// The whole edge side of one lazy-LN InteractionNet step on the multimesh's
// regular-block layout (graphs/structure.py: RegularBlocks), bf16, hidden and
// edge widths equal (H = De = W, 128 or 256), for Hopper (sm_90a):
//
//   h[e]   = xs[snd[e]] + xr[recv(e)] + v[e] @ W1e + b1                (fp32)
//   u[e]   = bf16(act(h[e])) @ W2 + b2                                 (fp32)
//   v'[e]  = bf16(a * v[e] + c + u[e])
//   agg[r] = bf16(sum over every row e of receiver r of u[e] * mask[e])
//   stats  = (sum v' w, sum v'^2 w, sum w),  w = mask[e]               (fp32)
//
// It replaces no TPU kernel: the JAX package writes this step as plain array
// code (graphcast_lite_tpu/ops/reg_edge.py: _fwd_impl, then the residual and
// the statistics in models/gnn.py) and leaves it to XLA's fusion.  Eager
// PyTorch fuses nothing: the same step ran as about forty passes over
// [rows, 256] tensors, each written to device memory.
//
// The layout.  Level b of the multimesh is a block of k_b slots of v_b rows
// each (slot-major): row off_b + s v_b + r belongs to receiver r < v_b, slot
// s.  So the rows of 64 consecutive receivers in one slot are one contiguous
// run, their receivers are the run's positions, and a receiver's aggregate
// is a sum over the (block, slot) pairs that hold it: no receiver gather, no
// segment search, no atomics.
//
// Work items.  An item is (sample, tile of 64 receivers).  It computes the
// tile's 64-row sub-tile of every slot of every block that holds the tile's
// first receiver (the blocks are ascending in v_b, so a tile below the
// coarse levels' sizes carries their slots too: 12 sub-tiles instead of 6 at
// the flagship's [4, 6] mesh), loads the tile's xr rows once for all of
// them, and keeps its aggregate in the fp32 registers of the second
// product's fragment across them, storing it once.  Items run heavy first
// (tile-major: the tiles of the coarse levels are the first), handed to one
// persistent block an SM by an atomic counter, so the launch's tail is a
// light item.  Each item writes its own statistics partial and a second
// small launch adds them in a fixed order: two launches are bitwise equal,
// and a sample's results do not depend on the batch around it.
//
// Per sub-tile, as the Hopper bf16 edge step (edge_step.cu:
// edge_step_bf16_kernel), whose pipeline this kernel keeps: two consumer
// warpgroups, warpgroup g computing output columns [g N/2, (g+1) N/2) of
// both products for all 64 rows; a ring of two row stages (the sub-tile's v
// rows by 16-byte cp.async, and the xs rows of their senders gathered the
// same way from the L2-resident node table) loading the next sub-tile while
// the current one computes; wgmma.mma_async (m64n64k16, bf16 in, fp32
// accumulate) with A and B in the 128-byte-swizzled K-major layout; the
// weights streamed as 64-column slabs (ops/edge_mlp.py: wgmma_b_image)
// through one slot a warpgroup, a slab's load running during the previous
// column block's epilogue.  Epilogue 1 forms h in fp32 from xs and xr in
// shared memory and the accumulator and writes bf16(act(h)) over xs as the
// second product's A operand; epilogue 2 forms u, v' (against the v tile
// still in shared memory), the masked statistics and the aggregate in
// registers, and writes v' over v, whence the next sub-tile copies it to
// device memory in 16-byte chunks.
//
// What a launch spent its time on (NVIDIA H100 80GB HBM3, 700 W; variants
// timed at the flagship shape): the epilogues, which run while the tensor
// cores idle.  The first version took 0.52 ms; without the products 0.47,
// without epilogue 1 0.37, without both epilogues 0.28, without v's and
// xs's loads or without the weight slabs' reloads unchanged.  Each
// epilogue therefore issues its shared-memory loads (xs, xr and b1; v, b2,
// a and c) while its product runs, before any of its arithmetic, and v'
// leaves through shared memory: its 4-byte stores from the fragment cost
// 0.075 ms.
//
// Bound (NVIDIA H100 SXM).  The flagship processor step (rows 261,248,
// 40,962 receivers, H = De = 256, B = 1) reads v (134 MB) and writes v' (134
// MB); the node tables xs and xr (21 MB each) and the aggregate (21 MB) add
// about 63 MB: 0.33 GB, 0.10 ms at 3.35 TB/s.  Its two products are 68.5
// GFLOP, 0.07 ms at 989 TFLOP/s.  So bytes bound it.
//
// Shared memory at H = De = 256 (from a 1024-aligned base): two row stages
// of 64 KB (v 32 KB, xs then act(h) 32 KB), two 32 KB weight slots, the
// item's xr tile (32 KB), the stages' masks, the reduction scratch, the
// next item, b1 and b2, and the barriers: 232,064 bytes with the alignment
// slack, of the 232,448 a block may use.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace gclt;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kSubRows;  // receivers an item
constexpr int kMaxBlocks = 8;    // RegularBlocks levels a launch takes

// The layout's blocks, ascending in v: level b holds k[b] slots of v[b]
// rows from row off[b] on.
struct Blocks {
  int n;
  int v[kMaxBlocks];
  int k[kMaxBlocks];
  int off[kMaxBlocks];
};

// Elements from one sample's input to the next; 0 where the samples share
// it (the first step's v, its folded W1e and b1, and its a and c).
struct Strides {
  long long v, w1e, b1, ac;
};

// Sub-tile rows [row0, row0 + nvalid): receivers tile * 64 + [0, nvalid)
// of one slot of one block.
struct Sub {
  int row0, nvalid;
};

__device__ __forceinline__ int subtiles(const Blocks& bl, int tile) {
  int n = 0;
  for (int b = 0; b < bl.n; ++b) {
    if (bl.v[b] > tile * kTile) n += bl.k[b];
  }
  return n;
}

// Sub-tile i of `tile`: the blocks in order, each slot in order.
__device__ __forceinline__ Sub sub_at(const Blocks& bl, int tile, int i) {
  const int r0 = tile * kTile;
  for (int b = 0; b < bl.n; ++b) {
    if (bl.v[b] <= r0) continue;
    if (i < bl.k[b]) {
      return Sub{bl.off[b] + i * bl.v[b] + r0, min(kTile, bl.v[b] - r0)};
    }
    i -= bl.k[b];
  }
  return Sub{0, 0};
}

// Byte offsets of the dynamic shared memory, from a 1024-aligned base, at
// width W = H = De.
template <int W>
struct Layout {
  // A [64, W] bf16 tile: a stage's v, its xs then act(h), or the item's xr.
  static constexpr int kRowTile = kSubRows * W * 2;
  static constexpr int kStage = 2 * kRowTile;
  // A weight slot: one 64-column block of W1e or W2 (K = W).
  static constexpr int kSlab = W * 128;
  static constexpr int slots = 2 * kStage;
  static constexpr int xr = slots + 2 * kSlab;
  static constexpr int mask = xr + kRowTile;  // [2][64] fp32
  static constexpr int red = mask + 2 * kSubRows * 4;
  static constexpr int item = red + round_up(kWarps * 3 * 4, 16);
  static constexpr int bias = item + 16;  // b1 (the item's), then b2
  static constexpr int bars = bias + round_up(2 * W * 2, 16);
  static constexpr int bytes = bars + 2 * 8 + 1024;  // + alignment slack
};

static_assert(Layout<256>::bytes <= 232448,
              "reg_edge: shared memory over a block's limit");

// Sum three per-thread values over the block in a fixed order (warp
// shuffles, then warps in order); thread 0 writes them to out[0..2].
__device__ inline void block_sum3(float s0, float s1, float s2, float* red_s,
                                  float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, off);
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    red_s[warp * 3] = s0;
    red_s[warp * 3 + 1] = s1;
    red_s[warp * 3 + 2] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      t0 += red_s[w * 3];
      t1 += red_s[w * 3 + 1];
      t2 += red_s[w * 3 + 2];
    }
    out[0] = t0;
    out[1] = t1;
    out[2] = t2;
  }
}

// Issue acc = A[64, K] @ the slab in this warpgroup's slot (K = 64 KB),
// A the swizzled tile at `a_tile`, once the slab is in: it is the
// warpgroup's n-th, so its barrier phase is n & 1.
template <int KB>
__device__ __forceinline__ void product_issue(float (&acc)[32],
                                              uint32_t a_tile, uint32_t slot,
                                              uint64_t* full, int n) {
  mbar_wait(full, n & 1);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_m64n64k16(acc, sw128_desc(a_tile + kb * kAtom + 32 * k),
                      sw128_desc(slot + kb * kAtom + 32 * k), (kb | k) != 0);
    }
  }
  wgmma_commit();
}

// Wait for the product; once every warp of the warpgroup is past its reads
// of the slot, the slot takes `next` (`bytes` bytes), if any.
__device__ __forceinline__ void product_wait(float (&acc)[32], uint32_t slot,
                                             uint64_t* full, const bf16* next,
                                             uint32_t bytes) {
  wgmma_wait<0>();
  fence_operands(acc);
  named_barrier(1 + (threadIdx.x >> 7), 128);
  if ((threadIdx.x & 127) == 0 && next != nullptr) {
    bulk_load(slot, next, bytes, full);
  }
}

template <int W, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
reg_edge_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ xr,
                const bf16* __restrict__ v, const bf16* __restrict__ w1e_img,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2_img,
                const bf16* __restrict__ b2, const float* __restrict__ a,
                const float* __restrict__ c, const bf16* __restrict__ mask,
                const int* __restrict__ snd, bf16* __restrict__ vout,
                bf16* __restrict__ agg, float* __restrict__ partials,
                int* __restrict__ counter, const Blocks bl, const Strides sd,
                int num_nodes, int rows, int batch, int tiles) {
  using L = Layout<W>;
  constexpr int NW = W / 2;   // output columns a warpgroup, either product
  constexpr int P = W / 128;  // their 64-column slabs
  constexpr int KB = W / 64;  // 64-wide blocks of either product's K
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int row_a = 16 * ((tid >> 5) & 3) + (lane >> 2);  // and row_a + 8
  const int cq = 2 * (lane & 3);

  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem + (base - raw);
  const unsigned char* xr_p = sp + L::xr;
  float* mask_s = reinterpret_cast<float*>(sp + L::mask);
  float* red_s = reinterpret_cast<float*>(sp + L::red);
  int* next_s = reinterpret_cast<int*>(sp + L::item);
  bf162* b1_s = reinterpret_cast<bf162*>(sp + L::bias);
  bf162* b2_s = b1_s + W / 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sp + L::bars);
  const uint32_t slot = base + L::slots + wg * L::kSlab;
  uint64_t* full = bars + wg;
  const int items = tiles * batch;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *next_s = gridDim.x + atomicAdd(counter, 1);
  }
  if (tid < W / 2) b2_s[tid] = reinterpret_cast<const bf162*>(b2)[tid];
  // v' of the rows past the last block (the layout's padding) is zero: a
  // strided share of them a block.
  {
    const int total = bl.off[bl.n - 1] + bl.k[bl.n - 1] * bl.v[bl.n - 1];
    const long long chunks = static_cast<long long>(rows - total) * W / 8;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
         i < batch * chunks; i += static_cast<long long>(gridDim.x) * kThreads) {
      const long long smp = i / chunks;
      reinterpret_cast<uint4*>(vout + (smp * rows + total) * W)[i - smp * chunks] =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto tile_of = [&](int k) { return k / batch; };
  auto sample_of = [&](int k) { return k - (k / batch) * batch; };
  // This warpgroup's p-th W1e slab of sample smp, and its p-th W2 slab.
  auto w1e_slab = [&](int smp, int p) {
    return w1e_img + smp * sd.w1e + static_cast<size_t>(wg * P + p) * W * 64;
  };
  auto w2_slab = [&](int p) {
    return w2_img + static_cast<size_t>(wg * P + p) * W * 64;
  };
  // v' of sub-tile s of sample smp, in the v tile of row stage st, to
  // device memory: 16-byte chunks, each thread the chunks it loads into
  // that tile (load_sub), so that its next copy into them follows its read.
  auto store_sub = [&](int st, const Sub& s, long long smp) {
    bf16* dst = vout + (smp * rows + s.row0) * W;
    const unsigned char* v_t = sp + st * L::kStage;
    for (int q = tid; q < kSubRows * (W / 8); q += kThreads) {
      const int row = q / (W / 8);
      const int ch = q - row * (W / 8);
      if (row < s.nvalid) {
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * W +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(v_t + swz_chunk(row, ch));
      }
    }
  };
  // Sub-tile s of item k into row stage st: its v rows and the xs rows of
  // their senders, rows past nvalid zero-filled, and their masks.
  auto load_sub = [&](int st, int k, const Sub& s) {
    const long long smp = sample_of(k);
    const bf16* vb = v + smp * sd.v + static_cast<size_t>(s.row0) * W;
    const bf16* xb = xs + smp * num_nodes * static_cast<long long>(W);
    const uint32_t v_t = base + st * L::kStage;
    const uint32_t x_t = v_t + L::kRowTile;
    for (int q = tid; q < kSubRows * (W / 8); q += kThreads) {
      const int row = q / (W / 8);
      const int ch = q - row * (W / 8);
      const bool ok = row < s.nvalid;
      cp_async16(v_t + swz_chunk(row, ch),
                 vb + static_cast<size_t>(ok ? row : 0) * W + ch * 8,
                 ok ? 16 : 0);
    }
    for (int q = tid; q < kSubRows * (W / 8); q += kThreads) {
      const int row = q / (W / 8);
      const int ch = q - row * (W / 8);
      const bool ok = row < s.nvalid;
      const int sn = ok ? snd[s.row0 + row] : 0;
      cp_async16(x_t + swz_chunk(row, ch),
                 xb + static_cast<size_t>(sn) * W + ch * 8, ok ? 16 : 0);
    }
    if (tid < kSubRows) {
      mask_s[st * kSubRows + tid] =
          tid < s.nvalid ? __bfloat162float(mask[s.row0 + tid]) : 0.0f;
    }
  };
  // Item k's xr rows (its tile's receivers) into the xr tile.
  auto load_xr = [&](int k) {
    const int r0 = tile_of(k) * kTile;
    const int nr = min(kTile, num_nodes - r0);
    const bf16* src = xr + (sample_of(k) * static_cast<long long>(num_nodes) +
                            r0) * W;
    for (int q = tid; q < kSubRows * (W / 8); q += kThreads) {
      const int row = q / (W / 8);
      const int ch = q - row * (W / 8);
      const bool ok = row < nr;
      cp_async16(base + L::xr + swz_chunk(row, ch),
                 src + static_cast<size_t>(ok ? row : 0) * W + ch * 8,
                 ok ? 16 : 0);
    }
  };

  __syncthreads();  // the barriers and the first ticket
  int cur = blockIdx.x;  // the grid is at most `items` blocks
  int nxt = *next_s;
  load_xr(cur);
  load_sub(0, cur, sub_at(bl, tile_of(cur), 0));
  cp_async_commit();
  if ((tid & 127) == 0) {
    bulk_load(slot, w1e_slab(sample_of(cur), 0), L::kSlab, full);
  }

  float aggr[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) aggr[i] = 0.0f;
  float s_sum = 0.0f, s_sq = 0.0f, s_cnt = 0.0f;
  int t = 0;  // sub-tiles begun by this block
  int n = 0;  // slabs this warpgroup has consumed
  Sub prev{0, 0};  // the sub-tile before, whose v' waits in its stage
  int prev_smp = 0;
  while (cur < items) {
    const int tile = tile_of(cur);
    const int smp = sample_of(cur);
    const int nsub = subtiles(bl, tile);
    const float* a_s = a + smp * sd.ac;
    const float* c_s = c + smp * sd.ac;
    if (tid < W / 2) {
      b1_s[tid] = reinterpret_cast<const bf162*>(b1 + smp * sd.b1)[tid];
    }
    for (int i = 0; i < nsub; ++i, ++t) {
      const int st = t & 1;
      const Sub s = sub_at(bl, tile, i);
      const bool last = i + 1 == nsub;
      // The next sub-tile: this item's next, or the next item's first.
      const bool more = !last || nxt < items;
      const int nk = last ? nxt : cur;
      if (t > 0) store_sub(st ^ 1, prev, prev_smp);
      if (more) {
        load_sub(st ^ 1, nk, sub_at(bl, tile_of(nk), last ? 0 : i + 1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_async_smem();
      __syncthreads();
      if (tid < s.nvalid) s_cnt += mask_s[st * kSubRows + tid];
      const uint32_t v_t = base + st * L::kStage;
      const uint32_t x_t = v_t + L::kRowTile;
      unsigned char* v_p = sp + st * L::kStage;
      unsigned char* x_p = v_p + L::kRowTile;
      const float* ms = mask_s + st * kSubRows;

      // act(h) over xs, one 64-column block at a time: its product, with
      // the block's xs, xr and b1 loaded while it runs, then its epilogue
      // while the slot loads the next slab.
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float acc[32];
        product_issue<KB>(acc, v_t, slot, full, n++);
        bf162 xv[16], rv[16], bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * NW + 64 * p + 8 * j + cq;
          bv[j] = b1_s[col >> 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t off = swz(row_a + 8 * hh, col);
            xv[2 * j + hh] = *reinterpret_cast<const bf162*>(x_p + off);
            rv[2 * j + hh] = *reinterpret_cast<const bf162*>(xr_p + off);
          }
        }
        product_wait(acc, slot, full,
                     p + 1 < P ? w1e_slab(smp, p + 1) : w2_slab(0),
                     L::kSlab);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = __bfloat1622float2(bv[j]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 x2 = __bfloat1622float2(xv[2 * j + hh]);
            const float2 r2 = __bfloat1622float2(rv[2 * j + hh]);
            const float h0 = ((x2.x + r2.x) + acc[4 * j + 2 * hh]) + bb.x;
            const float h1 = ((x2.y + r2.y) + acc[4 * j + 2 * hh + 1]) + bb.y;
            xv[2 * j + hh] = __floats2bfloat162_rn(activate_bf16<ACT>(h0),
                                                   activate_bf16<ACT>(h1));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * NW + 64 * p + 8 * j + cq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<bf162*>(x_p + swz(row_a + 8 * hh, col)) =
                xv[2 * j + hh];
          }
        }
      }
      fence_async_smem();
      __syncthreads();
      if (last && nxt < items) {  // the xr tile is free: epilogue 1 is done
        load_xr(nxt);
        cp_async_commit();
      }

      // u = act(h) @ W2 + b2; v' = a v + c + u over v (in place, for
      // store_sub); the statistics; the aggregate in registers.
      const float m_r[2] = {ms[row_a], ms[row_a + 8]};
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float acc[32];
        product_issue<KB>(acc, x_t, slot, full, n++);
        bf162 vv[16], bv[8];
        float2 av[8], cv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * NW + 64 * p + 8 * j + cq;
          bv[j] = b2_s[col >> 1];
          av[j] = __ldg(reinterpret_cast<const float2*>(a_s + col));
          cv[j] = __ldg(reinterpret_cast<const float2*>(c_s + col));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            vv[2 * j + hh] = *reinterpret_cast<const bf162*>(
                v_p + swz(row_a + 8 * hh, col));
          }
        }
        product_wait(acc, slot, full,
                     p + 1 < P ? w2_slab(p + 1)
                     : more     ? w1e_slab(sample_of(nk), 0)
                                : nullptr,
                     L::kSlab);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = 8 * p + j;
          const float2 bb = __bfloat1622float2(bv[j]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 x = __bfloat1622float2(vv[2 * j + hh]);
            const float u0 = acc[4 * j + 2 * hh] + bb.x;
            const float u1 = acc[4 * j + 2 * hh + 1] + bb.y;
            const float m = m_r[hh];
            const bf162 vn = __floats2bfloat162_rn(
                fmaf(av[j].x, x.x, cv[j].x) + u0,
                fmaf(av[j].y, x.y, cv[j].y) + u1);
            vv[2 * j + hh] = vn;
            const float2 f = __bfloat1622float2(vn);
            s_sum += f.x * m;
            s_sum += f.y * m;
            s_sq += f.x * f.x * m;
            s_sq += f.y * f.y * m;
            aggr[4 * jj + 2 * hh] += u0 * m;
            aggr[4 * jj + 2 * hh + 1] += u1 * m;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * NW + 64 * p + 8 * j + cq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<bf162*>(v_p + swz(row_a + 8 * hh, col)) =
                vv[2 * j + hh];
          }
        }
      }
      prev = s;
      prev_smp = smp;
      __syncthreads();  // v' is in its tile; the stage is free after that
    }

    // The tile's aggregate rows, written once, and the item's statistics.
    {
      bf16* dst = agg + (smp * static_cast<long long>(num_nodes) +
                         tile * kTile) * W;
#pragma unroll
      for (int jj = 0; jj < NW / 8; ++jj) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row_a + 8 * hh;
          if (tile * kTile + row < num_nodes) {
            *reinterpret_cast<bf162*>(dst + static_cast<size_t>(row) * W +
                                      wg * NW + 8 * jj + cq) =
                __floats2bfloat162_rn(aggr[4 * jj + 2 * hh],
                                      aggr[4 * jj + 2 * hh + 1]);
          }
          aggr[4 * jj + 2 * hh] = 0.0f;
          aggr[4 * jj + 2 * hh + 1] = 0.0f;
        }
      }
    }
    block_sum3(s_sum, s_sq, s_cnt, red_s,
               partials + 3 * (static_cast<size_t>(smp) * tiles + tile));
    s_sum = s_sq = s_cnt = 0.0f;
    cur = nxt;
    if (tid == 0) *next_s = gridDim.x + atomicAdd(counter, 1);
    __syncthreads();
    nxt = *next_s;
  }
  if (t > 0) store_sub((t - 1) & 1, prev, prev_smp);
}

// stats[s][k] = sum over tiles t of sample s's partials[t][k], in a fixed
// order (one block a sample: strided sums in double, then a tree).
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
stats_reduce_kernel(const float* __restrict__ partials, int tiles,
                    float* __restrict__ stats) {
  __shared__ double red[3][kReduceThreads];
  partials += static_cast<size_t>(blockIdx.x) * tiles * 3;
  stats += 3 * blockIdx.x;
  double s[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < tiles; b += kReduceThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] += partials[3 * b + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) red[k][threadIdx.x] = s[k];
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        red[k][threadIdx.x] += red[k][threadIdx.x + half];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 3) {
    stats[threadIdx.x] = static_cast<float>(red[threadIdx.x][0]);
  }
}

int smem_bytes(int width) {
  if (width == 128) return Layout<128>::bytes;
  if (width == 256) return Layout<256>::bytes;
  return -1;
}

struct Args {
  const bf16 *xs, *xr, *v, *w1e_img, *b1, *w2_img, *b2;
  const float *a, *c;
  const bf16* mask;
  const int* snd;
  bf16 *vout, *agg;
  float* partials;
  int* counter;
  Blocks bl;
  Strides sd;
  int num_nodes, rows, batch, tiles;
};

template <int W>
cudaError_t launch(const Args& g, int act, int blocks, cudaStream_t stream) {
  const int bytes = Layout<W>::bytes;
  const auto kernel = act == 0 ? reg_edge_kernel<W, 0> : reg_edge_kernel<W, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      g.xs, g.xr, g.v, g.w1e_img, g.b1, g.w2_img, g.b2, g.a, g.c, g.mask,
      g.snd, g.vout, g.agg, g.partials, g.counter, g.bl, g.sd, g.num_nodes,
      g.rows, g.batch, g.tiles);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at width H = De = `width`; -1 for a
// width the kernel does not take (128 or 256).
extern "C" int gclt_reg_edge_smem(int width) { return smem_bytes(width); }

// The most RegularBlocks levels a launch takes.
extern "C" int gclt_reg_edge_max_blocks() { return kMaxBlocks; }

// One reg-block edge step over `batch` samples, bf16, at H = De = `width`.
// xs and xr [batch, R, H] (R = num_nodes); v [batch, rows, De]; w1e_img the
// wgmma_b_image of W1e [De, H] a sample; b1 [batch, H]; a and c [batch, De]
// fp32; w2_img the image of W2 [H, De] and b2 [De], shared; mask [rows]
// (bf16) and snd [rows] (int32), shared.  `shared` bit 0: v is one [rows,
// De] for every sample, bit 1: W1e's image, bit 2: b1, bit 3: a and c.
// `table` holds nblocks receiver counts v then nblocks slot counts k (host
// memory), ascending in v.  Outputs: vout [batch, rows, De], agg [batch, R, De]
// (rows at or past 64 ceil(max v / 64) are not written), stats [batch][3]
// fp32; partials [batch][ceil(max v / 64)][3] fp32 and counter (one int32,
// zero) are scratch.  act: 0 = swish/silu, 1 = relu.  Returns
// cudaGetLastError() after each launch (the first non-zero one), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gclt_reg_edge(const void* xs, const void* xr, const void* v,
                             const void* w1e_img, const void* b1,
                             const void* w2_img, const void* b2, const void* a,
                             const void* c, const void* mask, const void* snd,
                             const void* table, void* vout, void* agg,
                             void* partials, void* stats, void* counter,
                             int nblocks, int width, int act,
                             int num_nodes, int rows, int batch, int shared,
                             void* stream) {
  if (smem_bytes(width) < 0 || nblocks < 1 || nblocks > kMaxBlocks ||
      batch < 1 || (act != 0 && act != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tab = static_cast<const int*>(table);
  Args g;
  g.bl.n = nblocks;
  int off = 0;
  for (int b = 0; b < nblocks; ++b) {
    g.bl.v[b] = tab[b];
    g.bl.k[b] = tab[nblocks + b];
    g.bl.off[b] = off;
    if (g.bl.v[b] < 1 || g.bl.k[b] < 1 || g.bl.v[b] > num_nodes ||
        (b > 0 && g.bl.v[b] <= g.bl.v[b - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    off += g.bl.v[b] * g.bl.k[b];
  }
  if (off > rows) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = (g.bl.v[nblocks - 1] + kTile - 1) / kTile;
  g.xs = static_cast<const bf16*>(xs);
  g.xr = static_cast<const bf16*>(xr);
  g.v = static_cast<const bf16*>(v);
  g.w1e_img = static_cast<const bf16*>(w1e_img);
  g.b1 = static_cast<const bf16*>(b1);
  g.w2_img = static_cast<const bf16*>(w2_img);
  g.b2 = static_cast<const bf16*>(b2);
  g.a = static_cast<const float*>(a);
  g.c = static_cast<const float*>(c);
  g.mask = static_cast<const bf16*>(mask);
  g.snd = static_cast<const int*>(snd);
  g.vout = static_cast<bf16*>(vout);
  g.agg = static_cast<bf16*>(agg);
  g.partials = static_cast<float*>(partials);
  g.counter = static_cast<int*>(counter);
  g.sd.v = (shared & 1) ? 0 : static_cast<long long>(rows) * width;
  g.sd.w1e = (shared & 2) ? 0 : static_cast<long long>(width) * width;
  g.sd.b1 = (shared & 4) ? 0 : width;
  g.sd.ac = (shared & 8) ? 0 : width;
  g.num_nodes = num_nodes;
  g.rows = rows;
  g.batch = batch;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(g.tiles) * batch;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = items < sms ? static_cast<int>(items) : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = width == 128 ? launch<128>(g, act, blocks, s)
                     : launch<256>(g, act, blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(
      g.partials, g.tiles, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}
