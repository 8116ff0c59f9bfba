// The InteractionNet edge-MLP tail fused with its segment aggregation, for
// Hopper (sm_90a):
//
//   u[e, :]   = act(h_pre[e, :]) @ W2 + b2                  (one cast to T)
//   agg[r, :] = sum over e in [indptr[r], indptr[r+1]) of u[e, :] * mask[e]
//
// Replaces the Pallas TPU kernel
// graphcast_lite_tpu/ops/pallas_edge_mlp.py: edge_mlp_segment (_kernel).
// That kernel streams 1024-edge chunks through VMEM behind a DMA ring and
// sums each chunk into its 256-receiver tile as a one-hot matmul on the
// MXU, with a host-built chunk schedule.  None of that carries over: the
// receiver-sorted rows become CSR ranges, and a block owns groups of
// consecutive receivers and every edge row of theirs, so the block sums its
// receivers' rows in shared memory and writes each aggregate row once, with
// no atomics and no schedule.
//
// Rounding points follow the reference: activation in fp32 and rounded to
// T; the product accumulated in fp32; b2 added in fp32; one cast to T;
// the aggregate sums the cast u in fp32 and is cast to T once.  Padding
// rows (receiver R-1's range, mask 0) get a u row and add nothing.
//
// Bound.  Per edge row it reads H values and writes De values and does
// 2*H*De operations.  In bf16 at H = De = 256: 131,072 operations per 1 KB
// moved, 128 per byte, below the H100's 295, so bytes: at the flagship
// processor shape (E_pad 261,120, R 40,962) the least traffic is 133.7 MB
// of h_pre read, 133.7 MB of u and 21.0 MB of agg written, about 86 us at
// 3.35 TB/s; the 34.2 GFLOP would take 35 us.  In fp32 the bytes double
// (0.172 ms at the flagship) and the products, in 3xTF32 (three TF32
// products at 495 TFLOP/s), bound it: 0.207 ms at the flagship, 0.181 ms
// at the regional head's processing shape (E_pad 228,352, R 41,046).
//
// Three designs (design() below).  Rows wider than 256 keep the
// 16-receiver design of edge_tile.cuh: a block per 16 receivers, wmma (bf16)
// or FMA (fp32) products into an fp32 tile in shared memory with W2
// re-read from L2 for every 64-row sub-tile, epilogue and aggregate
// between barriers.  At H and De in {128, 256} (the flagship's widths) bf16
// and fp32 each take a design built for Hopper.
//
// bf16 (edge_mlp_bf16_kernel):
//
// * W2 resident.  W2 (128 KB at 256 x 256) fits in shared memory beside two
//   row stages, so each persistent block (one an SM, two warpgroups) loads
//   it once, as the wgmma B image (ops/edge_mlp.py: wgmma_b_image) in
//   64-column slabs by cp.async.bulk counted in on one mbarrier, while its
//   first rows load.  About 17 MB of weight reads a launch instead of the
//   0.5-0.65 GB of the 16-receiver design's fragments.
// * Rows.  The block walks groups of kMlpReceivers consecutive receivers
//   (blockIdx.x, blockIdx.x + gridDim.x, ...): at the flagship's in-degree
//   about 204 rows, close to three full 64-row sub-tiles.  A ring of two
//   64-row h stages (16-byte cp.async into the 128-byte-swizzled K-major
//   layout) runs on across the groups, so the next sub-tile's rows, masks
//   and receiver offsets load while the current one computes.
// * Activation in place in the stage, by all 256 threads, one 64-deep K
//   block at a time: fp32, rounded to bf16 once, the division without a
//   slow-path branch (activate_bf16).  As each K block is done
//   (fence.proxy.async, barrier), the warpgroups issue its products, which
//   run on the tensor cores while the next K block is activated.  The
//   activation is not done on register A fragments because both
//   warpgroups read every row: each would compute it for the whole tile.
// * Products on wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate), A
//   the activated stage, B the resident W2; warpgroup g owns output columns
//   [g De/2, (g+1) De/2).
// * Epilogue on the accumulator registers: + b2 in fp32, one cast to bf16,
//   into a u tile in shared memory: over the h rows it came from where
//   De <= H (after a barrier: both warpgroups' products read them), in a
//   tile of its own otherwise.  Each u row is then written once with
//   coalesced 16-byte stores, and all 256 threads sum u * mask in fp32,
//   in row order, into the group's fp32 aggregate rows: a thread owns two
//   columns of every kParts-th receiver (De / 2 column pairs, 256 / (De / 2)
//   threads a pair) and walks each of its receivers' rows in the sub-tile
//   (their range, stored with the masks), one register sum per receiver and
//   one add into its aggregate row.  Each thread writes its own aggregate
//   entries once, in bf16, when the group ends; no thread reads another's,
//   so that needs no barrier.
//
// Shared memory at H = De = 256 (from a 1024-aligned base): W2 128 KB, two
// 32 KB row stages, 32 fp32 aggregate rows (32 KB), row metadata and the
// barrier: 231,432 bytes with the 1 KB alignment slack, of the 232,448 a
// block may use.  32 receivers a group is the most that fits; at the
// flagship it also makes the fewest sub-tiles (4,082, against 4,354 at 20
// receivers and 5,281 at 16), since most receivers have 6 rows.
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W; scripts/
// torch_edge_mlp_time.py): about 0.235 ms at the flagship shape, 2.7x its
// bound, 3x faster than the 16-receiver design.  The row copies alone run
// in 0.068 ms; the phases of a sub-tile (activation, products, epilogue, u
// stores, aggregate) follow each other on the block's 8 warps, and the
// activation (two MUFU operations an element) is the largest.  A store
// warpgroup beside one or two product warpgroups was slower (0.25-0.29
// ms): with W2 resident only two row stages fit, so a stage goes back to
// the loader only once its u is out, and the next rows' load is exposed.

// fp32 (edge_mlp_f32_kernel).  fp32's W2 is 256 KB at 256 x 256, 512 KB
// split, and cannot stay resident; the fp32 tolerance rules out one TF32
// pass (about three digits).  Its machinery (the row shares, the ring, the
// product pass, the staging and the carried aggregate) lives in hopper.cuh,
// shared with the fp32 edge step.
//
// * Products in 3xTF32 on the tensor cores: wgmma.mma_async
//   m64n{De}k8 tf32 with fp32 accumulation, both operands from shared
//   memory, K-major.  Each operand is split into its TF32 big part
//   (cvt.rna.tf32.f32) and the TF32 of the remainder, and each k8 step
//   adds a_s b_b, a_b b_s, then a_b b_b into the same accumulators: the
//   dropped a_s b_s and the remainders' remainders are about 2^-22 of
//   each term, of the order of fp32's own rounding of the running sum
//   (one TF32 product alone keeps about 2^-11).  On the card the kernel
//   sits 1.9-13.8x as far from a float64 evaluation as cuBLAS fp32 does
//   (chip_smoke.py phase 1b, "vs fp64"), within FUSED_FP32_TOL of it: the
//   tensor cores' own rounding of the accumulator, which this reckoning
//   leaves out, is the suspect (PERF.md section 6).
// * W2 streamed.  The wrapper hands the kernel W2's big and small parts as
//   K-slabs (ops/edge_mlp.py: tf32x3_b_image: 32 K values by De rows,
//   128-byte-swizzled, 64 KB a slab at De = 256).  Thread 0 copies them
//   by cp.async.bulk into a two-slot ring counted in on "full" mbarriers;
//   each warp arrives on the slot's "empty" mbarrier once
//   wgmma.wait_group shows its products of that slab done, and warp 0
//   waits for all eight before slab c + 1 replaces slab c - 1.
// * Rows.  Two warpgroups each own one 64-row M tile of a
//   128-row step, so each W2 slab serves 128 rows: about 0.95 GB of L2
//   reads a regional launch.  A warpgroup loads its rows' K-slab from
//   global memory into registers one slab ahead, activates it in fp32
//   (x / (1 + expf(-x)), or relu, as the reference), splits it and stores
//   both parts into a double-buffered 128-byte-swizzled A slab.
// * Blocks.  One persistent block an SM (256 threads) owns the receivers
//   whose rows start in its equal share of the rows (a receiver's rows are
//   never split) and walks their rows in 128-row steps across receiver
//   boundaries, so every step but a block's last is full: the 16- or
//   32-receiver groups of the other designs would leave 64-row tiles
//   30-40% empty at these in-degrees (5.6 and 6.4 rows a receiver), and a
//   group's fp32 aggregate rows would not fit beside the W2 ring.
// * Epilogue, per 128 columns: + b2 in fp32 from the accumulators into a
//   u tile over the warpgroup's A buffers; each u row out once with
//   16-byte stores; then each thread sums u * mask for two columns over
//   its receivers' rows of the step, in row order.  A receiver that ends
//   in the step is written once; the one that runs on keeps its partial
//   sum in shared memory (two buffers, alternating by step) and adds it to
//   its next step's sum.  No atomics: two launches are bitwise equal.
//
// Shared memory at H = De = 256: W2 ring 128 KB, A slabs and u tiles
// 64 KB, b2, the carried sums and the barriers: 200,752 bytes with the
// 1 KB alignment slack.
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W; scripts/
// torch_edge_mlp_time.py --dtype float32): 0.47 ms at the regional shape,
// 0.36 of its 3xTF32 bound, 8.8x faster than the 16-receiver FMA design.
// The products alone take 0.25 ms; the epilogue's u stores and sums
// (0.11-0.13 ms) overlap nothing, since both warpgroups run it at once
// while the tensor cores idle.  The W2 stream costs nothing measurable.
//
#include <stdint.h>

#include "edge_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace gclt;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// ---------------------------------------------------------------------------
// fp32, and bf16 rows wider than 256: 16 receivers a block, FMA or wmma
// products (edge_tile.cuh).

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_mlp_kernel(const T* __restrict__ h, const T* __restrict__ w2,
                const T* __restrict__ b2, const T* __restrict__ mask,
                const int* __restrict__ indptr, T* __restrict__ u,
                T* __restrict__ agg, int num_receivers, int hid, int de,
                int act) {
  const Layout l = make_layout(sizeof(T), hid, de, false);
  int* indptr_s = reinterpret_cast<int*>(smem + l.indptr);
  int* recv_s = reinterpret_cast<int*>(smem + l.recv);
  float* mask_s = reinterpret_cast<float*>(smem + l.mask);
  float* agg_s = reinterpret_cast<float*>(smem + l.agg);
  float* c_s = reinterpret_cast<float*>(smem + l.c);
  T* a_s = reinterpret_cast<T*>(smem + l.a);
  const int lda = hid + kPad;

  const int nr = begin_block(indptr, num_receivers, indptr_s, agg_s, de);
  const int eb = indptr_s[0];
  const int ee = indptr_s[nr];
  for (int e0 = eb; e0 < ee; e0 += kRows) {
    const int nrows = min(kRows, ee - e0);
    row_meta(mask, indptr_s, e0, nrows, recv_s, mask_s);
    load_rows(a_s, lda, h + static_cast<size_t>(e0) * hid, nrows, hid, act);
    __syncthreads();
    for (int col0 = 0; col0 < de; col0 += kChunk) {
      tile_product<T>(a_s, lda, w2, de, col0, hid, c_s);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
        const int row = i / kChunk;
        const int c = i - row * kChunk;
        float val = 0.0f;
        if (row < nrows) {
          const T uv = Elt<T>::from_f(c_s[row * kLdc + c] +
                                      Elt<T>::to_f(b2[col0 + c]));
          u[static_cast<size_t>(e0 + row) * de + col0 + c] = uv;
          val = Elt<T>::to_f(uv) * mask_s[row];
        }
        c_s[row * kLdc + c] = val;
      }
      __syncthreads();
      aggregate_rows(c_s, recv_s, nrows, agg_s, de, col0);
      __syncthreads();
    }
  }
  store_agg(agg_s, nr, de, agg);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: W2 resident, wgmma products, register epilogue,
// asynchronous row copies, persistent blocks.

constexpr int kMlpReceivers = 32;  // receivers per group
constexpr int kMlpThreads = 256;   // two warpgroups

// Byte offsets of the bf16 kernel's dynamic shared memory, from a
// 1024-aligned base.
template <int H, int DE>
struct MlpLayout {
  static constexpr int kStage = kSubRows * H * 2;  // h, activated in place
  // The u tile: over its h rows where it fits, else a tile of its own.
  static constexpr int kUTile = DE > H ? kSubRows * DE * 2 : 0;
  static constexpr int w2 = 0;  // the image: [De / 64][H / 64][64][64]
  static constexpr int stages = H * DE * 2;
  static constexpr int utile = stages + 2 * kStage;
  static constexpr int agg = utile + kUTile;
  // Each receiver's rows within the sub-tile: [2][kMlpReceivers] int2.
  static constexpr int runs = agg + kMlpReceivers * DE * 4;
  static constexpr int mask = runs + 2 * kMlpReceivers * 8;  // [2][64]
  static constexpr int bar = mask + 2 * kSubRows * 4;
  static constexpr int bytes = bar + 8 + 1024;  // + alignment slack
};
static_assert(MlpLayout<256, 256>::bytes <= 232448,
              "the flagship layout must fit one block's shared memory");

template <int H, int DE, int ACT>
__global__ void __launch_bounds__(kMlpThreads, 1)
edge_mlp_bf16_kernel(const bf16* __restrict__ h,
                     const bf16* __restrict__ w2_img,
                     const bf16* __restrict__ b2,
                     const bf16* __restrict__ mask,
                     const int* __restrict__ indptr, bf16* __restrict__ u,
                     bf16* __restrict__ agg, int num_receivers) {
  using L = MlpLayout<H, DE>;
  constexpr int G = kMlpReceivers;
  constexpr int KB = H / 64;                // 64-deep K blocks
  constexpr int NS = DE / 128;              // W2 slabs per warpgroup
  constexpr int kPairs = DE / 2;                 // aggregate column pairs
  constexpr int kParts = kMlpThreads / kPairs;  // threads a column pair
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int row_a = 16 * ((tid >> 5) & 3) + (lane >> 2);  // and row_a + 8
  const int cq = 2 * (lane & 3);
  // This thread's aggregate columns, col_g and col_g + 1, and its
  // receivers, r % kParts == part (uniform in a warp).
  const int col_g = 2 * (tid % kPairs);
  const int part = tid / kPairs;

  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem + (base - raw);
  float* agg_s = reinterpret_cast<float*>(sp + L::agg);
  int2* runs_s = reinterpret_cast<int2*>(sp + L::runs);
  float* mask_s = reinterpret_cast<float*>(sp + L::mask);
  uint64_t* w2_full = reinterpret_cast<uint64_t*>(sp + L::bar);

  const int ngroups = (num_receivers + G - 1) / G;
  if (tid == 0) {
    mbar_init(w2_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < G * DE; i += kMlpThreads) agg_s[i] = 0.0f;
  // This thread's columns of b2, in fp32, once.
  float2 b2_r[NS * 8];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b2_r[8 * s + j] = __bfloat1622float2(*reinterpret_cast<const bf162*>(
          b2 + wg * (DE / 2) + 64 * s + 8 * j + cq));
    }
  }
  __syncthreads();

  // W2 once, if this block has rows at all (a block must not exit with a
  // bulk copy in flight).
  int nk = next_busy<G>(indptr, num_receivers, ngroups, blockIdx.x);
  if (tid == 0 && nk < ngroups) {
    mbar_expect_tx(w2_full, H * DE * 2);
    for (int s = 0; s < DE / 64; ++s) {
      bulk_copy(base + L::w2 + s * H * 128,
                w2_img + static_cast<size_t>(s) * H * 64, H * 128, w2_full);
    }
  }

  // Sub-tile rows [e0, e0 + nrows) into row stage st, rows past nrows
  // zero-filled (act(0) = 0).
  auto load_rows = [&](int st, int e0, int nrows) {
    const uint32_t dst = base + L::stages + st * L::kStage;
    for (int q = tid; q < kSubRows * (H / 8); q += kMlpThreads) {
      const int row = q / (H / 8);
      const int ch = q - row * (H / 8);
      const bool ok = row < nrows;
      cp_async16(dst + swz_chunk(row, ch),
                 h + static_cast<size_t>(e0 + (ok ? row : 0)) * H + ch * 8,
                 ok ? 16 : 0);
    }
  };
  // A sub-tile's metadata (each row's mask, and the row range of the
  // group's receiver tid), read into registers when its rows are issued
  // and stored into its stage's slots a sub-tile later, so that no thread
  // waits for the loads.  The slots hold the range as rows of the
  // sub-tile, empty for a receiver with none there.
  struct Meta {
    bf16 m;
    int lo, hi;
  };
  auto fetch_meta = [&](const Group& g, int e0, int nrows) {
    Meta mt{__float2bfloat16_rn(0.0f), 0, 0};
    if (tid < nrows) mt.m = mask[e0 + tid];
    if (tid < g.nr) {
      mt.lo = indptr[g.r0 + tid];
      mt.hi = indptr[g.r0 + tid + 1];
    }
    return mt;
  };
  auto put_meta = [&](int st, int e0, int nrows, const Meta& mt) {
    if (tid < kSubRows) mask_s[st * kSubRows + tid] = __bfloat162float(mt.m);
    if (tid < G) {
      runs_s[st * G + tid] = make_int2(max(mt.lo, e0) - e0,
                                       min(mt.hi, e0 + nrows) - e0);
    }
  };

  if (nk < ngroups) {
    const Group g = group_at<G>(indptr, num_receivers, nk);
    const int n = min(kSubRows, g.ee - g.eb);
    load_rows(0, g.eb, n);
    put_meta(0, g.eb, n, fetch_meta(g, g.eb, n));
  }
  cp_async_commit();
  bool w2_in = false;
  int t = 0;  // sub-tiles begun by this block
  for (int k = blockIdx.x; k < ngroups; k += gridDim.x) {
    const Group g = group_at<G>(indptr, num_receivers, k);
    bf16* dst = agg + static_cast<size_t>(g.r0) * DE;
    if (g.ee == g.eb) {  // no rows: zero aggregates
      for (int i = tid; i < g.nr * DE / 2; i += kMlpThreads) {
        reinterpret_cast<bf162*>(dst)[i] = __float2bfloat162_rn(0.0f);
      }
      continue;
    }
    const int ntiles = g.tiles();
    nk = next_busy<G>(indptr, num_receivers, ngroups, k + gridDim.x);
    Group gn{};
    if (nk < ngroups) gn = group_at<G>(indptr, num_receivers, nk);
    for (int i = 0; i < ntiles; ++i, ++t) {
      const int st = t & 1;
      const int e0 = g.eb + i * kSubRows;
      const int nrows = min(kSubRows, g.ee - e0);
      // This sub-tile's rows and metadata are in, and every thread is past
      // the sub-tile before, whose stage takes the next rows.
      cp_async_wait<0>();
      __syncthreads();
      const bool in_group = i + 1 < ntiles;
      const bool more = in_group || nk < ngroups;
      const Group gx = in_group ? g : gn;
      const int e0n = in_group ? e0 + kSubRows : gn.eb;
      const int nn = min(kSubRows, gx.ee - e0n);
      Meta mt{};
      if (more) {
        load_rows(st ^ 1, e0n, nn);
        mt = fetch_meta(gx, e0n, nn);
      }
      cp_async_commit();

      // u = act(h) @ W2: the activation in place, one K block at a time;
      // each block's products run while the next block is activated.
      const uint32_t a_t = base + L::stages + st * L::kStage;
      unsigned char* a_p = sp + L::stages + st * L::kStage;
      float acc[NS][32];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
        for (int q = 0; q < kAtom / 16 / kMlpThreads; ++q) {
          uint4* p = reinterpret_cast<uint4*>(a_p + kb * kAtom) + tid +
                     q * kMlpThreads;
          uint4 x = *p;
          bf162* e = reinterpret_cast<bf162*>(&x);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 f = __bfloat1622float2(e[c]);
            e[c] = __floats2bfloat162_rn(activate_bf16<ACT>(f.x),
                                         activate_bf16<ACT>(f.y));
          }
          *p = x;
        }
        fence_async_smem();
        __syncthreads();
        if (!w2_in) {
          mbar_wait(w2_full, 0);
          w2_in = true;
        }
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            wgmma_m64n64k16(
                acc[s], sw128_desc(a_t + kb * kAtom + 32 * k16),
                sw128_desc(base + L::w2 + (wg * NS + s) * H * 128 +
                           kb * kAtom + 32 * k16),
                (kb | k16) != 0);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) fence_operands(acc[s]);

      // u = T(acc + b2) into the u tile.
      unsigned char* ut = L::kUTile ? sp + L::utile : a_p;
      if (L::kUTile == 0) __syncthreads();  // both products read the rows
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * (DE / 2) + 64 * s + 8 * j + cq;
          const float2 bb = b2_r[8 * s + j];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<bf162*>(ut + swz(row_a + 8 * hh, col)) =
                __floats2bfloat162_rn(acc[s][4 * j + 2 * hh] + bb.x,
                                      acc[s][4 * j + 2 * hh + 1] + bb.y);
          }
        }
      }
      __syncthreads();

      // Each u row out once, 16 bytes a thread.
      for (int q = tid; q < nrows * (DE / 8); q += kMlpThreads) {
        const int row = q / (DE / 8);
        const int ch = q - row * (DE / 8);
        *reinterpret_cast<uint4*>(u + static_cast<size_t>(e0 + row) * DE +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(ut + swz_chunk(row, ch));
      }
      // agg_s[r] += u * mask over receiver r's rows of the sub-tile, in row
      // order, two columns a thread: one register sum per receiver.
      {
        const int2* rn = runs_s + st * G;
        const float* ms = mask_s + st * kSubRows;
        const unsigned char* uc =
            ut + (col_g >> 6) * kAtom + ((col_g & 7) << 1);
        const int ch = (col_g >> 3) & 7;
#pragma unroll
        for (int i = 0; i < G / kParts; ++i) {
          const int r = part + i * kParts;
          const int2 rg = rn[r];
          if (rg.x >= rg.y) continue;
          float s0 = 0.0f, s1 = 0.0f;
          for (int row = rg.x; row < rg.y; ++row) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<
                const bf162*>(uc + row * 128 + ((ch ^ (row & 7)) << 4)));
            const float m = ms[row];
            s0 += f.x * m;
            s1 += f.y * m;
          }
          float2* p = reinterpret_cast<float2*>(agg_s + r * DE + col_g);
          float2 v = *p;
          v.x += s0;
          v.y += s1;
          *p = v;
        }
      }
      if (more) put_meta(st ^ 1, e0n, nn, mt);
    }
    // The group's aggregate rows, each entry written once by the thread
    // that summed it, and zeroed for the next group.
    for (int r = part; r < g.nr; r += kParts) {
      float2* p = reinterpret_cast<float2*>(agg_s + r * DE + col_g);
      *reinterpret_cast<bf162*>(dst + static_cast<size_t>(r) * DE + col_g) =
          __float22bfloat162_rn(*p);
      *p = make_float2(0.0f, 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on Hopper: 3xTF32 wgmma products, W2 streamed in K-slabs, persistent
// blocks over row-balanced receiver ranges.

// Byte offsets of the fp32 kernel's dynamic shared memory, from a
// 1024-aligned base (kF32Threads, kF32StepRows, kF32A: hopper.cuh).
template <int H, int DE>
struct F32Layout {
  // One K-slab of W2's image (ops/edge_mlp.py: tf32x3_b_image): the TF32
  // big part, then the small part, each DE rows of 32 K values.
  static constexpr int kPart = DE * 128;
  static constexpr int kSlab = 2 * kPart;
  static constexpr int ring = 0;  // [2 slots][kSlab]
  // [2 warpgroups][2 buffers][big, small][kF32A]; in the epilogue each
  // warpgroup's 32 KB hold its u tile, 64 rows x 128 columns.
  static constexpr int a = ring + 2 * kSlab;
  static constexpr int b2 = a + 8 * kF32A;
  static constexpr int carry = b2 + DE * 4;       // [2][DE] fp32
  static constexpr int bounds = carry + 2 * DE * 4;  // rb0, rb1
  static constexpr int bar = bounds + 16;            // full[2], empty[2]
  static constexpr int bytes = bar + 4 * 8 + 1024;   // + alignment slack
};
static_assert(F32Layout<256, 256>::bytes <= 232448,
              "the fp32 layout must fit one block's shared memory");

template <int H, int DE, int ACT>
__global__ void __launch_bounds__(kF32Threads, 1)
edge_mlp_f32_kernel(const float* __restrict__ h,
                    const float* __restrict__ w2_img,
                    const float* __restrict__ b2,
                    const float* __restrict__ mask,
                    const int* __restrict__ indptr, float* __restrict__ u,
                    float* __restrict__ agg, int num_receivers) {
  using L = F32Layout<H, DE>;
  constexpr int NK = H / 32;    // K-slabs of W2
  constexpr int NH = DE / 128;  // column halves of the epilogue
  const int tid = threadIdx.x;

  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem + (base - raw);
  float* b2_s = reinterpret_cast<float*>(sp + L::b2);
  float* carry_s = reinterpret_cast<float*>(sp + L::carry);
  int* bounds_s = reinterpret_cast<int*>(sp + L::bounds);
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + L::bar);
  uint64_t* empty = full + 2;

  f32_block_setup(indptr, num_receivers, bounds_s, full, empty);
  for (int i = tid; i < DE; i += kF32Threads) b2_s[i] = b2[i];
  __syncthreads();
  const int rb0 = bounds_s[0];
  const int rb1 = bounds_s[1];
  const int eb = indptr[rb0];
  const int ee = indptr[rb1];
  const int nsteps = (ee - eb + kF32StepRows - 1) / kF32StepRows;
  const int nslabs = nsteps * NK;  // each step's pass over W2

  if (nsteps == 0) {  // no rows: zero aggregates
    f32_zero_agg<DE>(agg, rb0, rb1);
    return;
  }

  // K-slab c of the block's sequence (slab c % NK of a pass) into ring slot
  // c % 2, counted in on full[c % 2]; thread 0 issues every copy.
  auto fill = [&](int c) {
    const float* src = w2_img + static_cast<size_t>(c % NK) * (L::kSlab / 4);
    const uint32_t dst = base + L::ring + (c & 1) * L::kSlab;
    mbar_expect_tx(full + (c & 1), L::kSlab);
    bulk_copy(dst, src, L::kPart, full + (c & 1));
    bulk_copy(dst + L::kPart, src + L::kPart / 4, L::kPart, full + (c & 1));
  };
  if (tid == 0) {
    fill(0);
    if (nslabs > 1) fill(1);
  }
  __syncwarp();

  // The warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127;
  const int prow = wt >> 3;  // this thread's A rows: prow + 16 k, k < 4,
  const int pch = wt & 7;    // and their 16-byte chunk of a K-slab
  const uint32_t a_wg = base + L::a + wg * 4 * kF32A;
  unsigned char* a_wg_p = sp + L::a + wg * 4 * kF32A;

  // K-slab i of this warpgroup's rows of the step at e0, into registers
  // (rows past ee: 0).
  float4 x[4];
  auto load_raw = [&](int e0, int i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + kSubRows * wg + prow + 16 * k;
      x[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < ee) {
        x[k] = __ldg(reinterpret_cast<const float4*>(
            h + static_cast<size_t>(e) * H + 32 * i + 4 * pch));
      }
    }
  };
  // act(x) in fp32, split and stored into A buffer i % 2.
  auto put_a = [&](int i) {
    f32_put_a(a_wg_p + (i & 1) * 2 * kF32A, x, prow, pch,
              [](float v) { return activate(v, ACT); });
  };

  const F32Ring ring{base + L::ring, L::kSlab, full, empty, nslabs};
  float acc[DE / 2];
  int slab = 0;    // K-slabs consumed, in the producer's order
  int rc = rb0;    // the first receiver not yet written
  int e0 = eb;
  load_raw(e0, 0);
  for (int t = 0; t < nsteps; ++t, e0 += kF32StepRows) {
    const int e1 = min(e0 + kF32StepRows, ee);
    const bool busy = e0 + kSubRows * wg < e1;  // this warpgroup has rows
    f32_product(acc, NK, L::kPart, busy, slab, ring, a_wg, put_a,
                [&](int i) {
                  if (i + 1 < NK) {
                    load_raw(e0, i + 1);
                  } else if (t + 1 < nsteps) {
                    load_raw(e0 + kF32StepRows, 0);
                  }
                },
                fill);

    // The receivers [rc, rf) end within this step; rf (if below rb1) runs
    // on, its partial sum carried into the next step.
    const int rf = first_open(indptr, rc, rb1, e1);
    const int rlast = rf < rb1 ? rf : rb1 - 1;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      // Both warpgroups' products are done (hh = 0), or every thread is
      // past the last half's u tiles.
      __syncthreads();
      // u = acc + b2 in fp32, columns [128 hh, 128 hh + 128), into this
      // warpgroup's u tile.
      if (busy) f32_stage<true>(acc, hh, b2_s, a_wg_p);
      __syncthreads();
      // Each u row out once, 16 bytes a thread.
      for (int q = tid; q < (e1 - e0) * 32; q += kF32Threads) {
        const int lr = q >> 5;
        const int k = q & 31;
        *reinterpret_cast<float4*>(u + static_cast<size_t>(e0 + lr) * DE +
                                   128 * hh + 4 * k) =
            *reinterpret_cast<const float4*>(
                f32_tile_at(sp + L::a, lr, 4 * k));
      }
      f32_aggregate<DE>(indptr, mask, agg, sp + L::a, tid, rc, rf, rlast,
                        e0, e1, hh, carry_s + (t & 1) * DE,
                        carry_s + ((t + 1) & 1) * DE);
    }
    // The u tiles are read: the buffers take the next step's rows.
    __syncthreads();
    rc = rf;
  }
}

// The design a launch takes (kTile16, kHopperBf16, kHopperF32).  The two
// Hopper designs take H and De in {128, 256}: wider rows do not fit their
// shared memory (bf16 at H = De = 384: W2 alone is 288 KB; fp32 keeps
// 64-row operand slabs of 32 K values and a u tile of 128 columns whose
// layouts are written for these widths), and run the 16-receiver design of
// edge_tile.cuh.
enum Design { kTile16 = 0, kHopperBf16 = 1, kHopperF32 = 2 };

Design design(int dtype, int hid, int de) {
  if ((hid != 128 && hid != 256) || (de != 128 && de != 256)) return kTile16;
  return dtype == 1 ? kHopperBf16 : kHopperF32;
}

template <template <int, int> class Layout>
int hopper_bytes(int hid, int de) {
  if (hid == 128 && de == 128) return Layout<128, 128>::bytes;
  if (hid == 128) return Layout<128, 256>::bytes;
  if (de == 128) return Layout<256, 128>::bytes;
  return Layout<256, 256>::bytes;
}

// Dynamic shared memory of one block; -1 for a dtype the kernels do not
// take.
int smem_bytes(int dtype, int hid, int de) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (design(dtype, hid, de)) {
    case kHopperBf16:
      return hopper_bytes<MlpLayout>(hid, de);
    case kHopperF32:
      return hopper_bytes<F32Layout>(hid, de);
    default:
      return make_layout(dtype == 0 ? 4 : 2, hid, de, false).total;
  }
}

template <typename T>
cudaError_t launch_tile(int bytes, const void* h, const void* w2,
                        const void* b2, const void* mask, const int* indptr,
                        void* u, void* agg, int num_receivers, int hid,
                        int de, int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_receivers + kTileReceivers - 1) / kTileReceivers;
  edge_mlp_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(mask), indptr,
      static_cast<T*>(u), static_cast<T*>(agg), num_receivers, hid, de, act);
  return cudaGetLastError();
}

// One persistent block an SM (at most one fits), or one a work item
// (receiver group, receiver) where there are fewer.
template <typename T, typename Kernel>
cudaError_t launch_persistent(Kernel kernel, int threads, int bytes,
                              int items, const void* h, const void* w2,
                              const void* b2, const void* mask,
                              const int* indptr, void* u, void* agg,
                              int num_receivers, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  kernel<<<items < sms ? items : sms, threads, bytes, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(mask), indptr,
      static_cast<T*>(u), static_cast<T*>(agg), num_receivers);
  return cudaGetLastError();
}

template <int H, int DE>
cudaError_t launch_hopper(int dtype, const void* h, const void* w2_img,
                          const void* b2, const void* mask,
                          const int* indptr, void* u, void* agg,
                          int num_receivers, int act, cudaStream_t stream) {
  if (dtype == 1) {
    // Block b walks receiver groups b, b + blocks, ...
    return launch_persistent<bf16>(
        act == 0 ? edge_mlp_bf16_kernel<H, DE, 0>
                 : edge_mlp_bf16_kernel<H, DE, 1>,
        kMlpThreads, MlpLayout<H, DE>::bytes,
        (num_receivers + kMlpReceivers - 1) / kMlpReceivers, h, w2_img, b2,
        mask, indptr, u, agg, num_receivers, stream);
  }
  // Block b takes the receivers of its share of the rows.
  return launch_persistent<float>(
      act == 0 ? edge_mlp_f32_kernel<H, DE, 0> : edge_mlp_f32_kernel<H, DE, 1>,
      kF32Threads, F32Layout<H, DE>::bytes, num_receivers, h, w2_img, b2,
      mask, indptr, u, agg, num_receivers, stream);
}

}  // namespace

// Dynamic shared memory one block needs (dtype: 0 = float32, 1 =
// bfloat16); -1 for a dtype the kernels do not take.
extern "C" int gclt_edge_mlp_smem(int dtype, int hid, int de) {
  return smem_bytes(dtype, hid, de);
}

// The design a launch takes: 0, the 16-receiver design with W2 row-major;
// 1, the Hopper bf16 design with W2 as its wgmma image (ops/edge_mlp.py:
// wgmma_b_image); 2, the Hopper fp32 design with W2 as its 3xTF32 image
// (tf32x3_b_image).
extern "C" int gclt_edge_mlp_design(int dtype, int hid, int de) {
  return static_cast<int>(design(dtype, hid, de));
}

// Receivers per group: a block's (the 16-receiver design) or a group's
// that a persistent block walks (the Hopper bf16 design); 0 for the Hopper
// fp32 design, whose blocks split the rows, not receiver groups.
extern "C" int gclt_edge_mlp_tile_receivers(int dtype, int hid, int de) {
  switch (design(dtype, hid, de)) {
    case kHopperBf16:
      return kMlpReceivers;
    case kHopperF32:
      return 0;
    default:
      return kTileReceivers;
  }
}

// dtype: 0 = float32, 1 = bfloat16; act: 0 = swish/silu, 1 = relu.  w2
// [H, De] is row-major, or the image gclt_edge_mlp_design names.  Returns
// cudaGetLastError() after the launch.
extern "C" int gclt_edge_mlp(const void* h, const void* w2, const void* b2,
                             const void* mask, const void* indptr, void* u,
                             void* agg, int dtype, int num_receivers, int hid,
                             int de, int act, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = smem_bytes(dtype, hid, de);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (design(dtype, hid, de) == kTile16) {
    err = dtype == 0 ? launch_tile<float>(bytes, h, w2, b2, mask, ip, u, agg,
                                          num_receivers, hid, de, act, s)
                     : launch_tile<bf16>(bytes, h, w2, b2, mask, ip, u, agg,
                                         num_receivers, hid, de, act, s);
  } else if (hid == 128 && de == 128) {
    err = launch_hopper<128, 128>(dtype, h, w2, b2, mask, ip, u, agg,
                                  num_receivers, act, s);
  } else if (hid == 128) {
    err = launch_hopper<128, 256>(dtype, h, w2, b2, mask, ip, u, agg,
                                  num_receivers, act, s);
  } else if (de == 128) {
    err = launch_hopper<256, 128>(dtype, h, w2, b2, mask, ip, u, agg,
                                  num_receivers, act, s);
  } else {
    err = launch_hopper<256, 256>(dtype, h, w2, b2, mask, ip, u, agg,
                                  num_receivers, act, s);
  }
  return static_cast<int>(err);
}
