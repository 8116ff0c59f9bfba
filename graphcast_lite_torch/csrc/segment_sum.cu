// Sorted segment sum over CSR receiver ranges, for Hopper (sm_90a).
//
//   out[b, r, :] = sum over e in [indptr[r], indptr[r+1]) of msgs[b, e, :]
//
// Replaces the Pallas TPU kernel
// graphcast_lite_tpu/ops/pallas_segment.py: segment_sum_sorted (forward;
// _kernel and _segment_sum_impl).  That kernel accumulates each 1024-edge
// chunk into its receiver tile as a one-hot matmul on the MXU behind a DMA
// ring, with a host-built chunk schedule.  None of that carries over.  The
// one-hot product spends E*R_tile*F multiply-adds to do E*F additions: the
// TPU has no faster way to add rows into a tile, but here each thread adds
// its own columns in fp32 registers, and the tensor cores would only turn
// a byte-bound sum into a wasteful product.  The sorted receivers become
// CSR offsets (built once on the host, graphs/structure.py: build_graph),
// and each receiver row is one contiguous range of message rows.
//
// Bound: bytes.  It adds one value per message element (E*F operations,
// about 52 M at the flagship encoder shape), far below the card's ratio of
// operations to bytes.  The least traffic is one read of msgs and indptr
// and one write of out.  At the flagship encoder shape (E_pad 203,648,
// R 172,034, F 256) in bf16 that is 104.3 MB read + 88.1 MB written (67.1 MB
// of it the 131,072 grid rows, which have no edges) = 193 MB, about 58 us
// at the H100 SXM's 3.35 TB/s.  Both designs read each message row once
// and write each output row once.
//
// Two designs, picked by shape alone (gclt_segment_sum_design; the Python
// mirror is ops/cuda_segment.py: segment_design).
//
// Balanced (fp32 or bf16 rows of 256-1024 bytes, a multiple of 16, on
// 16-byte aligned pointers: F = 64-256 in fp32, F = 128-512 in bf16):
//  * Work, not rows, is split.  The merged sequence of R row ends and E
//    edges (merge path, Merrill & Garland, SC'16) is cut into tiles of
//    kTileItems items, one a warp, kWarps warps a block, launched in order
//    so that the card's scheduler hands out tiles as warps finish.  An edge
//    moves one row in and a row end one row out, so equal tiles are equal
//    bytes: the empty rows of the encoder's grid band and the 346-edge rows
//    of its mesh band are spread over the warps alike.
//  * A tile boundary that falls inside a row of fewer than kTileItems items
//    moves back to that row's start, so only long rows are ever split.
//  * Each warp finds its tile's two ends in indptr (half a warp each, 16
//    probes a round, about four rounds at R = 172,034; the last round also
//    reads the ends that the move back needs).  Nothing is built on the
//    host, so every CSR (a receiver or, later, a sender order) takes the
//    kernel as it is.
//  * A tile's edges are one contiguous byte range.  Lane 0 streams it into
//    the warp's ring of kStages chunks of about kChunkBytes by
//    cp.async.bulk, each completing on an mbarrier, and refills a chunk as
//    soon as the warp has summed it.
//  * Lane l owns 16-byte pieces l and l + 32 of every row (8 bf16 or 4 fp32
//    columns each): it reads them from the chunk without bank conflicts and
//    adds them in fp32 registers in row order.  The row ends come from
//    indptr 32 rows at a time, one a lane, the next 32 loaded ahead, and
//    reach every lane by shuffles, so the walk does not diverge.  At a row
//    end the row is stored once in the messages' dtype; a run of empty rows
//    after it is found by one ballot over the 32 ends and written with
//    16-byte zero stores.
//  * A long row that crosses tiles (the 346-edge rows, a 50,000-edge
//    receiver) is stored by the last of its tiles to finish: each leaves
//    its fp32 piece in a workspace and counts in on the row's integer
//    counter; the last adds the pieces in tile order, stores the row once
//    and sets the counter back to zero.  No floating-point atomics: two
//    launches on the same inputs give bitwise-equal outputs.
//  * It launches as a programmatic dependent launch and waits
//    (griddepcontrol.wait) before it reads anything, so its blocks are
//    dispatched while the kernel before it drains.
//  * Designs tried and dropped (PERF.md, PR 6): one share a block with a
//    block-wide walk (the chain of shared-memory reads at each row end),
//    one persistent share a warp (warps whose shares hold the grid's empty
//    rows finish at half time while the others still run), a second
//    fix-up kernel (a launch more), persistent warps taking tiles in turn.
//
// Warp per row (PR 1's design; every other shape, e.g. F = 19, bf16 F = 64,
// fp32 F = 512, misaligned views):
//  * One warp per (receiver row, stripe of 32 x VEC features).  Each lane
//    loads 16 bytes per edge row (8 bf16 or 4 fp32 values), so one warp
//    covers 256 bf16 (128 fp32) features of a row per load.  The edge loop
//    is unrolled by 4 to keep four row loads in flight per lane.
//  * F that is not a multiple of VEC, or a misaligned pointer, takes the
//    scalar path: each lane still owns VEC consecutive features.
//  * Narrow rows on that path (F <= 16 x VEC, e.g. F = 19) take
//    segment_sum_narrow_kernel: the row's features need `slots` lanes, so
//    the warp's lanes form 32 / slots groups, each summing every groups-th
//    edge of the row, and the first group adds the others' sums in group
//    order by shuffles (a fixed order: every launch gives the same bits).
//    With one group, 3 of 32 lanes would walk a row's edges one by one.
//  * At the encoder shape its warps of the few high-degree rows run long,
//    and the 16,384 blocks of the grid band only write zeros.
//
// Both keep sums in fp32 and store each row once in the messages' dtype;
// a row with no edges is written with zeros (no memset).  A leading batch
// dim [B, E, F] runs in gridDim.z (warp) or gridDim.y (balanced) with
// strides, the counterpart of the Pallas vmap rule's fold of the batch
// into F; the balanced design cuts every batch item's work alike.

#include <climits>
#include <cstring>

#include "hopper.cuh"

namespace {

using gclt::bulk_load;
using gclt::mbar_init;
using gclt::mbar_wait;
using gclt::smem_u32;

// ---------------------------------------------------------------------------
// Warp per row.

constexpr int kWarpsPerBlock = 8;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void add(const Raw& v, float* acc) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  __device__ static void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(const Raw& v, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const T* __restrict__ msgs, const int* __restrict__ indptr,
                   T* __restrict__ out, int num_receivers, int num_features,
                   long long msgs_batch_stride, long long out_batch_stride) {
  using V = Vec<T>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int f0 = (blockIdx.y * 32 + lane) * V::N;
  if (r >= num_receivers || f0 >= num_features) return;

  const long long f = num_features;
  const T* src = msgs + blockIdx.z * msgs_batch_stride + f0;
  T* dst = out + blockIdx.z * out_batch_stride + r * f + f0;
  const int beg = __ldg(indptr + r);
  const int end = __ldg(indptr + r + 1);

  float acc[V::N];
#pragma unroll
  for (int j = 0; j < V::N; ++j) acc[j] = 0.0f;

  if (kVector) {
    int e = beg;
    for (; e + 4 <= end; e += 4) {
      const typename V::Raw v0 = V::load(src + e * f);
      const typename V::Raw v1 = V::load(src + (e + 1) * f);
      const typename V::Raw v2 = V::load(src + (e + 2) * f);
      const typename V::Raw v3 = V::load(src + (e + 3) * f);
      V::add(v0, acc);
      V::add(v1, acc);
      V::add(v2, acc);
      V::add(v3, acc);
    }
    for (; e < end; ++e) V::add(V::load(src + e * f), acc);
    V::store(dst, acc);
  } else {
    const int n = min(V::N, num_features - f0);
    for (int e = beg; e < end; ++e) {
      const T* row = src + e * f;
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        if (j < n) acc[j] += V::to_float(row[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      if (j < n) dst[j] = V::from_float(acc[j]);
    }
  }
}

// Narrow rows: see the header.  The grid is launch_warp's (one feature
// stripe); the whole warp takes row r.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_narrow_kernel(const T* __restrict__ msgs,
                          const int* __restrict__ indptr, T* __restrict__ out,
                          int num_receivers, int num_features,
                          long long msgs_batch_stride,
                          long long out_batch_stride) {
  using V = Vec<T>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= num_receivers) return;

  const int slots = (num_features + V::N - 1) / V::N;
  const int groups = 32 / slots;
  const int slot = lane % slots, group = lane / slots;
  const int f0 = slot * V::N;
  const int n = min(V::N, num_features - f0);
  const long long f = num_features;
  const T* src = msgs + blockIdx.z * msgs_batch_stride + f0;
  const int beg = __ldg(indptr + r);
  const int end = __ldg(indptr + r + 1);

  float acc[V::N];
#pragma unroll
  for (int j = 0; j < V::N; ++j) acc[j] = 0.0f;
  if (group < groups) {
    // Four of the group's rows in flight at a time, added in edge order.
    int e = beg + group;
    for (; e + 3 * groups < end; e += 4 * groups) {
      float v[4][V::N];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T* row = src + (e + k * groups) * f;
#pragma unroll
        for (int j = 0; j < V::N; ++j) {
          v[k][j] = j < n ? V::to_float(row[j]) : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < V::N; ++j) acc[j] += v[k][j];
      }
    }
    for (; e < end; e += groups) {
      const T* row = src + e * f;
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        if (j < n) acc[j] += V::to_float(row[j]);
      }
    }
  }
  // The first group adds the other groups' sums, in group order; every lane
  // takes part in the shuffles.
  for (int g = 1; g < groups; ++g) {
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float v = __shfl_sync(0xffffffffu, acc[j], g * slots + slot);
      if (group == 0) acc[j] += v;
    }
  }
  if (group == 0) {
    T* dst = out + blockIdx.z * out_batch_stride + r * f + f0;
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      if (j < n) dst[j] = V::from_float(acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch_warp(const void* msgs, const int* indptr, void* out,
                        int num_receivers, int num_features, int batch,
                        long long msgs_batch_stride,
                        long long out_batch_stride, cudaStream_t stream) {
  constexpr int vec = Vec<T>::N;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((num_receivers + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (num_features + 32 * vec - 1) / (32 * vec), batch);
  const bool aligned =
      num_features % vec == 0 && msgs_batch_stride % vec == 0 &&
      out_batch_stride % vec == 0 &&
      reinterpret_cast<unsigned long long>(msgs) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const T* m = static_cast<const T*>(msgs);
  T* o = static_cast<T*>(out);
  if (aligned) {
    segment_sum_kernel<T, true><<<grid, block, 0, stream>>>(
        m, indptr, o, num_receivers, num_features, msgs_batch_stride,
        out_batch_stride);
  } else if (num_features <= 16 * vec) {
    segment_sum_narrow_kernel<T><<<grid, block, 0, stream>>>(
        m, indptr, o, num_receivers, num_features, msgs_batch_stride,
        out_batch_stride);
  } else {
    segment_sum_kernel<T, false><<<grid, block, 0, stream>>>(
        m, indptr, o, num_receivers, num_features, msgs_batch_stride,
        out_batch_stride);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Balanced: merge-path tiles, one a warp, in launch order; bulk-copied edge
// runs; rows split across tiles summed by their last contributor.

constexpr int kTileItems = 20;      // merge items a tile, before snapping
constexpr int kWarps = 4;           // warps a block, one tile each
constexpr int kStages = 2;          // ring chunks a warp
constexpr int kChunkBytes = 2048;   // at most; a whole number of rows
constexpr int kMinRowBytes = 256;
constexpr int kMaxRowBytes = 1024;  // two 16-byte pieces a lane
// Shared memory: each warp's ring, then each warp's full barriers.
constexpr int kRingBytes = kStages * kChunkBytes;
constexpr int kBarOff = kWarps * kRingBytes;
constexpr int kSmemBytes = kBarOff + kWarps * kStages * 8;

bool balanced_shape(int dtype, int num_features, bool aligned) {
  const long long row_bytes =
      static_cast<long long>(num_features) * (dtype == 0 ? 4 : 2);
  return (dtype == 0 || dtype == 1) && aligned && row_bytes % 16 == 0 &&
         row_bytes >= kMinRowBytes && row_bytes <= kMaxRowBytes;
}

// One 16-byte piece of a row: N values of T, summed in fp32.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int N = 4;
  __device__ static void add(const uint4& v, float* acc) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void add(const uint4& v, float* acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 to fp32 is a 16-bit shift.
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* acc) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The merged sequence of R row ends and E edges: row end r sits at merge
// index indptr[r + 1] + r, edge e of row r at e + r.  Tile k begins at item
// k * kTileItems, moved back to the start of the row there unless that row
// has kTileItems items or more.  So only such long rows are split, and a
// boundary inside a long row is never moved: the tile that holds an item of
// a long row is its merge index / kTileItems.
struct Merge {
  const int* __restrict__ indptr;
  int num_receivers, num_edges, tiles;
  long long total;

  // The tile that holds merge index x of a long row.
  __device__ int tile_of(long long x) const {
    return static_cast<int>(x / kTileItems);
  }
  // Merge index of row end r (r < R).
  __device__ long long end_index(int r) const {
    return static_cast<long long>(__ldg(indptr + r + 1)) + r;
  }
};

// indptr[x] for the 32 rows x of a batch, one a lane (INT_MAX past
// indptr[R]).
__device__ __forceinline__ int load_ends(const int* __restrict__ indptr,
                                         int num_receivers, int first,
                                         int lane) {
  const int x = first + lane;
  return x <= num_receivers ? __ldg(indptr + x) : INT_MAX;
}

// One warp's walk over its tile: rows [i0, i1) end in it, edges [j0, j1)
// are in it.  Every member is the same in every lane but acc and lane;
// lane l owns 16-byte pieces l and l + 32 of every row (VPL of them).
template <typename T, int VPL>
struct Walk {
  using P = Piece<T>;
  Merge m;
  T* out;           // this batch item's output rows
  float* parts;     // this batch item's fp32 pieces [tiles, 2, F]
  int* counters;    // this batch item's arrivals, one a tile
  int num_features, pieces, lane, tile;
  int i0, i1, j0, r, row_start;  // row_start: the first edge of row r
  int eb, ends, ends_next;  // ends of rows [eb, eb + 32): indptr[eb + 1 + l]
  float acc[VPL][P::N];

  __device__ bool owns(int v) const { return lane + 32 * v < pieces; }

  // The end of row x (x >= eb: the walk only moves forward).
  __device__ int end_of(int x) {
    while (x - eb >= 32) {
      eb += 32;
      ends = ends_next;
      ends_next = load_ends(m.indptr, m.num_receivers, eb + 33, lane);
    }
    return __shfl_sync(0xffffffffu, ends, x - eb);
  }

  __device__ void clear() {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
#pragma unroll
      for (int n = 0; n < P::N; ++n) acc[v][n] = 0.0f;
    }
  }

  __device__ float* slot(int k, int s) const {
    return parts + (2LL * k + s) * num_features;
  }

  __device__ void store(int x, const float (&sum)[VPL][P::N]) {
    uint4* row =
        reinterpret_cast<uint4*>(out + static_cast<long long>(x) * num_features);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (owns(v)) row[lane + 32 * v] = P::pack(sum[v]);
    }
  }

  // This tile's piece of split row x, whose first edge is in tile `first`
  // and whose end is in tile `last`: into slot 0 (x ends here) or 1 (x
  // ends later).  The last of the last - first + 1 tiles to arrive adds the
  // pieces in tile order (slot 1 of first .. last - 1, slot 0 of last) and
  // stores the row once.
  __device__ void arrive(int x, int first, int last) {
    const int s = tile == last ? 0 : 1;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!owns(v)) continue;
      float4* p = reinterpret_cast<float4*>(slot(tile, s) +
                                            (lane + 32 * v) * P::N);
#pragma unroll
      for (int n = 0; n < P::N / 4; ++n) {
        p[n] = make_float4(acc[v][4 * n], acc[v][4 * n + 1],
                           acc[v][4 * n + 2], acc[v][4 * n + 3]);
      }
    }
    __threadfence();
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(counters + last, 1) == last - first;
    if (!__shfl_sync(0xffffffffu, done, 0)) return;
    __threadfence();
    float sum[VPL][P::N];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
#pragma unroll
      for (int n = 0; n < P::N; ++n) sum[v][n] = 0.0f;
    }
    for (int k = first; k <= last; ++k) {
      const float* piece = slot(k, k == last ? 0 : 1);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!owns(v)) continue;
        const float4* q =
            reinterpret_cast<const float4*>(piece + (lane + 32 * v) * P::N);
#pragma unroll
        for (int n = 0; n < P::N / 4; ++n) {
          const float4 f = __ldcg(q + n);
          sum[v][4 * n] += f.x;
          sum[v][4 * n + 1] += f.y;
          sum[v][4 * n + 2] += f.z;
          sum[v][4 * n + 3] += f.w;
        }
      }
    }
    store(x, sum);
    if (lane == 0) counters[last] = 0;  // ready for the next launch
  }

  // Close the rows that end at edge position e: row r (if it ends there),
  // then the run of empty rows after it, by 16-byte zero stores.
  __device__ void close(int e) {
    if (r >= i1 || end_of(r) != e) return;
    if (r == i0 && row_start < j0) {
      // Row i0 began in an earlier tile: a split row.
      arrive(r, m.tile_of(static_cast<long long>(row_start) + r), tile);
    } else {
      store(r, acc);
    }
    clear();
    ++r;
    row_start = e;
    while (r < i1) {
      end_of(r);  // the batch that holds row r
      const unsigned past =
          __ballot_sync(0xffffffffu, ends != e) & (0xffffffffu << (r - eb));
      const int x = min(i1, past ? eb + __ffs(past) - 1 : eb + 32);
      if (x == r) break;  // row r has edges
      uint4* z = reinterpret_cast<uint4*>(
          out + static_cast<long long>(r) * num_features);
      const int n16 = (x - r) * pieces;
      for (int q = lane; q < n16; q += 32) z[q] = make_uint4(0u, 0u, 0u, 0u);
      r = x;
    }
  }
};

// Tile k's first item: (rows ended, edges taken), found by this half-warp
// (lanes 0-15 and 16-31 find two tiles' at once).  The rows ended among the
// first d merge items are searched 16 probes a round, each round cutting
// the range about 16-fold, until at most 14 rows are left; a last round
// reads the ends of rows lo - 1 .. lo + 14, which hold the answer i and the
// ends of rows i - 1 and i that the move back to row i's start needs.
__device__ int2 tile_begin(const Merge& m, int k, int lane) {
  const long long d = min(static_cast<long long>(k) * kTileItems, m.total);
  int lo = static_cast<int>(max(0LL, d - m.num_edges));
  int hi = static_cast<int>(min(d, static_cast<long long>(m.num_receivers)));
  const int sub = lane & 15, half = lane & 16;
  while (__any_sync(0xffffffffu, hi - lo > 14)) {
    const bool wide = hi - lo > 14;
    const int step = (hi - lo + 15) / 16;
    const int r = lo + sub * step;
    const bool before = wide && r < hi && m.end_index(r) < d;
    const int n =
        __popc((__ballot_sync(0xffffffffu, before) >> half) & 0xffffu);
    if (wide) {
      const int nlo = n > 0 ? lo + (n - 1) * step + 1 : lo;
      hi = min(hi, lo + n * step);
      lo = nlo;
    }
  }
  const int r = lo - 1 + sub;  // end_index(-1) = indptr[0] - 1
  const long long end_r =
      r < m.num_receivers ? m.end_index(r) : 0x7fffffffffffffffLL;
  const bool before = r >= lo && r < hi && end_r < d;
  const int n = __popc((__ballot_sync(0xffffffffu, before) >> half) & 0xffffu);
  const int i = lo + n;
  // The ends of rows i - 1 and i sit in lanes n and n + 1 of this half.
  const long long end_prev = __shfl_sync(0xffffffffu, end_r, half + n);
  const long long end_i = __shfl_sync(0xffffffffu, end_r, half + n + 1);
  int j = static_cast<int>(d - i);
  if (i < m.num_receivers) {
    // Row i is under way at d: start the tile at the row's start instead,
    // unless the row is long.
    const int beg = static_cast<int>(end_prev - (i - 1));
    if (j > beg && end_i - end_prev < kTileItems) j = beg;
  }
  return make_int2(i, j);
}

// gridDim.x blocks of kWarps warps, a tile each, in launch order; gridDim.y
// batch items.  Every row whose edges and end lie in one tile is stored by
// that tile; a long row that crosses tiles is stored by the last of its
// tiles to finish, from their fp32 pieces in `partials` [batch, tiles, 2,
// F], counted in on `counters` [batch, tiles] (zero at entry and left
// zero).
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
balanced_kernel(const T* __restrict__ msgs, const int* __restrict__ indptr,
                T* __restrict__ out, float* __restrict__ partials,
                int* __restrict__ counters, int num_receivers,
                int num_edges, int num_features, long long msgs_batch_stride,
                long long out_batch_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff) + warp * kStages;
  Merge m;
  m.indptr = indptr;
  m.num_receivers = num_receivers;
  m.num_edges = num_edges;
  m.total = static_cast<long long>(num_receivers) + num_edges;
  m.tiles = static_cast<int>((m.total + kTileItems - 1) / kTileItems);
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= m.tiles) return;
  const int row_bytes = num_features * static_cast<int>(sizeof(T));

  // Both ends of the tile at once: lanes 0-15 its first item, 16-31 the
  // next tile's.
  const int2 found = tile_begin(m, tile + (lane >> 4), lane);
  const int i0 = __shfl_sync(0xffffffffu, found.x, 0);
  const int j0 = __shfl_sync(0xffffffffu, found.y, 0);
  const int i1 = __shfl_sync(0xffffffffu, found.x, 16);
  const int j1 = __shfl_sync(0xffffffffu, found.y, 16);

  // The tile's edge rows, chunk by chunk, round the warp's ring: the ring
  // is filled first, and each chunk refilled once the warp has summed it.
  const int chunk_rows = kChunkBytes / row_bytes;
  const int nchunks = (j1 - j0 + chunk_rows - 1) / chunk_rows;
  const T* src = msgs + blockIdx.y * msgs_batch_stride +
                 static_cast<long long>(j0) * num_features;
  auto fetch = [&](int c) {
    const int rows = min(chunk_rows, j1 - j0 - c * chunk_rows);
    bulk_load(smem_u32(ring + (c % kStages) * kChunkBytes),
              src + static_cast<long long>(c) * chunk_rows * num_features,
              static_cast<uint32_t>(rows * row_bytes), &full[c % kStages]);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(kStages, nchunks); ++c) fetch(c);
  }
  __syncwarp();

  using P = Piece<T>;
  Walk<T, VPL> w;
  w.m = m;
  w.out = out + blockIdx.y * out_batch_stride;
  w.parts = partials + static_cast<long long>(blockIdx.y) * m.tiles * 2 *
                           num_features;
  w.counters = counters + blockIdx.y * m.tiles;
  w.num_features = num_features;
  w.pieces = row_bytes / 16;
  w.lane = lane;
  w.tile = tile;
  w.i0 = i0;
  w.i1 = i1;
  w.j0 = j0;
  w.r = i0;
  w.row_start = i0 < num_receivers ? __ldg(indptr + i0) : j0;
  w.eb = i0;
  w.ends = load_ends(indptr, num_receivers, i0 + 1, lane);
  w.ends_next = load_ends(indptr, num_receivers, i0 + 33, lane);
  w.clear();

  w.close(j0);
  for (int c = 0; c < nchunks; ++c) {
    const int base = j0 + c * chunk_rows;
    const int n = min(chunk_rows, j1 - base);
    const unsigned char* stage =
        ring + (c % kStages) * kChunkBytes + 16 * lane;
    mbar_wait(&full[c % kStages], (c / kStages) & 1);
    int k = 0;
    while (true) {
      const int stop = w.r < i1 ? min(n, w.end_of(w.r) - base) : n;
#pragma unroll 4
      for (; k < stop; ++k) {
        const unsigned char* row = stage + k * row_bytes;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          if (w.owns(v)) {
            P::add(*reinterpret_cast<const uint4*>(row + 512 * v), w.acc[v]);
          }
        }
      }
      if (k >= n) break;
      w.close(base + k);
    }
    __syncwarp();
    if (lane == 0 && c + kStages < nchunks) fetch(c + kStages);
  }
  w.close(j1);
  // Row i1, if it has edges here or earlier, is long and ends in a later
  // tile.
  if (i1 < num_receivers && w.row_start < j1) {
    w.arrive(i1, m.tile_of(static_cast<long long>(w.row_start) + i1),
             m.tile_of(static_cast<long long>(w.end_of(i1)) + i1));
  }
}

long long balanced_tiles(int num_receivers, int num_edges) {
  return (static_cast<long long>(num_receivers) + num_edges + kTileItems -
          1) / kTileItems;
}

template <typename T, int VPL>
cudaError_t launch_balanced_vpl(const void* msgs, const int* indptr,
                                void* out, float* partials, int* counters,
                                int tiles, int num_receivers, int num_edges,
                                int num_features, int batch,
                                long long msgs_batch_stride,
                                long long out_batch_stride,
                                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      balanced_kernel<T, VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + kWarps - 1) / kWarps, batch);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, balanced_kernel<T, VPL>,
                           static_cast<const T*>(msgs), indptr,
                           static_cast<T*>(out), partials, counters,
                           num_receivers, num_edges, num_features,
                           msgs_batch_stride, out_batch_stride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_balanced(const void* msgs, const int* indptr, void* out,
                            void* workspace, long long workspace_size,
                            void* counters, int num_receivers, int num_edges,
                            int num_features, int batch,
                            long long msgs_batch_stride,
                            long long out_batch_stride, cudaStream_t stream) {
  const long long tiles = balanced_tiles(num_receivers, num_edges);
  if (workspace == nullptr || counters == nullptr ||
      workspace_size < 8LL * batch * tiles * num_features ||
      tiles > 0x7fffffffLL / 2) {
    return cudaErrorInvalidValue;
  }
  const int row_bytes = num_features * static_cast<int>(sizeof(T));
  const auto launch = row_bytes <= 512 ? launch_balanced_vpl<T, 1>
                                       : launch_balanced_vpl<T, 2>;
  return launch(msgs, indptr, out, static_cast<float*>(workspace),
                static_cast<int*>(counters), static_cast<int>(tiles),
                num_receivers, num_edges, num_features, batch,
                msgs_batch_stride, out_batch_stride, stream);
}

bool aligned16(const void* msgs, const void* out, int dtype,
               long long msgs_batch_stride, long long out_batch_stride) {
  const int size = dtype == 0 ? 4 : 2;
  return reinterpret_cast<unsigned long long>(msgs) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(out) % 16 == 0 &&
         msgs_batch_stride * size % 16 == 0 &&
         out_batch_stride * size % 16 == 0;
}

}  // namespace

// 1 where a launch takes the balanced design (dtype: 0 = float32, 1 =
// bfloat16; aligned: msgs, out and their batch strides are 16-byte
// aligned), 0 where it takes the warp-per-row design.
extern "C" int gclt_segment_sum_design(int dtype, int num_features,
                                       int aligned) {
  return balanced_shape(dtype, num_features, aligned != 0) ? 1 : 0;
}

// Merge items a tile of the balanced design (before snapping).  A launch
// on R receivers and E message rows has ceil((R + E) / items) tiles; its
// workspace is 8 * batch * tiles * F bytes (fp32 pieces [batch, tiles, 2,
// F], written before read) and its counters batch * tiles ints, zero before
// the first launch and left zero by every launch that ran to its end.
extern "C" int gclt_segment_sum_tile_items() { return kTileItems; }

// dtype: 0 = float32, 1 = bfloat16.  num_edges: the message rows (E_pad,
// at least indptr[R]; rows past indptr[R] belong to no receiver).  design:
// -1 picks by shape (gclt_segment_sum_design), 0 the warp-per-row design,
// 1 the balanced one (cudaErrorInvalidValue where the shape does not allow
// it, or where its workspace or counters are missing).  Returns
// cudaGetLastError() after the launch (a refused launch is reported only
// there).
extern "C" int gclt_segment_sum(const void* msgs, const void* indptr,
                                void* out, void* workspace,
                                long long workspace_size, void* counters,
                                int dtype, int num_receivers, int num_edges,
                                int num_features, int batch,
                                long long msgs_batch_stride,
                                long long out_batch_stride, int design,
                                void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool balanced_ok = balanced_shape(
      dtype, num_features,
      aligned16(msgs, out, dtype, msgs_batch_stride, out_batch_stride));
  if (design < 0) design = balanced_ok ? 1 : 0;
  cudaError_t err;
  if (design == 1) {
    if (!balanced_ok) return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 0
              ? launch_balanced<float>(msgs, ip, out, workspace,
                                       workspace_size, counters,
                                       num_receivers, num_edges, num_features,
                                       batch, msgs_batch_stride,
                                       out_batch_stride, s)
              : launch_balanced<__nv_bfloat16>(
                    msgs, ip, out, workspace, workspace_size, counters,
                    num_receivers, num_edges, num_features, batch,
                    msgs_batch_stride, out_batch_stride, s);
  } else if (design == 0) {
    err = dtype == 0
              ? launch_warp<float>(msgs, ip, out, num_receivers, num_features,
                                   batch, msgs_batch_stride, out_batch_stride,
                                   s)
              : launch_warp<__nv_bfloat16>(msgs, ip, out, num_receivers,
                                           num_features, batch,
                                           msgs_batch_stride,
                                           out_batch_stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
