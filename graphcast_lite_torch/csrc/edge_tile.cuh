// Shared building blocks of the fused edge kernels' 16-receiver design
// (edge_mlp.cu, edge_step.cu), for Hopper (sm_90a).  It runs both kernels'
// rows wider than 256, in fp32 and bf16; at H and De in {128, 256} both
// kernels run designs of their own in both dtypes (hopper.cuh).
//
// Both kernels walk receiver-sorted edge rows by CSR ranges: one block of
// kThreads threads owns kTileReceivers consecutive receivers and every edge
// row of theirs (indptr[r0] .. indptr[r1]), in sub-tiles of kRows rows.
// Per sub-tile a [kRows, K] operand sits in shared memory and is multiplied
// by a weight matrix W [K, N] read from L2 (the weights are small and stay
// resident), kChunk output columns at a time, into an fp32 tile in shared
// memory.  bf16 runs on the tensor cores (nvcuda::wmma 16x16x16, fp32
// accumulation); fp32 runs in full fp32 on the FMA units (no TF32) here,
// where both kernels' fp32 Hopper designs multiply in 3xTF32.
// The block sums each receiver's rows into its own fp32 rows in shared
// memory, in row order, and writes each aggregate row once: no atomics, so
// results are deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gclt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;          // edge rows per sub-tile
constexpr int kTileReceivers = 16; // receivers per block
constexpr int kChunk = 128;        // output columns per product pass
constexpr int kPad = 8;            // row padding of the operand tiles
constexpr int kLdc = kChunk + 4;   // row stride of the fp32 product tile

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
  // Round to the working type (identity in fp32).
  __device__ static float rd(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  __device__ static float rd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// act: 0 = swish / silu, 1 = relu.  fp32, as the reference's kernels.
__device__ __forceinline__ float activate(float x, int act) {
  return act == 0 ? x / (1.0f + expf(-x)) : fmaxf(x, 0.0f);
}

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Byte offsets of the dynamic shared memory of one block.  The edge step
// (with_v) also keeps the v rows of the sub-tile and its block's xr rows.
struct Layout {
  int indptr, recv, mask, red, agg, c, a, v, xr, total;
};

__host__ __device__ inline Layout make_layout(int elt_bytes, int h, int de,
                                              bool with_v) {
  Layout l;
  int off = 0;
  l.indptr = off; off = align128(off + (kTileReceivers + 1) * 4);
  l.recv = off;   off = align128(off + kRows * 4);
  l.mask = off;   off = align128(off + kRows * 4);
  l.red = off;    off = align128(off + kWarps * 3 * 4);
  l.agg = off;    off = align128(off + kTileReceivers * de * 4);
  l.c = off;      off = align128(off + kRows * kLdc * 4);
  l.a = off;      off = align128(off + kRows * (h + kPad) * elt_bytes);
  l.v = l.xr = off;
  if (with_v) {
    off = align128(off + kRows * (de + kPad) * elt_bytes);
    l.xr = off;
    off = align128(off + kTileReceivers * h * elt_bytes);
  }
  l.total = off;
  return l;
}

extern __shared__ __align__(128) unsigned char smem[];

// The block's receivers [r0, r0 + nr): their CSR offsets into indptr_s and
// zeroed fp32 aggregate rows.
__device__ inline int begin_block(const int* __restrict__ indptr,
                                  int num_receivers, int* indptr_s,
                                  float* agg_s, int de) {
  const int r0 = blockIdx.x * kTileReceivers;
  const int nr = min(kTileReceivers, num_receivers - r0);
  for (int i = threadIdx.x; i <= nr; i += kThreads) indptr_s[i] = indptr[r0 + i];
  for (int i = threadIdx.x; i < nr * de; i += kThreads) agg_s[i] = 0.0f;
  __syncthreads();
  return nr;
}

// Row metadata of the sub-tile at e0: each row's receiver within the block
// and its mask (0 for rows past the sub-tile's end).
template <typename T>
__device__ inline void row_meta(const T* __restrict__ mask, const int* indptr_s,
                                int e0, int nrows, int* recv_s, float* mask_s) {
  const int i = threadIdx.x;
  if (i < kRows) {
    int r = 0;
    float m = 0.0f;
    if (i < nrows) {
      const int e = e0 + i;
      while (indptr_s[r + 1] <= e) ++r;
      m = Elt<T>::to_f(mask[e]);
    }
    recv_s[i] = r;
    mask_s[i] = m;
  }
}

// Copy nrows rows of ncols (a multiple of 128) into a [rows, ld] tile with
// 16-byte loads, zero-filling the rows past nrows; with act >= 0 the
// activation is applied on the way (in fp32, rounded to T).  Each thread
// issues kBatch loads before it stores any, so that they are in flight
// together.
template <typename T>
__device__ inline void load_rows(T* dst, int ld, const T* __restrict__ src,
                                 int nrows, int ncols, int act,
                                 int rows = kRows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBatch = 4;
  const int per_row = ncols / kVec;
  const int total = rows * per_row;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      const int row = i / per_row;
      const int col = (i - row * per_row) * kVec;
      raw[b] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && row < nrows) {
        raw[b] = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(row) * ncols + col));
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i >= total) break;
      const int row = i / per_row;
      const int col = (i - row * per_row) * kVec;
      if (act >= 0 && row < nrows) {
        T* p = reinterpret_cast<T*>(&raw[b]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          p[k] = Elt<T>::from_f(activate(Elt<T>::to_f(p[k]), act));
        }
      }
      *reinterpret_cast<uint4*>(dst + row * ld + col) = raw[b];
    }
  }
}

// c_s[kRows, kChunk] (fp32, row stride kLdc) = a_s[kRows, k] @
// w[:, col0 : col0 + kChunk], with w row-major [k, ldw].
template <typename T>
__device__ void tile_product(const T* a_s, int lda, const T* __restrict__ w,
                             int ldw, int col0, int k, float* c_s);

template <>
__device__ inline void tile_product<__nv_bfloat16>(
    const __nv_bfloat16* a_s, int lda, const __nv_bfloat16* __restrict__ w,
    int ldw, int col0, int k, float* c_s) {
  using namespace nvcuda;
  // Eight warps, each 16 output columns by all 64 rows (four 16-row bands),
  // so every W fragment is read from L2 once per sub-tile.
  static_assert(kChunk == kWarps * 16 && kRows == 64, "tile shape");
  const int cw = (threadIdx.x >> 5) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  // Four W fragments (a 64-deep slab) are loaded before they are used, so
  // their L2 reads are in flight together; k is a multiple of 128.
  for (int k0 = 0; k0 < k; k0 += 64) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wmma::load_matrix_sync(
          fb[q], w + static_cast<size_t>(k0 + 16 * q) * ldw + col0 + cw, ldw);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fa, a_s + 16 * j * lda + k0 + 16 * q, lda);
        wmma::mma_sync(acc[j], fa, fb[q], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(c_s + 16 * j * kLdc + cw, acc[j], kLdc,
                            wmma::mem_row_major);
  }
}

template <>
inline __device__ void tile_product<float>(const float* a_s, int lda,
                                           const float* __restrict__ w,
                                           int ldw, int col0, int k,
                                           float* c_s) {
  // Each thread: 4 rows x 8 columns, fp32 FMA in k order.
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const float* wp = w + col0 + tx * 8;
  const float* ap = a_s + (ty * 4) * lda;
  for (int kk = 0; kk < k; ++kk) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(
        wp + static_cast<size_t>(kk) * ldw));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(
        wp + static_cast<size_t>(kk) * ldw + 4));
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = ap[i * lda + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c_s[(ty * 4 + i) * kLdc + tx * 8 + j] = acc[i][j];
}

// agg_s[recv_s[row], col0 + c] += c_s[row, c] for the sub-tile's rows, in
// row order (one thread per column: no two threads touch one element).
__device__ inline void aggregate_rows(const float* c_s, const int* recv_s,
                                      int nrows, float* agg_s, int de,
                                      int col0) {
  const int c = threadIdx.x;
  if (c < kChunk) {
    for (int row = 0; row < nrows; ++row) {
      agg_s[recv_s[row] * de + col0 + c] += c_s[row * kLdc + c];
    }
  }
}

// Write the block's fp32 aggregate rows once, in T (empty receivers: 0).
template <typename T>
__device__ inline void store_agg(const float* agg_s, int nr, int de,
                                 T* __restrict__ agg) {
  T* dst = agg + static_cast<size_t>(blockIdx.x) * kTileReceivers * de;
  for (int i = threadIdx.x; i < nr * de; i += kThreads) {
    dst[i] = Elt<T>::from_f(agg_s[i]);
  }
}

}  // namespace gclt
