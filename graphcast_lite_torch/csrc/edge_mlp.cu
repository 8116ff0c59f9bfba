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
// receiver-sorted rows become CSR ranges, and a block owns 16 consecutive
// receivers and every edge row of theirs (edge_tile.cuh), so the block
// sums its receivers' rows in shared memory and writes each aggregate row
// once, with no atomics and no schedule.
//
// Rounding points follow the reference: activation in fp32 and rounded to
// T; the product accumulated in fp32; b2 added in fp32; one cast to T;
// the aggregate sums the cast u in fp32 and is cast to T once.  Padding
// rows (receiver R-1's range, mask 0) get a u row and add nothing.
//
// Bound: bytes.  Per edge row it reads H values and writes De values and
// does 2*H*De operations: at H = De = 256 in bf16, 131,072 operations per
// 1 KB moved, 128 per byte, below the H100's 295.  At the flagship
// processor shape (E_pad 261,120, R 40,962, H = De = 256, bf16) the least
// traffic is 133.7 MB of h_pre read, 133.7 MB of u and 21.0 MB of agg
// written: about 86 us at 3.35 TB/s.  The design reads h_pre once and
// writes u and agg once; the weights (128 KB) come from L2 for every
// sub-tile, which is the cost this first version leaves (no TMA, no
// wgmma, one 64-row sub-tile in flight per block).

#include "edge_tile.cuh"

namespace {

using namespace gclt;

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

template <typename T>
int launch(const void* h, const void* w2, const void* b2, const void* mask,
           const int* indptr, void* u, void* agg, int num_receivers, int hid,
           int de, int act, cudaStream_t stream) {
  const int bytes = make_layout(sizeof(T), hid, de, false).total;
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_receivers + kTileReceivers - 1) / kTileReceivers;
  edge_mlp_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(mask), indptr,
      static_cast<T*>(u), static_cast<T*>(agg), num_receivers, hid, de, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block needs (dtype: 0 = float32, 1 = bfloat16).
extern "C" int gclt_edge_mlp_smem(int dtype, int hid, int de) {
  return make_layout(dtype == 0 ? 4 : 2, hid, de, false).total;
}

// dtype: 0 = float32, 1 = bfloat16; act: 0 = swish/silu, 1 = relu.
// Returns cudaGetLastError() after the launch.
extern "C" int gclt_edge_mlp(const void* h, const void* w2, const void* b2,
                             const void* mask, const void* indptr, void* u,
                             void* agg, int dtype, int num_receivers, int hid,
                             int de, int act, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(h, w2, b2, mask, ip, u, agg, num_receivers, hid, de,
                         act, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(h, w2, b2, mask, ip, u, agg, num_receivers,
                                 hid, de, act, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
