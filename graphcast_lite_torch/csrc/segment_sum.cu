// Sorted segment sum over CSR receiver ranges, for Hopper (sm_90a).
//
//   out[b, r, :] = sum over e in [indptr[r], indptr[r+1]) of msgs[b, e, :]
//
// Replaces the Pallas TPU kernel
// graphcast_lite_tpu/ops/pallas_segment.py: segment_sum_sorted (forward;
// _kernel and _segment_sum_impl).  That kernel accumulates each 1024-edge
// chunk into its receiver tile as a one-hot matmul on the MXU behind a DMA
// ring; none of that carries over.  Here the sorted receivers become CSR
// offsets (built once on the host, graphs/structure.py: build_graph), and
// each receiver row is one contiguous range of message rows.
//
// Design:
//  * One warp per (receiver row, stripe of 32 x VEC features).  Each lane
//    loads 16 bytes per edge row (8 bf16 or 4 fp32 values), so one warp
//    covers 256 bf16 (128 fp32) features of a row per load.  The edge loop
//    is unrolled by 4 to keep four row loads in flight per lane.
//  * Sums are kept in fp32 registers and stored once in the messages'
//    dtype.  Every row is written, and a row with no edges writes zeros:
//    no memset, no schedule, no atomics, so the result is deterministic.
//  * A leading batch dim [B, E, F] runs in gridDim.z with strides (the
//    counterpart of the Pallas vmap rule's fold of the batch into F).
//  * F that is not a multiple of VEC (e.g. 19), or a misaligned pointer,
//    takes the scalar path: each lane still owns VEC consecutive features.
//
// Bound: bytes.  It adds one value per message element (E*F operations),
// so it sits far below the card's ratio of operations to bytes.  The least
// traffic is one read of msgs and indptr and one write of out.  At the
// flagship encoder shape (E_pad 203,648, R 172,034, F 256) in bf16 that is
// 104.3 MB read + 88.1 MB written = 193 MB, about 58 us at the H100 SXM's
// 3.35 TB/s (about 115 us in fp32).  Each message row is read exactly once
// (rows are owned by one receiver) and each output row written once, so
// the design moves exactly that least traffic.  What it does not fix yet:
// the encoder's in-degree is skewed (max 346, mean about 5), so the warps of
// the few high-degree rows run long, and 131,072 of the 172,034 rows have
// no edges and only write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
void launch(const void* msgs, const int* indptr, void* out, int num_receivers,
            int num_features, int batch, long long msgs_batch_stride,
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
  } else {
    segment_sum_kernel<T, false><<<grid, block, 0, stream>>>(
        m, indptr, o, num_receivers, num_features, msgs_batch_stride,
        out_batch_stride);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (a refused launch is reported only there).
extern "C" int gclt_segment_sum(const void* msgs, const void* indptr,
                                void* out, int dtype, int num_receivers,
                                int num_features, int batch,
                                long long msgs_batch_stride,
                                long long out_batch_stride, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(msgs, ip, out, num_receivers, num_features, batch,
                  msgs_batch_stride, out_batch_stride, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(msgs, ip, out, num_receivers, num_features, batch,
                          msgs_batch_stride, out_batch_stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
