// RMSNorm for Hopper (sm_90a): kernel K3, on the norm path of the port's
// kernel-path `forward` (every block norm and the final norm).
//
// Replaces the TPU kernel `rmsnorm` / `_kernel` in
// src/repro/kernels/rmsnorm.py (pallas_call at :30): per row of width D,
//   out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and stored in x's dtype, as the JAX package's plain norm
// (models/layers.py:64) and kernels/ref.py do.
//
// Design.  The TPU kernel tiles 256 rows a grid step and pads the row count
// to a multiple of 256; here one block of 256 threads owns one row, so any
// number of rows runs unpadded.  Pass 1 loads the row (16-byte vectors when
// the row and its stride are aligned, else element by element), squares and
// sums in f32, and reduces across the block (warp shuffles, then one value
// per warp in shared memory).  Pass 2 reads the row again (an L1/L2 hit:
// 4-16 KB a row at the model widths), scales it and stores x's dtype.  A
// warp per row holding the row in registers (one pass) was no faster at
// 2048 and slower at 4096, where its registers cut the resident warps.
// Rows are read through a row stride with the last dim contiguous, so a
// strided view is read in place.  bf16 converts only through the
// intrinsics.
//
// Bound.  The function reads x and scale once and writes the output once:
// at 4096 x 2048 bf16 that is 33.6 MB, 0.010 ms at 3.35 TB/s; it does ~4
// f32 operations an element, far below the compute bound.  So it is bound
// by bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one element of the output, in f32: (x * inv_rms) * scale
__device__ __forceinline__ float normed(float xf, float inv, float s) { return xf * inv * s; }

// one 16-byte vector of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// T: x and out; S: scale.  VEC: 16-byte loads and stores.
template <typename T, typename S, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               int D, long long x_stride, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + blockIdx.x * x_stride;
  T* orow = out + static_cast<long long>(blockIdx.x) * D;
  float ss = 0.f;
  if (VEC) {
    constexpr int NV = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    for (int i = threadIdx.x; i < D / NV; i += kThreads) {
      const Vec<T> v = xv[i];
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float f = to_f32(v.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float inv = 1.0f / sqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
  if (VEC) {
    constexpr int NV = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(orow);
    for (int i = threadIdx.x; i < D / NV; i += kThreads) {
      const Vec<T> v = xv[i];
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        o.v[e] = from_f32<T>(normed(to_f32(v.v[e]), inv, to_f32(scale[i * NV + e])));
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      orow[i] = from_f32<T>(normed(to_f32(xr[i]), inv, to_f32(scale[i])));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int D,
                   long long x_stride, float eps, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (x_stride * sizeof(T)) % 16 == 0 && (D * sizeof(T)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec)
    rmsnorm_kernel<T, S, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), D,
        x_stride, eps);
  else
    rmsnorm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), D,
        x_stride, eps);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  x: rows of D elements, row stride
// x_stride (elements), last dim contiguous; scale: D elements of s_dtype
// (float32 or x's dtype); out: contiguous (rows, D) of x's dtype.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int x_dtype,
                           int s_dtype, long long rows, int D, long long x_stride, float eps,
                           void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return int(launch<float, float>(x, scale, out, rows, D, x_stride, eps, st));
  if (x_dtype == 1 && s_dtype == 1)
    return int(launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, x_stride, eps, st));
  if (x_dtype == 1 && s_dtype == 0)
    return int(launch<__nv_bfloat16, float>(x, scale, out, rows, D, x_stride, eps, st));
  return int(cudaErrorInvalidValue);
}
