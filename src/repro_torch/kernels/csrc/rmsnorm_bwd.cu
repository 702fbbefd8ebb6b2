// RMSNorm backward for Hopper (sm_90a): kernel K3b, the backward of K3 on
// the port's kernel-path train step (every block norm and the final norm).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel and
// takes the gradient by autodiff through its plain norm
// (src/repro/train/train_step.py:32 through kernels/ref.py).  This kernel
// computes that gradient.  Per row of width D, with g = dy * scale and
// r = rsqrt(mean(x^2) + eps), all in f32:
//   dx = r g - x r^3 mean(g x)          (stored in x's dtype)
//   dscale = sum over rows of dy x r    (stored in scale's dtype)
//
// Bound.  It reads x and dy once and writes dx once (and a D-wide dscale):
// at 4096 x 2048 bf16 that is 50.3 MB, 0.015 ms at 3.35 TB/s, against ~10
// f32 operations an element.  So it is bound by bytes.
//
// Design (a simple first form).  dscale is a sum across rows, kept
// deterministic without float atomics: block b walks a contiguous run of
// rows and accumulates its share of dscale per column in shared memory
// (each column owned by one thread, so no two threads add to one value),
// then writes it as row b of a (blocks, D) f32 buffer; a second kernel sums
// that buffer's rows in order, a thread per column.  A row takes two passes
// over x and dy: the block sums x^2 and g x (one barrier: the reduction
// buffer alternates between rows), then writes dx.  Rows are read through a
// row stride with the last dim contiguous (x and dy each), so strided views
// are read in place; element loads, bf16 converted only through the
// intrinsics.  Vector loads are later work: 0.0756 ms at 4096 x 2048
// bf16 on an H100 with x and dy read from device memory, 5.0x the bound,
// against 0.0406 for F.rms_norm's backward (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// the sums of a and b over the block; red holds two values a warp
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  for (int off = 16; off > 0; off /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
}

// T: x, dy and dx; S: scale.  Block b takes rows [b * rpb, (b + 1) * rpb).
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int D, long long rpb, long long x_stride,
                   long long dy_stride, float eps) {
  extern __shared__ float acc[];  // this block's dscale, D floats
  __shared__ float red[2][2 * kWarps];
  const int tid = threadIdx.x;
  for (int i = tid; i < D; i += kThreads) acc[i] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = min(rows, r0 + rpb);
  const float inv_d = 1.f / static_cast<float>(D);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * x_stride;
    const T* dyr = dy + row * dy_stride;
    float ss = 0.f, gx = 0.f;
    for (int i = tid; i < D; i += kThreads) {
      const float xf = to_f32(xr[i]);
      const float g = to_f32(dyr[i]) * to_f32(scale[i]);
      ss = fmaf(xf, xf, ss);
      gx = fmaf(g, xf, gx);
    }
    block_sum2(ss, gx, red[(row - r0) & 1]);
    const float r = 1.f / sqrtf(ss * inv_d + eps);
    const float c = r * r * r * (gx * inv_d);
    T* dxr = dx + row * D;
    for (int i = tid; i < D; i += kThreads) {
      const float xf = to_f32(xr[i]);
      const float dyf = to_f32(dyr[i]);
      const float g = dyf * to_f32(scale[i]);
      dxr[i] = from_f32<T>(r * g - xf * c);
      acc[i] = fmaf(dyf * xf, r, acc[i]);
    }
  }
  // each column of acc was only ever touched by its own thread
  for (int i = tid; i < D; i += kThreads) partial[static_cast<long long>(blockIdx.x) * D + i] = acc[i];
}

// dscale[j] = sum over blocks b, in order, of partial[b][j]
template <typename S>
__global__ void __launch_bounds__(kThreads)
dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int nblocks, int D) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= D) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<long long>(b) * D + j];
  dscale[j] = from_f32<S>(s);
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, const void* dy, void* dx, float* partial,
                   void* dscale, long long rows, int D, long long rpb, int nblocks,
                   long long x_stride, long long dy_stride, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd_kernel<T, S><<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, D, rpb, x_stride, dy_stride, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dscale_kernel<S><<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, static_cast<S*>(dscale), nblocks, D);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  x and dy: rows of D elements with row
// strides x_stride and dy_stride (elements), last dim contiguous; scale: D
// elements of s_dtype (float32 or x's dtype); dx: contiguous (rows, D) of
// x's dtype; partial: (nblocks, D) float32 scratch, nblocks * rpb >= rows;
// dscale: D elements of s_dtype.  Returns the launches' cudaError_t (0 on
// success).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           float* partial, void* dscale, int x_dtype, int s_dtype,
                           long long rows, int D, long long rpb, int nblocks,
                           long long x_stride, long long dy_stride, float eps, void* stream) {
  if (rows <= 0 || D <= 0 || rpb <= 0 || nblocks <= 0 ||
      static_cast<long long>(nblocks) * rpb < rows)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return int(launch<float, float>(x, scale, dy, dx, partial, dscale, rows, D, rpb, nblocks,
                                    x_stride, dy_stride, eps, st));
  if (x_dtype == 1 && s_dtype == 1)
    return int(launch<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows, D,
                                                    rpb, nblocks, x_stride, dy_stride, eps, st));
  if (x_dtype == 1 && s_dtype == 0)
    return int(launch<__nv_bfloat16, float>(x, scale, dy, dx, partial, dscale, rows, D, rpb,
                                            nblocks, x_stride, dy_stride, eps, st));
  return int(cudaErrorInvalidValue);
}
