// RMSNorm for Hopper (sm_90a): kernel K3, on the norm path of the port's
// kernel-path `forward` (every block norm and the final norm).
//
// Replaces the TPU kernel `rmsnorm` / `_kernel` in
// src/repro/kernels/rmsnorm.py (pallas_call at :30): per row of width D,
//   out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and stored in x's dtype, as the JAX package's plain norm
// (models/layers.py:64) and kernels/ref.py do.
//
// Bound.  The function reads x and scale once and writes the output once:
// at 4096 x 2048 bf16 that is 33.6 MB, 0.010 ms at 3.35 TB/s; it does ~4
// f32 operations an element, far below the compute bound.  So it is bound
// by bytes, and the design is about keeping bytes in flight.
//
// Design.  The TPU kernel tiles 256 rows a grid step and pads the row count
// to a multiple of 256; here a block of 256 threads walks ROWS = 2
// consecutive rows (the last block masks the tail), so any number of rows
// runs unpadded.  Two forms:
// - the register form (`rmsnorm_rows_kernel`), for rows of exactly VPT
//   16-byte vectors a thread (VPT = 1, 2, 4: 2048 and 4096 wide in bf16,
//   2048 and 4096 in f32) with a scale of x's dtype and aligned rows.  The
//   scale is loaded into registers once per block as 16-byte vectors; a
//   row is loaded once into registers and stays there between the sum of
//   squares and the scaled store (no second read); the next row's loads
//   are issued before the current row's block reduction, so each block
//   keeps a row of bytes in flight across its barrier.  The reduction
//   buffer alternates between rows, so one barrier a row suffices.  Loads
//   and stores carry streaming hints.
// - the general form (`rmsnorm_kernel`), one block a row: any width (the
//   ragged 1600), unaligned rows (element loads) and an f32 scale with bf16
//   x.  Pass 1 sums squares, pass 2 reads the row again (an L1/L2 hit) and
//   stores.
// Measured with chip_compare.py on one NVIDIA H100 80GB HBM3, 700.00 W
// (PERF.md, PR 18), K3's mean device time inside a kernel-path forward
// (x just written by the layer before), llama3.2-1b
// (2048 wide) / rwkv6-7b (4096): 2 rows a block 0.00850 / 0.01891 ms, 4
// rows 0.00909 / 0.01924, 8 rows 0.00980 / 0.02005, one block a row (the
// form before) 0.01176 / 0.02748; without the hints 2 rows read 0.00887 /
// 0.02233 and 8 rows 0.00984 / 0.02105, so the hints stay.  On x read from
// device memory the order of 2, 4 and 8 rows changes from run to run
// (0.0111-0.0118 ms at 4096 x 2048); the form before read 0.0143 and
// F.rms_norm 0.0145.  A warp per row (one pass, PR 15) was slower at
// 4096: its registers cut the resident warps.  Rows are read
// through a row stride with the last dim contiguous, so a strided view is
// read in place.  bf16 converts only through the intrinsics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a block of the register form walks
constexpr int ROWS = 2;

// x loads and out stores of the register form: 16-byte vectors with
// streaming hints (each byte is read or written once)
template <typename V>
__device__ __forceinline__ V ld_row(const V* p) {
  static_assert(sizeof(V) == 16, "one 16-byte vector");
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  V v;
  memcpy(&v, &u, sizeof(V));
  return v;
}
template <typename V>
__device__ __forceinline__ void st_row(V* p, const V& v) {
  uint4 u;
  memcpy(&u, &v, sizeof(V));
  __stcs(reinterpret_cast<uint4*>(p), u);
}

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

// 1 / rms of a row from its sum of squares
__device__ __forceinline__ float inv_rms(float ss, int D, float eps) {
  return 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
}

// one element of the output, in f32: (x * inv_rms) * scale
__device__ __forceinline__ float normed(float xf, float inv, float s) { return xf * inv * s; }

// one 16-byte vector of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// the sum of v over the block; red holds one value a warp
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// The register form.  T: x, scale and out.  Vector i of a row is
// threadIdx.x + i * kThreads, so a warp's loads are contiguous.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                    long long rows, int D, long long x_stride, float eps) {
  __shared__ float red[2][kWarps];
  constexpr int NV = Vec<T>::N;
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int n = static_cast<int>(min(static_cast<long long>(ROWS), rows - r0));
  const int tid = threadIdx.x;

  Vec<T> sc[VPT], cur[VPT], nxt[VPT];
  const Vec<T>* sv = reinterpret_cast<const Vec<T>*>(scale);
#pragma unroll
  for (int i = 0; i < VPT; ++i) sc[i] = sv[tid + i * kThreads];
  {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + r0 * x_stride);
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = ld_row(xv + tid + i * kThreads);
  }
  for (int row = 0; row < n; ++row) {
    if (row + 1 < n) {  // the next row's bytes stay in flight across the barrier
      const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + (r0 + row + 1) * x_stride);
#pragma unroll
      for (int i = 0; i < VPT; ++i) nxt[i] = ld_row(xv + tid + i * kThreads);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float f = to_f32(cur[i].v[e]);
        ss = fmaf(f, f, ss);
      }
    const float inv = inv_rms(block_sum(ss, red[row & 1]), D, eps);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(out + (r0 + row) * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        o.v[e] = from_f32<T>(normed(to_f32(cur[i].v[e]), inv, to_f32(sc[i].v[e])));
      st_row(ov + tid + i * kThreads, o);
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

// The general form.  T: x and out; S: scale.  VEC: 16-byte loads and
// stores of x and out.
template <typename T, typename S, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               int D, long long x_stride, float eps) {
  __shared__ float red[kWarps];
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
  const float inv = inv_rms(block_sum(ss, red), D, eps);
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
  // 16-byte vectors a thread when a row is exactly that many per thread
  const long long row_bytes = static_cast<long long>(D) * sizeof(T);
  const int vpt = row_bytes % (16 * kThreads) == 0 ? static_cast<int>(row_bytes / (16 * kThreads)) : 0;
  const bool regs = vec && sizeof(S) == sizeof(T) && reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    (vpt == 1 || vpt == 2 || vpt == 4);
  if (regs) {
    const T* xt = static_cast<const T*>(x);
    const T* st = static_cast<const T*>(scale);
    T* ot = static_cast<T*>(out);
    const dim3 grid(static_cast<unsigned>((rows + ROWS - 1) / ROWS));
    if (vpt == 1)
      rmsnorm_rows_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xt, st, ot, rows, D, x_stride, eps);
    else if (vpt == 2)
      rmsnorm_rows_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xt, st, ot, rows, D, x_stride, eps);
    else
      rmsnorm_rows_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xt, st, ot, rows, D, x_stride, eps);
    return cudaGetLastError();
  }
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
