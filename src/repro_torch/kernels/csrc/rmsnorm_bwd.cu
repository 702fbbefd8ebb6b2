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
// dscale is a sum across rows, kept deterministic without float atomics:
// block b walks a contiguous run of rows (``rmsnorm_bwd.plan`` picks how
// many, from the shape and the SM count), keeps its share of dscale per
// column, and writes it as row b of a (blocks, D) f32 buffer; a second
// kernel (`dscale_kernel`) sums that buffer over the blocks in a fixed
// order: 8 segments of the blocks a column, each summed in order, then the
// segments in order.  Two forms of the first kernel:
// - the register form (`rmsnorm_bwd_rows_kernel`), K3's register form
//   carried over: rows of exactly VPT 16-byte vectors a thread (VPT = 1,
//   2, 4: 2048 and 4096 wide in bf16 and in f32), a scale of x's dtype,
//   16-byte aligned rows.  A thread owns the same columns on every row, so
//   its scale sits in registers and its share of dscale is summed in
//   registers across the block's rows, with no shared memory.  The rows of
//   x and dy are read once, as 16-byte vectors with streaming hints, and
//   stay in registers between the row's sums and its dx; the next row's
//   loads are issued before the current row's block reduction, and the
//   reduction buffer alternates between rows, so one barrier a row.
// - the general form (`rmsnorm_bwd_kernel`), for what the register form
//   does not take: other widths (the ragged 1600), unaligned rows, an f32
//   scale with bf16 x.  Element loads, two passes over a row (sums, then
//   dx), dscale per column in shared memory, each column owned by one
//   thread.
// Rows are read through a row stride with the last dim contiguous (x and dy
// each), so strided views are read in place.  bf16 converts only through
// the intrinsics.
//
// Measured with chip_compare.py on one NVIDIA H100 80GB HBM3, 700.00 W,
// with x and dy read from device memory (PERF.md): this form (the
// register form at both main shapes) 0.02324 ms at 4096 x 2048 bf16 (1.55x
// the bound) and 0.04284 at 4096 x 4096, against 0.04518 and 0.08157 for
// F.rms_norm's backward; 0.02114 a call inside a llama3.2-1b train step's
// backward.  The first form (the general form at every shape, two
// blocks an SM, the partials summed by one thread a column over all
// blocks) took 0.07549 and 0.13820, 0.07085 a call in the train step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// dscale_kernel: columns a block, and segments of the blocks a column
constexpr int kCols = 32;
constexpr int kSegs = 8;

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

// one 16-byte vector of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// loads of x and dy and stores of dx in the register form: 16-byte vectors
// with streaming hints (each byte is read or written once)
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

// The register form.  T: x, scale, dy and dx.  Vector i of a row is
// threadIdx.x + i * kThreads, so a warp's loads are contiguous.  Block b
// takes rows [b * rpb, min(rows, (b + 1) * rpb)).
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, 4 / VPT)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, long long rows, int D, long long rpb,
                        long long x_stride, long long dy_stride, float eps) {
  __shared__ float red[2][2 * kWarps];
  constexpr int NV = Vec<T>::N;
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const int n = static_cast<int>(min(rpb, rows - r0));
  const float inv_d = 1.f / static_cast<float>(D);

  Vec<T> sc[VPT], cx[VPT], cd[VPT], nx[VPT], nd[VPT];
  float ds[VPT][NV];
  const Vec<T>* sv = reinterpret_cast<const Vec<T>*>(scale);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    sc[i] = sv[tid + i * kThreads];
#pragma unroll
    for (int e = 0; e < NV; ++e) ds[i][e] = 0.f;
  }
  {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + r0 * x_stride);
    const Vec<T>* dv = reinterpret_cast<const Vec<T>*>(dy + r0 * dy_stride);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      cx[i] = ld_row(xv + tid + i * kThreads);
      cd[i] = ld_row(dv + tid + i * kThreads);
    }
  }
  for (int row = 0; row < n; ++row) {
    if (row + 1 < n) {  // the next row's bytes stay in flight across the barrier
      const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + (r0 + row + 1) * x_stride);
      const Vec<T>* dv = reinterpret_cast<const Vec<T>*>(dy + (r0 + row + 1) * dy_stride);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        nx[i] = ld_row(xv + tid + i * kThreads);
        nd[i] = ld_row(dv + tid + i * kThreads);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float xf = to_f32(cx[i].v[e]);
        const float g = to_f32(cd[i].v[e]) * to_f32(sc[i].v[e]);
        ss = fmaf(xf, xf, ss);
        gx = fmaf(g, xf, gx);
      }
    block_sum2(ss, gx, red[row & 1]);
    const float r = 1.f / sqrtf(ss * inv_d + eps);
    const float c = r * r * r * (gx * inv_d);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(dx + (r0 + row) * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float xf = to_f32(cx[i].v[e]);
        const float dyf = to_f32(cd[i].v[e]);
        o.v[e] = from_f32<T>(r * (dyf * to_f32(sc[i].v[e])) - xf * c);
        ds[i][e] = fmaf(dyf * xf, r, ds[i][e]);
      }
      st_row(ov + tid + i * kThreads, o);
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      cx[i] = nx[i];
      cd[i] = nd[i];
    }
  }
  float* prow = partial + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int e = 0; e < NV; e += 4)
      *reinterpret_cast<float4*>(prow + (tid + i * kThreads) * NV + e) =
          make_float4(ds[i][e], ds[i][e + 1], ds[i][e + 2], ds[i][e + 3]);
}

// The general form.  T: x, dy and dx; S: scale.  Block b takes rows
// [b * rpb, min(rows, (b + 1) * rpb)).
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

// dscale[j] = the sum over blocks b of partial[b][j]: thread (jx, sy) of a
// block sums segment sy of the blocks, in order, for column blockIdx.x *
// kCols + jx; then the segments are summed in order.
template <typename S>
__global__ void __launch_bounds__(kCols * kSegs)
dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int nblocks, int D) {
  __shared__ float seg[kSegs][kCols + 1];
  const int jx = threadIdx.x % kCols, sy = threadIdx.x / kCols;
  const int j = blockIdx.x * kCols + jx;
  const int per = (nblocks + kSegs - 1) / kSegs;
  const int b0 = sy * per, b1 = min(b0 + per, nblocks);
  float s = 0.f;
  if (j < D)
    for (int b = b0; b < b1; ++b) s += partial[static_cast<long long>(b) * D + j];
  seg[sy][jx] = s;
  __syncthreads();
  if (sy == 0 && j < D) {
    float t = seg[0][jx];
#pragma unroll
    for (int k = 1; k < kSegs; ++k) t += seg[k][jx];
    dscale[j] = from_f32<S>(t);
  }
}

bool aligned16(const void* p, long long stride, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride * elem) % 16 == 0;
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, const void* dy, void* dx, float* partial,
                   void* dscale, long long rows, int D, long long rpb, int nblocks,
                   long long x_stride, long long dy_stride, float eps, bool regs,
                   cudaStream_t stream) {
  cudaError_t e;
  if (regs) {
    // 16-byte vectors a thread when a row is exactly that many per thread
    const long long row_bytes = static_cast<long long>(D) * sizeof(T);
    const int vpt = row_bytes % (16 * kThreads) == 0
                        ? static_cast<int>(row_bytes / (16 * kThreads)) : 0;
    if (sizeof(S) != sizeof(T) || (vpt != 1 && vpt != 2 && vpt != 4) ||
        !aligned16(x, x_stride, sizeof(T)) || !aligned16(dy, dy_stride, sizeof(T)) ||
        !aligned16(dx, D, sizeof(T)) || reinterpret_cast<uintptr_t>(scale) % 16 != 0)
      return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* st = static_cast<const T*>(scale);
    const T* dt = static_cast<const T*>(dy);
    T* ot = static_cast<T*>(dx);
    if (vpt == 1)
      rmsnorm_bwd_rows_kernel<T, 1><<<nblocks, kThreads, 0, stream>>>(
          xt, st, dt, ot, partial, rows, D, rpb, x_stride, dy_stride, eps);
    else if (vpt == 2)
      rmsnorm_bwd_rows_kernel<T, 2><<<nblocks, kThreads, 0, stream>>>(
          xt, st, dt, ot, partial, rows, D, rpb, x_stride, dy_stride, eps);
    else
      rmsnorm_bwd_rows_kernel<T, 4><<<nblocks, kThreads, 0, stream>>>(
          xt, st, dt, ot, partial, rows, D, rpb, x_stride, dy_stride, eps);
  } else {
    const size_t smem = sizeof(float) * static_cast<size_t>(D);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    rmsnorm_bwd_kernel<T, S><<<nblocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
        static_cast<T*>(dx), partial, rows, D, rpb, x_stride, dy_stride, eps);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dscale_kernel<S><<<(D + kCols - 1) / kCols, kCols * kSegs, 0, stream>>>(
      partial, static_cast<S*>(dscale), nblocks, D);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  x and dy: rows of D elements with row
// strides x_stride and dy_stride (elements), last dim contiguous; scale: D
// elements of s_dtype (float32 or x's dtype); dx: contiguous (rows, D) of
// x's dtype; partial: (nblocks, D) float32 scratch, nblocks * rpb >= rows;
// dscale: D elements of s_dtype.  regs: 1 for the register form (refused
// unless the row, the dtypes and the alignment suit it), 0 for the general
// form.  Returns the launches' cudaError_t (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           float* partial, void* dscale, int x_dtype, int s_dtype,
                           long long rows, int D, long long rpb, int nblocks,
                           long long x_stride, long long dy_stride, float eps, int regs,
                           void* stream) {
  if (rows <= 0 || D <= 0 || rpb <= 0 || nblocks <= 0 ||
      static_cast<long long>(nblocks) * rpb < rows ||
      static_cast<long long>(nblocks - 1) * rpb >= rows)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rg = regs != 0;
  if (x_dtype == 0 && s_dtype == 0)
    return int(launch<float, float>(x, scale, dy, dx, partial, dscale, rows, D, rpb, nblocks,
                                    x_stride, dy_stride, eps, rg, st));
  if (x_dtype == 1 && s_dtype == 1)
    return int(launch<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows,
                                                    D, rpb, nblocks, x_stride, dy_stride, eps,
                                                    rg, st));
  if (x_dtype == 1 && s_dtype == 0)
    return int(launch<__nv_bfloat16, float>(x, scale, dy, dx, partial, dscale, rows, D, rpb,
                                            nblocks, x_stride, dy_stride, eps, rg, st));
  return int(cudaErrorInvalidValue);
}
