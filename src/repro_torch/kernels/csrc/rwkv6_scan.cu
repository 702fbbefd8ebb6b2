// WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper (sm_90a), one launch
// per rwkv layer of `forward`.
//
// Replaces the TPU kernel `rwkv6_scan` / `_kernel` in
// src/repro/kernels/rwkv6_scan.py (pallas_call at :81).  Per (batch, head),
// from a given f32 state S_0 (D x D, key dim x value dim):
//   o_t = r_t (diag(u) k_t^T v_t + S_{t-1}),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// returning o (in r's dtype) and S_T (f32).  All math is f32.
//
// Design.  The TPU kernel cuts the sequence into chunks of 32 and carries the
// state across a sequential grid axis in VMEM scratch, with the intra-chunk
// part as (C,C) matrix products.  CUDA blocks run in no order, so here one
// block owns one (batch, head) and walks the sequence in a loop: thread j
// keeps column j of the state (D floats) in registers for the whole scan.
// Every CH steps the block stages r, k, w, v and the bonus terms r*u*k of
// those steps in shared memory (coalesced rows, one barrier pair per CH
// steps); then each thread runs the CH steps alone, reading the staged rows
// as broadcasts.  The sequence is not padded: a ragged S shortens the last
// chunk, which matches the TPU wrapper's padding with w = 1 exactly.
// Inputs are read through (batch, head, seq) strides with the last dim
// contiguous, so the model's (B,S,H,D) tensors are read in place.  bf16 is
// converted only through the intrinsics.
//
// Bound.  At the rwkv6-7b prefill shape (B=4, H=64, S=1024, D=64, r/k/v bf16,
// w f32) the function moves 3*33.6 MB of r, k, v, 67.1 MB of w, 33.6 MB of o
// and 2*4.2 MB of S_0 and S_T, 209.7 MB in all: 0.063 ms at 3.35 TB/s.  It does
// 5 D^2 + 5 D flops per (b, h, t) (k^T v, the decayed update, r S, and the
// bonus), 5.4 GFLOP: 0.080 ms at 67 TFLOP/s of f32 CUDA cores.  So the bound
// is 0.080 ms, by operations.  This simple form runs 256 blocks of 64 threads
// (two warps a block, about two blocks an SM), and each step is a chain of
// D/4 dependent FMAs per accumulator: it is latency-bound, several times the
// bound.  A chunked tensor-core form is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace {

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

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

// floats of one staged array: CH = STAGE / D steps at once, five arrays,
// 40 KB of static shared memory
constexpr int STAGE = 2048;

// T: r, k, v and o; TW: w; TU: u.
template <int D, typename T, typename TW, typename TU>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const TW* __restrict__ w, const TU* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
            Strides rs, Strides ks, Strides vs, Strides ws, Strides os, long long u_sh, int H,
            int S) {
  constexpr int CH = STAGE / D;
  __shared__ __align__(16) float r_s[CH * D];
  __shared__ __align__(16) float k_s[CH * D];
  __shared__ __align__(16) float w_s[CH * D];
  __shared__ __align__(16) float b_s[CH * D];  // r * u * k, summed into the bonus
  __shared__ __align__(16) float v_s[CH * D];

  const int j = threadIdx.x;  // this thread's value column
  const int h = blockIdx.x, b = blockIdx.y;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const TW* wb = w + b * ws.b + h * ws.h;
  T* ob = o + b * os.b + h * os.h;
  const long long sbase = (static_cast<long long>(b) * H + h) * D * D;
  const float uj = to_f32(u[h * u_sh + j]);

  float st[D];  // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0[sbase + i * D + j];

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int c = 0; c < n; ++c) {  // thread j stages element j of each step
      const long long t = t0 + c;
      const float rv = to_f32(rb[t * rs.s + j]);
      const float kv = to_f32(kb[t * ks.s + j]);
      r_s[c * D + j] = rv;
      k_s[c * D + j] = kv;
      b_s[c * D + j] = rv * uj * kv;
      w_s[c * D + j] = to_f32(wb[t * ws.s + j]);
      v_s[c * D + j] = to_f32(vb[t * vs.s + j]);
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c * D + j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float bon[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[c * D + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[c * D + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[c * D + i]);
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[c * D + i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = fmaf(rr[e], st[i + e], acc[e]);  // o_t reads S_{t-1}
          bon[e] += bb[e];
          st[i + e] = fmaf(ww[e], st[i + e], kk[e] * vj);  // S_t
        }
      }
      const float bonus = (bon[0] + bon[1]) + (bon[2] + bon[3]);
      const float out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      ob[(t0 + c) * os.s + j] = from_f32<T>(fmaf(vj, bonus, out));
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sT[sbase + i * D + j] = st[i];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *r, *k, *v, *w, *u, *s0;
  void *o, *sT;
  int w_dtype, u_dtype;
  int B, H, S;
  Strides rs, ks, vs, ws, os;
  long long u_sh;
  cudaStream_t stream;
};

template <int D, typename T, typename TW, typename TU>
cudaError_t launch_typed(const Args& a) {
  dim3 grid(a.H, a.B);
  wkv6_kernel<D, T, TW, TU><<<grid, D, 0, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const TW*>(a.w), static_cast<const TU*>(a.u),
      static_cast<const float*>(a.s0), static_cast<T*>(a.o), static_cast<float*>(a.sT), a.rs,
      a.ks, a.vs, a.ws, a.os, a.u_sh, a.H, a.S);
  return cudaGetLastError();
}

template <int D, typename T, typename TW>
cudaError_t launch_u(const Args& a) {
  if (a.u_dtype == 0) return launch_typed<D, T, TW, float>(a);
  if (a.u_dtype == 1) return launch_typed<D, T, TW, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

// w is float32, or the dtype of r (bf16 w with f32 r is not taken)
template <int D, typename T>
cudaError_t launch_w(const Args& a) {
  if (a.w_dtype == 0) return launch_u<D, T, float>(a);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.w_dtype == 1) return launch_u<D, T, __nv_bfloat16>(a);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(int x_dtype, const Args& a) {
  if (x_dtype == 0) return launch_w<D, float>(a);
  if (x_dtype == 1) return launch_w<D, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  x_dtype is that of r, k, v and o;
// s0 and sT are float32, contiguous (B, H, D, D).  Strides in elements, the
// last dim contiguous; u is (H, D) with row stride u_sh.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* o, void* sT, int x_dtype,
                              int w_dtype, int u_dtype, int B, int H, int S, int D,
                              long long r_sb, long long r_sh, long long r_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long w_sb, long long w_sh, long long w_ss,
                              long long o_sb, long long o_sh, long long o_ss, long long u_sh,
                              void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return int(cudaErrorInvalidValue);
  const Args a{r, k, v, w, u, s0, o, sT, w_dtype, u_dtype, B, H, S,
               {r_sb, r_sh, r_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {w_sb, w_sh, w_ss}, {o_sb, o_sh, o_ss}, u_sh,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return int(launch<16>(x_dtype, a));
    case 32: return int(launch<32>(x_dtype, a));
    case 64: return int(launch<64>(x_dtype, a));
    case 128: return int(launch<128>(x_dtype, a));
    default: return int(cudaErrorInvalidValue);
  }
}
