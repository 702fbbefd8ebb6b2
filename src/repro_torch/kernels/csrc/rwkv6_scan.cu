// WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper (sm_90a), one launch
// per rwkv layer of `forward`.
//
// Replaces the TPU kernel `rwkv6_scan` / `_kernel` in
// src/repro/kernels/rwkv6_scan.py (pallas_call at :81).  Per (batch, head),
// from a given f32 state S_0 (D x D, key dim x value dim):
//   o_t = r_t (diag(u) k_t^T v_t + S_{t-1}),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// returning o (in r's dtype) and S_T (f32).  All math is f32.
//
// Design.  The TPU kernel cuts the sequence into chunks of 32 and carries
// the state across a sequential grid axis in VMEM scratch, with the
// intra-chunk part as (C,C) matrix products.  CUDA blocks run in no order,
// so here a block walks the sequence in a loop with the state in registers
// (the recurrent form).  Value columns are independent (S[:, j] depends only
// on v[:, j]), so a block owns JT = 64 value columns of one (batch, head)
// (a head of 128 is two blocks side by side, whose re-reads of r, k and w
// hit L2).  The keys are cut into groups of NK = 8: a key group is 16
// lanes, lane l keeping S[i][l + 16 n] for the group's 8 keys i and its
// NC = JT / 16 columns, so a step is 8 x 4 independent state updates a
// thread, r, k and w come from shared memory as 16-byte broadcasts (the
// same for 16 lanes), and each group's share of o_t goes to shared memory,
// summed over the groups once a chunk.  At D = 64 a block is 128 threads
// (8 key groups), 256 blocks in all.  The block stages CH = 16 steps of
// r, k, w, v in shared memory as f32, converted once and double-buffered:
// the next chunk's 16-byte loads are issued into registers before the
// current chunk runs and stored after it.  The bonus sum_i r_i u_i k_i of
// each staged step is reduced by one warp, once for the block; outputs
// leave as 16-byte rows.  The sequence is not padded: a ragged S shortens
// the last chunk, which matches the TPU wrapper's padding with w = 1
// exactly.  Inputs are read through (batch, head, seq) strides with the
// last dim contiguous, so the model's (B,S,H,D) tensors are read in place;
// unaligned views take element loads.  bf16 is converted only through the
// intrinsics.
//
// Measured against each other at the rwkv6-7b prefill shape with
// chip_compare.py on one NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, PR 18):
// this form 0.289 ms; the previous one (a block of 64 threads a (batch,
// head), a thread a column) 0.480; a chunked form in the TPU kernel's own shape (C = 16, decays as
// running products of w, scores on CUDA cores, A S, scores v and the state
// update on mma.sync m16n8k8 in 3xTF32) 0.320, so it was dropped.  Longer
// chunks (32 steps: 0.379) and 4 keys a thread (0.320) were slower.
//
// Bound.  At the rwkv6-7b prefill shape (B=4, H=64, S=1024, D=64, r/k/v bf16,
// w f32) the function moves 3*33.6 MB of r, k, v, 67.1 MB of w, 33.6 MB of o
// and 2*4.2 MB of S_0 and S_T, 209.7 MB in all: 0.063 ms at 3.35 TB/s.  It does
// 5 D^2 + 5 D flops per (b, h, t) (k^T v, the decayed update, r S, and the
// bonus), 5.4 GFLOP: 0.080 ms at 67 TFLOP/s of f32 CUDA cores.  So the bound
// is 0.080 ms, by operations.  A step is 3 f32 instructions an element
// (FMUL, FFMA, FFMA), 0.10 ms of issue at the card's f32 rate; the kernel
// runs at about 3x that.  Why is not measured (no profile of the step
// loop); a guess is that 8 warps an SM (two blocks) are too few to keep
// the f32 pipes busy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
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

// A block owns JT value columns of one (batch, head); key group kg (NK keys)
// is 16 lanes, each lane NC = JT / 16 columns: lane l of the group keeps
// S[NK kg + i][j0 + l + 16 n], i < NK, n < NC.  Two key groups a warp.
constexpr int NK = 8;

template <int D>
struct Plan {
  static constexpr int JT = D < 64 ? D : 64;  // value columns a block
  static constexpr int NC = JT / 16;          // value columns a lane
  static constexpr int G = D / NK;            // key groups
  static constexpr int NT = 16 * G;           // threads a block
  static constexpr int CH = 16;               // steps a chunk
  // floats of one staging buffer: r, k, w [CH][D], v [CH][JT], bonus [CH]
  static constexpr int BUF = 3 * CH * D + CH * JT + CH;
  // the partial outputs of a key group, [CH][JT] and 16 floats of padding,
  // so that the two groups of a warp store to different banks
  static constexpr int PST = CH * JT + 16;
  // dynamic shared memory: two buffers, the partial outputs [G][PST], u [D]
  static constexpr int SMEM = (2 * BUF + G * PST + D) * 4;
  static_assert(D % NK == 0 && NC >= 1 && G % 2 == 0, "plan");
};

// N elements of T loaded as one 16-byte vector (VEC) or one element
template <typename T, bool VEC>
struct Pack {
  static constexpr int N = VEC ? 16 / sizeof(T) : 1;
  T v[N];
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_pack(Pack<T, VEC>& d, const T* p) {
  if constexpr (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(d.v, &u, 16);
  } else {
    d.v[0] = *p;
  }
}

// CH steps of COLS columns of one input, prefetched into registers by the
// whole block and then stored as f32 rows of shared memory
template <typename T, bool VEC, int COLS, int CH, int NT>
struct Stage {
  static constexpr int N = Pack<T, VEC>::N;
  static constexpr int ROW = COLS / N;          // packs a step
  static constexpr int TOTAL = CH * ROW;        // packs a chunk
  static constexpr int NL = (TOTAL + NT - 1) / NT;
  Pack<T, VEC> q[NL];

  // steps t0 .. t0 + n - 1 of a (batch, head) whose step 0 is at base
  __device__ __forceinline__ void load(const T* base, long long ss, int t0, int n) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int idx = threadIdx.x + l * NT, c = idx / ROW;
      if (idx < TOTAL && c < n) load_pack(q[l], base + (t0 + c) * ss + (idx % ROW) * N);
    }
  }
  // dst: [CH][COLS]; the rows past the steps loaded are not read
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int idx = threadIdx.x + l * NT;
      if (idx < TOTAL) {
#pragma unroll
        for (int e = 0; e < N; ++e) dst[idx * N + e] = to_f32(q[l].v[e]);
      }
    }
  }
};

// T: r, k, v and o; TW: w; TU: u.  VEC: 16-byte loads and stores.
template <int D, typename T, typename TW, typename TU, bool VEC>
__global__ void __launch_bounds__(Plan<D>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const TW* __restrict__ w, const TU* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
            Strides rs, Strides ks, Strides vs, Strides ws, Strides os, long long u_sh, int H,
            int S) {
  using PL = Plan<D>;
  constexpr int JT = PL::JT, NC = PL::NC, G = PL::G, NT = PL::NT, CH = PL::CH, PST = PL::PST;
  extern __shared__ __align__(16) float smem[];
  float* const part = smem + 2 * PL::BUF;  // [G][PST]: r S over each key group
  float* const u_s = part + G * PST;       // [D]

  const int tid = threadIdx.x;
  const int kg = tid / 16, cl = tid % 16;  // this thread's key group and columns
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + j0;
  const TW* wb = w + b * ws.b + h * ws.h;
  T* ob = o + b * os.b + h * os.h + j0;
  const long long sbase = (static_cast<long long>(b) * H + h) * D * D + j0 + cl;

  for (int i = tid; i < D; i += NT) u_s[i] = to_f32(u[h * u_sh + i]);
  float st[NC][NK];  // st[n][i] = S[NK kg + i][j0 + cl + 16 n]
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < NK; ++i) st[n][i] = s0[sbase + (NK * kg + i) * D + 16 * n];

  Stage<T, VEC, D, CH, NT> rq, kq;
  Stage<TW, VEC, D, CH, NT> wq;
  Stage<T, VEC, JT, CH, NT> vq;
  auto load = [&](int t0) {
    const int n = min(CH, S - t0);
    rq.load(rb, rs.s, t0, n);
    kq.load(kb, ks.s, t0, n);
    wq.load(wb, ws.s, t0, n);
    vq.load(vb, vs.s, t0, n);
  };
  auto store = [&](float* buf) {
    rq.store(buf);
    kq.store(buf + CH * D);
    wq.store(buf + 2 * CH * D);
    vq.store(buf + 3 * CH * D);
  };
  // bonus[c] = sum_i r_i u_i k_i of each staged step, one warp a step
  auto bonus = [&](float* buf, int n) {
    const int warp = tid / 32, lane = tid % 32;
    for (int c = warp; c < n; c += NT / 32) {
      float s = 0.f;
      for (int i = lane; i < D; i += 32)
        s = fmaf(buf[c * D + i] * u_s[i], buf[CH * D + c * D + i], s);
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) buf[3 * CH * D + CH * JT + c] = s;
    }
  };

  load(0);
  store(smem);
  __syncthreads();
  bonus(smem, min(CH, S));
  __syncthreads();
  for (int t0 = 0, chunk = 0; t0 < S; t0 += CH, ++chunk) {
    float* const buf = smem + (chunk & 1) * PL::BUF;
    float* const nbuf = smem + ((chunk + 1) & 1) * PL::BUF;
    const int n = min(CH, S - t0);
    const bool more = t0 + CH < S;
    if (more) load(t0 + CH);  // in flight while this chunk runs

    const float* r_s = buf;
    const float* k_s = buf + CH * D;
    const float* w_s = buf + 2 * CH * D;
    const float* v_s = buf + 3 * CH * D;
    const float* b_s = v_s + CH * JT;
    for (int c = 0; c < n; ++c) {
      float vj[NC];
#pragma unroll
      for (int m = 0; m < NC; ++m) vj[m] = v_s[c * JT + cl + 16 * m];
      float acc[NC][4] = {};
#pragma unroll
      for (int q = 0; q < NK / 4; ++q) {
        // 16 bytes for each half-warp: broadcasts
        const int i = NK * kg + 4 * q;
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[c * D + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[c * D + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[c * D + i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int m = 0; m < NC; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][e] = fmaf(rr[e], st[m][4 * q + e], acc[m][e]);  // o_t reads S_{t-1}
            st[m][4 * q + e] = fmaf(ww[e], st[m][4 * q + e], kk[e] * vj[m]);  // S_t
          }
      }
#pragma unroll
      for (int m = 0; m < NC; ++m)
        part[kg * PST + c * JT + cl + 16 * m] = (acc[m][0] + acc[m][1]) + (acc[m][2] + acc[m][3]);
    }
    if (more) store(nbuf);
    __syncthreads();  // the partial outputs are complete; the next chunk is staged
    {
      // o = sum over the key groups of r S, plus v * bonus, as 16-byte rows
      constexpr int N = Pack<T, VEC>::N, ROW = JT / N;
      for (int idx = tid; idx < n * ROW; idx += NT) {
        const int c = idx / ROW, col = (idx % ROW) * N;
        Pack<T, VEC> pk;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          float out = 0.f;
#pragma unroll
          for (int gg = 0; gg < G; ++gg) out += part[gg * PST + c * JT + col + e];
          pk.v[e] = from_f32<T>(fmaf(v_s[c * JT + col + e], b_s[c], out));
        }
        T* dst = ob + (t0 + c) * os.s + col;
        if constexpr (VEC) {
          uint4 u4;
          memcpy(&u4, pk.v, 16);
          *reinterpret_cast<uint4*>(dst) = u4;
        } else {
          *dst = pk.v[0];
        }
      }
    }
    if (more) bonus(nbuf, min(CH, S - t0 - CH));
    __syncthreads();  // the partials are free; the next chunk's bonus is ready
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < NK; ++i) sT[sbase + (NK * kg + i) * D + 16 * n] = st[n][i];
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

bool aligned16(const void* p, const Strides& s, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * elem) % 16 == 0 &&
         (s.h * elem) % 16 == 0 && (s.s * elem) % 16 == 0;
}

template <int D, typename T, typename TW, typename TU, bool VEC>
cudaError_t launch_kernel(const Args& a) {
  using PL = Plan<D>;
  auto kern = wkv6_kernel<D, T, TW, TU, VEC>;
  const dim3 grid(D / PL::JT, a.H, a.B);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PL::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<grid, PL::NT, PL::SMEM, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const TW*>(a.w), static_cast<const TU*>(a.u),
      static_cast<const float*>(a.s0), static_cast<T*>(a.o), static_cast<float*>(a.sT), a.rs,
      a.ks, a.vs, a.ws, a.os, a.u_sh, a.H, a.S);
  return cudaGetLastError();
}

template <int D, typename T, typename TW, typename TU>
cudaError_t launch_typed(const Args& a) {
  const bool vec = aligned16(a.r, a.rs, sizeof(T)) && aligned16(a.k, a.ks, sizeof(T)) &&
                   aligned16(a.v, a.vs, sizeof(T)) && aligned16(a.w, a.ws, sizeof(TW)) &&
                   aligned16(a.o, a.os, sizeof(T));
  return vec ? launch_kernel<D, T, TW, TU, true>(a) : launch_kernel<D, T, TW, TU, false>(a);
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
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
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
