// Flash-attention backward for Hopper (sm_90a): kernel K1b, the backward of
// K1 on the port's kernel-path train step (one launch per attention layer).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel and
// takes the gradient by autodiff through its plain attention
// (src/repro/train/train_step.py:32 through kernels/ref.py).  This kernel
// computes that gradient for the masks K1 takes (causal, a sliding window's
// lower edge, ragged S) and GQA (kv head = q head / G):
//   P = softmax(scale q k^T) (masked),  dV = P^T dO,  dP = dO V^T,
//   dS = P (dP - delta),  dQ = scale dS K,  dK = scale dS^T Q,
// with delta_i = sum_j P_ij dP_ij (= dO_i . o_i for the f32 output o) and
// every sum in f32; the outputs are stored in the inputs' dtype.
//
// delta is not taken from the forward's stored output: in bf16 that o is
// rounded, and at the model's random init the softmax is near-argmax, so
// dP - delta cancels to a small difference whose rounding error (2^-9 of
// dO . o) was O(1) of dQ and dK (measured on an H100 against autograd of
// the plain version, llama3.2-1b's train step).  So the kernel reads
// neither o nor anything the forward saved beside q, k and v.
//
// Design (a simple first form: f32 on the CUDA cores; mma/wgmma, TMA and a
// pipelined ring are later work).  K1's forward writes no log-sum-exp, so
// three passes, each a kernel:
//   0. a block per (64-row q tile, q head, batch) walks the key tiles its
//      mask reaches with the forward's online softmax, keeping each row's
//      running max m, sum l and, rescaled alike, the sum of
//      exp(scale s - m) dP (dP = dO V^T tile by tile): lse_i = m_i + log
//      l_i and delta_i = that sum / l_i.  Both (B, Hq, S) f32 scratch.
//   1. a block per (64-key tile, kv head, batch) keeps its K and V tiles and
//      its dK, dV accumulators on chip and walks its G query heads and the
//      query tiles its mask reaches: S = Q K^T and dP = dO V^T (64 x 64),
//      P = exp(scale S - lse), dS = P (dP - delta) into shared memory, then
//      dV += P^T dO, dK += dS^T Q.  GQA's sum over a kv head's G q heads
//      is this loop, so dK and dV need no atomics.
//   2. a block per (64-row q tile, q head, batch) keeps Q, dO and its dQ
//      accumulator and walks its key tiles: dQ += dS K.
// Every output element is summed by one thread in a fixed order: the
// result is bitwise the same from run to run.  Tiles are staged in shared
// memory as f32 rows of D + 1 floats (conflict-free column walks); thread
// (ty, tx) of 16 x 16 owns rows ty + 16 i and columns tx + 16 j.  Inputs
// are read through (batch, head, seq) strides with the head dim
// contiguous, so transposed model-layout views are read in place, and the
// outputs are written through their own strides.
//
// Bound.  The function's least work is five products over the pairs its
// mask leaves (scale q k^T, dP = dO v^T, dV, dQ, dK): at the llama3.2-1b
// train shape (B=4, Hq=32, Hkv=8, S=1024, D=64, bf16, causal) that is
// 5 * 2 * 64 * 4*32*(1024*1025/2) = 43.0 GFLOP, 0.0435 ms at 989 TFLOP/s of
// bf16 tensor cores, against 50.3 MB of q, k, v, dO read and dq, dk, dv
// written (0.0150 ms at 3.35 TB/s): bound by operations.  This form does
// nine products (passes 0 and 2 each recompute q k^T and dO v^T) on the
// f32 CUDA cores, far from that bound: 4.68 ms at that shape on an H100
// (108x the bound; SDPA's backward 0.225 ms; PERF.md), and 26.2 ms at
// granite-34b's MQA shape (48 q heads on one kv head), where pass 1 has
// only 64 blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // key rows a tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDP = BK + 1;   // row stride of the P and dS tiles
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ bool visible(int row, int col, int S, int causal, int window) {
  bool ok = row < S && col < S;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// rows r0 .. r0 + 63 of one (batch, head) as f32 rows of D + 1 floats; rows
// at or past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long ss, int r0, int S) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? to_f32(base[row * ss + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two staged tiles
template <int D>
__device__ __forceinline__ void nt_product(float s[4][4], const float* A, const float* B, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int B, Hq, Hkv, S, causal, window;
  float scale;
  cudaStream_t stream;
};

// pass 0: lse and delta of one q tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
lse_delta_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                 Strides qs, Strides ks, Strides vs, Strides dos, int Hq, int S, int G,
                 int causal, int window, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<T, D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);

  // per row: running max m, sum l of exp(scale s - m), and u, the sum of
  // exp(scale s - m) dP, rescaled with l
  float m[4], l[4], u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    u[i] = 0.f;
  }
  const int hi = causal ? min(S, q0 + BQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = lo / BK; kt < (hi + BK - 1) / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks and Vs are no longer read
    load_tile<T, D>(Ks, kb, ks.s, k0, S);
    load_tile<T, D>(Vs, vb, vs.s, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<D>(s, Qs, Ks, ty, tx);
    nt_product<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (visible(row, k0 + tx + 16 * j, S, causal, window)) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f, su = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(row, k0 + tx + 16 * j, S, causal, window)) {
          const float e = expf(s[i][j] - m_new);
          sum += e;
          su = fmaf(e, dp[i][j], su);
        }
      l[i] = l[i] * alpha + sum;
      u[i] = u[i] * alpha + su;
      m[i] = m_new;
    }
  }
  const long long base = (static_cast<long long>(b) * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i], su = u[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      su += __shfl_xor_sync(0xffffffffu, su, off);
    }
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < S) {
      lse[base + row] = m[i] + logf(sum);
      delta[base + row] = su / sum;
    }
  }
}

// P and dS of a (q tile, key tile) pair into Ps / dSs; s and dp hold
// Q K^T and dO V^T
__device__ __forceinline__ void p_ds(float s[4][4], float dp[4][4], float* Ps, float* dSs,
                                     const float* lse_s, const float* dl_s, int q0, int k0, int ty,
                                     int tx, int S, int causal, int window, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          visible(q0 + r, k0 + c, S, causal, window) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (Ps) Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

// pass 1: dK and dV of one key tile, over the kv head's G q heads
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides qs,
            Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int Hq, int S, int G,
            int causal, int window, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* dl_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  load_tile<T, D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  load_tile<T, D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, S);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the query rows this key tile is visible to
  const int k_last = min(S, k0 + BK) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long base = (static_cast<long long>(b) * Hq + h) * S;
    for (int qt = q_lo / BQ; qt < (q_hi + BQ - 1) / BQ; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Qs, dOs, Ps and dSs are no longer read
      load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
      load_tile<T, D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse[base + row] : 0.f;
        dl_s[tid] = row < S ? delta[base + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      nt_product<D>(s, Qs, Ks, ty, tx);
      nt_product<D>(dp, dOs, Vs, ty, tx);
      p_ds(s, dp, Ps, dSs, lse_s, dl_s, q0, k0, ty, tx, S, causal, window, scale);
      __syncthreads();
      // dV[key][d] += sum_r P[r][key] dO[r][d];  dK[key][d] += sum_r dS[r][key] Q[r][d]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * LDP + ty + 16 * i];
          dsv[i] = dSs[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = dOs[r * LD + tx + 16 * j];
          qv[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pv[i], dov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }
  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[row * dks.s + tx + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
      dvb[row * dvs.s + tx + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// pass 2: dQ of one q tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
          Strides dos, Strides dqs, int Hq, int S, int G, int causal, int window, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDP;
  float* dl_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const long long base = (static_cast<long long>(b) * Hq + h) * S;
  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<T, D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  if (tid < BQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < S ? lse[base + row] : 0.f;
    dl_s[tid] = row < S ? delta[base + row] : 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int hi = causal ? min(S, q0 + BQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = lo / BK; kt < (hi + BK - 1) / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs and dSs are no longer read
    load_tile<T, D>(Ks, kb, ks.s, k0, S);
    load_tile<T, D>(Vs, vb, vs.s, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<D>(s, Qs, Ks, ty, tx);
    nt_product<D>(dp, dOs, Vs, ty, tx);
    p_ds(s, dp, nullptr, dSs, lse_s, dl_s, q0, k0, ty, tx, S, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqb[row * dqs.s + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_typed(const Args& a) {
  constexpr size_t LD = D + 1;
  const size_t smem0 = sizeof(float) * (2 * BQ + 2 * BK) * LD;
  const size_t smem1 = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LDP + 2 * BQ);
  const size_t smem2 = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LDP + 2 * BQ);
  cudaError_t e;
  if ((e = set_smem(lse_delta_kernel<T, D>, smem0)) != cudaSuccess) return e;
  if ((e = set_smem(dkdv_kernel<T, D>, smem1)) != cudaSuccess) return e;
  if ((e = set_smem(dq_kernel<T, D>, smem2)) != cudaSuccess) return e;
  const int G = a.Hq / a.Hkv;
  const unsigned tiles = static_cast<unsigned>((a.S + BQ - 1) / BQ);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  lse_delta_kernel<T, D><<<dim3(tiles, a.Hq, a.B), THREADS, smem0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.qs, a.ks, a.vs, a.dos, a.Hq, a.S, G, a.causal, a.window,
      a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv_kernel<T, D><<<dim3(tiles, a.Hkv, a.B), THREADS, smem1, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.Hq, a.S, G, a.causal, a.window, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_kernel<T, D><<<dim3(tiles, a.Hq, a.B), THREADS, smem2, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.Hq,
      a.S, G, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_typed<float, D>(a);
  if (dtype == 1) return launch_typed<__nv_bfloat16, D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the same for q, k, v, dout, dq, dk and
// dv.  q, dout, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); each given
// by its (batch, head, seq) strides in elements, the head dim contiguous.
// lse and delta: (B, Hq, S) float32 scratch.  Returns the launches'
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, int dtype, int B, int Hq, int Hkv, int S, int D,
                                   long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long do_sb, long long do_sh, long long do_ss,
                                   long long dq_sb, long long dq_sh, long long dq_ss,
                                   long long dk_sb, long long dk_sh, long long dk_ss,
                                   long long dv_sb, long long dv_sh, long long dv_ss,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, lse, delta,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, B, Hq, Hkv, S, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return int(launch<32>(dtype, a));
    case 64: return int(launch<64>(dtype, a));
    case 128: return int(launch<128>(dtype, a));
    default: return int(cudaErrorInvalidValue);
  }
}
