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
// every sum in f32; the outputs are stored in the inputs' dtype through
// the caller's strides.
//
// delta is not taken from the forward's stored output: in bf16 that o is
// rounded, and at the model's random init the softmax is near-argmax, so
// dP - delta cancels to a small difference whose rounding error (2^-9 of
// dO . o) was O(1) of dQ and dK (measured on an H100 against autograd of
// the plain version, llama3.2-1b's train step).  So the kernel reads
// neither o nor anything the forward saved beside q, k and v.
//
// K1's forward writes no row statistics, so both forms take three passes,
// each a kernel, with no atomics: every output element is summed by one
// thread (f32) or one warpgroup (bf16) in a fixed order, and the result is
// bitwise the same from run to run.  FlashAttention-3's backward adds dQ
// from the key-tile pass with atomics; here pass 2 recomputes S and dP
// instead.  The form is chosen by the dtype:
//   0. per q row: the softmax's statistics and delta = sum_j P dP;
//   1. a block per key tile keeps its K, V tiles and dK, dV accumulators on
//      chip and walks its kv head's G query heads and the query tiles its
//      mask reaches: S, dP, P, dS, then dV += P^T dO, dK += dS^T Q (GQA's
//      sum over the G heads is this loop);
//   2. a block per q tile keeps Q, dO and dQ on chip and walks its key
//      tiles: S, dP, P, dS, then dQ += dS K.
//
// bf16 (the model path): tensor cores, warp-specialised as K1's forward.
// - Every block has one producer warpgroup and two consumer warpgroups of
//   64 rows; `setmaxnreg` gives the consumers 232 registers and the
//   producer 40.  Loads are TMA copies of 64-row boxes through 4-D tensor
//   maps over the caller's strides (transposed model-layout views read in
//   place; the zero fill covers the edge past S), swizzled 128 bytes (64 at
//   D = 32), into a ring of 2 stages with a "full" and an "empty" mbarrier
//   each.  Passes 0 and 2 load their 128-row Q and dO tile once and stream
//   K and V tiles of 64 keys; pass 1 loads its 128-key K and V tile once
//   and streams the 64-row (Q, dO) tiles of its heads, each with its rows'
//   statistics (four 256-byte bulk copies).
// - Products are wgmma with f32 accumulators.  Every pass takes S = Q K^T
//   and dP = dO V^T as one m64n64k16 sequence on the same operands: 64 q
//   rows (A) against 64 keys (B), both K-major in shared memory, D / 16
//   steps in one order.  So pass 1's and pass 2's dP are bitwise pass 0's,
//   and dP - delta cancels as it did where delta was summed.  A first form
//   took pass 1's dP^T = V dO^T (keys as rows, so that P^T and dS^T were A
//   fragments in registers); the tensor cores round that product otherwise,
//   and at llama3.2-1b's near-argmax init, where dP - delta is a few ulps of
//   dP, dk came out 0.07-0.22 of a row block off autograd in 3 of 16
//   layers (train phase, an H100), dq, taken as pass 0 takes it, 0.012.
//   Pass 1 therefore writes P and dS as bf16 into its warpgroup's [q][key]
//   tiles in shared memory, and dV += P^T dO, dK += dS^T Q read them and
//   dO, Q MN-major (both transpose bits).  Pass 2's dQ += dS K takes dS's
//   bf16 A fragments from registers and reads K MN-major (the transpose
//   bit, as K1's O += P V).  dK and dV stay in registers over the whole
//   walk and are stored once, dK and dQ with the scale.  Rounding points:
//   P and dS to bf16 as the products' operands, the outputs at the store;
//   scores, the softmax, the pivot and r (from f32 P and dP), dP - pv - r
//   and every sum are f32.
// - Statistics.  Pass 0 runs K1's online softmax on the fragments (a
//   quad's shuffles; base-2 exponents, exp2 on the MUFU unit) and keeps
//   each row's max m = max(scale log2(e) s), sum l of p = exp2(scale
//   log2(e) s - m), a pivot pv, the dP at the score that set m, and
//   u = sum p (dP - pv), all rescaled (and u re-pivoted) when m grows.  It
//   writes m, 1 / l, pv and r = u / l = delta - pv (rows past S: m = +inf,
//   1 / l = 0, pv = r = 0, so their P and dS are 0).  Passes 1 and 2
//   recompute P = exp2(scale log2(e) s - m) / l and take
//   dS = P ((dP - pv) - r).  At a near-argmax row (llama3.2-1b's init)
//   delta is within a few ulps of the top score's dP, so dP - delta there
//   is mostly rounding; around the pivot the top score's dP - pv is exactly
//   0 (the same product in every pass) and its dS = -P r is exact to f32,
//   where dP - delta left dk up to 0.089 of a row block off autograd in the
//   train phase's gate (an H100).  P uses m and l, not a log-sum-exp
//   m + log2 l, which loses its last bit (~3e-5 at scores of a few
//   hundred), so that P sums to 1 +- 1e-5 and dS = P (dP - delta) turns
//   that into dq errors past the gate at near-argmax rows.
// - Masks as K1's: the loop bounds skip whole tiles (causal, the window's
//   lower edge), and only a tile that crosses the diagonal, the window's
//   edge or S evaluates the mask per element (P = 0 there).
// - Enough blocks under a large G: when pass 1's grid (key tiles x Hkv x
//   B) is below the SM count the binding's planner splits each kv head's
//   G query heads into `splits` contiguous groups, a further grid
//   dimension; each block then writes f32 partial dK, dV into scratch and
//   a small kernel sums them in split order (deterministic).  The binding
//   allocates the scratch; the kernels allocate nothing.
// - Registers: at D = 128 pass 1 holds dK and dV (64 x 128 f32 each a
//   warpgroup) beside S and dP (64 x 64), and pass 2 dQ beside them, with
//   none spilled (ptxas).
//
// f32 (the smoke's float32 gradient gates, the reduced configs' steps):
// the kernel's first form, kept as it was.  Pass 0 writes lse_i = m_i +
// log l_i (natural) and delta_i; tiles are staged in shared memory as f32
// rows of D + 1 floats (conflict-free column walks); thread (ty, tx) of
// 16 x 16 owns rows ty + 16 i and columns tx + 16 j and runs every product
// with scalar FMAs on the CUDA cores, nine products where five are needed
// (passes 0 and 2 each recompute q k^T and dO v^T).
//
// Bound.  The function's least work is five products over the pairs its
// mask leaves (scale q k^T, dP = dO v^T, dV, dQ, dK): at the llama3.2-1b
// train shape (B=4, Hq=32, Hkv=8, S=1024, D=64, bf16, causal) that is
// 5 * 2 * 64 * 4*32*(1024*1025/2) = 43.0 GFLOP, 0.0435 ms at 989 TFLOP/s of
// bf16 tensor cores, against 50.3 MB of q, k, v, dO read and dq, dk, dv
// written (0.0150 ms at 3.35 TB/s): bound by operations.  The bf16 form
// does nine products, so even at the full tensor-core rate it needs 0.078
// ms there; it takes 0.316 ms (7.3x the bound; SDPA's backward 0.225, the
// f32 form 4.60, pass 1's first form above 0.258; chip_compare.py on an
// NVIDIA H100 80GB HBM3 at 700 W).  Every time is in PERF.md.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // key rows a tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDP = BK + 1;   // row stride of the P and dS tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: wgmma on a TMA ring
// ---------------------------------------------------------------------------

constexpr int WG = 128;             // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;  // two consumer warpgroups, then the producer
constexpr int CONSUMER_WARPS = 8;   // arrivals that free a stage
constexpr int STAGES = 2;           // ring depth
constexpr int ROWS = 64;            // rows of a warpgroup, of a TMA box, of pass 1's q tile
constexpr int TB = 128;             // q rows of a pass-0/2 block, keys of a pass-1 block
constexpr int TK = 64;              // keys a stage of passes 0 and 2
constexpr int STAT_BYTES = 4 * ROWS * 4;  // a pass-1 stage's m, 1 / l, pv and r rows
constexpr int PS_BYTES = ROWS * ROWS * 2;  // a warpgroup's P (or dS) tile in pass 1, bf16
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of one head dim.  A row of D bf16 is cut into
// boxes of BOX columns, swizzled over SW bytes (a box row); a tile of R
// rows lies box after box, R * ROWB bytes each.
template <int D>
struct Geo {
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int NBOX = D / BOX;
  static constexpr int ROWB = 2 * BOX;  // bytes of a box row
  static constexpr int SW = ROWB;       // swizzle span: 64 or 128 bytes
  static constexpr int T64 = ROWS * ROWB * NBOX;  // bytes of a 64-row tile
  static constexpr int T128 = TB * ROWB * NBOX;   // ... of a 128-row tile
  // dynamic shared memory (+ 1024 for the alignment of the swizzle atoms)
  static constexpr int SMEM_Q = 1024 + 2 * T128 + STAGES * 2 * T64;
  static constexpr int SMEM_KV =
      1024 + STAGES * (2 * T64 + STAT_BYTES) + 4 * PS_BYTES + 2 * T128;
};

// `rows` rows (a multiple of 64) from row row0 of head h, batch b of a
// (D, S, H, B) map into the tile at dst: NBOX x rows / 64 boxes on `bar`.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows, int row0, int h, int b) {
  using Gm = Geo<D>;
#pragma unroll
  for (int bx = 0; bx < Gm::NBOX; ++bx)
    for (int rb = 0; rb < rows / ROWS; ++rb)
      tma_load(dst + (bx * rows + rb * ROWS) * Gm::ROWB, map, bar, bx * Gm::BOX,
               row0 + rb * ROWS, h, b);
}

// d (64 x 64) = A B^T over D: A the 64 rows at `a` of a tile of a_rows
// rows, B the 64 rows at `b` of a tile of b_rows rows, both K-major (D
// contiguous).  Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void nt_mma(float (&d)[ROWS / 2], uint32_t a, int a_rows, uint32_t b,
                                       int b_rows) {
  using Gm = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int bx = kk * 16 / Gm::BOX;
    const uint32_t col = (kk * 16 % Gm::BOX) * 2;
    wgmma_ss(d, make_desc<Gm::SW>(a + bx * a_rows * Gm::ROWB + col, 16, 8 * Gm::ROWB),
             make_desc<Gm::SW>(b + bx * b_rows * Gm::ROWB + col, 16, 8 * Gm::ROWB), kk > 0);
  }
  wg_commit();
}

// d (64 x D) += A B: A (64 x 64) as bf16 fragments in registers, B the 64
// rows at `b` of a tile of b_rows rows read MN-major (D contiguous): 8 rows
// of a box lie 8 ROWB apart (stride offset), the next box of columns
// b_rows ROWB on (leading offset).  Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void nn_mma(float (&d)[D / 2], const uint32_t (&a)[ROWS / 16][4],
                                       uint32_t b, int b_rows) {
  using Gm = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_rs(d, a[kk],
             make_desc<Gm::SW>(b + kk * 16 * Gm::ROWB, b_rows * Gm::ROWB, 8 * Gm::ROWB));
  wg_commit();
}

// The fragments of a 64 x 64 accumulator rounded to bf16 as the A operand
// of a product over its 64 columns: column blocks 2kk and 2kk + 1 are the
// fragment of depth step kk.
__device__ __forceinline__ void to_a(uint32_t (&a)[ROWS / 16][4], const float (&d)[ROWS / 2]) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// whether query row qr attends to key kr under the causal and window masks
__device__ __forceinline__ bool in_mask(int qr, int kr, int causal, int window) {
  return (!causal || kr <= qr) && (window <= 0 || kr > qr - window);
}

// Pass 0, one key tile on the fragments s = Q K^T and dp = dO V^T of rows
// `row` and `row + 8`: the running max m (base 2), the pivot pv (the dP at
// the score that set m), and the sums l of p = exp2(s sl2 - m) and u of
// p (dP - pv), rescaled and re-pivoted when m grows (sum p (dP - pv') =
// u + l (pv - pv')).  Only an EDGE tile evaluates the mask.
template <bool EDGE>
__device__ __forceinline__ void stats_step(const float (&s)[TK / 2], const float (&dp)[TK / 2],
                                           float (&m)[2], float (&pv)[2], float (&l)[2],
                                           float (&u)[2], int row, int k0, int c, int S,
                                           int causal, int window, float sl2) {
  uint64_t ok = ~0ull;  // bit 4j+e: score s[4j+e] is attended
  float mx[2] = {NEG_INF, NEG_INF}, px[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = k0 + 8 * j + 2 * c + (e & 1);
      if (EDGE && !(kr < S && in_mask(row + 8 * (e >> 1), kr, causal, window))) {
        ok &= ~(1ull << (4 * j + e));
      } else if (s[4 * j + e] > mx[e >> 1]) {
        mx[e >> 1] = s[4 * j + e];
        px[e >> 1] = dp[4 * j + e];
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row: the
    // larger score, on a tie the smaller dP, so all four agree
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float op = __shfl_xor_sync(0xffffffffu, px[r], off);
      if (om > mx[r] || (om == mx[r] && op < px[r])) {
        mx[r] = om;
        px[r] = op;
      }
    }
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    const float pv_new = m_new > m[r] ? px[r] : pv[r];
    const float alpha = exp2_mufu(m[r] - m_new);
    u[r] = alpha * fmaf(l[r], pv[r] - pv_new, u[r]);
    l[r] *= alpha;
    m[r] = m_new;
    pv[r] = pv_new;
  }
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_mufu(fmaf(s[4 * j + e], sl2, -m[e >> 1]));
      if (EDGE) p = (ok >> (4 * j + e)) & 1ull ? p : 0.f;
      l[e >> 1] += p;
      u[e >> 1] = fmaf(p, dp[4 * j + e] - pv[e >> 1], u[e >> 1]);
    }
}

// Pass 2, one key tile: dS = P ((dP - pv) - r) of rows `row` and `row + 8`
// (statistics m, il = 1 / l, pivot pv and r = delta - pv in registers) as
// bf16 A fragments.
template <bool EDGE>
__device__ __forceinline__ void ds_rows(float (&s)[TK / 2], const float (&dp)[TK / 2],
                                        const float (&m)[2], const float (&il)[2],
                                        const float (&pv)[2], const float (&rd)[2],
                                        uint32_t (&a)[TK / 16][4], int row, int k0, int c, int S,
                                        int causal, int window, float sl2) {
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kr = k0 + 8 * j + 2 * c + (e & 1);
      float p = exp2_mufu(fmaf(s[4 * j + e], sl2, -m[r])) * il[r];
      if (EDGE && !(kr < S && in_mask(row + 8 * r, kr, causal, window))) p = 0.f;
      s[4 * j + e] = p * ((dp[4 * j + e] - pv[r]) - rd[r]);
    }
  to_a(a, s);
}

// Pass 1, one (head, q tile): P and dS = P ((dP - pv) - r) of the tile's q
// rows `rq` and `rq + 8` (from q0; statistics m, 1 / l, pv, r of the tile's
// 64 rows at `st`) against this warpgroup's 64 keys from kw0, as
// bf16 into its [q][key] tiles at `pb` and `db` (rows of 128 bytes,
// swizzled 128 bytes), for the products over q that take their transposes.
template <bool EDGE>
__device__ __forceinline__ void p_ds_store(const float (&s)[ROWS / 2], const float (&dp)[ROWS / 2],
                                           const float* st, uint32_t pb, uint32_t db, int q0,
                                           int rq, int kw0, int c, int causal, int window,
                                           float sl2) {
  float m[2], il[2], pv[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = st[rq + 8 * r];
    il[r] = st[ROWS + rq + 8 * r];
    pv[r] = st[2 * ROWS + rq + 8 * r];
    rd[r] = st[3 * ROWS + rq + 8 * r];
  }
#pragma unroll
  for (int j = 0; j < ROWS / 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      p[e] = exp2_mufu(fmaf(s[4 * j + e], sl2, -m[r])) * il[r];
      if (EDGE && !in_mask(q0 + rq + 8 * r, kw0 + 8 * j + 2 * c + (e & 1), causal, window))
        p[e] = 0.f;
      ds[e] = p[e] * ((dp[4 * j + e] - pv[r]) - rd[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = swz<128>((rq + 8 * r) * 128 + (8 * j + 2 * c) * 2);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(pb + off), "r"(pack_bf16(p[2 * r], p[2 * r + 1]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(db + off),
                   "r"(pack_bf16(ds[2 * r], ds[2 * r + 1]))
                   : "memory");
    }
  }
}

// d (64 keys x D) += A^T B over the 64 q rows: A the [q][key] tile at `a`
// (P or dS, rows of 128 bytes) and B the 64-row tile at `b` (dO or Q), both
// read MN-major.  Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void tt_mma(float (&d)[D / 2], uint32_t a, uint32_t b) {
  using Gm = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_tt(d, make_desc<128>(a + kk * 16 * 128, PS_BYTES, 8 * 128),
             make_desc<Gm::SW>(b + kk * 16 * Gm::ROWB, ROWS * Gm::ROWB, 8 * Gm::ROWB));
  wg_commit();
}

__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0, uint32_t once) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMER_WARPS);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A warpgroup's 64 x D accumulator (times `mul`) as bf16 into its 64 rows
// at `rows` of a tile of TB rows, swizzled as the output map's boxes expect,
// then one TMA store of them to row r0 of head h, batch b (clipped at S).
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 2], float mul, uint32_t rows,
                                           const CUtensorMap* map, int r0, int h, int b, int S,
                                           int wg, int tid) {
  using Gm = Geo<D>;
  const int warp = tid / 32, g = (tid % 32) / 4, c = tid % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * c;
    const uint32_t box = rows + (col / Gm::BOX) * TB * Gm::ROWB;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t a = box + swz<Gm::SW>((16 * warp + g + 8 * r) * Gm::ROWB + (col % Gm::BOX) * 2);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                   "r"(pack_bf16(o[4 * j + 2 * r] * mul, o[4 * j + 2 * r + 1] * mul))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
  if (tid == 0 && r0 < S) {
#pragma unroll
    for (int bx = 0; bx < Gm::NBOX; ++bx)
      tma_store(map, rows + bx * TB * Gm::ROWB, bx * Gm::BOX, r0, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Passes 0 (DQ false: the row statistics) and 2 (DQ true: dQ).  A block
// owns 128 q rows of one (q head, batch), heavy-first under a causal mask;
// stat is (2, B, Hq, Sp) (m, then 1 / l) and delta (2, B, Hq, Sp) (pv,
// then r = delta - pv).
template <int D, bool DQ>
__global__ void __launch_bounds__(WS_THREADS, 1)
q_pass(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
       const __grid_constant__ CUtensorMap tdq, float* __restrict__ stat,
       float* __restrict__ delta, int S, int Sp, int Hq, int G, int causal, int window,
       float scale) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + Gm::T128;
  const uint32_t sKV = sdO + Gm::T128;  // stage s: K at sKV + 2 s T64, then V
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES, qbar = full0 + 16 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int qt = causal ? int(gridDim.z) - 1 - int(blockIdx.z) : int(blockIdx.z);
  const int q0 = qt * TB;
  const int hi = causal ? min(S, q0 + TB) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = lo / TK, kt1 = (hi + TK - 1) / TK;
  const int wg = threadIdx.x / WG;
  init_ring(full0, empty0, qbar);

  if (wg == 2) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(qbar, 2 * Gm::T128);
      load_rows<D>(sQ, &tq, qbar, TB, q0, h, b);
      load_rows<D>(sdO, &tdo, qbar, TB, q0, h, b);
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int stage = it % STAGES;
        mbar_wait(empty0 + 8 * stage, ((it / STAGES) & 1) ^ 1);
        const uint32_t fb = full0 + 8 * stage, dst = sKV + stage * 2 * Gm::T64;
        mbar_expect_tx(fb, 2 * Gm::T64);
        load_rows<D>(dst, &tk, fb, TK, kt * TK, hk, b);
        load_rows<D>(dst + Gm::T64, &tv, fb, TK, kt * TK, hk, b);
      }
    }
    return;
  }
  // consumers: warpgroup wg owns q rows r0 .. r0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int r0 = q0 + ROWS * wg;
  const int row = r0 + 16 * warp + g;  // and row + 8
  const uint32_t qa = sQ + wg * ROWS * Gm::ROWB, da = sdO + wg * ROWS * Gm::ROWB;
  const float sl2 = scale * LOG2E;  // score -> base-2 exponent
  const long long n = static_cast<long long>(gridDim.y) * Hq * Sp;
  const long long base = (static_cast<long long>(b) * Hq + h) * Sp;
  float m[2], il[2], pv[2], rd[2], l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = DQ ? stat[base + row + 8 * r] : NEG_INF;
    il[r] = DQ ? stat[n + base + row + 8 * r] : 0.f;
    pv[r] = DQ ? delta[base + row + 8 * r] : 0.f;
    rd[r] = DQ ? delta[n + base + row + 8 * r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int stage = it % STAGES;
    mbar_wait(full0 + 8 * stage, (it / STAGES) & 1);
    const uint32_t kv = sKV + stage * 2 * Gm::T64;
    float s[TK / 2], dp[TK / 2];
    nt_mma<D>(s, qa, TB, kv, TK);
    nt_mma<D>(dp, da, TB, kv + Gm::T64, TK);
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);
    const int k0 = kt * TK;
    const bool edge = k0 + TK > S || (causal && k0 + TK - 1 > r0) ||
                      (window > 0 && k0 <= r0 + ROWS - 1 - window);
    if constexpr (!DQ) {
      if (edge)
        stats_step<true>(s, dp, m, pv, l, u, row, k0, c, S, causal, window, sl2);
      else
        stats_step<false>(s, dp, m, pv, l, u, row, k0, c, S, causal, window, sl2);
    } else {
      uint32_t a[TK / 16][4];
      if (edge)
        ds_rows<true>(s, dp, m, il, pv, rd, a, row, k0, c, S, causal, window, sl2);
      else
        ds_rows<false>(s, dp, m, il, pv, rd, a, row, k0, c, S, causal, window, sl2);
      reg_fence(acc);
      reg_fence(a);
      nn_mma<D>(acc, a, kv, TK);
      wg_wait0();
      reg_fence(acc);
      reg_fence(a);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
  }

  if constexpr (!DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
      const int rr = row + 8 * r;
      const float inv = 1.f / l[r];
      if (c == 0) {  // rows past S: P = exp2(-inf) * 0 = 0 in passes 1 and 2
        stat[base + rr] = rr < S ? m[r] : INFINITY;
        stat[n + base + rr] = rr < S ? inv : 0.f;
        delta[base + rr] = rr < S ? pv[r] : 0.f;
        delta[n + base + rr] = rr < S ? u[r] * inv : 0.f;
      }
    }
  } else {
    // the warpgroup's Q rows are read by nothing any more: dQ goes out
    // through them
    store_rows<D>(acc, scale, qa, &tdq, r0, h, b, S, wg, tid);
  }
}

// Pass 1: dK and dV of one 128-key tile of kv head hk, over query heads
// hk G + [g0, g1) (split z of `splits`) and the q tiles the mask reaches.
// S and dP are taken as passes 0 and 2 take them (q rows against a
// warpgroup's 64 keys, the same wgmma on the same operands), so dP - delta
// cancels as it did where delta was summed.  With one split dK and dV go
// out through the tile's own K and V rows; with more, as f32 partials into
// part (2, splits, B, Hkv, Sp, D): dK's, scaled, then dV's.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
kv_pass(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
        const float* __restrict__ stat, const float* __restrict__ delta,
        float* __restrict__ part, int S, int Sp, int Hq, int Hkv, int G, int splits, int causal,
        int window, float scale) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  // the ring, the warpgroups' P and dS tiles, then K and V: an operand read
  // past a tile (as a wrong descriptor would make) stays in the block's memory
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // stage s: Q at sQ + 2 s T64, then dO
  const uint32_t sP = sQ + STAGES * 2 * Gm::T64;  // warpgroup w: P at sP + 2 w PS_BYTES, then dS
  const uint32_t sK = sP + 4 * PS_BYTES;
  const uint32_t sV = sK + Gm::T128;
  const uint32_t sSt = sV + Gm::T128;  // stage s: statistics at sSt + s STAT_BYTES
  const float* st_gen = reinterpret_cast<const float*>(smem_raw + (sSt - smem_u32(smem_raw)));
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES, kvbar = full0 + 16 * STAGES;

  const int hk = blockIdx.x / splits, z = blockIdx.x % splits, b = blockIdx.y;
  const int k0 = blockIdx.z * TB;  // key tile 0 reaches the most q tiles: heavy first
  const int chunk = (G + splits - 1) / splits;
  const int g0 = z * chunk, g1 = min(G, g0 + chunk);
  const int k_last = min(S, k0 + TB) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  const int qt0 = q_lo / ROWS, nq = (q_hi + ROWS - 1) / ROWS - qt0;
  const int n_it = (g1 - g0) * nq;
  const long long n = static_cast<long long>(gridDim.y) * Hq * Sp;
  const int wg = threadIdx.x / WG;
  init_ring(full0, empty0, kvbar);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(kvbar, 2 * Gm::T128);
      load_rows<D>(sK, &tk, kvbar, TB, k0, hk, b);
      load_rows<D>(sV, &tv, kvbar, TB, k0, hk, b);
      for (int it = 0; it < n_it; ++it) {
        const int h = hk * G + g0 + it / nq, q0 = (qt0 + it % nq) * ROWS;
        const int stage = it % STAGES;
        mbar_wait(empty0 + 8 * stage, ((it / STAGES) & 1) ^ 1);
        const uint32_t fb = full0 + 8 * stage, dst = sQ + stage * 2 * Gm::T64;
        const uint32_t sst = sSt + stage * STAT_BYTES;
        const long long at = (static_cast<long long>(b) * Hq + h) * Sp + q0;
        mbar_expect_tx(fb, 2 * Gm::T64 + STAT_BYTES);
        load_rows<D>(dst, &tq, fb, ROWS, q0, h, b);
        load_rows<D>(dst + Gm::T64, &tdo, fb, ROWS, q0, h, b);
        bulk_load(sst, stat + at, ROWS * 4, fb);
        bulk_load(sst + ROWS * 4, stat + n + at, ROWS * 4, fb);
        bulk_load(sst + 2 * ROWS * 4, delta + at, ROWS * 4, fb);
        bulk_load(sst + 3 * ROWS * 4, delta + n + at, ROWS * 4, fb);
      }
    }
    return;
  }
  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int kw0 = k0 + ROWS * wg;
  const int rq = 16 * warp + g;  // this thread's q rows of a tile: rq and rq + 8
  const uint32_t ka = sK + wg * ROWS * Gm::ROWB, va = sV + wg * ROWS * Gm::ROWB;
  const uint32_t pb = sP + wg * 2 * PS_BYTES, db = pb + PS_BYTES;
  const float sl2 = scale * LOG2E;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it % nq) * ROWS;
    const int stage = it % STAGES;
    mbar_wait(full0 + 8 * stage, (it / STAGES) & 1);
    const uint32_t qs = sQ + stage * 2 * Gm::T64;
    float s[ROWS / 2], dp[ROWS / 2];
    nt_mma<D>(s, qs, ROWS, ka, TB);             // S = Q K^T
    nt_mma<D>(dp, qs + Gm::T64, ROWS, va, TB);  // dP = dO V^T
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);
    const bool edge = (causal && kw0 + ROWS - 1 > q0) || (window > 0 && kw0 <= q0 + ROWS - 1 - window);
    const float* st = st_gen + stage * (STAT_BYTES / 4);
    if (edge)
      p_ds_store<true>(s, dp, st, pb, db, q0, rq, kw0, c, causal, window, sl2);
    else
      p_ds_store<false>(s, dp, st, pb, db, q0, rq, kw0, c, causal, window, sl2);
    // every warp's P and dS rows are in place before the products read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    reg_fence(dk);
    reg_fence(dv);
    tt_mma<D>(dv, pb, qs + Gm::T64);  // dV += P^T dO
    tt_mma<D>(dk, db, qs);            // dK += dS^T Q
    wg_wait0();
    reg_fence(dk);
    reg_fence(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  }

  if (splits == 1) {
    // the warpgroup's K and V rows are read by nothing any more
    store_rows<D>(dk, scale, ka, &tdk, kw0, hk, b, S, wg, tid);
    store_rows<D>(dv, 1.f, va, &tdv, kw0, hk, b, S, wg, tid);
    return;
  }
  const int key = kw0 + rq;  // the accumulators' rows: keys key and key + 8
  const long long split = static_cast<long long>(gridDim.y) * Hkv * Sp * D;
  const long long at = ((static_cast<long long>(b) * Hkv + hk) * Sp + key) * D;
  float* pk = part + z * split + at;
  float* pv = part + (splits + z) * split + at;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = 8 * r * D + 8 * j + 2 * c;
      *reinterpret_cast<float2*>(pk + off) =
          make_float2(dk[4 * j + 2 * r] * scale, dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(pv + off) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
}

// dK and dV of a split pass 1: each pair of columns the sum of its
// partials in split order, stored as bf16 through the outputs' strides.
__global__ void kv_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs, int B, int Hkv,
                       int S, int Sp, int D, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int half = D / 2;
  if (i >= static_cast<long long>(B) * Hkv * S * half) return;
  const int d = 2 * static_cast<int>(i % half);
  const long long t = i / half;
  const int row = static_cast<int>(t % S);
  const int hk = static_cast<int>((t / S) % Hkv);
  const int b = static_cast<int>(t / (static_cast<long long>(S) * Hkv));
  const long long split = static_cast<long long>(B) * Hkv * Sp * D;
  const long long at = ((static_cast<long long>(b) * Hkv + hk) * Sp + row) * D + d;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 x = *reinterpret_cast<const float2*>(part + z * split + at);
    const float2 y = *reinterpret_cast<const float2*>(part + (splits + z) * split + at);
    sk.x += x.x;
    sk.y += x.y;
    sv.x += y.x;
    sv.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + b * dks.b + hk * dks.h + row * dks.s + d) =
      __floats2bfloat162_rn(sk.x, sk.y);
  *reinterpret_cast<__nv_bfloat162*>(dv + b * dvs.b + hk * dvs.h + row * dvs.s + d) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *part;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int B, Hq, Hkv, S, causal, window, splits;
  float scale;
  cudaStream_t stream;
};

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
cudaError_t launch_bf16(const Args& a) {
  using Gm = Geo<D>;
  const int G = a.Hq / a.Hkv;
  if (a.splits < 1 || a.splits > G || (a.splits > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv;
  if (!make_map(&mq, a.q, D, a.S, a.Hq, a.B, a.qs, ROWS, Gm::BOX) ||
      !make_map(&mk, a.k, D, a.S, a.Hkv, a.B, a.ks, ROWS, Gm::BOX) ||
      !make_map(&mv, a.v, D, a.S, a.Hkv, a.B, a.vs, ROWS, Gm::BOX) ||
      !make_map(&mdo, a.dout, D, a.S, a.Hq, a.B, a.dos, ROWS, Gm::BOX) ||
      !make_map(&mdq, a.dq, D, a.S, a.Hq, a.B, a.dqs, ROWS, Gm::BOX) ||
      !make_map(&mdk, a.dk, D, a.S, a.Hkv, a.B, a.dks, ROWS, Gm::BOX) ||
      !make_map(&mdv, a.dv, D, a.S, a.Hkv, a.B, a.dvs, ROWS, Gm::BOX))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = set_smem(q_pass<D, false>, Gm::SMEM_Q)) != cudaSuccess) return e;
  if ((e = set_smem(q_pass<D, true>, Gm::SMEM_Q)) != cudaSuccess) return e;
  if ((e = set_smem(kv_pass<D>, Gm::SMEM_KV)) != cudaSuccess) return e;
  const int Sp = (a.S + TB - 1) / TB * TB;  // the statistics' rows
  const dim3 gq(a.Hq, a.B, Sp / TB);
  q_pass<D, false><<<gq, WS_THREADS, Gm::SMEM_Q, a.stream>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.delta, a.S, Sp, a.Hq, G, a.causal, a.window, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kv_pass<D><<<dim3(a.Hkv * a.splits, a.B, Sp / TB), WS_THREADS, Gm::SMEM_KV, a.stream>>>(
      mq, mk, mv, mdo, mdk, mdv, a.lse, a.delta, a.part, a.S, Sp, a.Hq, a.Hkv, G, a.splits,
      a.causal, a.window, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.splits > 1) {
    const long long pairs = static_cast<long long>(a.B) * a.Hkv * a.S * (D / 2);
    const unsigned blocks = static_cast<unsigned>((pairs + 255) / 256);
    kv_sum<<<blocks, 256, 0, a.stream>>>(
        a.part, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.dks,
        a.dvs, a.B, a.Hkv, a.S, Sp, D, a.splits);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  q_pass<D, true><<<gq, WS_THREADS, Gm::SMEM_Q, a.stream>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.delta, a.S, Sp, a.Hq, G, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// The form is the dtype's: float32 the CUDA-core form, bfloat16 the
// tensor-core one.
template <int D>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_typed<float, D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the same for q, k, v, dout, dq, dk and
// dv.  q, dout, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); each given
// by its (batch, head, seq) strides in elements, the head dim contiguous
// (bfloat16: every pointer 16-byte aligned and every other stride a
// multiple of 8 elements, as TMA needs; a map that cannot be encoded
// returns cudaErrorInvalidValue).  lse and delta: float32 scratch of the
// row statistics, (B, Hq, S) each for float32; for bfloat16 (2, B, Hq, Sp)
// each (m and 1 / l; the pivot and delta - pivot), Sp = S rounded up to
// 128.  part:
// bfloat16 with splits > 1 only, float32 scratch (2, splits, B, Hkv, Sp, D)
// of pass 1's partial dK and dV; splits: the groups a kv head's G query
// heads are cut into for pass 1 (1 <= splits <= G, the last group possibly
// shorter; 1 for float32).  Returns the launches' cudaError_t (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, float* part, int dtype, int B, int Hq, int Hkv,
                                   int S, int D, int splits,
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
  const Args a{q, k, v, dout, dq, dk, dv, lse, delta, part,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, B, Hq, Hkv, S, causal, window, splits, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return int(launch<32>(dtype, a));
    case 64: return int(launch<64>(dtype, a));
    case 128: return int(launch<128>(dtype, a));
    default: return int(cudaErrorInvalidValue);
  }
}
