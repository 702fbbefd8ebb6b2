// Forward flash attention for Hopper (sm_90a), one launch per attention layer.
//
// Replaces the TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :81): blockwise
// online softmax with f32 running max m, row sum l and accumulator acc,
// causal and sliding-window masks, GQA by kv head = h / G, and a final
// acc / max(l, 1e-30).
//
// Design.  On the TPU the kv blocks are the innermost, sequential grid axis
// and m/l/acc live in VMEM scratch between grid steps.  CUDA blocks run in
// no order, so here one block owns one (q tile, q head, batch) and walks the
// key tiles in a loop, with m, l and acc kept on chip.
// The loop bounds skip whole tiles that the mask would zero (causal stops at
// the diagonal, a window starts at q_start - window + 1); inside a tile the
// mask is the TPU kernel's (-1e30 for masked scores, p = 0 where masked).
// Rows and columns at or beyond S are masked here, so the caller pads
// nothing: a ragged S costs no copy and no padded key enters a softmax.
//
// Bound.  At the llama3.2-1b prefill shape (B=4, Hq=32, Hkv=8, S=2048,
// D=64, bf16, causal) the work is 4*32*(2048*2049/2)*64*2*2 = 68.7 GFLOP
// against 84 MB of q, k, v and o: 0.069 ms at 989 TFLOP/s of bf16 tensor
// cores against 0.025 ms at 3.35 TB/s, so the kernel is compute-bound.
//
// Two kernels share that structure:
// - bf16 (the model path): tensor cores through mma.sync m16n8k16 with f32
//   accumulation.  4 warps, each owning 16 of the block's 64 q rows; Q
//   stays in registers as A fragments, K and V tiles in shared memory, and
//   the score fragments are rescaled, masked, exponentiated and re-packed
//   as the A fragments of P @ V without leaving registers.  P enters that
//   product rounded to bf16; m, l and acc stay f32.  No cp.async or TMA
//   pipelining yet, and no wgmma: both are later work.
// - f32: scalar FMAs on the CUDA cores (8 warps, a 4 x 4 score tile and a
//   4 x D/16 output tile per thread from shared memory), exact enough for
//   the 2e-4 tolerance, far from any tensor-core bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 8 warps
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Qs and Ks padded to D+1 floats a row (conflict-free column walks),
  // Vs unpadded, Ps padded to BK+1, then m, l and alpha per row.
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D
                          + size_t(BQ) * (BK + 1) + 3 * BQ);
}

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides qs,
                     Strides ks, Strides vs, Strides os,
                 int S, int G, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;
  float* m_s = Ps + BQ * LDP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * LD + d] = row < S ? qb[row * qs.s + d] * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Key range this q tile can see; whole tiles outside it are all-masked
  // and would leave m, l and acc unchanged.
  const int hi = causal ? min(S, q0 + BQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_end = (hi + BK - 1) / BK;

  for (int kt = lo / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int col = k0 + r;
      const bool in = col < S;
      Ks[r * LD + d] = in ? kb[col * ks.s + d] : 0.f;
      Vs[r * D + d] = in ? vb[col * vs.s + d] : 0.f;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w+7, two columns a lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const int row = q0 + r;
      float sv[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cc = lane + 32 * c;
        const int col = k0 + cc;
        ok[c] = col < S;
        if (causal) ok[c] = ok[c] && col <= row;
        if (window > 0) ok[c] = ok[c] && col > row - window;
        sv[c] = Ps[r * LDP + cc];
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ok[c] ? expf(sv[c] - m_new) : 0.f;
        Ps[r * LDP + lane + 32 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P @ V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[row * os.s + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 q rows

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a (16x16, row) @ b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout (PTX ISA, m16n8k16): lane = 4 g + t.  A: a0 = row g, cols
// 2t..2t+1; a1 = row g+8; a2, a3 = the same rows at cols 2t+8..2t+9.  B:
// b0 = rows (k) 2t..2t+1 of col (n) g; b1 = rows 2t+8..2t+9.  C: c0, c1 =
// row g, cols 2t..2t+1; c2, c3 = row g+8.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Strides qs, Strides ks, Strides vs, Strides os, int S, int G, int causal,
                      int window, float scale) {
  constexpr int LD = D + 8;   // bf16 a smem row: 16-byte rows, conflict-free fragments
  constexpr int NT = BK / 8;  // score n-tiles of a warp (NT * 4 = 32 mask bits)
  constexpr int DT = D / 8;   // output n-tiles
  constexpr int DK = D / 16;  // k-steps over the head dim
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int row0 = q0 + int(threadIdx.x >> 5) * 16 + g;  // this lane's rows
  const int rows[2] = {row0, row0 + 8};

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e & 1];
      const int col = kk * 16 + 2 * t + (e >> 1) * 8;
      qa[kk][e] = row < S ? ld32(qb + row * qs.s + col) : 0u;
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  const int hi = causal ? min(S, q0 + BQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_end = (hi + BK - 1) / BK;

  for (int kt = lo / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D / 2; i += MMA_THREADS) {
      const int r = i / (D / 2), c = (i % (D / 2)) * 2;
      const int col = k0 + r;
      const bool in = col < S;
      *reinterpret_cast<uint32_t*>(&Ks[r * LD + c]) = in ? ld32(kb + col * ks.s + c) : 0u;
      *reinterpret_cast<uint32_t*>(&Vs[r * LD + c]) = in ? ld32(vb + col * vs.s + c) : 0u;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const __nv_bfloat16* kp = &Ks[(8 * j + g) * LD + kk * 16 + 2 * t];
        mma_bf16(s[j], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    uint32_t ok = 0;  // bit 4j+e: score s[j][e] is attended
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        bool in = col < S;
        if (causal) in = in && col <= row;
        if (window > 0) in = in && col > row - window;
        s[j][e] = in ? s[j][e] * scale : NEG_INF;
        ok |= uint32_t(in) << (4 * j + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P @ V: the C fragments of two score n-tiles are the A
    // fragment of one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = &Vs[(16 * kk + 2 * t) * LD + g];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vj = vp + 8 * j;
        mma_bf16(acc[j], pa, pack(vj[0], vj[LD]), pack(vj[8 * LD], vj[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* orow = ob + rows[r] * os.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack(acc[j][2 * r] * l[r], acc[j][2 * r + 1] * l[r]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int B, Hq, Hkv, S, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_f32_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks, a.vs, a.os, a.S,
      a.Hq / a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_bf16_kernel<D><<<grid, MMA_THREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.qs, a.ks,
      a.vs, a.os, a.S, a.Hq / a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; the last dim is
// contiguous, and for bfloat16 every stride is even and every pointer
// 4-byte aligned (the kernel reads and writes bf16 pairs).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Hq, int Hkv, int S, int D,
                                   long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, o, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, B, Hq, Hkv, S, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return int(launch<32>(dtype, a));
    case 64: return int(launch<64>(dtype, a));
    case 128: return int(launch<128>(dtype, a));
    default: return int(cudaErrorInvalidValue);
  }
}
