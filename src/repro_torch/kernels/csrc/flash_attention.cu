// Forward flash attention for Hopper (sm_90a), one launch per attention layer.
//
// Replaces the TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :81): blockwise
// online softmax with f32 running max m, row sum l and accumulator acc,
// causal and sliding-window masks, GQA by kv head = h / G, and a final
// acc / max(l, 1e-30).
//
// On the TPU the kv blocks are the innermost, sequential grid axis and
// m/l/acc live in VMEM scratch between grid steps.  CUDA blocks run in no
// order, so here one block owns one (q tile, q head, batch) and walks the
// key tiles in a loop, with m, l and acc kept on chip.  The loop bounds skip
// whole tiles that the mask would zero (causal stops at the diagonal, a
// window starts at q_start - window + 1); inside a tile the mask is the TPU
// kernel's (-1e30 for masked scores, p = 0 where masked).  Rows and columns
// at or beyond S are handled here, so the caller pads nothing.
//
// bf16 (the model path), warp-specialised:
// - A block owns 128 query rows of one (batch, q head): two consumer
//   warpgroups of 64 rows and one producer warpgroup.  `setmaxnreg` gives
//   the consumers 232 registers a thread and the producer 40.  Under a
//   causal mask the q tiles are taken heavy-first (the last tile, with the
//   most keys, has blockIdx.x 0).
// - Loads are TMA copies.  Q is loaded once; K and V tiles of 128 keys go
//   through a ring of STAGES = 2 stages, each with a "full" mbarrier (the
//   producer's expect_tx, completed by the copies' bytes) and an "empty"
//   one (one arrival from each consumer warp once its products have read
//   the stage), so the loads of tile i + 1 run under the products of tile
//   i.  A row of D bf16 is cut into boxes of at most 64 columns, swizzled
//   128 bytes (D = 64, 128; two boxes at D = 128) or 64 bytes (D = 32),
//   and the wgmma descriptors name the same swizzle.  The tensor maps are
//   4-D, (D, S, H, B) over the caller's strides, so transposed model-layout
//   views are read in place, and TMA's zero fill covers the ragged edge
//   past S.
// - S = Q K^T is a wgmma m64n128k16 per 16 columns of D, both operands
//   K-major in shared memory, f32 accumulators.  The online softmax runs on
//   the accumulator fragments: row max and sum over the quad of lanes that
//   share a row; the exponent is the raw score times scale * log2(e) less
//   the running max (one FMA, in that base-2 domain) through exp2 on the
//   MUFU unit (ex2.approx.ftz); m, l and acc stay f32.  The mask is
//   evaluated only on a tile that crosses the causal diagonal, the
//   window's lower edge or S.
// - O += P V is a wgmma m64nDk16 per 16 keys with A = P from registers (the
//   score fragments rounded to bf16 and re-packed as A fragments) and B = V
//   read MN-major from the ring (the transpose bit), so no copy of V is
//   transposed.
// - Each consumer waits for its own products before its softmax; the SM
//   overlaps one warpgroup's softmax with the other's products as it
//   schedules them.  Issuing S_i together with P_{i-1} V_{i-1} and taking
//   turns between the warpgroups (named barriers, as FlashAttention-3
//   does) was slower at every timed shape on an H100, and a third stage
//   bought nothing, so neither is here.  A persistent grid is later work.
// - Epilogue: acc / max(l, 1e-30) in bf16 into the warpgroup's own Q rows
//   of shared memory, swizzled as the output's tensor map expects, then one
//   TMA store, clipped at S.
//
// Bound.  At the llama3.2-1b prefill shape (B=4, Hq=32, Hkv=8, S=1024,
// D=64, bf16, causal) the products the mask leaves are
// 4*32*(1024*1025/2)*64*4 = 17.2 GFLOP against 33.6 MB of q, k, v and o:
// 0.0174 ms at 989 TFLOP/s of bf16 tensor cores against 0.0100 ms at
// 3.35 TB/s, so the kernel is bound by operations.  At D = 64 the
// exponentials (one MUFU ex2 per score, 16 a cycle an SM) take as long as
// the two products on the tensor cores, so only a softmax that overlaps
// the products can come near that bound.
//
// f32 (the smoke's float32 layer gates): scalar FMAs on the CUDA cores (8
// warps, a 4 x 4 score tile and a 4 x D/16 output tile per thread from
// shared memory), exact enough for the 2e-4 tolerance, far from any
// tensor-core bound.
#include <cuda.h>
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
// bf16: wgmma on a TMA ring
// ---------------------------------------------------------------------------

constexpr int TQ = 128;             // query rows per block
constexpr int TK = 128;             // key rows per ring stage
constexpr int STAGES = 2;           // ring depth
constexpr int WG = 128;             // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;  // two consumer warpgroups, then the producer
constexpr int CONSUMER_WARPS = 8;   // arrivals that free a stage
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of one head dim.  A row of D bf16 is cut into
// boxes of BOX columns; a box of 128 rows is one TMA copy, swizzled over SW
// bytes (its row length), and tiles lie box after box.
template <int D>
struct Geo {
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int NBOX = D / BOX;
  static constexpr int ROWB = 2 * BOX;            // bytes of a box row
  static constexpr int SW = ROWB;                 // swizzle span: 64 or 128 bytes
  static constexpr int BOX_BYTES = TQ * ROWB;     // one box of a Q, K or V tile
  static constexpr int TILE_BYTES = NBOX * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K, then V
  static constexpr int SMEM = 1024 + TILE_BYTES + STAGES * STAGE_BYTES;  // + alignment
  static_assert(TQ == TK, "Q and K/V boxes share one size");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte a TMA swizzle of SW bytes moves the offset `a` (from a base
// aligned to 1024) to: the 16-byte chunk index XORed with the row bits.
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ ((a >> 3) & (SW == 128 ? 0x70u : 0x30u));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D (D, S, H, B) tensor map into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the fences and waits around the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128 bytes, 2 = 64 bytes).
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : 2;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (desc) x B (desc)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Accumulator fragments of a wgmma m64nN (f32): thread t of the warpgroup,
// warp w = t / 32, lane = 4 g + c, holds for each 8-column block j the
// elements d[4j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 c + (e & 1).
// The A fragment of m64k16 from registers is the m16n8k16 one of mma.sync
// per warp: a0 = (row g, cols 2c, 2c+1), a1 = row g + 8, a2 and a3 the same
// rows at cols 2c + 8, 2c + 9; so the fragments of score blocks 2kk and
// 2kk + 1 are the A fragment of key step kk.

// s = Q K^T for the 64 rows of Q at `q` and the 128 keys of the K tile at
// `k`; both are K-major (D contiguous) boxes.  Issued and committed, not
// waited for.
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[TK / 2], uint32_t q, uint32_t k) {
  using Gm = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / Gm::BOX) * Gm::BOX_BYTES + (kk * 16 % Gm::BOX) * 2;
    wgmma_ss_n128(s, make_desc<Gm::SW>(q + off, 16, 8 * Gm::ROWB),
                  make_desc<Gm::SW>(k + off, 16, 8 * Gm::ROWB), kk > 0);
  }
  wg_commit();
}

// o += P V with P's A fragments in registers and the V tile at `v` read
// MN-major (D contiguous): 8 keys of a box lie 8 * ROWB apart (stride
// offset), the next 64 columns one box on (leading offset).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&p)[TK / 16][4],
                                           uint32_t v) {
  using Gm = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_rs(o, p[kk], make_desc<Gm::SW>(v + kk * 16 * Gm::ROWB, Gm::BOX_BYTES, 8 * Gm::ROWB));
  wg_commit();
}

// exp2f by the MUFU unit alone, flushing results below 2^-126 to zero (a
// p that small is lost in any row sum it joins).
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One key tile's online-softmax step on the score fragments s of rows
// `row` and `row + 8` (this thread's), keys k0 + 8 j + 2 c + (e & 1).  Only
// an EDGE tile (one that crosses the causal diagonal, the window's lower
// edge or S) evaluates the mask.  Leaves P's bf16 A fragments in p and
// rescales o.
template <bool EDGE, int D>
__device__ __forceinline__ void softmax_step(float (&s)[TK / 2], float (&o)[D / 2], float (&m)[2],
                                             float (&l)[2], uint32_t (&p)[TK / 16][4], int row,
                                             int k0, int c, int S, int causal, int window,
                                             float sl2) {
  uint64_t ok = ~0ull;  // bit 4j+e: score s[4j+e] is attended
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (EDGE) {
        const int r = row + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * c + (e & 1);
        bool in = col < S;
        if (causal) in = in && col <= r;
        if (window > 0) in = in && col > r - window;
        if (!in) {
          s[4 * j + e] = NEG_INF;
          ok &= ~(1ull << (4 * j + e));
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);  // base-2 domain
    alpha[r] = exp2_mufu(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2_mufu(fmaf(s[4 * j + e], sl2, -m[e >> 1]));
      if (EDGE) pe = (ok >> (4 * j + e)) & 1ull ? pe : 0.f;
      s[4 * j + e] = pe;
      l[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  // P's A fragments: the fragments of score blocks 2kk and 2kk + 1
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The key tiles [kt0, kt1) that a q tile starting at q0 can see; producer
// and consumers walk the same range.
__device__ __forceinline__ void key_tiles(int q0, int S, int causal, int window, int& kt0,
                                          int& kt1) {
  const int hi = causal ? min(S, q0 + TQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kt0 = lo / TK;
  kt1 = (hi + TK - 1) / TK;
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      int S, int G, int causal, int window, float scale) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Gm::TILE_BYTES;
  const uint32_t full0 = smem_u32(bars);            // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;       // empty[s]
  const uint32_t qbar = full0 + 16 * STAGES;

  const int qt = causal ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x);  // heavy first
  const int q0 = qt * TQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  int kt0, kt1;
  key_tiles(q0, S, causal, window, kt0, kt1);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(qbar, Gm::TILE_BYTES);
#pragma unroll
      for (int bx = 0; bx < Gm::NBOX; ++bx)
        tma_load(sQ + bx * Gm::BOX_BYTES, &tq, qbar, bx * Gm::BOX, q0, h, b);
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int stage = it % STAGES;
        mbar_wait(empty0 + 8 * stage, ((it / STAGES) & 1) ^ 1);
        const uint32_t fb = full0 + 8 * stage;
        const uint32_t dst = sKV + stage * Gm::STAGE_BYTES;
        mbar_expect_tx(fb, Gm::STAGE_BYTES);
#pragma unroll
        for (int bx = 0; bx < Gm::NBOX; ++bx) {
          tma_load(dst + bx * Gm::BOX_BYTES, &tk, fb, bx * Gm::BOX, kt * TK, hk, b);
          tma_load(dst + Gm::TILE_BYTES + bx * Gm::BOX_BYTES, &tv, fb, bx * Gm::BOX, kt * TK, hk,
                   b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows r0 .. r0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int r0 = q0 + 64 * wg;
    const int row = r0 + 16 * warp + g;  // and row + 8
    const uint32_t q = sQ + wg * 64 * Gm::ROWB;
    const float sl2 = scale * LOG2E;  // score -> base-2 exponent

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums

    mbar_wait(qbar, 0);
    for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
      const int stage = it % STAGES;
      mbar_wait(full0 + 8 * stage, (it / STAGES) & 1);
      const uint32_t kv = sKV + stage * Gm::STAGE_BYTES;
      float s[TK / 2];
      qk_product<D>(s, q, kv);
      wg_wait0();
      reg_fence(s);
      const int k0 = kt * TK;
      const bool edge = k0 + TK > S || (causal && k0 + TK - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 63 - window);
      uint32_t p[TK / 16][4];
      if (edge)
        softmax_step<true, D>(s, o, m, l, p, row, k0, c, S, causal, window, sl2);
      else
        softmax_step<false, D>(s, o, m, l, p, row, k0, c, S, causal, window, sl2);
      reg_fence(o);
      reg_fence(p);
      pv_product<D>(o, p, kv + Gm::TILE_BYTES);
      wg_wait0();
      reg_fence(o);
      reg_fence(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    // the warpgroup's Q rows are read by nothing any more: stage O there,
    // swizzled as the output map's boxes, and store it with one TMA copy
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      const uint32_t box = q + (col / Gm::BOX) * Gm::BOX_BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t a = box + swz<Gm::SW>((16 * warp + g + 8 * r) * Gm::ROWB + (col % Gm::BOX) * 2);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                     "r"(pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    if (tid == 0 && r0 < S) {
#pragma unroll
      for (int bx = 0; bx < Gm::NBOX; ++bx)
        tma_store(&to, q + bx * Gm::BOX_BYTES, bx * Gm::BOX, r0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found at run time so that the
// library links against the runtime only (the call is in CUDA 12.5 and
// later; the kernels are built with 12.9).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D, S, H, B) of bf16 over element strides st (D contiguous),
// read and written in boxes of `box` columns by `rows` rows, swizzled over a
// box row.  Returns false if cuTensorMapEncodeTiled refuses it.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, Strides st,
              int rows, int box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  // byte strides of dims 1..3; a dim of extent 1 is never stepped, so any
  // valid stride stands in for one the caller left unaligned
  const long long el[3] = {st.s, st.h, st.b};
  const int ext[3] = {S, H, B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = cuuint64_t(ext[i] == 1 ? D : el[i]) * 2;
  cuuint32_t boxd[4] = {cuuint32_t(box), cuuint32_t(rows), 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using Gm = Geo<D>;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, D, a.S, a.Hq, a.B, a.qs, TQ, Gm::BOX) ||
      !make_map(&mk, a.k, D, a.S, a.Hkv, a.B, a.ks, TK, Gm::BOX) ||
      !make_map(&mv, a.v, D, a.S, a.Hkv, a.B, a.vs, TK, Gm::BOX) ||
      !make_map(&mo, a.o, D, a.S, a.Hq, a.B, a.os, 64, Gm::BOX))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + TQ - 1) / TQ, a.Hq, a.B);
  flash_fwd_bf16_kernel<D><<<grid, WS_THREADS, Gm::SMEM, a.stream>>>(
      mq, mk, mv, mo, a.S, a.Hq / a.Hkv, a.causal, a.window, a.scale);
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
// contiguous.  For bfloat16 the kernel reads and writes through TMA: every
// pointer 16-byte aligned and every other stride a multiple of 8 elements
// (16 bytes); a map that cannot be encoded returns cudaErrorInvalidValue.
// Returns the launch's cudaError_t (0 on success).
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
