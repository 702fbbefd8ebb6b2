// WKV6 backward for Hopper (sm_90a): kernel K2b, the backward of K2 on the
// port's kernel-path rwkv6 train step (one launch per rwkv layer).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel and
// takes the gradient by autodiff through its plain scan
// (src/repro/train/train_step.py:32 through kernels/ref.py).  This kernel
// computes that gradient with respect to r, k, v, w and u for a given
// initial state S_{-1} (the model passes zeros) whose own gradient, and
// that of the final state, are not asked for.  Per (batch, head), forward
//   o_t = r_t (diag(u) k_t^T v_t + S_{t-1}),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// and with A_t the adjoint of S_t (A_{T-1} = 0), walking t from T-1 down:
//   dk_t[i] = sum_j A_t[i,j] v_t[j] + r_t[i] u[i] (do_t . v_t)
//   dv_t[j] = sum_i A_t[i,j] k_t[i] + do_t[j] sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = sum_j A_t[i,j] S_{t-1}[i,j]
//   dr_t[i] = sum_j S_{t-1}[i,j] do_t[j] + u[i] k_t[i] (do_t . v_t)
//   du[i]  += r_t[i] k_t[i] (do_t . v_t)
//   A_{t-1} = diag(w_t) A_t + r_t^T do_t
// all in f32.
//
// The trap is dw, which needs the forward state S_{t-1} beside the reverse
// adjoint A_t.  S_{t-1} cannot be recovered from S_t by dividing by w_t:
// the model's decay exp(-exp(x)) reaches exactly 0 in f32.  So nothing
// here divides: the forward is replayed once by `wkv6_ckpt_kernel`, which
// writes the state every C = 16 steps into a (B, H, ceil(S/C), D, D) f32
// buffer (268 MB at the rwkv6-7b train shape B=4, H=64, S=1024, D=64), and
// `wkv6_bwd_kernel` walks the chunks in reverse, re-deriving each chunk's
// C states from its checkpoint and stepping back through them.
//
// Design (the "cluster" form).  Key rows are independent in both
// recurrences (S[i, :] depends only on k_t[i] and w_t[i], A[i, :] only on
// r_t[i] and w_t[i]), so a block owns KB = 16 keys of one (batch, head) and
// all D value columns, and the D / 16 blocks of a (batch, head) form a
// thread-block cluster (4 at D = 64: 1024 blocks of 128 threads in all,
// 3 an SM).  Thread (warp, key group kg, column lane cq) owns keys 2 kg,
// 2 kg + 1 of the block's 16 and columns 16 warp + 4 cq .. + 3.
// - A chunk's states stay on chip, in registers, in two windows of 8
//   steps (8 x 8 values a thread): pass 1 replays the chunk's 16 steps from
//   its checkpoint, keeping the last 8 states, and walks those back; pass
//   2 replays the first 8 again and walks them back.  The checkpoint and
//   the chunk's inputs arrive by cp.async into shared memory two chunks
//   ahead, and are converted to f32 once.  A whole chunk takes an unguarded
//   path, so its steps interleave; only a ragged last chunk tests c < n.
// - No barrier a step.  Each step's sums over j (dk, dw from A; dr from
//   S) are summed over the thread's 4 columns and then over the 4 lanes of
//   its key group by a reduce-scatter of shuffles (two levels: each lane
//   keeps one of the four sums); dv's sum over i over the thread's 2 keys
//   and the warp's 8 key groups likewise (three levels); the step's sums go
//   to shared memory.  Once a chunk, after one block barrier, dk, dw, dr
//   and du are finished inside the block (the warps' partials summed in
//   order, the u-bonus terms added); only dv's partials cross the cluster:
//   each block sums its 16 columns over the cluster's blocks in rank
//   order, through distributed shared memory (double-buffered by chunk),
//   behind a split cluster barrier whose arrive comes before the block's
//   own sums and whose wait after them.
// - do_t . v_t is summed by every block over all columns; sum_i r u k of
//   dv's bonus goes with dv's partials.  du is summed per (batch, head)
//   over the sequence in order, then over the batch by a third kernel.
// Every output is summed in a fixed order: the result is bitwise the same
// from run to run.  Inputs are read, and dr, dk, dv, dw written, through
// (batch, head, seq) strides with the head dim contiguous; r, k, v, w and
// dO must be 16-byte aligned rows (the wrapper copies any that are not).
//
// Bound.  The least work is the forward's recurrence once and the adjoint
// recurrence once, 14 D^2 f32 operations per (b, h, t): the replayed
// state (k v and the decayed update, 3), the adjoint's update (3) and four
// sums over the D x D state, dk, dw, dr and dv (2 each); 15.0 GFLOP at
// B=4, H=64, S=1024, D=64, 0.224 ms at 67 TFLOP/s of f32 CUDA cores.  Its
// bytes: r, k, v, dO read and dr, dk, dv written (7 x 33.6 MB in bf16), w
// read and dw written (2 x 67.1 MB in f32), S_0 (4.2 MB), 373 MB, 0.111 ms
// at 3.35 TB/s: bound by operations.  This form replays the state twice
// (once to checkpoint, once a chunk: 2 more D^2 operations a step) and
// moves the checkpoints once each way (537 MB).
//
// Forms measured with chip_compare.py at B=4, H=64, S=1024, D=64 bf16
// (model layout), cold, each call with its replay, on one NVIDIA H100 80GB
// HBM3, 700.00 W, all in one call (PERF.md):
// - the first form (a block of 2D threads a (batch, head), a thread
//   a key and 32 value columns, the forward replayed twice, a chunk's
//   states through a (B, H, 16, D, D) f32 device buffer, two barriers a
//   step): 3.806 ms, ~17x the bound;
// - the cluster split by value columns (a block per 16 columns, dk, dw and
//   dr summed across the cluster through distributed shared memory, a
//   chunk's 16 states in registers): 2.849;
// - this form without its paired output stores, 16-byte conversion and
//   interleaved bonus columns: 1.923;
// - this form: 1.847 (8.2x the bound; 1.855 a call inside the rwkv6-7b
//   8-layer train step's backward); capped at 128 registers for 4 blocks
//   an SM it spills and takes 2.376.  Removing one per-chunk part at a
//   time (the results then wrong) took 1.537 without the cp.async copies,
//   1.624 without dk, dw, dr and du finished in the block, 1.754 without
//   the f32 conversion, 1.766 without dv across the cluster and 1.787
//   without the bonus sums.
// Slower in measurements not kept: the chunk's 16 states in registers in
// this key split (spills at 168 registers), every step guarded by c < n,
// and bulk TMA copies of the 32-byte staging rows in place of cp.async.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 16;   // steps a chunk, and between checkpoints
constexpr int KB = 16;  // keys a block
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// two and four consecutive elements as f32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const float2 a = ld2(p), b = ld2(p + 2);
  return make_float4(a.x, a.y, b.x, b.y);
}

// two consecutive elements from f32, in one 8- or 4-byte store
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n rows of `bytes` bytes each, row c from src + c * stride (elements of
// E), to dst + c * bytes; every thread of the block takes its share of the
// 16-byte segments
template <typename E, int NT>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const E* src, long long stride,
                                          int n, int bytes) {
  const int seg = bytes / 16;
  for (int s = threadIdx.x; s < n * seg; s += NT) {
    const int c = s / seg, q = s % seg;
    cp16(dst + c * bytes + q * 16,
         reinterpret_cast<const unsigned char*>(src + c * stride) + q * 16);
  }
}

template <int D>
struct Plan {
  static constexpr int CL = D / KB;       // blocks a cluster: one (batch, head)
  static constexpr int T = 2 * D;         // threads a block: 8 key groups x D / 4 lanes
  static constexpr int NW = T / 32;       // warps a block, 16 value columns each
  static constexpr int QS = NW * KB + 16; // a (step, quantity) row of the partials, padded
  static constexpr int VS = D + 8;        // a row of v and dO in the f32 staging, padded
  static constexpr int NI = (C * KB / 2 + T - 1) / T;  // a thread's column pairs of dv
  static constexpr int MINB = 384 / T > 0 ? 384 / T : 1;  // blocks an SM, for registers
  static constexpr int CK_MINB = 1024 / T;  // the replay's blocks an SM: all resident
  static_assert(D % KB == 0 && T % 32 == 0, "plan");
};

// Shared memory of wkv6_bwd_kernel, in bytes: two raw staging buffers, each
// r, k [C][KB] (T), w [C][KB] (f32), v, dO [C][D] (T) and the checkpoint
// [KB * D] (f32); then floats: the f32 staging r, k, w [C][KB], v, dO
// [C][VS]; the partial sums over each warp's columns [C][3][QS]; dv's
// partials over this block's keys [2][C][D]; sum r u k over this block's
// keys [2][C]; do . v [C]; u [KB].
template <int D, typename T>
struct Smem {
  using P = Plan<D>;
  static constexpr int R = 0;
  static constexpr int K = R + C * KB * sizeof(T);
  static constexpr int W = K + C * KB * sizeof(T);
  static constexpr int V = W + C * KB * 4;
  static constexpr int DO = V + C * D * sizeof(T);
  static constexpr int CK = DO + C * D * sizeof(T);
  static constexpr int RAW = CK + KB * D * 4;
  static constexpr int FLOATS = 3 * C * KB + 2 * C * P::VS + C * 3 * P::QS + 2 * C * D + 2 * C +
                                C + KB;
  static constexpr int BYTES = 2 * RAW + FLOATS * 4;
  // the replay kernel's staging, two buffers of k, w [C][KB] and v [C][D]
  static constexpr int CK_K = 0;
  static constexpr int CK_W = C * KB * sizeof(T);
  static constexpr int CK_V = CK_W + C * KB * 4;
  static constexpr int CK_BUF = CK_V + C * D * sizeof(T);
  static_assert(K % 16 == 0 && W % 16 == 0 && V % 16 == 0 && DO % 16 == 0 && CK % 16 == 0 &&
                    RAW % 16 == 0 && CK_W % 16 == 0 && CK_V % 16 == 0 && CK_BUF % 16 == 0,
                "16-byte staging");
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The replay: block (rank, h, b) owns keys [16 rank, 16 rank + 16) of
// (b, h) and all D value columns, threads laid out as in wkv6_bwd_kernel,
// and writes the state before each chunk (S_{-1} for chunk 0) into its
// slice of the checkpoints, thread by thread.
template <int D, typename T>
__global__ void __launch_bounds__(Plan<D>::T, Plan<D>::CK_MINB)
wkv6_ckpt_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ s0, float* __restrict__ ckpt, Strides ks, Strides vs,
                 Strides ws, int H, int S) {
  using P = Plan<D>;
  using SM = Smem<D, T>;
  constexpr int NT = P::T;
  extern __shared__ __align__(16) unsigned char craw[];
  const int tid = threadIdx.x, cq = tid & 3, kg = (tid >> 2) & 7, warp = tid >> 5;
  const int col = 16 * warp + 4 * cq;  // this thread's first value column
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = rank * KB;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nch = (S + C - 1) / C;
  const T* kb = k + b * ks.b + h * ks.h + i0;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h + i0;

  float st[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float4 s = ld4(s0 + (bh * D + i0 + 2 * kg + kk) * D + col);
    st[kk][0] = s.x;
    st[kk][1] = s.y;
    st[kk][2] = s.z;
    st[kk][3] = s.w;
  }
  auto issue = [&](int ch) {
    unsigned char* buf = craw + (ch & 1) * SM::CK_BUF;
    const int t0 = ch * C, n = min(C, S - t0);
    copy_rows<T, NT>(buf + SM::CK_K, kb + t0 * ks.s, ks.s, n, KB * sizeof(T));
    copy_rows<float, NT>(buf + SM::CK_W, wb + t0 * ws.s, ws.s, n, KB * 4);
    copy_rows<T, NT>(buf + SM::CK_V, vb + t0 * vs.s, vs.s, n, D * sizeof(T));
  };
  issue(0);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    float* out = ckpt + ((bh * nch + ch) * P::CL + rank) * (KB * D);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      *reinterpret_cast<float4*>(out + (kk * NT + tid) * 4) =
          make_float4(st[kk][0], st[kk][1], st[kk][2], st[kk][3]);
    if (ch + 1 < nch) issue(ch + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // chunk ch is staged
    const unsigned char* buf = craw + (ch & 1) * SM::CK_BUF;
    const T* k_s = reinterpret_cast<const T*>(buf + SM::CK_K);
    const float* w_s = reinterpret_cast<const float*>(buf + SM::CK_W);
    const T* v_s = reinterpret_cast<const T*>(buf + SM::CK_V);
    const int n = min(C, S - ch * C);
    auto steps = [&](auto full) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (decltype(full)::value || c < n) {
          const float2 k2 = ld2(k_s + c * KB + 2 * kg), w2 = ld2(w_s + c * KB + 2 * kg);
          const float4 v4 = ld4(v_s + c * D + col);
          const float kk2[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int m = 0; m < 4; ++m) st[kk][m] = fmaf(ww[kk], st[kk][m], kk2[kk] * vv[m]);
        }
      }
    };
    if (n == C)  // a whole chunk: no step is guarded, so steps interleave
      steps(std::true_type{});
    else
      steps(std::false_type{});
    __syncthreads();  // chunk ch's staging is read: chunk ch + 2 may land there
  }
}

// The backward: block (rank, h, b) of the cluster of (b, h) owns keys
// i0 .. i0 + 15 (i0 = 16 rank) and all D value columns, and finishes dk,
// dw, dr and du of its keys and dv of columns i0 .. i0 + 15.  Thread tid:
// column lane cq = tid & 3 and key group kg = (tid >> 2) & 7 of warp
// tid >> 5, which owns value columns 16 warp .. 16 warp + 15; the thread
// owns keys i0 + 2 kg + kk and columns 16 warp + 4 cq + m, where it keeps
// the adjoint A_t (adj[kk][m]) and a window of the chunk's states.
template <int D, typename T>
__global__ void __launch_bounds__(Plan<D>::T, Plan<D>::MINB)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ dout,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part, Strides rs, Strides ks,
                Strides vs, Strides ws, Strides dos, Strides drs, Strides dks, Strides dvs,
                Strides dws, int H, int S) {
  using P = Plan<D>;
  using SM = Smem<D, T>;
  constexpr int NT = P::T, NW = P::NW, QS = P::QS, VS = P::VS, CL = P::CL, NI = P::NI;
  constexpr int HW = C / 2;  // steps a window
  extern __shared__ __align__(16) unsigned char raw[];
  float* const r_s = reinterpret_cast<float*>(raw + 2 * SM::RAW);  // [C][KB]
  float* const k_s = r_s + C * KB;
  float* const w_s = k_s + C * KB;
  float* const v_s = w_s + C * KB;                // [C][VS]
  float* const do_s = v_s + C * VS;
  float* const jp = do_s + C * VS;                // [C][3][QS]: dk, dw, dr over a warp's columns
  float* const dvp = jp + C * 3 * QS;             // [2][C][D]: dv over this block's keys
  float* const rkp = dvp + 2 * C * D;             // [2][C]: sum r u k over this block's keys
  float* const dov = rkp + 2 * C;                 // [C]: do . v
  float* const u_s = dov + C;                     // [KB]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int cq = tid & 3, kg = (tid >> 2) & 7;
  const int col = 16 * warp + 4 * cq;
  const int b0 = tid & 1, b1 = (tid >> 1) & 1, b2 = (tid >> 2) & 1, b3 = (tid >> 3) & 1,
            b4 = (tid >> 4) & 1;
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = rank * KB;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nch = (S + C - 1) / C;
  const T* rb = r + b * rs.b + h * rs.h + i0;
  const T* kb = k + b * ks.b + h * ks.h + i0;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h + i0;
  const T* db = dout + b * dos.b + h * dos.h;

  for (int i = tid; i < KB; i += NT) u_s[i] = u[h * D + i0 + i];
  auto issue = [&](int ch) {
    unsigned char* buf = raw + (ch & 1) * SM::RAW;
    const int t0 = ch * C, n = min(C, S - t0);
    copy_rows<T, NT>(buf + SM::R, rb + t0 * rs.s, rs.s, n, KB * sizeof(T));
    copy_rows<T, NT>(buf + SM::K, kb + t0 * ks.s, ks.s, n, KB * sizeof(T));
    copy_rows<float, NT>(buf + SM::W, wb + t0 * ws.s, ws.s, n, KB * 4);
    copy_rows<T, NT>(buf + SM::V, vb + t0 * vs.s, vs.s, n, D * sizeof(T));
    copy_rows<T, NT>(buf + SM::DO, db + t0 * dos.s, dos.s, n, D * sizeof(T));
    copy_rows<float, NT>(buf + SM::CK, ckpt + ((bh * nch + ch) * CL + rank) * (KB * D), 0, 1,
                         KB * D * 4);
  };
  // two chunks in flight: chunk ch is waited for while chunk ch - 1 lands
  issue(nch - 1);
  cp_commit();
  if (nch > 1) issue(nch - 2);
  cp_commit();

  float adj[2][4] = {};
  float du_acc = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * C, n = min(C, S - t0), buf = ch & 1;
    cp_wait<1>();
    __syncthreads();  // chunk ch is staged; the last chunk's local sums are read
    float s0r[2][4];  // the checkpoint, S_{t0-1}
    {
      const unsigned char* rw = raw + buf * SM::RAW;
      const T* rr = reinterpret_cast<const T*>(rw + SM::R);
      const T* kr = reinterpret_cast<const T*>(rw + SM::K);
      const float* wr = reinterpret_cast<const float*>(rw + SM::W);
      const T* vr = reinterpret_cast<const T*>(rw + SM::V);
      const T* dr_ = reinterpret_cast<const T*>(rw + SM::DO);
      // 16-byte vectors of the raw staging to f32 rows
      constexpr int NV = 16 / sizeof(T);
      auto cvt = [&](float* dst, const T* src) {
        const uint4 q = *reinterpret_cast<const uint4*>(src);
        T e[NV];
        memcpy(e, &q, 16);
#pragma unroll
        for (int m = 0; m < NV; m += 4)
          *reinterpret_cast<float4*>(dst + m) =
              make_float4(to_f32(e[m]), to_f32(e[m + 1]), to_f32(e[m + 2]), to_f32(e[m + 3]));
      };
      for (int idx = tid; idx < n * KB / NV; idx += NT) {
        cvt(r_s + idx * NV, rr + idx * NV);
        cvt(k_s + idx * NV, kr + idx * NV);
      }
      for (int idx = tid; idx < n * KB / 4; idx += NT)
        *reinterpret_cast<float4*>(w_s + 4 * idx) = *reinterpret_cast<const float4*>(wr + 4 * idx);
      for (int idx = tid; idx < n * D / NV; idx += NT) {
        const int c = idx / (D / NV), j = (idx % (D / NV)) * NV;
        cvt(v_s + c * VS + j, vr + c * D + j);
        cvt(do_s + c * VS + j, dr_ + c * D + j);
      }
      const float* ck = reinterpret_cast<const float*>(rw + SM::CK);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 s = ld4(ck + (kk * NT + tid) * 4);
        s0r[kk][0] = s.x;
        s0r[kk][1] = s.y;
        s0r[kk][2] = s.z;
        s0r[kk][3] = s.w;
      }
    }
    __syncthreads();  // the f32 staging is written; this raw buffer is free
    if (ch >= 2) issue(ch - 2);
    cp_commit();
    // sum_i r u k over this block's keys and do . v over all columns: 8
    // lanes a step (lane p: keys 2p, 2p + 1 and columns p, p + 8, ...),
    // then 3 levels of shuffles (whole warps: C * 8 = 128 tasks)
    for (int task = tid; task < C * 8; task += NT) {
      const int c = task >> 3, part = task & 7;
      float sr = 0.f, sd = 0.f;
      if (c < n) {
        sr = fmaf(r_s[c * KB + 2 * part + 1] * u_s[2 * part + 1], k_s[c * KB + 2 * part + 1],
                  r_s[c * KB + 2 * part] * u_s[2 * part] * k_s[c * KB + 2 * part]);
#pragma unroll
        for (int q = 0; q < D / 8; ++q) {
          const int j = part + 8 * q;
          sd = fmaf(do_s[c * VS + j], v_s[c * VS + j], sd);
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        sr += __shfl_xor_sync(FULL, sr, off);
        sd += __shfl_xor_sync(FULL, sd, off);
      }
      if (part == 0 && c < n) {
        rkp[buf * C + c] = sr;
        dov[c] = sd;
      }
    }

    // The chunk's states in two windows of HW steps, so that a window (8
    // steps x 8 values) and not the chunk stays in registers: pass 1
    // replays all C steps from the checkpoint, with dr's sums over j (they
    // need only S), keeps the states of steps HW .. C - 1 and walks them
    // back; pass 2 replays steps 0 .. HW - 1 again and walks them back.
    float win[HW][2][4];
    // step c of the walk, with S_{t0+c-1} in sp and A_{t0+c} in adj: the
    // sums over j of dk and dw over the key group's 4 lanes (lane (b0, b1)
    // ends with quantity b0 of key 2 kg + b1), dv's over i over the warp's
    // 8 key groups (lane (b2, b3) ends with column col + 2 b2 + b3); then
    // adj becomes A_{t0+c-1}
    auto walk_step = [&](int c, const float (&sp)[2][4]) {
      const float2 r2 = ld2(r_s + c * KB + 2 * kg), k2 = ld2(k_s + c * KB + 2 * kg),
                   w2 = ld2(w_s + c * KB + 2 * kg);
      const float4 v4 = ld4(v_s + c * VS + col), d4 = ld4(do_s + c * VS + col);
      const float rr[2] = {r2.x, r2.y}, kk2[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
      float pk[2], pw[2], dvj[4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pk[kk] = adj[kk][0] * vv[0];
        pw[kk] = adj[kk][0] * sp[kk][0];
#pragma unroll
        for (int m = 1; m < 4; ++m) {
          pk[kk] = fmaf(adj[kk][m], vv[m], pk[kk]);
          pw[kk] = fmaf(adj[kk][m], sp[kk][m], pw[kk]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) dvj[m] = fmaf(adj[1][m], kk2[1], adj[0][m] * kk2[0]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) adj[kk][m] = fmaf(ww[kk], adj[kk][m], rr[kk] * dd[m]);
      const float x0 = (b0 ? pw[0] : pk[0]) + __shfl_xor_sync(FULL, b0 ? pk[0] : pw[0], 1);
      const float x1 = (b0 ? pw[1] : pk[1]) + __shfl_xor_sync(FULL, b0 ? pk[1] : pw[1], 1);
      const float y = (b1 ? x1 : x0) + __shfl_xor_sync(FULL, b1 ? x0 : x1, 2);
      jp[(c * 3 + b0) * QS + warp * KB + 2 * kg + b1] = y;
      const float e0 = (b2 ? dvj[2] : dvj[0]) + __shfl_xor_sync(FULL, b2 ? dvj[0] : dvj[2], 4);
      const float e1 = (b2 ? dvj[3] : dvj[1]) + __shfl_xor_sync(FULL, b2 ? dvj[1] : dvj[3], 4);
      float f = (b3 ? e1 : e0) + __shfl_xor_sync(FULL, b3 ? e0 : e1, 8);
      f += __shfl_xor_sync(FULL, f, 16);
      if (!b4) dvp[(buf * C + c) * D + col + 2 * b2 + b3] = f;
    };
    // sp: S_{t0+c-1} -> S_{t0+c}
    auto replay_step = [&](int c, float (&sp)[2][4]) {
      const float2 k2 = ld2(k_s + c * KB + 2 * kg), w2 = ld2(w_s + c * KB + 2 * kg);
      const float4 v4 = ld4(v_s + c * VS + col);
      const float kk2[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) sp[kk][m] = fmaf(ww[kk], sp[kk][m], kk2[kk] * vv[m]);
    };
    auto steps = [&](auto full) {
      constexpr bool F = decltype(full)::value;
      float sp[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) sp[kk][m] = s0r[kk][m];
      // pass 1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (F || c < n) {
          const float4 d4 = ld4(do_s + c * VS + col);
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
          float p[2];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            p[kk] = sp[kk][0] * dd[0];
#pragma unroll
            for (int m = 1; m < 4; ++m) p[kk] = fmaf(sp[kk][m], dd[m], p[kk]);
          }
          // over the key group's 4 lanes: every lane ends with key 2 kg + b0
          float x = (b0 ? p[1] : p[0]) + __shfl_xor_sync(FULL, b0 ? p[0] : p[1], 1);
          x += __shfl_xor_sync(FULL, x, 2);
          if (!b1) jp[(c * 3 + 2) * QS + warp * KB + 2 * kg + b0] = x;
          if (c >= HW) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int m = 0; m < 4; ++m) win[c - HW][kk][m] = sp[kk][m];
          }
          if (c + 1 < C) replay_step(c, sp);
        }
      }
#pragma unroll
      for (int c = C - 1; c >= HW; --c)
        if (F || c < n) walk_step(c, win[c - HW]);
      // pass 2
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) sp[kk][m] = s0r[kk][m];
#pragma unroll
      for (int c = 0; c < HW; ++c) {
        if (F || c < n) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int m = 0; m < 4; ++m) win[c][kk][m] = sp[kk][m];
          if (c + 1 < HW) replay_step(c, sp);
        }
      }
#pragma unroll
      for (int c = HW - 1; c >= 0; --c)
        if (F || c < n) walk_step(c, win[c]);
    };
    if (n == C)  // a whole chunk: no step is guarded, so steps interleave
      steps(std::true_type{});
    else
      steps(std::false_type{});
    __syncthreads();  // this block's sums of chunk ch are written
    cluster_arrive();

    // dk, dw, dr of this block's keys, two a thread: the warps' partials
    // in order
    for (int idx = tid; idx < n * KB / 2; idx += NT) {
      const int c = idx / (KB / 2), il = 2 * (idx % (KB / 2)), i = i0 + il;
      float2 sk = make_float2(0.f, 0.f), sw = sk, sr = sk;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const float2 a = ld2(jp + (c * 3 + 0) * QS + q * KB + il);
        const float2 e = ld2(jp + (c * 3 + 1) * QS + q * KB + il);
        const float2 g = ld2(jp + (c * 3 + 2) * QS + q * KB + il);
        sk.x += a.x;
        sk.y += a.y;
        sw.x += e.x;
        sw.y += e.y;
        sr.x += g.x;
        sr.y += g.y;
      }
      const float2 r2 = ld2(r_s + c * KB + il), k2 = ld2(k_s + c * KB + il),
                   u2 = ld2(u_s + il);
      const long long t = t0 + c;
      st2(dk + b * dks.b + h * dks.h + t * dks.s + i, fmaf(r2.x * u2.x, dov[c], sk.x),
          fmaf(r2.y * u2.y, dov[c], sk.y));
      st2(dw + b * dws.b + h * dws.h + t * dws.s + i, sw.x, sw.y);
      st2(dr + b * drs.b + h * drs.h + t * drs.s + i, fmaf(u2.x * k2.x, dov[c], sr.x),
          fmaf(u2.y * k2.y, dov[c], sr.y));
    }
    if (tid < KB) {  // du of key i0 + tid over the chunk's steps, from the last
#pragma unroll
      for (int c = C - 1; c >= 0; --c)
        if (c < n) du_acc = fmaf(r_s[c * KB + tid] * k_s[c * KB + tid], dov[c], du_acc);
    }
    cluster_wait();  // every block's dv partials of chunk ch are written

    // dv of columns i0 .. i0 + 15, two a thread: the cluster's partials in
    // rank order, every remote load issued before the first store
    float2 sv[NI];
    float rk[NI];
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const int idx = tid + it * NT, c = idx / (KB / 2), jl = 2 * (idx % (KB / 2));
      sv[it] = make_float2(0.f, 0.f);
      rk[it] = 0.f;
      if (c < n) {
#pragma unroll
        for (int p = 0; p < CL; ++p) {
          const float2 a = ld2(cluster.map_shared_rank(dvp, p) + (buf * C + c) * D + i0 + jl);
          sv[it].x += a.x;
          sv[it].y += a.y;
          rk[it] += cluster.map_shared_rank(rkp, p)[buf * C + c];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const int idx = tid + it * NT, c = idx / (KB / 2), jl = 2 * (idx % (KB / 2));
      if (c < n) {
        const float2 d2 = ld2(do_s + c * VS + i0 + jl);
        st2(dv + b * dvs.b + h * dvs.h + (t0 + c) * dvs.s + i0 + jl,
            fmaf(rk[it], d2.x, sv[it].x), fmaf(rk[it], d2.y, sv[it].y));
      }
    }
  }
  if (tid < KB) du_part[bh * D + i0 + tid] = du_acc;
  cluster.sync();  // no block leaves while another reads its shared memory
}

// du[h][i] = sum over batches b, in order, of du_part[b][h][i]
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B,
                          int HD) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<long long>(b) * HD + x];
  du[x] = s;
}

struct Args {
  const void *r, *k, *v, *w, *dout;
  const float *u, *s0;
  void *dr, *dk, *dv;
  float *dw, *du_part, *du, *ckpt;
  Strides rs, ks, vs, ws, dos, drs, dks, dvs, dws;
  int B, H, S;
  cudaStream_t stream;
};

bool aligned16(const void* p, const Strides& s, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * elem) % 16 == 0 &&
         (s.h * elem) % 16 == 0 && (s.s * elem) % 16 == 0;
}

// outputs are stored two elements at a time
bool paired(const void* p, const Strides& s, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % (2 * elem) == 0 && s.b % 2 == 0 && s.h % 2 == 0 &&
         s.s % 2 == 0;
}

template <int D, typename T>
cudaError_t launch_typed(const Args& a) {
  using P = Plan<D>;
  using SM = Smem<D, T>;
  if (!aligned16(a.r, a.rs, sizeof(T)) || !aligned16(a.k, a.ks, sizeof(T)) ||
      !aligned16(a.v, a.vs, sizeof(T)) || !aligned16(a.w, a.ws, 4) ||
      !aligned16(a.dout, a.dos, sizeof(T)) || reinterpret_cast<uintptr_t>(a.s0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.ckpt) % 16 != 0 || !paired(a.dr, a.drs, sizeof(T)) ||
      !paired(a.dk, a.dks, sizeof(T)) || !paired(a.dv, a.dvs, sizeof(T)) ||
      !paired(a.dw, a.dws, 4))
    return cudaErrorInvalidValue;
  const T* rt = static_cast<const T*>(a.r);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const float* wt = static_cast<const float*>(a.w);
  const T* dt = static_cast<const T*>(a.dout);
  const dim3 grid(P::CL, a.H, a.B);

  auto ck = wkv6_ckpt_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(ck, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       2 * SM::CK_BUF);
  if (e != cudaSuccess) return e;
  ck<<<grid, P::T, 2 * SM::CK_BUF, a.stream>>>(kt, vt, wt, a.s0, a.ckpt, a.ks, a.vs, a.ws, a.H,
                                                a.S);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto kern = wkv6_bwd_kernel<D, T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(P::T);
  cfg.dynamicSmemBytes = SM::BYTES;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, rt, kt, vt, wt, dt, a.u,
                         static_cast<const float*>(a.ckpt), static_cast<T*>(a.dr),
                         static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dw, a.du_part, a.rs,
                         a.ks, a.vs, a.ws, a.dos, a.drs, a.dks, a.dvs, a.dws, a.H, a.S);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int HD = a.H * D;
  du_kernel<<<(HD + 255) / 256, 256, 0, a.stream>>>(a.du_part, a.du, a.B, HD);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int x_dtype, const Args& a) {
  if (x_dtype == 0) return launch_typed<D, float>(a);
  if (x_dtype == 1) return launch_typed<D, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16, that of r, k, v, dout, dr, dk and dv.
// w and dw: float32; u: float32 (H, D) contiguous; s0: float32 (B, H, D, D)
// contiguous.  r, k, v, w, dout, dr, dk, dv, dw: (B, H, S, D) by their
// (batch, head, seq) strides in elements, the last dim contiguous; r, k,
// v, w and dout with 16-byte aligned rows, dr, dk, dv and dw with even
// strides and pointers aligned to two elements.  cluster: the blocks of a (batch,
// head), D / 16 (the plan the wrapper computed; anything else is refused).
// du_part: (B, H, D) float32 scratch; du: (H, D) float32 out; ckpt:
// B * H * ceil(S / 16) * D * D float32 scratch.  Returns the launches'
// cudaError_t (0 on success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* dout, const float* u, const float* s0, void* dr,
                              void* dk, void* dv, float* dw, float* du_part, float* du,
                              float* ckpt, int x_dtype, int B, int H, int S, int D, int cluster,
                              long long r_sb, long long r_sh, long long r_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long w_sb, long long w_sh, long long w_ss,
                              long long do_sb, long long do_sh, long long do_ss,
                              long long dr_sb, long long dr_sh, long long dr_ss,
                              long long dk_sb, long long dk_sh, long long dk_ss,
                              long long dv_sb, long long dv_sh, long long dv_ss,
                              long long dw_sb, long long dw_sh, long long dw_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 || D % KB != 0 ||
      cluster != D / KB)
    return int(cudaErrorInvalidValue);
  const Args a{r, k, v, w, dout, u, s0, dr, dk, dv, static_cast<float*>(dw), du_part, du, ckpt,
               {r_sb, r_sh, r_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {w_sb, w_sh, w_ss}, {do_sb, do_sh, do_ss}, {dr_sb, dr_sh, dr_ss},
               {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss}, {dw_sb, dw_sh, dw_ss}, B, H, S,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return int(launch<16>(x_dtype, a));
    case 32: return int(launch<32>(x_dtype, a));
    case 64: return int(launch<64>(x_dtype, a));
    case 128: return int(launch<128>(x_dtype, a));
    default: return int(cudaErrorInvalidValue);
  }
}
