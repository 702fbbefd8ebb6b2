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
// the model's decay exp(-exp(x)) reaches exactly 0 in f32.  So the kernel
// replays the forward and checkpoints the state every C = 16 steps into a
// (B, H, ceil(S/C), D, D) f32 buffer (268 MB at the rwkv6-7b train shape
// B=4, H=64, S=1024, D=64), then walks the chunks in reverse: it re-derives
// the chunk's C states from its checkpoint into a (B, H, C, D, D) f32
// scratch and steps back through them.
//
// Design (a simple first form).  A block per (batch, head); thread
// (i, g) owns key row i and the JC = min(D, 32) value columns of group g
// (D / JC groups: 64 threads at D = 16 and 32, 128 at D = 64, 512 at
// D = 128), with its slices of S and A in registers.  So the sums over j
// (dk, dw, dr) are a thread's own plus one add across its row's groups, and
// only dv's sum over i crosses threads: each thread stores its A[i,j] k[i]
// into a D x (D+1) shared tile and thread j adds column j in order of i.
// A thread writes and reads back only its own slices of the checkpoint and
// chunk scratch (laid out thread-fastest, so the accesses coalesce).  A
// chunk's r, k, v, w and dO are staged in shared memory as f32.  du is
// summed per (batch, head) over the sequence in order, then over the batch
// by a second kernel.  Every output is summed in a fixed order: the result
// is bitwise the same from run to run.  Inputs are read, and dr, dk, dv, dw
// written, through (batch, head, seq) strides with the head dim contiguous.
//
// Bound.  The least work is the forward's recurrence once and the adjoint
// recurrence once, 14 D^2 f32 operations per (b, h, t): the replayed
// state (k v and the decayed update, 3), the adjoint's update (3) and four
// sums over the D x D state, dk, dw, dr and dv (2 each); 15.0 GFLOP at
// B=4, H=64, S=1024, D=64, 0.224 ms at 67 TFLOP/s of f32 CUDA cores.  Its
// bytes: r, k, v, dO read and dr, dk, dv written (7 x 33.6 MB in bf16), w
// read and dw written (2 x 67.1 MB in f32), S_0 (4.2 MB), 373 MB, 0.111 ms
// at 3.35 TB/s: bound by operations.  This form also replays the state
// twice (once to checkpoint, once per chunk) and moves the checkpoints and
// chunk states through L2 and device memory; measured on an H100 it runs
// at ~17x that bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 16;  // steps a chunk

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

template <int D>
struct Plan {
  static constexpr int JC = D < 32 ? D : 32;  // value columns a thread
  static constexpr int NJ = D / JC;           // column groups
  static constexpr int NT = D * NJ;           // threads a block
  // shared floats: r, k, w, v, dO [C][D]; the dv tile [D][D+1]; the
  // row sums [3][NJ][D]; do.v and sum r u k [C] each
  static constexpr int SMEM = (5 * C * D + D * (D + 1) + 3 * NJ * D + 2 * C) * 4;
};

struct Args {
  const void *r, *k, *v, *w, *dout;
  const float *u, *s0;
  void *dr, *dk, *dv;
  float *dw, *du_part, *du, *ckpt, *scratch;
  Strides rs, ks, vs, ws, dos, drs, dks, dvs, dws;
  int B, H, S;
  cudaStream_t stream;
};

// steps t0 .. t0 + n - 1 of one input into dst [C][D] as f32
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, const T* base, long long ss, int t0, int n) {
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int c = idx / D, d = idx % D;
    dst[c * D + d] = to_f32(base[(t0 + c) * ss + d]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(Plan<D>::NT)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ dout,
                const float* __restrict__ u, const float* __restrict__ s0, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ckpt,
                float* __restrict__ scratch, Strides rs, Strides ks, Strides vs, Strides ws,
                Strides dos, Strides drs, Strides dks, Strides dvs, Strides dws, int H, int S) {
  using P = Plan<D>;
  constexpr int JC = P::JC, NJ = P::NJ, NT = P::NT;
  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + C * D;
  float* w_s = k_s + C * D;
  float* v_s = w_s + C * D;
  float* do_s = v_s + C * D;
  float* red = do_s + C * D;          // [D][D+1]: A[i,j] k[i]
  float* rk = red + D * (D + 1);      // [NJ][D] row sums: dk
  float* rw = rk + NJ * D;            // dw
  float* rr = rw + NJ * D;            // dr
  float* dov = rr + NJ * D;           // [C] do_t . v_t
  float* rku = dov + C;               // [C] sum_i r u k

  const int tid = threadIdx.x;
  const int i = tid % D, g = tid / D, j0 = g * JC;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long bh = blockIdx.x;
  const int nch = (S + C - 1) / C;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h;
  const T* db = dout + b * dos.b + h * dos.h;
  // a thread's slices: element cc of state n at [(n * JC + cc) * NT + tid]
  float* ck = ckpt + bh * nch * JC * NT * 1LL;
  float* scr = scratch + bh * C * JC * NT * 1LL;
  const float ui = u[h * D + i];

  // A. replay the forward, checkpointing the state before each chunk
  float st[JC];
#pragma unroll
  for (int cc = 0; cc < JC; ++cc) st[cc] = s0[(bh * D + i) * D + j0 + cc];
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * C, n = min(C, S - t0);
#pragma unroll
    for (int cc = 0; cc < JC; ++cc) ck[(static_cast<long long>(ch) * JC + cc) * NT + tid] = st[cc];
    __syncthreads();  // the previous chunk's staging is no longer read
    stage<T, D, NT>(k_s, kb, ks.s, t0, n);
    stage<float, D, NT>(w_s, wb, ws.s, t0, n);
    stage<T, D, NT>(v_s, vb, vs.s, t0, n);
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float wi = w_s[c * D + i], ki = k_s[c * D + i];
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) st[cc] = fmaf(wi, st[cc], ki * v_s[c * D + j0 + cc]);
    }
  }

  // B. the chunks in reverse
  float adj[JC];
#pragma unroll
  for (int cc = 0; cc < JC; ++cc) adj[cc] = 0.f;
  float du_acc = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * C, n = min(C, S - t0);
    __syncthreads();  // the previous chunk's staging is no longer read
    stage<T, D, NT>(r_s, rb, rs.s, t0, n);
    stage<T, D, NT>(k_s, kb, ks.s, t0, n);
    stage<float, D, NT>(w_s, wb, ws.s, t0, n);
    stage<T, D, NT>(v_s, vb, vs.s, t0, n);
    stage<T, D, NT>(do_s, db, dos.s, t0, n);
    __syncthreads();
    for (int idx = tid; idx < 2 * C; idx += NT) {
      const int c = idx % C;
      if (c >= n) continue;
      float acc = 0.f;
      if (idx < C) {
        for (int d = 0; d < D; ++d) acc = fmaf(do_s[c * D + d], v_s[c * D + d], acc);
        dov[c] = acc;
      } else {
        for (int d = 0; d < D; ++d) acc = fmaf(r_s[c * D + d] * u[h * D + d], k_s[c * D + d], acc);
        rku[c] = acc;
      }
    }
    // re-derive the chunk's states S_{t0-1} .. S_{t0+n-2} into the scratch
#pragma unroll
    for (int cc = 0; cc < JC; ++cc) st[cc] = ck[(static_cast<long long>(ch) * JC + cc) * NT + tid];
    for (int c = 0; c < n; ++c) {
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) scr[(c * JC + cc) * NT + tid] = st[cc];
      const float wi = w_s[c * D + i], ki = k_s[c * D + i];
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) st[cc] = fmaf(wi, st[cc], ki * v_s[c * D + j0 + cc]);
    }
    __syncthreads();  // dov and rku are written
    for (int c = n - 1; c >= 0; --c) {
      const long long t = t0 + c;
      const float wi = w_s[c * D + i], ki = k_s[c * D + i], ri = r_s[c * D + i];
      float pk = 0.f, pw = 0.f, pr = 0.f;
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) {
        const float sp = scr[(c * JC + cc) * NT + tid];
        const float vj = v_s[c * D + j0 + cc], dj = do_s[c * D + j0 + cc];
        pk = fmaf(adj[cc], vj, pk);
        pw = fmaf(adj[cc], sp, pw);
        pr = fmaf(sp, dj, pr);
        red[i * (D + 1) + j0 + cc] = adj[cc] * ki;
      }
      rk[g * D + i] = pk;
      rw[g * D + i] = pw;
      rr[g * D + i] = pr;
      __syncthreads();
      if (tid < D) {  // column j = tid of dv, and row i = tid of dk, dw, dr
        float sv = 0.f;
        for (int ii = 0; ii < D; ++ii) sv += red[ii * (D + 1) + tid];
        sv = fmaf(rku[c], do_s[c * D + tid], sv);
        dv[b * dvs.b + h * dvs.h + t * dvs.s + tid] = from_f32<T>(sv);
        float sk = 0.f, sw = 0.f, sr = 0.f;
        for (int gg = 0; gg < NJ; ++gg) {
          sk += rk[gg * D + i];
          sw += rw[gg * D + i];
          sr += rr[gg * D + i];
        }
        const float d = dov[c];
        dk[b * dks.b + h * dks.h + t * dks.s + i] = from_f32<T>(fmaf(ri * ui, d, sk));
        dw[b * dws.b + h * dws.h + t * dws.s + i] = sw;
        dr[b * drs.b + h * drs.h + t * drs.s + i] = from_f32<T>(fmaf(ui * ki, d, sr));
        du_acc = fmaf(ri * ki, d, du_acc);
      }
      __syncthreads();  // red and the row sums are read
#pragma unroll
      for (int cc = 0; cc < JC; ++cc) adj[cc] = fmaf(wi, adj[cc], ri * do_s[c * D + j0 + cc]);
    }
  }
  if (tid < D) du_part[bh * D + i] = du_acc;
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

template <int D, typename T>
cudaError_t launch_typed(const Args& a) {
  using P = Plan<D>;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_kernel<D, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return e;
  wkv6_bwd_kernel<D, T><<<a.B * a.H, P::NT, P::SMEM, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const T*>(a.dout), a.u, a.s0,
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dw, a.du_part,
      a.ckpt, a.scratch, a.rs, a.ks, a.vs, a.ws, a.dos, a.drs, a.dks, a.dvs, a.dws, a.H, a.S);
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
// (batch, head, seq) strides in elements, the last dim contiguous.
// du_part: (B, H, D) float32 scratch; du: (H, D) float32 out; ckpt:
// B * H * ceil(S / 16) * D * D float32 scratch; scratch: B * H * 16 * D * D
// float32.  Returns the launches' cudaError_t (0 on success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* dout, const float* u, const float* s0, void* dr,
                              void* dk, void* dv, float* dw, float* du_part, float* du,
                              float* ckpt, float* scratch, int x_dtype, int B, int H, int S,
                              int D, long long r_sb, long long r_sh, long long r_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long w_sb, long long w_sh, long long w_ss,
                              long long do_sb, long long do_sh, long long do_ss,
                              long long dr_sb, long long dr_sh, long long dr_ss,
                              long long dk_sb, long long dk_sh, long long dk_ss,
                              long long dv_sb, long long dv_sh, long long dv_ss,
                              long long dw_sb, long long dw_sh, long long dw_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const Args a{r, k, v, w, dout, u, s0, dr, dk, dv, static_cast<float*>(dw), du_part, du, ckpt,
               scratch, {r_sb, r_sh, r_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
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
