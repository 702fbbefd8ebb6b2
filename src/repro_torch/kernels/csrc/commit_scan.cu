// The sequential greedy commit of the Hadar decision path for Hopper
// (sm_90a): kernel K5, float64.
//
// Replaces the JAX kernel `_build_commit_kernel` / `scan_fn` / `step` in
// src/repro/core/batch_solver.py (:798-974, a lax.scan with a (free, gamma)
// carry).  For B jobs in commit order, each step runs a full FIND_ALLOC for
// one job at the carried state and commits its winner into the carry before
// the next step:
//   consolidated slots as in find_alloc.cu, with each key's packed cost the
//     sequential sum of Eq. 5 prices gathered from the host table
//     P_tab[m, gamma_m + i] (gamma is integer on this path, so the gathers
//     are bitwise the oracle's unit prices at every step);
//   spread slots over the job's fixed pool order (sorted once on the host;
//     the order does not depend on gamma), masked to the window
//     gamma_m <= u < gamma_m + free_m: the first W eligible units per
//     preference prefix, their cost in NumPy's order, slowest rank, distinct
//     servers and communication penalty;
//   selection in the reference enumeration order (per prefix: node slots,
//     then the spread slot; first maximum wins) with the mu_j > 0 gate, and
//     the runner-up;
//   the commit: the winner's units per key leave free and join gamma.
// Outputs are those of ref.commit_scan_ref, bitwise.
//
// Design.  A CUDA grid has no order, so the scan is ONE block (256 threads)
// looping over the jobs, with the carry (free, gamma) in shared memory for
// the whole launch; each step's FIND_ALLOC is spread over the block (a
// thread per key or node row, a warp per spread prefix walking the pool 32
// units at a time and stopping at the W-th eligible unit) between barriers,
// and the argmax is a block reduction that keeps the first maximum.  Rows
// with no usable type (the padding of the job bucket) are skipped.  Shared
// memory is sized from the runtime M, N, R and wmax.
//
// Bound.  The function reads the state and tables once and, per step, the
// job's rows and the prefix of its pool that the W-th eligible unit ends
// (data-dependent; chip_smoke.py counts it with the plain version), and
// writes (B, M) counts: it is bound by bytes, a few microseconds at
// 3.35 TB/s.  One block walking the steps in order, with some ten barriers
// and a dependent pool walk per step, is latency-bound far above that.
#include "sched_common.cuh"

namespace {

using sched::kThreads;
using sched::kWarps;

struct Args {
  const double* free0;     // (M) the carry before the first job
  const int* gamma0;       // (M)
  const double* P_tab;     // (M, C)
  const int* node_row;     // (M)
  const double* W;         // (B)
  const int* Kj;           // (B)
  const uint8_t* single;   // (B)
  const int* rank;         // (B, M)
  const double* u_tab;     // (B, R)
  const int* s_m;          // (B, L)
  const int* s_u;          // (B, L)
  const int* s_rank;       // (B, L)
  const double* s_price;   // (B, L)
  const int* s_node;       // (B, L)
  double* free;            // (M) the carry after the last job
  int* gamma;              // (M)
  uint8_t* won;            // (B)
  int* win;                // (B)
  int* counts;             // (B, M)
  int* win2;               // (B)
  double* win2_pay;        // (B)
  int* sp_nserv;           // (B, R)
  int B, M, N, R, C, L, wmax;
  double comm_frac;
};

// Shared memory: doubles first, then ints, then bytes.
struct Smem {
  double *free_s, *cell, *take_s, *pp, *sp_pay, *ch_price, *red_val;
  int *gamma_s, *tkey, *kf, *jl, *nch, *ch_key, *ch_rank, *ch_node, *red_idx;
  uint8_t *feas, *sp_ok;
};

// Carves the shared memory at `base` (nullptr: just sizes it); returns bytes.
__host__ __device__ size_t smem_layout(int M, int N, int R, int wmax, unsigned char* base,
                                       Smem* s) {
  size_t off = 0;
  auto dbl = [&](size_t n) {
    double* p = reinterpret_cast<double*>(base + off);
    off += n * sizeof(double);
    return p;
  };
  auto in = [&](size_t n) {
    int* p = reinterpret_cast<int*>(base + off);
    off += n * sizeof(int);
    return p;
  };
  s->free_s = dbl(M);
  s->cell = dbl(static_cast<size_t>(N) * R);
  s->take_s = dbl(static_cast<size_t>(N) * R);
  s->pp = dbl(N);
  s->sp_pay = dbl(R);
  s->ch_price = dbl(static_cast<size_t>(R) * wmax);
  s->red_val = dbl(2 * kWarps + 2);
  s->gamma_s = in(M);
  s->tkey = in(M);
  s->kf = in(N);
  s->jl = in(N);
  s->nch = in(R);
  s->ch_key = in(static_cast<size_t>(R) * wmax);
  s->ch_rank = in(static_cast<size_t>(R) * wmax);
  s->ch_node = in(static_cast<size_t>(R) * wmax);
  s->red_idx = in(2 * kWarps + 2);
  s->feas = base + off;
  off += N;
  s->sp_ok = base + off;
  off += R;
  return off;
}

// (val, idx) order of the reference argmax: larger value first, then the
// smaller index (numpy/jnp argmax keep the first maximum).
__device__ __forceinline__ bool better(double v, int i, double w, int j) {
  return v > w || (v == w && i < j);
}

// Top two (val, idx) pairs of the block under `better`; every thread gets
// them in (v1, i1) and (v2, i2).
__device__ void block_top2(double& v1, int& i1, double& v2, int& i2, const Smem& s) {
  for (int off = 16; off > 0; off /= 2) {
    const double ov1 = __shfl_down_sync(0xffffffffu, v1, off);
    const int oi1 = __shfl_down_sync(0xffffffffu, i1, off);
    const double ov2 = __shfl_down_sync(0xffffffffu, v2, off);
    const int oi2 = __shfl_down_sync(0xffffffffu, i2, off);
    if (better(ov1, oi1, v1, i1)) {
      if (better(v1, i1, ov2, oi2)) { v2 = v1; i2 = i1; } else { v2 = ov2; i2 = oi2; }
      v1 = ov1;
      i1 = oi1;
    } else if (better(ov1, oi1, v2, i2)) {
      v2 = ov1;
      i2 = oi1;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s.red_val[2 * warp] = v1;
    s.red_idx[2 * warp] = i1;
    s.red_val[2 * warp + 1] = v2;
    s.red_idx[2 * warp + 1] = i2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const double ov1 = s.red_val[2 * w], ov2 = s.red_val[2 * w + 1];
      const int oi1 = s.red_idx[2 * w], oi2 = s.red_idx[2 * w + 1];
      if (better(ov1, oi1, v1, i1)) {
        if (better(v1, i1, ov2, oi2)) { v2 = v1; i2 = i1; } else { v2 = ov2; i2 = oi2; }
        v1 = ov1;
        i1 = oi1;
      } else if (better(ov1, oi1, v2, i2)) {
        v2 = ov1;
        i2 = oi1;
      }
    }
    s.red_val[2 * kWarps] = v1;
    s.red_idx[2 * kWarps] = i1;
    s.red_val[2 * kWarps + 1] = v2;
    s.red_idx[2 * kWarps + 1] = i2;
  }
  __syncthreads();
  v1 = s.red_val[2 * kWarps];
  i1 = s.red_idx[2 * kWarps];
  v2 = s.red_val[2 * kWarps + 1];
  i2 = s.red_idx[2 * kWarps + 1];
}

__global__ void __launch_bounds__(kThreads) commit_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.M, N = a.N, R = a.R, C = a.C, L = a.L, wmax = a.wmax;
  Smem s;
  smem_layout(M, N, R, wmax, smem, &s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const double NEG_INF = -CUDART_INF;

  for (int m = threadIdx.x; m < M; m += kThreads) {
    s.free_s[m] = a.free0[m];
    s.gamma_s[m] = a.gamma0[m];
  }
  for (int i = threadIdx.x; i < N * R; i += kThreads) s.cell[i] = 0.0;
  __syncthreads();

  for (int p = 0; p < a.B; ++p) {
    const double W = a.W[p];
    const int Wi = static_cast<int>(W);
    const int kj = a.Kj[p];
    const int* rank = a.rank + static_cast<size_t>(p) * M;
    const double* u = a.u_tab + static_cast<size_t>(p) * R;
    int* counts = a.counts + static_cast<size_t>(p) * M;
    if (kj == 0) {  // no usable type: no candidate, nothing committed
      for (int m = threadIdx.x; m < M; m += kThreads) counts[m] = 0;
      for (int k = threadIdx.x; k < R; k += kThreads)
        a.sp_nserv[static_cast<size_t>(p) * R + k] = 0;
      if (threadIdx.x == 0) {
        a.won[p] = 0;
        a.win[p] = 0;
        a.win2[p] = 0;
        a.win2_pay[p] = NEG_INF;
      }
      continue;
    }

    // ---- consolidated slots at the carried state ------------------------
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const int r = rank[m];
      if (r < kj) s.cell[a.node_row[m] * R + r] = s.free_s[m];
    }
    __syncthreads();
    for (int h = threadIdx.x; h < N; h += kThreads) {
      int kf, jl;
      s.feas[h] = sched::consolidate(s.cell + h * R, R, W, s.take_s + h * R, &kf, &jl);
      s.kf[h] = kf;
      s.jl[h] = jl;
      for (int k = 0; k < R; ++k) s.cell[h * R + k] = 0.0;  // row h is this thread's
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const int r = rank[m];
      int t = 0;
      if (r < kj) {
        const int h = a.node_row[m];
        t = static_cast<int>(s.take_s[h * R + r]);
        double v = 0.0;  // unit by unit, as NumPy's cumsum
        const double* prow = a.P_tab + static_cast<size_t>(m) * C;
        for (int i = 0; i < t; ++i) v = __dadd_rn(v, prow[min(s.gamma_s[m] + i, C - 1)]);
        s.cell[h * R + r] = v;
      }
      s.tkey[m] = t;
    }
    __syncthreads();
    for (int h = threadIdx.x; h < N; h += kThreads) {
      s.pp[h] = __dsub_rn(u[s.jl[h]], sched::numpy_sum(s.cell + h * R, kj < R ? kj : R));
      for (int k = 0; k < R; ++k) s.cell[h * R + k] = 0.0;
    }

    // ---- spread slots: one warp per preference prefix --------------------
    const size_t row = static_cast<size_t>(p) * L;
    for (int k = warp + 1; k <= R; k += kWarps) {
      double* ch_price = s.ch_price + (k - 1) * wmax;
      int* ch_key = s.ch_key + (k - 1) * wmax;
      int* ch_rank = s.ch_rank + (k - 1) * wmax;
      int* ch_node = s.ch_node + (k - 1) * wmax;
      int found = 0;
      for (int p0 = 0; p0 < L && found < Wi; p0 += 32) {
        const int q = p0 + lane;
        bool e = false;
        if (q < L) {
          const int m = a.s_m[row + q];
          const int lo = s.gamma_s[m];
          const int uu = a.s_u[row + q];
          e = uu >= lo && static_cast<double>(uu - lo) < s.free_s[m] && a.s_rank[row + q] < k;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, e);
        const int before = found + __popc(mask & ((1u << lane) - 1u));
        if (e && before < Wi) {
          ch_price[before] = a.s_price[row + q];
          ch_key[before] = a.s_m[row + q];
          ch_rank[before] = a.s_rank[row + q];
          ch_node[before] = a.s_node[row + q];
        }
        found += __popc(mask);
      }
      __syncwarp();
      if (lane == 0) {
        const int n = found < Wi ? found : Wi;
        int jmax = -1;
        for (int i = 0; i < n; ++i) jmax = max(jmax, ch_rank[i]);
        const int nserv = sched::n_distinct(ch_node, n);
        const double u_jmax = u[jmax > 0 ? jmax : 0];
        const double cost = sched::with_comm(sched::numpy_sum(ch_price, n), nserv, u_jmax,
                                             a.comm_frac);
        s.nch[k - 1] = n;
        s.sp_ok[k - 1] = found >= Wi && !a.single[p] && k <= kj;
        s.sp_pay[k - 1] = __dsub_rn(u_jmax, cost);
        a.sp_nserv[static_cast<size_t>(p) * R + (k - 1)] = nserv;
      }
    }
    __syncthreads();

    // ---- selection: reference enumeration order, first maximum ----------
    double v1 = NEG_INF, v2 = NEG_INF;
    int i1 = 0x7fffffff, i2 = 0x7fffffff;
    for (int c = threadIdx.x; c < R * (N + 1); c += kThreads) {
      const int k = c / (N + 1), h = c % (N + 1);
      const double v = h < N ? (s.feas[h] && s.kf[h] == k ? s.pp[h] : NEG_INF)
                             : (s.sp_ok[k] ? s.sp_pay[k] : NEG_INF);
      if (better(v, c, v1, i1)) {
        v2 = v1;
        i2 = i1;
        v1 = v;
        i1 = c;
      } else if (better(v, c, v2, i2)) {
        v2 = v;
        i2 = c;
      }
    }
    block_top2(v1, i1, v2, i2, s);
    const bool ok = v1 > 0.0;  // the mu_j > 0 gate
    const int slot = i1 % (N + 1), ksel = i1 / (N + 1);
    if (threadIdx.x == 0) {
      a.won[p] = ok;
      a.win[p] = i1;
      // runner-up: the argmax with the winner set to -inf, which is the
      // first index (0) when every other candidate is -inf
      a.win2[p] = v2 == NEG_INF ? 0 : i2;
      a.win2_pay[p] = v2;
    }

    // ---- commit into the carry -------------------------------------------
    for (int m = threadIdx.x; m < M; m += kThreads) {
      int cnt = 0;
      if (ok && slot < N) {
        cnt = a.node_row[m] == slot ? s.tkey[m] : 0;
      } else if (ok) {
        const int* ck = s.ch_key + ksel * wmax;
        for (int i = 0; i < s.nch[ksel]; ++i) cnt += ck[i] == m;
      }
      counts[m] = cnt;
      s.free_s[m] = __dsub_rn(s.free_s[m], static_cast<double>(cnt));
      s.gamma_s[m] += cnt;
    }
    __syncthreads();
  }
  for (int m = threadIdx.x; m < M; m += kThreads) {
    a.free[m] = s.free_s[m];
    a.gamma[m] = s.gamma_s[m];
  }
}

}  // namespace

// Shapes as ref.commit_scan_ref: free0 and gamma0 hold the initial carry
// (read only, so a launch can be repeated), free and gamma receive the final
// one.  Bool arrays are one byte each.  Returns the launch's cudaError_t (0
// on success), or -1 when M, N, R and wmax need more shared memory than a
// block has.
extern "C" int commit_scan_fwd(const void* free0, const void* gamma0, const void* P_tab,
                               const void* node_row, const void* W, const void* Kj,
                               const void* single, const void* rank, const void* u_tab,
                               const void* s_m, const void* s_u, const void* s_rank,
                               const void* s_price, const void* s_node, void* free, void* gamma,
                               void* won, void* win, void* counts, void* win2, void* win2_pay,
                               void* sp_nserv, int B, int M, int N, int R, int C, int L,
                               int wmax, double comm_frac, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || R <= 0 || C <= 0 || L < 0 || wmax <= 0 || wmax > 128)
    return int(cudaErrorInvalidValue);
  Smem layout;
  const size_t smem = smem_layout(M, N, R, wmax, nullptr, &layout);
  if (smem > sched::kSmemMax) return sched::kSmemExceeded;
  cudaError_t err = cudaFuncSetAttribute(commit_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return int(err);
  const Args a{static_cast<const double*>(free0), static_cast<const int*>(gamma0),
               static_cast<const double*>(P_tab), static_cast<const int*>(node_row),
               static_cast<const double*>(W), static_cast<const int*>(Kj),
               static_cast<const uint8_t*>(single), static_cast<const int*>(rank),
               static_cast<const double*>(u_tab), static_cast<const int*>(s_m),
               static_cast<const int*>(s_u), static_cast<const int*>(s_rank),
               static_cast<const double*>(s_price), static_cast<const int*>(s_node),
               static_cast<double*>(free), static_cast<int*>(gamma), static_cast<uint8_t*>(won), static_cast<int*>(win), static_cast<int*>(counts),
               static_cast<int*>(win2), static_cast<double*>(win2_pay),
               static_cast<int*>(sp_nserv), B, M, N, R, C, L, wmax, comm_frac};
  commit_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
