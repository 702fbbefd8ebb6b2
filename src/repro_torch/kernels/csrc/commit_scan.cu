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
// Outputs are those of ref.commit_scan_ref, bitwise, on tables as
// core/batch_solver.py::scan_tables builds them: each job's pool is its
// whole (key, unit) table (every u in [0, C) of every key once), with
// s_rank = rank[s_m] and s_node = node_row[s_m], and a (node row, rank) cell
// holds at most one key.
//
// Design.  A CUDA grid has no order, so the scan is ONE block (256 threads)
// looping over the jobs, with the carry (free, gamma) in shared memory for
// the whole launch and every sum in NumPy's order with fma contraction
// blocked (sched_common.cuh).  A step is a chain of phases between barriers,
// each a few hundred dependent instructions in the slowest thread; the
// design walks less of the pool and shortens the chain.
// 1. Count before walking.  A key's pool entries inside its window number
//    max(0, min(C, gamma + ceil(free)) - max(gamma, 0)) (`window_units`;
//    exact for a fractional free), so the pass over the keys gives each
//    prefix's eligible units and, as bits per rank, the node rows that hold
//    them.  A prefix with fewer than W eligible units would take them all:
//    it is not walked (n = its count, its servers the distinct node rows,
//    not a candidate).  Only the prefixes from the first whose count reaches
//    W are walked: at fig5 n=2048, 560 of 2048 steps walk at all (grown),
//    354 (bursty); the parent walked every prefix of every step, most of
//    them to the pool's end.
// 2. Walk with the whole block.  A chunk of 256 entries is one entry a
//    thread, for all walked prefixes at once: a ballot per prefix, the
//    warps' counts in shared memory, one barrier, then each eligible entry's
//    place in pool order (earlier chunks, earlier warps, earlier lanes); the
//    first W are the prefix's chosen units.  The walk stops after the chunk
//    in which the first walked prefix (the one with the fewest eligible
//    units) reached W.  A warp per prefix then finishes it: slowest rank and
//    distinct servers over the lanes, the cost summed by one lane in
//    NumPy's order.
// 3. A shorter step.  Each key works out its own take from its node row's
//    rank-prefix sums (as sched::consolidate does) beside the node rows'
//    flags, so costs do not wait for a node's whole row; the packed payoff
//    is formed in the selection pass; selection offers one slot a node row
//    (its first feasible prefix) and one a prefix, with no division; the
//    block's top two is a butterfly in the lanes; the next job's W, Kj,
//    single, utilities and each thread's first rank are loaded a step
//    ahead.
// 4. A step with no candidate.  Where no prefix reaches W and the usable
//    keys hold fewer than W units (their ceil(free) summed in the same
//    pass), no node row is feasible either: after the first barrier the
//    step finishes its prefixes from the counts, clears its rows and ends.
//    At fig5 n=2048 that is 1488 of 2048 steps (grown), 1694 (bursty).
//    Where such a step finds no key with a free unit at all, the carry can
//    never change again: the later steps' outputs are those of a step
//    without a candidate, and are written at once, up to the first job
//    whose gang is below one unit (steps 1645.. at grown, 373.. at bursty).
// Barriers a step: 7 in the parent; here 2 for a step with no candidate, 3
// for one that walks nothing (after the key scatter, after the node rows and
// keys, in the top two; the commit needs none, as each thread commits the
// keys it reads next) and 5 for one that walks, plus one for each pool
// chunk past the first.  The counts are kept twice, by the parity of the
// counted steps, so that a step clears the other's without a barrier.
// Staging each job's rows ahead of its step with cp.async (the rank row, the
// utilities and up to six pool chunks into two buffers, 16-byte copies) was
// built and measured, and dropped: it did not lower the time by 5% at both
// fig5 shapes (below).
//
// Shared memory: the parent's arrays, with its (N, R) takes replaced by the
// keys' (N, R) costs and without its (N) packed payoffs and 24 bytes of its
// reduction, plus the count's (R doubles, 2 R (1 + ceil(N/32)) + 5 ints) and
// the block walk's (2R ints, 16R bytes):
//   this layout - the parent's = 40 R + 8 R ceil(N/32) - 8 N - 4 bytes,
// whatever M, L and wmax.  It is no larger for N >= 6, 12, 18, 24 at
// R = 1, 2, 3, 4; below those N, a key per (node row, rank) cell (M <= N R)
// keeps both far under the limit.  So for R <= 19 it refuses no shape the
// parent took (SMEM_EXCEEDED only from M, N, R and wmax, nothing grows with
// L; checked over every N < 20000, wmax <= 128, M <= N R); from R = 20 types
// on, a shape that the parent's layout fits by less than that difference is
// refused.
//
// Bound.  The function reads the state and tables once and, per step, the
// job's rows and the prefix of its pool that its longest walk ends (data-
// dependent; chip_smoke.py counts it with the plain version, counting no
// read for a prefix the count rules out), and writes (B, M) counts: it is
// bound by bytes, a few microseconds at 3.35 TB/s.  A scan of 2048
// dependent steps, each a chain of barriers and latency-bound phases, cannot
// come near that: the step is the limit.
//
// Forms timed (chip_compare.py --kernels commit_scan: the fig5 n=2048 grown
// and bursty tables, cold, in turns on one NVIDIA H100 80GB HBM3 at 700.00 W,
// medians of 3, ms; each list is one call; a form without a mechanism is a
// build with it switched off):
//   parent (PR 15)                                  42.21 / 50.54
//   no mechanism (a warp a prefix)                  39.09 / 50.48
//   count                                            9.16 /  7.83
//   count + staging                                  8.20 /  7.85  (+0.2% at
//                                                                  bursty)
//   count + staging of the rows only                 8.52 /  7.77
//   count + block walk                               7.94 /  7.39
//   count + staging + block walk                     8.34 /  7.99
// then R known to the compiler (a build for each R = 1..4 beside one for any
// R) and the rank and utilities a step ahead: 7.70 / 7.88 before, 7.07 / 7.52
// after; that form beside its variants:
//   parent (PR 15)                                  42.38 / 50.50
//   no mechanism                                    39.38 / 48.37
//   count                                            8.55 /  8.08
//   count + block walk                               7.07 /  7.52
//   the same on 512 threads                          8.00 /  7.14
//   walk and finish helpers not inlined              9.60 /  9.31
// then steps without a candidate ending after one barrier: 7.07 / 7.52
// before, 5.54 / 5.23 after; pool entries loaded ahead of the walk (chunk 0
// a step ahead, chunk c + 1 while c is taken), dropped: 5.53 / 5.21 before,
// 5.41 / 5.62 after; the sweep once the carry is empty: 5.50 / 5.19 before,
// 5.07 / 2.27 after.  Last, without the warp-per-prefix fallback, the build
// for R = 3 against the one for any R (medians of 5): 4.961 / 2.281 against
// 5.006 / 2.296, 0.9% / 0.6%, under the 5% rule: one form for any R is
// built (this kernel).  The first form of this PR (every slot
// and prefix a candidate with a division each, 4- and 8-byte staging copies,
// seven barriers) read 13.91 / 11.42 with all three mechanisms and 11.70 /
// 10.20 without staging.
#include "sched_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kChunk = kThreads;  // pool entries a block walk takes at once

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
  double *free_s, *cell, *vcell, *sp_pay, *ch_price, *red_val;
  int *gamma_s, *tkey, *kf, *jl, *nch, *ch_key, *ch_rank, *ch_node, *red_idx;
  double* u_s;      // this job's utilities
  // two of each, a step's by the parity of the steps counted so far:
  int* rcnt;        // (2, R) eligible units by rank
  int* ucap;        // (2) units free in the usable keys, ceil(free) each
  int* anyfree;     // (2) nonzero: some key has free > 0
  int* stop;        // the first step a sweep of empty steps may not write
  unsigned* nbits;  // (2, R, ceil(N/32)) node rows with eligible units, by rank
  int* fnd;         // (2, R) eligible entries before a chunk, by its parity
  uint8_t* wcnt;    // (2, R, kWarps) each warp's eligible entries of a chunk
  uint8_t *feas, *sp_ok;
};

__host__ __device__ inline int node_words(int N) { return (N + 31) / 32; }

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
  s->vcell = dbl(static_cast<size_t>(N) * R);
  s->sp_pay = dbl(R);
  s->ch_price = dbl(static_cast<size_t>(R) * wmax);
  s->red_val = dbl(2 * kWarps);
  s->u_s = dbl(R);
  s->gamma_s = in(M);
  s->tkey = in(M);
  s->kf = in(N);
  s->jl = in(N);
  s->nch = in(R);
  s->ch_key = in(static_cast<size_t>(R) * wmax);
  s->ch_rank = in(static_cast<size_t>(R) * wmax);
  s->ch_node = in(static_cast<size_t>(R) * wmax);
  s->red_idx = in(2 * kWarps);
  s->rcnt = in(2 * R);
  s->ucap = in(2);
  s->anyfree = in(2);
  s->stop = in(1);
  s->nbits = reinterpret_cast<unsigned*>(in(2 * static_cast<size_t>(R) * node_words(N)));
  s->fnd = in(2 * R);
  s->wcnt = base + off;
  off += 2 * kWarps * R;
  s->feas = base + off;
  off += N;
  s->sp_ok = base + off;
  off += R;
  return off;
}

// Units u in [0, C) with gamma <= u < gamma + free: integer u - gamma < free
// holds for the first ceil(free) of them when free > 0.
__device__ __forceinline__ int window_units(double free, int gamma, int C) {
  if (!(free > 0.0)) return 0;
  const double hi = fmin(static_cast<double>(C), static_cast<double>(gamma) + ceil(free));
  return static_cast<int>(fmax(hi - fmax(static_cast<double>(gamma), 0.0), 0.0));
}

// The consolidated slot of node row h from its availability row a[0..R):
// sched::consolidate's feasibility, first feasible prefix (k_first) and
// slowest rank (j_last), without the takes (each key works out its own).
__device__ __forceinline__ bool node_slot(const double* a, int R, double W, int* k_first,
                                          int* j_last) {
  double rc = 0.0, pc = 0.0;
  bool feas = false, full = false;
  *k_first = 0;
  *j_last = 0;
  for (int k = 0; k < R; ++k) {
    const double ak = a[k];
    rc = __dadd_rn(rc, ak);
    pc = __dadd_rn(pc, fmax(ak, 0.0));
    if (!feas && rc >= W) { feas = true; *k_first = k; }
    if (!full && pc >= W) { full = true; *j_last = k; }
  }
  return feas;
}

// The take of the key at rank r of an availability row a (r < R), as
// sched::consolidate computes it: the row's rank-prefix sums in NumPy's
// cumsum order.
__device__ __forceinline__ double key_take(const double* a, int r, double W) {
  double pc = 0.0, ap = 0.0;
  for (int k = 0; k <= r; ++k) {
    ap = fmax(a[k], 0.0);
    pc = __dadd_rn(pc, ap);
  }
  return fmin(fmax(__dsub_rn(W, __dsub_rn(pc, ap)), 0.0), ap);
}

// (val, idx) order of the reference argmax: larger value first, then the
// smaller index (numpy/jnp argmax keep the first maximum).
__device__ __forceinline__ bool better(double v, int i, double w, int j) {
  return v > w || (v == w && i < j);
}

// Offers candidate (v, c) to the running top two.
__device__ __forceinline__ void offer(double v, int c, double& v1, int& i1, double& v2, int& i2) {
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

// Merges (ov1, oi1) >= (ov2, oi2) into the running top two.
__device__ __forceinline__ void merge_top2(double& v1, int& i1, double& v2, int& i2, double ov1,
                                           int oi1, double ov2, int oi2) {
  if (better(ov1, oi1, v1, i1)) {
    if (better(v1, i1, ov2, oi2)) { v2 = v1; i2 = i1; } else { v2 = ov2; i2 = oi2; }
    v1 = ov1;
    i1 = oi1;
  } else if (better(ov1, oi1, v2, i2)) {
    v2 = ov1;
    i2 = oi1;
  }
}

// Top two of the pairs held by the lanes of each group of `width` lanes,
// in every lane of the group (a butterfly: the top two of a union does not
// depend on the order of the merges).
__device__ __forceinline__ void lanes_top2(double& v1, int& i1, double& v2, int& i2, int width) {
  for (int off = width / 2; off > 0; off /= 2) {
    const double ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const double ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
    const int oi2 = __shfl_xor_sync(0xffffffffu, i2, off);
    merge_top2(v1, i1, v2, i2, ov1, oi1, ov2, oi2);
  }
}

// Top two (val, idx) pairs of the block under `better`; every thread gets
// them in (v1, i1) and (v2, i2).  One barrier: each warp's pair goes to
// shared memory, and every warp merges the kWarps pairs in its lanes.
__device__ void block_top2(double& v1, int& i1, double& v2, int& i2, const Smem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  lanes_top2(v1, i1, v2, i2, 32);
  if (lane == 0) {
    s.red_val[2 * warp] = v1;
    s.red_idx[2 * warp] = i1;
    s.red_val[2 * warp + 1] = v2;
    s.red_idx[2 * warp + 1] = i2;
  }
  __syncthreads();
  const int w = lane % kWarps;
  v1 = s.red_val[2 * w];
  i1 = s.red_idx[2 * w];
  v2 = s.red_val[2 * w + 1];
  i2 = s.red_idx[2 * w + 1];
  lanes_top2(v1, i1, v2, i2, kWarps);
}

// This thread's entry of the chunk a block walk is on.
struct Entry {
  int q, key, rk;
  bool in;  // inside its key's window
};

// First half of walking chunk c: this thread's entry, and each warp's count
// of eligible entries for the prefixes k0..R.
__device__ __forceinline__ void walk_mark(const Args& a, const Smem& s, int R, size_t row, int c,
                                          int k0, Entry& e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  e.q = c * kChunk + threadIdx.x;
  e.key = 0;
  e.rk = R;
  e.in = false;
  if (e.q < a.L) {
    e.key = a.s_m[row + e.q];
    e.rk = a.s_rank[row + e.q];
    const int uu = a.s_u[row + e.q];
    const int lo = s.gamma_s[e.key];
    e.in = uu >= lo && static_cast<double>(uu - lo) < s.free_s[e.key];
  }
  uint8_t* wc = s.wcnt + (c & 1) * R * kWarps;
  for (int k = k0; k <= R; ++k) {
    const unsigned b = __ballot_sync(0xffffffffu, e.in && e.rk < k);
    if (lane == 0) wc[(k - 1) * kWarps + warp] = static_cast<uint8_t>(__popc(b));
  }
}

// Second half, after a barrier: each eligible entry's place in pool order
// for each prefix k0..R; the first W become the prefix's chosen units.
// Returns whether prefix k0 still lacks units and the pool has another
// chunk.
__device__ __forceinline__ bool walk_take(const Args& a, const Smem& s, int R, size_t row, int c,
                                          int k0, int Wi, const Entry& e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* wc = s.wcnt + (c & 1) * R * kWarps;
  bool more = false;
  for (int k = k0; k <= R; ++k) {
    int before = c == 0 ? 0 : s.fnd[(c & 1) * R + k - 1];
    int total = before;
    for (int w = 0; w < kWarps; ++w) {
      const int n = wc[(k - 1) * kWarps + w];
      total += n;
      if (w < warp) before += n;
    }
    const bool el = e.in && e.rk < k;
    const unsigned b = __ballot_sync(0xffffffffu, el);
    before += __popc(b & ((1u << lane) - 1u));
    if (el && before < Wi) {
      const int i = (k - 1) * a.wmax + before;
      s.ch_price[i] = a.s_price[row + e.q];
      s.ch_key[i] = e.key;
      s.ch_rank[i] = e.rk;
      s.ch_node[i] = a.s_node[row + e.q];
    }
    if (threadIdx.x == 0) s.fnd[((c + 1) & 1) * R + k - 1] = total;
    if (k == k0) more = total < Wi;
  }
  return more && (c + 1) * kChunk < a.L;
}

// A walked prefix k's spread slot from its chosen units (`found` eligible
// units seen), by one warp: the slowest rank and the distinct servers over
// the lanes, the cost summed by lane 0 in NumPy's order.
__device__ __forceinline__ void finish_walked(const Args& a, const Smem& s, int R, const double* u,
                                              int p, int k, int found, int Wi, int kj,
                                              bool single) {
  const int lane = threadIdx.x % 32, wmax = a.wmax;
  const double* ch_price = s.ch_price + (k - 1) * wmax;
  const int* ch_rank = s.ch_rank + (k - 1) * wmax;
  const int* ch_node = s.ch_node + (k - 1) * wmax;
  const int n = found < Wi ? found : Wi;
  int jmax = -1, nserv = 0;
  for (int i = lane; i < n; i += 32) {
    jmax = max(jmax, ch_rank[i]);
    bool seen = false;
    for (int j = 0; j < i; ++j) seen = seen || ch_node[j] == ch_node[i];
    nserv += !seen;
  }
  jmax = __reduce_max_sync(0xffffffffu, jmax);
  nserv = __reduce_add_sync(0xffffffffu, nserv);
  if (lane != 0) return;
  const double u_jmax = u[jmax > 0 ? jmax : 0];
  const double cost = sched::with_comm(sched::numpy_sum(ch_price, n), nserv, u_jmax,
                                       a.comm_frac);
  s.nch[k - 1] = n;
  s.sp_ok[k - 1] = found >= Wi && !single && k <= kj;
  s.sp_pay[k - 1] = __dsub_rn(u_jmax, cost);
  a.sp_nserv[static_cast<size_t>(p) * R + (k - 1)] = nserv;
}

// A prefix k with fewer than W eligible units, by one warp: the walk would
// take all of them, from every node row that holds one; not a candidate.
__device__ __forceinline__ void finish_counted(const Args& a, const Smem& s, int R, int par, int p,
                                               int k) {
  const int lane = threadIdx.x % 32, NW = node_words(a.N);
  const unsigned* nbits = s.nbits + par * R * NW;
  int nserv = 0;
  for (int w = lane; w < NW; w += 32) {
    unsigned bits = 0;
    for (int r = 0; r < k; ++r) bits |= nbits[r * NW + w];
    nserv += __popc(bits);
  }
  nserv = __reduce_add_sync(0xffffffffu, nserv);
  if (lane != 0) return;
  int n = 0;
  for (int r = 0; r < k; ++r) n += s.rcnt[par * R + r];
  s.nch[k - 1] = n;
  s.sp_ok[k - 1] = false;
  a.sp_nserv[static_cast<size_t>(p) * R + (k - 1)] = nserv;
}

__global__ void __launch_bounds__(kThreads, 1) commit_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.M, N = a.N, R = a.R, C = a.C, L = a.L, NW = node_words(N);
  Smem s;
  smem_layout(M, N, R, a.wmax, smem, &s);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const double NEG_INF = -CUDART_INF;

  for (int m = tid; m < M; m += kThreads) {
    s.free_s[m] = a.free0[m];
    s.gamma_s[m] = a.gamma0[m];
  }
  for (int i = tid; i < N * R; i += kThreads) {
    s.cell[i] = 0.0;
    s.vcell[i] = 0.0;
  }
  for (int i = tid; i < 2 * R * NW; i += kThreads) s.nbits[i] = 0u;
  for (int r = tid; r < 2 * R; r += kThreads) s.rcnt[r] = 0;
  if (tid < 2) {
    s.ucap[tid] = 0;
    s.anyfree[tid] = 0;
  }
  int par = 0;  // parity of the steps counted so far
  // the next job's scalars, the rank of this thread's first key and a
  // utility, loaded a step ahead
  double Wn = a.W[0];
  int kjn = a.Kj[0];
  bool singlen = a.single[0] != 0;
  int rkn = tid < M ? a.rank[tid] : R;
  double un = tid < R ? a.u_tab[tid] : 0.0;
  __syncthreads();

  for (int p = 0; p < a.B; ++p) {
    const double W = Wn;
    const int Wi = static_cast<int>(W);
    const int kj = kjn;
    const bool single = singlen;
    const int rk_own = rkn;
    const int* rank = a.rank + static_cast<size_t>(p) * M;
    // read after the first barrier; last read before the last one
    const double* u = s.u_s;
    for (int k = tid; k < R; k += kThreads)
      s.u_s[k] = k == tid ? un : a.u_tab[static_cast<size_t>(p) * R + k];
    if (p + 1 < a.B) {
      Wn = a.W[p + 1];
      kjn = a.Kj[p + 1];
      singlen = a.single[p + 1] != 0;
      if (tid < M) rkn = a.rank[static_cast<size_t>(p + 1) * M + tid];
      if (tid < R) un = a.u_tab[static_cast<size_t>(p + 1) * R + tid];
    }
    const size_t row = static_cast<size_t>(p) * L;
    int* counts = a.counts + static_cast<size_t>(p) * M;
    if (kj == 0) {  // no usable type: no candidate, nothing committed
      for (int m = tid; m < M; m += kThreads) counts[m] = 0;
      for (int k = tid; k < R; k += kThreads) a.sp_nserv[static_cast<size_t>(p) * R + k] = 0;
      if (tid == 0) {
        a.won[p] = 0;
        a.win[p] = 0;
        a.win2[p] = 0;
        a.win2_pay[p] = NEG_INF;
      }
      continue;
    }

    // ---- keys: the (node row, rank) cells; eligible units by rank -------
    // (the other parity's counts, last read before the last step's last
    // barrier, are cleared for the next step)
    int* rcnt = s.rcnt + par * R;
    unsigned* nbits = s.nbits + par * R * NW;
    for (int i = tid; i < R * NW; i += kThreads) s.nbits[(par ^ 1) * R * NW + i] = 0u;
    for (int r = tid; r < R; r += kThreads) s.rcnt[(par ^ 1) * R + r] = 0;
    if (tid == 0) {
      s.ucap[par ^ 1] = 0;
      s.anyfree[par ^ 1] = 0;
    }
    for (int m0 = 0; m0 < M; m0 += kThreads) {  // whole warps, for the sum
      const int m = m0 + tid;
      int cap = 0;
      if (m < M) {
        const int r = m == tid ? rk_own : rank[m];
        const int h = __ldg(a.node_row + m);
        const double f = s.free_s[m];
        if (r < kj) s.cell[h * R + r] = f;
        if (r < R) {
          const int n = window_units(f, s.gamma_s[m], C);
          if (n > 0) {
            atomicAdd(rcnt + r, n);
            atomicOr(nbits + r * NW + h / 32, 1u << (h % 32));
          }
          if (r < kj && f > 0.0) cap = static_cast<int>(ceil(f));
        }
        if (f > 0.0) s.anyfree[par] = 1;
      }
      cap = __reduce_add_sync(0xffffffffu, cap);
      if (lane == 0 && cap > 0) atomicAdd(s.ucap + par, cap);
    }
    __syncthreads();

    // the first prefix whose eligible units reach W; the ones before it
    // are not walked (R + 1: none is)
    int n = 0, k0 = R + 1;
    for (int r = 0; r < R; ++r) {
      n += rcnt[r];
      if (n >= Wi) { k0 = r + 1; break; }
    }
    // No prefix walks and the usable keys hold fewer than W units, so no
    // node row is feasible either: no candidate, slot 0 wins with -inf,
    // nothing is committed.
    if (k0 > R && static_cast<double>(s.ucap[par]) < W) {
      for (int k = warp + 1; k <= R; k += kWarps) finish_counted(a, s, R, par, p, k);
      for (int i = tid; i < N * R; i += kThreads) s.cell[i] = 0.0;
      for (int m = tid; m < M; m += kThreads) counts[m] = 0;
      if (tid == 0) {
        a.won[p] = 0;
        a.win[p] = 0;
        a.win2[p] = 0;
        a.win2_pay[p] = NEG_INF;
        s.stop[0] = a.B;
      }
      const bool empty = !s.anyfree[par];
      par ^= 1;
      __syncthreads();
      if (!empty) continue;
      // No key has a free unit, so no later step can take one: each has
      // the outputs of a step without a candidate (all servers 0) up to
      // the first whose gang is below one unit (an empty spread slot
      // could then win).  They are written at once.
      for (int q = p + 1 + tid; q < a.B; q += kThreads)
        if (a.Kj[q] > 0 && !(a.W[q] >= 1.0)) atomicMin(s.stop, q);
      __syncthreads();
      const int stop = s.stop[0];
      for (size_t i = tid; i < static_cast<size_t>(stop - p - 1) * M; i += kThreads)
        a.counts[static_cast<size_t>(p + 1) * M + i] = 0;
      for (size_t i = tid; i < static_cast<size_t>(stop - p - 1) * R; i += kThreads)
        a.sp_nserv[static_cast<size_t>(p + 1) * R + i] = 0;
      for (int q = p + 1 + tid; q < stop; q += kThreads) {
        a.won[q] = 0;
        a.win[q] = 0;
        a.win2[q] = 0;
        a.win2_pay[q] = NEG_INF;
      }
      p = stop - 1;
      if (stop < a.B) {
        Wn = a.W[stop];
        kjn = a.Kj[stop];
        singlen = a.single[stop] != 0;
        if (tid < M) rkn = a.rank[static_cast<size_t>(stop) * M + tid];
        if (tid < R) un = a.u_tab[static_cast<size_t>(stop) * R + tid];
      }
      continue;
    }

    // ---- node rows: consolidated slots; keys: takes and packed costs -----
    for (int h = tid; h < N; h += kThreads) {
      int kf, jl;
      s.feas[h] = node_slot(s.cell + h * R, R, W, &kf, &jl);
      s.kf[h] = kf;
      s.jl[h] = jl;
    }
    for (int m = tid; m < M; m += kThreads) {
      const int r = m == tid ? rk_own : rank[m];
      int t = 0;
      if (r < kj) {
        const int h = __ldg(a.node_row + m);
        t = static_cast<int>(key_take(s.cell + h * R, r, W));
        const int g = s.gamma_s[m];
        const double* prow = a.P_tab + static_cast<size_t>(m) * C;
        double v = 0.0;  // unit by unit, as NumPy's cumsum
        for (int i = 0; i < t; ++i) v = __dadd_rn(v, __ldg(prow + min(g + i, C - 1)));
        s.vcell[h * R + r] = v;
      }
      s.tkey[m] = t;
    }
    // prefixes below k0 from their counts; k0 and up walk the pool
    for (int k = warp + 1; k < k0; k += kWarps) finish_counted(a, s, R, par, p, k);
    Entry e;
    if (k0 <= R) walk_mark(a, s, R, row, 0, k0, e);
    __syncthreads();

    // ---- the block walk: chosen units, then the walked prefixes ---------
    if (k0 <= R) {
      int c = 0;
      while (walk_take(a, s, R, row, c, k0, Wi, e)) {
        walk_mark(a, s, R, row, ++c, k0, e);
        __syncthreads();
      }
      __syncthreads();
      for (int k = warp + 1; k <= R; k += kWarps)
        if (k >= k0)
          finish_walked(a, s, R, u, p, k, s.fnd[((c + 1) & 1) * R + k - 1], Wi, kj, single);
      __syncthreads();
    }

    // ---- selection: reference enumeration order, first maximum ----------
    // Slot k (N + 1) + h: node row h is live only at its first feasible
    // prefix, the spread slot (h = N) where sp_ok; every other slot is
    // -inf, and the argmax of a row of -inf is slot 0 (thread 0's seed).
    par ^= 1;
    double v1 = NEG_INF, v2 = NEG_INF;
    int i1 = tid == 0 ? 0 : 0x7fffffff, i2 = 0x7fffffff;
    for (int h = tid; h < N; h += kThreads) {
      double* cost = s.vcell + h * R;
      if (s.feas[h])  // the packed payoff
        offer(__dsub_rn(u[s.jl[h]], sched::numpy_sum(cost, kj < R ? kj : R)),
              s.kf[h] * (N + 1) + h, v1, i1, v2, i2);
      for (int k = 0; k < R; ++k) {  // row h is this thread's
        s.cell[h * R + k] = 0.0;
        cost[k] = 0.0;
      }
    }
    for (int k = tid; k < R; k += kThreads)
      if (s.sp_ok[k]) offer(s.sp_pay[k], k * (N + 1) + N, v1, i1, v2, i2);
    block_top2(v1, i1, v2, i2, s);
    const bool ok = v1 > 0.0;  // the mu_j > 0 gate
    const int slot = i1 % (N + 1), ksel = i1 / (N + 1);
    if (tid == 0) {
      a.won[p] = ok;
      a.win[p] = i1;
      // runner-up: the argmax with the winner set to -inf, which is the
      // first index (0) when every other candidate is -inf
      a.win2[p] = v2 == NEG_INF ? 0 : i2;
      a.win2_pay[p] = v2;
    }

    // ---- commit into the carry: each thread its own keys ----------------
    for (int m = tid; m < M; m += kThreads) {
      int cnt = 0;
      if (ok && slot < N) {
        cnt = __ldg(a.node_row + m) == slot ? s.tkey[m] : 0;
      } else if (ok) {
        const int* ck = s.ch_key + ksel * a.wmax;
        for (int i = 0; i < s.nch[ksel]; ++i) cnt += ck[i] == m;
      }
      counts[m] = cnt;
      s.free_s[m] = __dsub_rn(s.free_s[m], static_cast<double>(cnt));
      s.gamma_s[m] += cnt;
    }
  }
  for (int m = tid; m < M; m += kThreads) {
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
               static_cast<double*>(free), static_cast<int*>(gamma), static_cast<uint8_t*>(won),
               static_cast<int*>(win), static_cast<int*>(counts), static_cast<int*>(win2),
               static_cast<double*>(win2_pay), static_cast<int*>(sp_nserv), B, M, N, R, C, L,
               wmax, comm_frac};
  commit_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
