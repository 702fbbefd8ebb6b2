// FIND_ALLOC for a whole queue of jobs against one shared cluster state, for
// Hopper (sm_90a): kernel K4 of the Hadar decision path, float64.
//
// Replaces the JAX kernel `_build_kernel` / `per_job` in
// src/repro/core/batch_solver.py (:228-335, a jit-ed vmap over the job
// bucket).  Per job b (one block each), with M cluster keys (node, gpu type),
// N node rows, R gpu types, the job's preference rank of each key's type
// (rank == R: unusable) and its gang size W:
//   consolidated slots (Algorithm 2 line 24): the job's usable free units
//     scattered into (node, rank) cells (at most one key per cell, so the
//     scatter is exact), prefix sums over the rank axis in NumPy's cumsum
//     order, feasibility, the first feasible prefix, the packed takes, the
//     slowest rank used, and the packed cost: the take of each key gathered
//     from the host's unit-price prefix sums cumP, summed over ranks;
//   spread slots (lines 25-27), for each preference prefix k = 1..R: the
//     first W eligible units of the job's pool in its host-sorted order
//     (stable mergesort of price/throughput), their cost, slowest rank,
//     distinct servers, the communication penalty, and the units per key.
// Outputs are those of ref.find_alloc_ref, bitwise: every sum is taken in the
// NumPy oracle's order (sched_common.cuh), never by a tree or an atomic.
//
// Design.  One block of 256 threads per padded job.  The (node, rank)
// availability, the takes and the per-cell packed costs live in dynamic
// shared memory (2 N R doubles, sized from the runtime N and R); a thread
// per node row walks the rank axis.  Each warp takes one spread prefix and
// walks the job's sorted pool 32 units at a time: a ballot marks the
// eligible units, a popcount ranks them, and the warp stops at the W-th, so
// it reads only as much of the pool as this state needs.  The chosen units
// (at most wmax <= 128) are kept per warp in shared memory and summed by one
// lane in NumPy's pairwise order.
//
// Bound.  The function reads the shared tables once (avail, cumP, node_row),
// each job's rows (rank, u_tab, scalars) and the prefix of its sorted pool
// that the W-th eligible unit ends (data-dependent; chip_smoke.py counts it
// from the run's tables), and writes the slot tables (take is B N R doubles).
// Its float64 work is a few operations per byte, so it is bound by bytes; the
// latency of the pool walk (dependent loads, one warp per prefix) keeps this
// simple form above that bound.
#include "sched_common.cuh"

namespace {

using sched::kThreads;
using sched::kWarps;

struct Args {
  const double* avail;     // (M)
  const double* cumP;      // (M, C1)
  const int* node_row;     // (M)
  const double* W;         // (B)
  const int* Kj;           // (B)
  const uint8_t* single;   // (B)
  const int* rank;         // (B, M)
  const double* u_tab;     // (B, R)
  const int* s_rank;       // (B, L)
  const uint8_t* s_valid;  // (B, L)
  const double* s_price;   // (B, L)
  const int* s_key;        // (B, L)
  uint8_t* feasible;       // (B, N)
  int* k_first;            // (B, N)
  int* j_last;             // (B, N)
  double* take;            // (B, N, R)
  double* packed_cost;     // (B, N)
  double* packed_payoff;   // (B, N)
  uint8_t* sp_ok;          // (B, R)
  double* sp_pay;          // (B, R)
  int* sp_jmax;            // (B, R)
  int* sp_nserv;           // (B, R)
  int* sp_counts;          // (B, R, M)
  int B, M, N, R, C1, L, wmax;
  double comm_frac;
};

size_t smem_bytes(int N, int R, int wmax) {
  return sizeof(double) * 2 * static_cast<size_t>(N) * R  // cells, takes
         + static_cast<size_t>(kWarps) * wmax * (sizeof(double) + 3 * sizeof(int));
}

__global__ void __launch_bounds__(kThreads) find_alloc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, R = a.R, M = a.M, L = a.L, wmax = a.wmax;
  double* cell = reinterpret_cast<double*>(smem);  // (N, R): avail, then cost
  double* take_s = cell + N * R;                    // (N, R)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* ch_price = take_s + N * R + warp * wmax;  // per warp (wmax)
  int* ch_int = reinterpret_cast<int*>(take_s + N * R + kWarps * wmax);
  int* ch_rank = ch_int + warp * 3 * wmax;
  int* ch_key = ch_rank + wmax;
  int* ch_node = ch_key + wmax;

  const int b = blockIdx.x;
  const double W = a.W[b];
  const int Wi = static_cast<int>(W);
  const int kj = a.Kj[b];
  const int* rank = a.rank + static_cast<size_t>(b) * M;
  const double* u = a.u_tab + static_cast<size_t>(b) * R;

  // ---- consolidated slots ----------------------------------------------
  for (int i = threadIdx.x; i < N * R; i += kThreads) cell[i] = 0.0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int r = rank[m];
    if (r < kj) cell[a.node_row[m] * R + r] = a.avail[m];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < N; h += kThreads) {
    int kf, jl;
    const bool feas = sched::consolidate(cell + h * R, R, W, take_s + h * R, &kf, &jl);
    const size_t o = static_cast<size_t>(b) * N + h;
    a.feasible[o] = feas;
    a.k_first[o] = kf;
    a.j_last[o] = jl;
    for (int k = 0; k < R; ++k) {
      a.take[o * R + k] = take_s[h * R + k];
      cell[h * R + k] = 0.0;  // row h is read by this thread only
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int r = rank[m];
    if (r < kj) {
      const int h = a.node_row[m];
      const int t = static_cast<int>(take_s[h * R + r]);
      cell[h * R + r] = a.cumP[static_cast<size_t>(m) * a.C1 + t];
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < N; h += kThreads) {
    const size_t o = static_cast<size_t>(b) * N + h;
    const double cost = sched::numpy_sum(cell + h * R, kj < R ? kj : R);
    a.packed_cost[o] = cost;
    a.packed_payoff[o] = __dsub_rn(u[a.j_last[o]], cost);
  }

  // ---- spread slots: one warp per preference prefix --------------------
  const int* s_rank = a.s_rank + static_cast<size_t>(b) * L;
  const uint8_t* s_valid = a.s_valid + static_cast<size_t>(b) * L;
  const double* s_price = a.s_price + static_cast<size_t>(b) * L;
  const int* s_key = a.s_key + static_cast<size_t>(b) * L;
  for (int k = warp + 1; k <= R; k += kWarps) {
    int found = 0;  // eligible units seen, stopping at the W-th
    for (int p0 = 0; kj > 0 && p0 < L && found < Wi; p0 += 32) {  // kj == 0: none
      const int p = p0 + lane;
      const bool e = p < L && s_valid[p] && s_rank[p] < k;
      const unsigned mask = __ballot_sync(0xffffffffu, e);
      const int before = found + __popc(mask & ((1u << lane) - 1u));
      if (e && before < Wi) {
        ch_price[before] = s_price[p];
        ch_rank[before] = s_rank[p];
        ch_key[before] = s_key[p];
        ch_node[before] = a.node_row[s_key[p]];
      }
      found += __popc(mask);
    }
    int* counts = a.sp_counts + (static_cast<size_t>(b) * R + (k - 1)) * M;
    for (int m = lane; m < M; m += 32) counts[m] = 0;
    __syncwarp();
    if (lane == 0) {
      const int n = found < Wi ? found : Wi;
      int jmax = -1;
      for (int i = 0; i < n; ++i) {
        jmax = max(jmax, ch_rank[i]);
        counts[ch_key[i]] += 1;
      }
      const int nserv = sched::n_distinct(ch_node, n);
      const double u_jmax = u[jmax > 0 ? jmax : 0];
      const double cost = sched::with_comm(sched::numpy_sum(ch_price, n), nserv, u_jmax,
                                           a.comm_frac);
      const size_t o = static_cast<size_t>(b) * R + (k - 1);
      a.sp_ok[o] = found >= Wi && !a.single[b] && k <= kj;
      a.sp_pay[o] = __dsub_rn(u_jmax, cost);
      a.sp_jmax[o] = jmax;
      a.sp_nserv[o] = nserv;
    }
    __syncwarp();
  }
}

}  // namespace

// Shapes as ref.find_alloc_ref; bool arrays are one byte each.  Returns the
// launch's cudaError_t (0 on success), or -1 when N, R and wmax need more
// shared memory than a block has.
extern "C" int find_alloc_fwd(const void* avail, const void* cumP, const void* node_row,
                              const void* W, const void* Kj, const void* single,
                              const void* rank, const void* u_tab, const void* s_rank,
                              const void* s_valid, const void* s_price, const void* s_key,
                              void* feasible, void* k_first, void* j_last, void* take,
                              void* packed_cost, void* packed_payoff, void* sp_ok,
                              void* sp_pay, void* sp_jmax, void* sp_nserv, void* sp_counts,
                              int B, int M, int N, int R, int C1, int L, int wmax,
                              double comm_frac, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || R <= 0 || C1 <= 0 || L < 0 || wmax <= 0 || wmax > 128)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, R, wmax);
  if (smem > sched::kSmemMax) return sched::kSmemExceeded;
  cudaError_t err = cudaFuncSetAttribute(find_alloc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return int(err);
  const Args a{static_cast<const double*>(avail), static_cast<const double*>(cumP),
               static_cast<const int*>(node_row), static_cast<const double*>(W),
               static_cast<const int*>(Kj), static_cast<const uint8_t*>(single),
               static_cast<const int*>(rank), static_cast<const double*>(u_tab),
               static_cast<const int*>(s_rank), static_cast<const uint8_t*>(s_valid),
               static_cast<const double*>(s_price), static_cast<const int*>(s_key),
               static_cast<uint8_t*>(feasible), static_cast<int*>(k_first),
               static_cast<int*>(j_last), static_cast<double*>(take),
               static_cast<double*>(packed_cost), static_cast<double*>(packed_payoff),
               static_cast<uint8_t*>(sp_ok), static_cast<double*>(sp_pay),
               static_cast<int*>(sp_jmax), static_cast<int*>(sp_nserv),
               static_cast<int*>(sp_counts), B, M, N, R, C1, L, wmax, comm_frac};
  find_alloc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
