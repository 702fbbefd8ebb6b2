// FIND_ALLOC for a whole queue of jobs against one shared cluster state, for
// Hopper (sm_90a): kernel K4 of the Hadar decision path, float64.
//
// Replaces the JAX kernel `_build_kernel` / `per_job` in
// src/repro/core/batch_solver.py (:228-335, a jit-ed vmap over the job
// bucket).  Per job b, with M cluster keys (node, gpu type), N node rows, R
// gpu types, the job's preference rank of each key's type (rank == R:
// unusable) and its gang size W:
//   consolidated slots (Algorithm 2 line 24): the job's usable free units in
//     (node, rank) cells (at most one key per cell), prefix sums over the
//     rank axis in NumPy's cumsum order, feasibility, the first feasible
//     prefix, the packed takes, the slowest rank used, and the packed cost:
//     the take of each key gathered from the host's unit-price prefix sums
//     cumP, summed over ranks;
//   spread slots (lines 25-27), for each preference prefix k = 1..R: the
//     first W eligible units of the job's pool in its host-sorted order
//     (stable mergesort of price/throughput), their cost, slowest rank,
//     distinct servers, the communication penalty, and the units per key.
// Outputs are those of ref.find_alloc_ref, bitwise: every sum is taken in the
// NumPy oracle's order (sched_common.cuh); the counts, integer adds, are the
// only values built with atomics.
//
// Bound.  The function reads the shared tables once (avail, cumP, node_row),
// each job's rows (rank, u_tab, scalars) and the prefix of its sorted pool
// that the W-th eligible unit ends (data-dependent; chip_smoke.py counts it
// from the run's tables), and writes the slot tables: 15.6 KB a job at fig5
// n=2048 (take, B N R doubles, and the (B, R, M) counts are most of it).
// Its float64 work is a few operations per byte, so it is bound by the
// bytes it writes.
//
// Design: one warp a job, in one wave, each output written once.
// - A block is one warp and takes one job: B blocks.  At the fig5 n=2048
//   shapes a block takes 8.3-8.5 KB of shared memory (below) and 64
//   registers a thread (ptxas), so by Hopper's limits (228 KB of shared
//   memory an SM, 1 KB of it reserved a block; 64 K registers) about 24
//   fit an SM, over 3000 on the card's 132, and there every job's warp is
//   resident from the start: one job's stores overlap
//   the others' loads and the write stream does not drain between waves.
//   A larger queue's blocks start as others end.  Only __syncwarp orders
//   the phases: no block barrier anywhere.  (The parent: a block of 256
//   threads a job, five resident an SM by its 48 registers, so four waves
//   at n=2048, four block barriers before its spread phase and five of its
//   eight warps idle in it.)
// - Few trips to device memory in a job's chain.  Its (node, rank) cells
//   are a shared (N, R) tile: a lane a key loads the key's rank, node row
//   and free units, kBatch keys a lane with every load in flight at once,
//   and writes its cell; a lane a node row takes its rank-prefix sums in
//   place; a lane a key gathers its cost from cumP (again kBatch at once)
//   into the same cell, and each node row sums its cells.  Nothing is
//   scattered through device memory, zeroed there or read back.
// - Each output is written once, coalesced: the per-row fields a lane a row,
//   the job's N R takes from the tile as one span, each prefix's counts from
//   a shared (M) row built with atomic adds (integers: any order is exact),
//   the distinct servers a bitmap of node rows set beside them.  Every
//   output store is st.global.cs (evict first): 32 MB of outputs then do
//   not push the shared tables out of L2.
// - A walk a preference prefix over the job's sorted pool, 32 entries a
//   ballot, ending at the W-th eligible unit; the chosen units' cost summed
//   in NumPy's order by one lane.
//
// Kept by their time (chip_compare.py --kernels find_alloc, cold, in turns,
// fig5 n=2048 grown / bursty, on an NVIDIA H100 80GB HBM3, 700.00 W; each
// mechanism against the form without it, kept if >= 5% at both).  In this
// form: the staged take span against each row's R takes stored by its
// lane, 0.01772 / 0.02013 ms against 0.02396 / 0.02874 (26% / 30%);
// streaming stores against plain ones, against 0.01983 / 0.02307 (11% /
// 13%); kBatch 8 against 1, against 0.01966 / 0.02331 (9.9% / 14%).  On
// the persistent-grid form before it: 25% / 28%, 9.3% / 13%, 8.4% / 12%.
// Measured and dropped (gain of adding it; the form it was added to):
// a persistent grid of at most SMs x resident blocks (occupancy query at
// each launch), a warp taking jobs blockIdx.x, + gridDim.x, ...: 80
// registers and 4 bytes spilled against this form's 64 and none, 0.01812 /
// 0.02107 ms against 0.01775 / 0.02008 (-2.1% / -4.9%; -5.6% at 256 busy
// jobs, -23% at an 8192-job queue); on this form, the single flag loaded
// at the job's start (3.1% / -2.1%), with the utilities staged in shared
// memory there (0.5% / 1.3%), and with the pool's first chunk prefetched
// into L2 too (1.1% / -4.1%); none moved the 622 launches of a 256-job
// simulate by 2% (5.29-5.41 ms in all against 5.39); on the persistent
// form, all R prefixes walked side by side, a ballot a prefix (4.1% / 2.3%
// without the staged span, -1.1% / -0.5% with it); the first chunk loaded
// at the job's start (2.9% / 3.7%, with it); the utilities in registers,
// read by shuffle (3.6% / 1.2%, without it); on earlier forms, the next
// chunk's loads issued a chunk ahead (-5.3% / -6.4%: no fig5 walk needs a
// second chunk), kBatch 12 (-6.8% / +1.3%), 16-byte vector stores of the
// spans (3.3% / 6.3%), the cost loads issued before the take stores
// (-3.0% / -4.5%), the tile zeroed after a job rather than before the
// next (-0.3% / -0.6%).
// Small queues: on the 622 launches of the 256-job simulate (8-256 jobs
// each, N = M = 32, L = 128) back to back, this form takes 5.396 ms in all
// against the parent's 4.214 (28% more); on 256 busy jobs 0.00735 against
// 0.00639.  There one job's chain is the launch; what in it costs the
// time was not measured.

// Shared memory of a block: 8 N R (the tile; in the spread phase it holds
// the servers' bitmap, ceil(N/32) words) + 12 wmax (the chosen units'
// prices and keys) + 4 N (each node row's slowest rank used) + 4 M (a key's
// cell, then a prefix's counts) bytes.  With at most one key per (node row,
// type), M <= N R, so this is at most 12 N R + 4 N + 12 wmax, and the
// parent's 16 N R + 160 wmax exceeds it by at least 4 N (R - 1) +
// 148 wmax > 0: no shape the parent accepted is refused.
#include "sched_common.cuh"

namespace {

constexpr int kBatch = 8;  // keys a lane loads at once

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

size_t smem_bytes(int N, int R, int M, int wmax) {
  return 8 * static_cast<size_t>(N) * R + 12 * static_cast<size_t>(wmax) +
         4 * static_cast<size_t>(N) + 4 * static_cast<size_t>(M);
}

// One pool entry a lane: 32 consecutive entries of a job's sorted pool.
struct Chunk {
  bool valid;  // false past the pool's end
  int rank, key;
  double price;
};

__device__ __forceinline__ Chunk load_chunk(const Args& a, size_t base, int p) {
  Chunk c{false, 0, 0, 0.0};
  if (p < a.L) {
    c.valid = a.s_valid[base + p];
    c.rank = a.s_rank[base + p];
    c.key = a.s_key[base + p];
    c.price = a.s_price[base + p];
  }
  return c;
}

__global__ void __launch_bounds__(32) find_alloc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, R = a.R, M = a.M, L = a.L, wmax = a.wmax;
  const int words = (N + 31) / 32;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  double* tile = reinterpret_cast<double*>(smem);        // (N, R)
  unsigned* served = reinterpret_cast<unsigned*>(smem);  // (words), later
  double* ch_price = tile + static_cast<size_t>(N) * R;  // (wmax)
  int* ch_key = reinterpret_cast<int*>(ch_price + wmax);  // (wmax)
  int* jlast = ch_key + wmax;                             // (N)
  int* cnt = jlast + N;  // (M): a key's cell, then a prefix's counts

  const int b = blockIdx.x;
  const double W = a.W[b];
  const int Wi = static_cast<int>(W);
  const int kj = a.Kj[b];
  const int nk = kj < R ? kj : R;
  const int* rank = a.rank + static_cast<size_t>(b) * M;
  const double* u = a.u_tab + static_cast<size_t>(b) * R;

  // ---- consolidated slots: the (node, rank) cells in the tile ----------
  for (int i = lane; i < N * R; i += 32) tile[i] = 0.0;
  __syncwarp();
  for (int m0 = 0; m0 < M; m0 += 32 * kBatch) {  // a lane a key
    int r[kBatch], h[kBatch];
    double av[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = m0 + 32 * j + lane;
      if (m < M) {
        r[j] = rank[m];
        h[j] = a.node_row[m];
        av[j] = a.avail[m];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = m0 + 32 * j + lane;
      if (m < M) {
        const int cell = r[j] < kj ? h[j] * R + r[j] : -1;
        if (cell >= 0) tile[cell] = av[j];
        cnt[m] = cell;  // the key's cell, or -1 if the job may not use it
      }
    }
  }
  __syncwarp();
  for (int h = lane; h < N; h += 32) {  // a lane a node row: takes in place
    int kf, jl;
    const bool feas = sched::consolidate(tile + h * R, R, W, tile + h * R, &kf, &jl);
    const size_t o = static_cast<size_t>(b) * N + h;
    __stcs(a.feasible + o, static_cast<uint8_t>(feas));
    __stcs(a.k_first + o, kf);
    __stcs(a.j_last + o, jl);
    jlast[h] = jl;
  }
  __syncwarp();
  double* take = a.take + static_cast<size_t>(b) * N * R;
  for (int i0 = lane; i0 < N * R; i0 += 32 * kBatch) {  // one span
    double t[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) t[j] = i0 + 32 * j < N * R ? tile[i0 + 32 * j] : 0.0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + 32 * j < N * R) __stcs(take + i0 + 32 * j, t[j]);
  }
  __syncwarp();
  for (int m0 = 0; m0 < M; m0 += 32 * kBatch) {  // a key's cost replaces its take
    int cell[kBatch];
    double c[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = m0 + 32 * j + lane;
      cell[j] = m < M ? cnt[m] : -1;
      c[j] = cell[j] >= 0
                 ? a.cumP[static_cast<size_t>(m) * a.C1 + static_cast<int>(tile[cell[j]])]
                 : 0.0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int m = m0 + 32 * j + lane;
      if (cell[j] >= 0) tile[cell[j]] = c[j];
      if (m < M) cnt[m] = 0;
    }
  }
  __syncwarp();
  for (int h = lane; h < N; h += 32) {
    const double cost = sched::numpy_sum(tile + h * R, nk);
    const size_t o = static_cast<size_t>(b) * N + h;
    __stcs(a.packed_cost + o, cost);
    __stcs(a.packed_payoff + o, __dsub_rn(u[jlast[h]], cost));
  }
  __syncwarp();

  // ---- spread slots: a walk a preference prefix -----------------------
  const size_t pool = static_cast<size_t>(b) * L;
  for (int k = 1; k <= R; ++k) {
    int found = 0, jmax = -1;  // eligible units seen, stopping at the W-th
    for (int p0 = 0; p0 < L && found < Wi; p0 += 32) {
      const Chunk c = load_chunk(a, pool, p0 + lane);
      const bool e = c.valid && c.rank < k;
      const unsigned mask = __ballot_sync(0xffffffffu, e);
      const int before = found + __popc(mask & below);
      if (e && before < Wi) {
        ch_price[before] = c.price;
        ch_key[before] = c.key;
        jmax = max(jmax, c.rank);
      }
      found += __popc(mask);
    }
    const int n = min(found, Wi);
    jmax = __reduce_max_sync(0xffffffffu, jmax);
    for (int w = lane; w < words; w += 32) served[w] = 0u;
    __syncwarp();
    for (int i = lane; i < n; i += 32) {  // counts, and the node rows used
      const int key = ch_key[i];
      const int h = a.node_row[key];
      atomicAdd(&cnt[key], 1);
      atomicOr(&served[h >> 5], 1u << (h & 31));
    }
    __syncwarp();
    int ns = 0;
    for (int w = lane; w < words; w += 32) ns += __popc(served[w]);
    const int nserv = __reduce_add_sync(0xffffffffu, ns);
    int* counts = a.sp_counts + (static_cast<size_t>(b) * R + (k - 1)) * M;
    for (int m = lane; m < M; m += 32) {
      __stcs(counts + m, cnt[m]);
      cnt[m] = 0;
    }
    if (lane == 0) {
      const double u_jmax = u[jmax > 0 ? jmax : 0];
      const double cost =
          sched::with_comm(sched::numpy_sum(ch_price, n), nserv, u_jmax, a.comm_frac);
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

// Shapes as ref.find_alloc_ref; bool arrays are one byte each; node_row
// values in [0, N).  Returns the launch's cudaError_t (0
// on success), or -1 when the shapes need more shared memory than a block
// has.
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
  const size_t smem = smem_bytes(N, R, M, wmax);
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
  find_alloc_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
