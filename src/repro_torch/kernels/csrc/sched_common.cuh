// Device helpers shared by the two scheduler kernels (find_alloc.cu, K4, and
// commit_scan.cu, K5).  Everything is float64, and every sum is taken in the
// order of the NumPy oracle (repro_torch/core/dp.py::_find_alloc_arrays), so
// the kernels' payoffs are bitwise the oracle's.  No multiply feeds an add
// without an explicit rounding (__dmul_rn / __dadd_rn): nvcc would otherwise
// contract it into an fma, which rounds once instead of twice.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace sched {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// what the C entries return when the shapes need more shared memory than a
// block can have (kernels/find_alloc.py: SMEM_EXCEEDED)
constexpr int kSmemExceeded = -1;
constexpr size_t kSmemMax = 232448;  // 227 KB, Hopper's per-block limit

// NumPy's float64 sum of v[0..n) (pairwise_sum in numpy's loops, n <= 128):
// under 8 values one by one from 0.0; else eight running sums over strides
// of 8, combined ((s0+s1)+(s2+s3))+((s4+s5)+(s6+s7)), then the rest in order.
__device__ __forceinline__ double numpy_sum(const double* v, int n) {
  if (n < 8) {
    double r = 0.0;
    for (int i = 0; i < n; ++i) r = __dadd_rn(r, v[i]);
    return r;
  }
  double s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = v[j];
  int i = 8;
  for (; i < n - n % 8; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = __dadd_rn(s[j], v[i + j]);
  }
  double r = __dadd_rn(__dadd_rn(__dadd_rn(s[0], s[1]), __dadd_rn(s[2], s[3])),
                       __dadd_rn(__dadd_rn(s[4], s[5]), __dadd_rn(s[6], s[7])));
  for (; i < n; ++i) r = __dadd_rn(r, v[i]);
  return r;
}

// A spread candidate's cost with its communication term: the NumPy oracle's
// cost2 += COMM_COST_FRAC * max(u, 0) * (n_servers - 1), rounded per op.
__device__ __forceinline__ double with_comm(double cost, int nserv, double u,
                                            double comm_frac) {
  if (nserv <= 1) return cost;
  const double extra = __dmul_rn(__dmul_rn(comm_frac, fmax(u, 0.0)),
                                 static_cast<double>(nserv - 1));
  return __dadd_rn(cost, extra);
}

// Distinct values among v[0..n).
__device__ __forceinline__ int n_distinct(const int* v, int n) {
  int d = 0;
  for (int i = 0; i < n; ++i) {
    bool seen = false;
    for (int j = 0; j < i; ++j) seen = seen || v[j] == v[i];
    d += !seen;
  }
  return d;
}

// The consolidated slot of one node row h for a job of gang W: rank-axis
// prefix sums of its (node, rank) availability row a[0..R), in NumPy's
// cumsum order.  Writes take[0..R); returns feasible and sets the first
// feasible prefix (k_first) and the slowest rank used (j_last), both 0 when
// none, as argmax of an all-false row.
__device__ __forceinline__ bool consolidate(const double* a, int R, double W,
                                            double* take, int* k_first,
                                            int* j_last) {
  double rc = 0.0, pc = 0.0;
  bool feas = false, full = false;
  *k_first = 0;
  *j_last = 0;
  for (int k = 0; k < R; ++k) {
    const double ak = a[k];
    const double ap = fmax(ak, 0.0);
    rc = __dadd_rn(rc, ak);
    pc = __dadd_rn(pc, ap);
    if (!feas && rc >= W) { feas = true; *k_first = k; }
    if (!full && pc >= W) { full = true; *j_last = k; }
    take[k] = fmin(fmax(__dsub_rn(W, __dsub_rn(pc, ap)), 0.0), ap);
  }
  return feas;
}

}  // namespace sched
