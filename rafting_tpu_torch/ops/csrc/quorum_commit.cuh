// Per-group body of the quorum-commit kernel, shared by the CUDA launcher
// (quorum_commit.cu) and a CPU harness compiled with g++ (the tests), so
// the kernel's arithmetic is checked against the plain PyTorch version
// (rafting_tpu_torch/ops/quorum.py quorum_commit_ref) on a machine without
// a card.
//
// For one Raft group it computes the leader's new commit index:
//   1. the majority order statistic of the match row over the voter
//      bitmask: non-voters become -1, an odd-even transposition network
//      sorts the P values in registers, and the statistic sits at
//      position P - (popcount // 2 + 1), clipped to [0, P-1];
//   2. while joint (voters_new != 0), the min with the same statistic
//      over voters_new;
//   3. the full-replication lane: min of match over the slots of both
//      voter sets;
//   4. the gates can_lead, q > commit, q >= own_from, q <= last (and
//      full > commit, full <= last for the full lane);
//   5. the monotone max into commit.
// Everything is int32; there is no float math, so the result is exact.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define QC_HD __host__ __device__ __forceinline__
#else
#define QC_HD inline
#endif

// Every loop below has a trip count fixed by the template parameter P, so
// nvcc unrolls them fully on its own and v[] stays in registers.  Do not
// add "#pragma unroll": with it, nvcc 12.8 for sm_90a miscompiled this
// body (wrong commits on ~30% of P=3 lanes, as if each loop ran once),
// while the same header without it, or with ptxas -O0, was exact.

QC_HD int32_t qc_min(int32_t a, int32_t b) { return a < b ? a : b; }
QC_HD int32_t qc_max(int32_t a, int32_t b) { return a > b ? a : b; }
QC_HD void qc_cswap(int32_t& a, int32_t& b) {
  const int32_t lo = qc_min(a, b);
  b = qc_max(a, b);
  a = lo;
}

template <int P>
QC_HD int32_t qc_order_stat(const int32_t (&m)[P], int32_t word) {
  int32_t v[P];
  int nv = 0;
  for (int p = 0; p < P; ++p) {
    const int bit = (word >> p) & 1;
    v[p] = bit ? m[p] : -1;
    nv += bit;
  }
  // Odd-even transposition network: P alternating phases (even pairs,
  // then odd pairs) sort P values.
  for (int r = 0; r < P; ++r) {
    for (int i = 0; i + 1 < P; ++i)
      if ((i & 1) == (r & 1)) qc_cswap(v[i], v[i + 1]);
  }
  int pos = P - (nv / 2 + 1);
  pos = pos < 0 ? 0 : (pos > P - 1 ? P - 1 : pos);
  // A static select chain keeps v[] in registers (no dynamic indexing).
  int32_t q = v[0];
  for (int p = 1; p < P; ++p) q = (pos == p) ? v[p] : q;
  return q;
}

template <int P>
QC_HD int32_t qc_commit_one(const int32_t* match, int32_t own_from,
                            int32_t last, int32_t commit, bool can_lead,
                            int32_t voters, int32_t voters_new) {
  int32_t m[P];
  for (int p = 0; p < P; ++p) m[p] = match[p];
  int32_t q = qc_order_stat<P>(m, voters);
  if (voters_new != 0) q = qc_min(q, qc_order_stat<P>(m, voters_new));
  const int32_t both = voters | voters_new;
  int32_t full = INT32_MAX;
  for (int p = 0; p < P; ++p)
    if ((both >> p) & 1) full = qc_min(full, m[p]);
  const bool can = can_lead && q > commit && q >= own_from && q <= last;
  const bool can_full = can_lead && full > commit && full <= last;
  return qc_max(can ? q : commit, can_full ? full : commit);
}

// Runtime-P entry for one lane (the host harness loops it; the CUDA
// launcher switches on P once per launch instead).
QC_HD int32_t qc_commit_lane(int P, const int32_t* match, int32_t own_from,
                             int32_t last, int32_t commit, bool can_lead,
                             int32_t voters, int32_t voters_new) {
  switch (P) {
#define QC_CASE(N) \
  case N:          \
    return qc_commit_one<N>(match, own_from, last, commit, can_lead, voters, voters_new);
    QC_CASE(1) QC_CASE(2) QC_CASE(3) QC_CASE(4) QC_CASE(5)
    QC_CASE(6) QC_CASE(7) QC_CASE(8) QC_CASE(9) QC_CASE(10)
#undef QC_CASE
    default:
      return commit;
  }
}
