// Per-group body of the quorum-commit kernel and the addressing of one
// launch, shared by the CUDA launcher (quorum_commit.cu) and a CPU harness
// compiled with g++ (the tests), so the kernel's arithmetic and the way it
// walks its operands are checked against the plain PyTorch version
// (rafting_tpu_torch/ops/quorum.py quorum_commit_ref) on a machine without
// a card.
//
// For one Raft group it computes the leader's new commit index:
//   1. the majority order statistic of the match row over the voter
//      bitmask: non-voters become -1, an odd-even transposition network
//      sorts the P values in registers, and the statistic sits at
//      position P - (popcount // 2 + 1), clipped to [0, P-1] (the min of
//      the sorted values from there on);
//   2. while joint (voters_new != 0), the min with the same statistic
//      over voters_new;
//   3. the full-replication lane: min of match over the slots of both
//      voter sets;
//   4. the gates can_lead, q > commit, q >= own_from, q <= last (and
//      full > commit, full <= last for the full lane);
//   5. the monotone max into commit.
// Everything is int32; there is no float math, so the result is exact.
//
// Addressing (qc_parse, qc_thread): the operands arrive as stored, with
// their element strides.  When every operand is dense in [N, G(, P)] order,
// lane i's operands sit at element i (its match row at i * P); otherwise
// (a transposed lane) each lane is read where it lies, through the
// strides.  Nothing is copied first either way.
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
  // v[] is sorted, so v[pos] is the min of v[pos..P-1].  A masked min
  // keeps v[] in registers: a select chain on pos == p was turned into a
  // load from a stack copy of v[] indexed by pos (local memory, two round
  // trips a lane) once the body sat in a grid-stride loop.
  int32_t q = v[P - 1];
  for (int p = 0; p < P - 1; ++p) q = (p >= pos) ? qc_min(q, v[p]) : q;
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

// ------------------------------------------------------------ addressing --

// The operands of one launch as stored.  Strides are in elements.
struct QcArgs {
  const int32_t* match;       // [N, G, P]
  const int32_t* own_from;    // [N, G] each, in this order
  const int32_t* last;
  const int32_t* commit;
  const uint8_t* can_lead;
  const int32_t* voters;
  const int32_t* voters_new;
  int32_t* out;               // [N, G], dense: the wrapper allocates it
  long long N, G;
  int P;
  long long ms[3];            // match's strides
  long long ls[6][2];         // each lane's strides, in the order above
  bool dense;                 // every operand dense in [N, G(, P)] order
};

// The launcher's descriptor, 38 int64 words packed by the wrapper:
// 8 pointers (match, the six lanes, out), match's sizes and strides (3 +
// 3), then each lane's sizes and strides (2 + 2).
enum { QC_DESC_WORDS = 38 };

QC_HD bool qc_lane_dense(long long N, long long G, const long long* s) {
  return (N == 1 || s[0] == G) && (G == 1 || s[1] == 1);
}

// Unpack and check a descriptor.  Returns 0, or -1 - k when operand k
// (0 match_full, 1 own_from, 2 last, 3 commit, 4 can_lead, 5 voters,
// 6 voters_new) has a shape the kernel does not take: match [N, G, P] with
// 1 <= P <= 10, and every lane [N, G].
QC_HD int qc_parse(const long long* d, QcArgs* a) {
  a->match = (const int32_t*)(uintptr_t)d[0];
  a->own_from = (const int32_t*)(uintptr_t)d[1];
  a->last = (const int32_t*)(uintptr_t)d[2];
  a->commit = (const int32_t*)(uintptr_t)d[3];
  a->can_lead = (const uint8_t*)(uintptr_t)d[4];
  a->voters = (const int32_t*)(uintptr_t)d[5];
  a->voters_new = (const int32_t*)(uintptr_t)d[6];
  a->out = (int32_t*)(uintptr_t)d[7];
  a->N = d[8];
  a->G = d[9];
  if (d[10] < 1 || d[10] > 10) return -1;
  a->P = (int)d[10];
  a->ms[0] = d[11];
  a->ms[1] = d[12];
  a->ms[2] = d[13];
  bool dense = (a->N == 1 || a->ms[0] == a->G * a->P) &&
               (a->G == 1 || a->ms[1] == a->P) && (a->P == 1 || a->ms[2] == 1);
  for (int k = 0; k < 6; ++k) {
    const long long* w = d + 14 + 4 * k;
    if (w[0] != a->N || w[1] != a->G) return -2 - k;
    a->ls[k][0] = w[2];
    a->ls[k][1] = w[3];
    dense = dense && qc_lane_dense(a->N, a->G, w + 2);
  }
  a->dense = dense;
  return 0;
}

// One lane of a dense launch.
template <int P>
QC_HD void qc_dense_lane(const QcArgs& a, long long i) {
  a.out[i] = qc_commit_one<P>(a.match + i * P, a.own_from[i], a.last[i],
                              a.commit[i], a.can_lead[i] != 0, a.voters[i],
                              a.voters_new[i]);
}

// One lane read where it lies, through the strides.
template <int P>
QC_HD void qc_strided_lane(const QcArgs& a, long long i) {
  const long long n = i / a.G, g = i - n * a.G;
  const int32_t* row = a.match + n * a.ms[0] + g * a.ms[1];
  int32_t m[P];
  for (int p = 0; p < P; ++p) m[p] = row[p * a.ms[2]];
#define QC_AT(k) (n * a.ls[k][0] + g * a.ls[k][1])
  a.out[i] = qc_commit_one<P>(m, a.own_from[QC_AT(0)], a.last[QC_AT(1)],
                              a.commit[QC_AT(2)], a.can_lead[QC_AT(3)] != 0,
                              a.voters[QC_AT(4)], a.voters_new[QC_AT(5)]);
#undef QC_AT
}

// What thread `tid` of `nthreads` does: the lanes tid, tid + nthreads, ...
// (the CUDA launch has one thread a lane, so at most one).
template <int P>
QC_HD void qc_thread(const QcArgs& a, long long tid, long long nthreads) {
  const long long n = a.N * a.G;
  for (long long i = tid; i < n; i += nthreads) {
    if (a.dense)
      qc_dense_lane<P>(a, i);
    else
      qc_strided_lane<P>(a, i);
  }
}

#if !defined(__CUDACC__)
// The whole launch on the host, thread by thread (the CPU harness).
inline void qc_run_host(const QcArgs& a, long long nthreads) {
  for (long long tid = 0; tid < nthreads; ++tid) {
    switch (a.P) {
#define QC_CASE(N) \
  case N:          \
    qc_thread<N>(a, tid, nthreads); \
    break;
      QC_CASE(1) QC_CASE(2) QC_CASE(3) QC_CASE(4) QC_CASE(5)
      QC_CASE(6) QC_CASE(7) QC_CASE(8) QC_CASE(9) QC_CASE(10)
#undef QC_CASE
    }
  }
}
#endif
