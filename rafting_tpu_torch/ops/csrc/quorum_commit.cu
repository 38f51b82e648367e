// Quorum-commit kernel for Hopper (sm_90a): phase 10 of the device tick.
//
// Replaces the Pallas TPU kernel quorum_commit_pallas / _kernel in
// rafting_tpu/ops/quorum.py (pallas_call at line 231).  On the TPU the
// group axis rode the 128 lanes in [P, R, 128] tiles of 8-row blocks; here
// one thread owns one (node, group) lane of the batched step, so a single
// launch covers the whole cluster (N * G lanes) every tick.  The thread
// reads its P contiguous match ints straight from the [N, G, P] layout as
// stored (no transpose copy), runs the sorting network of
// quorum_commit.cuh in registers and writes one int32.
//
// What bounds it on this card: memory.  Each lane reads P match ints and
// five int32 lanes plus one bool, and writes one int32 — about (P + 7) * 4
// bytes, ~12 MB at 300k lanes and P = 3, a few microseconds at HBM
// bandwidth; in practice one launch is bound by launch latency.  The
// strided per-thread match read (P ints per thread) is served by whole
// cache lines shared between neighbouring threads.  Making it fast (a
// fused tick, CUDA-graph capture) is later work.
//
// Interface: plain C, loaded with ctypes (rafting_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "quorum_commit.cuh"

template <int P>
__global__ void __launch_bounds__(256)
qc_kernel(const int32_t* __restrict__ match, const int32_t* __restrict__ own_from,
          const int32_t* __restrict__ last, const int32_t* __restrict__ commit,
          const uint8_t* __restrict__ can_lead, const int32_t* __restrict__ voters,
          const int32_t* __restrict__ voters_new, int32_t* __restrict__ out,
          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = qc_commit_one<P>(match + i * P, own_from[i], last[i], commit[i],
                            can_lead[i] != 0, voters[i], voters_new[i]);
}

extern "C" int qc_launch(int P, const void* match, const void* own_from,
                         const void* last, const void* commit,
                         const void* can_lead, const void* voters,
                         const void* voters_new, void* out, long long n,
                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* m = (const int32_t*)match;
  const int32_t* of = (const int32_t*)own_from;
  const int32_t* la = (const int32_t*)last;
  const int32_t* co = (const int32_t*)commit;
  const uint8_t* cl = (const uint8_t*)can_lead;
  const int32_t* vo = (const int32_t*)voters;
  const int32_t* vn = (const int32_t*)voters_new;
  int32_t* o = (int32_t*)out;
  switch (P) {
#define QC_LAUNCH(N)                                                     \
  case N:                                                                \
    qc_kernel<N><<<blocks, threads, 0, s>>>(m, of, la, co, cl, vo, vn, o, n); \
    break;
    QC_LAUNCH(1) QC_LAUNCH(2) QC_LAUNCH(3) QC_LAUNCH(4) QC_LAUNCH(5)
    QC_LAUNCH(6) QC_LAUNCH(7) QC_LAUNCH(8) QC_LAUNCH(9) QC_LAUNCH(10)
#undef QC_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
