// Quorum-commit kernel for Hopper (sm_90a): phase 10 of the device tick.
//
// Replaces the Pallas TPU kernel quorum_commit_pallas / _kernel in
// rafting_tpu/ops/quorum.py (pallas_call at line 231).  On the TPU the
// group axis rode the 128 lanes in [P, R, 128] tiles of 8-row blocks; here
// one launch covers the whole cluster (N * G lanes) every tick, and the
// per-lane body (the sorting network of quorum_commit.cuh) runs in
// registers.
//
// What bounds it on this card: bytes.  Each lane reads P match ints, five
// int32 lanes and one bool, and writes one int32: (P + 6) * 4 + 1 bytes,
// 11.1 MB at [3, 100000, 3], 3.3 us at 3.35 TB/s.  The work is one pass of
// streamed int32 with no reuse and no matrix product, so shared memory,
// TMA and wgmma have nothing to offer.  One thread owns one lane, 256 a
// block: at the main path's sizes the launch is about one wave of
// threads.  Four lanes a thread in 16-byte accesses, two lanes a thread,
// a cap on the blocks per SM and read-only no-L1-allocate loads were
// each measured on the H100 against this design and none was faster
// (PERF.md, kernel table).  The launch uses programmatic dependent
// launch: the grid is set up while the previous kernel drains and waits
// for its writes before the first load, which took ~1.5 us off every
// shape.  A launch whose operands are not all dense (a transposed lane)
// reads every lane through its strides instead; nothing is copied first.
//
// Interface: plain C, loaded with ctypes (rafting_tpu_torch/ops/_build.py).
// qc_launch takes the wrapper's packed descriptor (quorum_commit.cuh
// qc_parse), checks the operands' shapes and launches on the caller's
// stream.  It returns the path it launched (0 dense, 1 strided), -1 - k
// for a bad operand k, or -1000 - e for CUDA error e.

#include <cuda_runtime.h>

#include "quorum_commit.cuh"

template <int P>
__global__ void __launch_bounds__(256) qc_kernel(const QcArgs a) {
  // Under programmatic dependent launch the grid may start while the
  // previous kernel drains: wait for its writes before the first read.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  qc_thread<P>(a, (long long)blockIdx.x * blockDim.x + threadIdx.x,
               (long long)gridDim.x * blockDim.x);
}

extern "C" int qc_launch(const long long* desc, void* stream) {
  QcArgs a;
  const int bad = qc_parse(desc, &a);
  if (bad != 0) return bad;
  const int path = a.dense ? 0 : 1;
  const long long n = a.N * a.G;
  if (n <= 0) return path;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (a.P) {
#define QC_LAUNCH(N) \
  case N:            \
    err = cudaLaunchKernelEx(&cfg, qc_kernel<N>, a); \
    break;
    QC_LAUNCH(1) QC_LAUNCH(2) QC_LAUNCH(3) QC_LAUNCH(4) QC_LAUNCH(5)
    QC_LAUNCH(6) QC_LAUNCH(7) QC_LAUNCH(8) QC_LAUNCH(9) QC_LAUNCH(10)
#undef QC_LAUNCH
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err == cudaSuccess ? path : -1000 - (int)err;
}

// ------------------------------------------------------------------------
// The first design (one thread a lane, scalar loads at a P-int stride, one
// block per 256 lanes), kept only so chip_smoke.py can time it beside the
// kernel above in the same run.  It takes contiguous operands and is never
// reached from the port's quorum_commit.

template <int P>
__global__ void __launch_bounds__(256)
qc_kernel_v1(const int32_t* __restrict__ match,
             const int32_t* __restrict__ own_from,
             const int32_t* __restrict__ last,
             const int32_t* __restrict__ commit,
             const uint8_t* __restrict__ can_lead,
             const int32_t* __restrict__ voters,
             const int32_t* __restrict__ voters_new,
             int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = qc_commit_one<P>(match + i * P, own_from[i], last[i], commit[i],
                            can_lead[i] != 0, voters[i], voters_new[i]);
}

extern "C" int qc_launch_v1(const long long* desc, void* stream) {
  QcArgs a;
  const int bad = qc_parse(desc, &a);
  if (bad != 0) return bad;
  if (!a.dense) return -1000 - (int)cudaErrorInvalidValue;   // dense only
  const long long n = a.N * a.G;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.P) {
#define QC_LAUNCH(N)                                                      \
  case N:                                                                 \
    qc_kernel_v1<N><<<blocks, 256, 0, s>>>(a.match, a.own_from, a.last,   \
                                           a.commit, a.can_lead, a.voters, \
                                           a.voters_new, a.out, n);        \
    break;
    QC_LAUNCH(1) QC_LAUNCH(2) QC_LAUNCH(3) QC_LAUNCH(4) QC_LAUNCH(5)
    QC_LAUNCH(6) QC_LAUNCH(7) QC_LAUNCH(8) QC_LAUNCH(9) QC_LAUNCH(10)
#undef QC_LAUNCH
    default:
      return -1;
  }
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : -1000 - (int)err;
}
