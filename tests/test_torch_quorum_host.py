"""The CUDA quorum-commit kernel's body and addressing, compiled for the CPU.

``rafting_tpu_torch/ops/csrc/quorum_commit.cuh`` holds the kernel's per-lane
body and the way one launch walks its operands (the descriptor check, then
every lane at its dense index or through its strides) as host-callable
code; here g++ compiles it into a small shared library that runs a whole
launch thread by thread.  Its result is held bit for bit against the
port's plain version ``quorum_commit_ref`` for every peer count the kernel
takes (1..10), at several lane counts, on dense, transposed, misaligned
and padded operands, through the port's own descriptor packing
(``ops/quorum.py`` ``_launch``).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rafting_tpu_torch.ops import quorum as tq
from rafting_tpu_torch.ops.quorum import quorum_commit_ref

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "rafting_tpu_torch", "ops", "csrc")

HARNESS = r"""
#include "quorum_commit.cuh"
// Parse the descriptor as the CUDA launcher does, then run the launch on
// `nthreads` host "threads".  Returns what qc_launch returns: the path
// (0 dense, 1 strided) or qc_parse's code for a bad operand.
extern "C" int qc_run(const char* desc, long long nthreads) {
  QcArgs a;
  const int bad = qc_parse((const long long*)desc, &a);
  if (bad != 0) return bad;
  qc_run_host(a, nthreads);
  return a.dense ? 0 : 1;
}
"""

# Lane counts as [N, G]: 1..9, N > 1 where the count allows it, and two
# counts past a thousand.
SHAPES = [(1, 1), (2, 1), (1, 3), (2, 2), (1, 5), (3, 2), (1, 7), (2, 4),
          (3, 3), (7, 143), (1, 4097)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("qc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "libqc_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", os.path.abspath(CSRC), str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.qc_run.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.qc_run.restype = ctypes.c_int
    return lib


def _case(rng, shape, P, L=64):
    """Random matches, own_from on both sides of the ring, ~70% leading
    lanes, random voter sets, ~half the lanes joint; the first lanes get
    an empty voter mask (no quorum ever), some of them joint."""
    base = rng.integers(0, 5, shape)
    last = base + rng.integers(0, L - 5, shape)
    match = rng.integers(0, L, shape + (P,))
    match[..., 0] = last
    commit = np.minimum(rng.integers(0, L, shape), last)
    own_from = rng.integers(0, L + 4, shape)
    lead = rng.random(shape) < 0.7
    full = (1 << P) - 1
    voters = rng.integers(1, full + 1, shape)
    vnew = np.where(rng.random(shape) < 0.5,
                    rng.integers(1, full + 1, shape), 0)
    flat = [a.reshape(-1) for a in (voters, vnew, lead)]
    k = min(8, flat[0].size)
    flat[0][:k] = 0
    flat[1][k // 2:k] = rng.integers(1, full + 1, k - k // 2)
    flat[2][:k] = True
    return (match, own_from, last, commit, lead, voters, vnew)


def _lay_out(a: np.ndarray, layout: str, dtype) -> torch.Tensor:
    """``a`` as a tensor stored dense, transposed ([G, N] lanes, [P, G, N]
    match), one element past a 16-byte boundary, or as a slice of rows
    one element longer."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if layout == "strided":
        return t.permute(*range(t.dim() - 1, -1, -1)).contiguous() \
            .permute(*range(t.dim() - 1, -1, -1))
    if layout == "offset":
        buf = torch.zeros(t.numel() + 1, dtype=dtype)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    if layout == "padded":
        buf = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=dtype)
        buf[..., :-1] = t
        return buf[..., :-1]
    return t


@pytest.mark.parametrize("layout", ["dense", "strided", "offset", "padded"])
@pytest.mark.parametrize("P", list(range(1, 11)))
def test_kernel_body_matches_plain_version(host_lib, P, layout):
    rng = np.random.default_rng(100 + P)
    for shape in SHAPES:
        case = _case(rng, shape, P)
        args = [_lay_out(a, layout, torch.bool if k == 4 else torch.int32)
                for k, a in enumerate(case)]
        ref = quorum_commit_ref(*args)
        for nthreads in (1, 3, 64):
            out = torch.full(shape, -7, dtype=torch.int32)
            path = tq._launch(
                lambda desc, stream: host_lib.qc_run(desc, nthreads), 0,
                out, *args)
            # The dense path exactly when every operand is dense (a
            # transposed 1 x G lane is still dense, and so is match when
            # P = 1 and N = 1), whatever its alignment.
            dense = all(t.is_contiguous() for t in args)
            assert path == int(not dense), (shape, layout)
            np.testing.assert_array_equal(
                out.numpy(), ref.numpy(),
                err_msg=f"{shape}, {nthreads} threads")


@pytest.mark.parametrize("k", range(7))
def test_launcher_names_bad_operand(host_lib, k):
    """A shape the C launcher refuses comes back as a ValueError naming
    the operand: a wrong [N, G] (or P out of 1..10 for match_full), and a
    wrong rank, which the descriptor has no room for."""
    case = _case(np.random.default_rng(7), (2, 5), 3)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bool if j == 4 else torch.int32) for j, a in enumerate(case)]
    out = torch.empty((2, 5), dtype=torch.int32)
    run = lambda desc, stream: host_lib.qc_run(desc, 3)
    bad = list(args)
    bad[k] = torch.zeros((2, 5, 11) if k == 0 else (2, 6),
                         dtype=args[k].dtype)
    with pytest.raises(ValueError, match=rf"\b{tq._OPERANDS[k]} has shape"):
        tq._launch(run, 0, out, *bad)
    bad[k] = args[k].reshape(-1)
    with pytest.raises(ValueError, match=rf"\b{tq._OPERANDS[k]} has shape"):
        tq._launch(run, 0, out, *bad)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tq._launch(lambda desc, stream: -1700, 0, out, *args)
    tq._launch(run, 0, out, *args)
    np.testing.assert_array_equal(out.numpy(),
                                  quorum_commit_ref(*args).numpy())


@pytest.mark.parametrize("path", ["headline", "nemesis"])
def test_tick_hands_the_kernel_dense_operands(monkeypatch, path):
    """Every operand phase 10 of the tick hands the kernel is dense in
    [N, G(, P)] order, so the kernel takes its dense path: the headline
    deployment's ticks under load and the nemesis deployment's under
    chaos_mix, at a small width, on the CPU (where the strides come out
    as on the card: the step's ops choose output strides the same way on
    both)."""
    import rafting_tpu_torch.core.step as step
    from rafting_tpu_torch import (
        DeviceCluster, EngineConfig, run_cluster_ticks,
        run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.testkit import nemesis

    seen = []
    real = step.quorum_commit

    def spy(cfg, match_full, log, commit, own_from, can_lead, voters,
            voters_new):
        ops = (match_full, own_from, log.last, commit, can_lead, voters,
               voters_new)
        seen.append([n for n, t in zip(tq._OPERANDS, ops)
                     if not t.is_contiguous()])
        return real(cfg, match_full, log, commit, own_from, can_lead,
                    voters, voters_new)
    monkeypatch.setattr(step, "quorum_commit", spy)
    if path == "headline":
        cfg = EngineConfig(n_groups=32, n_peers=3, log_slots=64, batch=8,
                           max_submit=8, election_ticks=10,
                           heartbeat_ticks=3, rpc_timeout_ticks=8,
                           pre_vote=True)
        c = DeviceCluster(cfg, seed=0, device="cpu")
        load = torch.full((3, 32), 8, dtype=torch.int32)
        run_cluster_ticks(cfg, 30, c.states, c.inflight, c.last_info,
                          c.conn, load, device="cpu")
    else:
        cfg = EngineConfig(n_groups=32, n_peers=5, log_slots=64, batch=8,
                           max_submit=8, trace_depth=16, heat=True,
                           check_quorum=True, debug_checks=True)
        sched = nemesis.concat(
            nemesis.chaos_mix(5, 30, seed=13, device="cpu"),
            nemesis.healthy(5, 10, device="cpu"))
        c = DeviceCluster(cfg, seed=13, device="cpu")
        load = torch.full((5, 32), 4, dtype=torch.int32)
        run_cluster_ticks_nemesis(cfg, c.states, c.inflight, c.last_info,
                                  sched, load, device="cpu")
    assert len(seen) >= 30
    assert all(not s for s in seen), next(s for s in seen if s)
