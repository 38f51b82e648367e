"""The CUDA quorum-commit kernel's per-group body, compiled for the CPU.

``rafting_tpu_torch/ops/csrc/quorum_commit.cuh`` holds the kernel's body
as a ``__host__ __device__`` function; here g++ compiles it into a small
shared library with a C loop over lanes, and the result is held bit for
bit against the port's plain version ``quorum_commit_ref`` for every peer
count the kernel takes (1..10), on random, joint and empty-mask lanes.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rafting_tpu_torch.ops.quorum import quorum_commit_ref

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "rafting_tpu_torch", "ops", "csrc")

HARNESS = r"""
#include "quorum_commit.cuh"
extern "C" void qc_host(int P, const int32_t* match, const int32_t* own_from,
                        const int32_t* last, const int32_t* commit,
                        const uint8_t* can_lead, const int32_t* voters,
                        const int32_t* voters_new, int32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = qc_commit_lane(P, match + i * P, own_from[i], last[i], commit[i],
                            can_lead[i] != 0, voters[i], voters_new[i]);
}
"""


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
    lib.qc_host.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + \
        [ctypes.c_long]
    lib.qc_host.restype = None
    return lib


def _case(rng, G, P, L=64):
    base = rng.integers(0, 5, G)
    last = base + rng.integers(0, L - 5, G)
    match = rng.integers(0, L, (G, P))
    match[:, 0] = last
    commit = np.minimum(rng.integers(0, L, G), last)
    own_from = rng.integers(0, L + 4, G)
    lead = rng.random(G) < 0.7
    full = (1 << P) - 1
    voters = rng.integers(1, full + 1, G)
    vnew = np.where(rng.random(G) < 0.5, rng.integers(1, full + 1, G), 0)
    voters[:8] = 0          # empty voter masks (no quorum ever)
    vnew[4:8] = rng.integers(1, full + 1, 4)   # ... some of them joint
    lead[:8] = True
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return (i32(match), i32(own_from), i32(last), i32(commit),
            np.ascontiguousarray(lead, dtype=np.uint8), i32(voters),
            i32(vnew))


@pytest.mark.parametrize("P", list(range(1, 11)))
def test_kernel_body_matches_plain_version(host_lib, P):
    rng = np.random.default_rng(100 + P)
    G = 4000
    args = _case(rng, G, P)
    out = np.empty(G, np.int32)
    host_lib.qc_host(P, *(a.ctypes.data for a in args), out.ctypes.data, G)
    t = [torch.from_numpy(a) for a in args]
    t[4] = t[4].to(torch.bool)
    ref = quorum_commit_ref(*t).numpy()
    np.testing.assert_array_equal(out, ref)
