"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Builds go to
``rafting_tpu_torch/ops/_build/<name>-<hash>/``, keyed on a hash of the
sources and flags, at first use.  A failed build raises; nothing falls
back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# name -> (sources compiled, headers hashed, C entry points with argtypes)
_P = ctypes.c_void_p
KERNELS = {
    "quorum_commit": (
        ["quorum_commit.cu"], ["quorum_commit.cuh"],
        {"qc_launch": ([ctypes.c_char_p, _P], ctypes.c_int),
         "qc_launch_v1": ([ctypes.c_char_p, _P], ctypes.c_int)},
    ),
}

_lock = threading.Lock()
_loaded: dict = {}
# name -> {"seconds": build wall time, "log": nvcc/ptxas output}
build_info: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest(name: str) -> str:
    srcs, hdrs, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for f in srcs + hdrs:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile kernel ``name`` if its library is not built yet; return
    the library path."""
    srcs, _, _ = KERNELS[name]
    out_dir = os.path.join(BUILD_DIR, f"{name}-{_digest(name)}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ([nvcc_path()] + ARCH_FLAGS + NVCC_FLAGS + ["-I", CSRC, "-o", tmp]
           + [os.path.join(CSRC, s) for s in srcs])
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)       # atomic: a concurrent loader sees all or none
    build_info[name] = {"seconds": secs, "log": res.stderr + res.stdout}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in KERNELS[name][2].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return _loaded[name]
