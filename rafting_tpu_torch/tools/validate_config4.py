"""BASELINE config 4 on the port: 100k groups x 5 peers, AppendEntries and
RequestVote under a partition, with the in-step invariant checks on
(``EngineConfig.debug_checks``).  The twin of the repo's
``tools/validate_config4.py``.

    python -m rafting_tpu_torch.tools.validate_config4 [n_groups] [--device cpu]

The scenario, step by step: elect and replicate for 60 ticks under four
submissions per group and tick; partition the cluster into a majority
{0, 1, 2} and a minority {3, 4} and run up to six windows of 30 ticks,
recording after each the share of groups whose commit index on the
majority side moved past its value at the cut (``progressed_pct``), until
every group has; heal, run 60 loaded and 15 idle ticks.  It asserts one
leader per group after the election, progress in every group under the
partition and again after the heal.  Same-term split brain is checked at
every tick by ``DeviceCluster._debug_check`` (``debug_checks=True``), so
reaching the end is the safety result.

It runs on the card unless ``--device cpu`` is given (with no card it
exits non-zero).  Each phase record carries its wall time and ms/tick
(host wall; every tick reads the state back for the split-brain check);
the artifact, written through ``_artifact.PhaseLog``, names the device as
nvidia-smi gives its name and power limit.  The reference measured on a
TPU v5e (its docstring): 95.7% of the groups progressed within 30
partitioned ticks, 100% by 120; those are protocol outcomes of that run,
printed beside the port's and gated on by neither.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import _artifact
from .bench import device_label

SEED = 4
SUBMIT = 4
WINDOW, MAX_WINDOWS = 30, 6
# The reference run's outcomes on its TPU (tools/validate_config4.py:6-9).
TPU_PROGRESSED_PCT = {30: 95.7, 120: 100.0}


def config4_cfg(n_groups: int):
    from ..core.types import EngineConfig
    return EngineConfig(n_groups=n_groups, n_peers=5, log_slots=64, batch=8,
                        max_submit=8, election_ticks=10, heartbeat_ticks=3,
                        rpc_timeout_ticks=8, debug_checks=True)


def run_config4(n_groups: int = 100_000, device=None, seed: int = SEED):
    """Run the scenario; returns ``(plog, cluster)``: the ``PhaseLog``
    holding the phase records (``plog.phases``, also printed) and the
    final ``DeviceCluster``."""
    from ..core.cluster import DeviceCluster
    from ..core.types import LEADER

    cfg = config4_cfg(n_groups)
    c = DeviceCluster(cfg, seed=seed, device=device)
    cuda = c.device.type == "cuda"
    plog = _artifact.PhaseLog(
        "config4", seed=seed,
        config={"n_groups": n_groups, "n_peers": 5, "log_slots": 64,
                "batch": 8, "max_submit": 8, "submit_n": SUBMIT,
                "debug_checks": True, "device": device_label(c.device)})

    def ticks(n: int, submit_n=SUBMIT) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            c.tick(submit_n=submit_n)
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    secs = ticks(60)
    roles = c.states.role.cpu().numpy()
    if not ((roles == LEADER).sum(axis=0) == 1).all():
        raise AssertionError("not one leader per group after the election")
    commit0 = c.states.commit.amax(dim=0).cpu().numpy()
    if not (commit0 > 0).all():
        raise AssertionError("a group committed nothing in 60 ticks")
    plog.phase("elect+replicate", groups=n_groups, peers=5,
               elapsed_s=secs, ms_per_tick=secs / 60 * 1e3,
               committed=int(commit0.astype(np.int64).sum()))

    # Cut off a 2-node minority: the 3-node majority keeps committing
    # (groups whose leader is in the minority re-elect behind the cut).
    c.set_partition([[0, 1, 2], [3, 4]])
    commit1 = commit0
    for k in range(MAX_WINDOWS):
        secs = ticks(WINDOW)
        commit1 = c.states.commit[:3].amax(dim=0).cpu().numpy()
        frac = float((commit1 > commit0).mean())
        n = WINDOW * (k + 1)
        plog.phase("partitioned", ticks=n,
                   progressed_pct=round(frac * 100, 3),
                   tpu_progressed_pct=TPU_PROGRESSED_PCT.get(n),
                   elapsed_s=secs, ms_per_tick=secs / WINDOW * 1e3)
        if frac == 1.0:
            break
    if not (commit1 > commit0).all():
        raise AssertionError(f"stuck groups under the partition: "
                             f"{int((commit1 <= commit0).sum())}")

    c.heal()
    secs = ticks(60) + ticks(15, None)
    commit2 = c.states.commit.amax(dim=0).cpu().numpy()
    if not (commit2 > commit1).all():
        raise AssertionError(f"groups without progress after the heal: "
                             f"{int((commit2 <= commit1).sum())}")
    plog.phase("healed", committed=int(commit2.astype(np.int64).sum()),
               commits_after_heal=int((commit2 - commit1).astype(
                   np.int64).sum()),
               split_brain=0, elapsed_s=secs, ms_per_tick=secs / 75 * 1e3)
    return plog, c


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else "?"
        del args[i:i + 2]
    G = int(args[0]) if args else 100_000
    t0 = time.perf_counter()
    if device is None and not torch.cuda.is_available():
        raise SystemExit("validate_config4: no CUDA device (pass --device "
                         "cpu to run on the CPU)")
    dev = torch.device(device or "cuda")
    plog, _ = run_config4(G, dev)
    plog.save("gpu" if dev.type == "cuda" else "cpu")
    print(f"config-4 OK on {plog.config['device']}: no same-term split "
          f"brain, all {G} groups progressed; total "
          f"{time.perf_counter() - t0:.1f}s, committed="
          f"{plog.phases[-1]['committed']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
