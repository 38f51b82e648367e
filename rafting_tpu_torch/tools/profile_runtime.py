"""Profile the port's durable-runtime host path.

    python -m rafting_tpu_torch.tools.profile_runtime [n_groups] [rounds] [--device cpu]

The twin of the repo's ``tools/profile_runtime.py``: one scale of the
port's ``tools/bench_runtime.run`` under cProfile (on the card unless
``--device cpu``), the top functions by cumulative and by self time
printed, and both tables saved with the bench result as a ``PhaseLog``
artifact (``profile_runtime_<platform>_<seq>.json.gz`` under
``_artifact.ARTIFACT_DIR``; platform ``cuda`` or ``cpu``), so the shape
of the host path can be diffed between runs.  cProfile adds a cost to
every Python call and none to native work, so it finds candidates; the
benchmark measures them.

On Python 3.12 cProfile records every thread into one table (the WAL,
checkpoint and transport threads beside the tick thread), so its
cumulative column mixes threads.  A second run of the same scale,
without cProfile, therefore samples the tick thread's stack every
``SAMPLE_S`` during the loaded rounds (``bench_runtime.run``'s
``tick_round`` and ``offer``) and splits the wall time of ``RaftNode.tick``
by the method it was in (``_dispatch``, ``_fetch``, ``_host_phase``, ...)
and the two package frames below it: the per-tick time outside the
named stages, which ``_host_phase`` (wal, fsync, send, apply, reads,
maintain) and ``_fetch``'s ``to_host`` (scan_wait) make up, is the
rest.  Printed as ``[tick split]`` lines and saved as the artifact's
``tick_split`` phase.
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import sys
import threading
import time
from collections import Counter

TOP_N = 35
SAMPLE_S = 0.002
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BENCH = os.path.join(_PKG, "tools", "bench_runtime.py")
_NODE = os.path.join(_PKG, "runtime", "node.py")
# The step's buffer carrying (runtime/step_graph.py) is left out of the
# chains: below _dispatch they name node_step itself where it runs
# uncaptured, and a graph replay counts to _dispatch.
_STEP_GRAPH = os.path.join(_PKG, "runtime", "step_graph.py")


def top_rows(stats: pstats.Stats, key: str, n: int = TOP_N) -> list:
    """The top ``n`` functions by ``key`` as JSON-ready rows."""
    stats.sort_stats(key)
    rows = []
    for func in stats.fcn_list[:n]:
        cc, nc, tt, ct, _callers = stats.stats[func]
        fname, line, name = func
        rows.append({
            "func": f"{fname}:{line}({name})",
            "ncalls": nc,
            "primitive_calls": cc,
            "tottime_s": round(tt, 6),
            "cumtime_s": round(ct, 6),
        })
    return rows


def _chain(frame):
    """Where a tick-thread sample falls: ``("tick", f1, f2, f3)`` with
    the package functions below ``RaftNode.tick``, ``("offer", ...)`` in
    the bench's offer loop, or None outside the loaded rounds."""
    stack = []
    while frame is not None:
        stack.append(frame.f_code)
        frame = frame.f_back
    stack.reverse()                      # outermost first
    root = next((i for i, c in enumerate(stack)
                 if c.co_filename == _BENCH
                 and c.co_name in ("tick_round", "offer")), None)
    if root is None:
        return None
    below = stack[root + 1:]
    if stack[root].co_name == "tick_round":
        at = next((i for i, c in enumerate(below)
                   if c.co_filename == _NODE and c.co_name == "tick"), None)
        if at is None:
            return None
        below = below[at + 1:]
    names = [c.co_name for c in below if c.co_filename.startswith(_PKG)
             and c.co_filename != _STEP_GRAPH]
    return (stack[root].co_name.replace("tick_round", "tick"),
            *names[:3])


class TickSampler:
    """Samples one thread's stack every ``SAMPLE_S`` from a thread of its
    own; each sample is weighted by the wall time since the last one."""

    def __init__(self, ident: int):
        self.ident = ident
        self.seconds: Counter = Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tick-sampler")

    def _loop(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(SAMPLE_S):
            now = time.perf_counter()
            key = _chain(sys._current_frames().get(self.ident))
            if key is not None:
                self.seconds[key] += now - last
            last = now

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def tick_split(seconds: Counter, node_ticks: int) -> dict:
    """ms per node tick by the method of ``RaftNode.tick`` (level 1) and
    the 20 heaviest three-frame chains."""
    level1: Counter = Counter()
    for key, v in seconds.items():
        level1[key[:2]] += v
    ms = lambda v: round(v / node_ticks * 1e3, 3)
    return {
        "node_ticks": node_ticks,
        "ms_per_tick": {"/".join(k): ms(v) for k, v in level1.most_common()},
        "top_chains": [["/".join(k), ms(v)]
                       for k, v in seconds.most_common(20)],
    }


def main(argv=None) -> None:
    from ..core.types import resolve_device
    from . import _artifact
    from .bench_runtime import run

    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else "?"
        del args[i:i + 2]
    dev = resolve_device(device)
    n_groups = int(args[0]) if len(args) > 0 else 32_768
    rounds = int(args[1]) if len(args) > 1 else 0
    log = _artifact.PhaseLog("profile_runtime", seed=0,
                             config={"n_groups": n_groups, "rounds": rounds,
                                     "device": dev.type})
    prof = cProfile.Profile()
    prof.enable()
    res = run(n_groups=n_groups, rounds=rounds, device=dev)
    prof.disable()
    print(json.dumps(res), flush=True)
    log.phase("bench", commits_per_sec=res["value"],
              rounds=res["rounds"],
              p99_tick_s=res["tick_latency"].get("p99_s", 0),
              tick_stages_mean_s=res["tick_stages_mean_s"])
    st = pstats.Stats(prof)
    for key in ("cumulative", "tottime"):
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats(key).print_stats(TOP_N)
        print(f"\n==== top by {key} ====")
        # Drop the header boilerplate, keep the table.
        lines = s.getvalue().splitlines()
        start = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
        print("\n".join(lines[start - 2:start + 40]))
        rows = top_rows(st, key)
        log.phase(f"top_{key}", shown=len(rows))
        log.phases[-1]["rows"] = rows

    # The split of the tick thread's wall time, from a run without
    # cProfile.
    with TickSampler(threading.get_ident()) as sampler:
        res2 = run(n_groups=n_groups, rounds=rounds, device=dev)
    split = tick_split(sampler.seconds, 3 * (5 + res2["rounds"]))
    print(json.dumps(res2), flush=True)
    for k, v in split["ms_per_tick"].items():
        print(f"[tick split] {v:10.3f} ms/tick  {k}")
    for k, v in split["top_chains"]:
        print(f"[tick split]   {v:10.3f} ms/tick  {k}")
    log.phase("tick_split", commits_per_sec=res2["value"],
              tick_stages_mean_s=res2["tick_stages_mean_s"],
              tick_latency=res2["tick_latency"], **split)
    log.save(platform=dev.type)


if __name__ == "__main__":
    main()
