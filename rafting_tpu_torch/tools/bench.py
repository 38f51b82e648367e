"""Headline benchmark of the port: AppendEntries commits/s across up to
100k Raft groups on the card.

    python -m rafting_tpu_torch.tools.bench [scale] [--device cpu]
    python -m rafting_tpu_torch.tools.bench --child G TICKS WARMUP [cpu] [PROFILE_DIR]

The twin of the repo's ``bench.py``: the same ladder, stages, ``BENCH_*``
knobs and JSON lines, over the port's engine.  The full consensus loop
(elections, AppendEntries fan-out over a 3-node cluster, the quorum
commit in the CUDA kernel, slack compaction) runs on the card, every node
batched over all groups.

* Every scale runs in its own subprocess under a hard timeout, so a
  faulting scale costs that scale only; scales escalate 1k (smoke) ->
  4k -> 16k -> 32k -> 65k -> 100k, and a headline line is printed and
  flushed after every scale that passes.
* Above ``BENCH_GROUP_BLOCK`` (32,768) groups a scale runs the
  group-blocked loop (``run_cluster_ticks_blocked``) in equal blocks.
* After the ladder, at the best scale: the read plane (``BENCH_READS``,
  linearizable reads/s under a 90/10 read/write mix), the nemesis
  (``BENCH_NEMESIS``, commits/s under ``chaos_mix``) and the flight
  recorder's overhead (``BENCH_TRACE``), each a separate line.

Where it departs from ``bench.py``:

* It never falls back to the CPU.  With no card it exits non-zero, unless
  the caller passes ``--device cpu``: then it runs the reference's CPU
  shape (one scale, 96 measured and 48 warm-up ticks, the tuned budget
  ``TUNED_ENV``) and every stage after it, labelled ``cpu``.
* It has no ``BENCH_USE_PALLAS`` stage: on the card the port runs its
  quorum kernel on every tick whatever ``use_pallas`` says, so that stage
  would time one program twice.  The flag is recorded in the result.
* ``BENCH_MEMBER``, ``BENCH_LAT``, ``BENCH_HEAT``, ``BENCH_OPENLOOP`` and
  ``BENCH_TXN`` select stages the port has no twin of yet: the twin
  refuses them by name and exits non-zero.

The host fence is ``torch.cuda.synchronize()`` and the read of the
commit total (int64).  On the card the measured window runs under
``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
inside it is a fault.  Each line carries a ``device`` key: the card's
name and power limit as nvidia-smi gives them, or ``cpu``.  The final
stdout line is the last stage's result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial

from . import _artifact

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCALES = (1_024, 4_096, 16_384, 32_768, 65_536, 100_000)
# The repo's north-star target (BASELINE.md: >1M commits/s at 100k
# groups), not a measurement: vs_baseline is the ratio to it.
BASELINE_CPS = 1_000_000
FALSY = ("", "0", "false", "no", "off")
# The tuned pipeline budget of bench.py's CPU run (its 32k-group sweep).
TUNED_ENV = {"BENCH_MAX_SUBMIT": "32", "BENCH_BATCH": "32",
             "BENCH_LOG_SLOTS": "256"}
TUNED_TAG = " [tuned budget S=32/B=32/L=256]"
# bench.py stages with no twin yet: each flag makes the twin exit.
UNPORTED_STAGES = ("BENCH_MEMBER", "BENCH_LAT", "BENCH_HEAT",
                   "BENCH_OPENLOOP", "BENCH_TXN")


def env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in FALSY


def device_label(device) -> str:
    """``cpu``, or the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        lines = smi.stdout.strip().splitlines()
        if smi.returncode == 0 and lines:
            return lines[device.index or 0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    import torch
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def child_run(n_groups: int, measure_ticks: int, warmup_ticks: int,
              device: str = "", profile_dir: str = "") -> dict:
    """One scale, in-process, on the card (``device`` "") or on the CPU
    (``device`` "cpu").  Prints nothing; returns the result dict."""
    import faulthandler
    faulthandler.enable()
    # If anything wedges, dump every thread's stack to stderr before the
    # parent's timeout fires.
    timeout_s = float(os.environ.get("BENCH_CHILD_WATCHDOG", "240"))
    faulthandler.dump_traceback_later(timeout_s, exit=False)
    try:
        return _child_run(n_groups, measure_ticks, warmup_ticks, device,
                          profile_dir)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _child_run(n_groups, measure_ticks, warmup_ticks, device, profile_dir):
    import torch

    from .. import (
        DeviceCluster, EngineConfig, committed_entries, run_cluster_ticks,
        run_cluster_ticks_blocked,
    )
    from ..core.types import LEADER, resolve_device, tree_map

    t_init = time.perf_counter()
    dev = resolve_device(device or None)
    cuda = dev.type == "cuda"
    if cuda:
        torch.empty(1, device=dev)       # creates the context
    init_s = time.perf_counter() - t_init

    n_peers = 3
    # BENCH_NEMESIS=1: commits/s under the three-regime fault schedule
    # (testkit/nemesis.chaos_mix, seed 0) in the measured window; the
    # warm-up stays healthy.
    nemesis_on = env_flag("BENCH_NEMESIS")
    # BENCH_READS=1: the linearizable read plane under a mixed 90/10
    # read/write load (per tick per group one ReadIndex batch of
    # 9*max_submit queries beside max_submit writes).
    reads_on = env_flag("BENCH_READS")
    if reads_on and nemesis_on:
        raise SystemExit("BENCH_READS and BENCH_NEMESIS are mutually "
                         "exclusive: the read stage measures the healthy "
                         "path (a faults-on reads scan does not exist yet)")
    # BENCH_TRACE=1: the flight recorder on (BENCH_TRACE_DEPTH slots).
    trace_on = env_flag("BENCH_TRACE")
    cfg = EngineConfig(
        n_groups=n_groups, n_peers=n_peers,
        log_slots=int(os.environ.get("BENCH_LOG_SLOTS", "64")),
        batch=int(os.environ.get("BENCH_BATCH", "8")),
        max_submit=int(os.environ.get("BENCH_MAX_SUBMIT", "8")),
        election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8,
        pre_vote=True,
        # Recorded only: the port's kernel runs on every CUDA tick.
        use_pallas=env_flag("BENCH_USE_PALLAS"),
        trace_depth=(int(os.environ.get("BENCH_TRACE_DEPTH", "16"))
                     if trace_on else 0),
    )
    # Group-axis tiling, bench.py's rule: above the block size, equal
    # blocks with minimal padding.
    max_block = int(os.environ.get("BENCH_GROUP_BLOCK", "32768"))
    if n_groups > max_block:
        n_blocks = -(-n_groups // max_block)
        block = -(-n_groups // n_blocks)
        run_ticks = partial(run_cluster_ticks_blocked, group_block=block,
                            device=dev)
    else:
        n_blocks = 1
        block = 0
        run_ticks = partial(run_cluster_ticks, device=dev)
    c = DeviceCluster(cfg, seed=0, device=dev)
    submit = torch.full((n_peers, n_groups), cfg.max_submit,
                        dtype=torch.int32, device=dev)

    # Ticks per call, bench.py's chunking.  A blocked call runs every
    # block over the chunk and then folds the keys again, so the chunk
    # sizes are part of the result.
    default_chunk = max(16, 128 // n_blocks)
    chunk = max(1, min(int(os.environ.get("BENCH_TICKS_PER_CALL",
                                          str(default_chunk))),
                       measure_ticks))

    def steps(n_ticks):
        return [min(chunk, n_ticks - d) for d in range(0, n_ticks, chunk)]

    def run_chunks(n_ticks, states, inflight, info):
        for step in steps(n_ticks):
            states, inflight, info = run_ticks(
                cfg, step, states, inflight, info, c.conn, submit)
        return states, inflight, info

    if reads_on:
        from ..core.sim import run_cluster_ticks_reads
        read_load = torch.full((n_peers, n_groups), 9 * cfg.max_submit,
                               dtype=torch.int32, device=dev)
        read_totals = {"served": 0, "lease": 0, "appended": 0}

        def run_reads(step, states, inflight, info):
            return run_cluster_ticks_reads(
                cfg, step, states, inflight, info, c.conn, submit,
                read_load, device=dev)

        def run_chunks_reads(n_ticks, states, inflight, info):
            served = lease = appended = 0
            for step in steps(n_ticks):
                states, inflight, info, sv, lh, ap = run_reads(
                    step, states, inflight, info)
                # Summed on the device, read once after the window.
                served, lease, appended = (served + sv, lease + lh,
                                           appended + ap)
            return states, inflight, info, served, lease, appended

    if nemesis_on:
        from ..core.sim import run_cluster_ticks_nemesis
        from ..testkit import nemesis as _nem
        sched = _nem.chaos_mix(n_peers, measure_ticks, seed=0, device=dev)

        def run_chunks_faulted(states, inflight, info):
            done = 0
            for step in steps(measure_ticks):
                states, inflight, info = run_cluster_ticks_nemesis(
                    cfg, states, inflight, info,
                    tree_map(lambda a: a[done:done + step], sched), submit,
                    device=dev)
                done += step
            return states, inflight, info

    def commit_sum(states):
        if cuda:
            torch.cuda.synchronize(dev)
        return int(committed_entries(states))

    # Warm-up: elect leaders and reach steady-state replication.
    t0 = time.perf_counter()
    states, inflight, info = run_chunks(warmup_ticks, c.states, c.inflight,
                                        c.last_info)
    # bench.py compiles the nemesis and reads scans here, once per step
    # size of the measured window (an all-healthy schedule; the read
    # load).  The port compiles nothing, but runs the same ticks, so the
    # two packages' windows start from the same state.
    for step in sorted(set(steps(measure_ticks))):
        if nemesis_on:
            states, inflight, info = run_cluster_ticks_nemesis(
                cfg, states, inflight, info,
                _nem.healthy(n_peers, step, device=dev), submit, device=dev)
        if reads_on:
            states, inflight, info, *_ = run_reads(step, states, inflight,
                                                   info)
    start_commit = commit_sum(states)
    warm_s = time.perf_counter() - t0

    def measure():
        nonlocal states, inflight, info
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if reads_on:
                states, inflight, info, sv, lh, ap = run_chunks_reads(
                    measure_ticks, states, inflight, info)
            elif nemesis_on:
                states, inflight, info = run_chunks_faulted(
                    states, inflight, info)
            else:
                states, inflight, info = run_chunks(measure_ticks, states,
                                                    inflight, info)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        # The fence (a synchronize and the [N, G] commit read) is part of
        # the measurement.
        commit_sum(states)
        if reads_on:
            read_totals["served"] = int(sv)
            read_totals["lease"] = int(lh)
            read_totals["appended"] = int(ap)
        return time.perf_counter() - t0

    from ..utils.profiling import device_trace
    with device_trace(profile_dir):   # no-op when unset
        elapsed = measure()

    commits = commit_sum(states) - start_commit

    # Exactly one leader per group on the healthy path; after chaos a
    # deposed minority leader may linger at a lower term (legal Raft), so
    # the faulted run asserts at least one somewhere.
    n_lead = (states.role == LEADER).sum(dim=0)
    if nemesis_on:
        assert bool((n_lead >= 1).any()), "no leaders anywhere after chaos"
    else:
        assert bool((n_lead == 1).all()), \
            f"leaders per group: {sorted(set(n_lead.tolist()))}"
    assert commits > 0

    res = {
        "scale": n_groups,
        "platform": dev.type,
        "device": device_label(dev),
        "cps": commits / elapsed,
        "commits": commits,
        "ticks": measure_ticks,
        "elapsed_s": round(elapsed, 4),
        "warmup_s": round(warm_s, 2),
        "init_s": round(init_s, 2),
        "nemesis": nemesis_on,
        "trace_depth": cfg.trace_depth,
        "use_pallas": cfg.use_pallas,
        "n_blocks": n_blocks,
        "group_block": block,
    }
    if trace_on:
        ev = int(states.trace.n.to(torch.int64).sum())
        assert ev > 0, "BENCH_TRACE run recorded zero events"
        res["trace_events"] = ev
    if reads_on:
        assert read_totals["served"] > 0, "read stage served nothing"
        res.update(
            reads=read_totals["served"],
            rps=read_totals["served"] / elapsed,
            lease_hits=read_totals["lease"],
            appended=read_totals["appended"],
            read_mix="90/10",
        )
    return res


def headline(res: dict, tuned: bool = False) -> dict:
    tag = "" if res["platform"] == "cpu" else " on device"
    note = TUNED_TAG if tuned else ""
    if res.get("nemesis"):
        note += " [NEMESIS: three-regime fault schedule on]"
    if res.get("trace_depth"):
        note += f" [TRACE: flight recorder on, depth {res['trace_depth']}]"
    return {
        # The device engine, payload-free: no WAL, no payload bytes, no
        # transport (bench_runtime.py's metric is the durable path).
        "metric": f"AppendEntries commits/sec @{res['scale'] // 1000}k Raft "
                  f"groups (3-node cluster, device engine, "
                  f"payload-free{tag}){note}",
        "value": round(res["cps"]),
        "unit": "commits/sec",
        "vs_baseline": round(res["cps"] / BASELINE_CPS, 3),
        "device": res["device"],
    }


def headline_reads(res: dict) -> dict:
    """Linearizable reads/s under the 90/10 mix.  Its baseline is the
    mix-implied read rate at the commits target (9x BASELINE_CPS)."""
    tag = "" if res["platform"] == "cpu" else " on device"
    return {
        "metric": f"linearizable reads/sec @{res['scale'] // 1000}k Raft "
                  f"groups (ReadIndex+lease, mixed {res['read_mix']} "
                  f"read/write, 3-node cluster, device engine{tag}) "
                  f"[writes rode along at {round(res['cps'])} commits/sec]",
        "value": round(res["rps"]),
        "unit": "reads/sec",
        "vs_baseline": round(res["rps"] / (9 * BASELINE_CPS), 3),
        "device": res["device"],
    }


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def save_artifact(res: dict, child_env: dict | None = None,
                  extra_env: dict | None = None) -> None:
    """Persist one scale's raw result, its knobs and argv as
    ``bench_<platform>_<scale>_<seq>.json`` under the port's
    ``_artifact.ARTIFACT_DIR``.  Best-effort: a failed write never kills
    the bench."""
    try:
        art = _artifact.ARTIFACT_DIR
        os.makedirs(art, exist_ok=True)
        stem = f"bench_{res.get('platform', 'unknown')}_{res.get('scale', 0)}"
        seq = 0
        while os.path.exists(os.path.join(art, f"{stem}_{seq:03d}.json")):
            seq += 1
        doc = {
            "result": res,
            "seed": 0,                       # DeviceCluster(cfg, seed=0)
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            # The child's environment, not the parent's.
            "env": {k: v for k, v in (child_env or os.environ).items()
                    if k.startswith("BENCH_")},
            "extra_env": extra_env or {},
            "argv": sys.argv[1:],
        }
        path = os.path.join(art, f"{stem}_{seq:03d}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        sys.stderr.write(f"[bench] artifact saved: {path}\n")
    except OSError as e:
        sys.stderr.write(f"[bench] artifact save failed: {e}\n")


def run_scale(n_groups: int, measure_ticks: int, warmup_ticks: int,
              timeout_s: float, device: str = "", profile_dir: str = "",
              extra_env: dict | None = None) -> dict | None:
    """Run one scale in a subprocess; return its result dict or None."""
    cmd = [sys.executable, "-m", "rafting_tpu_torch.tools.bench", "--child",
           str(n_groups), str(measure_ticks), str(warmup_ticks), device,
           profile_dir]
    env = dict(os.environ)
    if extra_env:
        env.update(extra_env)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired as e:
        # Keep the child's watchdog dump: it says where the hang was.
        s = e.stderr or ""
        if isinstance(s, bytes):
            s = s.decode(errors="replace")
        tail = "\n".join(s.splitlines()[-25:])
        sys.stderr.write(f"[bench] scale {n_groups}: TIMEOUT after "
                         f"{timeout_s:.0f}s\n{tail}\n")
        return None
    if r.returncode != 0:
        tail = r.stderr.strip().splitlines()[-12:]
        sys.stderr.write(f"[bench] scale {n_groups}: rc={r.returncode}\n" +
                         "\n".join(tail) + "\n")
        return None
    try:
        res = json.loads(r.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        sys.stderr.write(f"[bench] scale {n_groups}: unparseable output: "
                         f"{r.stdout[-500:]!r}\n")
        return None
    save_artifact(res, child_env=env, extra_env=extra_env)
    return res


def _refuse_unported(argv) -> None:
    if argv[:1] == ["--member-child"]:
        raise SystemExit("BENCH_MEMBER: stage not ported yet (ROADMAP "
                         "queue 1 item 5)")
    for name in UNPORTED_STAGES:
        if env_flag(name):
            raise SystemExit(f"{name}: stage not ported yet (ROADMAP "
                             f"queue 1 item 5)")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        n_groups, ticks, warmup = map(int, argv[1:4])
        device = argv[4] if len(argv) > 4 else ""
        profile_dir = argv[5] if len(argv) > 5 else ""
        print(json.dumps(child_run(n_groups, ticks, warmup, device,
                                   profile_dir)))
        return
    _refuse_unported(argv)
    device = ""
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1] if i + 1 < len(argv) else "?"
        del argv[i:i + 2]
        if device not in ("cpu", "cuda"):
            raise SystemExit(f"bench: --device takes cpu or cuda, not "
                             f"{device!r}")
        device = "" if device == "cuda" else device
    if not device:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                "bench: no CUDA device; the twin measures the card and "
                "does not fall back to the CPU (pass --device cpu for a "
                "run labelled cpu)")

    profile_dir = os.environ.get("BENCH_PROFILE_DIR", "")
    only = int(argv[0]) if argv else None
    smoke_timeout = float(os.environ.get("BENCH_SMOKE_TIMEOUT", "420"))
    scale_timeout = float(os.environ.get("BENCH_SCALE_TIMEOUT", "300"))
    # Global wall budget for the ladder and the stages after it.
    budget = float(os.environ.get("BENCH_TOTAL_BUDGET", "2200"))
    t_start = time.monotonic()

    best = None
    # The extra env and run shape that produced `best`: the recorder
    # stage re-runs them exactly, so its ratio isolates trace cost.
    best_env: dict = {}
    best_shape = (512, 128)
    if device == "cpu":
        # bench.py's CPU run: one scale, its shape, the tuned budget
        # applied all-or-nothing (mixed with operator-pinned knobs it
        # could make an invalid config, e.g. batch > log_slots).
        tuned = ({} if any(k in os.environ for k in TUNED_ENV)
                 else TUNED_ENV)
        timeout_s = max(60, min(scale_timeout,
                                budget - (time.monotonic() - t_start)))
        res = run_scale(only or 100_000, 96, 48, timeout_s, device="cpu",
                        extra_env=tuned)
        if res is not None:
            best, best_env, best_shape = res, dict(tuned), (96, 48)
            emit(headline(best, tuned=bool(tuned)))
    else:
        scales = [only] if only else list(SCALES)
        for i, g in enumerate(scales):
            is_smoke = (i == 0 and only is None)
            timeout_s = smoke_timeout if i == 0 else scale_timeout
            remaining = budget - (time.monotonic() - t_start)
            if remaining < timeout_s * 0.5:
                sys.stderr.write(f"[bench] budget exhausted before scale "
                                 f"{g}\n")
                break
            ticks, warmup = (64, 32) if is_smoke else (512, 128)
            res = run_scale(g, ticks, warmup, min(timeout_s, remaining),
                            profile_dir="" if is_smoke else profile_dir)
            if res is None:
                if best is None and i == 0:
                    break   # the smoke scale failed: nothing else runs
                continue    # a mid-ladder failure costs that scale only
            best = res
            best_shape = (ticks, warmup)
            sys.stderr.write(f"[bench] scale {g}: {res['cps']:,.0f} "
                             f"commits/s ({res['device']}, warmup "
                             f"{res['warmup_s']}s)\n")
            emit(headline(best))

    if best is None:
        emit({"metric": "AppendEntries commits/sec (no scale survived)",
              "value": 0, "unit": "commits/sec", "vs_baseline": 0.0,
              "device": "cpu" if device == "cpu" else "cuda"})
        sys.exit(1)
    stage_shape = (96, 48) if best["platform"] == "cpu" else (512, 128)

    def stage(timeout_var, shape, extra_env):
        remaining = budget - (time.monotonic() - t_start)
        timeout_s = float(os.environ.get(timeout_var, "300"))
        if remaining < timeout_s * 0.4:
            return None
        return run_scale(best["scale"], *shape, min(timeout_s, remaining),
                         device=device, extra_env=extra_env)

    # Read-plane stage: a separate headline, never replacing commits/s.
    # Skipped when the operator pinned BENCH_READS (the ladder measured
    # reads) or BENCH_NEMESIS (the child refuses the pair).
    if ("BENCH_READS" not in os.environ
            and "BENCH_NEMESIS" not in os.environ):
        res = stage("BENCH_READS_TIMEOUT", stage_shape,
                    {"BENCH_READS": "1"})
        if res is not None and "rps" in res:
            sys.stderr.write(f"[bench] read plane: {res['rps']:,.0f} "
                             f"reads/s ({res['lease_hits']} lease hits)\n")
            emit(headline_reads(res))
    elif "rps" in best:
        emit(headline_reads(best))

    # Faults-on stage: commits/s under the nemesis schedule, a separate
    # headline.  Skipped when BENCH_NEMESIS or BENCH_READS is pinned.
    if ("BENCH_NEMESIS" not in os.environ
            and "BENCH_READS" not in os.environ):
        res = stage("BENCH_NEMESIS_TIMEOUT", stage_shape,
                    {"BENCH_NEMESIS": "1"})
        if res is not None:
            sys.stderr.write(f"[bench] nemesis faults-on: "
                             f"{res['cps']:,.0f} commits/s\n")
            emit(headline(res))

    # Flight-recorder overhead stage: the config and run shape of `best`
    # plus the recorder; vs_baseline is with-trace / without-trace.
    if ("BENCH_TRACE" not in os.environ
            and "BENCH_READS" not in os.environ
            and "BENCH_NEMESIS" not in os.environ):
        res = stage("BENCH_TRACE_TIMEOUT", best_shape,
                    {**best_env, "BENCH_TRACE": "1"})
        if res is not None:
            ratio = res["cps"] / best["cps"]
            sys.stderr.write(
                f"[bench] flight recorder on: {res['cps']:,.0f} commits/s "
                f"({(1 - ratio) * 100:+.1f}% overhead, "
                f"{res.get('trace_events', 0)} events)\n")
            emit({
                "metric": f"flight-recorder overhead "
                          f"@{res['scale'] // 1000}k Raft groups: "
                          f"commits/sec with trace_depth="
                          f"{res['trace_depth']} vs "
                          f"{round(best['cps'])} without "
                          f"({res['platform']})",
                "value": round(res["cps"]),
                "unit": "commits/sec",
                "vs_baseline": round(ratio, 3),
                "device": res["device"],
            })


if __name__ == "__main__":
    main()
