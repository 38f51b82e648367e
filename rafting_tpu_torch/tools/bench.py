"""Headline benchmark of the port: AppendEntries commits/s across up to
100k Raft groups on the card.

    python -m rafting_tpu_torch.tools.bench [scale] [--device cpu]
    python -m rafting_tpu_torch.tools.bench --child G TICKS WARMUP [cpu] [PROFILE_DIR]
    python -m rafting_tpu_torch.tools.bench --member-child G [cpu]
    BENCH_MEMBER=1 | BENCH_LAT=1 | BENCH_HEAT=1 | BENCH_OPENLOOP=1 |
    BENCH_TXN=1 python -m rafting_tpu_torch.tools.bench [--device cpu]

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
* Five flags replace the ladder with one stage, as in ``bench.py``:
  ``BENCH_MEMBER`` (the masked quorum kernel against the fixed-majority
  baseline at P = 3, and the P = 6 3 -> 3-disjoint rebalance walk, at
  1k, 32k and 100k groups, a subprocess each), ``BENCH_LAT`` and
  ``BENCH_HEAT`` (the latency plane's and the attribution plane's cost
  to durable commits/s, ABBA through ``bench_runtime.run``),
  ``BENCH_OPENLOOP`` (an open-loop overload sweep, admission on and
  off) and ``BENCH_TXN`` (cross-group 2PC transfers against independent
  writes).

Where it departs from ``bench.py``:

* It never falls back to the CPU.  With no card it exits non-zero, unless
  the caller passes ``--device cpu``: then it runs the reference's CPU
  shape (one scale, 96 measured and 48 warm-up ticks, the tuned budget
  ``TUNED_ENV``) and every stage after it, labelled ``cpu``.  Each of
  the five stages runs on the card, or on the CPU with ``--device cpu``;
  the reference pins the lat, heat, open-loop and txn stages to the CPU.
* It has no ``BENCH_USE_PALLAS`` stage: on the card the port runs its
  quorum kernel on every tick whatever ``use_pallas`` says, so that stage
  would time one program twice.  The flag is recorded in the result.
* The member stage's baseline (``quorum_fixed=True``) is plain torch
  ops, as the reference's is jnp and not Pallas: the A/B holds the hand
  kernel against torch ops that compute a simpler function (a fixed
  majority, no voter masks).  The ladder builds the kernel once before
  its children start.  Its throughput windows run under sync-debug
  "error", fenced as the ladder's child is; the walk's clock holds the
  host reads of its convergence test, as the reference's does.
* Results and lines name the device they ran on, where the reference
  writes ``"platform": "cpu"`` for its lat, heat, open-loop and txn stages.
* On the card the txn stage sets the admission controller's delay
  target to three idle steps of a throwaway cluster of its shape (as
  ``tools/chaos_run.py`` does; the nodes' own target is one step of the
  thread that ticks them all, and admission shed the seeding writes).
  Its tick thread selects the card before it ticks, and a
  fault in it fails the stage after the phase instead of leaving the
  clients to time out.

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
# The member stage (bench.py:302-469): its scales, its one scan length,
# and the walk's new voter set.
MEMBER_SCALES = (1_024, 32_768, 100_000)
MEMBER_CHUNK = 16
MEMBER_TARGET, MEMBER_NEW = 0b111000, (3, 4, 5)


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
                  extra_env: dict | None = None, note: str = "") -> None:
    """Persist one scale's (or stage's) raw result, its ``note``, its
    knobs and argv as ``bench_<platform>_<scale>_<seq>.json`` under the
    port's ``_artifact.ARTIFACT_DIR``.  Best-effort: a failed write never
    kills the bench."""
    try:
        art = _artifact.ARTIFACT_DIR
        os.makedirs(art, exist_ok=True)
        stem = f"bench_{res.get('platform', 'unknown')}_{res.get('scale', 0)}"
        seq = 0
        while os.path.exists(os.path.join(art, f"{stem}_{seq:03d}.json")):
            seq += 1
        doc = {
            "result": res,
            "note": note,
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


def _require(cond, msg: str) -> None:
    """bench.py's assertions, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


# -- BENCH_MEMBER (bench.py:302-469) -----------------------------------------

def member_cfg(n_groups: int):
    """The member stage's P = 3 config (bench.py:355-361; the
    ``BENCH_*`` budget knobs apply).  The walk runs it at P = 6."""
    from ..core.types import EngineConfig
    return EngineConfig(
        n_groups=n_groups, n_peers=3,
        log_slots=int(os.environ.get("BENCH_LOG_SLOTS", "64")),
        batch=int(os.environ.get("BENCH_BATCH", "8")),
        max_submit=int(os.environ.get("BENCH_MAX_SUBMIT", "8")),
        election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8,
        pre_vote=True)


def _scan_chunks(cfg, c, n_ticks: int, submit) -> None:
    """``n_ticks`` ticks in whole ``MEMBER_CHUNK``-tick calls."""
    from ..core.sim import run_cluster_ticks
    for _ in range(n_ticks // MEMBER_CHUNK):
        c.states, c.inflight, c.last_info = run_cluster_ticks(
            cfg, MEMBER_CHUNK, c.states, c.inflight, c.last_info, c.conn,
            submit, device=c.device)


def _commit_total(c) -> int:
    """The fence: a synchronize and the int64 commit total."""
    import torch

    from ..core.sim import committed_entries
    if c.device.type == "cuda":
        torch.cuda.synchronize(c.device)
    return int(committed_entries(c.states))


def member_cps(cfg, device, reps: int = 2) -> float:
    """bench.py's ``commits_per_sec``: a fresh ``DeviceCluster(cfg,
    seed=0)`` at full offered load, 32 warm-up ticks, then the best of
    ``reps`` 64-tick windows.  A window runs under sync-debug "error" on
    the card and ends with the fence."""
    import torch

    from ..core.cluster import DeviceCluster
    c = DeviceCluster(cfg, seed=0, device=device)
    cuda = c.device.type == "cuda"
    submit = torch.full((cfg.n_peers, cfg.n_groups), cfg.max_submit,
                        dtype=torch.int32, device=c.device)
    _scan_chunks(cfg, c, 32, submit)
    best = 0.0
    for _ in range(reps):
        start = _commit_total(c)
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            _scan_chunks(cfg, c, 64, submit)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        end = _commit_total(c)
        best = max(best, (end - start) / (time.perf_counter() - t0))
    return best


def member_walk(cfg6, device, on_step=None) -> dict:
    """bench.py's member stage (2): on ``DeviceCluster(cfg6, seed=0,
    n_voters=3)`` every group walks the 3 -> 3-disjoint rebalance: 64
    ticks at full load, then at one submission a group a tick (at full
    load the floor outruns the learners' snapshot installs,
    bench.py:387-391) learners {3, 4, 5} in, 48 ticks of catch-up, the
    joint switch to {3, 4, 5}, and 16-tick chunks until every new node
    has left the joint config with one leader among them (fewer than 64
    chunks); then a chunk at full load.

    ``on_step(label, cluster)`` runs after every chunk and each request
    tick.  Returns the walk's record: ``chunks`` to converge, the commit
    frontier ([G], max over nodes) before the walk (``pre``), over the
    new voters after it (``post``) and after the full-load chunk
    (``resume``), its ``elapsed_s`` (host reads of the convergence test
    included) and ``ticks`` in all.  Raises where bench.py asserts."""
    import torch

    from ..core.cluster import DeviceCluster, cluster_snapshot
    from ..core.types import LEADER, conf_new_of, conf_voters_of
    G = cfg6.n_groups
    c = DeviceCluster(cfg6, seed=0, n_voters=3, device=device)
    full = torch.full((6, G), cfg6.max_submit, dtype=torch.int32,
                      device=c.device)
    light = torch.ones((6, G), dtype=torch.int32, device=c.device)
    new = list(MEMBER_NEW)
    ticks = 0

    def step(label, n=1):
        nonlocal ticks
        ticks += n
        if on_step is not None:
            on_step(label, c)

    def chunks(n_ticks, load, label):
        for _ in range(n_ticks // MEMBER_CHUNK):
            _scan_chunks(cfg6, c, MEMBER_CHUNK, load)
            step(label, MEMBER_CHUNK)

    def walk_done() -> bool:
        w = c.last_info.conf_word[new]
        ok = ((conf_voters_of(w) == MEMBER_TARGET)
              & (conf_new_of(w) == 0)).all()
        leaders = (c.states.role[new] == LEADER).sum(dim=0)
        return bool(ok & (leaders == 1).all())

    chunks(64, full, "warm-up")
    pre = cluster_snapshot(c.states)["commit"].max(axis=0)
    _require((pre > 0).all(), "warm-up never committed")
    chunks(MEMBER_CHUNK, light, "light")   # bench.py compiles the walk here
    t0 = time.perf_counter()
    c.request_membership(voters=0b000111, learners=MEMBER_TARGET)
    step("learners")
    chunks(48, light, "catch-up")
    c.request_membership(voters=MEMBER_TARGET, learners=0)
    step("joint")
    n_chunks = 0
    while not walk_done():
        chunks(MEMBER_CHUNK, light, "walk")
        n_chunks += 1
        _require(n_chunks < 64, "rebalance walk did not converge")
    elapsed = time.perf_counter() - t0
    # No committed entry lost: the new set's frontier covers the pre-walk
    # one and keeps advancing under the new voters.
    post = cluster_snapshot(c.states)["commit"][new].max(axis=0)
    _require((post >= pre).all(), "committed entries lost in the walk")
    chunks(MEMBER_CHUNK, full, "resume")
    resume = cluster_snapshot(c.states)["commit"][new].max(axis=0)
    _require((resume > post).all(), "commits stalled after the walk")
    return {"chunks": n_chunks, "pre": pre, "post": post, "resume": resume,
            "elapsed_s": elapsed, "ticks": ticks}


def member_run(n_groups: int, device: str = "", check: bool = True,
               on_step=None) -> tuple:
    """bench.py's ``member_child`` in-process: (1) the quorum kernel
    against the fixed-majority baseline at P = 3 (``check``: masked >=
    0.95x fixed, as bench.py asserts); (2) the P = 6 walk
    (``member_walk``, which calls ``on_step``).  On the card every kernel launch must be dense,
    one per tick of the masked run and of the walk, none in the fixed
    run.  Returns ``(result, walk)``: bench.py's keys plus ``device``,
    and the walk's record with its ``launches`` and ``peak_bytes``."""
    import dataclasses

    import torch

    from ..core.types import resolve_device
    from ..ops import quorum
    dev = resolve_device(device or None)
    cuda = dev.type == "cuda"
    if cuda:
        torch.empty(1, device=dev)       # creates the context
        torch.cuda.reset_peak_memory_stats(dev)

    def counts():
        return (quorum.launch_counts["quorum_commit"],
                quorum.strided_launches["quorum_commit"])

    base = member_cfg(n_groups)
    n0 = counts()
    cps_fixed = member_cps(dataclasses.replace(base, quorum_fixed=True), dev)
    n1 = counts()
    cps_masked = member_cps(base, dev)
    n2 = counts()
    ratio = cps_masked / max(cps_fixed, 1e-9)
    if check:
        _require(ratio >= 0.95,
                 f"masked-quorum kernel regressed commit throughput beyond "
                 f"noise at P=3: {cps_masked:,.0f} vs fixed "
                 f"{cps_fixed:,.0f} ({ratio:.3f}x)")
    walk = member_walk(dataclasses.replace(base, n_peers=6), dev, on_step)
    n3 = counts()
    launches = {"fixed": n1[0] - n0[0], "masked": n2[0] - n1[0],
                "walk": n3[0] - n2[0], "strided": n3[1] - n0[1]}
    if cuda:
        want = {"fixed": 0, "masked": 32 + 2 * 64, "walk": walk["ticks"],
                "strided": 0}
        _require(launches == want, f"member stage quorum kernel launches "
                                   f"{launches}, want {want}")
    walk["launches"] = launches
    walk["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res = {
        "scale": n_groups,
        "platform": dev.type,
        "member_stage": True,
        "walk_groups_per_sec": n_groups / walk["elapsed_s"],
        "walk_elapsed_s": round(walk["elapsed_s"], 3),
        "cps_masked": cps_masked,
        "cps_fixed": cps_fixed,
        "masked_vs_fixed": round(ratio, 4),
        "device": device_label(dev),
    }
    return res, walk


def member_child(n_groups: int, device: str = "") -> dict:
    """One member scale under the child's watchdog; bench.py's result
    keys plus ``device``.  The walk's record goes to stderr."""
    import faulthandler
    faulthandler.enable()
    timeout_s = float(os.environ.get("BENCH_CHILD_WATCHDOG", "240"))
    faulthandler.dump_traceback_later(timeout_s, exit=False)
    try:
        res, walk = member_run(n_groups, device)
    finally:
        faulthandler.cancel_dump_traceback_later()
    sys.stderr.write(
        f"[bench] member {n_groups}: walk converged in {walk['chunks']} "
        f"chunks, {walk['ticks']} ticks, kernel launches "
        f"{walk['launches']}, peak device memory "
        f"{walk['peak_bytes'] / 2**30:.3f} GiB\n")
    return res


def run_member_ladder(device: str = "") -> None:
    """BENCH_MEMBER=1: walk-through throughput at 1k/32k/100k and the
    masked-vs-fixed A/B at P = 3, one subprocess per scale; the kernel is
    built here first, so every child loads the built library."""
    timeout_s = float(os.environ.get("BENCH_MEMBER_TIMEOUT", "420"))
    if device != "cpu":
        from ..ops import _build
        _build.build("quorum_commit")
    any_ok = False
    for g in MEMBER_SCALES:
        cmd = [sys.executable, "-m", "rafting_tpu_torch.tools.bench",
               "--member-child", str(g), device]
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout_s, env=env)
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"[bench] member scale {g}: TIMEOUT\n")
            continue
        sys.stderr.write(r.stderr[-2000:] if r.returncode else
                         "".join(ln + "\n" for ln in r.stderr.splitlines()
                                 if ln.startswith("[bench]")))
        if r.returncode != 0:
            sys.stderr.write(f"[bench] member scale {g}: rc="
                             f"{r.returncode}\n")
            continue
        try:
            res = json.loads(r.stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            continue
        save_artifact(res, child_env=env, note="BENCH_MEMBER stage")
        any_ok = True
        emit(member_line(res))
    if not any_ok:
        emit({"metric": "membership rebalance stage (no scale survived)",
              "value": 0, "unit": "groups/sec", "vs_baseline": 0.0,
              "device": "cpu" if device == "cpu" else "cuda"})
        sys.exit(1)


def member_line(res: dict) -> dict:
    g = res["scale"]
    return {
        "metric": f"membership rebalance walk-throughs/sec "
                  f"@{g // 1000}k Raft groups (3->3-disjoint walk: "
                  f"add-learner -> catch-up -> joint switch -> "
                  f"auto-leave, P=6, {res['platform']}) "
                  f"[masked-quorum commit kernel "
                  f"{res['masked_vs_fixed']}x of fixed-majority @P=3]",
        "value": round(res["walk_groups_per_sec"]),
        "unit": "groups/sec",
        "vs_baseline": res["masked_vs_fixed"],
        "device": res["device"],
    }


# -- BENCH_OPENLOOP (bench.py:472-609) ----------------------------------------

def run_openloop_stage(device: str = "", check: bool = True) -> dict:
    """BENCH_OPENLOOP=1: an open-loop rate sweep (testkit/openloop.py)
    against a durable 3-node ``LocalCluster`` with the admission plane on
    and then off (``RAFT_ADMISSION=0``): offered load against goodput,
    shed rate and admitted percentiles per point.  The headline is the
    no-collapse property of the admission-on sweep (``check``: asserted,
    as bench.py does).

    Knobs: BENCH_OPENLOOP_GROUPS (default 8), BENCH_OPENLOOP_DUR (s per
    sweep point, 2), BENCH_OPENLOOP_MULTS (offered load as x capacity,
    "0.5,1.0,2.0,3.0"), BENCH_OPENLOOP_DEADLINE_S (1.0).  Returns the
    artifact's document."""
    import shutil
    import tempfile

    from ..core.types import EngineConfig, resolve_device
    from ..testkit.harness import LocalCluster
    from ..testkit.openloop import (
        OpenLoopSpec, no_collapse_check, run_open_loop,
    )

    dev = resolve_device(device or None)
    label = device_label(dev)
    n_groups = int(os.environ.get("BENCH_OPENLOOP_GROUPS", "8"))
    dur = float(os.environ.get("BENCH_OPENLOOP_DUR", "2"))
    mults = [float(x) for x in os.environ.get(
        "BENCH_OPENLOOP_MULTS", "0.5,1.0,2.0,3.0").split(",")]
    deadline_s = float(os.environ.get("BENCH_OPENLOOP_DEADLINE_S", "1.0"))
    cfg = EngineConfig(
        n_groups=n_groups, n_peers=3, log_slots=64, batch=8, max_submit=8,
        election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8)

    def build(root: str) -> LocalCluster:
        c = LocalCluster(cfg, root, seed=7, device=dev)
        for g in range(n_groups):
            c.wait_leader(g)
        return c

    def submit_fn(c: LocalCluster):
        leaders = {g: c.leader_of(g) for g in range(n_groups)}

        def submit(grp: int, tenant: str, seq: int):
            g = grp % n_groups
            ld = leaders.get(g)
            if ld is None or not c.nodes[ld].is_leader(g):
                leaders[g] = ld = c.leader_of(g)
            if ld is None:
                return None
            return c.nodes[ld].submit(g, b"ol-%d" % seq, tenant=tenant)
        return submit

    def probe_capacity(c: LocalCluster) -> float:
        """Closed-loop throughput: burst-submit to every leader, tick
        until drained, 16 times."""
        t0 = time.monotonic()
        done = 0
        for _ in range(16):
            futs = []
            for g in range(n_groups):
                ld = c.leader_of(g)
                if ld is not None:
                    futs.append(c.nodes[ld].submit_batch(g, [b"cap"] * 8))
            for _ in range(200):
                if all(f.done() for f in futs):
                    break
                c.tick(1)
            done += sum(8 for f in futs
                        if f.done() and f.exception() is None)
        return done / max(time.monotonic() - t0, 1e-9)

    def sweep(c: LocalCluster, cap: float, adm: str) -> list:
        out = []
        for m in mults:
            spec = OpenLoopSpec(
                rate=max(1.0, cap * m), duration_s=dur, n_tenants=4,
                n_groups=n_groups, deadline_s=deadline_s,
                seed=int(m * 100))
            r = run_open_loop(spec, submit_fn(c),
                              step=lambda: c.tick(1), drain_s=2.0)
            d = r.to_dict()
            d["offered_x_capacity"] = m
            adms = [n.admission for n in c.nodes.values()]
            d["admission"] = {
                "enabled": adms[0].enabled,
                "level": round(max(a.level for a in adms), 4),
                "shed_total": sum(a.shed for a in adms)}
            out.append((m, r, d))
            emit({"metric": f"open-loop goodput @{n_groups} groups, "
                            f"admission={adm}, offered={m:g}x capacity",
                  "value": round(r.goodput, 1), "unit": "ops/sec",
                  "vs_baseline": None, **d, "device": label})
        return out

    results = {}
    for adm, env_admission in (("on", None), ("off", "0")):
        root = tempfile.mkdtemp(prefix=f"openloop-{adm}-")
        old = os.environ.get("RAFT_ADMISSION")
        try:
            if env_admission is not None:
                os.environ["RAFT_ADMISSION"] = env_admission
            else:
                os.environ.pop("RAFT_ADMISSION", None)
            c = build(root)
            try:
                cap = probe_capacity(c)
                emit({"metric": f"closed-loop capacity probe "
                                f"@{n_groups} groups (admission={adm})",
                      "value": round(cap, 1), "unit": "ops/sec",
                      "vs_baseline": None, "device": label})
                results[adm] = (cap, sweep(c, cap, adm))
            finally:
                c.close()
        finally:
            if old is None:
                os.environ.pop("RAFT_ADMISSION", None)
            else:
                os.environ["RAFT_ADMISSION"] = old
            shutil.rmtree(root, ignore_errors=True)

    on = [r for _m, r, _d in results["on"][1]]
    ok, why = no_collapse_check(on, slo_s=deadline_s)
    emit({"metric": "open-loop no-collapse verdict (admission on)",
          "value": 1 if ok else 0, "unit": "pass", "vs_baseline": None,
          "why": why,
          "capacity_ops_per_sec": round(results["on"][0], 1),
          "device": label})
    doc = {"platform": dev.type, "device": label, "scale": n_groups,
           "capacity": {k: round(v[0], 1) for k, v in results.items()},
           "sweep": {k: [d for _m, _r, d in v[1]]
                     for k, v in results.items()},
           "no_collapse": {"ok": ok, "why": why}}
    save_artifact(doc, note="BENCH_OPENLOOP stage: open-loop overload sweep")
    if check:
        _require(ok, f"no-collapse property failed: {why}")
    return doc


# -- BENCH_TXN (bench.py:612-777) ---------------------------------------------

def run_txn_stage(device: str = "") -> list:
    """BENCH_TXN=1: closed-loop 2-key Zipf bank transfers through the 2PC
    plane (runtime/txn.py) on a durable 3-node cluster, against the same
    key traffic as two independent single-group writes (the
    no-atomicity bound).  One transfer is five sequential quorum commits
    (begin, 2x prepare, decide, finalize) against the bound's two.

    Knobs: BENCH_TXN_GROUPS (comma ladder of total group counts,
    coordinator + participants, "3,5"), BENCH_TXN_CLIENTS (8),
    BENCH_TXN_DUR (s per phase, 4), BENCH_TXN_ZIPF (1.0).  Returns each
    scale's result; raises if a scale committed no transfer."""
    import itertools
    import shutil
    import tempfile
    import threading

    import torch

    from ..api.stub import RaftStub
    from ..core.types import EngineConfig, resolve_device
    from ..machine.kv_machine import KVMachineProvider
    from ..testkit.chaos import StubHost
    from ..testkit.harness import LocalCluster
    from ..testkit.openloop import OpenLoopSpec, gen_transfers
    from .chaos_run import calibrate

    dev = resolve_device(device or None)
    label = device_label(dev)
    ladder = [int(x) for x in os.environ.get(
        "BENCH_TXN_GROUPS", "3,5").split(",")]
    clients = int(os.environ.get("BENCH_TXN_CLIENTS", "8"))
    dur = float(os.environ.get("BENCH_TXN_DUR", "4"))
    zipf = float(os.environ.get("BENCH_TXN_ZIPF", "1.0"))
    n_accounts = 16
    out = []

    for n_groups in ladder:
        participants = list(range(1, n_groups))
        cfg = EngineConfig(n_groups=n_groups, n_peers=3, log_slots=64,
                           batch=8, max_submit=8, election_ticks=10,
                           heartbeat_ticks=3, rpc_timeout_ticks=8,
                           read_lease=True)
        root = tempfile.mkdtemp(prefix=f"txnbench-{n_groups}-")
        env_target = os.environ.get("RAFT_ADMISSION_TARGET_MS")
        try:
            if dev.type == "cuda":
                # One thread steps every node, so a node's own delay
                # target (three of its ticks) is one step, which every
                # write waits by construction; a card step nears the
                # 50 ms floor and admission shed the seeding writes.
                # tools/chaos_run.py calibrates its soak the same way.
                step_s = calibrate(cfg, os.path.join(root, "calibration"),
                                   dev)
                target_ms = max(float(env_target or 50), 3e3 * step_s)
                os.environ["RAFT_ADMISSION_TARGET_MS"] = f"{target_ms:.1f}"
                sys.stderr.write(f"[bench] txn {n_groups} groups: an idle "
                                 f"step {step_s * 1e3:.1f} ms, admission "
                                 f"target {target_ms:.1f} ms\n")
            cluster = LocalCluster(
                cfg, root, seed=5,
                provider_factory=lambda i: KVMachineProvider(
                    os.path.join(root, f"node{i}", "kv")),
                device=dev)
        finally:
            # The nodes read the target as they start.
            if env_target is None:
                os.environ.pop("RAFT_ADMISSION_TARGET_MS", None)
            else:
                os.environ["RAFT_ADMISSION_TARGET_MS"] = env_target
        stop = threading.Event()
        tick_faults = []

        def tick_loop():
            # The nodes' engines were built on the main thread: select
            # their card in this one before it launches anything.
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index or 0)
            try:
                while not stop.is_set():
                    for node in list(cluster.nodes.values()):
                        node.tick()
                    time.sleep(0.002)
            except BaseException as e:
                tick_faults.append(e)
                raise

        ticker = threading.Thread(target=tick_loop, daemon=True)
        try:
            for g in range(n_groups):
                cluster.wait_leader(g)
            ticker.start()
            hosts = [StubHost(cluster, c % cfg.n_peers)
                     for c in range(clients)]
            seeder = StubHost(cluster, 0)
            for g in participants:
                s = RaftStub(seeder, str(g), g, forward=True,
                             forward_budget=10.0)
                for a in range(n_accounts):
                    s.execute(json.dumps({"op": "set", "k": f"acct{a}",
                                          "v": 10_000}), timeout=10)
            # One seeded plan feeds both phases: same keys, skew and
            # amounts; the A/B differs only in atomicity.
            spec = OpenLoopSpec(rate=500.0, duration_s=dur * 8,
                                n_tenants=4, n_groups=len(participants),
                                seed=5)
            plan = gen_transfers(spec, n_accounts=n_accounts,
                                 account_zipf=zipf)

            def phase(body) -> tuple:
                idx = itertools.count()
                outs = [{"ok": 0, "aborted": 0, "failed": 0}
                        for _ in range(clients)]

                def worker(c):
                    host = hosts[c]
                    parts = {g: RaftStub(host, str(g), g, forward=True,
                                         forward_budget=8.0)
                             for g in participants}
                    coord = RaftStub(host, "0", 0, forward=True,
                                     forward_budget=8.0)
                    end = time.monotonic() + dur
                    while time.monotonic() < end:
                        step = plan[next(idx) % len(plan)]
                        body(coord, parts, step, outs[c])
                threads = [threading.Thread(target=worker, args=(c,))
                           for c in range(clients)]
                t0 = time.monotonic()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                el = time.monotonic() - t0
                tot = {k: sum(o[k] for o in outs) for k in outs[0]}
                return tot, el

            def txn_body(coord, parts, step, out):
                _t, _tn, src, dst, ka, kb, amt = step
                sg, dg = participants[src], participants[dst]
                try:
                    r = (coord.txn(deadline_s=2.0)
                         .transfer(parts[sg], ka, parts[dg], kb, amt)
                         .execute(timeout=6.0))
                    out["ok" if r.committed else "aborted"] += 1
                except Exception:
                    out["failed"] += 1

            def write_body(coord, parts, step, out):
                _t, _tn, src, dst, ka, kb, amt = step
                sg, dg = participants[src], participants[dst]
                try:
                    parts[sg].execute(json.dumps(
                        {"op": "incr", "k": ka, "v": -amt}), timeout=6.0)
                    parts[dg].execute(json.dumps(
                        {"op": "incr", "k": kb, "v": amt}), timeout=6.0)
                    out["ok"] += 1
                except Exception:
                    out["failed"] += 1

            txn_tot, txn_el = phase(txn_body)
            wr_tot, wr_el = phase(write_body)
        finally:
            stop.set()
            # The nodes close only once their last tick has ended: a
            # closing node releases its step's buffers, which a tick still
            # in flight would read.
            if ticker.is_alive():
                ticker.join(timeout=60)
            cluster.close()
            shutil.rmtree(root, ignore_errors=True)
        if tick_faults:
            raise RuntimeError("the txn stage's tick thread failed") \
                from tick_faults[0]

        attempted = txn_tot["ok"] + txn_tot["aborted"] + txn_tot["failed"]
        txn_rate = txn_tot["ok"] / max(txn_el, 1e-9)
        abort_rate = txn_tot["aborted"] / max(attempted, 1)
        wr_rate = wr_tot["ok"] / max(wr_el, 1e-9)
        ratio = txn_rate / max(wr_rate, 1e-9)
        res = {
            "platform": dev.type, "device": label, "scale": n_groups,
            "participants": len(participants), "clients": clients,
            "duration_s": dur, "account_zipf": zipf,
            "txn": {**txn_tot, "attempted": attempted,
                    "elapsed_s": round(txn_el, 3)},
            "independent_writes": {**wr_tot,
                                   "elapsed_s": round(wr_el, 3)},
            "txn_per_sec": round(txn_rate, 1),
            "abort_rate": round(abort_rate, 4),
            "independent_pairs_per_sec": round(wr_rate, 1),
            "atomicity_tax": round(ratio, 3),
        }
        save_artifact(res, note="BENCH_TXN stage: cross-group 2PC "
                                "transfers vs independent-writes bound")
        emit({"metric": f"cross-group 2PC transfers/sec @{n_groups} "
                        f"groups (1 coordinator + "
                        f"{len(participants)} participants, 2-key "
                        f"Zipf({zipf:g}) transfers, {clients} closed-"
                        f"loop clients, durable 3-node cluster) "
                        f"[abort rate {abort_rate:.1%}; independent-"
                        f"writes bound {wr_rate:.0f} pairs/sec]",
              "value": round(txn_rate, 1), "unit": "txn/sec",
              "vs_baseline": round(ratio, 3), "device": label})
        _require(txn_tot["ok"] > 0, "txn stage committed nothing")
        out.append(res)
    return out


# -- BENCH_LAT and BENCH_HEAT (bench.py:780-894) -------------------------------

def _abba(scale: int, device: str, on: dict, off: dict) -> tuple:
    """Four ``bench_runtime.run``s in one process in ABBA order (off,
    on, on, off): linear drift of a shared host cancels.  Returns the
    four results (on1, on2, off1, off2), each pair's mean commits/s (on,
    off) and the overhead, 1 - on / off."""
    from . import bench_runtime
    kw = dict(n_groups=scale, device=device or None)
    off1 = bench_runtime.run(**kw, **off)
    on1 = bench_runtime.run(**kw, **on)
    on2 = bench_runtime.run(**kw, **on)
    off2 = bench_runtime.run(**kw, **off)
    on_cps = (on1["value"] + on2["value"]) / 2
    off_cps = (off1["value"] + off2["value"]) / 2
    return on1, on2, off1, off2, on_cps, off_cps, \
        1.0 - on_cps / max(off_cps, 1)


def run_latency_ab(device: str = "", scale: int = 0) -> dict:
    """BENCH_LAT=1: durable commits/s through ``bench_runtime.run`` with
    span sampling on (1/64) against off (RAFT_LAT_SAMPLE=0), ABBA at one
    scale (BENCH_LAT_SCALE, default 100k).  The sampled pair must keep
    > 98% of the unsampled pair's throughput, as bench.py asserts.
    Returns the result."""
    from ..core.types import resolve_device
    dev = resolve_device(device or None)
    label = device_label(dev)
    scale = scale or int(os.environ.get("BENCH_LAT_SCALE", "100000"))
    on1, on2, off1, off2, on_cps, off_cps, overhead = _abba(
        scale, device, {"lat_sample": 64}, {"lat_sample": 0})
    _require(on1["latency"]["sample_rate"] == 64 and
             off1["latency"]["sample_rate"] == 0, "A/B pins did not take")
    res = {
        "scale": scale,
        "platform": dev.type,
        "device": label,
        "lat_overhead": round(overhead, 4),
        "sampled_commits_per_sec": round(on_cps),
        "unsampled_commits_per_sec": round(off_cps),
        "order": "ABBA (off, on, on, off)",
        "sampled": [on1, on2],
        "unsampled": [off1, off2],
    }
    save_artifact(res, note="BENCH_LAT stage: span-sampling overhead A/B")
    emit({
        "metric": f"latency-plane sampling overhead @{scale // 1000}k "
                  f"groups (durable runtime, 1/64 sampling vs off, "
                  f"loopback)",
        "value": round(overhead * 100, 2),
        "unit": "% durable commits/sec regression (target <2%)",
        "vs_baseline": None,
        "sampled_commits_per_sec": round(on_cps),
        "unsampled_commits_per_sec": round(off_cps),
        "sampled_e2e": on1["latency"].get("e2e"),
        "sampled_counts": on1["latency"].get("counts"),
        "device": label,
    })
    _require(overhead < 0.02,
             f"latency plane costs {overhead * 100:.2f}% durable "
             f"throughput (budget: 2%) — sampled {on_cps:.0f} vs "
             f"unsampled {off_cps:.0f} commits/sec")
    return res


def run_heat_ab(device: str = "", scale: int = 0) -> dict:
    """BENCH_HEAT=1: durable commits/s with the whole attribution plane
    on (heat lanes in the step, 1/64 span sampling, cross-node hop
    tracing) against all of it off, ABBA at one scale (BENCH_HEAT_SCALE,
    default 100k).  The attributed pair must keep > 98% of the bare
    pair's throughput, as bench.py asserts.  Returns the result."""
    from ..core.types import resolve_device
    dev = resolve_device(device or None)
    label = device_label(dev)
    scale = scale or int(os.environ.get("BENCH_HEAT_SCALE", "100000"))
    on1, on2, off1, off2, on_cps, off_cps, overhead = _abba(
        scale, device, {"lat_sample": 64, "heat": True, "hops": True},
        {"lat_sample": 0, "heat": False, "hops": False})
    _require(on1["heat"]["enabled"] and not off1["heat"]["enabled"],
             "A/B heat pins did not take")
    res = {
        "scale": scale,
        "platform": dev.type,
        "device": label,
        "heat_overhead": round(overhead, 4),
        "attributed_commits_per_sec": round(on_cps),
        "bare_commits_per_sec": round(off_cps),
        "order": "ABBA (off, on, on, off)",
        "active_set": on1["heat"].get("active_set"),
        "attributed": [on1, on2],
        "bare": [off1, off2],
    }
    save_artifact(res, note="BENCH_HEAT stage: fleet-attribution "
                            "overhead A/B")
    emit({
        "metric": f"fleet-attribution overhead @{scale // 1000}k groups "
                  f"(heat lanes + 1/64 sampling + hop tracing vs all "
                  f"off, durable runtime, loopback)",
        "value": round(overhead * 100, 2),
        "unit": "% durable commits/sec regression (target <2%)",
        "vs_baseline": None,
        "attributed_commits_per_sec": round(on_cps),
        "bare_commits_per_sec": round(off_cps),
        "active_set": on1["heat"].get("active_set"),
        "device": label,
    })
    _require(overhead < 0.02,
             f"attribution plane costs {overhead * 100:.2f}% durable "
             f"throughput (budget: 2%) — attributed {on_cps:.0f} vs "
             f"bare {off_cps:.0f} commits/sec")
    return res


# The flags that replace the ladder with one stage, in bench.py's order.
STAGES = (("BENCH_MEMBER", run_member_ladder),
          ("BENCH_LAT", run_latency_ab),
          ("BENCH_HEAT", run_heat_ab),
          ("BENCH_OPENLOOP", run_openloop_stage),
          ("BENCH_TXN", run_txn_stage))


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        n_groups, ticks, warmup = map(int, argv[1:4])
        device = argv[4] if len(argv) > 4 else ""
        profile_dir = argv[5] if len(argv) > 5 else ""
        print(json.dumps(child_run(n_groups, ticks, warmup, device,
                                   profile_dir)))
        return
    if argv[:1] == ["--member-child"]:
        device = argv[2] if len(argv) > 2 else ""
        print(json.dumps(member_child(int(argv[1]), device)))
        return
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
    for flag, stage in STAGES:
        if env_flag(flag):
            # The stage replaces the ladder, as in bench.py.
            stage(device)
            return

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
