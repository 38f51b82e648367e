"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py [--profile]

Phases (one line printed for each; any failure exits non-zero and prints
no result line):

1. probe   — a CUDA card must be present; prints its name and power limit.
2. build   — nvcc builds the quorum-commit kernel from the sources here.
3. kernel  — the CUDA kernel against its plain PyTorch version on the card,
             bit for bit: P in {1,3,5,7,9,10}, G in {1, 1000, 300000},
             random voter sets, ~half the lanes joint, an empty-mask lane,
             and the main path's own [3, 100000, 3] shape.
4. parity  — the port on CUDA against the port on the CPU: 512 groups,
             P=3 and P=5 with 3 voters, 80 ticks under load with one
             isolate/heal; then the nemesis case: 512 groups x 5 nodes
             with the flight recorder, heat lanes, CheckQuorum and debug
             checks on, chaos_mix(5, 90) plus a 30-tick healthy tail
             through run_cluster_ticks_nemesis.  Every lane of the final
             state (subtrees included), step info and in-flight messages
             must be identical.
5. main    — the bench headline deployment at full size: 100k groups x 3
             nodes (log_slots=64, batch=8, max_submit=8, PreVote), 60
             warm-up ticks, 64 measured ticks through run_cluster_ticks
             with no host synchronisation allowed, a 15-tick drain; one
             leader per group, commits > 0, converged commit indices, and
             exactly one kernel launch per tick.
6. nemesis — BASELINE.json configs[3] at full width: 100k groups x 5
             nodes, all four optional flags on, offered load max_submit,
             a 50-tick healthy warm-up, chaos_mix(5, 150, seed=0), then a
             healthy settle, through
             run_cluster_ticks_nemesis one tick per call with no host
             synchronisation allowed inside a 50-tick audit window.  At
             every window: the port's ClusterChecker, zero debug_viol on
             every tick.  At the end: log matching, one leader per group,
             commits in every group, a CheckQuorum step-down inside the
             split-brain window, one kernel launch per tick.
7. runtime-parity — the node runtime (RaftNode + WAL + loopback +
             LocalCluster, FileMachine per group) on CUDA against the same
             on the CPU: 64 groups x 3 nodes in lockstep through the
             scripted scenario of testkit/lockstep.py (elect, submit
             through leaders, kill the node leading group 0, re-elect,
             submit, restart it from its WAL, drain), with the durable
             pipeline off and then on.  h_role/h_term/h_commit/h_leader
             of every node equal at every round; machine files byte-equal.
8. runtime — BASELINE.json configs[2] (10k groups, PreVote, randomized
             leader churn) through three RaftNodes on the card over
             loopback, pipelined, NullProvider, bench_runtime.py's offered
             load (8 x 64-byte payloads per led, ready group per round via
             submit_batch_many): settle, 5 warm-up + 25 measured rounds,
             kill the node leading the most groups, re-elect, restart it
             from its WAL, drain.  One leader per group, converged
             commits, payload agreement and every acknowledged submission
             read back on 512 seeded groups, one kernel launch per node
             tick.
9. profile — only with --profile: 8 headline ticks, then 8 nemesis ticks
             inside the split-brain window, under torch.profiler: the top
             kernels by device time and the device-busy share.

The line before the last is the card's name and power limit as nvidia-smi
reports them; before it, one JSON line lists each kernel with its launches
on the path that launched it (the quorum kernel three times: P=3 on the
headline path, P=5 on the nemesis path, P=3 at N=1 per node tick on the
runtime path), its error against the plain
version, its time, the plain version's time and its bound.  The last line is the result object.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12            # vector (non-tensor-core) rate, 32-bit lanes


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script runs "
                         "only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} | {card}")
    return card


def phase_build() -> None:
    from rafting_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("quorum_commit")
    info = _build.build_info["quorum_commit"]
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln]
    log(f"[build] quorum_commit built in {info['seconds']:.2f}s "
        f"(load {time.perf_counter() - t0:.2f}s); ptxas: "
        f"{' | '.join(regs[:3])}")


def random_case(rng, shape, P, L, dev):
    """The test_ops.py input space: random matches, own_from on both
    sides of the ring, ~70% leading lanes, random non-empty voter sets,
    ~half the lanes joint; lane 0 gets an empty voter mask."""
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
    voters.reshape(-1)[0] = 0
    vnew.reshape(-1)[0] = 0
    lead.reshape(-1)[0] = True
    t = lambda a, dt=torch.int32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dt).to(dev)
    return (t(match), t(own_from), t(last), t(commit),
            t(lead, torch.bool), t(voters), t(vnew))


def phase_kernel() -> None:
    from rafting_tpu_torch.ops.quorum import (
        quorum_commit_cuda, quorum_commit_ref,
    )
    rng = np.random.default_rng(1234)
    n = 0
    cases = [(P, (G,)) for P in (1, 3, 5, 7, 9, 10)
             for G in (1, 1000, 300_000)] + [(3, (3, 100_000))]
    for P, shape in cases:
        args = random_case(rng, shape, P, 64, "cuda")
        got = quorum_commit_cuda(*args)
        ref = quorum_commit_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            cpu = quorum_commit_ref(*(a.cpu() for a in args))
            bad = (got != ref).reshape(-1).nonzero()[:3, 0].tolist()
            flat = [a.reshape(-1, *a.shape[len(shape):]).cpu()
                    for a in args]
            rows = [(i, [f[i].tolist() for f in flat], int(got.reshape(-1)[i]),
                     int(ref.reshape(-1)[i]), int(cpu.reshape(-1)[i]))
                    for i in bad]
            raise AssertionError(
                f"kernel != plain at P={P} shape={shape}: (lane, [match, "
                f"own_from, last, commit, can_lead, voters, voters_new], "
                f"kernel, plain on card, plain on cpu) {rows}")
        n += 1
    log(f"[kernel] quorum_commit == quorum_commit_ref bit for bit in {n} "
        f"cases (P 1..10, G up to 300000, joint and empty-mask lanes)")


def _compare(a, b, path: str) -> None:
    from rafting_tpu_torch.core.types import _Tree
    if isinstance(a, _Tree):
        for f in dataclasses.fields(a):
            _compare(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"CUDA != CPU at {path}")


def phase_parity() -> None:
    from rafting_tpu_torch import DeviceCluster, EngineConfig
    for P, nv in ((3, None), (5, 3)):
        cfg = EngineConfig(n_groups=512, n_peers=P, log_slots=64, batch=8,
                           max_submit=8)
        cl = {d: DeviceCluster(cfg, seed=11, n_voters=nv, device=d)
              for d in ("cuda", "cpu")}
        for t in range(80):
            for c in cl.values():
                if t == 30:
                    c.isolate(0)
                if t == 55:
                    c.heal()
                c.tick(submit_n=2)
        a, b = cl["cuda"], cl["cpu"]
        _compare(a.states, b.states, "state")
        _compare(a.last_info, b.last_info, "info")
        _compare(a.inflight, b.inflight, "inflight")
        commits = int(a.states.commit.amax(dim=0).sum())
        log(f"[parity] P={P} n_voters={nv or P}: port on CUDA == port on "
            f"CPU on every lane after 80 ticks (commit sum {commits})")


def phase_parity_nemesis() -> None:
    from rafting_tpu_torch import (
        DeviceCluster, EngineConfig, run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.testkit import nemesis
    cfg = EngineConfig(n_groups=512, n_peers=5, log_slots=64, batch=8,
                       max_submit=8, trace_depth=16, heat=True,
                       check_quorum=True, debug_checks=True)
    sched = nemesis.concat(nemesis.chaos_mix(5, 90, seed=13, device="cpu"),
                           nemesis.healthy(5, 30, device="cpu"))
    out = {}
    for d in ("cuda", "cpu"):
        c = DeviceCluster(cfg, seed=13, device=d)
        load = torch.full((5, cfg.n_groups), 4, dtype=torch.int32,
                          device=d)
        out[d] = run_cluster_ticks_nemesis(
            cfg, c.states, c.inflight, c.last_info,
            tree_map(lambda a: a.to(d), sched), load, device=d)
    for name, a, b in zip(("state", "inflight", "info"), out["cuda"],
                          out["cpu"]):
        _compare(a, b, name)
    s = out["cpu"][0]
    log(f"[parity] nemesis P=5, trace/heat/check_quorum/debug_checks on, "
        f"{sched.n_ticks} ticks: port on CUDA == port on CPU on every lane "
        f"(commit sum {int(s.commit.amax(dim=0).sum())}, trace events "
        f"{int(s.trace.n.sum())}, heat rpcs {int(s.heat.sent.sum())})")


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_entry(name: str, s, launches: int) -> dict:
    """The quorum kernel at a path's own shapes — that run's final match
    matrix and lanes — against its plain version, timed, with its bound.
    These launches are not counted as the path's."""
    from rafting_tpu_torch import LEADER
    from rafting_tpu_torch.core.types import conf_new_of, conf_voters_of
    from rafting_tpu_torch.ops import quorum

    args = (s.match_idx.contiguous(), s.own_from, s.log.last, s.commit,
            s.active & (s.role == LEADER), conf_voters_of(s.conf_word),
            conf_new_of(s.conf_word))
    got = quorum.quorum_commit_cuda(*args)
    ref = quorum.quorum_commit_ref(*args)
    err = int((got.long() - ref.long()).abs().max())
    ms = _time_ms(lambda: quorum.quorum_commit_cuda(*args), 200)
    plain_ms = _time_ms(lambda: quorum.quorum_commit_ref(*args), 50)
    nbytes = sum(a.numel() * a.element_size() for a in args) + \
        got.numel() * got.element_size()
    P = s.match_idx.shape[-1]
    # Per lane: two masked sorting networks (P rounds of ~P-1 min/max
    # pairs), the full-lane min and the gates — ~4*P*P + 8*P + 16 ops.
    ops = got.numel() * (4 * P * P + 8 * P + 16)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT_OPS_PER_S * 1e3
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain on the path's inputs "
                             f"(max abs err {err})")
    return {"name": name, "route": "cuda",
            "source": "rafting_tpu_torch/ops/csrc/quorum_commit.cu",
            "replaces": "rafting_tpu/ops/quorum.py:231",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "bytes": nbytes}


def _kernel_line(k: dict) -> str:
    return (f"{k['ms'] * 1e3:.2f} us/launch (plain {k['plain_ms'] * 1e3:.2f}"
            f" us, bound {k['bound_ms'] * 1e3:.2f} us, {k['bytes']} bytes)")


def phase_main() -> dict:
    from rafting_tpu_torch import (
        LEADER, DeviceCluster, EngineConfig, committed_entries,
        run_cluster_ticks,
    )
    from rafting_tpu_torch.ops import quorum

    cfg = EngineConfig(n_groups=100_000, n_peers=3, log_slots=64, batch=8,
                       max_submit=8, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8, pre_vote=True)
    N, G = cfg.n_peers, cfg.n_groups
    torch.cuda.reset_peak_memory_stats()
    c = DeviceCluster(cfg, seed=0, device="cuda")
    load = torch.full((N, G), cfg.max_submit, dtype=torch.int32,
                      device="cuda")
    run = lambda k, sub: run_cluster_ticks(
        cfg, k, c.states, c.inflight, c.last_info, c.conn, sub,
        device="cuda")

    c.states, c.inflight, c.last_info = run(60, load)
    torch.cuda.synchronize()
    before = int(committed_entries(c.states))

    T = 64
    quorum.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    c.states, c.inflight, c.last_info = run(T, load)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = quorum.launch_counts["quorum_commit"]
    after = int(committed_entries(c.states))
    if launches != T:
        raise AssertionError(f"quorum kernel launched {launches} times in "
                             f"{T} ticks (want one per tick)")

    idle = torch.zeros((N, G), dtype=torch.int32, device="cuda")
    c.states, c.inflight, c.last_info = run(15, idle)
    snap = c.snapshot()
    n_lead = (snap["role"] == LEADER).sum(axis=0)
    if not (n_lead == 1).all():
        raise AssertionError(f"{int((n_lead != 1).sum())} groups without "
                             f"exactly one leader")
    if not (snap["commit"] > 0).all():
        raise AssertionError("a group committed nothing")
    if not (snap["commit"] == snap["commit"][0:1]).all():
        raise AssertionError("commit indices differ across nodes after "
                             "the drain")
    peak = torch.cuda.max_memory_allocated()

    kern = _kernel_entry("quorum_commit", c.states, launches)
    commits = after - before
    log(f"[main] 100000 groups x 3 nodes: {commits} commits in {T} ticks, "
        f"{commits / secs:.0f} commits/s, {secs / T * 1e3:.3f} ms/tick; "
        f"quorum_commit {launches} launches, {_kernel_line(kern)}; "
        f"peak memory {peak / 2**30:.3f} GiB; "
        f"leaders {int(n_lead.sum())}, commit min {int(snap['commit'].min())}")
    return kern


# The nemesis phase's healthy settle after chaos_mix.  The per-group
# election lottery has a slow tail: at 100k groups x 5 nodes every group
# had one leader again within 50 settle ticks (H100; PERF.md §4), and 200
# leaves four times that.
NEMESIS_SETTLE = 200


def nemesis_cfg():
    """BASELINE.json configs[3] (100k groups, 5 peers, AppendEntries +
    RequestVote under partition) with every optional subtree on."""
    from rafting_tpu_torch import EngineConfig
    return EngineConfig(n_groups=100_000, n_peers=5, log_slots=64, batch=8,
                        max_submit=8, election_ticks=10, heartbeat_ticks=3,
                        rpc_timeout_ticks=8, pre_vote=True, trace_depth=16,
                        heat=True, check_quorum=True, debug_checks=True)


def phase_nemesis() -> dict:
    from rafting_tpu_torch import (
        LEADER, DeviceCluster, committed_entries, raise_debug_violations,
        run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit import nemesis
    from rafting_tpu_torch.testkit.invariants import (
        ClusterChecker, cluster_snapshot,
    )

    cfg = nemesis_cfg()
    N, G, dev = cfg.n_peers, cfg.n_groups, "cuda"
    # A healthy warm-up first: the split brain must cut leaders off, or
    # CheckQuorum has no leader on the minority side to depose.
    WARM, CHAOS, WINDOW = 50, 150, 50
    t3 = CHAOS // 3
    split = range(WARM + t3 // 4, WARM + 3 * t3 // 4)  # split-brain ticks
    sched = nemesis.concat(nemesis.healthy(N, WARM, dev),
                           nemesis.chaos_mix(N, CHAOS, seed=0, device=dev),
                           nemesis.healthy(N, NEMESIS_SETTLE, dev))
    T = sched.n_ticks
    crash_np = sched.crash.cpu().numpy()

    torch.cuda.reset_peak_memory_stats()
    c = DeviceCluster(cfg, seed=0, device=dev)
    states, inflight, info = c.states, c.inflight, c.last_info
    load = torch.full((N, G), cfg.max_submit, dtype=torch.int32, device=dev)
    chk = ClusterChecker(cfg)
    chk.check(cluster_snapshot(states))
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    downs, split_downs, viol = zero(), zero(), zero()
    run_s = chaos_s = audit_s = 0.0
    chaos_commits = committed = 0
    quorum.reset_launch_counts()
    for lo in range(0, T, WINDOW):
        hi = min(lo + WINDOW, T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        for t in range(lo, hi):
            states, inflight, info = run_cluster_ticks_nemesis(
                cfg, states, inflight, info,
                tree_map(lambda a: a[t:t + 1], sched), load, device=dev)
            d = info.cq_stepdown.sum()
            downs += d
            if t in split:
                split_downs += d
            viol += (info.debug_viol != 0).sum()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_s += secs
        t0 = time.perf_counter()
        snap = cluster_snapshot(states)
        chk.check(snap, crashed=crash_np[lo:hi].any(axis=0))
        raise_debug_violations(info, f"nemesis ticks {lo}..{hi}")
        if int(viol):
            raise AssertionError(f"{int(viol)} lanes reported a debug_viol "
                                 f"code by tick {hi}")
        audit_s += time.perf_counter() - t0
        before, committed = committed, int(committed_entries(states))
        n_lead = (snap["role"] == LEADER).sum(axis=0)
        if WARM <= lo and hi <= WARM + CHAOS:
            chaos_s += secs
            chaos_commits += committed - before
        log(f"[nemesis] ticks {lo:4d}..{hi:4d}: {secs / (hi - lo) * 1e3:.3f} "
            f"ms/tick, committed {committed}, groups without exactly one "
            f"leader {int((n_lead != 1).sum())}, step-downs so far "
            f"{int(downs)}")
    launches = quorum.launch_counts["quorum_commit"]
    if launches != T:
        raise AssertionError(f"quorum kernel launched {launches} times in "
                             f"{T} nemesis ticks (want one per tick)")
    t0 = time.perf_counter()
    chk.check_log_matching(snap)
    audit_s += time.perf_counter() - t0
    n_lead = (snap["role"] == LEADER).sum(axis=0)
    if not (n_lead == 1).all():
        raise AssertionError(f"{int((n_lead != 1).sum())} groups without "
                             f"exactly one leader after {NEMESIS_SETTLE} "
                             f"settle ticks")
    if not (snap["commit"].max(axis=0) > 0).all():
        raise AssertionError("a group committed nothing under the nemesis")
    if int(split_downs) == 0:
        raise AssertionError("no CheckQuorum step-down in the split-brain "
                             f"window (ticks {split.start}..{split.stop})")
    peak = torch.cuda.max_memory_allocated()
    kern = _kernel_entry("quorum_commit[P=5 nemesis]", states, launches)
    log(f"[nemesis] {G} groups x {N} nodes, trace/heat/check_quorum/"
        f"debug_checks on, {WARM} warm-up + {CHAOS} chaos + "
        f"{NEMESIS_SETTLE} settle ticks: "
        f"{run_s / T * 1e3:.3f} ms/tick overall, {chaos_s / CHAOS * 1e3:.3f} "
        f"ms/tick and {chaos_commits / chaos_s:.0f} commits/s under faults "
        f"({chaos_commits} commits in {CHAOS} ticks); audits {audit_s:.2f}s; "
        f"CheckQuorum step-downs {int(downs)} ({int(split_downs)} in the "
        f"split-brain window); trace events {int(states.trace.n.sum())}; "
        f"heat rpcs {int(states.heat.sent.sum())}; peak memory "
        f"{peak / 2**30:.3f} GiB; leaders {int(n_lead.sum())}; "
        f"quorum_commit {launches} launches, {_kernel_line(kern)}")
    return kern


def phase_runtime_parity() -> None:
    import tempfile
    from rafting_tpu_torch import EngineConfig, LocalCluster
    from rafting_tpu_torch.testkit.lockstep import pinned_env, run_script
    cfg = EngineConfig(n_groups=64, n_peers=3, log_slots=32, batch=4,
                       max_submit=4, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8)
    for pipeline in (False, True):
        with tempfile.TemporaryDirectory() as root, pinned_env():
            t0 = time.perf_counter()
            cl = [LocalCluster(cfg, os.path.join(root, d), pipeline=pipeline,
                               device=d) for d in ("cuda", "cpu")]
            try:
                r = run_script(cl)
            finally:
                for c in cl:
                    c.close()
        log(f"[runtime-parity] pipeline={pipeline}: 64 groups x 3 RaftNodes "
            f"on CUDA == on CPU at every one of {r['rounds']} rounds "
            f"(killed node {r['victim']}, {len(r['acked'])} acknowledged "
            f"submissions), machine files byte-equal "
            f"({sum(len(b) for b in r['files'].values())} bytes); "
            f"{time.perf_counter() - t0:.1f}s")


# BASELINE.json configs[2] driven as bench_runtime.py drives its 10k-group
# scale (_shape: 8 entries per led group per round, 512 log slots; batch
# and max_submit 32).  Its 25 measured rounds are cut to 10: a round took
# 6.6 s on the H100 machine's host, and the phase must leave the script
# inside its time limit (PERF.md §4).
RUNTIME_GROUPS = 10_000
RUNTIME_WARMUP, RUNTIME_ROUNDS, RUNTIME_BURST = 5, 10, 8
RUNTIME_SAMPLE = 512


class _PayloadAudit:
    """Reads the committed payloads of a seeded sample of groups from
    every node's LogStore after each round (compaction keeps the newest
    committed entries, so nothing is missed between two reads), and the
    indices of every acknowledged submission in the sample.  ``seconds``
    is the time spent reading, which the round timing leaves out."""

    def __init__(self, G: int, n: int, seed: int = 0):
        self.groups = np.sort(np.random.default_rng(seed).choice(
            G, n, replace=False)).tolist()
        self.sample = set(self.groups)
        self.read: dict = {}        # (node, group) -> {index: payload}
        self.upto: dict = {}        # (node, group) -> last index read
        self.sinks: list = []       # (group, payloads, sink)
        self.seconds = 0.0

    def offer(self, node, led: np.ndarray, burst: list) -> None:
        sinks = node.submit_batch_many(led, burst)
        for g, sink in zip(led.tolist(), sinks):
            if g in self.sample:
                self.sinks.append((g, burst, sink))

    def collect(self, nodes) -> None:
        t0 = time.perf_counter()
        for i, n in nodes.items():
            for g in self.groups:
                got = self.read.setdefault((i, g), {})
                lo = max(self.upto.get((i, g), 0), n.store.floor(g)) + 1
                hi = min(int(n.h_commit[g]), n.store.tail(g))
                if hi < lo:
                    continue
                for k, p in enumerate(n.store.payloads_window(
                        g, lo, hi - lo + 1)):
                    if p is None:
                        break
                    got[lo + k] = p
                    self.upto[(i, g)] = lo + k
        self.seconds += time.perf_counter() - t0

    def check(self, node_ids) -> tuple:
        """Agreement on every index two nodes both read; every
        acknowledged submission read back from a majority of the nodes,
        and from every node that read its index.  Returns (acknowledged,
        read back from all nodes)."""
        for g in self.groups:
            have = [self.read.get((i, g), {}) for i in node_ids]
            for a in have:
                for b in have:
                    for idx in a.keys() & b.keys():
                        if a[idx] != b[idx]:
                            raise AssertionError(
                                f"group {g} index {idx}: replicas disagree")
        acked = everywhere = 0
        for g, burst, sink in self.sinks:
            f = sink.future
            if not f.done() or f.exception() is not None:
                continue
            for idx, p in zip(f.result(), burst):
                acked += 1
                found = [self.read.get((i, g), {}).get(idx)
                         for i in node_ids]
                hits = [x for x in found if x is not None]
                if any(x != p for x in hits) or \
                        2 * len(hits) <= len(node_ids):
                    raise AssertionError(
                        f"acknowledged submission lost: group {g} index "
                        f"{idx} read back on {len(hits)} node(s)")
                everywhere += len(hits) == len(node_ids)
        return acked, everywhere


def phase_runtime() -> dict:
    import tempfile
    from rafting_tpu_torch import LEADER, EngineConfig, LocalCluster
    from rafting_tpu_torch.log.wal import native_available
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit.fixtures import NullProvider

    cfg = EngineConfig(n_groups=RUNTIME_GROUPS, n_peers=3, log_slots=512,
                       batch=32, max_submit=32, election_ticks=10,
                       heartbeat_ticks=3, rpc_timeout_ticks=8, pre_vote=True)
    G = cfg.n_groups
    audit = _PayloadAudit(G, RUNTIME_SAMPLE)
    ticks = 0

    def tick_round():
        nonlocal ticks
        for n in c.nodes.values():
            n.tick()
        ticks += len(c.nodes)
        audit.collect(c.nodes)

    def leaders():
        return (np.stack([n.h_role for n in c.nodes.values()])
                == LEADER).sum(axis=0)

    def offer(r):
        burst = [f"r{r:04d}-{j:02d}-".encode().ljust(64, b"x")
                 for j in range(RUNTIME_BURST)]
        for n in c.nodes.values():
            audit.offer(n, np.nonzero((n.h_role == LEADER) & n.h_ready)[0],
                        burst)

    def mean_commits():
        return sum(int(n.h_commit.astype(np.int64).sum())
                   for n in c.nodes.values()) / len(c.nodes)

    root = tempfile.mkdtemp(prefix="runtime-")
    torch.cuda.reset_peak_memory_stats()
    quorum.reset_launch_counts()
    t_boot = time.perf_counter()
    c = LocalCluster(cfg, root, provider_factory=NullProvider, seed=0,
                     device="cuda")
    try:
        node0 = c.nodes[0]
        if not node0.pipeline:
            raise AssertionError("the durable pipeline is off on the card")
        settle = 0
        while not (leaders() >= 1).all():
            tick_round()
            settle += 1
            if settle > 300:
                raise AssertionError(f"{int((leaders() == 0).sum())} "
                                     f"groups without a leader after "
                                     f"{settle} rounds")
        settle_s = time.perf_counter() - t_boot
        r = 0
        for _ in range(RUNTIME_WARMUP):
            offer(r)
            tick_round()
            r += 1
        for n in c.nodes.values():
            n.metrics.histogram("tick_latency_s").reset()
            for stage in n.metrics.breakdown():
                n.metrics.histogram(f"tick_stage_{stage}").reset()
        start = mean_commits()
        l0, t_meas = quorum.launch_counts["quorum_commit"], ticks
        torch.cuda.synchronize()
        a0, t0 = audit.seconds, time.perf_counter()
        for _ in range(RUNTIME_ROUNDS):
            offer(r)
            tick_round()
            r += 1
        elapsed = time.perf_counter() - t0 - (audit.seconds - a0)
        commits = mean_commits() - start
        meas_launches = quorum.launch_counts["quorum_commit"] - l0
        meas_ticks = ticks - t_meas
        slow = max(c.nodes.values(),
                   key=lambda n: n.metrics.histogram("tick_latency_s").total)
        h = slow.metrics.histogram("tick_latency_s")
        p50, p99, mean, top = (h.quantile(0.5), h.quantile(0.99),
                               h.total / max(h.n, 1), h.max)
        stages = {k: v["mean"] for k, v in slow.metrics.breakdown().items()}

        # Leader churn: the node leading the most groups dies.
        led = {i: int((n.h_role == LEADER).sum()) for i, n in c.nodes.items()}
        victim = max(led, key=led.get)
        c.kill_node(victim)
        a0, t0 = audit.seconds, time.perf_counter()
        churn = 0
        while not (leaders() >= 1).all():
            tick_round()
            churn += 1
            if churn > 300:
                raise AssertionError(f"{int((leaders() == 0).sum())} "
                                     f"groups leaderless {churn} rounds "
                                     f"after the kill")
        churn_s = time.perf_counter() - t0 - (audit.seconds - a0)
        c.restart_node(victim)
        drain = 0
        while True:
            tick_round()
            drain += 1
            hc = np.stack([n.h_commit for n in c.nodes.values()])
            if drain >= 10 and (hc == hc[0:1]).all() \
                    and (leaders() == 1).all():
                break
            if drain > 300:
                raise AssertionError(
                    f"not converged {drain} rounds after the restart: "
                    f"{int((hc != hc[0:1]).any(axis=0).sum())} groups with "
                    f"differing commits, {int((leaders() != 1).sum())} "
                    f"without exactly one leader")
        acked, everywhere = audit.check(sorted(c.nodes))
        launches = quorum.launch_counts["quorum_commit"]
        if launches != ticks or meas_launches != meas_ticks:
            raise AssertionError(f"quorum kernel launched {launches} times "
                                 f"in {ticks} node ticks (want one per "
                                 f"tick)")
        if acked == 0:
            raise AssertionError("no acknowledged submission in the sample")
        peak = torch.cuda.max_memory_allocated()
        kern = _kernel_entry("quorum_commit[runtime]", c.nodes[0].state,
                             launches)
        native = bool(native_available() and node0._native_host)
        log(f"[runtime] {G} groups x 3 RaftNodes on the card, pipelined, "
            f"NullProvider: settle {settle} rounds ({settle_s:.1f}s incl. "
            f"boot); measured {RUNTIME_ROUNDS} rounds: "
            f"{commits / elapsed:.0f} durable commits/s, "
            f"{elapsed / RUNTIME_ROUNDS * 1e3:.1f} ms/round; slowest node "
            f"tick p50 <= {p50 * 1e3:.1f} ms, p99 <= {p99 * 1e3:.1f} ms "
            f"(2x histogram buckets), mean {mean * 1e3:.1f} ms, max "
            f"{top * 1e3:.1f} ms; stage "
            f"means (ms) " + ", ".join(
                f"{k} {v * 1e3:.2f}" for k, v in sorted(stages.items()))
            + f"; native WAL engine {native}")
        log(f"[runtime] churn: killed node {victim} (led {led[victim]} "
            f"groups); every group led again after {churn} rounds "
            f"({churn_s:.2f}s); restarted from its WAL, converged after "
            f"{drain} rounds; {acked} acknowledged submissions in "
            f"{RUNTIME_SAMPLE} sampled groups all read back ({everywhere} "
            f"on all 3 nodes; reading them took {audit.seconds:.1f}s, "
            f"outside the timings); quorum_commit {launches} launches in "
            f"{ticks} node ticks, {_kernel_line(kern)}; peak memory "
            f"{peak / 2**30:.3f} GiB")
        return kern
    finally:
        c.close()
        shutil.rmtree(root, ignore_errors=True)


def _profile(label: str, tick) -> None:
    """8 ticks of ``tick()`` under torch.profiler: the top kernels by
    device time and the device-busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    T = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(T):
            tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    launches = sum(e.count for e in rows)
    log(f"[profile {label}] {T} ticks: wall {wall / T * 1e3:.3f} ms/tick, "
        f"device busy {busy / T * 1e3:.3f} ms/tick ({busy / wall:.1%} of "
        f"wall), {launches / T:.0f} device ops/tick")
    for e in rows[:10] + [e for e in rows if "qc_kernel" in e.key]:
        log(f"[profile {label}]   {e.self_device_time_total / T:9.1f} "
            f"us/tick {e.count / T:6.1f}/tick  {e.key[:70]}")


def phase_profile() -> None:
    """``--profile`` only: where a tick's device time goes on each path —
    8 steady headline ticks, then 8 nemesis ticks inside the split-brain
    window (all four optional subtrees on)."""
    from rafting_tpu_torch import (
        DeviceCluster, EngineConfig, run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.testkit import nemesis
    cfg = EngineConfig(n_groups=100_000, n_peers=3)
    c = DeviceCluster(cfg, seed=0, device="cuda")
    for _ in range(60):
        c.tick(submit_n=cfg.max_submit)
    _profile("headline", lambda: c.tick(submit_n=cfg.max_submit))
    del c

    cfg = nemesis_cfg()
    c = DeviceCluster(cfg, seed=0, device="cuda")
    sched = nemesis.concat(nemesis.healthy(cfg.n_peers, 50, "cuda"),
                           nemesis.chaos_mix(cfg.n_peers, 150, seed=0,
                                             device="cuda"))
    load = torch.full((cfg.n_peers, cfg.n_groups), cfg.max_submit,
                      dtype=torch.int32, device="cuda")
    states, inflight, info, t = c.states, c.inflight, c.last_info, 0

    def tick():
        nonlocal states, inflight, info, t
        states, inflight, info = run_cluster_ticks_nemesis(
            cfg, states, inflight, info,
            tree_map(lambda a: a[t:t + 1], sched), load, device="cuda")
        t += 1

    for _ in range(64):      # warm-up, then into the split (ticks 62..87)
        tick()
    _profile("nemesis", tick)


def main() -> int:
    sys.path.insert(0, HERE)
    card = phase_probe()
    phase_build()
    phase_kernel()
    phase_parity()
    phase_parity_nemesis()
    kernels = [phase_main(), phase_nemesis()]
    phase_runtime_parity()
    kernels.append(phase_runtime())
    if "--profile" in sys.argv[1:]:
        phase_profile()
    for k in kernels:
        del k["bytes"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
