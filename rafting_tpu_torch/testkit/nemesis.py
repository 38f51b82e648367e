"""Nemesis schedule generators and audited chaos runs for the port.

The port's own copy of ``rafting_tpu/testkit/nemesis.py``: seeded
generators that compile Jepsen-style scenarios — split brain, rolling
partitions, crash-restart storms, clock stalls, lossy and duplicating
links — into the dense per-tick ``FaultSchedule`` tensors, and the audit
harness that runs a schedule through ``run_cluster_ticks_nemesis`` in
windows and checks every Raft safety invariant between them.

The generators draw from numpy with the same calls in the same order as
the JAX package, so one seed gives one schedule in both packages.  The
tensors go on ``device``, the card unless the caller asks otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.types import (
    EngineConfig, FaultSchedule, resolve_device, tree_map,
)

__all__ = [
    "healthy", "split_brain", "rolling_partition", "crash_storm",
    "clock_stalls", "lossy_links", "compose", "concat", "chaos_mix",
    "run_nemesis_audited", "assert_nemesis_deterministic",
]


def _as_schedule(link_up, crash, stall, dup, device) -> FaultSchedule:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)
    return FaultSchedule(link_up=t(link_up), crash=t(crash),
                         stall=t(stall), dup=t(dup))


def _blank(n_peers: int, n_ticks: int):
    """Host-side all-healthy arrays for the generators to mutate."""
    return (np.ones((n_ticks, n_peers, n_peers), bool),
            np.zeros((n_ticks, n_peers), bool),
            np.zeros((n_ticks, n_peers), bool),
            np.zeros((n_ticks, n_peers, n_peers), bool))


def healthy(n_peers: int, n_ticks: int, device=None) -> FaultSchedule:
    """All links up, nothing crashes."""
    return FaultSchedule.healthy(n_peers, n_ticks, device)


def split_brain(n_peers: int, n_ticks: int, *, start: int = 0,
                stop: Optional[int] = None,
                sides: Optional[Sequence[Sequence[int]]] = None,
                seed: int = 0, device=None) -> FaultSchedule:
    """Partition the cluster into ``sides`` for ticks [start, stop)
    (default: a seeded near-half split); nodes reach only their own
    side, and the cluster heals for the remaining ticks."""
    link_up, crash, stall, dup = _blank(n_peers, n_ticks)
    stop = n_ticks if stop is None else stop
    if sides is None:
        perm = np.random.default_rng(seed).permutation(n_peers)
        k = n_peers // 2
        sides = [perm[:k].tolist(), perm[k:].tolist()]
    conn = np.zeros((n_peers, n_peers), bool)
    for side in sides:
        for a in side:
            for b in side:
                conn[a, b] = True
    link_up[start:stop] = conn
    return _as_schedule(link_up, crash, stall, dup, device)


def rolling_partition(n_peers: int, n_ticks: int, *, period: int = 20,
                      heal_gap: int = 5, device=None) -> FaultSchedule:
    """Isolate each node in turn: node ``w % N`` is cut off for the first
    ``period - heal_gap`` ticks of window w, then the cluster heals for
    ``heal_gap`` ticks — leader churn that never loses a quorum."""
    link_up, crash, stall, dup = _blank(n_peers, n_ticks)
    for t in range(n_ticks):
        w, off = divmod(t, period)
        if off < period - heal_gap:
            victim = w % n_peers
            link_up[t, victim, :] = False
            link_up[t, :, victim] = False
            link_up[t, victim, victim] = True
    return _as_schedule(link_up, crash, stall, dup, device)


def crash_storm(n_peers: int, n_ticks: int, *, rate: float = 0.02,
                seed: int = 0, max_down: Optional[int] = None,
                device=None) -> FaultSchedule:
    """Random crash-restarts: each (tick, node) crashes with probability
    ``rate``; at most ``max_down`` per tick (default: keep a majority
    standing)."""
    link_up, crash, stall, dup = _blank(n_peers, n_ticks)
    rng = np.random.default_rng(seed)
    cap = (n_peers - (n_peers // 2 + 1)) if max_down is None else max_down
    hits = rng.random((n_ticks, n_peers)) < rate
    for t in range(n_ticks):
        idx = np.nonzero(hits[t])[0]
        if cap >= 0 and len(idx) > cap:
            idx = rng.permutation(idx)[:cap]
        crash[t, idx] = True
    return _as_schedule(link_up, crash, stall, dup, device)


def clock_stalls(n_peers: int, n_ticks: int, *, rate: float = 0.01,
                 max_len: int = 8, seed: int = 0, device=None
                 ) -> FaultSchedule:
    """GC-pause regime: nodes freeze for random windows of 1..max_len
    ticks (clock, timers, sends and receives all stop)."""
    link_up, crash, stall, dup = _blank(n_peers, n_ticks)
    rng = np.random.default_rng(seed)
    for n in range(n_peers):
        t = 0
        while t < n_ticks:
            if rng.random() < rate:
                ln = int(rng.integers(1, max_len + 1))
                stall[t:t + ln, n] = True
                t += ln
            else:
                t += 1
    return _as_schedule(link_up, crash, stall, dup, device)


def lossy_links(n_peers: int, n_ticks: int, *, drop_p: float = 0.1,
                dup_p: float = 0.0, seed: int = 0, device=None
                ) -> FaultSchedule:
    """Flaky network: every directed link drops each tick with ``drop_p``
    and duplicates delivered traffic with ``dup_p``; self-links never
    drop."""
    link_up, crash, stall, dup = _blank(n_peers, n_ticks)
    rng = np.random.default_rng(seed)
    link_up &= rng.random(link_up.shape) >= drop_p
    if dup_p > 0:
        dup |= rng.random(dup.shape) < dup_p
    link_up |= np.eye(n_peers, dtype=bool)[None]
    return _as_schedule(link_up, crash, stall, dup, device)


def compose(*scheds: FaultSchedule) -> FaultSchedule:
    """Overlay schedules of equal length: a link is up iff up in all, a
    node crashes/stalls/dups if any says so."""
    assert scheds, "compose() needs at least one schedule"
    T = scheds[0].n_ticks
    assert all(s.n_ticks == T for s in scheds), "tick counts differ"
    out = scheds[0]
    for s in scheds[1:]:
        out = FaultSchedule(link_up=out.link_up & s.link_up,
                            crash=out.crash | s.crash,
                            stall=out.stall | s.stall,
                            dup=out.dup | s.dup)
    return out


def concat(*scheds: FaultSchedule) -> FaultSchedule:
    """Concatenate schedules along the tick axis (phased scenarios)."""
    assert scheds, "concat() needs at least one schedule"
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *scheds)


def chaos_mix(n_peers: int, n_ticks: int, *, seed: int = 0, device=None
              ) -> FaultSchedule:
    """The three-regime acceptance scenario, phased over the run: a
    split-brain window plus rolling partitions; then a crash-restart
    storm plus clock stalls; then lossy links with duplication.  The
    remainder of ``n_ticks / 3`` is padded healthy — not enough settle
    time for liveness: callers asserting one leader per group append
    healthy ticks (``run_nemesis_audited(settle_ticks=...)``)."""
    t3 = n_ticks // 3
    tail = max(n_ticks - 3 * t3, 0)
    kw = dict(device=device)
    p1 = compose(
        split_brain(n_peers, t3, start=t3 // 4, stop=3 * t3 // 4, seed=seed,
                    **kw),
        rolling_partition(n_peers, t3, period=max(8, t3 // 4), heal_gap=4,
                          **kw),
    )
    p2 = compose(
        crash_storm(n_peers, t3, rate=0.03, seed=seed + 1, **kw),
        clock_stalls(n_peers, t3, rate=0.02, max_len=5, seed=seed + 2, **kw),
    )
    p3 = lossy_links(n_peers, t3, drop_p=0.15, dup_p=0.1, seed=seed + 3,
                     **kw)
    parts = [p1, p2, p3]
    if tail:
        parts.append(healthy(n_peers, tail, **kw))
    return concat(*parts)


# --------------------------------------------------------------- audit ----

def run_nemesis_audited(cfg: EngineConfig, sched: FaultSchedule, *,
                        seed: int = 0, submit: int = 2,
                        audit_every: int = 32, settle_ticks: int = 0,
                        checker=None, device=None):
    """Run a fault schedule, auditing safety between windows of
    ``audit_every`` ticks (the host reads the state only at window
    boundaries).  ``settle_ticks`` appends an all-healthy tail so callers
    can assert liveness after the chaos.  The schedule is moved to the
    run's device.  Returns ``(states, checker, snapshot)``."""
    from ..core.cluster import DeviceCluster
    from ..core.sim import run_cluster_ticks_nemesis
    from .invariants import ClusterChecker, cluster_snapshot

    dev = resolve_device(device)
    sched = tree_map(lambda a: a.to(dev), sched)
    if settle_ticks:
        sched = concat(sched, healthy(cfg.n_peers, settle_ticks, dev))
    c = DeviceCluster(cfg, seed=seed, device=dev)
    chk = checker if checker is not None else ClusterChecker(cfg)
    states, inflight, info = c.states, c.inflight, c.last_info
    sub = torch.full((cfg.n_peers, cfg.n_groups), submit, dtype=torch.int32,
                     device=dev)
    T = sched.n_ticks
    snap = cluster_snapshot(states)
    chk.check(snap)
    crash_np = sched.crash.cpu().numpy()
    done = 0
    while done < T:
        step = min(audit_every, T - done)
        window = tree_map(lambda a: a[done:done + step], sched)
        states, inflight, info = run_cluster_ticks_nemesis(
            cfg, states, inflight, info, window, sub, device=dev)
        crashed = crash_np[done:done + step].any(axis=0)
        done += step
        snap = cluster_snapshot(states)
        chk.check(snap, crashed=crashed)
    chk.check_log_matching(snap)
    return states, chk, snap


def assert_nemesis_deterministic(cfg: EngineConfig, sched: FaultSchedule, *,
                                 seed: int = 0, submit: int = 2,
                                 device=None) -> None:
    """Same seed + same schedule => bit-identical final state: runs the
    whole schedule twice from two independently built clusters and
    requires every lane (PRNG keys and per-node clocks included) to
    match exactly."""
    import dataclasses

    from ..core.cluster import DeviceCluster
    from ..core.sim import run_cluster_ticks_nemesis
    from ..core.types import _Tree

    dev = resolve_device(device)
    sched = tree_map(lambda a: a.to(dev), sched)
    sub = torch.full((cfg.n_peers, cfg.n_groups), submit, dtype=torch.int32,
                     device=dev)

    def one_run():
        c = DeviceCluster(cfg, seed=seed, device=dev)
        states, _, _ = run_cluster_ticks_nemesis(
            cfg, c.states, c.inflight, c.last_info, sched, sub, device=dev)
        return states

    def same(a, b, path):
        if isinstance(a, _Tree):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        elif a is None or b is None:
            assert a is None and b is None, path
        elif not torch.equal(a, b):
            raise AssertionError(f"nemesis run not deterministic at {path}")

    same(one_run(), one_run(), "state")
