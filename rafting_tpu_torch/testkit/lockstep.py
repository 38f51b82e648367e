"""Lockstep runner: several ``LocalCluster``s run one scripted scenario
round by round, held equal at every round.

The clusters may be of either engine, on any device (the runner only
reads the host mirrors every ``RaftNode`` keeps: ``h_role``, ``h_term``,
``h_commit``, ``h_leader``), so one script holds the port on the card
equal to the port on the CPU, or the port equal to the reference engine.
Every decision of the script (who leads, whom to kill, when a leader is
ready) is read from the first cluster; the per-round check proves the
others would have decided the same.

The script (``run_script``): elect a leader in every group, wait until
each is ready, submit ``n_submit`` commands per group through its leader
and drain them; kill the node leading group 0, re-elect every group among
the survivors, submit again; restart the killed node from its WAL and
drain.  At the end every cluster's machine files are compared byte for
byte.

With ``lanes=True`` each round also holds every node's whole engine state
and the step info and outbox of its last tick equal across the clusters,
exactly (a port node's node axis of 1 is dropped; the PRNG key compares
as integers).  Snapshot downloads and checkpoints run on worker threads
and their results reach the tick at the next round after they finish, so
then each cluster waits for them after its tick, and all see them at the
same round.

Two host planes decide from wall-clock time: admission control (queue
sojourn) and the health plane (fsync latency → leadership evacuation).
Two clusters in one process see different times, so a loaded host can
push one of them over a threshold and not the other.  ``pinned_env``
turns both off through their own switches; build the clusters and run
the script inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Sequence

import numpy as np

from ..core.types import LEADER

MIRRORS = ("h_role", "h_term", "h_commit", "h_leader")
PINNED_ENV = {"RAFT_ADMISSION": "0", "RAFT_HEALTH": "0"}


@contextlib.contextmanager
def pinned_env():
    """``PINNED_ENV`` in ``os.environ`` for the block (restored after):
    every ``RaftNode`` built inside, restarts included, runs without the
    wall-clock planes."""
    saved = {k: os.environ.get(k) for k in PINNED_ENV}
    os.environ.update(PINNED_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mirrors(cluster) -> Dict[int, Dict[str, np.ndarray]]:
    """Host mirrors of every live node, copied."""
    return {i: {k: np.array(getattr(n, k)) for k in MIRRORS}
            for i, n in sorted(cluster.nodes.items())}


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def _copy_tree(tree):
    """A container of host arrays, copied (a later tick may reuse them)."""
    return type(tree)(**{f.name: (None if getattr(tree, f.name) is None
                                  else np.array(getattr(tree, f.name)))
                         for f in dataclasses.fields(tree)})


def same_lanes(a, b, path: str) -> None:
    """Two containers of the same fields (either engine's state, step
    info or outbox), leaf by leaf, exactly.  A leading node axis of 1 on
    one side only is dropped."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        where = f"{path}.{f.name}"
        if x is None or y is None:
            assert x is None and y is None, f"{where}: only one side is None"
        elif dataclasses.is_dataclass(x):
            same_lanes(x, y, where)
        else:
            x, y = _numpy(x), _numpy(y)
            if x.ndim == y.ndim + 1 and x.shape[0] == 1:
                x = x[0]
            elif y.ndim == x.ndim + 1 and y.shape[0] == 1:
                y = y[0]
            if x.shape != y.shape:
                raise AssertionError(f"{where}: shape {x.shape} vs "
                                     f"{y.shape}")
            x, y = x.astype(np.int64), y.astype(np.int64)
            if not np.array_equal(x, y):
                at = tuple(np.argwhere(x != y)[0])
                raise AssertionError(
                    f"{where} differs in {int((x != y).sum())} lane(s), "
                    f"first at {at}: {x[at]} vs {y[at]}")


def _record_fetches(cluster) -> dict:
    """node id -> copies of the step info and outbox its last tick
    fetched, for every node of ``cluster``, restarts included."""
    last: dict = {}

    def hook(node):
        real = node._fetch

        def _fetch(ctx):
            real(ctx)
            last[node.node_id] = (_copy_tree(ctx.info),
                                  _copy_tree(ctx.outbox))
        node._fetch = _fetch

    real_start = cluster.start_node

    def start_node(i):
        node = real_start(i)
        hook(node)
        return node
    cluster.start_node = start_node
    for n in cluster.nodes.values():
        hook(n)
    return last


def quiesce(cluster, timeout: float = 60.0) -> None:
    """Wait until no node of ``cluster`` has a snapshot download or a
    checkpoint in flight."""
    deadline = time.monotonic() + timeout
    for n in cluster.nodes.values():
        while True:
            with n._snap_cv:
                busy = bool(n._snap_inflight)
            with n._ckpt_cv:
                done = {d[0] for d in n._ckpt_done}
                busy |= not n._ckpt_inflight <= done
            if not busy:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"node {n.node_id}: snapshot or "
                                     f"checkpoint workers busy for "
                                     f"{timeout:.0f}s")
            time.sleep(0.002)


class Lockstep:
    """Tick several clusters together and hold their mirrors equal (and,
    with ``lanes=True``, every node's state, step info and outbox)."""

    def __init__(self, clusters: Sequence, lanes: bool = False):
        assert len(clusters) >= 1
        self.clusters = list(clusters)
        self.rounds = 0
        self.fetched = [_record_fetches(c) for c in self.clusters] \
            if lanes else None

    @property
    def lead(self):
        return self.clusters[0]

    def check(self) -> None:
        ref = mirrors(self.lead)
        for k, c in enumerate(self.clusters[1:], 1):
            got = mirrors(c)
            assert sorted(got) == sorted(ref), \
                f"round {self.rounds}: live nodes {sorted(got)} != " \
                f"{sorted(ref)} (cluster {k})"
            for i in ref:
                for name in MIRRORS:
                    a, b = ref[i][name], got[i][name]
                    if not np.array_equal(a, b):
                        bad = np.nonzero(a != b)[0]
                        raise AssertionError(
                            f"round {self.rounds}: cluster {k} node {i} "
                            f"{name} differs in {bad.size} group(s), first "
                            f"{int(bad[0])}: {int(a[bad[0]])} vs "
                            f"{int(b[bad[0]])}")

    def check_lanes(self) -> None:
        ref = self.lead
        for k, c in enumerate(self.clusters[1:], 1):
            for i, n in sorted(c.nodes.items()):
                at = f"round {self.rounds}: cluster {k} node {i}"
                same_lanes(n.state, ref.nodes[i].state, f"{at} state")
                (info, out), (rinfo, rout) = (self.fetched[k][i],
                                              self.fetched[0][i])
                same_lanes(info, rinfo, f"{at} info")
                same_lanes(out, rout, f"{at} outbox")

    def tick(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            for c in self.clusters:
                c.tick()
                if self.fetched is not None:
                    quiesce(c)
            self.rounds += 1
            self.check()
            if self.fetched is not None:
                self.check_lanes()

    def tick_until(self, pred, max_rounds: int, what: str) -> None:
        for _ in range(max_rounds):
            if pred():
                return
            self.tick()
        raise AssertionError(f"{what} not reached in {max_rounds} rounds")

    def each(self, fn) -> list:
        """Apply ``fn(cluster)`` to every cluster (a kill, a restart)."""
        return [fn(c) for c in self.clusters]

    # -- queries on the lead cluster --------------------------------------

    def leaders(self) -> np.ndarray:
        """[G] node leading each group (-1 none), highest term first."""
        nodes = self.lead.nodes
        G = self.lead.cfg.n_groups
        out = np.full(G, -1, np.int64)
        best = np.full(G, -1, np.int64)
        for i, n in sorted(nodes.items()):
            lead = (n.h_role == LEADER) & (n.h_term > best)
            out[lead] = i
            best[lead] = n.h_term[lead]
        return out

    def all_led_ready(self) -> bool:
        lead = self.leaders()
        if (lead < 0).any():
            return False
        nodes = self.lead.nodes
        return all(bool(nodes[int(lead[g])].h_ready[g])
                   for g in range(lead.size))

    def submit_all(self, tag: str, n_submit: int,
                   max_rounds: int = 400) -> List[tuple]:
        """Submit ``n_submit`` commands to every group through its leader
        in every cluster, drive until every future settles, and return
        the acknowledged ``(group, payload)`` pairs (the same in every
        cluster, or this raises)."""
        lead = self.leaders()
        futs = []
        for c in self.clusters:
            cf = []
            for g in range(lead.size):
                node = c.nodes[int(lead[g])]
                for j in range(n_submit):
                    p = f"g{g}-{tag}{j}".encode()
                    cf.append((g, p, node.submit(g, p)))
            futs.append(cf)
        self.tick_until(lambda: all(f.done() for cf in futs
                                    for _, _, f in cf),
                        max_rounds, f"submissions {tag} settled")
        outcomes = [[(g, p, f.exception() is None,
                      f.result() if f.exception() is None else None)
                     for g, p, f in cf] for cf in futs]
        for k, o in enumerate(outcomes[1:], 1):
            assert o == outcomes[0], \
                f"submission outcomes differ in cluster {k} ({tag})"
        return [(g, p) for g, p, ok, _ in outcomes[0] if ok]


def machine_bytes(cluster) -> Dict[tuple, bytes]:
    """Every (node, group) machine file of a ``FileMachineProvider``
    cluster, as bytes (missing file = b"")."""
    out = {}
    for i in sorted(cluster.nodes):
        for g in range(cluster.cfg.n_groups):
            path = cluster.machine_file(i, g)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[(i, g)] = f.read()
            else:
                out[(i, g)] = b""
    return out


def run_script(clusters: Sequence, n_submit: int = 2,
               drain_rounds: int = 40, max_rounds: int = 600,
               lanes: bool = False) -> dict:
    """Run the scripted scenario on ``clusters`` in lockstep (see the
    module docstring).  Returns ``{"rounds", "victim", "acked",
    "files"}``; raises AssertionError at the first round where the
    clusters differ, or if any phase does not finish."""
    ls = Lockstep(clusters, lanes=lanes)
    ls.check()
    ls.tick_until(ls.all_led_ready, max_rounds, "every group led and ready")
    acked = ls.submit_all("a", n_submit)
    victim = int(ls.leaders()[0])
    ls.each(lambda c: c.kill_node(victim))
    ls.tick_until(ls.all_led_ready, max_rounds,
                  "every group re-led and ready among survivors")
    acked += ls.submit_all("b", n_submit)
    ls.each(lambda c: c.restart_node(victim))
    ls.tick(drain_rounds)
    files = [machine_bytes(c) for c in clusters]
    for k, f in enumerate(files[1:], 1):
        diff = [key for key in f if f[key] != files[0].get(key)]
        assert not diff, \
            f"machine files differ in cluster {k}: (node, group) {diff[:4]}"
    return {"rounds": ls.rounds, "victim": victim, "acked": acked,
            "files": files[0]}
