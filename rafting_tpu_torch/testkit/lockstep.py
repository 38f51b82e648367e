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

The second script (``run_lifecycle_script``) drives the snapshot plane
and the group lifecycle: lanes closed and reopened, lanes purged (a
destroyed group) and reused, then the node leading the fewest groups
killed while the survivors load and compact until their WAL floor has
passed its log tail in every group, restarted, and caught up by a
snapshot install in every group; then a second round of closes and
purges.  Besides the per-round checks it holds the installs, the machine
files of every node and the copies each port node's step made into its
static state (``NodeStepper.copied``): a copy on exactly the rounds that
follow a lifecycle write, none on any other round.

With ``lanes=True`` each round also holds every node's whole engine state
and the step info and outbox of its last tick equal across the clusters,
exactly: shape and value, with the PRNG key compared as integers (the
port's node holds its state at ``[G]`` lanes, as the reference's does,
and the step info and outbox the node fetched are host arrays at the
reference's shapes too).  Snapshot downloads and checkpoints run on
worker threads and their results reach the tick at the next round after
they finish, so then each cluster waits for them after its tick, and all
see them at the same round.

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
from typing import Dict, List, Optional, Sequence

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
    info or outbox), leaf by leaf, exactly: a leaf whose shape differs
    fails."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        where = f"{path}.{f.name}"
        if x is None or y is None:
            assert x is None and y is None, f"{where}: only one side is None"
        elif dataclasses.is_dataclass(x):
            same_lanes(x, y, where)
        else:
            x, y = _numpy(x), _numpy(y)
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


def _copy_counts(cluster) -> Optional[dict]:
    """stepper -> leaves its ``_adopt`` copied so far, for every live node
    of ``cluster``; None for a cluster whose nodes carry no stepper (the
    reference's)."""
    steppers = [getattr(n, "_stepper", None) for n in cluster.nodes.values()]
    if any(st is None for st in steppers):
        return None
    return {st: st.copied for st in steppers}


def _copied_since(cluster, before: Optional[dict]) -> Optional[int]:
    now = _copy_counts(cluster)
    if now is None or before is None:
        return None
    return sum(v - before.get(st, 0) for st, v in now.items())


def record_installs(cluster) -> dict:
    """node id -> {"fetched": downloads handed to the tick, "stale":
    those it dropped (the lane closed, the group's pending record gone,
    or taken by an earlier download of the group in the same call: each
    install ends it), "failed": those whose install raised, "groups":
    [G] installs per group}, for every node of ``cluster``, restarts
    included."""
    G = cluster.cfg.n_groups
    out: dict = {}

    def hook(node):
        rec = out.setdefault(node.node_id, {
            "fetched": 0, "stale": 0, "failed": 0,
            "groups": np.zeros(G, np.int64)})
        real = node._install_snapshots

        def _install_snapshots(fetched):
            stale, seen = 0, set()
            for item in fetched:
                g = int(item[0])
                stale += g in seen or not node.h_active[g] \
                    or node.archive.pending(g) is None
                seen.add(g)
            done = real(fetched)
            rec["fetched"] += len(fetched)
            rec["stale"] += stale
            rec["failed"] += len(fetched) - stale - len(done)
            for d in done:
                rec["groups"][int(d[0])] += 1
            return done
        node._install_snapshots = _install_snapshots

    real_start = cluster.start_node

    def start_node(i):
        node = real_start(i)
        hook(node)
        return node
    cluster.start_node = start_node
    for n in cluster.nodes.values():
        hook(n)
    return out


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
        # Per round, per cluster: leaves the port nodes' steps copied into
        # their static state (None for the reference's nodes).
        self.copied: List[list] = []

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
            before = [_copy_counts(c) for c in self.clusters]
            for c in self.clusters:
                c.tick()
                if self.fetched is not None:
                    quiesce(c)
            self.copied.append([_copied_since(c, b) for c, b
                                in zip(self.clusters, before)])
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


def file_payloads(data: bytes) -> List[bytes]:
    """The payloads of a machine file's ``index:payload`` lines."""
    return [ln.split(b":", 1)[1] for ln in data.splitlines()]


def _files_agree(files: Dict[tuple, bytes], G: int, what: str) -> None:
    """Every group's machine file byte-equal on every node of one
    cluster."""
    nodes = sorted({i for i, _ in files})
    bad = [g for g in range(G)
           if len({files[(i, g)] for i in nodes}) != 1]
    assert not bad, f"{what}: machine files differ across nodes in " \
        f"group(s) {bad[:8]}"


def run_lifecycle_script(clusters: Sequence, lanes: bool = False,
                         closed: Sequence[Sequence[int]] = ((3,), (6,)),
                         purged: Sequence[Sequence[int]] = ((5,), (2,)),
                         n_submit: int = 2, max_rounds: int = 400,
                         max_loads: int = 120,
                         drain_rounds: int = 10) -> dict:
    """The snapshot plane and the group lifecycle in lockstep (see the
    module docstring).  ``closed[k]`` / ``purged[k]``: the lanes closed
    and reopened / purged and reused in lifecycle round k (round 0 before
    the install, round 1 after it).  Returns ``{"rounds", "victim",
    "acked", "files", "installs", "installed", "fetched", "loads",
    "writes", "copied"}``, each list holding one entry per cluster:
    ``files`` its machine files, ``installs`` the victim's [G] installs,
    ``installed`` its ``snapshots_installed`` metric, ``fetched`` the
    downloads its tick was handed; ``writes`` the rounds that follow a
    lifecycle write, ``copied`` the leaves copied on those rounds (None
    for the reference's nodes).  Raises AssertionError where the
    clusters differ, a phase does not finish, a group of the victim
    caught up without an install, a download was not installed, a purged
    lane kept its history or a closed one lost it, machine files differ
    across nodes or clusters, or a port node copied a leaf on a round
    that followed no lifecycle write (or none on one that did)."""
    ls = Lockstep(clusters, lanes=lanes)
    G = ls.lead.cfg.n_groups
    writes: List[int] = []

    def set_lanes(lanes_, active, purge=False):
        for c in ls.clusters:
            for n in c.nodes.values():
                for g in lanes_:
                    n.set_active(g, active, purge=purge)
        if ls.rounds + 1 not in writes:
            writes.append(ls.rounds + 1)

    def cycle(k):
        shut, wipe = list(closed[k]), list(purged[k])
        old = machine_bytes(ls.lead)
        set_lanes(shut, False)
        set_lanes(wipe, False, purge=True)
        ls.tick(4)
        set_lanes(shut + wipe, True)
        ls.tick_until(ls.all_led_ready, max_rounds,
                      f"lifecycle round {k}: reopened lanes led and ready")
        got = ls.submit_all(f"l{k}-", n_submit)
        ls.tick(drain_rounds)
        new = machine_bytes(ls.lead)
        for (i, g), data in new.items():
            had = set(file_payloads(old[(i, g)])) - {b""}
            now = set(file_payloads(data))
            if g in wipe:
                assert had and not had & now and data, \
                    f"purged lane {g} on node {i} kept its history " \
                    f"or served nothing after its reuse"
            elif g in shut:
                assert had <= now and data.startswith(old[(i, g)]), \
                    f"closed lane {g} on node {i} lost its history"
        return got

    ls.check()
    ls.tick_until(ls.all_led_ready, max_rounds, "every group led and ready")
    acked = ls.submit_all("a", n_submit)
    ls.tick(drain_rounds)
    acked += cycle(0)

    # The node leading the fewest groups dies; the survivors load and
    # compact until their WAL floor has passed its log tail everywhere.
    lead = ls.leaders()
    victim = int(np.argmin(np.bincount(lead, minlength=len(ls.lead.nodes))))
    vnode = ls.lead.nodes[victim]
    tail = np.maximum(_numpy(vnode.state.log.last).astype(np.int64),
                      [vnode.store.tail(g) for g in range(G)])
    ls.each(lambda c: c.kill_node(victim))
    ls.tick_until(ls.all_led_ready, max_rounds,
                  "every group re-led and ready among survivors")
    loads = 0
    while not all((n.h_base.astype(np.int64) > tail).all()
                  for n in ls.lead.nodes.values()):
        acked += ls.submit_all(f"d{loads}-", n_submit)
        loads += 1
        behind = [i for i, n in ls.lead.nodes.items()
                  if (n.h_base <= tail).any()]
        assert loads <= max_loads, \
            f"the compaction floor never passed the victim's tail on " \
            f"node(s) {behind}"
    installs = [record_installs(c) for c in ls.clusters]
    ls.each(lambda c: c.restart_node(victim))

    def caught_up() -> bool:
        nodes = ls.lead.nodes
        top = np.max([n.h_commit for i, n in nodes.items() if i != victim],
                     axis=0)
        return bool((nodes[victim].h_commit >= top).all())
    ls.tick_until(caught_up, max_rounds, "the restarted node caught up")
    per_group = [rec[victim]["groups"].copy() for rec in installs]
    fetched = [rec[victim]["fetched"] for rec in installs]
    installed = [int(c.nodes[victim].metrics["snapshots_installed"])
                 for c in ls.clusters]
    for k, (grp, rec) in enumerate(zip(per_group, installs)):
        rec = rec[victim]
        lag = np.nonzero(grp == 0)[0]
        assert lag.size == 0, \
            f"cluster {k}: node {victim} caught up without an install in " \
            f"{lag.size} group(s), first {lag[:8].tolist()}"
        assert rec["failed"] == 0 and \
            rec["fetched"] == int(grp.sum()) + rec["stale"], \
            f"cluster {k}: {rec['fetched']} downloads handed to the " \
            f"tick, {int(grp.sum())} installed, {rec['stale']} stale, " \
            f"{rec['failed']} failed"
        assert np.array_equal(grp, per_group[0]), \
            f"cluster {k}: installs per group differ from cluster 0's"
    ls.tick_until(ls.all_led_ready, max_rounds, "every group led and ready")
    acked += ls.submit_all("z", n_submit)
    acked += cycle(1)

    files = [machine_bytes(c) for c in ls.clusters]
    for k, f in enumerate(files):
        _files_agree(f, G, f"cluster {k}")
        diff = [key for key in f if f[key] != files[0].get(key)]
        assert not diff, \
            f"machine files differ in cluster {k}: (node, group) {diff[:4]}"
    copied = []
    for k in range(len(ls.clusters)):
        per_round = [row[k] for row in ls.copied]
        if any(v is None for v in per_round):
            copied.append(None)
            continue
        wrong = [r + 1 for r, v in enumerate(per_round)
                 if (v > 0) != (r + 1 in writes)]
        assert not wrong, \
            f"cluster {k}: leaves copied into the static state on rounds " \
            f"{[(r, per_round[r - 1]) for r in wrong[:6]]}; lifecycle " \
            f"writes before rounds {writes}"
        copied.append([per_round[r - 1] for r in writes])
    return {"rounds": ls.rounds, "victim": victim, "acked": acked,
            "files": files, "installs": per_group, "installed": installed,
            "fetched": fetched, "loads": loads, "writes": writes,
            "copied": copied}
