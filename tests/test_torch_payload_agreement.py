"""The payloads a durable node consumes and stages agree across replicas
when a deposed leader's uncommitted suffix is rewritten, in the reference
and in the port.

Both packages' ``testkit.harness.LocalCluster`` run pipelined on the CPU:
3 nodes, 32 groups, every group loaded every round, the wall-clock
planes off.  The node leading the
most groups stops ticking for longer than the election timeout while the
other two tick on.  The entries it accepted in its last tick never left
it (a pipelined node sends a tick's new entries in that tick's host phase,
which runs during its next tick), so the new leader writes other entries
at the same indices, and commits them.  When the node comes back, the new
leader's AppendEntries rewrite its suffix.

Three records are kept for every node and group:

(i)   the payloads a read bounded by ``h_commit`` right after ``tick()``
      returns (how ``chip_smoke.py``'s payload audit read the store until
      it was repaired);
(ii)  the payloads the node consumes: what its state machine applies and
      what leaves it in AppendEntries frames (decoded at the receiver);
(iii) the store's ``(entry_term, payload)`` once the host phase that
      staged the committing tick has run (``chip_smoke._PayloadAudit``).

What the run shows, in both packages (reading A): (i) returns the
deposed leader's old payload at an index that the tick just committed,
because that tick's host phase, which stages the rewrite, runs only in
the next tick; nothing the node consumes ever carries it, and (ii) and
(iii) agree across replicas at every committed index.  The old audit read
a state that the node never serves; the replicas did not diverge."""

import copy
import importlib
import importlib.util
import os
import shutil
import tempfile
from collections import defaultdict

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

G = 32
SEED = 0
BURST = 2
STALL_ROUNDS = 40       # > the randomised election timeout (10..20 ticks)
AFTER_ROUNDS = 30
# The two planes that decide from wall-clock time (admission control and
# the health plane's evacuations) are off, so the run is the same on any
# host (testkit/lockstep.py PINNED_ENV).
PINNED_ENV = {"RAFT_ADMISSION": "0", "RAFT_HEALTH": "0"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tape:
    """What the scenario recorded; see the module docstring."""

    def __init__(self):
        self.naive = {}             # (node, group, index) -> (term, payload)
        self.applied = defaultdict(dict)    # (node, group) -> {index: bytes}
        self.sent = defaultdict(set)        # (group, index, term) -> payloads
        self.stalled = None
        self.led_before = None      # groups the stalled node led
        self.led_after = None       # of those, the ones it leads at the end
        self.final_commit = {}      # node -> h_commit after the drain
        self.audit = None
        self.acked = self.everywhere = 0


def _recording_provider(fixtures, tape):
    class Machine(fixtures.NullMachine):
        def __init__(self, key):
            super().__init__()
            self.key = key

        def apply(self, index, payload):
            tape.applied[self.key][index] = bytes(payload)
            return super().apply(index, payload)

        def apply_batch(self, start_index, payloads):
            for k, p in enumerate(payloads):
                tape.applied[self.key][start_index + k] = bytes(p)
            return super().apply_batch(start_index, payloads)

    class Provider(fixtures.NullProvider):
        def __init__(self, node_id):
            self.node_id = node_id

        def bootstrap(self, group):
            return Machine((self.node_id, group))

    return Provider


def _record_frames(transport, tape):
    """Decode every AppendEntries entry a node receives, as the receiver's
    inbox gets it (the last column of a group in a frame wins, as in the
    receiver's scatter)."""
    inner = transport.on_slice

    def on_slice(src, fields, payloads):
        if "ae_valid" in fields:
            cols = fields["ae_valid"][0]
            prevs = fields["ae_prev_idx"][1]
            ns = fields["ae_n"][1]
            ents = fields["ae_ents"][1]
            last = {int(g): k for k, g in enumerate(cols.tolist())}
            for g, k in last.items():
                run = payloads.get(g)
                for e in range(int(ns[k])):
                    idx = int(prevs[k]) + 1 + e
                    p = run.entry(idx - run.start)
                    tape.sent[(g, idx, int(ents[k][e]))].add(p)
        return inner(src, fields, payloads)
    transport.on_slice = on_slice


def _scenario(pkg: str, root: str) -> _Tape:
    base = "rafting_tpu" if pkg == "jax" else "rafting_tpu_torch"
    top = importlib.import_module(base)
    harness = importlib.import_module(base + ".testkit.harness")
    fixtures = importlib.import_module(base + ".testkit.fixtures")
    LEADER = top.LEADER
    cfg = top.EngineConfig(n_groups=G, n_peers=3, log_slots=64,
                           batch=4, max_submit=4, election_ticks=10,
                           heartbeat_ticks=3, rpc_timeout_ticks=8,
                           pre_vote=True)
    tape = _Tape()
    audit = tape.audit = _chip_smoke()._PayloadAudit(G, G, seed=SEED)
    kw = {"device": "cpu"} if pkg == "port" else {}
    c = harness.LocalCluster(cfg, root,
                             provider_factory=_recording_provider(
                                 fixtures, tape),
                             seed=SEED, pipeline=True, **kw)
    upto = {}
    rnd = [0]

    def naive_read(i, n):
        for g in range(G):
            lo = max(upto.get((i, g), 0), n.store.floor(g)) + 1
            hi = min(int(n.h_commit[g]), n.store.tail(g))
            if hi < lo:
                continue
            for k, p in enumerate(n.store.payloads_window(
                    g, lo, hi - lo + 1)):
                if p is None:
                    break
                tape.naive[(i, g, lo + k)] = (
                    n.store.entry_term(g, lo + k), p)
                upto[(i, g)] = lo + k

    def tick_round(skip=None, load=True):
        r = rnd[0]
        rnd[0] += 1
        burst = [f"r{r:04d}-{j}-".encode().ljust(24, b"x")
                 for j in range(BURST)]
        live = {i: n for i, n in c.nodes.items() if i != skip}
        for n in live.values():
            if load:
                audit.offer(n, np.nonzero((n.h_role == LEADER)
                                          & n.h_ready)[0], burst)
        for i, n in live.items():
            n.tick()
            naive_read(i, n)
        audit.collect(live)

    def led(i):
        return np.nonzero(c.nodes[i].h_role == LEADER)[0]

    try:
        assert c.nodes[0].pipeline
        for n in c.nodes.values():
            _record_frames(n.transport, tape)
        for _ in range(300):
            roles = np.stack([n.h_role for n in c.nodes.values()])
            if ((roles == LEADER).sum(axis=0) == 1).all():
                break
            tick_round()
        for _ in range(10):
            tick_round()
        x = tape.stalled = max(c.nodes, key=lambda i: len(led(i)))
        tape.led_before = led(x)
        for _ in range(STALL_ROUNDS):
            tick_round(skip=x)
        for _ in range(AFTER_ROUNDS):
            tick_round()
        tape.led_after = np.intersect1d(led(x), tape.led_before)
        for _ in range(100):        # unloaded, until the commits agree
            tick_round(load=False)
            hc = np.stack([n.h_commit for n in c.nodes.values()])
            if (hc == hc[0:1]).all():
                break
        audit.drain(c.nodes)
        tape.final_commit = {i: np.asarray(n.h_commit).copy()
                             for i, n in c.nodes.items()}
        tape.acked, tape.everywhere = audit.check(sorted(c.nodes))
    finally:
        c.close()
    return tape


@pytest.fixture(scope="module", params=["jax", "port"])
def tape(request):
    root = tempfile.mkdtemp(prefix=f"agree-{request.param}-")
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in PINNED_ENV.items():
                mp.setenv(k, v)
            yield _scenario(request.param, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _stale(tape) -> list:
    """(node, group, index, read, staged): every entry the read bounded by
    ``h_commit`` returned that differs from what the node staged there."""
    out = []
    for (i, g, idx), e in tape.naive.items():
        staged = tape.audit.read.get((i, g), {}).get(idx)
        if staged is not None and staged != e:
            out.append((i, g, idx, e, staged))
    return out


def test_a_deposed_leaders_suffix_is_rewritten_under_load(tape):
    """The scenario happens: the stalled node lost its groups, and a
    suffix it had accepted was rewritten at an index that the read
    bounded by ``h_commit`` had already read (a committed index)."""
    assert len(tape.led_before) >= 4
    assert len(tape.led_after) < len(tape.led_before)
    rewritten = [s for s in _stale(tape) if s[3][0] != s[4][0]]
    assert rewritten, "no suffix was rewritten at a committed index"
    assert any(s[0] == tape.stalled for s in rewritten)


def test_reading_a_the_commit_bounded_read_returns_unstaged_payloads(tape):
    """Reading A: every entry on which (i) differs from (iii) is an old
    term's payload that the node never consumed; it applied and sent the
    staged entry at that index instead (the old entry may leave under
    its own term, in the deposed leader's last outbox, which the others
    reject)."""
    stale = _stale(tape)
    assert stale
    # The old audit's failure: two replicas' reads differ at an index.
    reads = defaultdict(set)
    for (i, g, idx), e in tape.naive.items():
        reads[(g, idx)].add(e[1])
    assert any(len(ps) > 1 for ps in reads.values())
    for i, g, idx, (old_term, old), (term, new) in stale:
        assert old_term < term and old != new
        assert tape.applied[(i, g)].get(idx) == new, (i, g, idx)
        assert tape.sent[(g, idx, term)] == {new}, (i, g, idx)


def test_staged_entries_agree_at_every_committed_index(tape):
    """(iii): ``_PayloadAudit`` (terms and payloads; its agreement and
    read-back assertions ran at the scenario's end) read every committed
    index of every node, and acknowledged writes were read back."""
    assert tape.acked > 0 and tape.everywhere > 0
    for i, commit in tape.final_commit.items():
        for g in range(G):
            if commit[g] > 0:
                assert tape.audit.upto[(i, g)] == commit[g], (i, g)
    for g in range(G):
        have = [tape.audit.read[(i, g)] for i in tape.final_commit]
        for idx in set().union(*have):
            assert len({h[idx] for h in have if idx in h}) == 1, (g, idx)


def test_applied_payloads_agree_with_the_staged_log(tape):
    """(ii) against (iii): every node applies at each index the payload
    that it, and every other node, staged there."""
    n_applied = 0
    for (i, g), got in tape.applied.items():
        for idx, p in got.items():
            n_applied += 1
            assert idx in tape.audit.read[(i, g)], (i, g, idx)
            for j in tape.final_commit:
                e = tape.audit.read.get((j, g), {}).get(idx)
                if e is not None:
                    assert e[1] == p, (i, j, g, idx)
    assert n_applied > G * 10


def test_sent_entries_agree_with_the_staged_log(tape):
    """(ii) on the wire: one payload for each (group, index, term) that
    left any node, and it is the payload every node staged at that index
    when the committed entry there has that term."""
    assert tape.sent
    for (g, idx, term), ps in tape.sent.items():
        assert len(ps) == 1, (g, idx, term)
        for i in tape.final_commit:
            e = tape.audit.read.get((i, g), {}).get(idx)
            if e is not None and e[0] == term:
                assert e[1] in ps, (i, g, idx, term)


def test_a_disagreement_names_each_nodes_entry_and_state(tape):
    """The audit's failure names, for each node that read the index, the
    entry it read and the node's state at that read."""
    audit = copy.copy(tape.audit)
    audit.read = {k: dict(v) for k, v in tape.audit.read.items()}
    nodes = sorted(tape.final_commit)
    g, idx = next((g, idx) for g in range(G)
                  for idx in sorted(audit.read[(nodes[1], g)])
                  if idx in audit.read[(nodes[0], g)])
    term = audit.read[(nodes[0], g)][idx][0]
    audit.read[(nodes[0], g)][idx] = (term, b"not-what-was-staged")
    with pytest.raises(AssertionError) as e:
        audit.check(nodes)
    msg = str(e.value)
    assert msg.startswith(f"group {g} index {idx}: replicas disagree")
    assert f"node {nodes[0]}: (term {term}, b'not-what-was-sta')" in msg
    for field in ("h_commit", "store.tail", "durable-tail mirror", "role",
                  "term", "ticks since its role in the group changed"):
        assert msg.count(field) >= 2, field
