"""The port's scalar oracle, against the JAX package's and against the
port's own vectorised step (CPU, exact: int32 and bool lanes, no
tolerance).

* Oracle against oracle: the reference's chaos loop
  (``tests/test_oracle_parity.py``'s ``run_parity``) runs the JAX engine;
  at every tick each node's (state, inbox, host inbox) is also carried
  across with ``rafting_tpu_torch.bridge`` and stepped by the port's
  ``oracle_step``, whose state, outbox and info dicts must equal the JAX
  oracle's field for field, dtype included.
* Step against oracle: ``rafting_tpu_torch.testkit.parity.run_parity``
  holds the port's ``node_step`` equal to the port's oracle, tick by tick,
  over the scenarios of ``tests/test_oracle_parity.py`` (PreVote on three
  seeds, PreVote off, strict ReadIndex, a one-slot read FIFO, five nodes,
  heat lanes under chaos), those of ``tests/test_checkquorum.py`` and a
  five-node run with the flight recorder, heat lanes and CheckQuorum on
  under membership and transfer offers, with the debug checks on.
"""

import jax
import numpy as np
import pytest

import test_oracle_parity as ref
from rafting_tpu.core.types import EngineConfig as JaxEngineConfig
from rafting_tpu_torch.bridge import state_from_numpy
from rafting_tpu_torch.core.types import EngineConfig
from rafting_tpu_torch.testkit.oracle import oracle_step
from rafting_tpu_torch.testkit.parity import run_parity

SMALL = dict(n_groups=8, n_peers=3, log_slots=16, batch=4, max_submit=4,
             election_ticks=6, heartbeat_ticks=2, rpc_timeout_ticks=5,
             pre_vote=True)
FIVE = dict(SMALL, n_groups=4, n_peers=5, batch=2, max_submit=2,
            election_ticks=8, rpc_timeout_ticks=6)
ALL_LANES = dict(trace_depth=16, heat=True, check_quorum=True,
                 debug_checks=True)
CHAOS = dict(crash_p=0.04, stall_p=0.06)

# name -> (engine kwargs, seed, ticks, run_parity kwargs)
SCENARIOS = {
    "prevote-0": (SMALL, 0, 60, {}),
    "prevote-1": (SMALL, 1, 60, {}),
    "prevote-2": (SMALL, 2, 60, {}),
    "no-prevote": (dict(SMALL, pre_vote=False), 7, 60, {}),
    "strict-read-index": (dict(SMALL, read_lease=False), 13, 60, CHAOS),
    "read-fifo-1": (dict(SMALL, read_slots=1), 17, 60, CHAOS),
    "five-nodes": (FIVE, 11, 50, dict(drop_p=0.25, part_p=0.15)),
    "heat-chaos": (dict(SMALL, heat=True), 19, 60, CHAOS),
    "check-quorum": (dict(SMALL, check_quorum=True), 23, 60, CHAOS),
    "check-quorum-strict": (dict(SMALL, check_quorum=True,
                                 read_lease=False), 29, 60, CHAOS),
    "check-quorum-membership": (
        dict(SMALL, check_quorum=True), 37, 60,
        dict(crash_p=0.03, stall_p=0.04, conf_p=0.05, xfer_p=0.05)),
    "five-nodes-all-lanes": (dict(FIVE, **ALL_LANES), 41, 50,
                             dict(CHAOS, conf_p=0.05, xfer_p=0.05)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_matches_oracle(name):
    kw, seed, ticks, chaos = SCENARIOS[name]
    states, stats = run_parity(seed, ticks, EngineConfig(**kw), "cpu",
                               **chaos)
    assert stats["elections"] > 0 and stats["commits"] > 0, stats
    if chaos.get("crash_p"):
        assert stats["crashes"] > 0 and stats["stalls"] > 0, stats
    final = states[-1]
    if kw.get("heat"):
        for lane in ("appended", "sent", "commits"):
            assert int(getattr(final.heat, lane).sum()) > 0, lane
    if kw.get("trace_depth"):
        assert int(final.trace.n.sum()) > 0


def _same(want: dict, got: dict, what: str) -> None:
    assert sorted(want) == sorted(got), (what, set(want) ^ set(got))
    for k, a in want.items():
        b = got[k]
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), f"{what}.{k} differs"


@pytest.mark.parametrize("name", ["prevote-0", "five-nodes-all-lanes",
                                  "check-quorum-membership"])
def test_port_oracle_matches_jax_oracle(name, monkeypatch):
    kw, seed, ticks, chaos = SCENARIOS[name]
    tcfg = EngineConfig(**kw)
    calls = {"n": 0}
    jax_oracle = ref.oracle_step

    def both(cfg, state, inbox, host):
        want = jax_oracle(cfg, state, inbox, host)
        got = oracle_step(
            tcfg, *(state_from_numpy(jax.tree.map(np.asarray, t), "cpu")
                    for t in (state, inbox, host)))
        for w, g, what in zip(want, got, ("state", "outbox", "info")):
            _same(w, g, f"call {calls['n']} {what}")
        calls["n"] += 1
        return want

    monkeypatch.setattr(ref, "oracle_step", both)
    ref.run_parity(seed, n_ticks=ticks, cfg=JaxEngineConfig(**kw), **chaos)
    assert calls["n"] >= ticks * kw["n_peers"] // 2
