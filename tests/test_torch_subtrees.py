"""The port's optional device subtrees against the JAX engine, exactly.

The flight recorder (``trace_depth``), heat lanes (``heat``), CheckQuorum
(``check_quorum``) and the invariant checks (``debug_checks``), each alone
and all four together, tick for tick beside the JAX ``DeviceCluster``
under an isolate/heal walk: every lane of the state (subtrees included),
the step info (``cq_*`` and ``debug_viol`` included) and the in-flight
messages must be equal.  Also ``contact_quorum`` and ``trace_append`` on
random inputs, ``crash_restart`` with the subtrees, and the seeded
invariant violations of ``tests/test_debug_checks.py`` raised through the
port.  Every lane is an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import step as jst
from rafting_tpu.core import types as jty
from rafting_tpu.ops import quorum as jq
from rafting_tpu_torch import DeviceCluster, EngineConfig
from rafting_tpu_torch.bridge import state_from_numpy, state_to_numpy
from rafting_tpu_torch.core import step as tst
from rafting_tpu_torch.core import types as tty
from rafting_tpu_torch.ops import quorum as tq

KW = dict(n_groups=32, log_slots=16, batch=4, max_submit=4)
ALL = dict(trace_depth=16, heat=True, check_quorum=True, debug_checks=True)


def assert_same(jx, tn, path=""):
    if tn is None:
        assert jx is None, path
        return
    if isinstance(tn, dict):
        for k, v in tn.items():
            sub = jx[k] if isinstance(jx, dict) else getattr(jx, k)
            assert_same(sub, v, f"{path}.{k}")
        return
    a = np.asarray(jx)
    assert a.dtype == tn.dtype and a.shape == tn.shape, \
        (path, a.dtype, tn.dtype, a.shape, tn.shape)
    if not np.array_equal(a, tn):
        raise AssertionError(f"{path} differs at "
                             f"{np.argwhere(a != tn)[:5].tolist()}")


@pytest.mark.parametrize("P,flags", [
    (3, dict(trace_depth=16)), (3, dict(heat=True)),
    (3, dict(check_quorum=True)), (3, dict(debug_checks=True)),
    (3, ALL), (5, ALL),
], ids=["trace", "heat", "check_quorum", "debug_checks", "all-P3",
        "all-P5"])
def test_flags_tick_for_tick(P, flags):
    kw = dict(KW, n_peers=P, **flags)
    jc = jcl.DeviceCluster(jty.EngineConfig(**kw), seed=3)
    tc = DeviceCluster(EngineConfig(**kw), seed=3, device="cpu")
    jc.compact = tc.compact = 4
    downs = 0
    for t in range(100):
        if t == 30:
            jc.isolate(0)
            tc.isolate(0)
        if t == 70:
            jc.heal()
            tc.heal()
        want = jc.tick(submit_n=2)
        got = tc.tick(submit_n=2)
        assert_same(want, state_to_numpy(got), f"tick {t} info")
        assert_same(jc.states, state_to_numpy(tc.states), f"tick {t} state")
        if got.cq_stepdown is not None:
            downs += int(got.cq_stepdown.sum())
    assert_same(jc.inflight, state_to_numpy(tc.inflight), "inflight")
    s = tc.states
    if "trace_depth" in flags:
        assert int(s.trace.n.min()) > 0
    if "heat" in flags:
        assert int(s.heat.sent.min()) > 0 and int(s.heat.commits.min()) > 0
    if "check_quorum" in flags:
        # The isolated node led some groups: CheckQuorum deposed them.
        assert downs > 0
    if "debug_checks" in flags:
        assert not tc.last_info.debug_viol.any()


def test_contact_quorum_matches_jax():
    rng = np.random.default_rng(21)
    for P in range(1, 11):
        N, G = 3, 257
        full = (1 << P) - 1
        heard = rng.integers(0, 30, (N, G, P)).astype(np.int32)
        since = rng.integers(0, 30, (N, G)).astype(np.int32)
        voters = rng.integers(0, full + 1, (N, G)).astype(np.int32)
        vnew = np.where(rng.random((N, G)) < 0.5,
                        rng.integers(1, full + 1, (N, G)), 0).astype(np.int32)
        me = rng.integers(0, P, N).astype(np.int32)
        got = tq.contact_quorum(*(torch.from_numpy(a) for a in
                                  (voters, vnew, me, heard, since)))
        assert got.dtype == torch.bool and got.shape == (N, G)
        for n in range(N):
            want = jq.contact_quorum(voters[n], vnew[n], jnp.int32(me[n]),
                                     heard[n], since[n])
            np.testing.assert_array_equal(np.asarray(want),
                                          got[n].numpy(), err_msg=f"P={P}")
        one = tq.contact_quorum(*(torch.as_tensor(a) for a in
                                  (voters[0], vnew[0], me[0], heard[0],
                                   since[0])))
        assert torch.equal(one, got[0])


@pytest.mark.parametrize("D", [12, 16, 33])
def test_trace_append_matches_jax(D):
    rng = np.random.default_rng(D)
    G = 40
    ring = {k: rng.integers(0, 99, (G, D)).astype(np.int32)
            for k in ("tick", "kind", "term", "aux")}
    ring["n"] = rng.integers(0, 200, G).astype(np.int32)
    jtr = jty.TraceState(**{k: jnp.asarray(v) for k, v in ring.items()})
    ttr = state_from_numpy(ring, "cpu", tty.TraceState)
    for step in range(4):
        mask = rng.random(G) < 0.6
        tick = np.int32(step + 5)
        term = rng.integers(0, 9, G).astype(np.int32)
        aux = rng.integers(0, 99, G).astype(np.int32)
        jtr = jty.trace_append(jtr, jnp.asarray(mask), 7, tick,
                               jnp.asarray(term), jnp.asarray(aux))
        ttr = tty.trace_append(ttr, torch.from_numpy(mask), 7,
                               torch.tensor(tick), torch.from_numpy(term),
                               torch.from_numpy(aux))
        assert_same(jtr, state_to_numpy(ttr), f"append {step}")
    # Batched over a node axis: each node's rows as the one-node append.
    stack = tty.tree_map(lambda a: torch.stack([a, a.flip(0)]), ttr)
    mask = torch.from_numpy(rng.random((2, G)) < 0.5)
    got = tty.trace_append(stack, mask, 3, torch.tensor([[8], [9]],
                                                        dtype=torch.int32),
                           stack.n, stack.n + 1)
    for n in range(2):
        one = tty.tree_map(lambda a: a[n], stack)
        want = tty.trace_append(one, mask[n], 3, torch.tensor(8 + n),
                                one.n, one.n + 1)
        assert_same(state_to_numpy(want),
                    state_to_numpy(tty.tree_map(lambda a: a[n], got)))


def test_crash_restart_with_subtrees_matches_jax():
    kw = dict(KW, n_peers=3, **ALL)
    jcfg, tcfg = jty.EngineConfig(**kw), tty.EngineConfig(**kw)
    jc = jcl.DeviceCluster(jcfg, seed=2)
    for _ in range(40):
        jc.tick(submit_n=2)
    states = jax.tree.map(np.array, jc.states)
    assert (states.qc.heard > 0).any()
    want = jax.vmap(lambda s: jty.crash_restart(jcfg, s))(
        jax.tree.map(jnp.asarray, states))
    got = tty.crash_restart(tcfg, state_from_numpy(states, "cpu"))
    assert_same(want, state_to_numpy(got))
    one = jax.tree.map(lambda a: a[1], states)
    assert_same(jty.crash_restart(jcfg, jax.tree.map(jnp.asarray, one)),
                state_to_numpy(tty.crash_restart(
                    tcfg, state_from_numpy(one, "cpu"))))


def _seeded_viol(mutate, n_groups):
    """One node's boot state, mutated, stepped once by both engines with
    debug_checks on; returns the (JAX, port) debug_viol codes."""
    kw = dict(n_groups=n_groups, n_peers=3, log_slots=16, batch=4,
              max_submit=4, election_ticks=50, heartbeat_ticks=3,
              debug_checks=True)
    jcfg, tcfg = jty.EngineConfig(**kw), tty.EngineConfig(**kw)
    st = jax.tree.map(np.array, jty.init_state(jcfg, node_id=0, seed=0))
    mutate(st)
    _, _, want = jst.node_step(jcfg, jax.tree.map(jnp.asarray, st),
                               jty.Messages.empty(jcfg),
                               jty.HostInbox.empty(jcfg))
    _, _, got = tst.node_step(
        tcfg, tty.stack_states([state_from_numpy(st, "cpu")]),
        tty.Messages.empty(tcfg, "cpu", lead=(1,)),
        tty.HostInbox.empty(tcfg, "cpu", lead=(1,)))
    return np.asarray(want.debug_viol), got


def test_seeded_violations_raise_the_same_codes():
    def commit_past_end(st):
        st.commit[1] = 9

    def ring_overflow(st):
        st.log.last[0] = 20

    def foreign_ballot(st):
        st.role[0] = tty.CANDIDATE
        st.term[0] = 3
        st.voted_for[0] = 2

    for mutate, G, lane, code in ((commit_past_end, 2, 1, 2),
                                  (ring_overflow, 1, 0, 1),
                                  (foreign_ballot, 1, 0, 5)):
        want, got = _seeded_viol(mutate, G)
        assert want[lane] == code
        np.testing.assert_array_equal(want, got.debug_viol[0].numpy())
        with pytest.raises(AssertionError, match=tst.DEBUG_CODES[code]):
            tst.raise_debug_violations(got)
        with pytest.raises(AssertionError, match=jst.DEBUG_CODES[code]):
            jst.raise_debug_violations(jty.StepInfo.empty(
                jty.EngineConfig(n_groups=G, n_peers=3)).replace(
                    debug_viol=jnp.asarray(want)))
    assert tst.DEBUG_CODES == jst.DEBUG_CODES


def test_cluster_split_brain_caught():
    cfg = EngineConfig(n_groups=16, n_peers=3, debug_checks=True)
    c = DeviceCluster(cfg, seed=0, device="cpu")
    s = c.states
    role, term = s.role.clone(), s.term.clone()
    role[0, 0] = role[1, 0] = tty.LEADER
    term[0, 0] = term[1, 0] = 7
    c.states = s.replace(role=role, term=term)
    with pytest.raises(AssertionError, match="election safety"):
        c._debug_check(c.last_info)
