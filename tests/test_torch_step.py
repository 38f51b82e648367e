"""The port's batched ``node_step`` against the JAX engine, exactly.

States evolved by the JAX ``DeviceCluster`` (carried across with
``rafting_tpu_torch.bridge``) go through the port's ``node_step`` every
tick, fed the same routed inbox and host inbox as the JAX tick; every
field of the new state, the outbox and the step info must be equal, with
equal dtypes.  Two walks cover lease on and off, learner slots
(``n_voters < P``), a joint membership walk, a leadership transfer and a
partition long enough to force a snapshot install.  The translation
points a literal port gets wrong (argmax over bool, drop-mode scatter,
int32 lanes) also have direct unit tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import step as jst
from rafting_tpu.core import types as jty
from rafting_tpu.core.sim import committed_entries as jax_committed
from rafting_tpu_torch.bridge import state_from_numpy, state_to_numpy
from rafting_tpu_torch.core import step as tst
from rafting_tpu_torch.core import types as tty
from rafting_tpu_torch.core.sim import committed_entries


def assert_same(jx, tn, path=""):
    """JAX pytree (attributes) vs the port's state_to_numpy dict."""
    if tn is None:
        assert jx is None, path
        return
    if isinstance(tn, dict):
        for k, v in tn.items():
            assert_same(getattr(jx, k), v, f"{path}.{k}")
        return
    a = np.asarray(jx)
    assert a.dtype == tn.dtype, (path, a.dtype, tn.dtype)
    assert a.shape == tn.shape, (path, a.shape, tn.shape)
    if not np.array_equal(a, tn):
        bad = np.argwhere(a != tn)[:5].tolist()
        raise AssertionError(f"{path} differs at {bad}")


def _np(tree):
    return jax.tree.map(np.array, tree)


def _walk(kw, seed, n_voters, compact, schedule, n_ticks):
    """Drive a JAX DeviceCluster; before each tick hand the same inputs to
    the port's node_step and compare its outputs with the JAX tick's.
    ``schedule[t]`` is an optional callable(cluster) -> host-lane dict
    (membership/transfer requests) or a partition action.  Returns the
    JAX StepInfos seen, for coverage asserts."""
    jcfg = jty.EngineConfig(**kw)
    tcfg = tty.EngineConfig(**kw)
    jc = jcl.DeviceCluster(jcfg, seed=seed, n_voters=n_voters)
    jc.compact = compact
    N, G = jcfg.n_peers, jcfg.n_groups
    infos = []
    for t in range(n_ticks):
        lanes = schedule.get(t, lambda c: {})(jc) or {}
        sub = jnp.full((N, G), 3 if t < n_ticks - 20 else 0, jnp.int32)
        rd = jnp.full((N, G), 2, jnp.int32)
        host = jcl.auto_host_inbox(jcfg, jc.states, sub, jc.compact,
                                   jc.last_info, rd)
        host = host.replace(**{k: jnp.broadcast_to(jnp.asarray(v),
                                                   (N, G))
                               for k, v in lanes.items()})
        states0 = _np(jc.states)
        inbox0 = _np(jcl.route(jc.inflight, jc.conn))
        host0 = _np(host)
        info = jc.tick(host=host)
        got = tst.node_step(tcfg, state_from_numpy(states0, "cpu"),
                            state_from_numpy(inbox0, "cpu"),
                            state_from_numpy(host0, "cpu"))
        for name, jx, tn in zip(("state", "outbox", "info"),
                                (jc.states, jc.inflight, info), got):
            assert_same(jx, state_to_numpy(tn), f"tick {t} {name}")
        infos.append(_np(info))
    return infos


def _partition(node):
    def act(c):
        c.isolate(node)
    return act


def _heal(c):
    c.heal()


def test_node_step_lease_on_with_snapshot_install():
    kw = dict(n_groups=32, n_peers=3, log_slots=16, batch=4, max_submit=4)
    infos = _walk(kw, seed=3, n_voters=None, compact=5,
                  schedule={20: _partition(2), 90: _heal}, n_ticks=150)
    assert any(i.snap_req.any() for i in infos), \
        "the partition never forced a snapshot install"
    assert any(i.read_lease.any() for i in infos)
    assert infos[-1].commit.min() > 0


def test_node_step_learners_membership_transfer_lease_off():
    kw = dict(n_groups=24, n_peers=5, log_slots=16, batch=4, max_submit=4,
              read_lease=False)
    G = kw["n_groups"]
    sched = {
        # joint walk: voters {0,1,2} -> {1,2,3,4}, slot 0 becomes a learner
        40: lambda c: {"conf_voters": np.full(G, 0b11110, np.int32),
                       "conf_learners": np.full(G, 0b00001, np.int32)},
        100: lambda c: {"xfer_target": np.full(G, 2, np.int32)},
        120: lambda c: {"conf_voters": np.full(G, 0b00111, np.int32)},
    }
    infos = _walk(kw, seed=5, n_voters=3, compact=True, schedule=sched,
                  n_ticks=170)
    words = np.concatenate([i.conf_word.ravel() for i in infos])
    assert (jty.conf_new_of(words) != 0).any(), "never joint"
    assert any(i.conf_app_idx.any() for i in infos)
    assert any(i.xfer_fired.any() for i in infos), "transfer never fired"
    assert any(i.read_served.any() for i in infos)


# ------------------------------------------------------- translation points --

def test_pick_peer_matches_argmax_on_ties_and_empty_columns():
    rng = np.random.default_rng(0)
    flags = rng.random((3, 5, 400)) < 0.3
    flags[:, :, :40] = False                      # no peer set at all
    flags[:, :, 40:80] = True                     # every peer set (ties)
    want_p = np.asarray(jax.vmap(lambda f: jst._pick_peer(f)[0])(
        jnp.asarray(flags)))
    got_p, got_any = tst._pick_peer(torch.from_numpy(flags))
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(want_p, got_p.numpy())
    np.testing.assert_array_equal(flags.any(axis=1), got_any.numpy())


def test_ring_write_batch_drops_masked_writes():
    rng = np.random.default_rng(1)
    G, L, K = 64, 16, 6
    ring = rng.integers(0, 9, (G, L)).astype(np.int32)
    idx = (rng.integers(-3, 40, G)[:, None] + np.arange(K)).astype(np.int32)
    vals = rng.integers(10, 99, (G, K)).astype(np.int32)
    mask = rng.random((G, K)) < 0.5
    mask[:8] = False                             # whole rows dropped
    want = np.asarray(jst.ring_write_batch(
        jnp.asarray(ring), jnp.asarray(idx), jnp.asarray(vals),
        jnp.asarray(mask)))
    got = tst.ring_write_batch(torch.from_numpy(ring),
                               torch.from_numpy(idx),
                               torch.from_numpy(vals),
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(got.numpy()[:8], ring[:8])


def test_int32_lanes_stay_int32():
    """Sums over bool promote to int64 in torch; the lanes the reference
    keeps int32 are cast back, and the tallies compare the same."""
    rng = np.random.default_rng(2)
    P = 5
    flags = rng.random((200, P)) < 0.5
    voters = rng.integers(0, 32, 200).astype(np.int32)
    vnew = np.where(rng.random(200) < 0.5, rng.integers(1, 32, 200),
                    0).astype(np.int32)
    want = np.asarray(jst.dual_quorum(jnp.asarray(flags),
                                      jnp.asarray(voters),
                                      jnp.asarray(vnew)))
    got = tst.dual_quorum(torch.from_numpy(flags), torch.from_numpy(voters),
                          torch.from_numpy(vnew))
    np.testing.assert_array_equal(want, got.numpy())
    # floor division and remainder on negatives agree with jnp
    x = np.arange(-20, 20, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x) // 2),
                                  (torch.from_numpy(x) // 2).numpy())
    np.testing.assert_array_equal(np.asarray(jnp.remainder(x, 16)),
                                  torch.remainder(torch.from_numpy(x),
                                                  16).numpy())
    c = tty.init_state(tty.EngineConfig(n_groups=8, n_peers=3), 0,
                       device="cpu")
    for f in ("term", "commit", "elect_deadline", "conf_word"):
        assert getattr(c, f).dtype == torch.int32


def test_committed_entries_does_not_wrap():
    """JAX's total is int32 with x64 off and wraps; the port's is int64."""
    commit = np.full((3, 3), 1 << 30, np.int32)
    exact = 3 * (1 << 30)

    class S:
        pass
    s = S()
    s.commit = torch.from_numpy(commit)
    assert committed_entries(s).dtype == torch.int64
    assert int(committed_entries(s)) == exact
    js = S()
    js.commit = jnp.asarray(commit)
    assert int(jax_committed(js)) == int(np.int64(exact).astype(np.int32))


def test_ring_reads_match_jax():
    rng = np.random.default_rng(4)
    G, L = 32, 16
    base = rng.integers(0, 10, G).astype(np.int32)
    last = (base + rng.integers(0, L, G)).astype(np.int32)
    log_np = dict(term=rng.integers(1, 5, (G, L)).astype(np.int32),
                  conf=np.where(rng.random((G, L)) < 0.2,
                                rng.integers(1 << 30, (1 << 30) + 99,
                                             (G, L)), 0).astype(np.int32),
                  base=base, base_term=rng.integers(0, 3, G).astype(np.int32),
                  base_conf=np.full(G, (1 << 30) | 7, np.int32), last=last)
    jlog = jty.LogState(**{k: jnp.asarray(v) for k, v in log_np.items()})
    tlog = state_from_numpy(log_np, "cpu", tty.LogState)
    idx = (base[:, None] - 3 + np.arange(L + 6)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jst.ring_terms_batch(jlog, jnp.asarray(idx))),
        tst.ring_terms_batch(tlog, torch.from_numpy(idx)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jst.ring_conf_batch(jlog, jnp.asarray(idx))),
        tst.ring_conf_batch(tlog, torch.from_numpy(idx)).numpy())
    for upto in (last, last - 3, base):
        for w, g in zip(jst.latest_conf(jlog, jnp.asarray(upto)),
                        tst.latest_conf(tlog, torch.from_numpy(upto))):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
