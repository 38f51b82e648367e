"""Step <-> scalar-oracle lockstep under a seeded chaos schedule.

The port's counterpart of the loop in ``tests/test_oracle_parity.py``
(``run_parity``): every tick, each node's (state, inbox, host inbox) goes
to the port's vectorised ``node_step`` on ``device`` and to the scalar
oracle (:func:`.oracle.oracle_step`, host loops); the new state, every
outbound message (masked by its validity lane) and the step info must be
equal, exactly.  The step's outputs carry the run forward, so each tick is
an independent check and a divergence cannot compound silently.

The schedule draws from one numpy generator in the reference's order:
random link drops, occasional partitions, crash-restarts
(``types.crash_restart`` before the tick), clock stalls (a stalled node
does not step and loses its traffic), client submissions, read offers, a
rare host read veto, compaction requests, snapshot completions fed back
from the previous tick, and, with ``conf_p``/``xfer_p``, membership and
leadership-transfer offers through the host inbox.

Each node steps on its own (a node axis of one), so on a CUDA device
every call launches the quorum kernel once.  With ``cfg.debug_checks``
every step's violation codes must be zero as well.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.step import node_step, raise_debug_violations
from ..core.types import (
    EngineConfig, HostInbox, Messages, crash_restart, init_state, tree_map,
)
from .oracle import _np, oracle_step

# (validity lane, dependent fields) per RPC kind: fields are only
# meaningful where the lane is set; the step leaves arbitrary broadcast
# values elsewhere.
MSG_GROUPS = {
    "ae_valid": ["ae_term", "ae_prev_idx", "ae_prev_term", "ae_commit",
                 "ae_n", "ae_ents", "ae_cents", "ae_tick"],
    "aer_valid": ["aer_term", "aer_success", "aer_match", "aer_tick"],
    "rv_valid": ["rv_term", "rv_last_idx", "rv_last_term", "rv_prevote"],
    "rvr_valid": ["rvr_term", "rvr_granted", "rvr_prevote", "rvr_echo"],
    "is_valid": ["is_term", "is_idx", "is_last_term", "is_conf"],
    "isr_valid": ["isr_term", "isr_success"],
    "tn_valid": ["tn_term"],
}


def _eq(a: np.ndarray, b: np.ndarray, what: str) -> None:
    if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
        bad = (np.argwhere(a != b)[:5].tolist()
               if a.shape == b.shape else "shape")
        raise AssertionError(f"{what} mismatch: {a.dtype}{a.shape} vs "
                             f"{b.dtype}{b.shape} at {bad}")


def assert_messages_equal(step_out: Messages, oracle_out: dict,
                          tag: str) -> None:
    k = _np(step_out)
    for vfield, deps in MSG_GROUPS.items():
        mask = k[vfield]
        _eq(mask, oracle_out[vfield], f"{tag}: {vfield}")
        for f in deps:
            a, b = k[f], oracle_out[f]
            m = mask[..., None] if a.ndim == 3 else mask
            _eq(np.where(m, a, 0), np.where(m, b, 0),
                f"{tag}: {f} (masked by {vfield})")


def assert_fields_equal(step_tree, oracle_dict: dict, tag: str,
                        all_fields: bool = True) -> None:
    """Every field of the oracle's state or info dict against the step's
    (same dtypes, shapes and values).  ``all_fields``: the step has no
    field the oracle lacks (the state; the step info also carries the
    step's own ``debug_viol`` codes, which the oracle does not model)."""
    k = _np(step_tree)
    missing = sorted(set(oracle_dict) - set(k))
    extra = sorted(set(k) - set(oracle_dict)) if all_fields else []
    assert not missing and not extra, f"{tag}: fields differ: {missing} " \
        f"{extra}"
    for f, ov in oracle_dict.items():
        _eq(k[f], ov, f"{tag}: {f}")


def route(outboxes: List[Messages], conn: torch.Tensor) -> List[Messages]:
    """inbox[dst].field[src] = outbox[src].field[dst], valid lanes masked
    by ``conn[src, dst]`` (the reference's ``route_numpy``, on the
    outboxes' device)."""
    inboxes = []
    names = [f.name for f in dataclasses.fields(Messages)]
    raw = {f: torch.stack([getattr(ob, f) for ob in outboxes])
           for f in names}                       # [N(src), P(dst), G, ...]
    for d in range(len(outboxes)):
        kw = {}
        for f in names:
            arr = raw[f][:, d].clone()
            if f.endswith("_valid"):
                arr &= conn[:, d].unsqueeze(-1)
            kw[f] = arr
        inboxes.append(Messages(**kw))
    return inboxes


def _one(cfg, state, inbox, host):
    """``node_step`` for one node (a node axis of one)."""
    lift = lambda t: tree_map(lambda a: a.unsqueeze(0), t)
    outs = node_step(cfg, lift(state), lift(inbox), lift(host))
    return tuple(tree_map(lambda a: a[0], t) for t in outs)


def run_parity(seed: int, n_ticks: int, cfg: EngineConfig, device,
               drop_p: float = 0.15, part_p: float = 0.1,
               crash_p: float = 0.0, stall_p: float = 0.0,
               conf_p: float = 0.0, xfer_p: float = 0.0,
               n_voters: Optional[int] = None):
    """Run the lockstep; raise AssertionError at the first lane that
    differs.  Returns (final states, stats): ``stats`` counts partitions,
    crashes, stalls, ``steps`` (``node_step`` calls), ``elections`` (wins
    seen in the step info's §8 no-op lanes), ``commits`` (the sum of
    every node's commit advances) and ``oracle_s``/``step_s`` (wall
    seconds in each)."""
    dev = torch.device(device)
    N, G = cfg.n_peers, cfg.n_groups
    rng = np.random.default_rng(seed)
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    states = [init_state(cfg, i, seed=seed, n_voters=n_voters, device=dev)
              for i in range(N)]
    outboxes = [Messages.empty(cfg, dev) for _ in range(N)]
    infos = [None] * N
    partition_left = 0
    partition = None
    stats: Dict[str, float] = {"partitions": 0, "crashes": 0, "stalls": 0,
                               "steps": 0, "elections": 0, "commits": 0,
                               "oracle_s": 0.0, "step_s": 0.0}

    for t in range(n_ticks):
        # --- chaos schedule: random drops plus occasional partitions -----
        if partition_left == 0 and rng.random() < part_p:
            stats["partitions"] += 1
            k = rng.integers(1, N)
            side = rng.permutation(N)[:k]
            partition = np.zeros((N, N), bool)
            for a in range(N):
                for b in range(N):
                    partition[a, b] = (a in side) == (b in side)
            partition_left = int(rng.integers(3, 12))
        if partition_left > 0:
            conn = partition.copy()
            partition_left -= 1
        else:
            conn = np.ones((N, N), bool)
        conn &= rng.random((N, N)) > drop_p
        np.fill_diagonal(conn, True)

        # Crash-restarts and clock stalls: a crashed node resets volatile
        # state to the durable frontier BEFORE the tick (both sides then
        # step the restarted state); a stalled node does not step at all
        # and loses inbound + sends nothing.
        crashed = rng.random(N) < crash_p
        stalled = rng.random(N) < stall_p
        stats["crashes"] += int(crashed.sum())
        stats["stalls"] += int(stalled.sum())
        for n in range(N):
            if crashed[n]:
                states[n] = crash_restart(cfg, states[n])
            if crashed[n] or stalled[n]:
                conn[:, n] = False
                conn[n, n] = True

        inboxes = route(outboxes, torch.from_numpy(conn).to(dev))
        new_outboxes = []
        for n in range(N):
            if stalled[n]:
                new_outboxes.append(Messages.empty(cfg, dev))
                continue
            sub = rng.integers(0, cfg.max_submit + 1, size=G).astype(np.int32)
            reads = rng.integers(0, 4, size=G).astype(np.int32)
            veto = bool(rng.random() < 0.05)
            full = (1 << N) - 1
            cv = np.where(rng.random(G) < conf_p,
                          rng.integers(1, full + 1, size=G),
                          0).astype(np.int32)
            cl = (np.where(rng.random(G) < 0.5,
                           rng.integers(0, full + 1, size=G), 0)
                  .astype(np.int32) & ~cv).astype(np.int32) \
                if conf_p else np.zeros(G, np.int32)
            xt = np.where(rng.random(G) < xfer_p,
                          rng.integers(0, N, size=G),
                          -1).astype(np.int32)
            host = HostInbox.empty(cfg, dev)
            if conf_p or xfer_p:
                host = host.replace(conf_voters=t32(cv), conf_learners=t32(cl),
                                    xfer_target=t32(xt))
            vt = torch.tensor(veto, device=dev)
            if infos[n] is not None:
                prev = infos[n]
                commit = states[n].commit.cpu().numpy()
                compact = np.where(
                    rng.random(G) < 0.3,
                    np.maximum(commit - cfg.log_slots // 4, 0),
                    0).astype(np.int32)
                host = host.replace(
                    submit_n=t32(sub), read_n=t32(reads), read_veto=vt,
                    snap_done=prev.snap_req.clone(),
                    snap_idx=prev.snap_req_idx.clone(),
                    snap_term=prev.snap_req_term.clone(),
                    snap_conf=prev.snap_req_conf.clone(),
                    compact_to=t32(compact))
            else:
                host = host.replace(submit_n=t32(sub), read_n=t32(reads),
                                    read_veto=vt)

            c_in = states[n].commit.cpu().numpy().astype(np.int64)
            t0 = time.perf_counter()
            o_state, o_out, o_info = oracle_step(cfg, states[n], inboxes[n],
                                                 host)
            t1 = time.perf_counter()
            k_state, k_out, k_info = _one(cfg, states[n], inboxes[n], host)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            stats["oracle_s"] += t1 - t0
            stats["step_s"] += t2 - t1
            stats["steps"] += 1
            tag = f"seed={seed} tick={t} node={n}"
            assert_fields_equal(k_state, o_state, f"{tag} state")
            assert_messages_equal(k_out, o_out, f"{tag} outbox")
            assert_fields_equal(k_info, o_info, f"{tag} info",
                                all_fields=False)
            if cfg.debug_checks:
                raise_debug_violations(k_info, tag)
            stats["elections"] += int((o_info["noop_idx"] > 0).sum())
            stats["commits"] += int(np.maximum(
                o_state["commit"] - c_in, 0).sum())
            states[n] = k_state
            new_outboxes.append(k_out)
            infos[n] = k_info
        outboxes = new_outboxes

    total_commit = sum(int(s.commit.sum()) for s in states)
    assert total_commit > 0, "chaos schedule never committed anything"
    return states, stats
