"""Rebalancer: the admin control loop over the §6 membership plane.

Drives live Multi-Raft rebalancing against running RaftNodes: drain the
leaders off a node before maintenance, and walk groups through the safe
reconfiguration sequence —

    add learners -> wait for catch-up -> promote to voters (joint
    consensus walks C_old -> C_old,new -> C_new on the device, the leave
    entry auto-appending when the joint entry commits) -> demote/remove
    the old voters -> optionally transfer leadership into the new set.

The learner stage exists for AVAILABILITY, not safety: a joint quorum
includes the incoming set, so entering it with empty newcomers would
stall commits while they fetch snapshots (§6's cluster-expansion
caveat).  Safety is the kernel's: joint decisions need quorums in both
sets regardless of what this driver does.

The driver is deliberately dumb and restartable: every step is an
idempotent target-config request against whoever currently leads, so a
crashed admin re-runs the walk from scratch and converges.  ``step`` is
how the cluster advances between polls — ``LocalCluster.tick`` for
lockstep harnesses, ``time.sleep`` for free-running deployments.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional

from ..core.types import LEADER


class RebalanceError(RuntimeError):
    pass


class Rebalancer:
    def __init__(self, nodes: Dict[int, object],
                 step: Optional[Callable[[], None]] = None,
                 max_rounds: int = 4000, catch_up_slack: int = 2):
        """``nodes``: node_id -> RaftNode (or anything exposing h_role,
        membership(), change_membership(), transfer_leadership(),
        catch_up_gap()).  ``step()`` advances the cluster one round
        between polls (default: 5 ms wall sleep for free-running nodes).
        ``catch_up_slack``: a learner counts as caught up when its
        replication gap (last - match on the leader) is at most this
        many entries."""
        self.nodes = nodes
        self.step = step or (lambda: time.sleep(0.005))
        self.max_rounds = max_rounds
        self.catch_up_slack = catch_up_slack

    # -- plumbing ------------------------------------------------------------

    def leader_of(self, group: int) -> Optional[int]:
        best = None
        for nid, node in self.nodes.items():
            if node.h_role[group] == LEADER:
                t = int(node.h_term[group])
                if best is None or t > best[1]:
                    best = (nid, t)
        return None if best is None else best[0]

    def _wait(self, pred: Callable[[], bool], what: str) -> None:
        for _ in range(self.max_rounds):
            if pred():
                return
            self.step()
        raise RebalanceError(f"{what} not reached in {self.max_rounds} "
                             "rounds")

    def _wait_future(self, fut, what: str):
        self._wait(fut.done, what)
        return fut.result()

    def _request(self, group: int, voters: int, learners: int, what: str):
        """Issue a target-config request against the current leader,
        retrying through elections (each retry is a fresh idempotent
        request — a change that already landed resolves immediately)."""
        for _ in range(8):
            self._wait(lambda: self.leader_of(group) is not None,
                       f"leader for group {group}")
            node = self.nodes[self.leader_of(group)]
            fut = node.change_membership(group, voters, learners)
            self._wait(fut.done, what)
            if fut.exception() is None:
                return fut.result()
            self.step()   # leadership moved mid-change: re-resolve
        raise RebalanceError(f"{what}: change kept failing")

    # -- the walk ------------------------------------------------------------

    def walk_group(self, group: int, target_voters: int,
                   target_learners: int = 0) -> None:
        """Reconfigure one group to ``target_voters`` (+ permanent
        ``target_learners``) via the full safe sequence."""
        lead = self.leader_of(group)
        if lead is None:
            self._wait(lambda: self.leader_of(group) is not None,
                       f"leader for group {group}")
            lead = self.leader_of(group)
        cur = self.nodes[lead].membership(group)
        cur_voters = cur["voters"]
        newcomers = target_voters & ~cur_voters
        if newcomers:
            # Stage 1: newcomers ride as learners first — they replicate
            # (snapshot + log) without being counted anywhere.
            self._request(group, cur_voters,
                          (cur["learners"] | newcomers) & ~cur_voters,
                          f"group {group}: add learners")
            # Stage 2: catch-up gate before they join any quorum.
            def caught_up() -> bool:
                nid = self.leader_of(group)
                if nid is None:
                    return False
                node = self.nodes[nid]
                return all(node.catch_up_gap(group, p)
                           <= self.catch_up_slack
                           for p in range(64) if (newcomers >> p) & 1)
            self._wait(caught_up, f"group {group}: learner catch-up")
        # Stage 3: promote + demote in ONE joint walk (the kernel appends
        # C_old,new, commits it under both quorums, auto-appends C_new).
        self._request(group, target_voters, target_learners,
                      f"group {group}: joint switch")
        # Stage 4: a removed leader already resigned (kernel §6
        # epilogue); just wait for a leader inside the new set.
        self._wait(lambda: (lambda l: l is not None
                            and (target_voters >> l) & 1)
                   (self.leader_of(group)),
                   f"group {group}: leader inside the new voter set")

    def rebalance(self, groups: Iterable[int], target_voters: int,
                  target_learners: int = 0) -> int:
        """Walk many groups to one target config; returns the count."""
        n = 0
        for g in groups:
            self.walk_group(int(g), target_voters, target_learners)
            n += 1
        return n

    # -- leader draining -----------------------------------------------------

    def drain_leaders(self, node_id: int,
                      groups: Optional[Iterable[int]] = None) -> List[int]:
        """Transfer every group's leadership OFF ``node_id`` (maintenance
        drain): for each group it leads, pick the most caught-up other
        voter and TimeoutNow it.  Returns the drained group ids."""
        node = self.nodes[node_id]
        import numpy as np

        led = [int(g) for g in
               (groups if groups is not None
                else np.nonzero(node.h_role == LEADER)[0])
               if node.h_role[g] == LEADER]
        drained = []
        for g in led:
            m = node.membership(g)
            voters = m["voters"] | m["voters_new"]
            candidates = [p for p in range(64)
                          if (voters >> p) & 1 and p != node_id]
            if not candidates:
                continue
            target = min(candidates,
                         key=lambda p: node.catch_up_gap(g, p))
            fut = node.transfer_leadership(g, target)
            try:
                self._wait_future(fut, f"group {g}: leadership transfer")
            except Exception:
                continue   # aborted (deadline/step-down): leave it
            self._wait(lambda: self.leader_of(g) not in (node_id, None),
                       f"group {g}: new leader")
            drained.append(g)
        return drained

    def evacuate(self, node_id: int,
                 groups: Optional[Iterable[int]] = None) -> List[int]:
        """``drain_leaders`` for a DEGRADED node (the admin-driven twin
        of the node's own health evacuation, runtime/node.py
        _health_tick): transfer every group's leadership off ``node_id``
        like a drain, but consult each node's gray-failure scorecard
        (utils/health.py) and never hand a group to a peer that any
        scorecard currently marks degraded — evacuating INTO the next
        gray failure just moves the outage.  Falls back to the plain
        most-caught-up choice when every candidate looks degraded (a
        slow leader still beats no leader).  Returns the evacuated
        group ids."""
        node = self.nodes[node_id]
        import numpy as np

        degraded: set = set()
        for n in self.nodes.values():
            h = getattr(n, "health", None)
            if h is not None:
                degraded |= h.degraded_peers()
                if h.self_degraded():
                    degraded.add(h.node_id)
        led = [int(g) for g in
               (groups if groups is not None
                else np.nonzero(node.h_role == LEADER)[0])
               if node.h_role[g] == LEADER]
        moved = []
        for g in led:
            m = node.membership(g)
            voters = m["voters"] | m["voters_new"]
            candidates = [p for p in range(64)
                          if (voters >> p) & 1 and p != node_id]
            healthy = [p for p in candidates if p not in degraded]
            pool = healthy or candidates
            if not pool:
                continue
            target = min(pool, key=lambda p: node.catch_up_gap(g, p))
            fut = node.transfer_leadership(g, target)
            try:
                self._wait_future(fut, f"group {g}: leadership transfer")
            except Exception:
                continue
            self._wait(lambda: self.leader_of(g) not in (node_id, None),
                       f"group {g}: new leader")
            moved.append(g)
        return moved
