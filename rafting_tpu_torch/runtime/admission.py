"""CoDel-style admission control for the node's offer queues (ISSUE 15,
the server half of the overload-control plane; beyond-reference — the
reference's only admission story is Netty's unbounded channel queue).

Why queue DELAY and not queue LENGTH: the existing bounds
(group_queue_cap / busy_threshold) are correctness backstops, sized for
the burst a healthy node absorbs — by the time they trip, the standing
queue already costs seconds of latency.  CoDel's insight is that a
GOOD queue empties regularly (burst absorption) while a BAD one holds a
standing backlog; the discriminator is the MINIMUM sojourn time over an
interval — a single slow pop is a burst, a whole window of slow pops is
overload.  We measure sojourn where it is truth: at the submission-queue
pop in ``_persist_prepare`` (the instant the device accepts the entry),
one max per tick, fed to :meth:`note_delay`.

Scaling: an absolute 5ms target is nonsense for a system whose tick
takes 2ms at 1k groups and 3s at 100k — a submission always waits >= 1
tick by construction.  The target is therefore expressed in TICKS
(``target_ticks`` x an EWMA of recent tick wall time, floored by
``target_s``), so the controller self-calibrates across four orders of
magnitude of scale without retuning.

Control law: each completed interval whose min-delay exceeded the
target bumps a consecutive-bad-window counter and the shed level rises
as ``1 - 1/sqrt(bad+1)`` (the CoDel drop-frequency curve, re-expressed
as a shed probability); a good window halves the level and unwinds the
counter.  The level is capped below 1 so the controller always admits a
trickle — it must keep observing sojourn to know when to recover.

Per-tenant fairness: while shedding, tenants consuming more than twice
their fair share of the CURRENT window's admissions are shed at an
elevated probability and in-share tenants at a reduced one, so one hot
tenant degrades itself before it degrades the rest.  Tenancy is a
label, not a promise — accounting is per node, best-effort, and only
consulted under overload.

``RAFT_ADMISSION=0`` force-disables the controller (every admit passes;
only the hard queue caps remain) — the collapse half of the no-collapse
A/B in testkit/openloop.py.

Thread contract: :meth:`note_delay` and :meth:`note_tick` run on the
tick thread.  :meth:`admit` runs on client threads under the node's
submit/read locks; its reads of the level and window state race the
tick thread benignly (a float read and dict bumps under the GIL — a
stale level mis-sheds at most a request or two per window boundary).
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import Dict, Optional

__all__ = ["AdmissionController", "admission_from_env"]

# Shed-probability cap: always admit a trickle, or the controller goes
# blind (no pops -> no sojourn samples -> no recovery signal).
MAX_LEVEL = 0.95


class AdmissionController:
    def __init__(self, enabled: bool = True,
                 target_s: float = 0.05,
                 target_ticks: float = 3.0,
                 interval_s: float = 0.1,
                 lifo: bool = True,
                 tenant_fair: bool = True,
                 expire_factor: float = 2.0,
                 seed: int = 0):
        """``target_s``: absolute floor of the queue-delay target;
        ``target_ticks``: the target in units of recent tick wall time
        (the larger of the two wins — see module docstring);
        ``interval_s``: minimum CoDel observation window;
        ``lifo``: serve newest-first while shedding (deadline-aware:
        under overload the oldest queued work is the most likely to be
        past its deadline already — burn the backlog, save the fresh);
        ``tenant_fair``: per-tenant fair shedding;
        ``expire_factor``: queue-age cap while shedding, in units of
        the delay target (0 disables late shedding)."""
        self.enabled = bool(enabled)
        self.target_s = float(target_s)
        self.target_ticks = float(target_ticks)
        self.interval_s = float(interval_s)
        self.lifo = bool(lifo)
        self.tenant_fair = bool(tenant_fair)
        self.expire_factor = float(expire_factor)
        self._rng = random.Random(seed ^ 0xAD31)
        # Control state (tick thread).
        self.level = 0.0           # shed probability in [0, MAX_LEVEL]
        self._bad_windows = 0
        self._win_min: Optional[float] = None   # min sojourn this window
        self._win_end: Optional[float] = None
        self._tick_ewma: Optional[float] = None
        # Cumulative decision counters (client threads; GIL-atomic int
        # bumps, folded into the Metrics registry by the tick thread).
        self.admitted = 0
        self.shed = 0
        self.shed_tenant = 0       # subset of shed: over-share tenants
        self.expired = 0           # late sheds: aged out of the queue
        self.txn_admitted = 0      # whole-transaction decisions
        self.txn_shed = 0          # (runtime/txn.py admit_txn)
        # Tenant admission accounting: current window accumulates, the
        # LAST completed window is what fairness decisions read (stable
        # within a window).
        self._tenant_cur: Dict[str, int] = {}
        self._tenant_win: Dict[str, int] = {}
        self._win_total = 0

    # ------------------------------------------------------- tick thread --

    def note_tick(self, tick_s: float) -> None:
        """EWMA of tick wall time — the unit the delay target scales by."""
        e = self._tick_ewma
        self._tick_ewma = tick_s if e is None else 0.9 * e + 0.1 * tick_s

    def target_now(self) -> float:
        e = self._tick_ewma or 0.0
        return max(self.target_s, self.target_ticks * e)

    def interval_now(self) -> float:
        # CoDel: the window must be at least the target (an interval
        # shorter than the target cannot observe a standing queue).
        return max(self.interval_s, self.target_now())

    def note_delay(self, delay_s: Optional[float],
                   now: Optional[float] = None) -> None:
        """One sojourn sample per tick from the submission-queue pop
        (None = nothing popped AND queues non-empty: no information;
        0.0 = queues empty: the queue drained, the strongest good
        signal).  Runs the window state machine."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        if delay_s is not None:
            m = self._win_min
            self._win_min = delay_s if m is None else min(m, delay_s)
        if self._win_end is None:
            self._win_end = now + self.interval_now()
            return
        # The window end may only SHRINK as the interval estimate
        # recovers: a window armed while the tick EWMA was transiently
        # huge (first-tick JIT compile can take seconds) would
        # otherwise freeze the controller far into the future.
        self._win_end = min(self._win_end, now + self.interval_now())
        if now < self._win_end:
            return
        # Window closed: judge it, then roll tenant accounting.
        bad = self._win_min is not None and self._win_min > self.target_now()
        if bad:
            self._bad_windows += 1
            # Two control terms, take the max: a PROPORTIONAL jump to
            # the overshoot fraction (sojourn 2x target -> shed ~1/2 —
            # the equilibrium shed for 2x offered load, reached in ONE
            # window, so the standing backlog stops growing before it
            # wrecks the admitted tail) and the CoDel sqrt ramp for
            # sustained badness the proportional term undershoots.
            ramp = 1.0 - 1.0 / math.sqrt(self._bad_windows + 1)
            prop = 1.0 - self.target_now() / self._win_min
            self.level = min(MAX_LEVEL, max(ramp, prop, self.level))
        else:
            self._bad_windows = max(0, self._bad_windows - 2)
            self.level = 0.0 if self.level < 0.05 else self.level * 0.5
        self._win_min = None
        self._win_end = now + self.interval_now()
        self._tenant_win = self._tenant_cur
        self._win_total = sum(self._tenant_win.values())
        self._tenant_cur = {}

    # ------------------------------------------------------ client threads --

    def admit(self, n: int = 1,
              tenant: Optional[str] = None) -> Optional[float]:
        """Admission decision for ``n`` entries: None = admitted, else
        the retry-after hint (seconds) to send with the OverloadError.
        Cheap when idle: one attribute read and one counter bump."""
        if not self.enabled or self.level <= 0.0:
            self.admitted += n
            return None
        p = self.level
        over_share = False
        if tenant is not None and self.tenant_fair:
            total, win = self._win_total, self._tenant_win
            if total >= 32 and len(win) > 1:
                share = win.get(tenant, 0) * len(win)
                if share > 2 * total:
                    # Hot tenant: shed first, and harder.
                    p = min(0.98, p * 2 + 0.25)
                    over_share = True
                else:
                    # In-share tenant: protected while the hot one pays.
                    p = p * 0.5
        if self._rng.random() < p:
            self.shed += n
            if over_share:
                self.shed_tenant += n
            return self.retry_after()
        self.admitted += n
        if tenant is not None and self.tenant_fair:
            self._tenant_cur[tenant] = self._tenant_cur.get(tenant, 0) + n
        return None

    def admit_txn(self, n: int = 1,
                  tenant: Optional[str] = None) -> Optional[float]:
        """Whole-TRANSACTION admission (the 2PC plane, runtime/txn.py):
        one decision covers all ``n`` entries the transaction will write
        across every participant group, taken BEFORE txn_begin is
        submitted.  This is the txn-level shed the overload plane
        requires — refusing here costs the cluster nothing (no id
        allocated, no intent buffered, retry is trivially safe), whereas
        refusing one participant's PREPARE mid-flight strands the other
        participants' intents until the abort fan-out or the deadline
        sweep reclaims them.  Same control law and hint as :meth:`admit`;
        accounted separately so /healthz and the open-loop proof can
        show refusals happen at the txn boundary."""
        ra = self.admit(n, tenant)
        if ra is None:
            self.txn_admitted += 1
        else:
            self.txn_shed += 1
        return ra

    def retry_after(self) -> float:
        """Server-issued backoff hint: at least one observation window —
        retrying sooner cannot see a different decision — stretched with
        the shed level so deep overload pushes clients further out."""
        return round(max(0.05, self.interval_now() * (0.5 + 2.0 * self.level)),
                     4)

    def busy_retry_after(self) -> float:
        """Hint for HARD-BOUND refusals (queue full): the queue drains at
        tick cadence, so a couple of ticks is the soonest a retry can see
        free space.  Distinct from :meth:`retry_after` — a full queue is
        a burst, not necessarily overload."""
        if self.overloaded:
            return self.retry_after()
        e = self._tick_ewma or 0.0
        return round(max(0.02, min(5.0, 2.0 * e)), 4)

    def expire_age(self) -> Optional[float]:
        """Queue-age cap while shedding (None = expiry off): batches
        still queued past this age are refused UNSERVED at the
        device-accept sweep.  Admission refusal alone cannot bound the
        admitted tail — the backlog admitted BEFORE the controller
        engaged keeps rotting in the queue, and under LIFO it would be
        served dead-last, long past any client deadline.  Origin CoDel
        drops from the queue for exactly this reason; refusing here is
        still retry-safe because the entry provably never reached the
        log.

        Engages as soon as the CURRENT window's min-sojourn crosses the
        target — not only after a window closes bad — so the transient
        backlog that piles up in the lag between overload onset and the
        first bad-window verdict still gets burned instead of served a
        second too late."""
        if not self.enabled or self.expire_factor <= 0.0:
            return None
        if not (self.overloaded
                or (self._win_min is not None
                    and self._win_min > self.target_now())):
            return None
        return self.expire_factor * self.target_now()

    def lifo_now(self) -> bool:
        """Serve newest-first while actively shedding (see __init__)."""
        return self.enabled and self.lifo and self.level > 0.0

    @property
    def overloaded(self) -> bool:
        return self.level > 0.0

    # ------------------------------------------------------------- helpers --

    def force_level(self, level: float, bad_windows: int = 4) -> None:
        """Test hook: pin the controller into an overloaded state."""
        self.level = float(level)
        self._bad_windows = int(bad_windows)

    def snapshot(self) -> dict:
        """The /healthz overload block's view (reads only)."""
        return {
            "enabled": self.enabled,
            "shedding": self.overloaded,
            "level": round(self.level, 4),
            "target_s": round(self.target_now(), 6),
            "interval_s": round(self.interval_now(), 6),
            "retry_after_s": self.retry_after() if self.overloaded else 0.0,
            "lifo": self.lifo_now(),
            "admitted_total": self.admitted,
            "shed_total": self.shed,
            "shed_tenant_total": self.shed_tenant,
            "expired_total": self.expired,
            "txn_admitted_total": self.txn_admitted,
            "txn_shed_total": self.txn_shed,
        }


def admission_from_env(seed: int = 0) -> AdmissionController:
    """Build from env knobs:

    * ``RAFT_ADMISSION``           — 0/false disables (default on);
    * ``RAFT_ADMISSION_TARGET_MS`` — absolute delay-target floor (50);
    * ``RAFT_ADMISSION_TARGET_TICKS`` — delay target in ticks (3; a
      submission waits >= 1 tick by construction, so ~2 ticks of queue
      is burst absorption and more is a standing backlog);
    * ``RAFT_ADMISSION_INTERVAL_MS``  — min observation window (100);
    * ``RAFT_ADMISSION_LIFO``      — newest-first under overload (on);
    * ``RAFT_ADMISSION_FAIR``      — per-tenant fair shedding (on);
    * ``RAFT_ADMISSION_EXPIRE``    — queue-age cap in units of the delay
      target while shedding (2; 0 disables late shedding).
    """
    def flag(name: str, default: bool) -> bool:
        v = os.environ.get(name, "").strip().lower()
        if not v:
            return default
        return v not in ("0", "false", "no", "off")

    return AdmissionController(
        enabled=flag("RAFT_ADMISSION", True),
        target_s=float(os.environ.get("RAFT_ADMISSION_TARGET_MS", "50"))
        / 1e3,
        target_ticks=float(
            os.environ.get("RAFT_ADMISSION_TARGET_TICKS", "3")),
        interval_s=float(
            os.environ.get("RAFT_ADMISSION_INTERVAL_MS", "100")) / 1e3,
        lifo=flag("RAFT_ADMISSION_LIFO", True),
        tenant_fair=flag("RAFT_ADMISSION_FAIR", True),
        expire_factor=float(os.environ.get("RAFT_ADMISSION_EXPIRE", "2")),
        seed=seed,
    )
