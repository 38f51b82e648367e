"""Open-loop traffic harness: offered load that does NOT wait for you.

The closed-loop drivers everywhere else in this repo (bench.py,
LocalCluster tests) submit, wait, submit — so offered load automatically
tracks capacity and latency collapse is INVISIBLE: the system can't be
overloaded by a driver that politely blocks (ROADMAP item 5: "the
current closed-loop burst bench can't see latency collapse").  Real
clients are open-loop: arrivals come from the outside world at their own
rate, and when the system falls behind, queues — not the driver — absorb
the difference.  This module generates that traffic:

* seeded **Poisson** arrivals (exponential inter-arrival at ``rate``)
  and bursty **MMPP** (2-state Markov-modulated Poisson: a quiet rate
  and a burst rate with exponentially-distributed dwells — the classic
  model for flash-crowd traffic);
* **multi-tenant Zipf skew**: tenant identity and target group are both
  drawn Zipf-distributed, so one hot tenant / hot group dominates the
  offered mix exactly the way production keyspaces do;
* **per-request deadlines**: a completion after its deadline is NOT
  goodput — it's work the system wasted on an answer nobody is waiting
  for anymore.

The harness fires each arrival at its scheduled instant (spinning the
caller-supplied ``step`` — usually one cluster tick — while waiting),
registers a done-callback, and moves on WITHOUT awaiting the future.
Results classify every arrival: completed-in-deadline (goodput), late,
shed (typed refusal taxonomy: admission shed / queue-full busy /
routing / unavailable), errored, or still pending at drain end; latency
percentiles (p50/p99/p999) are reported over ADMITTED completions —
the no-collapse property is "goodput plateaus AND admitted p999 stays
bounded", never "nothing is refused".

Everything is deterministic given ``seed`` (arrival times, tenant/group
draws) — completions of course depend on the system under test.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "OpenLoopSpec", "OpenLoopResult", "Transfer", "gen_schedule",
    "gen_transfers", "run_open_loop", "zipf_weights",
]


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Zipf pmf over ranks 1..n with exponent ``s`` (s=0 -> uniform)."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


@dataclass
class OpenLoopSpec:
    """One open-loop run's traffic law.

    ``rate``: mean arrivals/second (Poisson), or the QUIET rate when
    ``mmpp`` is set.  ``mmpp``: (burst_rate, mean_quiet_s, mean_burst_s)
    — a 2-state MMPP alternating exponential dwells between ``rate`` and
    ``burst_rate``.  ``deadline_s``: per-request SLO; completions later
    than this are not goodput.  ``tenant_zipf``/``group_zipf``: skew
    exponents (0 = uniform).  ``hot_tenant_share`` (optional override):
    when set, tenant 0 is drawn with exactly this probability and the
    rest uniformly — the one-hot-tenant fairness scenario without
    needing an extreme exponent."""
    rate: float = 200.0
    duration_s: float = 2.0
    n_tenants: int = 4
    n_groups: int = 4
    tenant_zipf: float = 1.1
    group_zipf: float = 0.8
    deadline_s: float = 1.0
    mmpp: Optional[Tuple[float, float, float]] = None
    hot_tenant_share: Optional[float] = None
    seed: int = 0


# One scheduled arrival: (t_offset_s, tenant_name, group_rank).
Arrival = Tuple[float, str, int]


def gen_schedule(spec: OpenLoopSpec) -> List[Arrival]:
    """Materialize the arrival schedule — deterministic in ``spec.seed``.
    Group ranks are 0..n_groups-1 by hotness; the caller maps rank to
    actual group ids (identity is the common case)."""
    rng = random.Random(spec.seed ^ 0x09E37)
    tw = zipf_weights(spec.n_tenants, spec.tenant_zipf)
    if spec.hot_tenant_share is not None and spec.n_tenants > 1:
        rest = (1.0 - spec.hot_tenant_share) / (spec.n_tenants - 1)
        tw = np.array([spec.hot_tenant_share]
                      + [rest] * (spec.n_tenants - 1))
    gw = zipf_weights(spec.n_groups, spec.group_zipf)
    t_cum = np.cumsum(tw)
    g_cum = np.cumsum(gw)

    out: List[Arrival] = []
    t = 0.0
    if spec.mmpp is None:
        lam = spec.rate
        while t < spec.duration_s:
            t += rng.expovariate(lam)
            if t >= spec.duration_s:
                break
            ten = int(np.searchsorted(t_cum, rng.random()))
            grp = int(np.searchsorted(g_cum, rng.random()))
            out.append((t, f"tenant-{ten}", grp))
    else:
        burst_rate, mean_quiet, mean_burst = spec.mmpp
        bursting = False
        # Next modulation switch; dwells are exponential.
        t_switch = rng.expovariate(1.0 / mean_quiet)
        while t < spec.duration_s:
            lam = burst_rate if bursting else spec.rate
            t += rng.expovariate(lam)
            while t >= t_switch:
                bursting = not bursting
                t_switch += rng.expovariate(
                    1.0 / (mean_burst if bursting else mean_quiet))
            if t >= spec.duration_s:
                break
            ten = int(np.searchsorted(t_cum, rng.random()))
            grp = int(np.searchsorted(g_cum, rng.random()))
            out.append((t, f"tenant-{ten}", grp))
    return out


# One scheduled bank transfer: (t_offset_s, tenant, src_group_rank,
# dst_group_rank, src_key, dst_key, amount) — the 2-key txn workload
# for the cross-group transaction plane (runtime/txn.py).
Transfer = Tuple[float, str, int, int, str, str, int]


def gen_transfers(spec: OpenLoopSpec, n_accounts: int = 64,
                  account_zipf: float = 1.0,
                  max_amount: int = 5) -> List[Transfer]:
    """Materialize a seeded transfers-between-accounts schedule on top
    of :func:`gen_schedule`'s arrival law: each arrival becomes a 2-key
    transfer debiting ``src_key`` on the arrival's (Zipf-hot) group and
    crediting ``dst_key`` on a different group, with BOTH account keys
    drawn Zipf over ``n_accounts`` — hot accounts contend, which is
    what gives the 2PC plane real lock conflicts to abort on.  Amounts
    are uniform in [1, max_amount].  Deterministic in ``spec.seed``;
    the sum of all balances is invariant under any subset of these
    transfers applied atomically (testkit/invariants.py judges that)."""
    sched = gen_schedule(spec)
    rng = random.Random(spec.seed ^ 0x72A45)
    a_cum = np.cumsum(zipf_weights(n_accounts, account_zipf))
    out: List[Transfer] = []
    for t, tenant, src in sched:
        if spec.n_groups > 1:
            dst = rng.randrange(spec.n_groups - 1)
            if dst >= src:
                dst += 1
        else:
            dst = src
        a = int(np.searchsorted(a_cum, rng.random()))
        b = int(np.searchsorted(a_cum, rng.random()))
        out.append((t, tenant, src, dst, f"acct{a}", f"acct{b}",
                    1 + rng.randrange(max_amount)))
    return out


@dataclass
class _TenantStat:
    offered: int = 0
    ok: int = 0
    shed: int = 0


@dataclass
class OpenLoopResult:
    """Outcome of one open-loop run.  ``goodput`` counts completions
    within their deadline; ``admitted_lat`` percentiles cover every
    ADMITTED completion (in- or out-of-deadline) — the tail the
    no-collapse property bounds."""
    offered: int = 0
    ok: int = 0                 # completed within deadline (goodput)
    late: int = 0               # completed past deadline
    shed_overload: int = 0      # OverloadError (admission shed)
    shed_busy: int = 0          # BusyLoopError (hard queue bound)
    shed_routing: int = 0       # NotLeader / NotReady
    shed_unavailable: int = 0   # Unavailable / StorageFault
    errors: int = 0             # anything else
    pending: int = 0            # unresolved at drain end
    duration_s: float = 0.0
    p50_s: float = 0.0
    p99_s: float = 0.0
    p999_s: float = 0.0
    per_tenant: Dict[str, _TenantStat] = field(default_factory=dict)

    @property
    def shed(self) -> int:
        return (self.shed_overload + self.shed_busy
                + self.shed_routing + self.shed_unavailable)

    @property
    def goodput(self) -> float:
        return self.ok / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def offered_rate(self) -> float:
        return self.offered / self.duration_s if self.duration_s > 0 \
            else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    def to_dict(self) -> dict:
        return {
            "offered": self.offered, "ok": self.ok, "late": self.late,
            "shed_overload": self.shed_overload,
            "shed_busy": self.shed_busy,
            "shed_routing": self.shed_routing,
            "shed_unavailable": self.shed_unavailable,
            "errors": self.errors, "pending": self.pending,
            "duration_s": round(self.duration_s, 3),
            "offered_rate": round(self.offered_rate, 1),
            "goodput": round(self.goodput, 1),
            "shed_rate": round(self.shed_rate, 4),
            "admitted_p50_s": round(self.p50_s, 6),
            "admitted_p99_s": round(self.p99_s, 6),
            "admitted_p999_s": round(self.p999_s, 6),
        }


def _classify(res: OpenLoopResult, name: str) -> None:
    """Fold one failure outcome (by exception-type NAME — callbacks
    record names, not live objects) into the refusal taxonomy."""
    if name == "OverloadError":
        res.shed_overload += 1
    elif name == "BusyLoopError":
        res.shed_busy += 1
    elif name in ("NotLeaderError", "NotReadyError"):
        res.shed_routing += 1
    elif name in ("UnavailableError", "StorageFaultError"):
        res.shed_unavailable += 1
    else:
        res.errors += 1


def run_open_loop(spec: OpenLoopSpec,
                  submit: Callable[[int, str, int], "object"],
                  step: Optional[Callable[[], None]] = None,
                  drain_s: float = 2.0,
                  schedule: Optional[List[Arrival]] = None
                  ) -> OpenLoopResult:
    """Fire ``spec``'s arrivals open-loop against ``submit(group_rank,
    tenant, seq) -> Future`` and classify every outcome.

    ``step``: called while waiting for the next arrival instant and
    during the drain — pass one cluster tick for lockstep tests (the
    harness then IS the tick driver), or None to sleep (free-running
    cluster / real transport).  The loop never blocks on a future:
    completions land via done-callbacks on whatever thread resolves
    them, so the offered schedule is honored regardless of how far the
    system falls behind — the whole point of open loop.

    ``drain_s``: after the last arrival, keep stepping this long for
    stragglers; whatever is still unresolved is counted ``pending``
    (pending at drain end is latency-collapse evidence, not noise)."""
    sched = gen_schedule(spec) if schedule is None else schedule
    res = OpenLoopResult(duration_s=spec.duration_s)
    for t_arr, tenant, _g in sched:
        res.per_tenant.setdefault(tenant, _TenantStat())

    # Completion records appended from resolver threads: plain list
    # appends are GIL-atomic; the harness only reads after the drain.
    done: List[Tuple[str, float, Optional[str]]] = []

    def fire(tenant: str, grp: int, seq: int) -> None:
        t_sub = time.monotonic()
        st = res.per_tenant[tenant]
        st.offered += 1
        try:
            fut = submit(grp, tenant, seq)
        except Exception as e:   # refusal raised synchronously
            done.append((tenant, 0.0, type(e).__name__))
            return
        if fut is None:          # fire-and-forget submit path
            return

        def _done(f, tenant=tenant, t_sub=t_sub):
            exc = f.exception()
            if exc is None:
                done.append((tenant, time.monotonic() - t_sub, None))
            else:
                done.append((tenant, 0.0, type(exc).__name__))
        fut.add_done_callback(_done)

    t0 = time.monotonic()
    for seq, (t_arr, tenant, grp) in enumerate(sched):
        # Honor the schedule: step (or sleep) until the arrival instant,
        # then fire without waiting.  If we're BEHIND schedule (step took
        # too long), fire immediately — arrivals never queue in the
        # harness itself.
        while time.monotonic() - t0 < t_arr:
            if step is not None:
                step()
            else:
                time.sleep(min(0.001, t_arr - (time.monotonic() - t0)))
        fire(tenant, grp, seq)
    res.offered = len(sched)

    # Drain: give stragglers a bounded chance to resolve.
    t_end = time.monotonic() + drain_s
    while time.monotonic() < t_end and len(done) < res.offered:
        if step is not None:
            step()
        else:
            time.sleep(0.005)

    lats: List[float] = []
    for tenant, lat, kind in done:
        st = res.per_tenant[tenant]
        if kind is None:
            lats.append(lat)
            if lat <= spec.deadline_s:
                res.ok += 1
                st.ok += 1
            else:
                res.late += 1
        else:
            _classify(res, kind)
            st.shed += 1
    res.pending = res.offered - len(done)
    if lats:
        arr = np.asarray(lats)
        res.p50_s = float(np.percentile(arr, 50))
        res.p99_s = float(np.percentile(arr, 99))
        res.p999_s = float(np.percentile(arr, 99.9))
    return res


def no_collapse_check(results: List[OpenLoopResult],
                      slo_s: float,
                      goodput_floor: float = 0.85
                      ) -> Tuple[bool, str]:
    """The acceptance predicate over a rate sweep: past-peak goodput must
    stay >= ``goodput_floor`` x peak, and every sweep point's admitted
    p999 must sit within the SLO.  Returns (ok, human-readable why)."""
    if not results:
        return False, "empty sweep"
    peaks = [r.goodput for r in results]
    peak = max(peaks)
    if peak <= 0:
        return False, "no goodput anywhere in the sweep"
    i_peak = peaks.index(peak)
    for i, r in enumerate(results):
        if i > i_peak and r.goodput < goodput_floor * peak:
            return False, (f"goodput collapsed past peak: point {i} "
                           f"{r.goodput:.1f}/s < {goodput_floor:.0%} of "
                           f"peak {peak:.1f}/s")
        if r.p999_s > slo_s and r.ok:
            return False, (f"admitted p999 {r.p999_s * 1e3:.1f}ms out of "
                           f"SLO {slo_s * 1e3:.1f}ms at point {i}")
    return True, f"peak {peak:.1f}/s, floor held, p999 within SLO"
