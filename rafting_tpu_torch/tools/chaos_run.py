"""Seeded chaos soak on the port: every nemesis at once, judged by the checker.

The twin of the repo's ``tools/chaos_run.py`` over ``rafting_tpu_torch``:
the same arguments, modes, judgments and artifact, plus ``--device``
(required), where every node's engine runs.

Drives a LocalCluster of full node runtimes (engine + WAL + machines +
read plane) under a seeded mixed-nemesis timeline — asymmetric
partitions, flaky links, crash/restart, clock stalls, slow storage,
membership churn (testkit/chaos.py) — while seeded client threads
drive load through recording stubs (testkit/history.py).

Two workloads:

* ``--workload kv`` (default): register+list KV traffic at one group;
  afterwards the Wing & Gong checker (testkit/linz.py) must find the
  recorded history linearizable.
* ``--workload transfer``: the Jepsen BANK TEST over the cross-group
  2PC plane (runtime/txn.py) — concurrent bank transfers between
  accounts in different Raft groups, coordinated by a replicated 2PC
  coordinator group.  The judgment is
  testkit/invariants.py:check_transfer_atomicity over converged state:
  total balance conserved, no lost / phantom / half-applied transfer,
  zero stranded intents after the deadline sweep.  ``--min-transfers``
  replays fresh seeded timelines (seed, seed+1, ...) until that many
  transfers were attempted, so long soaks stay replayable round by
  round.

Either way the run saves an auditable artifact under ``artifacts/``,
named with the device (``chaos_soak_gpu_*``, ``chaos_soak_torch-cpu_*``),
embedding the canonical timeline(s) (byte-for-byte reproducible from
the seed), the applied-event audit, the transport fault counters, the
raw history and the verdict.

A third nemesis mode targets the GRAY failure (``--nemesis
leader-isolate``): every link INTO one group's current leader is cut
while its outbound heartbeats keep suppressing follower timers — the
hostage scenario CheckQuorum (core/step.py phase 6c) exists for.  The
judgment adds a GOODPUT-RECOVERY assertion on top of the checker: after
every isolate lands, new client ops must commit within
``--recovery-ticks`` WHILE THE CUT IS STILL ACTIVE (the old leader
steps itself down, the healthy majority re-elects).  With
``--no-check-quorum`` the verdict is EXPECTED to fail — the group is
hostage for the whole window, goodput flatlines, and the saved
artifact is the committed availability counterexample the self-healing
plane closes.  (The lease cannot serve stale reads here either way:
its evidence is ack-receipt based, so the inbound cut starves it —
unavailability, not corruption.  tests/test_linz.py carries the same
framing at test scale.)

The soak runs the serial node runtime, as the committed CPU artifacts
did (on the card the pipelined runtime takes ~10 ticks per execute,
which times the isolate soak's clients out).  On the card,
``CALIBRATION_STEPS`` idle conductor steps of a throwaway cluster of the
soak's shape measure one step first, and the admission controller's
delay target becomes ``max(its floor, 3 steps)``: a LocalCluster node's
own tick-based target (3 of ITS ticks) is one conductor step, which
every submission waits by construction, and a card step (60-110 ms)
nears or passes the 50 ms floor.  The soak's own cluster gets no extra
steps: with them the checker's search over the isolate soak's list key
took up to 80 s instead of 0.1-2 s on the CPU, and over 800 s once on
the card.  On the CPU nothing is measured and the target stays at the
floor, as the committed artifacts ran (a CPU step is ~25-45 ms).  A history with more than ``INFO_LIMIT``
unknown-outcome writes on one key is refused instead of judged: the
checker's search grows exponentially in them.

Usage:
    python -m rafting_tpu_torch.tools.chaos_run --device cuda --seed 7 \
        --ticks 400
    ... --nemesis leader-isolate --tick-wall 0.289  # paced like the
                                                    # committed artifact
    ... --no-lease        # strict ReadIndex instead of the lease path
    ... --transport tcp   # real localhost sockets (slower, full plane)
    ... --stale-reads     # inject the stale-read defect: MUST fail,
                          # prints the minimal counterexample (checker
                          # self-test; exits 0 when the bug is caught)
    ... --workload transfer --min-transfers 5000   # the bank soak
    ... --nemesis leader-isolate                   # gray-failure soak
    ... --nemesis leader-isolate --no-check-quorum # hostage proof

Exit status: 0 = verdict matches expectation, 1 = it does not.
"""

import argparse
import json
import os
import sys
import tempfile
import time

from ._artifact import PhaseLog

CALIBRATION_STEPS = (5, 20)     # warm-up, measured
INFO_LIMIT = 48


def judge(history):
    """``linz.check`` of ``history``, refused (RuntimeError) past
    INFO_LIMIT unknown-outcome writes on one key."""
    from ..testkit import linz

    info = {}
    for op in history.ops():
        if op.status == "info" and op.kind in ("w", "a"):
            info[op.key] = info.get(op.key, 0) + 1
    if max(info.values(), default=0) > INFO_LIMIT:
        raise RuntimeError(f"unknown-outcome writes per key {info} exceed "
                           f"{INFO_LIMIT}: the history cannot be judged")
    return linz.check(history)


def calibrate(cfg, root: str, device) -> float:
    """Mean wall seconds of one idle conductor step (every node ticks
    once) of a throwaway LocalCluster of ``cfg`` on ``device`` under
    ``root``, which is removed afterwards."""
    import shutil

    from ..testkit.harness import LocalCluster

    cluster = LocalCluster(cfg, root, device=device)
    try:
        for g in range(cfg.n_groups):
            cluster.wait_leader(g)

        def step():
            for n in list(cluster.nodes.values()):
                n.tick()
        warm, n = CALIBRATION_STEPS
        for _ in range(warm):
            step()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        return (time.perf_counter() - t0) / n
    finally:
        cluster.close()
        shutil.rmtree(root, ignore_errors=True)


def run_kv(args, log, cluster, history, events, tl):
    """The register+list workload judged by the per-key checker."""
    from ..testkit.chaos import ChaosConductor, KVWorkload

    conductor = ChaosConductor(cluster, events)
    load = KVWorkload(cluster, history, group=args.group,
                      clients=args.clients, seed=args.seed)
    load.start()
    conductor.run(extra_ticks=40, tick_sleep=args.tick_sleep)
    load.stop()
    load.join(tick_fn=conductor.step)
    conductor.finish()
    log.phase("soak done", ticks=conductor.t,
              applied=len(conductor.applied),
              ops=load.ops_attempted, **history.counts())

    verdict = judge(history)
    print(verdict.render(), flush=True)
    counters = cluster.faults.snapshot()["counters"]
    log.phase("checked", ok=verdict.ok, keys=verdict.checked_keys,
              **{f"net_{k}": v for k, v in counters.items()})
    expected_ok = not args.stale_reads
    return verdict.ok == expected_ok, {
        "timeline": json.loads(tl),
        "timeline_canonical": tl,
        "applied": conductor.applied,
        "fault_counters": counters,
        "history": history.to_json(),
        "verdict": {
            "ok": verdict.ok,
            "key": verdict.key,
            "counterexample": [op.describe()
                               for op in verdict.counterexample],
        },
    }


def run_kv_isolate(args, log, cluster, history, events, tl):
    """The gray-failure soak: leader_isolate nemesis + KV workload,
    judged by the checker AND per-window goodput recovery."""
    from ..testkit.chaos import ChaosConductor, KVWorkload

    conductor = ChaosConductor(cluster, events)
    # op_timeout=3: a client op stuck forwarding into the cut fails in
    # 3s wall and retries against the re-elected leader — the 6s
    # default would burn most of the recovery budget on one dead
    # forward.
    load = KVWorkload(cluster, history, group=args.group,
                      clients=args.clients, seed=args.seed,
                      op_timeout=3.0)
    load.start()
    # Per-tick cumulative ok-op series: the goodput trace the recovery
    # judgment (and the artifact's flatline evidence) reads.
    ok_series = []
    end = conductor.horizon + 1 + 40
    while conductor.t < end:
        t_tick = time.perf_counter()
        conductor.step()
        ok_series.append(history.counts()["ok"])
        if args.tick_wall is not None:
            time.sleep(max(0.0, args.tick_wall
                           - (time.perf_counter() - t_tick)))
        elif args.tick_sleep:
            time.sleep(args.tick_sleep)
    load.stop()
    load.join(tick_fn=conductor.step)
    conductor.finish()
    stepdowns = sum(
        n.metrics._counters.get("checkquorum_stepdowns", 0)
        for n in cluster.nodes.values())
    log.phase("soak done", ticks=conductor.t,
              applied=len(conductor.applied),
              ops=load.ops_attempted, stepdowns=stepdowns,
              **history.counts())

    # Recovery judgment: after each applied isolate, NEW ok ops must
    # land within the budget — while the cut is still open (the budget
    # is sized under the isolate duration: step-down <= 2 election
    # timeouts, re-election, first commits).
    windows = []
    for ev in conductor.applied:
        if ev["kind"] != "leader_isolate" or "victim" not in ev:
            continue
        t0 = min(ev["t"], len(ok_series) - 1)
        t1 = min(t0 + args.recovery_ticks, len(ok_series) - 1)
        first = next((t for t in range(t0 + 1, len(ok_series))
                      if ok_series[t] > ok_series[t0]), None)
        windows.append({
            "cut_tick": ev["t"], "victim": ev["victim"],
            "ok_at_cut": ok_series[t0], "ok_at_budget": ok_series[t1],
            "first_ok_tick": first,
            "recovered": ok_series[t1] > ok_series[t0],
        })
    recovered = bool(windows) and all(w["recovered"] for w in windows)
    verdict = judge(history)
    print(verdict.render(), flush=True)
    counters = cluster.faults.snapshot()["counters"]
    log.phase("checked", ok=verdict.ok, recovered=recovered,
              windows=len(windows), keys=verdict.checked_keys,
              **{f"net_{k}": v for k, v in counters.items()})
    # The self-healing claim needs all three legs: clean history, the
    # step-down actually fired, and goodput resumed inside the budget.
    ok = verdict.ok and recovered and stepdowns >= 1
    # CheckQuorum off is the EXPECTED-fail counterexample run: the
    # history stays clean (nothing commits through a hostage leader)
    # but no step-down fires and goodput never recovers inside any
    # window.
    expected_ok = not args.no_check_quorum
    return ok == expected_ok, {
        "timeline": json.loads(tl),
        "timeline_canonical": tl,
        "applied": conductor.applied,
        "fault_counters": counters,
        "history": history.to_json(),
        "goodput_ok_series": ok_series,
        "recovery_windows": windows,
        "checkquorum_stepdowns": stepdowns,
        "verdict": {
            "ok": verdict.ok,
            "recovered": recovered,
            "key": verdict.key,
            "counterexample": [op.describe()
                               for op in verdict.counterexample],
        },
    }


def run_transfer(args, log, cluster, history):
    """The bank-transfer workload judged by the 2PC atomicity invariant."""
    from ..testkit.chaos import (
        ChaosConductor, TransferWorkload, plan_chaos, timeline_json,
    )
    from ..testkit.invariants import (
        InvariantViolation, check_transfer_atomicity,
    )

    coord = args.coord_group
    participants = [g for g in range(args.groups) if g != coord]
    assert len(participants) >= 2, \
        "transfer mode needs >= 2 participant groups besides the coordinator"
    for n in cluster.nodes.values():
        n.txn.sweep_every = 8   # brisk in-doubt recovery under chaos

    # Seed the bank before any nemesis fires (lockstep, no ticker yet).
    for g in participants:
        for a in range(args.accounts):
            cluster.submit_via_leader(g, json.dumps(
                {"op": "set", "k": f"acct{a}",
                 "v": args.seed_balance}).encode())
    initial_total = len(participants) * args.accounts * args.seed_balance
    log.phase("bank seeded", participants=len(participants),
              accounts=args.accounts, initial_total=initial_total)

    load = TransferWorkload(cluster, history, coord_group=coord,
                            groups=participants, clients=args.clients,
                            seed=args.seed, accounts=args.accounts,
                            deadline_s=2.0, op_timeout=6.0)
    load.start()
    timelines, applied = [], []
    conductor = None
    rnd = 0
    while True:
        events = plan_chaos(args.peers, args.ticks, seed=args.seed + rnd,
                            period=args.period,
                            churn_group=participants[0])
        timelines.append(timeline_json(events))
        conductor = ChaosConductor(cluster, events)
        conductor.run(extra_ticks=40, tick_sleep=args.tick_sleep)
        conductor.finish()   # heal fully: each round replays standalone
        applied.extend(conductor.applied)
        rnd += 1
        log.phase(f"round {rnd}", **load.counts())
        if load.attempted >= args.min_transfers or rnd >= args.max_rounds:
            break
    load.stop()
    load.join(tick_fn=conductor.step)
    log.phase("soak done", rounds=rnd, applied=len(applied),
              **load.counts())

    # Drain: tick until the deadline sweep resolved every in-doubt
    # intent everywhere (the no-key-locked-past-deadline guarantee).
    def clean():
        for node in cluster.nodes.values():
            for g in participants:
                m = node.dispatcher.machine(g)
                if m.intents or m.locks:
                    return False
        return True
    deadline = time.time() + args.drain_s
    while not clean() and time.time() < deadline:
        conductor.step()
        time.sleep(args.tick_sleep)
    drained = clean()
    log.phase("drained", clean=drained)

    def leader_machine(g):
        lead = cluster.leader_of(g)
        return cluster.nodes[lead].dispatcher.machine(g)

    violation = None
    report = {}
    try:
        report = check_transfer_atomicity(
            leader_machine(coord),
            {g: leader_machine(g) for g in participants},
            initial_total=initial_total)
    except InvariantViolation as e:
        violation = str(e)
    ok = drained and violation is None
    plane = {i: n.txn.snapshot() for i, n in cluster.nodes.items()}
    counters = cluster.faults.snapshot()["counters"]
    log.phase("judged", ok=ok, violation=violation or "none", **report)
    if violation:
        print(f"INVARIANT VIOLATION: {violation}", flush=True)
    else:
        print(f"bank invariant holds: {report}", flush=True)
    return ok, {
        "timelines_canonical": timelines,
        "applied": applied,
        "fault_counters": counters,
        "history": history.to_json(),
        "workload": load.counts(),
        "txn_plane": plane,
        "verdict": {"ok": ok, "drained": drained,
                    "violation": violation, "report": report},
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", required=True,
                    help="torch device of every node's engine ('cuda' for "
                         "the card, 'cpu' for the plain version)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=300,
                    help="timeline horizon (nemesis events stop here)")
    ap.add_argument("--period", type=int, default=12,
                    help="ticks between nemesis draws")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--group", type=int, default=1,
                    help="group the kv workload targets")
    ap.add_argument("--no-lease", action="store_true",
                    help="strict ReadIndex reads (read_lease=False)")
    ap.add_argument("--transport", choices=("loopback", "tcp"),
                    default="loopback")
    ap.add_argument("--stale-reads", action="store_true",
                    help="arm the KV machine's stale-read defect; the "
                         "checker is then EXPECTED to fail")
    ap.add_argument("--tick-sleep", type=float, default=None,
                    help="conductor sleep per tick (yields to clients). "
                         "Default 0.002; leader-isolate mode defaults "
                         "to 0.25: client recovery is WALL-bound "
                         "(op timeouts, retry backoff sleeps) while the "
                         "recovery budget is counted in TICKS, so the "
                         "tick must be slow enough that a couple of "
                         "seconds of client wall time spans only a "
                         "handful of ticks")
    ap.add_argument("--tick-wall", type=float, default=None,
                    help="leader-isolate: pace each conductor tick to "
                         "this many wall seconds (sleeping what the step "
                         "left) instead of sleeping --tick-sleep after "
                         "it; the committed CPU artifact ran 0.289")
    ap.add_argument("--root", default=None,
                    help="data dir (default: a fresh temp dir)")
    ap.add_argument("--workload", choices=("kv", "transfer"),
                    default="kv")
    ap.add_argument("--coord-group", type=int, default=0,
                    help="transfer mode: the 2PC coordinator group")
    ap.add_argument("--accounts", type=int, default=12,
                    help="transfer mode: accounts per participant group")
    ap.add_argument("--seed-balance", type=int, default=1000,
                    help="transfer mode: initial balance per account")
    ap.add_argument("--min-transfers", type=int, default=0,
                    help="transfer mode: replay fresh seeded timelines "
                         "until this many transfers were attempted")
    ap.add_argument("--max-rounds", type=int, default=200,
                    help="transfer mode: hard cap on timeline replays")
    ap.add_argument("--drain-s", type=float, default=120.0,
                    help="transfer mode: max seconds to drain intents")
    ap.add_argument("--nemesis", choices=("mixed", "leader-isolate"),
                    default="mixed",
                    help="mixed = the full seeded nemesis mix; "
                         "leader-isolate = inbound-only cuts of the "
                         "workload group's current leader (gray "
                         "failure; kv workload only)")
    ap.add_argument("--no-check-quorum", action="store_true",
                    help="disable CheckQuorum (leader-isolate then "
                         "EXPECTS the recovery verdict to fail — the "
                         "hostage counterexample artifact)")
    ap.add_argument("--isolate-period", type=int, default=100,
                    help="leader-isolate: ticks between cuts")
    ap.add_argument("--isolate-dur", type=int, default=70,
                    help="leader-isolate: ticks each cut stays open")
    ap.add_argument("--recovery-ticks", type=int, default=60,
                    help="leader-isolate: goodput must resume within "
                         "this many ticks of each cut (must be under "
                         "--isolate-dur so recovery happens under the "
                         "live cut; the budget covers step-down <= 2 "
                         "election timeouts + follower timeout + "
                         "re-election + client retry backoff)")
    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    if args.tick_sleep is None:
        args.tick_sleep = (0.25 if args.nemesis == "leader-isolate"
                           else 0.002)
    if args.nemesis == "leader-isolate":
        assert args.workload == "kv", \
            "leader-isolate judges kv goodput; transfer mode keeps mixed"
        assert args.recovery_ticks < args.isolate_dur, \
            "--recovery-ticks must fit inside --isolate-dur"
    return args


def soak(args: argparse.Namespace):
    """One soak as ``args`` say: returns (verdict matched, the artifact's
    config document, the artifact's path)."""
    from ..core.types import EngineConfig, resolve_device
    from ..machine.kv_machine import KVMachineProvider
    from ..testkit.chaos import plan_chaos, timeline_json
    from ..testkit.harness import LocalCluster
    from ..testkit.history import History

    device = resolve_device(args.device)

    cfg = EngineConfig(n_groups=args.groups, n_peers=args.peers,
                       log_slots=64, batch=8, max_submit=8,
                       election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8,
                       read_lease=not args.no_lease,
                       check_quorum=not args.no_check_quorum)
    name = ("chaos_soak_isolate" if args.nemesis == "leader-isolate"
            else "chaos_soak" if args.workload == "kv"
            else "chaos_soak_transfer")
    log = PhaseLog(name, args.seed, {
        "peers": args.peers, "groups": args.groups, "ticks": args.ticks,
        "period": args.period, "clients": args.clients,
        "lease": not args.no_lease, "transport": args.transport,
        "stale_reads": args.stale_reads, "workload": args.workload,
        "nemesis": args.nemesis,
        "check_quorum": not args.no_check_quorum,
        "device": str(device),
    })
    log.argv = args.argv

    root = args.root or tempfile.mkdtemp(prefix="chaos_soak_")
    history = History()
    env_target = os.environ.get("RAFT_ADMISSION_TARGET_MS")
    cluster = None
    try:
        if device.type == "cuda":
            step_s = calibrate(cfg, os.path.join(root, "calibration"),
                               device)
            target_s = max(float(env_target or 50) / 1e3, 3 * step_s)
            # Every node reads it as it starts, restarted ones too.
            os.environ["RAFT_ADMISSION_TARGET_MS"] = f"{target_s * 1e3:.1f}"
            cal = dict(step_ms=round(step_s * 1e3, 3),
                       admission_target_ms=round(target_s * 1e3, 3))
            log.config.update(cal)
            log.phase("calibrated", **cal)
        cluster = LocalCluster(
            cfg, root, seed=args.seed,
            provider_factory=lambda i: KVMachineProvider(
                os.path.join(root, f"node{i}", "kv"),
                stale_reads=args.stale_reads),
            transport=args.transport, pipeline=False, device=device)
        for g in range(args.groups):
            cluster.wait_leader(g)
        log.phase("cluster up", nodes=args.peers)
        if args.nemesis == "leader-isolate":
            from ..testkit.chaos import plan_leader_isolate
            events = plan_leader_isolate(
                args.ticks, seed=args.seed, group=args.group,
                period=args.isolate_period, dur=args.isolate_dur)
            tl = timeline_json(events)
            log.phase("planned", events=len(events),
                      timeline_bytes=len(tl))
            success, doc_extra = run_kv_isolate(args, log, cluster,
                                                history, events, tl)
        elif args.workload == "kv":
            events = plan_chaos(args.peers, args.ticks, seed=args.seed,
                                period=args.period,
                                churn_group=args.group)
            tl = timeline_json(events)
            log.phase("planned", events=len(events),
                      timeline_bytes=len(tl))
            success, doc_extra = run_kv(args, log, cluster, history,
                                        events, tl)
        else:
            success, doc_extra = run_transfer(args, log, cluster,
                                              history)
    finally:
        if cluster is not None:
            cluster.close()
        if env_target is None:
            os.environ.pop("RAFT_ADMISSION_TARGET_MS", None)
        else:
            os.environ["RAFT_ADMISSION_TARGET_MS"] = env_target

    log.config.update(doc_extra)
    platform = "gpu" if device.type == "cuda" else f"torch-{device.type}"
    path = log.save(platform, ok=success)
    if not success:
        print("FAIL: verdict did not match expectation", flush=True)
    return success, log.config, path


def main(argv=None) -> int:
    success, _, _ = soak(parse_args(argv))
    return 0 if success else 1


if __name__ == "__main__":
    sys.exit(main())
