"""Durable-runtime benchmark of the port: commits/s through the full node
stack.

    python -m rafting_tpu_torch.tools.bench_runtime [n_groups ...] [--tcp] [--device cpu]

The twin of the repo's ``bench_runtime.py``.  Unlike ``tools/bench.py``
(the device engine, payload-free), this drives the product path: three
``RaftNode``s in one process with WAL durability (persist before send),
state-machine applies (``NullProvider``), snapshot and compaction
maintenance and the loopback transport (``--tcp``: real localhost
sockets).  Nodes tick one after another in one thread; the result
carries the slowest node's tick-latency histogram and its per-stage tick
breakdown.

Offered load follows the reference: dense per group at small group
counts, many quiet groups at 32k-100k.  The same ``BENCH_RT_*`` knobs,
JSON keys and A/B stages (``BENCH_PIPELINE``, ``BENCH_HOSTPAR``,
``BENCH_NATIVE``).  One departure: the reference pins its engine to the
CPU unless ``--default-backend`` is given; the twin runs the engine on
the card, and on the CPU only when the caller passes ``--device cpu``
(or ``run(..., device="cpu")``).  With no card and no device it exits.

Prints one JSON line per scale.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def _shape(n_groups: int):
    """(per-group burst, measured rounds, log_slots) per scale: dense at
    small G, aggregate-heavy at large G (at the 1M/s target the 100k
    regime is ~10 commits/s per group).  log_slots grows with scale
    because sustained acceptance is bounded by checkpoint throughput x
    ring capacity / n_groups (RaftNode.max_checkpoints_per_tick)."""
    if n_groups <= 8_192:
        return 32, 40, 1024
    if n_groups <= 32_768:
        return 8, 25, 512
    return 8, 12, 1024


def run(n_groups: int = 1024, rounds: int = 0, burst_n: int = 0,
        transport: str = "loopback", pipeline=None,
        host_workers=None, native=None, lat_sample=None,
        heat=None, hops=None, device=None) -> dict:
    """One scale; returns the reference's result dict.

    ``pipeline``: True/False forces the durable pipeline on/off for every
    node; None uses the runtime default (RAFT_PIPELINE if set, else on for
    the card).  ``host_workers``: striped host tier width per node (None:
    RAFT_HOST_WORKERS, else 1).  ``native``: pins the C++ stage_and_sync
    host tier on/off (RAFT_NATIVE_HOST) for the run; None: native when
    the library loads.  ``lat_sample``: pins RAFT_LAT_SAMPLE (1/N span
    sampling; 0 turns the latency plane off).  ``heat``: the per-group
    heat lanes in/out (None: off).  ``hops``: pins RAFT_HOP_TRACE.
    ``device``: where the engine runs (default the card; raises without
    one)."""
    from ..core.types import LEADER, EngineConfig, resolve_device
    from ..testkit.fixtures import NullProvider
    from ..testkit.harness import LocalCluster

    dev = resolve_device(device)
    d_burst, d_rounds, d_slots = _shape(n_groups)
    burst_n = burst_n or d_burst
    rounds = rounds or d_rounds

    # The tuned pipeline budget (S=32/B=32); BENCH_RT_* knobs override.
    slots = int(os.environ.get("BENCH_RT_SLOTS", str(d_slots)))
    cfg = EngineConfig(
        n_groups=n_groups, n_peers=3, log_slots=slots,
        batch=int(os.environ.get("BENCH_RT_BATCH", "32")),
        max_submit=int(os.environ.get("BENCH_RT_SUBMIT", "32")),
        election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8,
        heat=bool(heat))
    root = tempfile.mkdtemp(prefix="bench-runtime-")
    pins = {}
    if native is not None:
        pins["RAFT_NATIVE_HOST"] = "1" if native else "0"
    if lat_sample is not None:
        pins["RAFT_LAT_SAMPLE"] = str(lat_sample)
    if hops is not None:
        pins["RAFT_HOP_TRACE"] = "1" if hops else "0"
    env_prev = {k: os.environ.get(k) for k in pins}
    os.environ.update(pins)
    try:
        c = LocalCluster(cfg, root, provider_factory=NullProvider, seed=0,
                         transport=transport, pipeline=pipeline,
                         host_workers=host_workers, device=dev)
    finally:
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    payload = b"x" * 64
    burst = [payload] * burst_n

    def tick_round():
        for n in c.nodes.values():
            n.tick()

    def offer():
        # Fill every led, ready group's per-round budget through the bulk
        # batch API: one arena build and one lock per node.
        for n in c.nodes.values():
            mask = (n.h_role == LEADER) & n.h_ready
            n.submit_batch_many(np.nonzero(mask)[0], burst)

    try:
        c.wait_leader(0, max_rounds=300)
        # Settle until every group elected.
        for _ in range(40):
            c.tick(5)
            roles = np.stack([m.h_role for m in c.nodes.values()])
            if (roles == LEADER).any(axis=0).all():
                break
        leaders = np.array([c.leader_of(g) if c.leader_of(g) is not None
                            else -1 for g in range(n_groups)])
        assert (leaders >= 0).all()

        for _ in range(5):
            offer()
            tick_round()
        # Histograms and windowed rates cover the measured rounds only.
        for n in c.nodes.values():
            n.metrics.histogram("tick_latency_s").reset()
            for stage in n.metrics.breakdown():
                n.metrics.histogram(f"tick_stage_{stage}").reset()
            for name in list(n.metrics._histograms):
                if name.startswith("lat_"):
                    n.metrics.histogram(name).reset()
            n.metrics.checkpoint()
        start = sum(int(n.h_commit.astype(np.int64).sum())
                    for n in c.nodes.values()) / len(c.nodes)
        t0 = time.perf_counter()
        for _ in range(rounds):
            offer()
            tick_round()
        elapsed = time.perf_counter() - t0
        end = sum(int(n.h_commit.astype(np.int64).sum())
                  for n in c.nodes.values()) / len(c.nodes)
        commits = end - start
        lat = {}
        for n in c.nodes.values():
            h = n.metrics.histogram("tick_latency_s")
            if h.n and (not lat or h.quantile(0.5) > lat.get("p50_s", 0)):
                lat = {"p50_s": round(h.quantile(0.5), 5),
                       "p99_s": round(h.quantile(0.99), 5),
                       "max_s": round(h.max, 4),
                       "ticks": h.n}
        applies_ps = max((n.metrics.rates(since_last=True)
                          .get("applies_per_sec", 0.0))
                         for n in c.nodes.values())
        # Per-stage tick breakdown of the slowest node, mean s per tick.
        slow = max(c.nodes.values(),
                   key=lambda n: n.metrics.histogram("tick_latency_s").total)
        stages = {k: round(v["mean"], 6)
                  for k, v in slow.metrics.breakdown().items()}
        # Per-entry commit-path latency from the node with the most
        # completed spans.
        latency = {"sample_rate": 0}
        lat_node = max(c.nodes.values(),
                       key=lambda n: n.metrics.histogram("lat_e2e_s").n)
        if lat_node._lat is not None:
            def _summ(name):
                h = lat_node.metrics._histograms.get(name)
                if h is None or not h.n:
                    return None
                s = h.summary()
                return {"count": s["count"], "mean_s": round(s["mean"], 6),
                        "p50_s": round(s["p50"], 6),
                        "p99_s": round(s["p99"], 6),
                        "p999_s": round(h.quantile(0.999), 6),
                        "max_s": round(s["max"], 6)}
            latency = {
                "sample_rate": lat_node._lat.rate,
                "counts": dict(lat_node._lat.counts),
                "e2e": _summ("lat_e2e_s"),
                "phases": {name: s for name in (
                    "submit_offer", "offer_stage", "stage_fsync",
                    "fsync_send", "send_commit", "commit_apply",
                    "apply_ack")
                    if (s := _summ(f"lat_{name}_s")) is not None},
            }
        return {
            "metric": f"durable-runtime commits/sec @{n_groups} groups "
                      f"(3 nodes, WAL fsync barrier, applies, {transport})",
            "value": round(commits / elapsed),
            "unit": "commits/sec",
            "vs_baseline": None,
            "burst_per_group": burst_n,
            "rounds": rounds,
            "pipeline": bool(slow.pipeline),
            "host_workers": int(slow._w_eff),
            "native_host": bool(slow._native_host),
            "native_workers": int(slow._w_native) if slow._native_host
                              else 0,
            "wal_shards": getattr(getattr(slow.store, "wal", None),
                                  "n_shards", 1),
            "tick_latency": lat,
            "tick_stages_mean_s": stages,
            "applies_per_sec_windowed": round(applies_ps),
            "latency": latency,
            "heat": ({"enabled": True,
                      "active_set": slow.heatmap_snapshot(8)
                      .get("active_set")}
                     if slow.heat is not None else {"enabled": False}),
        }
    finally:
        c.close()
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else "?"
        del args[i:i + 2]
        if device not in ("cpu", "cuda"):
            raise SystemExit(f"bench_runtime: --device takes cpu or cuda, "
                             f"not {device!r}")
    if device is None:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("bench_runtime: no CUDA device (pass --device "
                             "cpu to run the engine on the CPU)")
    transport = "loopback"
    if "--tcp" in args:
        # Real localhost sockets: framing, sender queues, reader threads
        # and the accumulator under durable load.
        args.remove("--tcp")
        transport = "tcp"
    scales = [int(a) for a in args] or [1024]
    kw = dict(transport=transport, device=device)
    for n in scales:
        out = run(n_groups=n, **kw)
        print(json.dumps(out), flush=True)
        if os.environ.get("BENCH_PIPELINE", "") == "1":
            # Serial vs pipelined at the same scale: only the mode the
            # run above did not use is re-run, forced explicitly.
            other = run(n_groups=n, pipeline=not out["pipeline"], **kw)
            print(json.dumps(other), flush=True)
            piped, serial = ((out, other) if out["pipeline"]
                             else (other, out))
            print(json.dumps({
                "metric": f"durable pipeline speedup @{n} groups "
                          f"({transport})",
                "value": round(piped["value"] / max(serial["value"], 1), 3),
                "unit": "x (pipelined / serial commits/sec)",
                "pipelined_commits_per_sec": piped["value"],
                "serial_commits_per_sec": serial["value"],
                "pipelined_stages_mean_s": piped["tick_stages_mean_s"],
                "serial_stages_mean_s": serial["tick_stages_mean_s"],
            }), flush=True)
        if os.environ.get("BENCH_HOSTPAR", "") == "1":
            # Serial host tier (W=1) against the striped one (W=2, 4).
            base = run(n_groups=n, host_workers=1, **kw)
            print(json.dumps(base), flush=True)
            for w in (2, 4):
                striped = run(n_groups=n, host_workers=w, **kw)
                print(json.dumps(striped), flush=True)
                print(json.dumps({
                    "metric": f"striped host tier speedup @{n} groups "
                              f"(W={striped['host_workers']}, {transport})",
                    "value": round(striped["value"] /
                                   max(base["value"], 1), 3),
                    "unit": "x (striped / serial commits/sec)",
                    "striped_commits_per_sec": striped["value"],
                    "serial_commits_per_sec": base["value"],
                    "striped_stages_mean_s": striped["tick_stages_mean_s"],
                    "serial_stages_mean_s": base["tick_stages_mean_s"],
                }), flush=True)
        if os.environ.get("BENCH_NATIVE", "") == "1":
            # The C++ stage_and_sync tier against the Python staging
            # loop; the comparison is mean wal_s per tick.
            py = run(n_groups=n, native=False, host_workers=1, **kw)
            print(json.dumps(py), flush=True)
            nat = run(n_groups=n, native=True, host_workers=4, **kw)
            print(json.dumps(nat), flush=True)

            def _st(d, k):
                return d["tick_stages_mean_s"].get(k, 0.0)
            print(json.dumps({
                "metric": f"native host tier wal speedup @{n} groups "
                          f"(W={nat['native_workers']}, {transport})",
                "value": round(_st(py, "wal_s") /
                               max(_st(nat, "wal_s"), 1e-9), 3),
                "unit": "x (python wal_s / native wal_s, mean per tick)",
                "native_commits_per_sec": nat["value"],
                "python_commits_per_sec": py["value"],
                "native": {k: _st(nat, k)
                           for k in ("wal_s", "fsync_s", "send_s")},
                "python": {k: _st(py, k)
                           for k in ("wal_s", "fsync_s", "send_s")},
            }), flush=True)


if __name__ == "__main__":
    main()
