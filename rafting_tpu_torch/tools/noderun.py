"""Standalone cluster node + built-in load client: the deployment-shaped
process the reference tests with (cluster/TestNode1.java:16-56 — one JVM per
node, each submitting a command every ~10ms forever, operator kills and
restarts processes, correctness = byte-identical output files).

Run one per node::

    python -m rafting_tpu_torch.tools.noderun node1.xml

The process:
  * loads the XML config (reference-shaped schema, api/config.load_xml_config),
  * creates a full production container (TCP transport, replicated admin
    lifecycle, WAL durability, live tick loop),
  * opens the shared group ``root`` (idempotent across nodes),
  * submits a uniquely-tagged command every ``--period`` seconds through its
    own stub (redirected to the leader automatically), recording every
    ACKNOWLEDGED payload to ``<data_dir>/acked.txt`` — the survivors an
    operator (or the system test) must find exactly once in the final state,
  * reports liveness to ``<data_dir>/status.json`` so an external harness
    can pick the current leader to kill,
  * on SIGTERM: stops the load, keeps ticking ~3s so replicas drain, then
    closes cleanly.  SIGKILL is the crash case — the WAL recovers.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="XML config path")
    ap.add_argument("--group", default="root")
    ap.add_argument("--period", type=float, default=0.01,
                    help="seconds between submissions (reference: 10ms)")
    ap.add_argument("--device", default=None,
                    help="torch device for the engine (default: the CUDA "
                         "device; 'cpu' for the plain version)")
    ap.add_argument("--drain", type=float, default=3.0,
                    help="seconds to keep ticking after SIGTERM")
    args = ap.parse_args()

    from ..api import RaftContainer, load_xml_config

    cfg = load_xml_config(args.config)
    container = RaftContainer(cfg, device=args.device).create()
    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *a: stop.update(flag=True))
    signal.signal(signal.SIGINT, lambda *a: stop.update(flag=True))

    # Open (or join) the shared group; every node may race to open it —
    # the admin group's replicated OCC transaction makes this idempotent.
    lane = None
    deadline = time.time() + 120
    while lane is None and time.time() < deadline and not stop["flag"]:
        try:
            lane = container.open_context(args.group, timeout=30)
        except Exception as e:  # not elected yet / racing another opener
            print(f"open_context retry: {e}", flush=True)
            time.sleep(0.5)
    if lane is None:
        print("FATAL could not open group", flush=True)
        container.destroy()
        return 2
    print(f"READY lane={lane} node={cfg.node_id}", flush=True)

    acked_path = os.path.join(cfg.data_dir, "acked.txt")
    status_path = os.path.join(cfg.data_dir, "status.json")
    acked_f = open(acked_path, "a", buffering=1)
    stub = container.get_stub(args.group)
    n_acked = 0
    k = 0
    # Per-incarnation nonce: a restarted process must never re-submit a
    # payload string its pre-crash incarnation may already have committed
    # (the reference randomizes payloads for the same reason,
    # cluster/TestNode1.java:52).
    nonce = os.urandom(4).hex()
    last_status = 0.0
    while not stop["flag"]:
        payload = f"n{cfg.node_id}-{nonce}-{k}"
        k += 1
        try:
            stub.execute(payload, timeout=5)
            acked_f.write(payload + "\n")
            n_acked += 1
        except Exception:
            time.sleep(0.02)
        now = time.time()
        if now - last_status >= 0.5:
            last_status = now
            tmp = status_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"leader": container.node.is_leader(lane),
                           "acked": n_acked, "pid": os.getpid()}, f)
            os.replace(tmp, status_path)
        time.sleep(args.period)

    # Drain: the tick loop keeps running so in-flight commits replicate and
    # apply everywhere before the files are compared.
    print(f"DRAIN acked={n_acked}", flush=True)
    time.sleep(args.drain)
    acked_f.close()
    container.destroy()
    print("CLOSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
