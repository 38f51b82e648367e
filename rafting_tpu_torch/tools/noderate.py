"""Acked commands/s of three noderun processes on this host.

    python -m rafting_tpu_torch.tools.noderate [--module M] [--seconds S]
        [-- noderun arguments...]

Writes three XML configs (three free localhost ports, every other field
the schema's default: 16 groups, tick 100 ms), starts ``python -m M
nodeK.xml <noderun arguments>`` for each (``M`` defaults to the port's
noderun), waits for all three to print ``READY``, counts the lines each
adds to its ``acked.txt`` over ``S`` seconds of load, then stops them with
SIGTERM.  Prints one JSON line: acked commands/s per node and the ticks
one execute took, counted as the window's ticks at the configured period
over the node's acked commands (a loop whose tick outlasts the period
ticks less often, and the count is then an upper bound).

Any module with noderun's command line and output runs here, so
``--module rafting_tpu.tools.noderun -- --platform cpu`` measures the
JAX package's noderun the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from ..testkit.harness import free_ports

XML = """<raft>
  <cluster>
    <local>{local}</local>
    <remote>{r0}</remote>
    <remote>{r1}</remote>
  </cluster>
  <storage dir="{dir}"/>
</raft>
"""
TICK_S = 0.1     # the schema's default tick (api/config.py)


def _acked(d: str) -> int:
    try:
        with open(os.path.join(d, "acked.txt")) as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--module", default="rafting_tpu_torch.tools.noderun")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments for each noderun, after --")
    a = ap.parse_args()
    extra = a.args[1:] if a.args[:1] == ["--"] else a.args
    root = tempfile.mkdtemp(prefix="noderate-")
    uris = [f"raft://127.0.0.1:{p}" for p in free_ports(3)]
    dirs, procs, logs = [], [], []
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    try:
        for i in range(3):
            others = [u for j, u in enumerate(uris) if j != i]
            dirs.append(os.path.join(root, f"node{i}"))
            xml = os.path.join(root, f"node{i}.xml")
            with open(xml, "w") as f:
                f.write(XML.format(local=uris[i], r0=others[0],
                                   r1=others[1], dir=dirs[-1]))
            logs.append(open(os.path.join(root, f"node{i}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", a.module, xml] + extra, cwd=here,
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 300
        while not all(_ready(root, i) for i in range(3)):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                print(json.dumps({"error": "nodes not READY"}))
                return 1
            time.sleep(0.2)
        a0 = [_acked(d) for d in dirs]
        time.sleep(a.seconds)
        a1 = [_acked(d) for d in dirs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(root, ignore_errors=True)
    rates = [(y - x) / a.seconds for x, y in zip(a0, a1)]
    ticks = a.seconds / TICK_S
    print(json.dumps({
        "module": a.module, "args": extra, "seconds": a.seconds,
        "acked_per_s": rates,
        "ticks_per_execute": [ticks / max(y - x, 1)
                              for x, y in zip(a0, a1)]}))
    return 0


def _ready(root: str, i: int) -> bool:
    try:
        with open(os.path.join(root, f"node{i}.log")) as f:
            return any(ln.startswith("READY") for ln in f)
    except OSError:
        return False


if __name__ == "__main__":
    sys.exit(main())
