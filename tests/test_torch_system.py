"""The reference's system procedures on the port (CPU), and its data
dirs carried between the two packages.

* Data dirs carry across: a cluster of one package writes (WAL, admin
  checkpoint, machine files) and is destroyed; the other package's
  containers open the same data dirs, see the same Administrator table
  and machine files, and go on committing.  Both directions.
* ``tests/test_system_tcp.py``'s procedure on port containers: load from
  every node, the leader's container crashes and restarts from disk,
  then file parity, every acknowledged command exactly once and the
  offline WAL diff.
* ``python -m rafting_tpu_torch.tools.noderun`` as three processes
  (``--device cpu``) under load, then SIGTERM: every acknowledged payload
  is in the machine file exactly once and the three files are byte-equal.
* ``python -m rafting_tpu_torch.tools.noderate`` prints its JSON line.

No rate or duration is asserted; every wait is a predicate with a
deadline (``test_torch_api.py``'s helpers).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

from rafting_tpu_torch.api import RaftConfig
from rafting_tpu_torch.testkit.harness import free_ports, scaled_election_mul
from rafting_tpu_torch.testkit.lockstep import pinned_env
from rafting_tpu_torch.testkit.logcheck import check_logs
from test_torch_api import (
    PACKAGES, REPO, WAIT_S, _admin_table, _command_lines, _configs,
    _machine_files, _settled, _stable_leader, _wait,
)


# ---------------------------------------------------- data dirs carry across --

def _write_phase(make, cfgs) -> dict:
    cs = [make(cfg) for cfg in cfgs]
    try:
        root = cs[0].open_context("root", timeout=WAIT_S)
        a = cs[0].open_context("a", timeout=WAIT_S)
        _wait(lambda: all(c.node.is_active(root) and c.node.is_active(a)
                          for c in cs), "opens replicated")
        lead = _stable_leader(cs, root)
        for k in range(6):
            lead.get_stub("root").execute(f"w-{k}", timeout=60)
        cs[1].close_context("a", timeout=WAIT_S)
        _wait(lambda: not any(c.node.is_active(a) for c in cs), "a closed")
        files = _settled(cs, [root], 6)
        tables = [_admin_table(c) for c in cs]
        assert all(t == tables[0] for t in tables[1:])
        return {"root": root, "a": a, "files": files, "table": tables[0]}
    finally:
        for c in cs:
            c.destroy()


def _read_phase(make, cfgs, before) -> None:
    root = before["root"]
    cs = [make(cfg) for cfg in cfgs]
    try:
        _wait(lambda: all(c.node.is_active(root) for c in cs),
              "root reopened from the admin checkpoint")
        for c in cs:
            assert _admin_table(c) == before["table"]
            assert not c.node.is_active(before["a"])   # still SLEEPING
            assert c.open_context("root", timeout=WAIT_S) == root
            now = _machine_files(c)
            assert sorted(now) == sorted(before["files"])
            for name, blob in before["files"].items():
                assert now[name].startswith(blob), name
        last = int(before["files"][f"group_{root}.txt"].decode()
                   .splitlines()[-1].split(":", 1)[0])
        stub = _stable_leader(cs, root).get_stub("root")
        res = [stub.execute(f"r-{k}", timeout=60) for k in range(3)]
        assert last < res[0] < res[1] < res[2]
        files = _settled(cs, [root], 9)
        lines = _command_lines(files[f"group_{root}.txt"])
        assert [ln.split(":", 1)[1] for ln in lines] == \
            [f"w-{k}" for k in range(6)] + [f"r-{k}" for k in range(3)]
        # The sleeping group wakes on its old lane.
        assert cs[2].open_context("a", timeout=WAIT_S) == before["a"]
    finally:
        for c in cs:
            c.destroy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_dirs_carry_across(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    ports = free_ports(3)
    with pinned_env():
        wc, wmake = PACKAGES[writer]
        before = _write_phase(wmake, _configs(wc, tmp_path, 9, ports))
        rc, rmake = PACKAGES[reader]
        _read_phase(rmake, _configs(rc, tmp_path, 9, ports), before)


# ----------------------------- test_system_tcp.py's procedure on the port --

def _lines(c, lane):
    f = os.path.join(c.config.data_dir, "machines", f"group_{lane}.txt")
    if not os.path.exists(f):
        return []
    with open(f) as fh:
        return fh.readlines()


def test_three_node_system_kill_restart(tmp_path):
    cfgs = _configs(RaftConfig, tmp_path, seed=11, log_slots=64, batch=8,
                    max_submit=8)
    make = PACKAGES["port"][1]
    cs = {i: make(cfgs[i]) for i in range(3)}
    acked, acked_lock, stop = [], threading.Lock(), threading.Event()

    def loader(idx):
        k = 0
        while not stop.is_set():
            c = cs.get(idx)
            if c is None or c._destroyed:
                time.sleep(0.05)
                continue
            payload = f"n{idx}-{k}"
            k += 1
            try:
                c.get_stub("root").execute(payload, timeout=5)
                with acked_lock:
                    acked.append(payload)
            except Exception:
                time.sleep(0.02)
            time.sleep(0.01)

    try:
        lane = cs[0].open_context("root", timeout=WAIT_S)
        _wait(lambda: all(c.node.is_active(lane) for c in cs.values()),
              "group replicated open")
        threads = [threading.Thread(target=loader, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: len(acked) >= 30, "initial load committed")
            lead = next(i for i, c in cs.items() if c.node.is_leader(lane))
            cs.pop(lead).destroy()
            _wait(lambda: len(acked) >= 60, "progress after the crash")
            cs[lead] = make(cfgs[lead])
            _wait(lambda: cs[lead].node.is_active(lane),
                  "restarted node re-opened the group")
            _wait(lambda: len(acked) >= 90, "progress after the restart")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        n_acked = len(acked)
        _wait(lambda: all(len(_lines(c, lane)) == len(_lines(cs[0], lane))
                          and len(_lines(c, lane)) >= n_acked
                          for c in cs.values()), "replicas converged")
    finally:
        for c in cs.values():
            c.destroy()

    def strip_trailing_noops(lines):
        out = list(lines)
        while out and not out[-1].split(":", 1)[1].strip():
            out.pop()
        return out

    files = [strip_trailing_noops(_lines(c, lane)) for c in cs.values()]
    assert files[0] == files[1] == files[2]
    body = [ln.split(":", 1)[1].strip() for ln in files[0]]
    for payload in acked:
        assert body.count(payload) == 1, f"acked {payload} count != 1"
    divs = check_logs([str(tmp_path / f"node{i}" / "wal") for i in range(3)])
    assert divs == [], f"log divergence: {divs[:5]}"


# ------------------------------------------------------------- noderun --

NODE_XML = """<raft>
  <cluster>
    <local>{local}</local>
    <remote>{r0}</remote>
    <remote>{r1}</remote>
  </cluster>
  <timing tick="{tick}" election="{election}"/>
  <engine groups="4" log-slots="64" batch="8" max-submit="8"/>
  <storage dir="{dir}"/>
</raft>
"""


def write_node_xmls(root: str, tick_ms: int, election: float) -> list:
    """Three noderun XML configs on free localhost ports."""
    uris = [f"raft://127.0.0.1:{p}" for p in free_ports(3)]
    paths = []
    for i in range(3):
        others = [u for j, u in enumerate(uris) if j != i]
        p = os.path.join(root, f"node{i}.xml")
        with open(p, "w") as f:
            f.write(NODE_XML.format(local=uris[i], r0=others[0],
                                    r1=others[1], tick=tick_ms,
                                    election=election,
                                    dir=os.path.join(root, f"node{i}")))
        paths.append(p)
    return paths


class _Proc:
    """One noderun process; its stdout lines collected by a thread."""

    def __init__(self, xml: str, args=()):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.p = subprocess.Popen(
            [sys.executable, "-m", "rafting_tpu_torch.tools.noderun", xml,
             *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for ln in self.p.stdout:
            self.lines.append(ln.rstrip("\n"))

    def said(self, word: str) -> bool:
        return any(ln.startswith(word) for ln in self.lines)


def test_noderun_processes_on_cpu(tmp_path):
    xmls = write_node_xmls(str(tmp_path), 50, scaled_election_mul(50, 6.0))
    procs = [_Proc(x, ("--device", "cpu")) for x in xmls]
    try:
        _wait(lambda: all(p.said("READY") for p in procs), "READY",
              timeout=240)
        acked = lambda: sum(
            len(open(tmp_path / f"node{i}" / "acked.txt").readlines())
            for i in range(3) if (tmp_path / f"node{i}" / "acked.txt")
            .exists())
        time.sleep(5)
        _wait(lambda: acked() >= 10, "acknowledged load")
        for p in procs:
            p.p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.p.wait(timeout=WAIT_S) == 0, "\n".join(p.lines[-30:])
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.p.kill()
                p.p.wait()
    lanes = {re.search(r"lane=(\d+)", ln).group(1)
             for p in procs for ln in p.lines if ln.startswith("READY")}
    assert lanes == {"1"}
    files = []
    for i in range(3):     # byte-equal up to trailing election no-ops
        lines = (tmp_path / f"node{i}" / "machines" / "group_1.txt") \
            .read_bytes().splitlines(keepends=True)
        while lines and lines[-1].rstrip(b"\n").endswith(b":"):
            lines.pop()
        files.append(b"".join(lines))
    assert files[0] == files[1] == files[2]
    body = [ln.split(":", 1)[1] for ln in files[0].decode().splitlines()]
    n = 0
    for i in range(3):
        for payload in (tmp_path / f"node{i}" / "acked.txt") \
                .read_text().split():
            assert body.count(payload) == 1, payload
            n += 1
    assert n >= 10


def test_noderate_reports_three_nodes():
    """``tools/noderate.py`` drives three noderun processes and prints
    one JSON line with a rate and a ticks-per-execute count per node."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "rafting_tpu_torch.tools.noderate",
         "--seconds", "1", "--", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    assert doc["module"] == "rafting_tpu_torch.tools.noderun"
    assert doc["args"] == ["--device", "cpu"]
    assert len(doc["acked_per_s"]) == len(doc["ticks_per_execute"]) == 3
    assert min(doc["acked_per_s"]) >= 0 and min(doc["ticks_per_execute"]) > 0
