"""The repo's post-mortem report tools on the port's output.

``tools/dump_timeline.py``, ``latency_report.py``, ``hop_report.py`` and
``health_report.py`` read a dump saved through the port's
``utils/tracelog.save_dump``: a 3-node ``LocalCluster`` of the port on
the CPU runs a few rounds with the flight recorder, the heat lanes, hop
tracing and every entry's latency sampled, and its leader's rings are
saved with its latency and health snapshots.  Each tool runs on the dump
as a subprocess, plain and with ``--json``, exits 0 and prints something.
The tools are the reference's own, unchanged.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rafting_tpu_torch import EngineConfig, LocalCluster
from rafting_tpu_torch.utils.tracelog import save_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("dump_timeline", "latency_report", "hop_report", "health_report")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast,
    and several only spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("report-tools")
    cfg = EngineConfig(n_groups=4, n_peers=3, log_slots=32, batch=4,
                       max_submit=4, trace_depth=16, heat=True)
    pins = {"RAFT_LAT_SAMPLE": "1", "RAFT_HOP_TRACE": "1"}
    old = {k: os.environ.get(k) for k in pins}
    os.environ.update(pins)
    try:
        c = LocalCluster(cfg, str(root / "cluster"), device="cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        for g in range(cfg.n_groups):
            c.wait_leader(g)
        for i in range(6):
            for g in range(cfg.n_groups):
                c.submit_via_leader(g, b"report-%d" % i)
        c.tick(8)
        node = c.nodes[c.leader_of(0)]
        latency = node.latency_snapshot()
        health = node.health_snapshot()
        assert latency["sampling"]["rate"] == 1
        assert latency["sampling"]["counts"]["ok"] > 0
        assert node.metrics["hop_finalized"] > 0, latency["hops"]
        assert int(node.state.trace.n.sum()) > 0
        assert node.heatmap_snapshot()["active_set"] > 0
        path = str(root / "dump.json.gz")
        save_dump(path, node.state.trace,
                  meta={"latency": latency, "health": health})
    finally:
        c.close()
    return path


@pytest.mark.parametrize("as_json", [False, True], ids=["plain", "json"])
@pytest.mark.parametrize("tool", TOOLS)
def test_report_tool_reads_a_port_dump(dump, tool, as_json):
    r = subprocess.run(
        [sys.executable, os.path.join("tools", f"{tool}.py"), dump,
         *(["--json"] if as_json else [])],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip(), r.stderr[-2000:]
    if as_json:
        json.loads(r.stdout)
