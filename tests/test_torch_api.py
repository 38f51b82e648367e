"""The port's public API on the CPU, against the JAX package's.

* Container parity: three JAX ``RaftContainer``s, then three of the port,
  over localhost TCP with live tick loops and the ``@raft`` admin group,
  run one sequential single-client script (opens, executes through the
  leader's and a follower's stub, close and reopen, destroy, a container
  destroyed and re-created from its data dir).  The lanes, every
  Administrator's table and the commands of every machine file, in order,
  are equal, and each run's ``execute`` results are strictly increasing
  and name its own file's lines.  The results and the files are equal
  byte for byte when neither run changed leader while the script ran:
  apply indices count election no-ops, so a leader that a loaded host
  deschedules past its election timeout shifts them in one run only.
* The TCP scenarios of ``tests/test_api.py`` and ``tests/test_admin.py``
  on the port (``tests/test_torch_system.py`` holds the data-dir
  interchange, the system procedure and ``noderun``).

Every port container runs with ``device="cpu"``.  Nothing here asserts a
rate or a duration: every wait is a predicate with a deadline of a minute
or more, and elections get a wall-clock floor of several hundred ms.
"""

import os
import re
import time

import pytest

from rafting_tpu.api import RaftConfig as JaxRaftConfig
from rafting_tpu.api import RaftContainer as JaxRaftContainer
from rafting_tpu_torch.api import (
    ADMIN_GROUP, ObsoleteContextError, RaftConfig, RaftContainer, RaftError,
)
from rafting_tpu_torch.testkit.harness import free_ports, scaled_election_mul
from rafting_tpu_torch.testkit.lockstep import pinned_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICK_MS = 10
# Elections every few hundred ms of wall clock at the least: the parity
# script compares apply indices, which count election no-ops, so a
# leader descheduled for a few ticks must not lose its term.
ELECTION_MUL = scaled_election_mul(TICK_MS, base=30.0)
WAIT_S = 120.0

PACKAGES = {
    "jax": (JaxRaftConfig, lambda cfg: JaxRaftContainer(cfg).create()),
    "port": (RaftConfig,
             lambda cfg: RaftContainer(cfg, device="cpu").create()),
}


def _configs(Config, root, seed, ports=None, **kw):
    ports = ports or free_ports(3)
    uris = [f"raft://127.0.0.1:{p}" for p in ports]
    base = dict(n_groups=4, log_slots=32, batch=4, max_submit=4,
                tick_ms=TICK_MS, election_mul=ELECTION_MUL, seed=seed)
    base.update(kw)
    return [Config(local=uris[i],
                   peers=tuple(u for j, u in enumerate(uris) if j != i),
                   data_dir=os.path.join(str(root), f"node{i}"), **base)
            for i in range(3)]


def _wait(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what} not reached in {timeout}s")


def _stable_leader(cs, lane, hold=0.3):
    """The container leading ``lane`` that kept it for ``hold`` s."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        lead = next((c for c in cs if c.node.is_leader(lane)), None)
        if lead is not None:
            time.sleep(hold)
            if lead.node.is_leader(lane):
                return lead
        time.sleep(0.02)
    raise AssertionError(f"no stable leader of lane {lane}")


def _machine_files(c) -> dict:
    d = os.path.join(c.config.data_dir, "machines")
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        if re.fullmatch(r"group_\d+\.txt", name):
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def _admin_table(c) -> dict:
    """name -> (status, lane, gen) of this container's Administrator."""
    data = c._admin_provider.admin.engine.data
    return {k[4:]: (v["status"], v.get("lane"), v.get("gen", 0))
            for k, (v, _) in sorted(data.items()) if k.startswith("ctx:")}


def _command_lines(blob: bytes) -> list:
    return [ln for ln in blob.decode().splitlines()
            if ln.split(":", 1)[1]]


def _noop_count(blob: bytes) -> int:
    return sum(1 for ln in blob.decode().splitlines()
               if not ln.split(":", 1)[1])


def _term(cs, lane) -> int:
    """The highest term any container's node holds for ``lane``."""
    return max(int(c.node.h_term[lane]) for c in cs)


def _settled(cs, lanes, n_root_cmds):
    """Every container's machine files equal, the root group's holding
    ``n_root_cmds`` commands; returns them."""
    root = f"group_{lanes[0]}.txt"
    box = {}

    def same():
        files = [_machine_files(c) for c in cs]
        if any(f != files[0] for f in files[1:]):
            return False
        if len(_command_lines(files[0].get(root, b""))) != n_root_cmds:
            return False
        box["files"] = files[0]
        return True

    _wait(same, "replicas applied every command")
    return box["files"]


# -------------------------------------------------------- container parity --

def _container_script(make, cfgs) -> dict:
    """One client, one thread: open three groups through @raft, execute
    through the leader's and a follower's stub, close and reopen ``a``,
    destroy ``b``, destroy and re-create a container that leads neither
    ``root`` nor ``a``, execute again."""
    out = {"lanes": [], "results": [], "terms": {}}
    cs = [make(cfg) for cfg in cfgs]
    try:
        for name in ("root", "a", "b"):
            out["lanes"].append(cs[0].open_context(name, timeout=WAIT_S))
        root, a, b = out["lanes"]
        _wait(lambda: all(c.node.is_active(lane) for c in cs
                          for lane in (root, a, b)), "opens replicated")

        def execute(tag, n):
            lead = _stable_leader(cs, root)
            out["terms"].setdefault("root", [_term(cs, root)])
            for k in range(n):
                if not lead.node.is_leader(root):
                    lead = _stable_leader(cs, root)
                fol = next(c for c in cs if c is not lead)
                via = lead if k % 2 == 0 else fol
                out["results"].append(via.get_stub("root").execute(
                    f"{tag}-{k}", timeout=60))

        execute("x", 20)
        cs[1].close_context("a", timeout=WAIT_S)
        _wait(lambda: not any(c.node.is_active(a) for c in cs), "a closed")
        out["lanes"].append(cs[2].open_context("a", timeout=WAIT_S))
        cs[0].close_context("b", destroy_group=True, timeout=WAIT_S)
        _wait(lambda: not any(c.node.is_active(b) for c in cs),
              "b destroyed")
        _wait(lambda: all(c.node.is_active(a) for c in cs), "a reopened")
        leads = {id(_stable_leader(cs, root)), id(_stable_leader(cs, a))}
        out["terms"]["a"] = [_term(cs, a)]
        victim = next(i for i, c in enumerate(cs) if id(c) not in leads)
        cs[victim].destroy()
        cs[victim] = make(cfgs[victim])
        _wait(lambda: cs[victim].node.is_active(root)
              and cs[victim].node.is_active(a), "re-created container")
        execute("y", 10)
        out["files"] = _settled(cs, out["lanes"], 30)
        for name, lane in (("root", root), ("a", a)):
            out["terms"][name].append(_term(cs, lane))
        tables = [_admin_table(c) for c in cs]
        assert all(t == tables[0] for t in tables[1:]), tables
        out["table"] = tables[0]
        return out
    finally:
        for c in cs:
            c.destroy()


def test_container_parity_with_jax(tmp_path):
    with pinned_env():
        got = {pkg: _container_script(make, _configs(Config,
                                                     tmp_path / pkg, seed=5))
               for pkg, (Config, make) in PACKAGES.items()}
    want, port = got["jax"], got["port"]
    assert port["lanes"] == want["lanes"] == [1, 2, 3, 2]
    assert port["table"] == want["table"]
    assert want["table"]["b"][0] == "DESTROYED"
    assert sorted(port["files"]) == sorted(want["files"]) == \
        ["group_1.txt", "group_2.txt"]
    script = [f"x-{k}" for k in range(20)] + [f"y-{k}" for k in range(10)]
    for run in (want, port):
        res = run["results"]
        assert all(a < b for a, b in zip(res, res[1:])), res
        cmds = [ln.split(":", 1)
                for ln in _command_lines(run["files"]["group_1.txt"])]
        assert [p for _, p in cmds] == script
        assert [int(i) for i, _ in cmds] == res
        assert _command_lines(run["files"]["group_2.txt"]) == []
    # Byte equality where no leader changed while the script ran in
    # either run (the same terms throughout, and the same no-ops, all of
    # them before the first command).
    calm = all(t[0] == t[-1] for run in (want, port)
               for t in run["terms"].values())
    noops = {pkg: {n: _noop_count(b) for n, b in run["files"].items()}
             for pkg, run in got.items()}
    if calm and noops["jax"] == noops["port"]:
        assert port["results"] == want["results"]
        for name in want["files"]:
            assert port["files"][name] == want["files"][name], name


# --------------------------------------- the scenarios of test_api.py --

@pytest.fixture
def tcp_cluster(tmp_path):
    """Three port containers over TCP with live loops (test_api.py's and
    test_admin.py's topology on the port)."""
    cs = [RaftContainer(cfg, device="cpu").create()
          for cfg in _configs(RaftConfig, tmp_path, seed=7)]
    yield cs
    for c in cs:
        c.destroy()


def _end_to_end(cs):
    for c in cs:
        assert c.open_context("root", timeout=WAIT_S) == 1   # 0 is @raft
    lead = _stable_leader(cs, 1)
    stub = lead.get_stub("root")
    fut = stub.submit("first-command")
    r1 = fut.result(timeout=WAIT_S)
    assert isinstance(r1, int) and r1 >= 1
    fol = next(c for c in cs if not c.node.is_leader(1))
    r2 = fol.get_stub("root").execute("via-follower", timeout=60)
    r3 = stub.execute("third", timeout=60)
    assert r1 < r2 < r3
    for c in cs:
        f = os.path.join(c.config.data_dir, "machines", "group_1.txt")
        _wait(lambda: os.path.exists(f) and len(_command_lines(
            open(f, "rb").read())) == 3, "replica apply")
    stub.close()


def _context_lifecycle(cs):
    c0 = cs[0]
    with pytest.raises(ObsoleteContextError):
        c0.get_stub("ghost")
    lane = c0.open_context("tmp", timeout=WAIT_S)
    _wait(lambda: any(c.node.is_leader(lane) for c in cs), "leader")
    stub = c0.get_stub("tmp")
    c0.close_context("tmp", timeout=WAIT_S)
    _wait(lambda: not any(c.node.is_active(lane) for c in cs), "close")
    with pytest.raises(ObsoleteContextError):
        raise stub.submit(b"x").exception(timeout=60)
    with pytest.raises(RaftError):
        c0.close_context(ADMIN_GROUP)
    assert c0.open_context("tmp", timeout=WAIT_S) == lane


def _replicated_group_lifecycle(cs):
    """test_admin.py's TCP lifecycle: one node opens, every node
    activates the lane; a second node's reopen is idempotent; a third
    closes it everywhere."""
    lane = cs[0].open_context("root", timeout=WAIT_S)
    assert lane == 1
    _wait(lambda: all(c.node.is_active(lane) for c in cs), "open replicated")
    assert cs[1].open_context("root", timeout=WAIT_S) == lane
    res = _stable_leader(cs, lane).get_stub("root").execute("cmd-1",
                                                            timeout=60)
    assert isinstance(res, int) and res >= 1
    cs[2].close_context("root", timeout=WAIT_S)
    _wait(lambda: not any(c.node.is_active(lane) for c in cs), "close")


TCP_SCENARIOS = {"container_end_to_end_tcp": _end_to_end,
                 "context_lifecycle": _context_lifecycle,
                 "replicated_group_lifecycle_tcp": _replicated_group_lifecycle}


@pytest.mark.parametrize("name", sorted(TCP_SCENARIOS))
def test_api_scenario(tcp_cluster, name):
    TCP_SCENARIOS[name](tcp_cluster)


