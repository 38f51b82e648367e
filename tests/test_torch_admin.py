"""The reference's pure API-layer cases, and its admin lane scenarios, on
the port (CPU).

* Pure cases: test functions of ``tests/test_admin.py`` (the MVCC KV
  engine, STM and the Administrator's apply, checkpoint and recovery),
  ``tests/test_api.py`` (config validation, XML loading),
  ``tests/test_log_spi.py`` (SPI conformance, MemoryLogStore),
  ``tests/test_read_runtime.py`` (the stub's redirect cap against a
  ping-ponging leader hint, Prometheus exposition) and
  ``tests/test_linz.py`` (the history model and the linearizability
  checker), each compiled from the reference test file's own source with
  its ``rafting_tpu.`` imports pointed at ``rafting_tpu_torch.``.  Only
  cases that touch no device and read no clock are taken this way.
* The lane scenarios of ``tests/test_admin.py`` on a port
  ``LocalCluster`` (``device="cpu"``): a new incarnation purges a stale
  lane, a destroyed lane comes back empty for the next group.
"""

import inspect
import os
import re

import pytest

from rafting_tpu_torch import EngineConfig, LocalCluster

HERE = os.path.dirname(os.path.abspath(__file__))

PURE = {
    "test_admin.py": [
        "test_kv_optimistic_commit_and_conflict",
        "test_kv_delete_and_dump_load",
        "test_administrator_apply_and_lifecycle_effects",
        "test_administrator_checkpoint_recover_reopens_groups",
        "test_recover_reconciles_closures_and_reuse",
    ],
    "test_api.py": ["test_config_validation", "test_xml_config_roundtrip"],
    "test_log_spi.py": ["test_protocol_conformance",
                        "test_memstore_roundtrip_and_export"],
    "test_read_runtime.py": ["test_stub_redirect_cap_ping_pong",
                             "test_render_prometheus_format"],
    "test_linz.py": [
        "test_sequential_register_reads", "test_stale_read_is_flagged",
        "test_concurrent_write_read_may_see_either",
        "test_info_write_may_happen_or_not",
        "test_failed_write_must_not_appear",
        "test_info_write_before_invoke_is_illegal",
        "test_duplicate_append_legal_iff_first_attempt_was_info",
        "test_append_order_must_match_observed_list",
        "test_counterexample_is_minimal_prefix",
        "test_per_key_compositionality", "test_vacuous_histories_pass",
        "test_recorder_classification_rule",
        "test_recorder_parses_kv_vocabulary_and_fallback",
        "test_recorded_result_is_snapshotted",
        "test_history_unpaired_invoke_is_info_forever",
    ],
}


def _on_port(fname: str) -> dict:
    """The module namespace of ``tests/<fname>`` compiled with every
    ``rafting_tpu.`` name replaced by ``rafting_tpu_torch.``."""
    with open(os.path.join(HERE, fname)) as f:
        src = re.sub(r"\brafting_tpu\.", "rafting_tpu_torch.", f.read())
    assert not re.search(r"\brafting_tpu\b(?!_)", src), fname
    ns = {"__name__": f"port_{fname[:-3]}",
          "__file__": os.path.join(HERE, fname)}
    exec(compile(src, f"{fname} on the port", "exec"), ns)
    mods = {name: getattr(v, "__module__", None) or getattr(v, "__name__", "")
            for name, v in ns.items()}
    for name, mod in mods.items():
        assert not (mod == "rafting_tpu" or mod.startswith("rafting_tpu.")), \
            f"{fname}: {name} comes from the JAX package"
    assert any(str(m).startswith("rafting_tpu_torch.") for m in mods.values())
    return ns


CASES = []
for _f, _names in sorted(PURE.items()):
    for _n in _names:
        CASES.append(f"{_f}::{_n}")
_NS: dict = {}


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_port(case, tmp_path):
    fname, name = case.split("::")
    if fname not in _NS:
        _NS[fname] = _on_port(fname)
    fn = _NS[fname][name]
    params = inspect.signature(fn).parameters
    if "op" in params:             # the reference's parametrised cases
        for op in ("submit", "read"):
            fn(op=op)
        return
    fn(**({"tmp_path": tmp_path} if "tmp_path" in params else {}))


# --------------------------------------------------- admin lane scenarios --

CFG = EngineConfig(n_groups=3, n_peers=3, log_slots=16, batch=4,
                   max_submit=4)


def _activate_lane_purges_stale_incarnation(c):
    node = c.nodes[0]
    node.activate_lane(1, 1)
    c.wait_leader(1)
    c.submit_via_leader(1, b"tenant-one")
    c.tick(5)
    assert node.store.tail(1) > 0
    node.activate_lane(1, 1)           # same incarnation: state survives
    c.tick(2)
    assert node.store.tail(1) > 0
    node.activate_lane(1, 2)           # new incarnation: purge first
    c.tick(2)
    assert node.store.tail(1) == 0
    assert node.is_active(1)


def _destroy_purges_lane_for_reuse(c):
    c.wait_leader(1)
    for k in range(3):
        c.submit_via_leader(1, f"old-{k}".encode())
    c.tick(5)
    assert c.command_payloads(c.leader_of(1), 1) == \
        ["old-0", "old-1", "old-2"]
    for node in c.nodes.values():
        node.set_active(1, False, purge=True)
    c.tick(3)
    for i, node in c.nodes.items():
        assert node.store.tail(1) == 0
        assert node.store.stable(1) is None
        assert int(node.state.log.last[1]) == 0
        assert int(node.state.term[1]) == 0
        assert c.machine_lines(i, 1) == []
    for node in c.nodes.values():
        node.set_active(1, True)
    c.wait_leader(1)
    res = c.submit_via_leader(1, b"new-0")
    c.tick(5)
    lead = c.leader_of(1)
    assert c.command_payloads(lead, 1) == ["new-0"]
    assert res == len(c.machine_lines(lead, 1))


LANE_SCENARIOS = {
    "activate_lane_purges_stale_incarnation":
        _activate_lane_purges_stale_incarnation,
    "destroy_purges_lane_for_reuse": _destroy_purges_lane_for_reuse,
}


@pytest.mark.parametrize("name", sorted(LANE_SCENARIOS))
def test_admin_lane_scenario(tmp_path, name):
    c = LocalCluster(CFG, str(tmp_path), device="cpu")
    try:
        LANE_SCENARIOS[name](c)
    finally:
        c.close()
