"""The hot-path lint of ``tests/test_hotpath_lint.py`` on both packages.

The same four checks, each parametrised over the JAX package's
``RaftNode`` (and ``RaftStub``) and the port's: no dense per-group loop in
the eleven hot methods, the send plane packs per-kind sections, the
client-history gate is one ``is None`` test, and the columnar structures
that replaced the loops are still the mechanism."""

import importlib
import inspect

import pytest

PACKAGES = ("rafting_tpu", "rafting_tpu_torch")

# Methods on the per-tick hot path (persist / send / apply / read) plus
# boot recovery.  Banned substrings mean "visits every group".
HOT_METHODS = (
    "_persist_prepare", "_persist_stage", "_sweep_rejections",
    "_stash_outbox_sections", "_eager_send", "_flush_sends",
    "_harvest_reads", "_serve_reads",
    "_host_phase_serial", "_host_phase_striped",
    "_recover_machines",
)
BANNED = (
    "for g in range(",                # dense group walk
    "range(self.cfg.n_groups)",       # dense group walk, spelled long
    "np.arange(G).tolist()",          # dense walk via arange
    "for g in list(self._reads_released",   # the pre-gate released walk
)


def _node(pkg):
    return importlib.import_module(f"{pkg}.runtime.node")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_hot_methods_have_no_dense_group_loops(pkg):
    node = _node(pkg).RaftNode
    for name in HOT_METHODS:
        src = inspect.getsource(getattr(node, name))
        for pat in BANNED:
            assert pat not in src, (
                f"{pkg} RaftNode.{name} reintroduced a dense per-group "
                f"loop ({pat!r}): visit np.nonzero(...) sparse subsets")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_send_plane_uses_section_packing(pkg):
    mod = _node(pkg)
    assert "pack_slice(" not in inspect.getsource(mod), (
        f"{pkg}/runtime/node.py calls pack_slice — pack per-kind sections "
        f"with pack_kind_section and frame them with assemble_slice")
    for name in ("_stash_outbox_sections", "_eager_send"):
        assert "pack_kind_section" in \
            inspect.getsource(getattr(mod.RaftNode, name)), name


@pytest.mark.parametrize("pkg", PACKAGES)
def test_stub_history_gate_is_single_is_none_test(pkg):
    stub = importlib.import_module(f"{pkg}.api.stub").RaftStub
    for name in ("execute", "execute_read"):
        src = inspect.getsource(getattr(stub, name))
        gates = src.count("self._history is not None")
        assert gates == 1, (
            f"{pkg} RaftStub.{name} must gate history recording behind "
            f"exactly one 'self._history is not None' test (found {gates})")
        assert "getattr" not in src and "try:" not in src, (
            f"{pkg} RaftStub.{name} grew logic on the history-disabled path")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_columnar_gates_present(pkg):
    node = _node(pkg).RaftNode
    assert "groups_with_snapshots" in \
        inspect.getsource(node._recover_machines)
    assert "_rel_min" in inspect.getsource(node._serve_reads)
    assert "_rel_min" in inspect.getsource(node._harvest_reads)
