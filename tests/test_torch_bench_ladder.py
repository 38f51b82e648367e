"""The port's benchmark ladder end to end on the CPU.

``python -m rafting_tpu_torch.tools.bench SCALE --device cpu`` runs the
repo's ``bench.py`` CPU shape (one scale, 96 measured and 48 warm-up
ticks, the tuned budget) and then the reads, nemesis and flight-recorder
stages, each in its own subprocess, and saves one artifact a scale.
Every line is labelled ``cpu``, and ``tools/bench_diff.py`` reads two
runs' lines.
"""

import importlib.util
import json
import os

from rafting_tpu_torch.tools import _artifact
from rafting_tpu_torch.tools import bench as twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ladder(tmp_path, monkeypatch, capsys, tag):
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path / tag))
    twin.main(["32", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    path = tmp_path / f"{tag}.jsonl"
    path.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return lines, str(path)


def test_cpu_ladder_and_bench_diff(tmp_path, monkeypatch, capsys):
    """``--device cpu`` runs bench.py's CPU shape (one scale, the tuned
    budget) and the reads, nemesis and recorder stages, every line
    labelled cpu; two such runs diff metric by metric."""
    runs = [_ladder(tmp_path, monkeypatch, capsys, tag)
            for tag in ("old", "new")]
    for lines, _ in runs:
        units = [ln["unit"] for ln in lines]
        assert units == ["commits/sec", "reads/sec", "commits/sec",
                         "commits/sec"], lines
        assert all(ln["device"] == "cpu" and ln["value"] > 0
                   for ln in lines)
        assert "tuned budget" in lines[0]["metric"]
        assert "on device" not in lines[0]["metric"]
        assert "NEMESIS" in lines[2]["metric"]
        assert lines[3]["metric"].startswith("flight-recorder overhead")
    arts = sorted(os.listdir(tmp_path / "new"))
    assert len(arts) == 4 and all(a.startswith("bench_cpu_32_")
                                  for a in arts), arts
    with open(tmp_path / "new" / arts[0]) as f:
        doc = json.load(f)
    assert doc["env"]["BENCH_MAX_SUBMIT"] == "32"
    assert doc["result"]["platform"] == "cpu"

    spec = importlib.util.spec_from_file_location(
        "bench_diff", os.path.join(REPO, "tools", "bench_diff.py"))
    bench_diff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_diff)
    old, new = (bench_diff.load_round(p) for _, p in runs)
    res = bench_diff.diff(old, new, threshold=1.0)
    # The reads and recorder metrics name the measured write rate (as
    # bench.py's do), so only the commits/s and nemesis lines pair up.
    assert res["compared"] == 2 and not res["flags"], res
    assert len(res["info"]) == 6, res
    assert bench_diff.main([runs[0][1], runs[1][1], "--threshold",
                            "1.0"]) == 0
