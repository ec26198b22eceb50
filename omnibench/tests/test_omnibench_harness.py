"""The loader, the import checks, the result line and BENCHMARK.json's
contract, on the CPU."""

import json
import re
import textwrap

import pytest

from omnibench import harness
from omnibench.harness import Check, Outcome

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.find_cell(workload)
    assert cell.config["name"] == next(w for w in BENCH["workloads"] if w["name"] == workload)["config"]
    assert hasattr(cell.driver, "run")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "a cell reports at least one per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], "moves a metric its cells report")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_no_trace(metric):
    read = harness.metric_reader(metric)
    assert read(None) is None
    assert read({"kind": "nothing"}) is None


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["omnibench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("omnibench/")
        assert all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_import_check_compares_whole_top_level_names():
    mods = {"omnigs_torch": 1, "omnigs_torch.ops.binning": 1, "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"omnigs_tpu.ops": 1, "jax.numpy": 1})
    assert harness.forbidden_modules(mods) == ["jax.numpy", "omnigs_tpu.ops"]


def test_reference_imports_nothing_of_the_program_or_jax(tmp_path):
    assert harness.reference_imports() == {}
    (tmp_path / "planted.py").write_text(textwrap.dedent("""
        import torch
        import omnigs_tpu.ops.binning
        from omnigs_torch import cameras
        from jax import numpy
    """))
    (tmp_path / "fine.py").write_text("import omnigs_torchvision\nfrom . import render\n")
    assert harness.reference_imports(tmp_path) == {
        "planted.py": ["omnigs_tpu.ops.binning", "omnigs_torch", "jax"]}


def test_result_line_without_a_card(monkeypatch):
    cell = harness.find_cell("roam360-render")
    monkeypatch.setattr(harness, "device_info", lambda count, peak: {
        "platform": "gpu", "kind": "test", "count": count, "memory_peak_bytes": peak})
    out = Outcome(attempted=10, failed=0,
                  end_to_end=dict(setup_s=1.5, render_p95_ms=20.0, render_frames_per_s=50.0),
                  checks=[Check("max_abs", 1e-6, 1e-3), Check("truncated", 1.0, 0.0)],
                  memory_peak_bytes=123, busy_s=0.5, window_s=1.0,
                  trace={"kind": "render", "events": [], "slice_s": 1.0, "slice_requests": 1,
                         "span_ms": {}, "counts": {}},
                  breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []})
    line = harness.result_line(cell, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False  # truncated 1 > 0
    assert set(line["metrics"]) == {"setup_s", "render_p95_ms", "render_frames_per_s"}
    assert line["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert line["checks"]["truncated"] == {"value": 1.0, "limit": 0.0}
    traced = harness.result_line(cell, out, trace=True)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 0.5 and traced["device"]["window_s"] == 1.0
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    json.dumps(traced)


def test_check_fails_on_nan_and_above_the_limit():
    assert Check("a", 0.0, 0.0).ok and not Check("a", 1e-9, 0.0).ok
    assert not Check("a", float("nan"), 1.0).ok


def test_cache_dirs_lie_inside_the_checkout():
    env = {}
    harness.set_cache_dirs(env)
    assert set(env) == {"TRITON_CACHE_DIR", "CUDA_CACHE_PATH", "TORCH_EXTENSIONS_DIR"}
    assert all(v.startswith(str(harness.ROOT / "build")) for v in env.values())
