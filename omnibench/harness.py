"""What every cell shares: finding a cell's configuration, traffic mix,
driver and metric readers by name, the checkout's cache directories, the
device description, the import check and the result line.

A cell names a configuration (``omnibench/configs/<config>.json``) and a
traffic mix (``omnibench/traffic/<traffic>.json``); the mix names the
driver (``omnibench/drivers/<driver>.py``) that runs it, and each
per-layer metric is read by ``omnibench/metrics/<metric>.py``. A new cell,
mix or metric is a new file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "omnibench"
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "omnigs_tpu")
# what the reference may not import, by top-level name
REFERENCE_FORBIDDEN = FORBIDDEN + ("omnigs_torch",)


def set_cache_dirs(environ=os.environ) -> None:
    """Fixed cache directories inside the checkout (the port's nvcc
    libraries already go to ``build/omnigs_torch``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        environ[var] = str(BUILD / sub)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self):
        return importlib.import_module(f"omnibench.drivers.{self.traffic['driver']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str) -> Cell:
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def metric_reader(name: str):
    """The ``read`` function of ``omnibench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"omnibench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def write_yaml(config: dict, path: Path) -> Path:
    """The configuration's YAML keys as the port's OpenCV-style file."""
    lines = ["%YAML:1.0"] + [f"{k}: {v}" for k, v in config["yaml"].items()]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``omnigs_torch`` is not ``omnigs_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def reference_imports(root: Path = HERE / "reference") -> Dict[str, List[str]]:
    """For each reference source, the imports whose top-level name is in
    REFERENCE_FORBIDDEN (read by ``ast``, not by running them)."""
    bad = {}
    for path in sorted(root.glob("*.py")):
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.append(node.module)
        hits = [n for n in names if n.split(".")[0] in REFERENCE_FORBIDDEN]
        if hits:
            bad[path.name] = hits
    return bad


@dataclasses.dataclass
class Check:
    """One number the comparison with the reference reads, and its limit:
    it passes while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back from a run."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None  # what the metric readers read
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def device_info(count: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}


def result_line(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The contract's last line. ``--trace 0``: the cell's end-to-end
    metrics; ``--trace 1``: its per-layer metrics, each from its reader (a
    reader that finds nothing returns None and the metric is left out)."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
    device = device_info(cell.chips, out.memory_peak_bytes)
    if trace:
        device["busy_s"], device["window_s"] = out.busy_s, out.window_s
    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line
