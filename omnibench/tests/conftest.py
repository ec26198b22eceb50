"""CPU tests of the benchmark. Tests marked ``gpu`` need a CUDA card and
decide inside the ``card`` fixture whether one is present; run them on the
card with ``python3 -m pytest omnibench/tests -m gpu``."""

import copy
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def shrink(cell, width=64, height=32, live=256, keyframes=4):
    """The cell at a size a CPU test holds: the same YAML and traffic, a
    small panorama, cloud and capacity."""
    cell = copy.deepcopy(cell)
    cell.config["camera"].update(width=width, height=height)
    cell.config["scene"].update(live_gaussians=live, keyframes=keyframes)
    cell.config["yaml"].update({"Tpu.capacity": 4 * live, "Tpu.max_instances": 16384})
    if "poses" in cell.traffic:
        cell.traffic.update(poses=64, keep_every=1)
    return cell


@pytest.fixture
def tiny():
    """tiny(workload, seed, seconds, trace, device) -> (cell, Outcome) of a
    run of the shrunken cell, the harness's look for a card skipped."""
    from omnibench import harness
    from omnibench.drivers.common import Ctx

    def run(name, seed=12345678901, seconds=0.3, trace=False, device="cpu", yaml=None, **size):
        cell = shrink(harness.find_cell(name), **size)
        cell.config["yaml"].update(yaml or {})
        ctx = Ctx(cell, seed, seconds, trace, device, time.perf_counter())
        return cell, cell.driver.run(ctx)

    return run
