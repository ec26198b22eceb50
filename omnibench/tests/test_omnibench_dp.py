"""The data-parallel driver (`drivers/train_dp.py`) on the CPU: the
shrunken `roam360-train-dp4` cell on four gloo ranks, the harness's look
for a card skipped. A sound run is correct with every replica bit for bit
rank 0's; each fault planted in the ranks (`dp_faults.py`) reads not
correct; a rank that raises ends the run with no result line, a non-zero
exit and no rank left alive."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

from omnibench import harness
from omnibench.drivers import train_dp

CELL = "roam360-train-dp4"


def checks(out):
    return {c.name: c.value for c in out.checks}


def test_sound_run_is_correct(tiny):
    _, out = tiny(CELL)
    assert all(c.ok for c in out.checks), checks(out)
    assert checks(out)["replica_gap"] == 0.0 and out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("fault, caught_by", [
    ("skip_grad_allreduce", "replica_gap"),
    ("sum_without_divide", "grad_gap"),
    ("rank_0s_view", "grad_gap"),
    ("other_densify_seed", "replica_gap"),
])
def test_planted_faults_are_caught(tiny, monkeypatch, fault, caught_by):
    monkeypatch.setattr(train_dp, "FAULT", f"omnibench.tests.dp_faults:{fault}")
    _, out = tiny(CELL)
    bad = {c.name for c in out.checks if not c.ok}
    assert caught_by in bad, checks(out)


def test_a_failing_rank_ends_the_run():
    code = textwrap.dedent("""
        import time
        from omnibench import harness
        from omnibench.drivers import train_dp
        from omnibench.drivers.common import Ctx
        from omnibench.tests.conftest import shrink

        train_dp.FAULT = "omnibench.tests.dp_faults:raise_in_rank_2"
        cell = shrink(harness.find_cell("roam360-train-dp4"))
        out = cell.driver.run(Ctx(cell, 12345678901, 0.3, False, "cpu", time.perf_counter()))
        print("RESULT", all(c.ok for c in out.checks))
    """)
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    got = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and "RESULT" not in got.stdout, got.stderr[-3000:]
    assert "rank 2 failed" in got.stderr and "a fault planted in rank 2" in got.stderr
    pids = [int(p) for p in re.search(r"pids \[([\d, ]+)\]", got.stderr).group(1).split(",")]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
