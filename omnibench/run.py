"""The benchmark's command: one run of one cell.

    python3 -m omnibench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's inputs from the seed on the card, warms up the
cell's shapes (set-up), measures for ``--seconds``, compares what the timed
path produced with the plain reference in ``omnibench/reference``, and
prints the result as the last line of its standard output, the numbers
compared beside their limits as the last lines of its standard error.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process, few threads: the host's share of a request varies least
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"omnibench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    from omnibench import harness

    harness.set_cache_dirs()
    bad = harness.reference_imports()
    if bad:
        return fail(f"the reference imports the program or JAX: {bad}")
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present")
    from omnibench.drivers.common import Ctx

    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    out = cell.driver.run(ctx)
    line = harness.result_line(cell, out, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package is loaded: {loaded}")
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
