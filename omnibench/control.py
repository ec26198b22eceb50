"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's (float32
products in TF32 on the tensor cores, where the configuration and the
reference run them in full float32), read by the same comparison as a run.
Its checks must come out not correct.

    python3 -m omnibench.control --workload <name> --seeds <n> [<n> ...]

prints, for each seed, one JSON line of the checks and ``correct``. It needs
no measured window: a training cell's numbers are of its first four
iterations, a render cell's of the poses a run would keep and compare.
Nothing of the program runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()


def train_checks(ctx):
    from omnibench.drivers import train
    from omnibench.reference import render as R

    inputs = train.make_inputs(ctx)
    with R.matmul_precision(tf32=False):
        ref = train.reference_readings(ctx, inputs)
    with R.matmul_precision(tf32=True):
        low = train.reference_readings(ctx, inputs)
    return train.compare(low, ref, 0, 0)


def render_checks(ctx, requests: int):
    from omnibench import harness
    from omnibench.drivers import common as C, render
    from omnibench.reference import render as R

    inputs = render.make_inputs(ctx)
    w, h = ctx.size
    gaps = []
    for j in sorted(k for k in inputs["kept"] if k < requests):
        vm, cp = C.pose_tensors(inputs["poses"][j], ctx.device)
        args = (inputs["truth"], w, h, vm, cp, inputs["bg"], inputs["sh"])
        with R.matmul_precision(tf32=False):
            ref, _ = R.render(*args)
        with R.matmul_precision(tf32=True):
            low, _ = R.render(*args)
        d = (low - ref).abs()
        gaps.append((float(d.max()), float(d.mean())))
    return [harness.Check("max_abs", max(g[0] for g in gaps), render.LIMITS["max_abs"]),
            harness.Check("mean_abs", max(g[1] for g in gaps), render.LIMITS["mean_abs"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1000,
                    help="render cells: compare the kept poses among this many requests")
    args = ap.parse_args(argv)
    from omnibench import harness

    harness.set_cache_dirs()
    import torch

    from omnibench.drivers.common import Ctx

    if not torch.cuda.is_available():
        print("omnibench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)  # on one card, whatever the cell's chips
    for seed in args.seeds:
        ctx = Ctx(cell, seed, 0.0, False, "cuda", time.perf_counter())
        if cell.traffic["driver"] == "render":
            checks = render_checks(ctx, args.requests)
        else:
            checks = train_checks(ctx)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": all(c.ok for c in checks),
                          "seconds": time.perf_counter() - ctx.t0,
                          "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
