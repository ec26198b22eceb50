"""Closed-loop rendering, one client: ``render_model`` of the truth model
(all of its Gaussians live, as the eval CLI and the viewer hold a loaded
model), each request at the next of the mix's poses drawn from the seed
(cycling through them), timed from its issue to a synchronise on its
image.

A sample of the requests, drawn from the seed before the window, keep
their images; after the window the reference renders the same poses, and
the worst image gap is compared with its limit, with the instances the
window's renders truncated (0).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from omnibench import harness, scene as S, tracing
from omnibench.drivers import common as C
from omnibench.reference import counts as RC, render as R

LIMITS = dict(max_abs=3e-2, mean_abs=4e-5, truncated=0)
SLICE, HOST_SLICE = 16, 4


def make_inputs(ctx: C.Ctx) -> dict:
    sc, tr = ctx.scene, ctx.cell.traffic
    truth = S.truth_model(sc["live_gaussians"], ctx.seed, ctx.device)
    poses = S.poses(tr["poses"], ctx.seed, 4, tr["pitch_sigma"], tr["offset"])
    rng = np.random.default_rng([ctx.seed, 5])
    kept = set(rng.choice(tr["poses"], size=tr["poses"] // tr["keep_every"], replace=False).tolist())
    return dict(truth=truth, poses=poses, kept=kept, bg=torch.zeros(3, device=ctx.device),
                sh=ctx.yaml["Model.sh_degree"])


def run(ctx: C.Ctx) -> harness.Outcome:
    from omnigs_torch.config import raster_config_from
    from omnigs_torch.ops import rasterize
    from omnigs_torch.train.renderer import render_model

    inputs = make_inputs(ctx)
    truth, poses, bg, sh = inputs["truth"], inputs["poses"], inputs["bg"], inputs["sh"]
    cfg = C.port_config(ctx)
    C.log(ctx, "inputs made")
    if ctx.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    model = C.port_model(truth, truth["xyz"].shape[0], ctx.device)
    rcfg = raster_config_from(cfg)
    cam = C.camera(ctx)
    vms = torch.from_numpy(np.stack([S.viewmatrix(*p) for p in poses])).to(ctx.device)
    cps = torch.from_numpy(np.stack([S.campos(*p) for p in poses])).to(ctx.device)
    n = len(poses)

    def request(i):
        with torch.inference_mode():
            return render_model(model, cam, vms[i % n], cps[i % n], bg, sh, rcfg)

    # the first poses once: builds and loads the kernels, and the allocator
    # holds the blocks of the larger requests before the window
    for i in range(min(n, ctx.cell.traffic["warm_poses"])):
        request(i)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    C.log(ctx, "set-up done")
    trace = {} if ctx.trace else None
    busy_s = window_s = breakdown = None
    first = 0
    if ctx.trace:
        def slice_fn():
            for i in range(SLICE):
                request(i).image.sum()

        events, host_s = tracing.profile(slice_fn, f"{ctx.cell.name}.slice")
        host_events, _ = tracing.profile(lambda: [request(SLICE + i) for i in range(HOST_SLICE)],
                                         f"{ctx.cell.name}.host", cpu=True)
        spans = {}
        with tracing.event_spans(rasterize, ("preprocess", "bin_instances_packed"), spans):
            for i in range(SLICE):
                request(i)
        busy_s, window_s = tracing.busy_us(events) * 1e-6, host_s
        breakdown = dict(device_ops=tracing.top_ops(events), idle_gaps=tracing.idle_gaps(host_events))
        trace.update(kind="render", events=events, slice_s=host_s, slice_requests=SLICE,
                     span_ms=tracing.span_ms(spans))
        first = SLICE + HOST_SLICE
    lat, images = [], {}
    truncated = torch.zeros((), dtype=torch.int64, device=ctx.device)
    t0 = time.perf_counter()
    i = first
    while True:
        t = time.perf_counter()
        res = request(i)
        ctx.sync()
        lat.append(time.perf_counter() - t)
        truncated += res.truncated
        if i % n in inputs["kept"] and i < n:
            images[i] = res.image
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    C.log(ctx, f"window closed: {len(lat)} requests in {window:.3f} s, ms p50 "
               f"{C.percentile(lat, 50) * 1e3:.3f} p95 {C.percentile(lat, 95) * 1e3:.3f} "
               f"max {max(lat) * 1e3:.3f}")
    memory_peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0
    truncated = int(truncated)
    del model
    gc.collect()
    w, h = ctx.size
    gaps = []
    with R.matmul_precision(tf32=False):
        for j, img in sorted(images.items()):
            ref, _ = R.render(truth, w, h, vms[j], cps[j], bg, sh)
            d = (img.float() - ref).abs()
            gaps.append((float(d.max()), float(d.mean())))
    checks = [harness.Check("max_abs", max(g[0] for g in gaps) if gaps else float("nan"),
                            LIMITS["max_abs"]),
              harness.Check("mean_abs", max(g[1] for g in gaps) if gaps else float("nan"),
                            LIMITS["mean_abs"]),
              harness.Check("none_compared", float(not gaps), 0.0),
              harness.Check("truncated", float(truncated), LIMITS["truncated"])]
    C.log(ctx, f"reference compared {len(gaps)} requests")
    if ctx.trace:
        trace["ms_per_request"] = window * 1e3 / len(lat)
        with R.matmul_precision(tf32=False):
            trace["counts"] = RC.mean_counts(truth, w, h, [(vms[j], cps[j]) for j in range(SLICE)],
                                             sh, bg)
    return harness.Outcome(
        attempted=len(lat), failed=0,
        end_to_end=dict(setup_s=setup_s, render_p95_ms=C.percentile(lat, 95) * 1e3,
                        render_frames_per_s=len(lat) / window),
        checks=checks, memory_peak_bytes=memory_peak, trace=trace, busy_s=busy_s,
        window_s=window_s, breakdown=breakdown)
