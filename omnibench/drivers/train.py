"""The training CLI's loop on one card: ``Trainer.train_window(fuse_steps)``
and, when it returns 0, ``Trainer.train_iteration`` (the YAML's densify and
reset events), from the configuration's start iteration.

Set-up makes the scene from the seed (the truth model on the card, the
keyframe poses, each ground truth rendered by the plain reference), builds
one Trainer on the partly trained start state, and takes its first four
iterations through the loop's own calls: ``train_window(1)`` (one replay
of the window's graph, whose capture is set-up), ``train_window(2)`` (two
replays from one staged index, the cursor and the step number advancing
inside the graph), then ``train_iteration`` at the event iteration the
start lies three before (the eager step, no Adam, and densify). The
window then runs the loop for ``--seconds``. The reference follows the
four iterations from the same start state and views; the four losses, the
first gradient (from the Adam state after one step) and the parameters'
change after three are compared, the norms by the worst leaf.
``truncated`` over the whole run must be 0.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from omnibench import harness, scene as S, tracing
from omnibench.drivers import common as C
from omnibench.reference import counts as RC, render as R, train as RT

# the window's calls that set-up checks, in order: one replay, two replays;
# then the event iteration
CHECK_WINDOWS = (1, 2)
CHECK_STEPS = sum(CHECK_WINDOWS)  # iterations with Adam
CHECKED = CHECK_STEPS + 1  # and the event iteration's loss
# limits of the comparison with the reference (PERF.md gives the readings
# each was set from)
LIMITS = dict(loss_gap=2e-3, grad_gap=5e-3, step_gap=8e-5, truncated=0, nonfinite=0)
# the traced run: iterations before the profiled slice (the slice then
# starts at a keyframe round), the slice, the host-profiled iterations
SKIP, SLICE, HOST_SLICE = 16 - CHECKED, 48, 4


def make_inputs(ctx: C.Ctx) -> dict:
    """The scene from the seed: keyframe poses, the ground truths the
    reference renders of the truth model (``gt_s``: the seconds they took,
    the reference's own, left out of ``setup_s``), the start state."""
    sc = ctx.scene
    n, start = sc["live_gaussians"], sc["start_iteration"]
    truth = S.truth_model(n, ctx.seed, ctx.device)
    poses = S.poses(sc["keyframes"], ctx.seed, 3, sc["keyframe_pitch"], sc["keyframe_offset"])
    bg = torch.zeros(3, device=ctx.device)
    sh = min((start - 1) // 1000, ctx.yaml["Model.sh_degree"])
    t = ctx.now()
    gts = C.reference_images(ctx, truth, poses, sh, bg)
    gt_s = ctx.now() - t
    start_raw = S.start_state(truth, ctx.seed)
    return dict(poses=poses, gts=gts, gt_s=gt_s, start_raw=start_raw, bg=bg, sh=sh)


def queued_losses(tr) -> list:
    """The losses the Trainer has queued on the device, in order."""
    return torch.cat([x.reshape(-1) for x, _, _ in tr._pending_losses]).tolist()


def build(ctx: C.Ctx, inputs: dict):
    """The Trainer on the start state, its first four iterations taken
    through the loop's own calls, and what they read."""
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.train.trainer import Trainer

    start_raw, dev = inputs["start_raw"], ctx.device
    n, start = start_raw["xyz"].shape[0], ctx.scene["start_iteration"]
    cfg = C.port_config(ctx)
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tr = Trainer(C.port_scene(ctx, inputs["poses"], inputs["gts"]), cfg, seed=ctx.seed, device=dev)
    tr.model = C.port_model(start_raw, cfg.tpu.capacity, dev)
    tr.opt_state = opt_ops.init_adam(tr.model.params())
    tr.opt_state.count.fill_(start - 1)
    tr.iteration = start - 1
    if dev != "cpu":
        # the window's buffers at their full length now, so no later window
        # captures again
        tr.step_graph.reserve(torch.device(dev), cfg.tpu.fuse_steps, 3)
    for i, k in enumerate(CHECK_WINDOWS):
        if tr.train_window(k) != k:
            raise RuntimeError(f"an event iteration within {k} of iteration {tr.iteration + 1}")
        if i == 0:
            g1 = C.norms({f: tr.opt_state.mu[f][:n] / (1.0 - RT.BETA1) for f in C.PARAMS})
    d3 = C.norms({f: getattr(tr.model, f)[:n] - start_raw[f] for f in C.PARAMS})
    if tr.train_window(1) != 0:
        raise RuntimeError(f"iteration {tr.iteration + 1} is not an event iteration")
    tr.train_iteration()  # its kernels and densify's load here, before the window
    losses = queued_losses(tr)
    tr.drain_losses()
    return tr, dict(losses=losses, grad=g1, change=d3, live_after_event=tr.live_gaussians())


def reference_readings(ctx: C.Ctx, inputs: dict) -> dict:
    """The reference's first four iterations from the start state, one
    keyframe each in the sampler's order: three with Adam, then the event
    iteration's loss (no Adam at a densify)."""
    sc, w, h = ctx.scene, *ctx.size
    start = sc["start_iteration"]
    y = ctx.yaml
    opt = dict(position_lr_init=y["Optimization.position_lr_init"],
               position_lr_final=y["Optimization.position_lr_final"],
               position_lr_max_steps=y["Optimization.position_lr_max_steps"],
               feature_lr=y["Optimization.feature_lr"], opacity_lr=y["Optimization.opacity_lr"],
               scaling_lr=y["Optimization.scaling_lr"],
               rotation_lr=y["Optimization.rotation_lr"],
               lambda_dssim=y["Optimization.lambda_dssim"])
    ratio = y.get("Optimization.skip_bottom_ratio", 0.0)
    skip = int(round(h * ratio)) if ratio > 0 else 0
    poses = inputs["poses"]
    views = [(*C.pose_tensors(poses[f], ctx.device), inputs["gts"][f])
             for f in C.sampler_fids(ctx.seed, range(len(poses)), CHECKED)]
    extent = RT.scene_extent([S.campos(*p) for p in poses])
    params = {k: v.clone() for k, v in inputs["start_raw"].items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    steps = RT.run_steps(params, mu, nu, start - 1, [[v] for v in views[:CHECK_STEPS]],
                         range(start, start + CHECK_STEPS), w, h, inputs["sh"], opt, extent,
                         skip, inputs["bg"])
    vm, cp, gt = views[CHECK_STEPS]
    image, _ = R.render(params, w, h, vm, cp, inputs["bg"], inputs["sh"])
    event_loss = float(RT.loss_fn(gt, opt["lambda_dssim"], skip)(image))
    return dict(losses=[s["loss"] for s in steps] + [event_loss],
                grad=C.norms(steps[0]["grads"]),
                change=C.norms({k: params[k] - inputs["start_raw"][k] for k in params}))


def compare(prog: dict, ref: dict, truncated: int, nonfinite: int):
    pairs = list(zip(prog["losses"], ref["losses"]))
    loss_gap = (max(abs(a - b) / abs(b) for a, b in pairs)
                if len(prog["losses"]) == len(ref["losses"]) == CHECKED else float("nan"))
    leaves = C.moving_leaves(ref["grad"])
    vals = dict(loss_gap=loss_gap, grad_gap=C.worst_norm_gap(prog["grad"], ref["grad"], leaves),
                step_gap=C.worst_norm_gap(prog["change"], ref["change"], leaves),
                truncated=truncated, nonfinite=nonfinite)
    return [harness.Check(k, float(v), float(LIMITS[k])) for k, v in vals.items()]


def run(ctx: C.Ctx) -> harness.Outcome:
    inputs = make_inputs(ctx)
    C.log(ctx, f"inputs made ({inputs['gt_s']:.2f} s of reference ground truths)")
    tr, prog = build(ctx, inputs)
    C.log(ctx, f"set-up done: {tr.step_graph.captures} capture, {CHECKED} iterations taken, "
               f"{prog['live_after_event']} live after the event")
    fuse = tr.config.tpu.fuse_steps
    trace = {} if ctx.trace else None
    busy_s = window_s = breakdown = None
    setup_s = ctx.now() - ctx.t0 - inputs["gt_s"]
    before = 0  # iterations of the traced run before the window
    if ctx.trace:
        before += tr.train_window(SKIP)
        # the live Gaussians the slice starts from (set-up's densify has
        # grown the start state), for the rooflines' counts
        live = {k: getattr(tr.model, k).detach()[tr.model.active].clone() for k in C.PARAMS}

        def slice_fn():
            done = 0
            while done < SLICE:
                k = tr.train_window(min(fuse, SLICE - done))
                if k == 0:
                    raise RuntimeError("an event iteration inside the profiled slice")
                done += k

        events, host_s = tracing.profile(slice_fn, f"{ctx.cell.name}.slice")
        busy_s = tracing.busy_us(events) * 1e-6
        host_events, _ = tracing.profile(lambda: tr.train_window(HOST_SLICE),
                                         f"{ctx.cell.name}.host", cpu=True)
        before += SLICE + HOST_SLICE
        t, clean = ctx.now(), 0
        while (k := tr.train_window(fuse)):  # up to the next event iteration
            clean += k
        clean_s = ctx.now() - t
        before += clean
        window_s = host_s
        breakdown = dict(device_ops=tracing.top_ops(events),
                         idle_gaps=tracing.idle_gaps(host_events))
        trace.update(kind="train", events=events, slice_s=host_s, slice_iters=SLICE,
                     ms_per_iter_clean=clean_s * 1e3 / max(clean, 1))
    iters, event_s = 0, 0.0
    t0 = ctx.now()
    while True:
        k = tr.train_window(fuse)
        if k == 0:
            te = ctx.now() if ctx.trace else 0.0
            tr.train_iteration()
            if ctx.trace:
                event_s += ctx.now() - te
            k = 1
        iters += k
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = ctx.now() - t0
    memory_peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0
    nonfinite = sum(not math.isfinite(x) for x in queued_losses(tr))
    tr.drain_losses()
    truncated = int(tr.total_truncated)
    del tr
    gc.collect()
    C.log(ctx, f"window closed: {iters} iterations in {window:.3f} s")
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    with R.matmul_precision(tf32=False):
        ref = reference_readings(ctx, inputs)
    C.log(ctx, "reference done")
    if ctx.trace:
        with R.matmul_precision(tf32=False):
            trace.update(event_s=event_s, window_iters=iters,
                         counts=RC.mean_counts(live, *ctx.size,
                                               [C.pose_tensors(p, ctx.device)
                                                for p in inputs["poses"]],
                                               inputs["sh"], inputs["bg"]))
    return harness.Outcome(
        attempted=CHECKED + before + iters, failed=nonfinite,
        end_to_end=dict(setup_s=setup_s, train_ms_per_iter=window * 1e3 / iters),
        checks=compare(prog, ref, truncated, nonfinite), memory_peak_bytes=memory_peak,
        trace=trace, busy_s=busy_s, window_s=window_s, breakdown=breakdown)
