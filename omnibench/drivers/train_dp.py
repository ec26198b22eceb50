"""The training CLI's loop on every rank of a (data, gauss) mesh, one
process a card: ``ParallelTrainer.train_window(fuse_steps)`` and, when it
returns 0, ``ParallelTrainer.train_iteration`` (the YAML's densify and
reset events), from the configuration's start iteration, through the
port's multi-card path (`parallel.distributed.initialize`, the mesh of the
configuration's ``mesh``, NCCL on the card, gloo on the CPU).

Rank 0 is the benchmark's own process. It opens a `TCPStore` on port 0
(the port is taken as it binds, so none is picked and then lost), starts
ranks 1..n-1 as spawned processes that join the process group through it,
and runs its own rank. It makes the scene from the seed (the truth model,
the keyframe poses, each ground truth rendered by the plain reference) and
broadcasts the ground truths and the start state, so every rank trains on
the same bytes. Set-up takes the first four iterations on every rank
through the loop's own calls, as `drivers/train.py` does: ``train_window(1)``,
``train_window(2)``, then ``train_iteration`` at the event iteration. The
window runs for ``--seconds`` on rank 0's clock: after each window rank 0
decides whether to go on and tells the others through the store (a host
round trip, no device sync). A traced run profiles rank 0's slice; the
other ranks run the same windows untraced.

``correct``: the four losses (all-reduced), the first gradient (from rank
0's Adam state) and the change after three Adam steps against the plain
reference over the same four-view batches (`reference/train.run_steps`,
the views in the sampler's order, four a batch), at `drivers/train.py`'s
limits; ``truncated`` and non-finite losses over every rank, 0; and
``replica_gap``, the largest difference over every capacity row between
any rank's model fields, Adam moments and step count and rank 0's after
the window, 0: every replica takes the same update, densify included.

Faults: a rank that raises prints its traceback and exits 1; rank 0 then
ends the run with no result line and a non-zero exit, and so it does when
a rank outlives the run's deadline. No rank calls
``destroy_process_group`` (a process group torn down while a captured
graph lives has hung): ranks 1..n-1 leave through ``os._exit`` once their
part is done, and each watches rank 0 and leaves if it is gone. (On the CPU
under gloo, which captures nothing, rank 0 leaves the group, so that one
process can run the driver again.)
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import multiprocessing as mp
import os
import sys
import threading
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from omnibench import harness, scene as S, tracing
from omnibench.drivers import common as C, train as T
from omnibench.reference import render as R, train as RT

# limits: drivers/train.py's, and every replica bit for bit the same
LIMITS = dict(T.LIMITS, replica_gap=0)
# the traced run's slice and host slice (set-up draws four whole rounds of
# the 16 keyframes, so the slice starts at a round)
SLICE, HOST_SLICE = T.SLICE, T.HOST_SLICE
# a run whose ranks are not all done this long after rank 0 started fails
DEADLINE_S = 900.0
# after a rank failed, how long rank 0 may take to raise before it exits
GRACE_S = 30.0
# "module:function" called on every rank as ``function(rank, patch)`` before
# it trains (``patch(obj, name, value)`` sets an attribute, undone on rank 0
# after the run): the tests' planted faults; None in a measured run
FAULT = None
GO = "omnibench/go/"


def mesh_shape(ctx: C.Ctx):
    """The configuration's (data, gauss) mesh; the model is replicated, so
    gauss is 1."""
    m = ctx.cell.config["mesh"]
    if m["gauss"] != 1:
        raise ValueError(f"a data-parallel deployment replicates the model: gauss {m['gauss']}")
    return m["data"], m["gauss"]


def port_config(ctx: C.Ctx, rank: int):
    """The configuration's YAML with its mesh, each rank its own file."""
    from omnigs_torch.config import load_config

    data, gauss = mesh_shape(ctx)
    yaml = dict(ctx.yaml, **{"Tpu.mesh_data": data, "Tpu.mesh_gauss": gauss})
    name = ctx.cell.config["name"]
    path = harness.BUILD / "configs" / f"{name}.rank{rank}.yaml"
    return load_config(harness.write_yaml({"yaml": yaml}, path))


def broadcast_inputs(ctx: C.Ctx, rank: int) -> dict:
    """`drivers/train.make_inputs` on rank 0; the ground truths and the start
    state broadcast from it to every rank (the poses are the seed's on
    every rank; the truth model stays on rank 0, for nothing but them)."""
    sc = ctx.scene
    if rank == 0:
        inputs = T.make_inputs(ctx)
    else:
        w, h = ctx.size
        n, start = sc["live_gaussians"], sc["start_iteration"]
        dev = ctx.device
        inputs = dict(
            poses=S.poses(sc["keyframes"], ctx.seed, 3, sc["keyframe_pitch"],
                          sc["keyframe_offset"]),
            gts=[torch.empty(3, h, w, device=dev) for _ in range(sc["keyframes"])],
            gt_s=0.0, bg=torch.zeros(3, device=dev),
            sh=min((start - 1) // 1000, ctx.yaml["Model.sh_degree"]),
            start_raw={k: torch.empty((n,) + S.SHAPES.get(k, (w_,)), device=dev)
                       for k, w_ in S.WIDTHS.items()})
    for t in inputs["gts"] + [inputs["start_raw"][k] for k in S.WIDTHS]:
        dist.broadcast(t, src=0)
    return inputs


def build(ctx: C.Ctx, rank: int, inputs: dict):
    """This rank's ParallelTrainer on the start state, its first four
    iterations taken through the loop's own calls, and what they read."""
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    start_raw, dev = inputs["start_raw"], ctx.device
    n, start = start_raw["xyz"].shape[0], ctx.scene["start_iteration"]
    cfg = port_config(ctx, rank)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    tr = ParallelTrainer(C.port_scene(ctx, inputs["poses"], inputs["gts"]), cfg,
                         seed=ctx.seed, device=dev)
    tr.model = C.port_model(start_raw, cfg.tpu.capacity, dev)
    tr.opt_state = opt_ops.init_adam(tr.model.params())
    tr.opt_state.count.fill_(start - 1)
    tr.iteration = start - 1
    if tr.window_mode == "graph":
        # the window's buffers at their full length now, so no later window
        # captures again
        tr.step_graph.reserve(torch.device(dev), cfg.tpu.fuse_steps,
                              2 * cfg.tpu.views_per_group + 1)
    for i, k in enumerate(T.CHECK_WINDOWS):
        if tr.train_window(k) != k:
            raise RuntimeError(f"an event iteration within {k} of iteration {tr.iteration + 1}")
        if i == 0:
            g1 = C.norms({f: tr.opt_state.mu[f][:n] / (1.0 - RT.BETA1) for f in C.PARAMS})
    d3 = C.norms({f: getattr(tr.model, f)[:n] - start_raw[f] for f in C.PARAMS})
    if tr.train_window(1) != 0:
        raise RuntimeError(f"iteration {tr.iteration + 1} is not an event iteration")
    tr.train_iteration()
    losses = T.queued_losses(tr)
    tr.drain_losses()
    return tr, dict(losses=losses, grad=g1, change=d3, live_after_event=tr.live_gaussians())


def replica_gap(tr) -> float:
    """The largest |x - x0| over every capacity row of the model's fields
    (the live mask included), the Adam moments and the step count, x0 rank
    0's, over every rank (equal values, infinities included, read 0)."""
    from omnigs_torch.model.gaussians import FIELD_NAMES

    st = tr.opt_state
    tensors = ([getattr(tr.model, k) for k in FIELD_NAMES] + list(st.mu.values())
               + list(st.nu.values()) + [st.count])
    worst = torch.zeros((), dtype=torch.float64, device=tr.model.xyz.device)
    for t in tensors:
        x = t.detach().to(torch.float64)
        x0 = x.clone()
        dist.broadcast(x0, src=0)
        d = (x - x0).abs()
        d[x == x0] = 0.0
        worst = torch.maximum(worst, d.max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _over_ranks(values, op, device) -> list:
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return t.tolist()


def reference_readings(ctx: C.Ctx, inputs: dict, world: int) -> dict:
    """`drivers/train.reference_readings` with ``world`` views an iteration,
    drawn as the ranks draw them: the sampler's draws in order, draw
    ``world·i + d`` data row d's view of iteration i; each step's loss and
    gradient the batch's means (`reference/train.run_steps`), the event
    iteration's loss its views' mean."""
    sc, (w, h), y = ctx.scene, ctx.size, ctx.yaml
    start = sc["start_iteration"]
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
    fids = C.sampler_fids(ctx.seed, range(len(poses)), T.CHECKED * world)
    views = [(*C.pose_tensors(poses[f], ctx.device), inputs["gts"][f]) for f in fids]
    batches = [views[i * world:(i + 1) * world] for i in range(T.CHECKED)]
    extent = RT.scene_extent([S.campos(*p) for p in poses])
    params = {k: v.clone() for k, v in inputs["start_raw"].items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    steps = RT.run_steps(params, mu, nu, start - 1, batches[:T.CHECK_STEPS],
                         range(start, start + T.CHECK_STEPS), w, h, inputs["sh"], opt, extent,
                         skip, inputs["bg"])
    event_loss = 0.0
    for vm, cp, gt in batches[T.CHECK_STEPS]:
        image, _ = R.render(params, w, h, vm, cp, inputs["bg"], inputs["sh"])
        event_loss += float(RT.loss_fn(gt, opt["lambda_dssim"], skip)(image)) / world
    return dict(losses=[s["loss"] for s in steps] + [event_loss],
                grad=C.norms(steps[0]["grads"]),
                change=C.norms({k: params[k] - inputs["start_raw"][k] for k in params}))


def compare(prog: dict, ref: dict, truncated: int, nonfinite: int, gap: float):
    checks = T.compare(prog, ref, truncated, nonfinite)
    return checks + [harness.Check("replica_gap", float(gap), float(LIMITS["replica_gap"]))]


def control_checks(ctx: C.Ctx):
    """The checks of the reference put in the program's place, computed in
    TF32 (the control; `omnibench/control.py` reads one view an
    iteration): on one card, whatever the cell's."""
    inputs = T.make_inputs(ctx)
    world = math.prod(mesh_shape(ctx))
    with R.matmul_precision(tf32=False):
        ref = reference_readings(ctx, inputs, world)
    with R.matmul_precision(tf32=True):
        low = reference_readings(ctx, inputs, world)
    return compare(low, ref, 0, 0, 0.0)


class _Patches:
    """``patch(obj, name, value)`` for a planted fault, undone by `undo`."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def _plant(fault, rank: int, patch) -> None:
    if fault:
        mod, fn = fault.split(":")
        getattr(importlib.import_module(mod), fn)(rank, patch)


def _rank_run(ctx: C.Ctx, rank: int, world: int, store, fault) -> dict:
    """One rank's run: join, set-up, window; on rank 0 also the reference
    and the comparison. Returns rank 0's readings (the others' are {})."""
    from omnigs_torch.parallel.distributed import initialize

    cuda = ctx.device != "cpu"
    ctx = dataclasses.replace(ctx, device=f"cuda:{rank}" if cuda else "cpu")
    initialize("nccl" if cuda else "gloo", rank=rank, world_size=world, store=store)
    patches = _Patches()
    threads = torch.get_num_threads()
    if not cuda:  # a CPU rehearsal: the ranks share the host's cores
        torch.set_num_threads(1)
    try:
        _plant(fault, rank, patches)
        return _train(ctx, rank, world, store)
    finally:
        patches.undo()
        torch.set_num_threads(threads)
        if not cuda:  # gloo captures no graph: a later run of this process joins anew
            dist.destroy_process_group()


def _train(ctx: C.Ctx, rank: int, world: int, store) -> dict:
    inputs = broadcast_inputs(ctx, rank)
    if rank == 0:
        C.log(ctx, f"inputs made and broadcast to {world} ranks "
                   f"({inputs['gt_s']:.2f} s of reference ground truths)")
    tr, prog = build(ctx, rank, inputs)
    if rank == 0:
        C.log(ctx, f"set-up done on every rank: {tr.step_graph.captures} capture, "
                   f"{T.CHECKED} iterations taken, {prog['live_after_event']} live after the event")
    fuse = tr.config.tpu.fuse_steps
    trace = {} if ctx.trace and rank == 0 else None
    busy_s = window_s = breakdown = None
    setup_s = ctx.now() - ctx.t0 - inputs["gt_s"]
    before = 0  # iterations of the traced run before the window
    if ctx.trace:
        live = int(tr.model.active.sum())
        counted = _program_bytes()

        def slice_fn():
            done = 0
            while done < SLICE:
                k = tr.train_window(min(fuse, SLICE - done))
                if k == 0:
                    raise RuntimeError("an event iteration inside the profiled slice")
                done += k

        if rank == 0:
            events, host_s = tracing.profile(slice_fn, f"{ctx.cell.name}.slice")
            after = _program_bytes()
            host_events, _ = tracing.profile(lambda: tr.train_window(HOST_SLICE),
                                             f"{ctx.cell.name}.host", cpu=True)
        else:
            slice_fn()
            tr.train_window(HOST_SLICE)
        if rank == 0:
            busy_s = tracing.busy_us(events) * 1e-6
            window_s = host_s
            breakdown = dict(device_ops=tracing.top_ops(events),
                             idle_gaps=tracing.idle_gaps(host_events))
            trace.update(kind="train_dp", events=events, slice_s=host_s, slice_iters=SLICE,
                         world=world, live=live,
                         allreduce_bytes=None if counted is None else after - counted)
        before += SLICE + HOST_SLICE
        while (k := tr.train_window(fuse)):  # up to the next event iteration
            before += k
    iters, windows, event_s = 0, 0, 0.0
    t0 = ctx.now()
    while True:
        k = tr.train_window(fuse)
        if k == 0:
            te = ctx.now() if trace is not None else 0.0
            tr.train_iteration()
            if trace is not None:
                event_s += ctx.now() - te
            k = 1
        iters += k
        if rank == 0:
            go = time.perf_counter() - t0 < ctx.seconds
            store.set(f"{GO}{windows}", "1" if go else "0")
        else:
            go = store.get(f"{GO}{windows}") == b"1"
        windows += 1
        if not go:
            break
    window = ctx.now() - t0
    dev = ctx.device
    memory_peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    nonfinite = sum(not math.isfinite(x) for x in T.queued_losses(tr))
    tr.drain_losses()
    gap = replica_gap(tr)
    forbidden = len(harness.forbidden_modules())
    memory_peak, nonfinite, truncated, forbidden = _over_ranks(
        [memory_peak, nonfinite, int(tr.total_truncated), forbidden], dist.ReduceOp.MAX, dev)
    del tr
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    if rank != 0:
        return {}
    if forbidden:
        raise RuntimeError("a rank loaded JAX or the JAX package")
    C.log(ctx, f"window closed: {iters} iterations ({world} views each) in {window:.3f} s; "
               f"replica_gap {gap!r}")
    with R.matmul_precision(tf32=False):
        ref = reference_readings(ctx, inputs, world)
    C.log(ctx, "reference done")
    if trace is not None:
        trace.update(event_s=event_s, window_iters=iters)
    return dict(outcome=harness.Outcome(
        attempted=T.CHECKED + before + iters, failed=int(nonfinite),
        end_to_end=dict(setup_s=setup_s, train_ms_per_iter=window * 1e3 / iters),
        checks=compare(prog, ref, int(truncated), int(nonfinite), gap),
        memory_peak_bytes=int(memory_peak), trace=trace, busy_s=busy_s, window_s=window_s,
        breakdown=breakdown))


def _program_bytes():
    """The program's run-wide all-reduce bytes, or None where it counts none."""
    from omnibench.metrics import _stages

    got = _stages.program_counters()
    return None if got is None else got.get("allreduce_bytes")


def _watch_parent(ppid: int) -> None:
    """Leave at once if rank 0's process is gone (a rank blocked in a
    collective would wait for it forever)."""
    def watch():
        while os.getppid() == ppid:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_entry(ctx: C.Ctx, rank: int, world: int, port: int, fault, ppid: int) -> None:
    """A spawned rank: its run, its traceback on a fault; it leaves through
    ``os._exit`` (no process-group teardown, see the module's docstring)."""
    code = 1
    try:
        _watch_parent(ppid)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=timedelta(seconds=DEADLINE_S))
        _rank_run(ctx, rank, world, store, fault)
        code = 0
    except BaseException:
        print(f"omnibench: rank {rank} failed:\n{traceback.format_exc()}", file=sys.stderr)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


class _Watchdog:
    """Rank 0's watch over the spawned ranks: a rank that exits non-zero, or
    a run past its deadline, kills every rank; rank 0 exits 1 if it has
    not raised within GRACE_S (a rank blocked in NCCL waits for ever)."""

    def __init__(self, procs, deadline: float):
        self.procs, self.deadline = procs, deadline
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)

    def _watch(self):
        while not self.done.wait(0.5):
            bad = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                   if p.exitcode not in (None, 0)]
            late = time.perf_counter() > self.deadline
            if bad or late:
                why = (f"rank {bad[0][0]} exited with {bad[0][1]}" if bad
                       else f"the ranks outlived the deadline ({DEADLINE_S:.0f} s)")
                print(f"omnibench: {why}: every rank stopped, no result", file=sys.stderr,
                      flush=True)
                self.kill()
                if not self.done.wait(GRACE_S):
                    os._exit(1)
                return


def run(ctx: C.Ctx) -> harness.Outcome:
    world = math.prod(mesh_shape(ctx))
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=DEADLINE_S))
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_rank_entry, daemon=True,
                           args=(ctx, r, world, store.port, FAULT, os.getpid()))
             for r in range(1, world)]
    for p in procs:
        p.start()
    C.log(ctx, f"ranks 1-{world - 1} started, pids {[p.pid for p in procs]}, "
               f"store port {store.port}")
    watch = _Watchdog(procs, time.perf_counter() + DEADLINE_S)
    try:
        out = _rank_run(ctx, 0, world, store, FAULT)
        for p in procs:
            p.join(timeout=60)
        bad = [(r, p.exitcode) for r, p in enumerate(procs, 1) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks that did not end cleanly (rank, exit code): {bad}")
        return out["outcome"]
    finally:
        watch.done.set()
        watch.kill()
