"""Training orchestration — the `GaussianMapper` analog.

Counterpart of `omnigs_tpu/train/trainer.py` (`train_step`,
`train_steps_fused` and the `Trainer` loop) and of the sharded step and
window of `omnigs_tpu/parallel/shard.py`:

* per iteration: a random keyframe with a times-of-use budget, the SH
  degree raised every 1000 iterations, the log-lerp xyz LR, render →
  bottom-cropped 0.8·L1 + 0.2·(1−SSIM) → backward (the segmented backward
  kernel, `ops/composite_seg.py`, or under ``Tpu.want_ncontrib: 1`` the
  tile-major one, `ops/composite_tile.py`) → densification statistics →
  Adam;
* densify/prune every ``densification_interval`` iterations inside
  (densify_from_iter, densify_until_iter), opacity reset every
  ``opacity_reset_interval``;
* the reference quirks the JAX trainer keeps: a densify iteration skips
  Adam, and a reset iteration zeroes the opacity LR.

`train_step` is the one step body, on one device and on a (data, gauss)
mesh (``mesh``; `parallel/shard.py` holds the mesh's render and loss
partials and `train/trainer_parallel.py` the `ParallelTrainer`). It
updates the model's parameters, statistics and the Adam state in place
(the JAX step returns new ones). Nothing in a step reads a value back to
the host or builds a tensor from host data: losses and capacity counters
stay on the device and `drain_losses` folds them in later.

`Trainer.train_window(k)` takes up to k steps between event iterations
(densify, opacity reset, SH bump, phase boundaries) through
`train_steps_fused`, JAX's one-program window: the keyframes are sampled
on the host in the order k `train_iteration` calls would draw them, their
rows of the pose and ground-truth banks (`Trainer._bank_rows`) are
staged, and on the card the k steps are k replays of one step captured as
a CUDA graph (`StepGraph`), bitwise the eager steps. On the CPU, or on a
mesh under gloo, the window runs the k steps eagerly (`window_mode`).
`train`, the live-tunable parameters and full-state checkpoints
(`train/checkpoint.py`) complete the API the training CLI calls.

Under the coarse-to-fine pyramid (``GausPyramid.do``) each keyframe's
first ``sub_level_times_of_use`` uses of each sub-level train at
0.5^(L−l) of the camera's size, with the ground truth resized by cv2's
INTER_AREA and the undistort mask by cv2's default on the host, as the
JAX trainer does; `train_window` then takes no steps. A pinhole keyframe
raises the JAX package's ValueError at its first step: neither trainer
passes `full_proj`.

`Trainer.lock` is held for the whole of each `train_iteration` (the Adam
step, densify/prune and the opacity reset included) and for each step of
a window (each graph replay, and a capture): the live viewer
(`viewer/live.py`) renders and reads its frame back under it, so a frame
never sees a half-applied step, and the render, which draws no random
number and writes no state, leaves the trajectory as it was. The lock is
first come, first served: a plain lock released and taken again by the
training loop would keep a waiting frame out for many iterations.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import math
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from omnigs_torch.cameras import Camera
from omnigs_torch.config import Config, raster_config_from
from omnigs_torch.model import densify as densify_ops
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import FIELD_NAMES, PARAM_NAMES, GaussianModel, from_pcd
from omnigs_torch.ops.knn import mean_sq_knn_dist
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.parallel import shard
from omnigs_torch.parallel.mesh import DATA_AXIS, GAUSS_AXIS, axis_size
from omnigs_torch.scene.scene import KeyframeSampler, Scene
from omnigs_torch.utils import profiling
from omnigs_torch.utils.profiling import PeakMemoryTracker


class FairLock:
    """A lock that waiting threads take in the order they asked for it (a
    releasing thread that asks again queues behind them)."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._queue = collections.deque()
        self._held = False

    def acquire(self):
        with self._cv:
            ticket = object()
            self._queue.append(ticket)
            while self._held or self._queue[0] is not ticket:
                self._cv.wait()
            self._queue.popleft()
            self._held = True
            return True

    def release(self):
        with self._cv:
            if not self._held:
                raise RuntimeError("FairLock released while not held")
            self._held = False
            self._cv.notify_all()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def _bank_views(bank: torch.Tensor, rows, device=None) -> torch.Tensor:
    """Rows ``rows`` of a bank as one (V, ...) tensor on ``device`` (the
    bank's by default): one row of a device bank is a view of it."""
    if len(rows) == 1:
        return bank[int(rows[0]) : int(rows[0]) + 1].to(device or bank.device, non_blocking=True)
    return torch.stack([bank[int(r)].to(device or bank.device, non_blocking=True) for r in rows])


def train_step(
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    viewmatrices: torch.Tensor,
    camposes: torch.Tensor,
    gt_images: torch.Tensor,
    step,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh=None,
    camera: Camera,
    sh_degree: int,
    raster_cfg: RasterConfig,
    lr_cfg: opt_ops.LRConfig,
    spatial_lr_scale: float,
    bg: torch.Tensor,
    lambda_dssim: float = 0.2,
    skip_bottom_px: int = 0,
    update_stats: bool = True,
    do_adam: bool = True,
    skip_opacity_update: bool = False,
) -> Dict[str, torch.Tensor]:
    """One training iteration in place over V views, the (V, 4, 4)
    ``viewmatrices``, (V, 3) ``camposes`` and (V, 3, H, W) ``gt_images``:
    for each view render → loss → backward, then the densification
    statistics and Adam with the views' mean gradient. ``step`` (int or ()
    tensor) sets the xyz LR; the undistort ``mask`` multiplies the rendered
    images. On a ``mesh`` (`parallel.mesh.make_mesh`) the model is this
    rank's gauss shard and the views its data row's: the render, the loss
    and the reductions are `parallel/shard.py`'s, the gradient and the
    statistics summed over ``data`` and the logged loss and counters over
    the mesh. Returns the aux tensors on the device: loss, l1, overflow and
    truncated, the same on every rank, and the last view's image and this
    shard's radii of it.

    The step's stage marks (`utils.profiling.STAGES`) run from
    ``preprocess`` to ``adam`` for each view; without a mesh the render's
    ``end`` sits between ``composite_fwd`` and ``loss``, as `render_model`
    ends every render, and ``adam`` opens before the statistics; on a mesh
    ``allreduce`` opens before the all-reduces, the statistics' included,
    and ``adam`` before their in-place updates. The caller's next mark
    closes ``adam``."""
    dev = model.xyz.device
    params = model.params()
    names = list(params)
    n_views = viewmatrices.shape[0]
    n_data = axis_size(mesh, DATA_AXIS)
    grads = None
    parts, ndc_grads, radii = [], [], []
    for v in range(n_views):
        ndc = torch.zeros(model.capacity, 2, device=dev, requires_grad=True)
        image, r, ov, tr = shard.render_view(
            model, viewmatrices[v], camposes[v], camera, bg, sh_degree, raster_cfg, mesh,
            means2d_ndc=ndc,
        )
        if mesh is None:
            profiling.mark("end", dev)
        profiling.mark("loss", dev)
        pred = image if mask is None else image * mask
        l1, ssim = shard.view_loss(pred, gt_images[v], skip_bottom_px, mesh)
        part = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim)
        # the view's own loss: its screen-space gradient feeds the
        # statistics as one single-device iteration's would
        *g, ndc_grad = torch.autograd.grad(
            part, [params[k] for k in names] + [ndc], allow_unused=True
        )
        g = [torch.zeros_like(params[k]) if x is None else x for k, x in zip(names, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        parts.append((part.detach(), l1.detach(), ssim.detach()))
        ndc_grads.append(ndc_grad)
        radii.append(r.detach())
        overflow, truncated = (ov, tr) if v == 0 else (overflow + ov, truncated + tr)

    profiling.mark("adam" if mesh is None else "allreduce", dev)
    if n_views == 1 and axis_size(mesh, GAUSS_AXIS) == 1:
        loss, l1 = parts[0][:2]
    else:
        # the partials all-reduced over gauss, then as the single-device
        # loss, averaged over the views
        means = shard.all_reduce(torch.stack([torch.stack(p[1:]) for p in parts]), mesh,
                                 GAUSS_AXIS)
        l1 = means[:, 0].mean()
        loss = ((1.0 - lambda_dssim) * means[:, 0] + lambda_dssim * (1.0 - means[:, 1])).mean()
    if mesh is not None:
        loss, l1 = (shard.all_reduce(torch.stack([loss, l1]), mesh, DATA_AXIS) / n_data).unbind()
        counters = torch.stack([overflow, truncated])
        counters = shard.all_reduce(shard.all_reduce(counters, mesh, GAUSS_AXIS), mesh, DATA_AXIS)
        overflow, truncated = counters.unbind()

    with torch.no_grad():
        # the gradient of the mean loss over the views and the data rows
        if n_views > 1:
            grads = [x / n_views for x in grads]
        if n_data > 1:
            grads = [shard.all_reduce(x, mesh, DATA_AXIS) / n_data for x in grads]
        if update_stats:
            densify_ops.add_densification_stats(
                model, ndc_grads, radii,
                None if mesh is None else functools.partial(_stats_over_data, mesh),
            )
        elif mesh is not None:
            profiling.mark("adam", dev)
        if do_adam:
            if not torch.is_tensor(step):
                step = torch.full((), step, dtype=torch.int32, device=dev)
            lrs = opt_ops.group_lrs(lr_cfg, spatial_lr_scale, step)
            if skip_opacity_update:
                lrs["opacity"] = 0.0
            opt_ops.adam_step(params, dict(zip(names, grads)), opt_state, lrs, model.active)
    return dict(loss=loss, l1=l1, overflow=overflow, truncated=truncated,
                image=image.detach(), radii=radii[-1])


def _stats_over_data(mesh, accum, count, radius):
    """The statistics' reduction on a mesh: the views' totals all-reduced
    over ``data`` (the radius by its max); then ``adam`` opens for their
    in-place updates."""
    accum = shard.all_reduce(accum, mesh, DATA_AXIS)
    count = shard.all_reduce(count, mesh, DATA_AXIS)
    radius = shard.all_reduce(radius, mesh, DATA_AXIS, op=dist.ReduceOp.MAX)
    profiling.mark("adam", accum)
    return accum, count, radius


# eager steps on a side stream before a capture (PyTorch's CUDA-graph
# notes: lazy initialisation, the autograd engine's device threads, the
# cuBLAS workspace of the stream); their effect on the state is undone
WARMUP_STEPS = 2
# graph replays a window keeps queued on the stream: enough that the card
# never waits for the host, few enough that a live-viewer frame, which
# takes the lock between two replays, waits for at most this many steps
# and not for the rest of the window
REPLAYS_IN_FLIGHT = 2


def _state_tensors(model: GaussianModel, opt_state: opt_ops.AdamState) -> list:
    """Every tensor a step writes in place: the model's fields, the Adam
    moments and count."""
    state = [getattr(model, k) for k in FIELD_NAMES]
    state += [opt_state.mu[k] for k in PARAM_NAMES] + [opt_state.nu[k] for k in PARAM_NAMES]
    return state + [opt_state.count]


def mesh_key(mesh) -> tuple:
    """What a step on a mesh bakes in of its `DeviceMesh`: the mesh's shape,
    this rank's coordinates and the ranks of each dim's process group."""
    return (
        tuple(mesh.mesh.shape),
        tuple(mesh.get_coordinate()),
        tuple(tuple(dist.get_process_group_ranks(mesh.get_group(d)))
              for d in mesh.mesh_dim_names),
    )


class CaptureKey(NamedTuple):
    """What a captured step bakes in, by field (`capture_key`)."""

    static: tuple
    capacity: int
    shapes: tuple
    no_mask: bool
    addresses: tuple
    mesh: Optional[tuple]
    marks: bool


def capture_reason(old: Optional[CaptureKey], new: CaptureKey) -> str:
    """Why a step with key ``new`` is captured after one with ``old``: the
    changed fields, joined by "+" ("first" without an earlier key)."""
    if old is None:
        return "first"
    return "+".join(f for f, a, b in zip(CaptureKey._fields, old, new) if a != b)


def capture_key(
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    viewmatrices: torch.Tensor,
    camposes: torch.Tensor,
    gt_images: torch.Tensor,
    mask: Optional[torch.Tensor],
    bg: torch.Tensor,
    *,
    mesh=None,
    **static,
) -> tuple:
    """What a captured step bakes in: the Python values of its launches
    (camera, SH degree, update_stats, LRs, λ, crop, raster config — the
    ``static`` keywords of `train_steps_fused`), the capacity, the address
    of every tensor it reads or writes in place (model, Adam state,
    statistics, banks, mask, background), on a mesh its ``mesh``
    (`mesh_key`), and whether the stage marks are on
    (`utils.profiling.set_marks`). A graph whose key differs is captured
    again; its views a step show in the staged index's width
    (`StepGraph.reserve`)."""
    tensors = _state_tensors(model, opt_state) + [viewmatrices, camposes, gt_images, bg]
    if mask is not None:
        tensors.append(mask)
    return CaptureKey(
        static=tuple(sorted(static.items())),
        capacity=model.capacity,
        shapes=tuple(t.shape for t in (viewmatrices, gt_images)),
        no_mask=mask is None,
        addresses=tuple(t.data_ptr() for t in tensors),
        mesh=None if mesh is None else mesh_key(mesh),
        marks=profiling.marks_on(),
    )


def window_index(pose_rows, gt_rows, step0: int) -> np.ndarray:
    """The (k, 2·V + 1) int64 index a window stages for its k steps: each
    step's V pose rows, its V ground-truth rows and its step number step0 +
    i + 1. A (k,) ``pose_rows`` / ``gt_rows`` is one view a step: the
    `Trainer`'s (k, 3) layout."""
    pose_rows = np.asarray(pose_rows, np.int64).reshape(len(pose_rows), -1)
    gt_rows = np.asarray(gt_rows, np.int64).reshape(len(gt_rows), -1)
    steps = step0 + 1 + np.arange(len(pose_rows), dtype=np.int64)
    return np.concatenate([pose_rows, gt_rows, steps[:, None]], axis=1)


class StepGraph:
    """One training step captured as a CUDA graph: the device program of
    `train_steps_fused` on the card (JAX's `lax.scan` body).

    The captured step reads its row of a (K_max, 2·V + 1) staged index
    buffer at a device-side cursor (V pose rows, V ground-truth rows, the
    step number: the `Trainer`'s one view takes 3 columns), gathers its
    inputs from the banks, writes its loss, overflow and truncated at the
    cursor into (K_max,) buffers, and advances the cursor. A window of k ≤
    K_max steps is one host → device copy of its rows and k replays, at
    most REPLAYS_IN_FLIGHT of them queued at a time; one capture serves
    every k. The graph is captured again when its key (`capture_key`)
    changes, or when the buffers are allocated again; each capture counts
    in `utils.profiling.counters` with its reason (`capture_reason`), as
    do the warm-up steps and the replays. Nothing outside the graph keeps
    a tensor the graph writes: a window returns copies. The step's stage
    marks run ``window`` (the row gather), the step's own, ``window``
    again (the output writes) and ``end``.

    A capture launches nothing: what its step counts (`utils.profiling`'s
    kernel launches and collectives) is held back, and each replay counts
    it again (`profiling.held_counts`, `profiling.add_counts`)."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.k_max = 0
        self.captures = 0
        self._per_replay: Dict[tuple, int] = {}
        self._gt_stage: Optional[torch.Tensor] = None
        self.rows: Optional[torch.Tensor] = None

    def reserve(self, device, k: int, cols: int):
        """The staged (K_max, ``cols``) index buffer, the cursor and the
        (K_max,) outputs for a window of ``k`` steps: allocated again (and
        the graph dropped, its key kept) when k exceeds K_max or the layout
        changes."""
        if k <= self.k_max and self.rows.shape[1] == cols:
            return
        self.k_max = k
        self.rows = torch.zeros(k, cols, dtype=torch.int64, device=device)
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self.loss = torch.zeros(k, dtype=torch.float32, device=device)
        self.overflow = torch.zeros(k, dtype=torch.int32, device=device)
        self.truncated = torch.zeros(k, dtype=torch.int32, device=device)
        self.graph = None

    def stage_gt(self, gt_bank: torch.Tensor, gt_rows: np.ndarray, device) -> torch.Tensor:
        """Upload the window's (k, V) ``gt_rows`` of a host ground-truth bank
        (pinned: the copies run on the stream, no host wait) into a
        (K_max·V, 3, H, W) device buffer; row j·V + v holds step j's view
        v."""
        flat = np.asarray(gt_rows).reshape(len(gt_rows), -1)
        shape = (self.k_max * flat.shape[1],) + tuple(gt_bank.shape[1:])
        if self._gt_stage is None or self._gt_stage.shape != shape:
            self._gt_stage = None
            self._gt_stage = torch.empty(shape, dtype=gt_bank.dtype, device=device)
        for j, r in enumerate(flat.reshape(-1)):
            self._gt_stage[j].copy_(gt_bank[int(r)], non_blocking=True)
        return self._gt_stage

    def _step_fn(self, body):
        """The captured step: ``body(row)`` on the cursor's row of the
        staged index → (loss, overflow, truncated), written at the cursor."""
        def step():
            profiling.mark("window", self.cursor)
            i = self.cursor.view(1)
            loss, overflow, truncated = body(self.rows.index_select(0, i)[0])
            profiling.mark("window", self.cursor)
            self.loss.index_copy_(0, i, loss.view(1))
            self.overflow.index_copy_(0, i, overflow.view(1))
            self.truncated.index_copy_(0, i, truncated.view(1))
            self.cursor += 1
            profiling.mark("end", self.cursor)

        return step

    def _capture(self, key, step, state, reason: str):
        """Warm up on a side stream, undo the warm-up's effect on
        ``state``, then capture one ``step`` into a graph with its own
        memory pool, counted with ``reason``."""
        dev = state[0].device
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.cursor.zero_()
                step()
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)
            self.cursor.zero_()
        torch.cuda.current_stream(dev).wait_stream(side)
        del saved
        profiling.count("warmup_steps", WARMUP_STEPS)
        self.graph = None  # the previous graph's pool goes back first
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        # thread-local: a live viewer's request thread may make CUDA calls
        # of its own while the training thread captures (never into this
        # stream: it renders under the trainer's lock, which the capture
        # holds), and so may the NCCL watchdog
        with profiling.held_counts() as per_replay:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step()
        self._per_replay = per_replay
        self.graph, self.key = graph, key
        self.captures += 1
        profiling.count_capture(reason)

    def replay(self, idx: np.ndarray, key, body, state, lock, why: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The window's k = len(idx) steps: ``idx`` (k, C) staged, the step
        ``body`` captured first if there is no graph (reason ``first``, or
        ``buffers`` after `reserve` dropped it), ``key`` differs from the
        graph's (the changed fields) or ``why`` (a reason the key does not
        show) is given (with ``state``,
        the tensors it writes in place: `_state_tensors`), then k replays →
        (losses (k,), Σoverflow, Σtruncated). The buffers must have been
        reserved for k and C."""
        k = len(idx)
        # pinned: the copy runs on the stream, and the host allocator keeps
        # the block until it has
        self.rows[:k].copy_(torch.from_numpy(idx).pin_memory(), non_blocking=True)
        if self.graph is None or key != self.key or why:
            reason = why or capture_reason(self.key, key) or "buffers"
            with lock:
                self._capture(key, self._step_fn(body), state, reason)
        self.cursor.zero_()
        queued = collections.deque()
        for _ in range(k):
            if len(queued) == REPLAYS_IN_FLIGHT:
                with profiling.host_wait("replay_queue"):
                    queued.popleft().synchronize()
            with lock:
                self.graph.replay()
                profiling.add_counts(self._per_replay)
                done = torch.cuda.Event()
                done.record()
            queued.append(done)
        profiling.count("replays", k)
        return self.loss[:k].clone(), self.overflow[:k].sum(), self.truncated[:k].sum()


def window_mode(device, mesh=None) -> str:
    """How `train_steps_fused` runs a window on ``device``: ``"graph"``
    (replays of one step captured as a CUDA graph) on a CUDA device, on a
    ``mesh`` only under NCCL, whose collectives a graph can capture;
    ``"eager"`` (the same step body run step by step) on the CPU, or on a
    mesh under gloo, which stages through the host."""
    if torch.device(device).type != "cuda":
        return "eager"
    return "graph" if mesh is None or dist.get_backend() == "nccl" else "eager"


def train_steps_fused(
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    viewmatrices: torch.Tensor,
    camposes: torch.Tensor,
    gt_images: torch.Tensor,
    step0: int,
    mask: Optional[torch.Tensor] = None,
    *,
    rows=None,
    mesh=None,
    graph: Optional[StepGraph] = None,
    lock=None,
    camera: Camera,
    sh_degree: int,
    raster_cfg: RasterConfig,
    lr_cfg: opt_ops.LRConfig,
    spatial_lr_scale: float,
    bg: torch.Tensor,
    lambda_dssim: float = 0.2,
    skip_bottom_px: int = 0,
    update_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K training iterations between event iterations, in place (JAX's
    `train_steps_fused` and `make_sharded_train_window`, one device
    program). ``rows`` (K, 2, V): step i (from 0) takes rows ``rows[i, 0]``
    of the (N, 4, 4) ``viewmatrices`` and (N, 3) ``camposes`` banks, rows
    ``rows[i, 1]`` of the (M, 3, H, W) ``gt_images`` bank and the step
    number step0 + i + 1, as `train_step` on ``mesh`` with Adam on and the
    opacity LR kept: a window ends before every event iteration. Without
    ``rows`` the banks are the K stacked rows, one view a step, as in JAX.
    Returns (losses (K,), Σoverflow, Σtruncated) on the device, totalled
    over the mesh.

    In `window_mode` "graph" the K steps are K replays of ``graph`` (a
    `StepGraph`, captured again when its key changed, on a mesh of several
    ranks when it changed on any rank; a new one when None); a capture or
    replay that fails raises. In "eager" the same step body runs K times.
    ``gt_images`` may be a host bank (pinned beside a CUDA device), whose
    window rows are uploaded once. ``lock`` (a context manager) is held for
    each step."""
    if rows is None:
        rows = np.repeat(np.arange(viewmatrices.shape[0])[:, None, None], 2, axis=1)
    rows = np.asarray(rows, np.int64)
    k, _, n_views = rows.shape
    pose_rows, gt_rows = rows[:, 0], rows[:, 1]
    lock = contextlib.nullcontext() if lock is None else lock
    kw = dict(camera=camera, sh_degree=sh_degree, raster_cfg=raster_cfg, lr_cfg=lr_cfg,
              spatial_lr_scale=spatial_lr_scale, bg=bg, lambda_dssim=lambda_dssim,
              skip_bottom_px=skip_bottom_px, update_stats=update_stats)
    dev = model.xyz.device
    mode = window_mode(dev, mesh)
    if mode == "graph":
        graph = StepGraph() if graph is None else graph
        graph.reserve(dev, k, 2 * n_views + 1)
    if gt_images.device != dev:
        # a host bank: the window's rows uploaded once, row j·V + v
        if mode == "graph":
            gt_images = graph.stage_gt(gt_images, gt_rows, dev)
        else:
            gt_images = gt_images[torch.from_numpy(gt_rows.reshape(-1))].to(dev)
        gt_rows = np.arange(k * n_views).reshape(k, n_views)
    idx = window_index(pose_rows, gt_rows, step0)

    def body(r):  # V pose rows, V ground-truth rows, the step number
        aux = train_step(
            model, opt_state,
            viewmatrices.index_select(0, r[:n_views]),
            camposes.index_select(0, r[:n_views]),
            gt_images.index_select(0, r[n_views : 2 * n_views]),
            r[2 * n_views].to(torch.int32),
            mask, mesh=mesh, do_adam=True, skip_opacity_update=False, **kw,
        )
        return aux["loss"], aux["overflow"], aux["truncated"]

    if mode == "eager":
        staged = torch.from_numpy(idx).to(dev)
        out = []
        for i in range(k):
            with lock:
                profiling.mark("window", dev)
                out.append(body(staged[i]))
                profiling.mark("end", dev)
        losses, overflow, truncated = (torch.stack(x) for x in zip(*out))
        return losses, overflow.sum(), truncated.sum()
    key = capture_key(model, opt_state, viewmatrices, camposes, gt_images, mask, mesh=mesh, **kw)
    # every rank captures, or none: a warm-up step runs the mesh's collectives
    why = None
    if mesh is not None and mesh.size() > 1 and shard.any_rank(key != graph.key, dev) \
            and key == graph.key:
        why = "another_rank"
    return graph.replay(idx, key, body, _state_tensors(model, opt_state), lock, why)


@dataclasses.dataclass
class Trainer:
    scene: Scene
    config: Config
    output_dir: Optional[Path] = None
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        cfg = self.config
        if self.scene.cameras:
            self.camera: Camera = next(iter(self.scene.cameras.values()))
        else:
            self.camera = next(iter(self.scene.keyframes.values())).camera
        _, self.cameras_extent = self.scene.nerfpp_norm()
        self.raster_cfg = raster_config_from(cfg)
        self.lr_cfg = opt_ops.LRConfig(
            position_lr_init=cfg.opt.position_lr_init,
            position_lr_final=cfg.opt.position_lr_final,
            position_lr_delay_mult=cfg.opt.position_lr_delay_mult,
            position_lr_max_steps=cfg.opt.position_lr_max_steps,
            feature_lr=cfg.opt.feature_lr,
            opacity_lr=cfg.opt.opacity_lr,
            scaling_lr=cfg.opt.scaling_lr,
            rotation_lr=cfg.opt.rotation_lr,
        )
        self.bg = torch.full(
            (3,), 1.0 if cfg.model.white_background else 0.0, device=self.device
        )
        self.sampler = KeyframeSampler(
            self.scene, cfg.mapper.new_keyframe_times_of_use, self.seed
        )
        self.iteration = 0
        self.ema_loss = 0.0
        self.last_loss = 0.0
        # capacity-pressure counters: instances dropped by max_instances /
        # aligned_cap are counted, never silent
        self.total_overflow = 0
        self.total_truncated = 0
        self._pending_losses = []
        self.peak_memory = PeakMemoryTracker(self.device)
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.model: Optional[GaussianModel] = None
        self.opt_state: Optional[opt_ops.AdamState] = None
        # the pyramid's device copies per (fid, level width); the undistort
        # masks per (camera, level w, level h)
        self._gt_cache: Dict[tuple, torch.Tensor] = {}
        self._mask_cache: Dict[tuple, Optional[torch.Tensor]] = {}
        self._pose_cache: Dict[int, tuple] = {}
        # one device: no mesh, one data row (`ParallelTrainer` sets its own)
        self.mesh = None
        self.n_data = 1
        # ({fid: row}, (N, 4, 4) poses, (N, 3) campos) of every keyframe
        self._poses = None
        # the ground truths loaded, in the order loaded: ({fid: row}, (rows,
        # 3, H, W) bank); the keyframes each data row has drawn (`_draw`
        # records them); times the bank grew
        self._gt_bank = ({}, None)
        self._drawn: List[set] = [set()]
        self.gt_bank_grows = 0
        self.step_graph = StepGraph()  # the window's graph on the card
        self.lock = FairLock()
        # the stage totals `drain_losses` last read (`profiling.stage_totals`)
        # and, at the last `trace_line`: the iteration, those totals and the
        # counters
        self.stage_totals: Dict[str, Tuple[float, int]] = {}
        self._traced = (self.iteration, {}, profiling.counters())

    # -- setup --

    def init_from_sfm(self):
        pts = torch.as_tensor(self.scene.points, dtype=torch.float32, device=self.device)
        cols = torch.as_tensor(self.scene.colors, dtype=torch.float32, device=self.device)
        d2 = mean_sq_knn_dist(pts)
        self.model = from_pcd(pts, cols, self.config.tpu.capacity, d2)
        self.opt_state = opt_ops.init_adam(self.model.params())
        if self.config.tpu.max_instances == 0:
            self._autosize_capacities()

    @torch.no_grad()
    def _autosize_capacities(self, sample_views: int = 4):
        """Size `max_instances` from the instance emission of a few sampled
        views, scaled by the densification growth headroom plus 25%, rounded
        to a power of two (``Tpu.max_instances: 0`` = auto); and the
        live-slab cap ``aligned_cap`` from the same estimate."""
        from omnigs_torch.ops.binning import _precull_masks
        from omnigs_torch.ops.preprocess import preprocess, tile_grid

        fids = sorted(self.scene.keyframes)
        step = max(len(fids) // sample_views, 1)
        gx, gy = tile_grid(self.camera)
        worst = 0
        m = self.model
        for fid in fids[::step][:sample_views]:
            kf = self.scene.keyframes[fid]
            prep = preprocess(
                m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(),
                m.get_features(), self.camera,
                torch.as_tensor(kf.viewmatrix, device=self.device),
                torch.as_tensor(kf.campos, device=self.device), 0,
                active_mask=m.active, tight_culling=self.raster_cfg.tight_culling,
            )
            if self.raster_cfg.tile_culling:
                tiles = _precull_masks(prep, gx)[2]
            else:
                tiles = prep.tiles_touched
            worst = max(worst, int(torch.sum(tiles, dtype=torch.int64)))
        growth = self.config.tpu.capacity / max(int(m.num_active), 1)
        est = int(worst * min(growth, 8.0) * 1.25)
        max_inst = 1 << max(16, math.ceil(math.log2(max(est, 1))))
        max_inst = min(max_inst, 1 << 23)
        self.config.tpu.max_instances = max_inst
        cap8 = None
        if self.config.tpu.aligned_cap == 0 and self.raster_cfg.backend == "pallas":
            # estimated survivors + the 8-granular padding bound, rounded up
            # to a 2^16 multiple; trimmed tiles are counted in `truncated`
            cap8 = est + 8 * gx * gy
            cap8 = min(-(-cap8 // (1 << 16)) * (1 << 16), max_inst)
            self.config.tpu.aligned_cap = cap8
        self.raster_cfg = raster_config_from(self.config)
        print(
            f"[autosize] max_instances={max_inst} aligned_cap={cap8} "
            f"(measured worst emission {worst}, growth cap "
            f"{min(growth, 8.0):.1f}x)",
            flush=True,
        )

    @property
    def sh_degree(self) -> int:
        """+1 every 1000 iterations up to the configured maximum."""
        return min(self.iteration // 1000, self.config.model.sh_degree)

    def _gt(self, kf, level_camera=None) -> torch.Tensor:
        """The keyframe's (3, H, W) ground truth on the device, at the
        pyramid level's size (cv2 INTER_AREA on the host) when given, kept
        per (keyframe, level): the pyramid's source (the trainer otherwise
        reads the banks)."""
        key = (kf.fid, None if level_camera is None else level_camera.width)
        if key not in self._gt_cache:
            img = kf.image
            if level_camera is not None and level_camera.width != kf.camera.width:
                import cv2

                img = cv2.resize(
                    np.asarray(img), (level_camera.width, level_camera.height),
                    interpolation=cv2.INTER_AREA,
                )
            img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
            # loaders produce HWC; the image convention is channels-first
            self._gt_cache[key] = img.permute(2, 0, 1).contiguous()
        return self._gt_cache[key]

    # -- the banks --

    def _pose_bank(self):
        """({fid: row}, (N, 4, 4) poses, (N, 3) campos) of every keyframe on
        the device, built again when the keyframe set changes."""
        fids = sorted(self.scene.keyframes)
        if self._poses is None or list(self._poses[0]) != fids:
            kfs = [self.scene.keyframes[f] for f in fids]
            dev = torch.device(self.device)
            self._poses = (
                {f: i for i, f in enumerate(fids)},
                torch.as_tensor(np.stack([k.viewmatrix for k in kfs]), device=dev),
                torch.as_tensor(np.stack([k.campos for k in kfs]), device=dev),
            )
        return self._poses

    def _bank_rows(self, views: List[list]) -> np.ndarray:
        """The (k, 2, V) rows of k iterations' views (each step's V pose
        rows, then its V ground-truth rows). When every keyframe's ground
        truth fits ``Tpu.gt_bank_mb`` MiB on the device, the bank holds them
        all, loaded at its first use: it never grows, so a window's graph is
        never captured again for it. Otherwise a keyframe new to this
        rank's data row is loaded into the bank when drawn (only this row's
        images are ever loaded), which holds a data row's share of the
        keyframes, ⌈N / n_data⌉ rows, and doubles (up to N) when a data row
        has drawn more: every rank tracks every row's draws, so all grow
        together and a sharded graph is captured again on all ranks. That
        bank lives on the device while its rows fit the budget, else on the
        host (pinned beside a CUDA device), and a window uploads its
        rows."""
        fid_row, _, _ = self._pose_bank()
        rows, bank = self._gt_bank
        n = len(fid_row)
        kf = next(iter(self.scene.keyframes.values()))
        h, w = np.asarray(kf.image).shape[:2]
        budget = self.config.tpu.gt_bank_mb * (1 << 20)
        every = n * 3 * h * w * 4 <= budget
        if every:
            cap = n
        else:
            cap = -(-n // self.n_data) if bank is None else bank.shape[0]
            need = max(len(d) for d in self._drawn)
            while cap < need:
                cap = min(2 * cap, max(n, need))
        if bank is None or cap != bank.shape[0]:
            dev = torch.device(self.device)
            on_device = cap * 3 * h * w * 4 <= budget
            new = torch.empty((cap, 3, h, w), dtype=torch.float32,
                              device=dev if on_device else "cpu",
                              pin_memory=not on_device and dev.type == "cuda")
            if bank is not None:
                new[: len(rows)].copy_(bank[: len(rows)])
                self.gt_bank_grows += 1
            bank = new
            profiling.count("bank_builds")
        load = [self.scene.keyframes[f] for f in fid_row] if every else []
        for kf in load + [kf for step in views for kf in step]:
            if kf.fid not in rows:
                # loaders produce HWC; the image convention is channels-first
                img = torch.as_tensor(np.asarray(kf.image), dtype=torch.float32)
                bank[len(rows)].copy_(img.permute(2, 0, 1))
                rows[kf.fid] = len(rows)
        self._gt_bank = (rows, bank)
        return np.array([[[fid_row[kf.fid] for kf in step], [rows[kf.fid] for kf in step]]
                         for step in views], np.int64)

    def _mask(self, camera, level_camera=None) -> Optional[torch.Tensor]:
        """The camera's (H, W) undistort mask on the device at the pyramid
        level's size (cv2's default interpolation), or None (always on a
        mesh: the sharded trainer trains without it, as JAX's does)."""
        if self.mesh is not None:
            return None
        lc = level_camera or camera
        key = (camera, lc.width, lc.height)
        if key not in self._mask_cache:
            m = self.scene.undistort_mask(camera)
            if m is not None:
                if (lc.width, lc.height) != (camera.width, camera.height):
                    import cv2

                    m = cv2.resize(np.asarray(m), (lc.width, lc.height))
                m = torch.as_tensor(m, device=self.device)
            self._mask_cache[key] = m
        return self._mask_cache[key]

    # -- the loop --

    def _schedule(self, it: int):
        """(in_densify_phase, do_densify, do_reset) of iteration ``it``."""
        cfg = self.config
        in_densify_phase = it < cfg.opt.densify_until_iter
        do_densify = (
            in_densify_phase
            and it > cfg.opt.densify_from_iter
            and it % cfg.opt.densification_interval == 0
        )
        do_reset = in_densify_phase and bool(
            (
                cfg.opt.opacity_reset_interval
                and it % cfg.opt.opacity_reset_interval == 0
            )
            or (cfg.model.white_background and it == cfg.opt.densify_from_iter)
        )
        return in_densify_phase, do_densify, do_reset

    def _densify_kwargs(self, it: int) -> dict:
        cfg = self.config
        return dict(
            max_grad=cfg.opt.densify_grad_threshold,
            min_opacity=cfg.opt.densify_min_opacity,
            extent=self.cameras_extent,
            max_screen_size=20 if it > cfg.opt.prune_big_point_after_iter else 0,
            percent_dense=cfg.opt.percent_dense,
            prune_by_extent=cfg.opt.prune_by_extent,
            iteration=it,
        )

    def _pose(self, kf):
        """The keyframe's (viewmatrix, campos) on the device, cached per
        keyframe (the pyramid's source)."""
        if kf.fid not in self._pose_cache:
            self._pose_cache[kf.fid] = (
                torch.as_tensor(kf.viewmatrix, device=self.device),
                torch.as_tensor(kf.campos, device=self.device),
            )
        return self._pose_cache[kf.fid]

    def _skip_bottom_px(self, camera) -> int:
        ratio = self.config.opt.skip_bottom_ratio
        return int(round(camera.height * ratio)) if ratio > 0 else 0

    def _step_kwargs(self, camera, update_stats: bool) -> dict:
        """The keywords a step at the current iteration takes, but the
        event flags."""
        return dict(
            camera=camera,
            sh_degree=self.sh_degree,
            raster_cfg=self.raster_cfg,
            lr_cfg=self.lr_cfg,
            spatial_lr_scale=self.cameras_extent,
            bg=self.bg,
            lambda_dssim=self.config.opt.lambda_dssim,
            skip_bottom_px=self._skip_bottom_px(camera),
            update_stats=update_stats,
        )

    def _pyramid_on(self) -> bool:
        """Whether the coarse-to-fine pyramid trains (never on a mesh, as in
        the JAX package)."""
        cfg = self.config.pyramid
        return bool(cfg.do and cfg.num_sub_levels > 0) and self.mesh is None

    def _level_camera(self, kf):
        """The camera of this use of ``kf``: under the pyramid, its
        sub-level's while the level's uses last, else the keyframe's."""
        cfg = self.config.pyramid
        camera = kf.camera
        if not self._pyramid_on():
            return camera
        if kf.pyramid_budgets is None:
            kf.pyramid_budgets = [cfg.sub_level_times_of_use] * cfg.num_sub_levels
        level = kf.current_pyramid_level(cfg.num_sub_levels)
        if level < cfg.num_sub_levels:
            f = cfg.factor(level)
            camera = dataclasses.replace(
                camera,
                width=max(int(camera.width * f), 16),
                height=max(int(camera.height * f), 16),
            )
        return camera

    def _draw(self) -> list:
        """One iteration's keyframes from the times-of-use sampler → this
        rank's views: one keyframe on one device."""
        kf = self.sampler.sample()
        self._drawn[0].add(kf.fid)
        return [kf]

    def _densify(self, it: int):
        densify_ops.densify_and_prune(
            self.model, self.opt_state, self.generator, **self._densify_kwargs(it)
        )

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        with self.lock:
            cfg = self.config
            self.iteration += 1
            it = self.iteration
            views = self._draw()
            in_densify_phase, do_densify, do_reset = self._schedule(it)
            kf = views[0]
            camera = self._level_camera(kf)
            if self._pyramid_on():
                vm, campos = self._pose(kf)
                vms, cps, gts = vm[None], campos[None], self._gt(kf, camera)[None]
            else:
                pose_rows, gt_rows = self._bank_rows([views])[0]
                _, vms, cps = self._pose_bank()
                vms, cps = _bank_views(vms, pose_rows), _bank_views(cps, pose_rows)
                gts = _bank_views(self._gt_bank[1], gt_rows, self.device)
            aux = train_step(
                self.model,
                self.opt_state,
                vms,
                cps,
                gts,
                # a fill kernel, not a host → device copy
                torch.full((), it, dtype=torch.int32, device=self.device),
                self._mask(kf.camera, camera),
                mesh=self.mesh,
                # reference quirk: replaced tensors skip their Adam update
                do_adam=not do_densify and it < cfg.opt.max_num_iterations,
                skip_opacity_update=do_reset,
                **self._step_kwargs(camera, in_densify_phase),
            )

            dev = self.model.xyz.device
            if do_densify:
                profiling.mark("densify", dev)
                self._densify(it)
            if do_reset:
                profiling.mark("reset", dev)
                densify_ops.reset_opacity(self.model, self.opt_state)
            profiling.mark("end", dev)
            if do_densify or do_reset:
                # where the densification temporaries peak
                self.peak_memory.sample()

            # the loss stays on the device: reading it here would sync every step
            self._pending_losses.append(
                (aux["loss"], aux["overflow"], aux["truncated"])
            )
            if len(self._pending_losses) > 512:
                self.drain_losses()
            return aux

    def live_gaussians(self) -> int:
        """The model's live Gaussians (reading the count syncs)."""
        with profiling.host_wait("live_gaussians"):
            return int(self.model.num_active)

    def drain_losses(self) -> float:
        """Fold the queued device-side losses (a window's (k,) losses or a
        step's loss, in the order they were queued) into the host EMA
        (0.4/0.6) and total the capacity-pressure counters; returns the
        last loss. Where it waits for the card anyway, it reads the device's
        stage totals into `stage_totals`."""
        if self._pending_losses:
            pend, self._pending_losses = self._pending_losses, []
            with profiling.host_wait("drain"):
                # a window's (k,) losses and a single step's () loss, in order
                losses = torch.cat([x.reshape(-1) for x, _, _ in pend]).tolist()
            counters = torch.stack(
                [torch.stack([ov, tr]).to(torch.int64) for _, ov, tr in pend]
            ).sum(0).tolist()
            self.stage_totals = profiling.stage_totals(pend[0][0].device)
            for v in losses:
                self.last_loss = v
                self.ema_loss = 0.4 * v + 0.6 * self.ema_loss
            self.total_overflow += counters[0]
            self.total_truncated += counters[1]
            if self.total_overflow or self.total_truncated:
                import warnings

                warnings.warn(
                    "capacity pressure: "
                    f"{self.total_truncated} instances truncated / "
                    f"{self.total_overflow} overflowed so far — raise "
                    "Tpu.max_instances / Tpu.aligned_cap",
                    stacklevel=2,
                )
        return self.last_loss

    # -- multi-step windows --

    def _next_event_iter(self, it: int) -> int:
        """First iteration > ``it`` that needs the single-step path (densify,
        opacity reset, SH-degree bump, phase boundary, final iteration)."""
        cfg = self.config

        def nxt(m):
            return (it // m + 1) * m

        events = [nxt(1000)]  # SH degree bump cadence
        if cfg.opt.densification_interval:
            events.append(nxt(cfg.opt.densification_interval))
        if cfg.opt.opacity_reset_interval:
            events.append(nxt(cfg.opt.opacity_reset_interval))
        for b in (
            cfg.opt.densify_from_iter,
            cfg.opt.densify_until_iter,
            cfg.opt.max_num_iterations,
        ):
            if b > it:
                events.append(b)
        return min(events)

    def _window_len(self, max_steps: int) -> int:
        """How many of ``max_steps`` iterations a window takes now: up to the
        next event iteration, none under the pyramid."""
        if self._pyramid_on():
            return 0
        it = self.iteration
        return max(min(max_steps, self._next_event_iter(it) - 1 - it), 0)

    def train_window(self, max_steps: int) -> int:
        """Take up to ``max_steps`` iterations before the next event
        iteration through `train_steps_fused` and return how many were
        taken: 0 means the next iteration is an event (call
        `train_iteration`), or the pyramid is on. The window draws its
        keyframes as that many `train_iteration` calls would (on a mesh
        every rank draws them all, so the ranks stay in lock-step); none of
        its steps densifies or resets, each steps Adam, and the statistics
        accumulate as in the JAX trainer's scanned window. In `window_mode`
        "graph" the steps are replays of `step_graph`, bitwise the eager
        iterations; the lock is held for each."""
        k = self._window_len(max_steps)
        if k == 0:
            return 0
        with self.lock:
            rows = self._bank_rows([self._draw() for _ in range(k)])
        _, vms, cps = self._pose_bank()
        it = self.iteration
        # a window ends before every event, so none of its steps leaves
        # the densify phase: its last step's phase is every step's
        kw = self._step_kwargs(self.camera, self._schedule(it + k)[0])
        losses, overflow, truncated = train_steps_fused(
            self.model, self.opt_state, vms, cps, self._gt_bank[1], it, self._mask(self.camera),
            rows=rows, mesh=self.mesh, graph=self.step_graph, lock=self.lock, **kw,
        )
        self.iteration = it + k
        self._pending_losses.append((losses, overflow, truncated))
        if len(self._pending_losses) > 512:
            self.drain_losses()
        return k

    # -- live-tunable training parameters (the reference's
    #    `VariableParameters`) --

    VARIABLE_PARAMS = (
        ("position_lr_init", "lr"),
        ("feature_lr", "lr"),
        ("opacity_lr", "lr"),
        ("scaling_lr", "lr"),
        ("rotation_lr", "lr"),
        ("percent_dense", "opt"),
        ("lambda_dssim", "opt"),
        ("opacity_reset_interval", "opt"),
        ("densify_grad_threshold", "opt"),
        ("densification_interval", "opt"),
        ("new_keyframe_times_of_use", "mapper"),
    )

    def get_variable_parameters(self) -> Dict[str, float]:
        out = {}
        for name, kind in self.VARIABLE_PARAMS:
            if kind == "lr":
                out[name] = getattr(self.lr_cfg, name)
            elif kind == "opt":
                out[name] = getattr(self.config.opt, name)
            else:
                out[name] = getattr(self.config.mapper, name)
        return out

    def set_variable_parameters(self, updates: Dict[str, float]):
        """Apply live updates mid-training (each value cast to the type of
        the one it replaces); an unknown name raises `KeyError`."""
        kinds = dict(self.VARIABLE_PARAMS)
        lr_updates = {}
        for name, val in updates.items():
            if name not in kinds:
                raise KeyError(name)
            kind = kinds[name]
            if kind == "lr":
                lr_updates[name] = type(getattr(self.lr_cfg, name))(val)
            elif kind == "opt":
                cur = getattr(self.config.opt, name)
                setattr(self.config.opt, name, type(cur)(val))
            else:
                cur = getattr(self.config.mapper, name)
                setattr(self.config.mapper, name, type(cur)(val))
                if name == "new_keyframe_times_of_use":
                    self.sampler.times_of_use = int(val)
        if lr_updates:
            self.lr_cfg = dataclasses.replace(self.lr_cfg, **lr_updates)

    # -- full-state checkpoints --

    def save_checkpoint(self, path):
        from omnigs_torch.train.checkpoint import save_checkpoint

        save_checkpoint(path, self.model, self.opt_state, self.iteration)

    def load_checkpoint(self, path):
        from omnigs_torch.train.checkpoint import load_checkpoint

        self.model, self.opt_state, self.iteration = load_checkpoint(
            path, self.config.tpu.capacity, device=self.device
        )

    def train(
        self,
        num_iterations: Optional[int] = None,
        log_every: int = 0,
        fuse: Optional[int] = None,
    ):
        """Run ``num_iterations`` (the config's maximum by default) in
        windows of up to ``fuse`` steps (``Tpu.fuse_steps``), logging every
        ``log_every`` iterations."""
        n = num_iterations or self.config.opt.max_num_iterations
        fuse = self.config.tpu.fuse_steps if fuse is None else fuse
        t0 = time.time()
        end = self.iteration + n
        while self.iteration < end:
            budget = end - self.iteration
            if log_every:
                budget = min(budget, log_every - self.iteration % log_every)
            took = self.train_window(min(budget, fuse)) if fuse > 1 else 0
            if took == 0:
                self.train_iteration()
            if log_every and self.iteration % log_every == 0:
                self.drain_losses()
                pressure = (
                    f" truncated={self.total_truncated}"
                    f" overflow={self.total_overflow}"
                    if self.total_truncated or self.total_overflow
                    else ""
                )
                live = self.live_gaussians()
                print(
                    f"{self._rank_tag()}iter {self.iteration}: loss={self.last_loss:.4f} "
                    f"ema={self.ema_loss:.4f} "
                    f"n_active={live} "
                    f"({(time.time() - t0):.1f}s)" + pressure + " | " + self.trace_line(),
                    flush=True,
                )
        return self.model

    def _rank_tag(self) -> str:
        """What leads a log line: nothing on one device."""
        return ""

    def trace_line(self) -> str:
        """The stage marks and counters since the last call: the device ms
        a step of each stage (the `stage_totals` that `drain_losses` last
        read, over the iterations since); the graph captures with their
        reasons, the warm-up steps, replays and bank builds; on a mesh whose
        collectives ran, their count and MB a step by kind; the host's
        waits for the replay queue (its back-pressure, expected); and the
        host's waits at each sync point (count / host ms). The launches of
        each kernel wrapper that launched follow the counters (a replay
        counts the launches its graph holds)."""
        it, seen, before = self._traced
        now = profiling.counters()
        steps = max(self.iteration - it, 1)
        stages = " ".join(
            f"{s}={(ms - seen.get(s, (0.0, 0))[0]) / steps:.2f}"
            for s, (ms, n) in self.stage_totals.items() if n > seen.get(s, (0.0, 0))[1]
        )
        reasons = {r: c - before["capture_reasons"].get(r, 0)
                   for r, c in now["capture_reasons"].items()}
        reasons = ",".join(f"{r}" if c == 1 else f"{r}x{c}" for r, c in reasons.items() if c)
        counts = " ".join(f"{k}={now[k] - before[k]}" + (f" ({reasons})" if k == "captures"
                                                          and reasons else "")
                          for k in profiling.COUNTER_NAMES)
        moved = {k: now[k] - before[k] for k in profiling.COLLECTIVE_NAMES}
        if moved["collectives"]:
            counts += f" collectives={moved['collectives']} " + " ".join(
                f"{k[:-len('_bytes')]}={v / steps / 1e6:.1f}MB/step"
                for k, v in moved.items() if k.endswith("_bytes") and v)
        ran = {k: v - before["launches"].get(k, 0) for k, v in now["launches"].items()
               if v != before["launches"].get(k, 0)}
        if ran:
            counts += " launches " + " ".join(f"{k}={v}" for k, v in ran.items())

        def waits(site):
            n = now["host_waits"].get(site, 0) - before["host_waits"].get(site, 0)
            ms = now["host_wait_ms"].get(site, 0.0) - before["host_wait_ms"].get(site, 0.0)
            return f"{site}={n}/{ms:.1f}ms" if n else ""

        syncs = " ".join(filter(None, (waits(site) for site in sorted(now["host_waits"])
                                       if site != "replay_queue")))
        self._traced = (self.iteration, self.stage_totals, now)
        return (f"ms/step {stages or '-'} | {counts} | {waits('replay_queue') or 'replay_queue=0'}"
                f" | syncs {syncs or '-'}")
