"""Training orchestration — the `GaussianMapper` analog.

Counterpart of `omnigs_tpu/train/trainer.py` (`train_step` and the
single-step `Trainer` loop):

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

`train_step` updates the model's parameters, statistics and the Adam state
in place (the JAX step returns new ones). Nothing in a step reads a value
back to the host: losses and capacity counters stay on the device and
`drain_losses` folds them in later.

`Trainer.train_window(k)` takes up to k steps between event iterations
(densify, opacity reset, SH bump, phase boundaries), as the JAX trainer's
scanned window does; here it is a loop over `train_iteration`. `train`,
the live-tunable parameters and full-state checkpoints
(`train/checkpoint.py`) complete the API the training CLI calls.

Under the coarse-to-fine pyramid (``GausPyramid.do``) each keyframe's
first ``sub_level_times_of_use`` uses of each sub-level train at
0.5^(L−l) of the camera's size, with the ground truth resized by cv2's
INTER_AREA and the undistort mask by cv2's default on the host, as the
JAX trainer does; `train_window` then takes no steps. A pinhole keyframe
raises the JAX package's ValueError at its first step: neither trainer
passes `full_proj`.

`Trainer.lock` is held for the whole of each `train_iteration` (the Adam
step, densify/prune and the opacity reset included): the live viewer
(`viewer/live.py`) renders and reads its frame back under it, so a frame
never sees a half-applied step, and the render, which draws no random
number and writes no state, leaves the trajectory as it was. The lock is
first come, first served: a plain lock released and taken again by the
training loop would keep a waiting frame out for many iterations.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from omnigs_torch.cameras import Camera
from omnigs_torch.config import Config, raster_config_from
from omnigs_torch.model import densify as densify_ops
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import GaussianModel, from_pcd
from omnigs_torch.ops import loss as loss_ops
from omnigs_torch.ops.knn import mean_sq_knn_dist
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scene.scene import KeyframeSampler, Scene
from omnigs_torch.train.renderer import render_model
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


def train_step(
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    gt_image: torch.Tensor,
    step,
    mask: Optional[torch.Tensor] = None,
    *,
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
    """One train iteration in place: render → loss → backward → stats →
    Adam. ``step`` (int or () tensor) sets the xyz LR. Returns the aux
    tensors (loss, l1, radii, image, overflow, truncated), on the device."""
    dev = model.xyz.device
    params = model.params()
    names = list(params)
    ndc = torch.zeros(model.capacity, 2, device=dev, requires_grad=True)
    res = render_model(
        model, camera, viewmatrix, campos, bg, sh_degree, raster_cfg,
        means2d_ndc=ndc,
    )
    pred = res.image  # (3, H, W)
    if mask is not None:
        # the undistort mask multiplies the RENDERED image only
        pred = pred * mask
    gt = gt_image
    if skip_bottom_px > 0:
        pred = pred[:, :-skip_bottom_px]
        gt = gt[:, :-skip_bottom_px]
    l1 = loss_ops.l1_loss(pred, gt)
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * (
        1.0 - loss_ops.ssim(pred, gt)
    )
    *grads, ndc_grad = torch.autograd.grad(
        total, [params[k] for k in names] + [ndc], allow_unused=True
    )
    grads = {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads)
    }

    if update_stats:
        densify_ops.add_densification_stats(model, ndc_grad, res.radii.detach())
    if do_adam:
        if not torch.is_tensor(step):
            step = torch.full((), step, dtype=torch.int32, device=dev)
        lrs = opt_ops.group_lrs(lr_cfg, spatial_lr_scale, step)
        if skip_opacity_update:
            lrs["opacity"] = 0.0
        opt_ops.adam_step(params, grads, opt_state, lrs, model.active)
    return dict(
        loss=total.detach(),
        l1=l1.detach(),
        radii=res.radii.detach(),
        image=res.image.detach(),
        overflow=res.overflow,
        truncated=res.truncated,
    )


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
        # device copies per (fid, level width) and (camera, level w, level h)
        self._gt_cache: Dict[tuple, torch.Tensor] = {}
        self._mask_cache: Dict[tuple, Optional[torch.Tensor]] = {}
        self._pose_cache: Dict[int, tuple] = {}
        self.lock = FairLock()

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
        pyramid level's size (cv2 INTER_AREA on the host) when given."""
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

    def _mask(self, camera, level_camera=None) -> Optional[torch.Tensor]:
        """The camera's (H, W) undistort mask on the device at the pyramid
        level's size (cv2's default interpolation), or None."""
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
        """The keyframe's (viewmatrix, campos) on the device, cached."""
        if kf.fid not in self._pose_cache:
            self._pose_cache[kf.fid] = (
                torch.as_tensor(kf.viewmatrix, device=self.device),
                torch.as_tensor(kf.campos, device=self.device),
            )
        return self._pose_cache[kf.fid]

    def _skip_bottom_px(self, camera) -> int:
        ratio = self.config.opt.skip_bottom_ratio
        return int(round(camera.height * ratio)) if ratio > 0 else 0

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        with self.lock:
            cfg = self.config
            self.iteration += 1
            it = self.iteration
            kf = self.sampler.sample()
            in_densify_phase, do_densify, do_reset = self._schedule(it)

            # coarse-to-fine pyramid: the level camera of this keyframe's use
            camera = kf.camera
            if cfg.pyramid.do and cfg.pyramid.num_sub_levels > 0:
                if kf.pyramid_budgets is None:
                    kf.pyramid_budgets = [
                        cfg.pyramid.sub_level_times_of_use
                    ] * cfg.pyramid.num_sub_levels
                level = kf.current_pyramid_level(cfg.pyramid.num_sub_levels)
                if level < cfg.pyramid.num_sub_levels:
                    f = cfg.pyramid.factor(level)
                    camera = dataclasses.replace(
                        camera,
                        width=max(int(camera.width * f), 16),
                        height=max(int(camera.height * f), 16),
                    )
            vm, campos = self._pose(kf)
            # a fill kernel, not a host → device copy
            step = torch.full((), it, dtype=torch.int32, device=self.device)
            aux = train_step(
                self.model,
                self.opt_state,
                vm,
                campos,
                self._gt(kf, camera),
                step,
                self._mask(kf.camera, camera),
                camera=camera,
                sh_degree=self.sh_degree,
                raster_cfg=self.raster_cfg,
                lr_cfg=self.lr_cfg,
                spatial_lr_scale=self.cameras_extent,
                bg=self.bg,
                lambda_dssim=cfg.opt.lambda_dssim,
                skip_bottom_px=self._skip_bottom_px(camera),
                update_stats=in_densify_phase,
                # reference quirk: replaced tensors skip their Adam update
                do_adam=not do_densify and it < cfg.opt.max_num_iterations,
                skip_opacity_update=do_reset,
            )

            if do_densify:
                densify_ops.densify_and_prune(
                    self.model, self.opt_state, self.generator,
                    **self._densify_kwargs(it),
                )
            if do_reset:
                densify_ops.reset_opacity(self.model, self.opt_state)
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
        return int(self.model.num_active)

    def drain_losses(self) -> float:
        """Fold the queued device-side losses into the host EMA (0.4/0.6)
        and total the capacity-pressure counters; returns the last loss."""
        if self._pending_losses:
            pend, self._pending_losses = self._pending_losses, []
            losses = torch.stack([x for x, _, _ in pend]).tolist()
            counters = torch.stack(
                [torch.stack([ov, tr]).to(torch.int64) for _, ov, tr in pend]
            ).sum(0).tolist()
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

    def train_window(self, max_steps: int) -> int:
        """Take up to ``max_steps`` iterations before the next event
        iteration and return how many were taken: 0 means the next
        iteration is an event (call `train_iteration`), or the pyramid is
        on. A window is that many `train_iteration` calls: it ends before
        every event, so none of its steps densifies or resets, each steps
        Adam, and the statistics accumulate exactly as the JAX trainer's
        scanned window accumulates them."""
        cfg = self.config
        if cfg.pyramid.do and cfg.pyramid.num_sub_levels > 0:
            return 0
        it = self.iteration
        k = min(max_steps, self._next_event_iter(it) - 1 - it)
        if k <= 0:
            return 0
        for _ in range(k):
            self.train_iteration()
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
                print(
                    f"iter {self.iteration}: loss={self.last_loss:.4f} "
                    f"ema={self.ema_loss:.4f} "
                    f"n_active={self.live_gaussians()} "
                    f"({(time.time() - t0):.1f}s)" + pressure,
                    flush=True,
                )
        return self.model
