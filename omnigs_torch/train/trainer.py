"""Training orchestration — the `GaussianMapper` analog.

Counterpart of `omnigs_tpu/train/trainer.py` (`train_step` and the
single-step `Trainer` loop):

* per iteration: a random keyframe with a times-of-use budget, the SH
  degree raised every 1000 iterations, the log-lerp xyz LR, render →
  bottom-cropped 0.8·L1 + 0.2·(1−SSIM) → backward (the segmented backward
  kernel, `ops/composite_seg.py`) → densification statistics → Adam;
* densify/prune every ``densification_interval`` iterations inside
  (densify_from_iter, densify_until_iter), opacity reset every
  ``opacity_reset_interval``;
* the reference quirks the JAX trainer keeps: a densify iteration skips
  Adam, and a reset iteration zeroes the opacity LR.

`train_step` updates the model's parameters, statistics and the Adam state
in place (the JAX step returns new ones). Nothing in a step reads a value
back to the host: losses and capacity counters stay on the device and
`drain_losses` folds them in later.

Not ported yet, raising `NotImplementedError`: the coarse-to-fine pyramid
and checkpoints (ROADMAP queue 1 item 5), and the fused multi-step windows
(`train_window`), which exist to cut TPU dispatches.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional

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


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to omnigs_torch yet (ROADMAP {item})"
    )


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
        self._gt_cache: Dict[int, torch.Tensor] = {}
        self._mask_cache: Dict[Camera, Optional[torch.Tensor]] = {}
        self._pose_cache: Dict[int, tuple] = {}

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

    def _gt(self, kf) -> torch.Tensor:
        """The keyframe's (3, H, W) ground truth on the device (cached)."""
        if kf.fid not in self._gt_cache:
            img = torch.as_tensor(kf.image, dtype=torch.float32, device=self.device)
            # loaders produce HWC; the image convention is channels-first
            self._gt_cache[kf.fid] = img.permute(2, 0, 1).contiguous()
        return self._gt_cache[kf.fid]

    def _mask(self, camera) -> Optional[torch.Tensor]:
        """The camera's (H, W) undistort mask on the device, or None."""
        if camera not in self._mask_cache:
            m = self.scene.undistort_mask(camera)
            self._mask_cache[camera] = (
                None if m is None else torch.as_tensor(m, device=self.device)
            )
        return self._mask_cache[camera]

    # -- the loop --

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        cfg = self.config
        self.iteration += 1
        it = self.iteration
        kf = self.sampler.sample()

        in_densify_phase = it < cfg.opt.densify_until_iter
        do_densify = (
            in_densify_phase
            and it > cfg.opt.densify_from_iter
            and it % cfg.opt.densification_interval == 0
        )
        do_reset = in_densify_phase and (
            (
                cfg.opt.opacity_reset_interval
                and it % cfg.opt.opacity_reset_interval == 0
            )
            or (cfg.model.white_background and it == cfg.opt.densify_from_iter)
        )
        if cfg.pyramid.do and cfg.pyramid.num_sub_levels > 0:
            raise _unported("the coarse-to-fine pyramid", "queue 1 item 5")

        camera = kf.camera
        skip_bottom_px = (
            int(round(camera.height * cfg.opt.skip_bottom_ratio))
            if cfg.opt.skip_bottom_ratio > 0
            else 0
        )
        if kf.fid not in self._pose_cache:
            self._pose_cache[kf.fid] = (
                torch.as_tensor(kf.viewmatrix, device=self.device),
                torch.as_tensor(kf.campos, device=self.device),
            )
        vm, campos = self._pose_cache[kf.fid]
        # a fill kernel, not a host → device copy
        step = torch.full((), it, dtype=torch.int32, device=self.device)
        aux = train_step(
            self.model,
            self.opt_state,
            vm,
            campos,
            self._gt(kf),
            step,
            self._mask(camera),
            camera=camera,
            sh_degree=self.sh_degree,
            raster_cfg=self.raster_cfg,
            lr_cfg=self.lr_cfg,
            spatial_lr_scale=self.cameras_extent,
            bg=self.bg,
            lambda_dssim=cfg.opt.lambda_dssim,
            skip_bottom_px=skip_bottom_px,
            update_stats=in_densify_phase,
            # reference quirk: replaced tensors skip their Adam update
            do_adam=not do_densify and it < cfg.opt.max_num_iterations,
            skip_opacity_update=do_reset,
        )

        if do_densify:
            size_threshold = 20 if it > cfg.opt.prune_big_point_after_iter else 0
            densify_ops.densify_and_prune(
                self.model,
                self.opt_state,
                self.generator,
                max_grad=cfg.opt.densify_grad_threshold,
                min_opacity=cfg.opt.densify_min_opacity,
                extent=self.cameras_extent,
                max_screen_size=size_threshold,
                percent_dense=cfg.opt.percent_dense,
                prune_by_extent=cfg.opt.prune_by_extent,
                iteration=it,
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

    def train_window(self, max_steps: int) -> int:
        raise _unported(
            "train_window (fused multi-step windows)", "queue 1 item 5"
        )

    def save_checkpoint(self, path):
        raise _unported("checkpoints", "queue 1 item 5")

    def load_checkpoint(self, path):
        raise _unported("checkpoints", "queue 1 item 5")
