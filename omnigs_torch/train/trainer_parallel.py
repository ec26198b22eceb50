"""Multi-device trainer: view-parallel data rows × a Gaussian-sharded model.

Counterpart of `omnigs_tpu/train/trainer_parallel.py`. One process per
rank, each holding one gauss shard of the model and its Adam moments
(`parallel/shard.py`). Per iteration every rank draws the same
``n_data · views_per_group`` keyframes from the times-of-use sampler (the
same seed on every rank keeps them in lock-step); a rank loads and
renders only those of its own data row. Gradients average over ``data``,
Adam and densification run on each shard, at the `Trainer`'s cadence and
with its quirks (a densify iteration skips Adam, a reset iteration zeroes
the opacity LR, the white-background reset at ``densify_from_iter``), so a
(1, 1) mesh takes the `Trainer`'s steps. As in the JAX package the sharded
trainer has no coarse-to-fine pyramid and no undistort mask: it trains at
the camera's size.

`init_from_sfm` places rows [g·P/G, (g+1)·P/G) of the `Trainer`'s initial
model on gauss rank g; ``Tpu.capacity`` must split evenly over ``gauss``.
The instance caps come from the config, the same on every rank
(``Tpu.max_instances: 0`` takes `raster_config_from`'s static budget, as
in the JAX package; no rank autosizes). Checkpoints are the port's
single-file format (`train/checkpoint.py`), gathered on rank 0 and read by
every rank for its own rows, so a sharded run's checkpoint loads into
`Trainer` and back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from omnigs_torch.model import densify as densify_ops
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import FIELD_NAMES, GaussianModel, from_pcd, shard_numpy
from omnigs_torch.ops.knn import mean_sq_knn_dist
from omnigs_torch.parallel.distributed import local_data_rows
from omnigs_torch.parallel.mesh import (
    DATA_AXIS,
    GAUSS_AXIS,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    make_mesh,
)
from omnigs_torch.parallel.shard import (
    shard_generator,
    sharded_densify,
    sharded_train_step,
)
from omnigs_torch.train.trainer import Trainer


@dataclasses.dataclass
class ParallelTrainer(Trainer):
    """`Trainer` over the (``Tpu.mesh_data``, ``Tpu.mesh_gauss``) mesh of the
    initialized process group; ``device`` is this rank's device."""

    def __post_init__(self):
        super().__post_init__()
        cfg = self.config
        self.mesh = make_mesh(
            cfg.tpu.mesh_data, cfg.tpu.mesh_gauss,
            device_type=torch.device(self.device).type,
        )
        self.n_data = axis_size(self.mesh, DATA_AXIS)
        self.n_gauss = axis_size(self.mesh, GAUSS_AXIS)
        self.gauss_index = axis_index(self.mesh, GAUSS_AXIS)
        if cfg.tpu.capacity % self.n_gauss:
            raise ValueError(
                f"Tpu.capacity {cfg.tpu.capacity} must split evenly over "
                f"{self.n_gauss} gauss ranks"
            )
        # the only data row whose ground truths this rank loads
        self.local_rows = local_data_rows(self.mesh)
        self.generator = shard_generator(self.seed, self.mesh, self.device)

    # -- setup --

    def _shard(self, arrays):
        return shard_numpy(arrays, self.gauss_index, self.n_gauss)

    def init_from_sfm(self):
        """Every rank builds the `Trainer`'s initial model from the SfM cloud
        and keeps its own rows."""
        pts = torch.as_tensor(self.scene.points, dtype=torch.float32, device=self.device)
        cols = torch.as_tensor(self.scene.colors, dtype=torch.float32, device=self.device)
        full = from_pcd(pts, cols, self.config.tpu.capacity, mean_sq_knn_dist(pts))
        lo = self.gauss_index * (full.capacity // self.n_gauss)
        hi = lo + full.capacity // self.n_gauss
        self.model = GaussianModel(
            {k: getattr(full, k).detach()[lo:hi].clone() for k in FIELD_NAMES}
        )
        self.opt_state = opt_ops.init_adam(self.model.params())

    # -- the loop --

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        with self.lock:
            cfg = self.config
            self.iteration += 1
            it = self.iteration
            vpg = cfg.tpu.views_per_group
            kfs = [self.sampler.sample() for _ in range(self.n_data * vpg)]
            in_densify_phase, do_densify, do_reset = self._schedule(it)
            # row d of the batch belongs to data row d // vpg: this rank
            # materializes only its own
            mine = [kfs[d * vpg + v] for d in self.local_rows for v in range(vpg)]
            poses = [self._pose(kf) for kf in mine]
            aux = sharded_train_step(
                self.mesh,
                self.model,
                self.opt_state,
                torch.stack([vm for vm, _ in poses]),
                torch.stack([cp for _, cp in poses]),
                torch.stack([self._gt(kf) for kf in mine]),
                torch.full((), it, dtype=torch.int32, device=self.device),
                camera=self.camera,
                sh_degree=self.sh_degree,
                raster_cfg=self.raster_cfg,
                lr_cfg=self.lr_cfg,
                spatial_lr_scale=self.cameras_extent,
                bg=self.bg,
                lambda_dssim=cfg.opt.lambda_dssim,
                skip_bottom_px=self._skip_bottom_px(self.camera),
                update_stats=in_densify_phase,
                do_adam=not do_densify and it < cfg.opt.max_num_iterations,
                skip_opacity_update=do_reset,
            )
            if do_densify:
                sharded_densify(
                    self.mesh, self.model, self.opt_state, self.generator,
                    **self._densify_kwargs(it),
                )
            if do_reset:
                densify_ops.reset_opacity(self.model, self.opt_state)
            if do_densify or do_reset:
                self.peak_memory.sample()
            self._pending_losses.append(
                (aux["loss"], aux["overflow"], aux["truncated"])
            )
            if len(self._pending_losses) > 512:
                self.drain_losses()
            return aux

    def train_window(self, max_steps: int) -> int:
        """Up to ``max_steps`` `train_iteration` calls before the next event
        iteration, the `Trainer`'s window length. A sharded step runs
        collectives, which the single-device window's CUDA graph does not
        capture (gloo's cannot be captured at all), so a sharded window is
        a loop of eager steps, with the results of a scanned one."""
        k = self._window_len(max_steps)
        for _ in range(k):
            self.train_iteration()
        return k

    def live_gaussians(self) -> int:
        """Live Gaussians of the whole model, summed over the gauss shards
        (every rank must call it)."""
        return int(all_reduce(self.model.num_active, self.mesh, GAUSS_AXIS))

    # -- the whole model on rank 0 --

    def _gathered(self, tensors: Dict[str, torch.Tensor]) -> Optional[Dict[str, np.ndarray]]:
        """All-gather ``tensors`` over ``gauss`` (every data row gathers its
        own replica) → host arrays on global rank 0, None elsewhere."""
        out = {k: all_gather(v.detach(), self.mesh, GAUSS_AXIS) for k, v in tensors.items()}
        if dist.get_rank() != 0:
            return None
        return {k: v.cpu().numpy() for k, v in out.items()}

    def host_model(self) -> Optional[Dict[str, np.ndarray]]:
        """The whole model's eleven fields as numpy arrays on rank 0 (None on
        the other ranks; every rank must call it)."""
        return self._gathered({k: getattr(self.model, k) for k in FIELD_NAMES})

    # -- full-state checkpoints --

    def save_checkpoint(self, path):
        """Gather the model and the Adam moments on rank 0, which writes the
        port's checkpoint file; every rank must call it."""
        from omnigs_torch.train.checkpoint import checkpoint_from_numpy

        model_np = self.host_model()
        opt = {f"mu/{k}": v for k, v in self.opt_state.mu.items()}
        opt.update({f"nu/{k}": v for k, v in self.opt_state.nu.items()})
        opt_np = self._gathered(opt)
        if model_np is not None:
            opt_np["count"] = self.opt_state.count.cpu().numpy()
            checkpoint_from_numpy(model_np, opt_np, self.iteration, path)
        dist.barrier()

    def load_checkpoint(self, path):
        """Every rank reads the file and keeps its own rows."""
        from omnigs_torch.train.checkpoint import read_checkpoint

        model_np, opt_np, self.iteration = read_checkpoint(path, self.config.tpu.capacity)
        self.model = GaussianModel.from_numpy(self._shard(model_np), device=self.device)
        self.opt_state = opt_ops.AdamState.from_numpy(self._shard(opt_np), device=self.device)
