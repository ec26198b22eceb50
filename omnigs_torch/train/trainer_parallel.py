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

A rank keeps a pose bank of every keyframe and a ground-truth bank of the
keyframes its data row has drawn (`_bank_rows`). `train_window` runs the
iterations between events through `sharded_train_steps_fused`: on a CUDA
device under NCCL as replays of one captured sharded step
(`window_mode` "graph"), on the CPU or under gloo eagerly ("eager"), in
both bitwise the `train_iteration`s it stands for. `Trainer.train` drives
windows and event iterations as JAX's `ParallelTrainer.train` does.

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
from typing import Dict, List, Optional

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
    sharded_train_steps_fused,
    window_mode,
)
from omnigs_torch.train.trainer import Trainer
from omnigs_torch.utils import profiling


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
        # ({fid: row}, (N, 4, 4) poses, (N, 3) campos) of every keyframe
        self._poses = None
        # the ground truths this rank's data row has drawn, in the order
        # drawn: ({fid: row}, (rows, 3, H, W) bank); the keyframes each data
        # row has drawn, the same on every rank; times the bank grew
        self._gt_bank = ({}, None)
        self._drawn: List[set] = [set() for _ in range(self.n_data)]
        self.gt_bank_grows = 0

    @property
    def window_mode(self) -> str:
        """How `train_window` runs its steps here: "graph" (replays of one
        captured sharded step; a CUDA device under NCCL) or "eager" (the CPU,
        or gloo)."""
        return window_mode(self.device)

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

    def _draw(self) -> list:
        """One iteration's n_data · views_per_group keyframes, drawn as every
        rank draws them → this rank's data row's views. Row d of the batch
        belongs to data row d // views_per_group."""
        vpg = self.config.tpu.views_per_group
        kfs = [self.sampler.sample() for _ in range(self.n_data * vpg)]
        for d, drawn in enumerate(self._drawn):
            drawn.update(kf.fid for kf in kfs[d * vpg : (d + 1) * vpg])
        return [kfs[d * vpg + v] for d in self.local_rows for v in range(vpg)]

    def _bank_rows(self, views: List[list]):
        """The (k, V) pose rows and ground-truth rows of k iterations'
        views. A keyframe new to this rank's data row is loaded into the
        ground-truth bank (only this row's images are ever loaded). The bank
        holds a data row's share of the keyframes, ⌈N / n_data⌉ rows, and
        doubles (up to N) when a data row has drawn more: every rank tracks
        every row's draws, so all grow together and a sharded graph is
        captured again on all ranks. It lives on the device while its rows
        fit ``Tpu.gt_bank_mb`` MiB, else on the host (pinned beside a CUDA
        device), as the `Trainer`'s bank."""
        fid_row, _, _ = self._pose_bank()
        rows, bank = self._gt_bank
        n = len(fid_row)
        cap = -(-n // self.n_data) if bank is None else bank.shape[0]
        need = max(len(d) for d in self._drawn)
        while cap < need:
            cap = min(2 * cap, max(n, need))
        if bank is None or cap != bank.shape[0]:
            kf = next(iter(self.scene.keyframes.values()))
            h, w = np.asarray(kf.image).shape[:2]
            dev = torch.device(self.device)
            on_device = cap * 3 * h * w * 4 <= self.config.tpu.gt_bank_mb * (1 << 20)
            new = torch.empty((cap, 3, h, w), dtype=torch.float32,
                              device=dev if on_device else "cpu",
                              pin_memory=not on_device and dev.type == "cuda")
            if bank is not None:
                new[: len(rows)].copy_(bank[: len(rows)])
                self.gt_bank_grows += 1
            bank = new
            profiling.count("bank_builds")
        for kf in (kf for step in views for kf in step):
            if kf.fid not in rows:
                # loaders produce HWC; the image convention is channels-first
                img = torch.as_tensor(np.asarray(kf.image), dtype=torch.float32)
                bank[len(rows)].copy_(img.permute(2, 0, 1))
                rows[kf.fid] = len(rows)
        self._gt_bank = (rows, bank)
        return (np.array([[fid_row[kf.fid] for kf in step] for step in views], np.int64),
                np.array([[rows[kf.fid] for kf in step] for step in views], np.int64))

    # -- the loop --

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        with self.lock:
            cfg = self.config
            self.iteration += 1
            it = self.iteration
            mine = self._draw()
            in_densify_phase, do_densify, do_reset = self._schedule(it)
            (pose_rows,), (gt_rows,) = self._bank_rows([mine])
            _, vms, cps = self._pose_bank()
            bank = self._gt_bank[1]
            aux = sharded_train_step(
                self.mesh,
                self.model,
                self.opt_state,
                torch.stack([vms[r] for r in pose_rows]),
                torch.stack([cps[r] for r in pose_rows]),
                torch.stack([bank[r].to(self.device, non_blocking=True) for r in gt_rows]),
                torch.full((), it, dtype=torch.int32, device=self.device),
                do_adam=not do_densify and it < cfg.opt.max_num_iterations,
                skip_opacity_update=do_reset,
                **self._step_kwargs(self.camera, in_densify_phase),
            )
            dev = self.model.xyz.device
            if do_densify:
                profiling.mark("densify", dev)
                sharded_densify(
                    self.mesh, self.model, self.opt_state, self.generator,
                    **self._densify_kwargs(it),
                )
            if do_reset:
                profiling.mark("reset", dev)
                densify_ops.reset_opacity(self.model, self.opt_state)
            profiling.mark("end", dev)
            if do_densify or do_reset:
                self.peak_memory.sample()
            self._pending_losses.append(
                (aux["loss"], aux["overflow"], aux["truncated"])
            )
            if len(self._pending_losses) > 512:
                self.drain_losses()
            return aux

    def train_window(self, max_steps: int) -> int:
        """Take up to ``max_steps`` iterations before the next event
        iteration through `sharded_train_steps_fused` and return how many
        were taken (0: call `train_iteration`). Every rank draws the
        window's keyframes as that many `train_iteration` calls would, so
        the ranks stay in lock-step; none of the steps densifies or resets,
        each steps Adam. In `window_mode` "graph" the steps are replays of
        `step_graph`, bitwise the eager iterations; the lock is held for
        each step."""
        k = self._window_len(max_steps)
        if k == 0:
            return 0
        with self.lock:
            pose_rows, gt_rows = self._bank_rows([self._draw() for _ in range(k)])
        _, vms, cps = self._pose_bank()
        it = self.iteration
        # a window ends before every event, so its last step's phase is
        # every step's
        kw = self._step_kwargs(self.camera, self._schedule(it + k)[0])
        losses, overflow, truncated = sharded_train_steps_fused(
            self.mesh, self.model, self.opt_state, vms, cps, self._gt_bank[1],
            pose_rows, gt_rows, it, graph=self.step_graph, lock=self.lock, **kw,
        )
        self.iteration = it + k
        self._pending_losses.append((losses, overflow, truncated))
        if len(self._pending_losses) > 512:
            self.drain_losses()
        return k

    def live_gaussians(self) -> int:
        """Live Gaussians of the whole model, summed over the gauss shards
        (every rank must call it)."""
        live = all_reduce(self.model.num_active, self.mesh, GAUSS_AXIS)
        with profiling.host_wait("live_gaussians"):
            return int(live)

    def _rank_tag(self) -> str:
        """A log line on a mesh starts with the global rank."""
        return f"[rank {dist.get_rank()}] "

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
