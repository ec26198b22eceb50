"""Configuration system mirroring the reference's YAML schema.

Counterpart of `omnigs_tpu/config.py`: the flat OpenCV-FileStorage YAML
files in `cfg/` (`%YAML:1.0` header, `Section.key: value` lines) land in
the same typed dataclasses, including the `Tpu.*` capacity and rasterizer
keys. `raster_config_from` builds the production `RasterConfig`; unlike the
JAX version it never demotes the backend by platform — the device of the
tensors picks kernel or plain version.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Union


@dataclasses.dataclass
class ModelParams:
    """`GaussianModelParams` (`include/gaussian_parameters.h`)."""

    sh_degree: int = 3
    resolution: float = -1.0
    white_background: bool = False
    eval: bool = False


@dataclasses.dataclass
class OptimizationParams:
    """`GaussianOptimizationParams` defaults
    (`include/gaussian_parameters.h:64-102`) + the YAML Optimization.* keys."""

    max_num_iterations: int = 32010
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    prune_big_point_after_iter: int = 0
    densify_min_opacity: float = 0.005
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002
    prune_by_extent: bool = True
    skip_bottom_ratio: float = 0.0


@dataclasses.dataclass
class PipelineParams:
    convert_SHs: bool = False
    compute_cov3D: bool = False
    z_near: float = 0.01
    z_far: float = 100.0


@dataclasses.dataclass
class GausPyramidParams:
    """Coarse-to-fine pyramid training (`src/gaussian_mapper.cpp:140-151`):
    level l trains at resolution factor 0.5^(L-l) with a per-keyframe
    times-of-use budget before graduating to full resolution."""

    do: bool = False
    num_sub_levels: int = 0
    sub_level_times_of_use: int = 8

    def factor(self, level: int) -> float:
        return 0.5 ** (self.num_sub_levels - level)


@dataclasses.dataclass
class MapperParams:
    new_keyframe_times_of_use: int = 1
    keyframe_record_interval: int = 0
    all_keyframes_record_interval: int = 8000
    record_rendered_image: bool = True
    record_ground_truth_image: bool = False
    record_loss_image: bool = False
    training_report_interval: int = 10000


@dataclasses.dataclass
class TpuParams:
    """Capacity and rasterizer knobs with no reference analog (the YAML
    ``Tpu.*`` keys, read unchanged; the field names keep the JAX package's)."""

    capacity: int = 1 << 19  # max Gaussians P_max
    max_instances: int = 1 << 22
    tile_cap: int = 1024
    chunk: int = 64
    # "pallas": the CUDA kernel path | "xla": the dense plain-PyTorch
    # compositor (`rasterize._CompositeTiles`)
    backend: str = "pallas"
    tight_culling: bool = True
    tile_culling: bool = True  # exact ellipse-box culling (pallas backend)
    aligned_cap: int = 0  # live-slab cap; 0 = uncapped (never drops tiles)
    # training-loop knobs: where the ground-truth bank lives, the window
    # length, the (data, gauss) mesh and the views a data row takes a step
    gt_bank_mb: int = 2048
    fuse_steps: int = 24
    mesh_data: int = 1  # view-parallel axis size
    mesh_gauss: int = 1  # Gaussian-parallel axis size
    views_per_group: int = 1  # views batched per data group per step
    # n_contrib contribution ranks (a diagnostic nothing in train/eval
    # consumes; the segmented path needs it off)
    want_ncontrib: bool = False
    # gather-based gradient reduction (switched off under `segmented`) and
    # the depth-presorted packed-key binning
    gather_reduce: bool = True
    depth_presort: bool = True
    # segmented compositing (the ported kernel); requires want_ncontrib=False
    segmented: bool = True


@dataclasses.dataclass
class Config:
    model: ModelParams = dataclasses.field(default_factory=ModelParams)
    opt: OptimizationParams = dataclasses.field(default_factory=OptimizationParams)
    pipe: PipelineParams = dataclasses.field(default_factory=PipelineParams)
    mapper: MapperParams = dataclasses.field(default_factory=MapperParams)
    pyramid: GausPyramidParams = dataclasses.field(
        default_factory=GausPyramidParams
    )
    tpu: TpuParams = dataclasses.field(default_factory=TpuParams)


def _parse_opencv_yaml(path: Union[str, Path]) -> Dict[str, Union[int, float]]:
    """Parse the flat `Key.sub: value` OpenCV YAML files in cfg/."""
    out: Dict[str, Union[int, float]] = {}
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if not val:
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val  # type: ignore[assignment]
    return out


_KEYMAP = {
    "Model.sh_degree": ("model", "sh_degree", int),
    "Model.resolution": ("model", "resolution", float),
    "Model.white_background": ("model", "white_background", bool),
    "Model.eval": ("model", "eval", bool),
    "Camera.z_near": ("pipe", "z_near", float),
    "Camera.z_far": ("pipe", "z_far", float),
    "Pipeline.convert_SHs": ("pipe", "convert_SHs", bool),
    "Pipeline.compute_cov3D": ("pipe", "compute_cov3D", bool),
    "Mapper.new_keyframe_times_of_use": ("mapper", "new_keyframe_times_of_use", int),
    "GausPyramid.do": ("pyramid", "do", bool),
    "GausPyramid.num_sub_levels": ("pyramid", "num_sub_levels", int),
    "GausPyramid.sub_level_times_of_use": ("pyramid", "sub_level_times_of_use", int),
    "Record.keyframe_record_interval": ("mapper", "keyframe_record_interval", int),
    "Record.all_keyframes_record_interval": (
        "mapper",
        "all_keyframes_record_interval",
        int,
    ),
    "Record.record_rendered_image": ("mapper", "record_rendered_image", bool),
    "Record.record_ground_truth_image": ("mapper", "record_ground_truth_image", bool),
    "Record.record_loss_image": ("mapper", "record_loss_image", bool),
    "Record.training_report_interval": ("mapper", "training_report_interval", int),
    "Optimization.max_num_iterations": ("opt", "max_num_iterations", int),
    "Optimization.position_lr_init": ("opt", "position_lr_init", float),
    "Optimization.position_lr_final": ("opt", "position_lr_final", float),
    "Optimization.position_lr_delay_mult": ("opt", "position_lr_delay_mult", float),
    "Optimization.position_lr_max_steps": ("opt", "position_lr_max_steps", int),
    "Optimization.feature_lr": ("opt", "feature_lr", float),
    "Optimization.opacity_lr": ("opt", "opacity_lr", float),
    "Optimization.scaling_lr": ("opt", "scaling_lr", float),
    "Optimization.rotation_lr": ("opt", "rotation_lr", float),
    "Optimization.percent_dense": ("opt", "percent_dense", float),
    "Optimization.lambda_dssim": ("opt", "lambda_dssim", float),
    "Optimization.densification_interval": ("opt", "densification_interval", int),
    "Optimization.opacity_reset_interval": ("opt", "opacity_reset_interval", int),
    "Optimization.prune_big_point_after_iter": (
        "opt",
        "prune_big_point_after_iter",
        int,
    ),
    "Optimization.densify_min_opacity": ("opt", "densify_min_opacity", float),
    "Optimization.densify_from_iter": ("opt", "densify_from_iter", int),
    "Optimization.densify_until_iter": ("opt", "densify_until_iter", int),
    "Optimization.densify_grad_threshold": ("opt", "densify_grad_threshold", float),
    "Optimization.prune_by_extent": ("opt", "prune_by_extent", bool),
    "Optimization.skip_bottom_ratio": ("opt", "skip_bottom_ratio", float),
    # extensions absent from reference configs (defaults apply)
    "Tpu.capacity": ("tpu", "capacity", int),
    "Tpu.max_instances": ("tpu", "max_instances", int),
    "Tpu.tile_cap": ("tpu", "tile_cap", int),
    "Tpu.chunk": ("tpu", "chunk", int),
    "Tpu.tile_culling": ("tpu", "tile_culling", bool),
    "Tpu.aligned_cap": ("tpu", "aligned_cap", int),
    "Tpu.fuse_steps": ("tpu", "fuse_steps", int),
    "Tpu.gt_bank_mb": ("tpu", "gt_bank_mb", int),
    "Tpu.mesh_data": ("tpu", "mesh_data", int),
    "Tpu.mesh_gauss": ("tpu", "mesh_gauss", int),
    "Tpu.views_per_group": ("tpu", "views_per_group", int),
    "Tpu.want_ncontrib": ("tpu", "want_ncontrib", bool),
    "Tpu.gather_reduce": ("tpu", "gather_reduce", bool),
    "Tpu.depth_presort": ("tpu", "depth_presort", bool),
    "Tpu.segmented": ("tpu", "segmented", bool),
}


def raster_config_from(cfg: Config):
    """Build the production RasterConfig from the Tpu.* knobs (shared by the
    trainer, the eval/test entry points, and the viewer)."""
    from omnigs_torch.ops.composite_seg import CHUNK
    from omnigs_torch.ops.rasterize import RasterConfig

    backend = cfg.tpu.backend
    # aligned_cap: 0/unset = uncapped (the slab spans the full sorted array
    # and never drops anything); an explicit cap rounds up to the kernel's
    # lane granularity and trades counted tile drops for a smaller slab
    aligned_cap = cfg.tpu.aligned_cap or None
    if aligned_cap is not None:
        aligned_cap = -(-aligned_cap // CHUNK) * CHUNK
    # Tpu.max_instances: 0 = a generous static budget for every consumer
    # that does not autosize from a model (eval, viewer)
    max_instances = cfg.tpu.max_instances or (1 << 22)
    pallas = backend == "pallas"
    return RasterConfig(
        max_instances=max_instances,
        tile_cap=cfg.tpu.tile_cap,
        chunk=cfg.tpu.chunk,
        backend=backend,
        tight_culling=cfg.tpu.tight_culling,
        tile_culling=pallas and cfg.tpu.tile_culling,
        aligned_cap=aligned_cap if pallas else None,
        want_ncontrib=cfg.tpu.want_ncontrib,
        fused_reduce=False,
        gather_reduce=pallas and cfg.tpu.gather_reduce,
        depth_presort=pallas and cfg.tpu.depth_presort,
        segmented=pallas and cfg.tpu.segmented and not cfg.tpu.want_ncontrib,
    )


def load_config(path: Union[str, Path]) -> Config:
    """Load a reference-format YAML (e.g. `cfg/lonlat/360roam_lonlat.yaml`)."""
    raw = _parse_opencv_yaml(path)
    cfg = Config()
    for key, val in raw.items():
        if key not in _KEYMAP:
            continue
        section, attr, typ = _KEYMAP[key]
        obj = getattr(cfg, section)
        setattr(obj, attr, typ(val))
    return cfg
