"""High-level render entry point — the `GaussianRenderer` analog.

Counterpart of `omnigs_tpu/train/renderer.py`: gathers the model's
activations and renders it from a pose. The render is differentiable in
the model's parameters (the training step); serving callers render under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from omnigs_torch.cameras import Camera, CameraType, world_to_cam
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops import sh as sh_ops
from omnigs_torch.ops.covariance import build_cov3d
from omnigs_torch.ops.rasterize import RasterConfig, RenderResult, rasterize


def render_model(
    model: GaussianModel,
    camera: Camera,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    bg: torch.Tensor,
    sh_degree: int,
    config: RasterConfig,
    *,
    full_proj: Optional[torch.Tensor] = None,
    means2d_ndc: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    render_depth: bool = False,
    convert_SHs: bool = False,
    compute_cov3D: bool = False,
) -> RenderResult:
    """Render the model from a pose (T_cw ``viewmatrix``, camera center
    ``campos``) over background ``bg``; all tensors on the model's device.

    A pinhole camera needs ``full_proj`` (`Keyframe.full_proj`, on the
    model's device).

    ``convert_SHs`` / ``compute_cov3D`` mirror the reference's Pipeline.*
    flags: evaluate SH colors / covariances outside the rasterizer and feed
    them precomputed. ``render_depth`` composites per-Gaussian depth (radial
    for lonlat) in place of color.
    """
    features_override = None
    if render_depth:
        t = world_to_cam(model.xyz, viewmatrix)
        if camera.camera_type == CameraType.LONLAT:
            features_override = torch.linalg.vector_norm(t, dim=-1)
        else:
            features_override = t[..., 2]

    colors_precomp = None
    if convert_SHs:
        colors_precomp = sh_ops.sh_to_rgb(
            sh_degree, model.get_features(), model.xyz, campos
        )
    cov3d_precomp = None
    if compute_cov3D:
        cov3d_precomp = build_cov3d(
            model.get_scaling(), model.get_rotation(), scale_modifier
        )

    return rasterize(
        model.xyz,
        model.get_scaling(),
        model.get_rotation(),
        model.get_opacity(),
        model.get_features(),
        camera=camera,
        viewmatrix=viewmatrix,
        campos=campos,
        bg=bg,
        sh_degree=sh_degree,
        config=config,
        scale_modifier=scale_modifier,
        full_proj=full_proj,
        means2d_ndc=means2d_ndc,
        active_mask=model.active,
        features_override=features_override,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
    )
