"""Tile-binned rasterizer: the segmented, packed-key render path.

Counterpart of `omnigs_tpu/ops/rasterize.py`. This slice ports the
production configuration (`config.raster_config_from` defaults), which is
one chain:

  preprocess → bin_instances_packed → segment_relay → _build_inst_seg →
  composite_seg_fwd (Hopper kernel) → _tiles_to_image

and its gradient: autograd back through `_tiles_to_image`, the segmented
backward (`composite_seg_bwd`, Hopper kernel), the instance → Gaussian
reduction and ``inv_perm`` gather (`composite_seg.composite_instances_seg`),
then back through `preprocess`. Binning reads detached inputs, as the JAX
path stops their gradient. Every other `RasterConfig` raises
`NotImplementedError` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from omnigs_torch.cameras import Camera
from omnigs_torch.ops.binning import RANK_BITS, bin_instances_packed, segment_relay
from omnigs_torch.ops.composite_seg import CHUNK, composite_instances_seg
from omnigs_torch.ops.preprocess import TILE, Preprocessed, preprocess, tile_grid


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static capacity knobs; same fields and defaults as the JAX
    `RasterConfig` except the TPU-only ``interpret`` (the tensor's device
    picks kernel or plain version here)."""

    max_instances: int = 1 << 20  # instance buffer capacity R
    tile_cap: int = 1024  # max composited instances per tile (XLA backend)
    chunk: int = 32  # instances composited per scan step (XLA backend)
    backend: str = "xla"  # "xla" | "pallas" (the kernel path)
    # opacity-aware radii: fewer instances, output-identical except at
    # the right/bottom rect edge (ROADMAP queue 3)
    tight_culling: bool = False
    tile_culling: bool = False  # exact ellipse–box culling in binning
    aligned_cap: Optional[int] = None  # live-slab cap (counted drops)
    ghost_align: bool = False
    want_ncontrib: bool = True
    fused_reduce: bool = False
    gather_reduce: bool = False
    depth_presort: bool = False  # packed-key binning
    segmented: bool = False  # segmented compositing (the ported kernel)

    def __post_init__(self):
        if self.tile_cap % self.chunk != 0:
            raise ValueError("tile_cap must be a multiple of chunk")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.segmented:
            if self.backend != "pallas":
                raise ValueError("segmented needs the pallas backend")
            if self.want_ncontrib:
                raise ValueError("segmented kernels do not compute n_contrib")
            if self.ghost_align or self.fused_reduce:
                raise ValueError("segmented replaces the ghost/fused layouts")
        if (
            self.aligned_cap is not None
            and self.backend == "pallas"
            and self.aligned_cap % CHUNK != 0
        ):
            raise ValueError(
                f"aligned_cap must be a multiple of {CHUNK}, got {self.aligned_cap}"
            )


class RenderResult(NamedTuple):
    image: torch.Tensor  # (3, H, W) channels-first
    radii: torch.Tensor  # (P,) float; 0 ⇒ culled (visibility filter)
    final_T: torch.Tensor  # (H, W) transmittance (no gradient)
    n_contrib: torch.Tensor  # (H, W) int32 (zeros on the segmented path)
    overflow: torch.Tensor  # () int32 instances dropped by tile_cap
    truncated: torch.Tensor  # () int32 instances dropped by any cap


def _tiles_to_image(tiles: torch.Tensor, grid_x: int, grid_y: int, W: int, H: int):
    """(num_tiles, TILE²) → (H, W) or (num_tiles, C, TILE²) → (C, H, W)."""
    if tiles.ndim == 3:
        c = tiles.shape[1]
        img = tiles.reshape(grid_y, grid_x, c, TILE, TILE)
        img = img.permute(2, 0, 3, 1, 4).reshape(c, grid_y * TILE, grid_x * TILE)
        return img[:, :H, :W]
    img = tiles.reshape(grid_y, grid_x, TILE, TILE)
    img = img.permute(0, 2, 1, 3).reshape(grid_y * TILE, grid_x * TILE)
    return img[:H, :W]


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to omnigs_torch yet (ROADMAP {item})"
    )


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    *,
    camera: Camera,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    bg: torch.Tensor,
    sh_degree: int,
    config: RasterConfig = RasterConfig(),
    scale_modifier: float = 1.0,
    means2d_ndc: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    features_override: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Differentiable render of one view.

    Args:
      means2d_ndc: optional (P, 2) zeros whose gradient receives the
        NDC-convention screen-space gradients of the densification
        statistics (the training path).
      features_override: optional (P,) or (P, 3) per-Gaussian features to
        composite instead of RGB (depth rendering).
    """
    if config.backend != "pallas":
        raise _unported(
            "the XLA tile compositor (backend='xla')", "queue 1 item 10"
        )
    if not config.segmented:
        raise _unported(
            "the tile-major Pallas path (segmented=False, kernel "
            "pallas_raster.py::_fwd_kernel)", "queue 2 item 3"
        )
    W, H = camera.width, camera.height
    gx, gy = tile_grid(camera)
    p_gauss = means3d.shape[0]
    if not (
        config.depth_presort
        and p_gauss <= (1 << RANK_BITS)
        and gx * gy < (1 << (32 - RANK_BITS)) - 1
    ):
        raise _unported(
            "bin_instances (no depth presort, P > 2^19 or > 8190 tiles)",
            "queue 1 item 4",
        )
    prep = preprocess(
        means3d,
        scales,
        quats,
        opacities,
        shs,
        camera,
        viewmatrix,
        campos,
        sh_degree,
        scale_modifier,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_mask=active_mask,
        tight_culling=config.tight_culling,
    )
    means2d = prep.means2d
    if means2d_ndc is not None:
        half = torch.tensor([W * 0.5, H * 0.5], device=means2d.device)
        means2d = means2d + means2d_ndc * half

    rgb = prep.rgb
    if features_override is not None:
        f = features_override
        rgb = f[:, None].expand(-1, 3) if f.ndim == 1 else f

    inst = bin_instances_packed(
        Preprocessed(*(t.detach() for t in prep)),
        gx,
        gy,
        config.max_instances,
        tile_cull=config.tile_culling,
    )
    r8 = config.aligned_cap
    if r8 is None:
        r8 = -(-config.max_instances // CHUNK) * CHUNK
    seg = segment_relay(
        inst.sorted_g, inst.starts, inst.counts, r8, p_gauss, inst.sorted_key
    )
    color_t, T_t, n_t = composite_instances_seg(
        means2d,
        prep.conic,
        rgb,
        prep.opacity,
        bg,
        seg.sorted_g8,
        seg.starts8,
        seg.counts,
        seg.live8,
        seg.ride_d,
        seg.ride_t,
        inst.perm,
        inst.inv_perm,
        gx * gy,
        gx,
    )
    return RenderResult(
        image=_tiles_to_image(color_t, gx, gy, W, H),
        radii=prep.radii,
        final_T=_tiles_to_image(T_t, gx, gy, W, H).detach(),
        n_contrib=_tiles_to_image(n_t, gx, gy, W, H),
        overflow=torch.zeros((), dtype=torch.int32, device=color_t.device),
        truncated=inst.truncated + seg.truncated,
    )
