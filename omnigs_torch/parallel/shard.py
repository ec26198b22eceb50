"""Sharded rendering over a (data, gauss) mesh, and the mesh's side of the
training step.

Counterpart of `omnigs_tpu/parallel/shard.py`. Each rank holds one gauss
shard of the model (P/G rows, with its Adam moments) and, on its data row,
its own views. Per view a rank (`render_view`):

1. preprocesses its Gaussian shard;
2. all-gathers the compact raster state (means2d, depth, conic, radii,
   rgb, opacity, rect, tiles touched, valid: 17 floats a Gaussian) over
   ``gauss``;
3. bins and composites its tile window [g·T/G, (g+1)·T/G) of the grid
   through the single-device path (`ops/rasterize._composite` with the
   window: the same layouts, kernels and plain versions);
4. all-gathers the tiles into the whole image (the SSIM window crosses
   tile rows).

Without a mesh (``mesh=None``) or with one gauss rank nothing is gathered,
and `render_view` runs `rasterize`'s own operations on the whole model.

The gradient rule. A rank differentiates only its own partial of the loss
(`view_loss`): the L1 sum and the `ssim_rows` sum of its row block
[g·H/G, (g+1)·H/G), each over the image's pixel count (with one row
block, `loss.l1_loss` and `loss.ssim` of the whole image, the
single-device loss). The partials sum to the loss, and the backward of
each all-gather is a reduce-scatter (`_AllGatherRows`), so the gradients
that reach a shard are those of the loss itself, summed over the ranks
that used its rows. `train.trainer.train_step` is the step on a mesh and
on one device: it all-reduces the logged loss's detached partials,
averages the gradients over a rank's views and then over ``data`` (the
gradient of the mean loss), and sums the densification statistics, each
view's own as a single-device iteration of that view would take them,
over the views and over ``data`` (``max_radii2d`` takes the max); the
capacity counters sum over both dims. It runs its collectives through
this module's `all_reduce`.

The JAX step differentiates the whole psum'd loss on every gauss shard, so
its gradients and statistics come out ``n_gauss`` times one device's
(`tests/test_torch_parallel_factor.py::test_jax_sharded_grad_is_n_gauss_times`),
and its statistics take the gradient of the views' mean, 1/V of each
view's with V views a rank; the port computes one device's. Adam's
ε = 1e-15 hides the factor from the parameter updates; the densification
threshold sees it.

Densification runs on each shard into the shard's own free slots, with the
split noise of a per-rank generator (`shard_generator`), its counts summed
over ``gauss``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from omnigs_torch.cameras import Camera
from omnigs_torch.model import densify as densify_ops
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops import loss as loss_ops
from omnigs_torch.ops.preprocess import Preprocessed, device_constant, preprocess, tile_grid
from omnigs_torch.ops.rasterize import RasterConfig, _composite, _tiles_to_image
from omnigs_torch.parallel.mesh import (
    GAUSS_AXIS,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    reduce_scatter,
)
from omnigs_torch.utils import profiling


class _AllGatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a mesh dim; the backward reduce-scatters
    the gradient onto the rank that owns the rows."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, ctx.axis), None, None


def _gather_prep(prep: Preprocessed, mesh: DeviceMesh) -> Preprocessed:
    """Every rank's `Preprocessed` rows in gauss-rank order: one all-gather
    of the state packed as 17 float32 columns (the integer fields are
    small enough to ride exactly)."""
    f32 = torch.float32
    packed = torch.cat(
        [
            prep.means2d, prep.depths[:, None], prep.conic, prep.radii[:, None],
            prep.rgb, prep.opacity[:, None], prep.rect.to(f32),
            prep.tiles_touched.to(f32)[:, None], prep.valid.to(f32)[:, None],
        ],
        dim=1,
    )
    full = _AllGatherRows.apply(packed, mesh, GAUSS_AXIS)
    return Preprocessed(
        means2d=full[:, 0:2],
        depths=full[:, 2],
        conic=full[:, 3:6],
        radii=full[:, 6],
        rgb=full[:, 7:10],
        opacity=full[:, 10],
        rect=full[:, 11:15].to(torch.int32),
        tiles_touched=full[:, 15].to(torch.int32),
        valid=full[:, 16] > 0,
    )


def render_view(
    model: GaussianModel,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    camera: Camera,
    bg: torch.Tensor,
    sh_degree: int,
    cfg: RasterConfig,
    mesh: Optional[DeviceMesh],
    means2d_ndc: Optional[torch.Tensor] = None,
):
    """One rank's part of the sharded forward, differentiable → (the whole
    (3, H, W) image, this shard's radii, overflow, truncated of this rank's
    window). Stage marks from ``preprocess`` to ``composite_fwd``, which
    the caller closes."""
    n_gauss = axis_size(mesh, GAUSS_AXIS)
    gx, gy = tile_grid(camera)
    num_tiles = gx * gy
    tiles_per_rank = -(-num_tiles // n_gauss)
    tile_lo = axis_index(mesh, GAUSS_AXIS) * tiles_per_rank

    profiling.mark("preprocess", viewmatrix)
    prep = preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(), model.get_opacity(),
        model.get_features(), camera, viewmatrix, campos, sh_degree,
        active_mask=model.active, tight_culling=cfg.tight_culling,
    )
    if means2d_ndc is not None:
        half = device_constant((camera.width * 0.5, camera.height * 0.5), viewmatrix.device,
                               torch.float32)
        prep = prep._replace(means2d=prep.means2d + means2d_ndc * half)
    full = _gather_prep(prep, mesh) if n_gauss > 1 else prep
    color_t, _, _, overflow, truncated = _composite(
        cfg, full, full.means2d, full.rgb, bg, gx, gy, tile_lo, tiles_per_rank
    )
    if n_gauss > 1:
        color_t = _AllGatherRows.apply(color_t, mesh, GAUSS_AXIS)[:num_tiles]
    image = _tiles_to_image(color_t, gx, gy, camera.width, camera.height)
    return image, prep.radii, overflow, truncated


def sharded_render(
    mesh: DeviceMesh,
    model: GaussianModel,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    camera: Camera,
    bg: torch.Tensor,
    sh_degree: int,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Forward-only sharded render of this rank's gauss shard ``model``:
    the whole (3, H, W) image, the same on every rank (evaluation and
    viewer path)."""
    with torch.inference_mode():
        image, *_ = render_view(model, viewmatrix, campos, camera, bg, sh_degree, cfg, mesh)
    profiling.mark("end", image)
    return image


def view_loss(image, gt, skip_bottom_px: int, mesh: Optional[DeviceMesh]):
    """This rank's partial of one view's (bottom-cropped) L1 and SSIM means:
    with one row block, `loss.l1_loss` and `loss.ssim` of the whole image;
    else the L1 sum and the `ssim_rows` sum of its row block, each over the
    image's pixel count. The partials sum to the means over ``gauss``."""
    pred = image
    if skip_bottom_px > 0:
        pred = pred[:, :-skip_bottom_px]
        gt = gt[:, :-skip_bottom_px]
    n_blocks = axis_size(mesh, GAUSS_AXIS)
    if n_blocks == 1:
        return loss_ops.l1_loss(pred, gt), loss_ops.ssim(pred, gt)
    c, h, w = pred.shape
    rows = -(-h // n_blocks)
    r0 = axis_index(mesh, GAUSS_AXIS) * rows
    r1 = min(r0 + rows, h)
    l1_sum = torch.abs(pred[:, r0:r1] - gt[:, r0:r1]).sum()
    ssim_sum = loss_ops.ssim_rows(pred, gt, r0, rows, h)[:, : max(r1 - r0, 0)].sum()
    return l1_sum / (c * h * w), ssim_sum / (c * h * w)


def any_rank(flag: bool, device) -> bool:
    """``flag`` or'ed over every rank (a host round trip)."""
    t = torch.full((1,), int(flag), dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    with profiling.host_wait("any_rank"):
        return bool(t.item())


def shard_generator(seed: int, mesh: DeviceMesh, device) -> torch.Generator:
    """The split-noise generator of this rank's gauss shard: seeded from
    (seed, gauss index) as ``seed + (index << 32)``, so gauss rank 0 draws
    the single-device `Trainer`'s stream and the data replicas of a shard
    draw the same noise."""
    g = axis_index(mesh, GAUSS_AXIS)
    return torch.Generator(device).manual_seed(seed + (g << 32))


def sharded_densify(
    mesh: DeviceMesh,
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    generator: torch.Generator,
    **kwargs,
) -> densify_ops.DensifyStats:
    """`densify_and_prune` on this rank's shard into its own free slots (the
    thresholds are elementwise, so the rule is the global one); the counts
    summed over ``gauss``."""
    stats = densify_ops.densify_and_prune(model, opt_state, generator, **kwargs)
    summed = all_reduce(torch.stack([s.to(torch.int64) for s in stats]), mesh, GAUSS_AXIS)
    return densify_ops.DensifyStats(*summed.unbind())
