"""Sharded rendering and training over a (data, gauss) mesh.

Counterpart of `omnigs_tpu/parallel/shard.py`. Each rank holds one gauss
shard of the model (P/G rows, with its Adam moments) and, on its data row,
its own views. Per view a rank:

1. preprocesses its Gaussian shard;
2. all-gathers the compact raster state (means2d, depth, conic, radii,
   rgb, opacity, rect, tiles touched, valid: 17 floats a Gaussian) over
   ``gauss``;
3. bins and composites its tile window [g·T/G, (g+1)·T/G) of the grid
   through the single-device path (`ops/rasterize._composite` with the
   window: the same layouts, kernels and plain versions);
4. all-gathers the tiles into the whole image (the SSIM window crosses
   tile rows).

The gradient rule. A rank differentiates only its own partial of the loss:
the L1 sum and the `ssim_rows` sum of its row block [g·H/G, (g+1)·H/G),
each over the image's pixel count. The partials sum to the loss, and the
backward of each all-gather is a reduce-scatter (`_AllGatherRows`), so the
gradients that reach a shard are those of the loss itself, summed over the
ranks that used its rows. The logged loss is an all-reduce of the detached
partials. Gradients average over a rank's views and then over ``data``
(the gradient of the mean loss); the densification statistics take each
view's own screen-space gradient, as a single-device iteration of that
view would, and sum over the views and over ``data`` (``max_radii2d``
takes the max); the capacity counters sum over both dims.

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

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from omnigs_torch.cameras import Camera
from omnigs_torch.model import densify as densify_ops
from omnigs_torch.model import optimizer as opt_ops
from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops import loss as loss_ops
from omnigs_torch.ops.preprocess import Preprocessed, preprocess, tile_grid
from omnigs_torch.ops.rasterize import RasterConfig, _composite, _tiles_to_image
from omnigs_torch.parallel.mesh import (
    DATA_AXIS,
    GAUSS_AXIS,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    reduce_scatter,
)


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


def _render_image_sharded(
    model: GaussianModel,
    viewmatrix: torch.Tensor,
    campos: torch.Tensor,
    camera: Camera,
    bg: torch.Tensor,
    sh_degree: int,
    cfg: RasterConfig,
    mesh: DeviceMesh,
    means2d_ndc: Optional[torch.Tensor] = None,
):
    """One rank's part of the sharded forward → (the whole (3, H, W) image,
    this shard's radii, overflow, truncated of this rank's window)."""
    n_gauss = axis_size(mesh, GAUSS_AXIS)
    gx, gy = tile_grid(camera)
    num_tiles = gx * gy
    tiles_per_rank = -(-num_tiles // n_gauss)
    tile_lo = axis_index(mesh, GAUSS_AXIS) * tiles_per_rank

    prep = preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(), model.get_opacity(),
        model.get_features(), camera, viewmatrix, campos, sh_degree,
        active_mask=model.active, tight_culling=cfg.tight_culling,
    )
    if means2d_ndc is not None:
        half = torch.tensor([camera.width * 0.5, camera.height * 0.5], device=viewmatrix.device)
        prep = prep._replace(means2d=prep.means2d + means2d_ndc * half)
    full = _gather_prep(prep, mesh) if n_gauss > 1 else prep
    color_t, _, _, overflow, truncated = _composite(
        cfg, full, full.means2d, full.rgb, bg, gx, gy, tile_lo, tiles_per_rank
    )
    tiles = _AllGatherRows.apply(color_t, mesh, GAUSS_AXIS)[:num_tiles]
    image = _tiles_to_image(tiles, gx, gy, camera.width, camera.height)
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
        image, *_ = _render_image_sharded(
            model, viewmatrix, campos, camera, bg, sh_degree, cfg, mesh
        )
    return image


def _view_partials(image, gt, skip_bottom_px, mesh):
    """This rank's (L1 sum, SSIM sum) over its row block of the (cropped)
    image, and the image's pixel count."""
    pred = image
    if skip_bottom_px > 0:
        pred = pred[:, :-skip_bottom_px]
        gt = gt[:, :-skip_bottom_px]
    c, h, w = pred.shape
    rows = -(-h // axis_size(mesh, GAUSS_AXIS))
    r0 = axis_index(mesh, GAUSS_AXIS) * rows
    r1 = min(r0 + rows, h)
    l1_sum = torch.abs(pred[:, r0:r1] - gt[:, r0:r1]).sum()
    ssim_sum = loss_ops.ssim_rows(pred, gt, r0, rows, h)[:, : max(r1 - r0, 0)].sum()
    return l1_sum, ssim_sum, c * h * w


def sharded_train_step(
    mesh: DeviceMesh,
    model: GaussianModel,
    opt_state: opt_ops.AdamState,
    viewmatrices: torch.Tensor,
    camposes: torch.Tensor,
    gt_images: torch.Tensor,
    step,
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
    """One training iteration of this rank's shard, in place: this rank's
    views (V, 4, 4), (V, 3), (V, 3, H, W) of its data row → the mean loss
    of the V views, its gradient (one device's) averaged over ``data``,
    the statistics, Adam. Returns the aux tensors (loss, l1, overflow,
    truncated, the last view's image), the same on every rank."""
    dev = model.xyz.device
    params = model.params()
    names = list(params)
    n_views = viewmatrices.shape[0]
    grads = None
    sums, radii_v, ndc_g = [], [], []
    overflow = truncated = torch.zeros((), dtype=torch.int32, device=dev)
    for v in range(n_views):
        ndc = torch.zeros(model.capacity, 2, device=dev, requires_grad=True)
        image, radii, ov, tr = _render_image_sharded(
            model, viewmatrices[v], camposes[v], camera, bg, sh_degree,
            raster_cfg, mesh, means2d_ndc=ndc,
        )
        l1_sum, ssim_sum, npix = _view_partials(image, gt_images[v], skip_bottom_px, mesh)
        part = (1.0 - lambda_dssim) * (l1_sum / npix) + lambda_dssim * (
            1.0 - ssim_sum / npix
        )
        # the view's own loss: its screen-space gradient feeds the
        # statistics as one single-device iteration's would
        *g, g_ndc = torch.autograd.grad(
            part, [params[k] for k in names] + [ndc], allow_unused=True
        )
        g = [torch.zeros_like(params[k]) if x is None else x for k, x in zip(names, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        sums.append(torch.stack([l1_sum.detach(), ssim_sum.detach()]) / npix)
        radii_v.append(radii.detach())
        ndc_g.append(g_ndc)
        overflow, truncated = overflow + ov, truncated + tr

    # the logged loss: the partials all-reduced over gauss, then as the
    # single-device loss, averaged over the views and the data rows
    means = all_reduce(torch.stack(sums), mesh, GAUSS_AXIS)
    l1 = means[:, 0].mean()
    total = ((1.0 - lambda_dssim) * means[:, 0] + lambda_dssim * (1.0 - means[:, 1])).mean()
    n_data = axis_size(mesh, DATA_AXIS)
    losses = all_reduce(torch.stack([total, l1]), mesh, DATA_AXIS) / n_data
    counters = torch.stack([overflow, truncated])
    counters = all_reduce(all_reduce(counters, mesh, GAUSS_AXIS), mesh, DATA_AXIS)

    with torch.no_grad():
        # the gradient of the mean loss over the views and the data rows
        grads = [x / n_views for x in grads]
        if n_data > 1:
            grads = [all_reduce(x, mesh, DATA_AXIS) / n_data for x in grads]
        if update_stats:
            vis = [r > 0 for r in radii_v]
            gnorm = [torch.linalg.vector_norm(x[:, :2], dim=-1) for x in ndc_g]
            acc = sum(torch.where(m, x, torch.zeros_like(x)) for m, x in zip(vis, gnorm))
            cnt = sum(m.to(model.denom.dtype) for m in vis)
            rmax = torch.stack(radii_v).amax(0)
            model.xyz_gradient_accum += all_reduce(acc, mesh, DATA_AXIS)
            model.denom += all_reduce(cnt, mesh, DATA_AXIS)
            rmax = all_reduce(rmax, mesh, DATA_AXIS, op=dist.ReduceOp.MAX)
            model.max_radii2d.copy_(torch.maximum(model.max_radii2d, rmax))
        if do_adam:
            if not torch.is_tensor(step):
                step = torch.full((), step, dtype=torch.int32, device=dev)
            lrs = opt_ops.group_lrs(lr_cfg, spatial_lr_scale, step)
            if skip_opacity_update:
                lrs["opacity"] = 0.0
            opt_ops.adam_step(params, dict(zip(names, grads)), opt_state, lrs, model.active)
    return dict(
        loss=losses[0], l1=losses[1], overflow=counters[0], truncated=counters[1],
        image=image.detach(),
    )


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
