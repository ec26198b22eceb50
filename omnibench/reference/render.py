"""Plain float32 reference of one lonlat Gaussian-splatting render.

Written from the published method (3D Gaussian splatting with an
equirectangular camera, as OmniGS renders 360-degree panoramas), in plain
PyTorch, with no kernel, no static capacity and no packed layout:

* activation: exp scales, normalised quaternions (w, x, y, z), sigmoid
  opacity, SH coefficients dc first;
* projection: world -> camera by T_cw, lon = atan2(x, z), lat = asin(y / r),
  pixel = ((s + 1) * size - 1) / 2 with s = (lon / pi, 2 lat / pi); depth is
  the radial distance; points with r^2 <= 0.04 are culled;
* covariance: Sigma = R diag(s^2) R^T, EWA cov2D = J W Sigma W^T J^T + 0.3 I
  with J the equirectangular Jacobian (the +1e-7 pole guards of the
  reference implementation);
* colour: real SH of degree <= 3 along the normalised (mean - campos), + 0.5,
  clamped at 0;
* tight culling: screen radius ceil(k sqrt(lambda_max)) with
  k = min(3, sqrt(2 ln(255 opacity))), the bounding rectangle of 16x16
  tiles, and a (Gaussian, tile) pair dropped where the largest alpha over
  the tile's pixels stays under 1/255;
* compositing: each tile's instances front to back by (depth, index),
  alpha = min(0.99, opacity exp(power)), pairs with power > 0 or
  alpha < 1/255 skipped, a pixel stopping before the first pair that would
  take its transmittance under 1e-4; image = colour + T bg.

Every product runs in full float32 (`matmul_precision`, TF32 off). Pixel
centres sit at integer coordinates. The compositor works on (pair)
tensors of whole tiles, a chunk of tiles at a time, and takes each pixel's
transmittance and colour from float64 prefix sums (of log(1 - alpha) and of
the weighted colours), so it needs no loop over depth. Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, NamedTuple

import torch

TILE = 16
PX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1.0e-4
LOW_PASS = 0.3
GUARD = 1.0e-7
# pixel-instance pairs the compositor holds at once: about 2 GB of
# temporaries with gradients, 4 GB without
GRAD_PAIR_BUDGET = 1 << 24
PAIR_BUDGET = 1 << 26
# (Gaussian, tile) candidates the binning tests at once
SLOT_BUDGET = 1 << 24

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@contextlib.contextmanager
def matmul_precision(tf32: bool = False):
    """Float32 products in full float32 (the reference's precision), or in
    TF32 on the card's tensor cores (the control's); restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Projected(NamedTuple):
    """Per-Gaussian screen state, one row per Gaussian."""

    means2d: torch.Tensor  # (N, 2) pixels
    conic: torch.Tensor  # (N, 3) inverse cov2D (A, B, C)
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor  # (N, 3)
    depth: torch.Tensor  # (N,) radial distance
    rect: torch.Tensor  # (N, 4) int64 tile rectangle [x0, y0, x1, y1)
    valid: torch.Tensor  # (N,) bool


class Bins(NamedTuple):
    """(Gaussian, tile) instances sorted by (tile, depth, Gaussian)."""

    gid: torch.Tensor  # (I,) int64
    tile: torch.Tensor  # (I,) int64
    starts: torch.Tensor  # (T,) int64 first instance of each tile
    counts: torch.Tensor  # (T,) int64


def activate(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw parameters (log-scales, quaternions, opacity logits, dc and rest
    SH) -> the quantities the renderer uses."""
    q = raw["rotation"]
    return dict(
        means=raw["xyz"],
        scales=torch.exp(raw["scaling"]),
        quats=q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12),
        opacity=torch.sigmoid(raw["opacity"][:, 0]),
        shs=torch.cat([raw["features_dc"], raw["features_rest"]], dim=1),
    )


def eval_sh(degree: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of ``degree`` at unit directions ``d``."""
    out = SH_C0 * sh[:, 0]
    if degree < 1:
        return out
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
           + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
           + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree < 3:
        return out
    return (out + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def project(g: Dict[str, torch.Tensor], width: int, height: int,
            viewmatrix: torch.Tensor, campos: torch.Tensor, sh_degree: int) -> Projected:
    """Activated Gaussians ``g`` (see `activate`) seen from T_cw
    ``viewmatrix`` by a ``width`` x ``height`` equirectangular camera."""
    rot, trans = viewmatrix[:3, :3], viewmatrix[:3, 3]
    t = g["means"] @ rot.T + trans
    in_front = (t * t).sum(-1) > 0.04
    # a harmless point where culled, so no NaN reaches a gradient
    t = torch.where(in_front[:, None], t, t.new_tensor([0.0, 0.0, 1.0]))
    x, y, z = t.unbind(-1)
    r = torch.sqrt((t * t).sum(-1))
    lon = torch.atan2(x, z)
    lat = torch.asin(torch.clamp(y / (r + GUARD), -1.0, 1.0))
    means2d = torch.stack([((lon / math.pi + 1.0) * width - 1.0) * 0.5,
                           ((2.0 * lat / math.pi + 1.0) * height - 1.0) * 0.5], -1)
    rxz2 = x * x + z * z
    rxz = torch.sqrt(rxz2)
    rr = rxz2 + y * y
    fx, fy = width / (2.0 * math.pi), height / math.pi
    zero = torch.zeros_like(x)
    jac = torch.stack([
        torch.stack([fx * z / (rxz2 + GUARD), zero, -fx * x / (rxz2 + GUARD)], -1),
        torch.stack([-fy * x * y / ((rxz + GUARD) * (rr + GUARD)),
                     fy * rxz / (rr + GUARD),
                     -fy * z * y / ((rxz + GUARD) * (rr + GUARD))], -1),
    ], -2)  # (N, 2, 3)
    rmat = quat_to_rotmat(g["quats"])
    m = rmat * g["scales"][:, None, :]
    sigma = m @ m.transpose(1, 2)
    jw = jac @ rot
    cov2d = jw @ sigma @ jw.transpose(1, 2)
    a = cov2d[:, 0, 0] + LOW_PASS
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + LOW_PASS
    det = a * c - b * b
    ok = det != 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    op = g["opacity"]
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    k = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp_min(255.0 * op, 1e-6))), 0.0, 3.0)
    radius = torch.ceil(k * torch.sqrt(lam)).detach()
    gx, gy = -(-width // TILE), -(-height // TILE)
    m2 = means2d.detach()

    def tile_of(v, lim):
        return torch.clamp(torch.floor(v).to(torch.int64), 0, lim)

    rect = torch.stack([
        tile_of((m2[:, 0] - radius) / TILE, gx), tile_of((m2[:, 1] - radius) / TILE, gy),
        tile_of((m2[:, 0] + radius + TILE - 1) / TILE, gx),
        tile_of((m2[:, 1] + radius + TILE - 1) / TILE, gy),
    ], -1)
    area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    valid = in_front & ok & (area > 0)
    d = g["means"] - campos
    d = torch.where(in_front[:, None], d, d.new_tensor([0.0, 0.0, 1.0]))
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(sh_degree, g["shs"], d) + 0.5
    rgb = torch.maximum(rgb, torch.zeros_like(rgb))
    return Projected(means2d, conic, op, rgb, r, rect, valid)


def _min_quadratic(A, B, C, u0, u1, v0, v1):
    """Least value of A u^2 + 2 B u v + C v^2 over [u0, u1] x [v0, v1]."""
    eps = 1e-12

    def q(u, v):
        return A * u * u + 2.0 * B * u * v + C * v * v

    edges = torch.stack([
        q(u0, torch.clamp(-B * u0 / torch.clamp_min(C, eps), v0, v1)),
        q(u1, torch.clamp(-B * u1 / torch.clamp_min(C, eps), v0, v1)),
        q(torch.clamp(-B * v0 / torch.clamp_min(A, eps), u0, u1), v0),
        q(torch.clamp(-B * v1 / torch.clamp_min(A, eps), u0, u1), v1),
    ]).amin(0)
    inside = (u0 <= 0) & (u1 >= 0) & (v0 <= 0) & (v1 >= 0)
    return torch.where(inside, torch.zeros_like(edges), edges)


@torch.no_grad()
def bin_tiles(p: Projected, width: int, height: int) -> Bins:
    """Every (Gaussian, tile) pair of each valid Gaussian's rectangle that
    survives the tight-culling test, sorted front to back within tiles."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    dev = p.depth.device
    idx = torch.nonzero(p.valid).squeeze(1)
    rect = p.rect[idx]
    w = rect[:, 2] - rect[:, 0]
    area = w * (rect[:, 3] - rect[:, 1])
    gids, tiles = [], []
    ends = torch.cumsum(area, 0)
    lo = 0
    while lo < idx.numel():  # Gaussians in blocks of about SLOT_BUDGET pairs
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + SLOT_BUDGET, right=True))
        hi = max(hi, lo + 1)
        a = area[lo:hi]
        owner = torch.repeat_interleave(torch.arange(lo, hi, device=dev), a)
        local = torch.arange(owner.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(a, 0) - a, a)
        tx = rect[owner, 0] + local % w[owner]
        ty = rect[owner, 1] + local // w[owner]
        g = idx[owner]
        m, cn, op = p.means2d[g], p.conic[g], p.opacity[g]
        u0 = (tx * TILE).to(m.dtype) - m[:, 0]
        v0 = (ty * TILE).to(m.dtype) - m[:, 1]
        qmin = _min_quadratic(cn[:, 0], cn[:, 1], cn[:, 2], u0, u0 + (TILE - 1), v0, v0 + (TILE - 1))
        keep = op * torch.exp(-0.5 * qmin) >= ALPHA_MIN
        gids.append(g[keep])
        tiles.append((ty * gx + tx)[keep])
        lo = hi
    gid = torch.cat(gids) if gids else torch.zeros(0, dtype=torch.int64, device=dev)
    tile = torch.cat(tiles) if tiles else torch.zeros_like(gid)
    order = torch.sort(p.depth[gid], stable=True).indices
    gid, tile = gid[order], tile[order]
    order = torch.sort(tile, stable=True).indices
    gid, tile = gid[order], tile[order]
    counts = torch.bincount(tile, minlength=gx * gy)
    return Bins(gid, tile, torch.cumsum(counts, 0) - counts, counts)


def _chunks(bins: Bins, budget: int):
    """Instance ranges [a, b) of whole tiles, about ``budget`` pairs each."""
    ends = torch.cumsum(bins.counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    per = max(budget // PX, 1)
    a = 0
    while a < total:
        # the first tile end at or past a + per
        t = int(torch.searchsorted(ends, a + per, right=False))
        b = int(ends[min(t, ends.numel() - 1)])
        yield a, max(b, a + 1)
        a = b


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive float64 prefix sums along the last dim of ``x``, one more
    column than ``x`` (the row's total last). One flat scan of the whole
    tensor: each row also carries the rows before it, which cancels in
    any difference of two entries of one row."""
    flat = torch.cumsum(x.double().reshape(-1), 0).reshape(x.shape)
    return torch.cat([flat - x.double(), flat[..., -1:]], -1)


def _composite_chunk(means2d, conic, opacity, rgb, bins: Bins, a: int, b: int, gx: int):
    """(tiles, colour (n, 3, PX), log-T (n, PX), composited pairs) of the
    tiles whose instances are [a, b). Pairs are laid out
    (PX, instances): each pixel's instances in depth order along a row."""
    g = bins.gid[a:b]
    tile = bins.tile[a:b]
    first_tile, last_tile = int(tile[0]), int(tile[-1])
    tiles = torch.arange(first_tile, last_tile + 1, device=g.device)
    lane = torch.arange(PX, device=g.device)[:, None]
    dt = means2d.dtype
    px = ((tile % gx) * TILE).to(dt)[None, :] + (lane % TILE).to(dt)
    py = ((tile // gx) * TILE).to(dt)[None, :] + (lane // TILE).to(dt)
    m, cn = means2d[g], conic[g]
    dx = m[:, 0] - px
    dy = m[:, 1] - py
    power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * dx * dy
    alpha = torch.clamp_max(opacity[g] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
    live = (power <= 0.0) & (alpha >= ALPHA_MIN)
    lg = torch.where(live, torch.log1p(-alpha), torch.zeros_like(alpha))
    # each pair's log-transmittance before it: the prefix within its tile
    before = _prefix(lg)
    s_excl = (before[:, :-1] - before[:, bins.starts[tile] - a]).to(dt)
    t_excl = torch.exp(s_excl)
    gate = (live & (t_excl * (1.0 - alpha) >= T_STOP)).detach()
    wgt = torch.where(gate, alpha * t_excl, torch.zeros_like(alpha))
    first = bins.starts[tiles] - a
    end = first + bins.counts[tiles]
    csum = _prefix(wgt[None] * rgb[g].T[:, None, :])  # (3, PX, n + 1)
    color = (csum[..., end] - csum[..., first]).to(dt).permute(2, 0, 1)
    lsum = _prefix(torch.where(gate, lg, torch.zeros_like(lg)))
    log_t = (lsum[:, end] - lsum[:, first]).to(dt).T
    return tiles, color, log_t, int(gate.sum())


def _to_image(tiles_rgb: torch.Tensor, width: int, height: int) -> torch.Tensor:
    gx, gy = -(-width // TILE), -(-height // TILE)
    img = tiles_rgb.reshape(gy, gx, 3, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(3, gy * TILE, gx * TILE)[:, :height, :width]


def _from_image(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    gx, gy = -(-width // TILE), -(-height // TILE)
    full = img.new_zeros(3, gy * TILE, gx * TILE)
    full[:, :height, :width] = img
    return full.reshape(3, gy, TILE, gx, TILE).permute(1, 3, 0, 2, 4).reshape(gy * gx, 3, PX)


class Counts(NamedTuple):
    """Work of one render as the plain compositor counts it."""

    instances: int  # (Gaussian, tile) pairs after tight culling
    pairs: int  # pixel-instance pairs composited: alpha >= 1/255, power <= 0,
    # before the transmittance stop


@torch.no_grad()
def composite(p: Projected, bins: Bins, width: int, height: int, bg: torch.Tensor):
    """(image (3, H, W), Counts) of the binned instances."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    color = torch.zeros(gx * gy, 3, PX, device=p.depth.device, dtype=p.opacity.dtype)
    log_t = torch.zeros(gx * gy, PX, device=p.depth.device, dtype=p.opacity.dtype)
    pairs = 0
    for a, b in _chunks(bins, PAIR_BUDGET):
        tiles, c, lt, n = _composite_chunk(p.means2d, p.conic, p.opacity, p.rgb, bins, a, b, gx)
        color[tiles], log_t[tiles] = c, lt
        pairs += n
    tiles_rgb = color + torch.exp(log_t)[:, None, :] * bg[None, :, None]
    return _to_image(tiles_rgb, width, height), Counts(int(bins.gid.numel()), pairs)


def render(raw: Dict[str, torch.Tensor], width: int, height: int, viewmatrix, campos,
           bg, sh_degree: int):
    """Image (3, H, W) and Counts of the raw parameters from one pose."""
    with torch.no_grad():
        p = project(activate(raw), width, height, viewmatrix, campos, sh_degree)
        return composite(p, bin_tiles(p, width, height), width, height, bg)


def render_loss_grad(raw: Dict[str, torch.Tensor], width: int, height: int, viewmatrix,
                     campos, bg, sh_degree: int,
                     loss_fn: Callable[[torch.Tensor], torch.Tensor]):
    """(loss, {name: gradient}) of ``loss_fn(image)`` in the raw
    parameters. The image is composited once without gradients; the loss's
    gradient in the image then flows back tile chunk by tile chunk through
    the compositor into the screen-space quantities, and from there
    through the projection by autograd."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    p = project(activate(leaves), width, height, viewmatrix, campos, sh_degree)
    screen = [t.detach().requires_grad_(True) for t in (p.means2d, p.conic, p.opacity, p.rgb)]
    flat = Projected(*screen, p.depth.detach(), p.rect, p.valid)
    bins = bin_tiles(flat, width, height)
    image, _ = composite(flat, bins, width, height, bg)
    image.requires_grad_(True)
    loss = loss_fn(image)
    (g_img,) = torch.autograd.grad(loss, image)
    g_tiles = _from_image(g_img, width, height)  # (T, 3, PX)
    gx = -(-width // TILE)
    for a, b in _chunks(bins, GRAD_PAIR_BUDGET):
        tiles, c, lt, _ = _composite_chunk(*screen, bins, a, b, gx)
        out = (c * g_tiles[tiles]).sum()
        out = out + (torch.exp(lt) * (g_tiles[tiles] * bg[None, :, None]).sum(1)).sum()
        out.backward()
    torch.autograd.backward(
        [p.means2d, p.conic, p.opacity, p.rgb],
        [s.grad if s.grad is not None else torch.zeros_like(s) for s in screen])
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}
    return loss.detach(), grads
