"""Where the port's float32 training step and the JAX package's op-by-op
float32 step part, stage by stage, on `xla_gap_step.py`'s case (the render
model through the XLA backend, L1 + SSIM, gradients against the port's
float64 step at the JAX Pallas-vs-XLA bar).

Prints one JSON line: whether the two float32 images and image gradients
(dL/dimage) are equal, and per parameter group the misses and the bar
ratios of four gradients: the port's, JAX's, the port's backward fed JAX's
dL/dimage and JAX's backward fed the port's. With ``--gaussian G`` also
G's ratios and its preprocess outputs in the three steps. ``--xla-asin``
runs the port's `lonlat_project` with XLA's float32 asin values (its
gradient unchanged), which decides whether the asin is the stage.

    python tests/xla_gap_stages.py --width 480 --height 240 --gaussians 32768
        --seed 2 --gaussian 17272 [--xla-asin]

CPU only, JAX op by op (``jax.disable_jit()``); ~100 s at that size.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import xla_gap_step as X  # noqa: E402  (sets JAX to the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import omnigs_torch.cameras as tcams  # noqa: E402
import omnigs_torch.ops.preprocess as tpre  # noqa: E402
from omnigs_torch.model.gaussians import PARAM_NAMES  # noqa: E402
from omnigs_torch.model.gaussians import GaussianModel as TModel  # noqa: E402
from omnigs_torch.ops import loss as tloss  # noqa: E402
from omnigs_torch.ops.rasterize import RasterConfig as TRasterConfig  # noqa: E402
from omnigs_torch.train.renderer import render_model as trender  # noqa: E402
from omnigs_tpu.cameras import Camera, CameraType  # noqa: E402
from omnigs_tpu.model.gaussians import GaussianModel as JModel  # noqa: E402
from omnigs_tpu.ops import loss as jloss  # noqa: E402
from omnigs_tpu.ops import preprocess as jpre  # noqa: E402
from omnigs_tpu.ops.rasterize import RasterConfig as JRasterConfig  # noqa: E402
from omnigs_tpu.train.renderer import render_model as jrender  # noqa: E402


class _XlaAsin(torch.autograd.Function):
    """float32 asin with XLA's op-by-op values; torch's derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.dtype != torch.float32:
            return torch.asin(x)
        return torch.from_numpy(np.array(jnp.arcsin(jnp.asarray(x.detach().numpy()))))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / torch.sqrt(1 - x * x)


def lonlat_project_xla_asin(t, width, height):
    """`cameras.lonlat_project` with `_XlaAsin` in place of `torch.asin`."""
    rr = torch.sum(t * t, dim=-1)
    r = torch.sqrt(rr)
    inv_r = 1.0 / (r + tcams._EPS)
    lon = torch.atan2(t[..., 0], t[..., 2])
    lat = _XlaAsin.apply(torch.clamp(t[..., 1] * inv_r, -1.0, 1.0))
    pix = torch.stack([tcams.ndc2pix(lon * (1.0 / math.pi), width),
                       tcams.ndc2pix(lat * (2.0 / math.pi), height)], dim=-1)
    return pix, r, rr > 0.04


def _loss(pred, gt, ops):
    return 0.8 * ops.l1_loss(pred, gt) + 0.2 * (1.0 - ops.ssim(pred, gt))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--gaussians", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--gaussian", type=int, default=-1)
    ap.add_argument("--xla-asin", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.xla_asin:
        tpre.lonlat_project = lonlat_project_xla_asin
    fields = X.render_model_np(args.gaussians, args.seed)
    w, h = args.width, args.height
    tcam = tcams.Camera(tcams.CameraType.LONLAT, w, h)
    jcam = Camera(CameraType.LONLAT, w, h)
    tcfg = TRasterConfig(max_instances=X.MAX_INSTANCES, **X.XLA_KW)
    jcfg = JRasterConfig(max_instances=X.MAX_INSTANCES, **X.XLA_KW)
    vm1, campos1 = X.pose_np(1)
    with torch.no_grad():
        gt = trender(TModel.from_numpy(fields, device="cpu"), tcam, torch.from_numpy(vm1),
                     torch.from_numpy(campos1), torch.zeros(3), X.SH_DEGREE, tcfg).image.numpy()
    vm, campos = X.pose_np(0)

    def port(dtype, image_grad=None):
        wide = {k: v.astype(np.float64) if v.dtype == np.float32 and dtype == torch.float64
                else v for k, v in fields.items()}
        m = TModel.from_numpy(wide, device="cpu")
        params = m.params()
        img = trender(m, tcam, torch.from_numpy(vm).to(dtype),
                      torch.from_numpy(campos).to(dtype), torch.zeros(3, dtype=dtype),
                      X.SH_DEGREE, tcfg).image
        leaf = img.detach().requires_grad_(True)
        (G,) = torch.autograd.grad(_loss(leaf, torch.from_numpy(gt).to(dtype), tloss), leaf)
        use = G if image_grad is None else torch.from_numpy(np.array(image_grad)).to(dtype)
        grads = torch.autograd.grad(img, [params[k] for k in PARAM_NAMES], grad_outputs=use,
                                    allow_unused=True)
        prep = tpre.preprocess(m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(),
                               m.get_features(), tcam, torch.from_numpy(vm).to(dtype),
                               torch.from_numpy(campos).to(dtype), X.SH_DEGREE,
                               active_mask=m.active, tight_culling=True)
        return (img.detach().numpy(), G.numpy(),
                {k: np.zeros(params[k].shape) if g is None else g.numpy().astype(np.float64)
                 for k, g in zip(PARAM_NAMES, grads)}, prep)

    img32, G32, g32, prep32 = port(torch.float32)
    _, _, g64, prep64 = port(torch.float64)
    with jax.disable_jit():
        model = JModel(**{k: jnp.asarray(v) for k, v in fields.items()})

        def render(p):
            return jrender(model.replace(**p), jcam, jnp.asarray(vm), jnp.asarray(campos),
                           jnp.zeros(3), X.SH_DEGREE, jcfg).image

        imgj, vjp = jax.vjp(render, model.params())
        Gj = np.asarray(jax.grad(lambda p: _loss(p, jnp.asarray(gt), jloss))(imgj))
        gj = {k: np.asarray(v, np.float64) for k, v in vjp(jnp.asarray(Gj))[0].items()}
        gj_portG = {k: np.asarray(v, np.float64) for k, v in vjp(jnp.asarray(G32))[0].items()}
        prepj = jpre.preprocess(model.xyz, model.get_scaling(), model.get_rotation(),
                                model.get_opacity(), model.get_features(), jcam,
                                jnp.asarray(vm), jnp.asarray(campos), X.SH_DEGREE,
                                active_mask=model.active, tight_culling=True)
    _, _, g32_jaxG, _ = port(torch.float32, Gj)
    imgj = np.asarray(imgj)
    out = {"size": [w, h, args.gaussians], "seed": args.seed, "xla_asin": args.xla_asin,
           "image_differs": int((img32 != imgj).sum()), "image_grad_differs": int((G32 != Gj).sum()),
           "pixels": int(img32.size)}
    runs = {"port": g32, "jax": gj, "port_with_jax_image_grad": g32_jaxG,
            "jax_with_port_image_grad": gj_portG}
    for k in PARAM_NAMES:
        ratios = {n: X.bar_ratio(g[k], g64[k]) for n, g in runs.items()}
        d = {"misses": {n: int((r > 1).sum()) for n, r in ratios.items()},
             "port_only": np.nonzero((ratios["port"] > 1) & (ratios["jax"] <= 1))[0][:10].tolist(),
             "jax_only": np.nonzero((ratios["jax"] > 1) & (ratios["port"] <= 1))[0][:10].tolist()}
        if args.gaussian >= 0:
            d["gaussian_ratio"] = {n: float(r[args.gaussian]) for n, r in ratios.items()}
        out[k] = d
    # the lonlat asin over this step's Gaussians: its float32 inputs (the
    # port's), ulps off the correctly rounded asin in each package
    t = torch.from_numpy(fields["xyz"]) @ torch.from_numpy(vm[:3, :3]).T + torch.from_numpy(vm[:3, 3])
    arg = torch.clamp(t[:, 1] * (1.0 / (torch.sqrt(torch.sum(t * t, dim=-1)) + tcams._EPS)),
                      -1.0, 1.0).numpy()
    exact = np.arcsin(arg.astype(np.float64)).astype(np.float32)
    with jax.disable_jit():
        xla = np.asarray(jnp.arcsin(jnp.asarray(arg)))
    port = torch.asin(torch.from_numpy(arg)).numpy()

    def ulps(a):
        return np.abs(a.view(np.int32).astype(np.int64) - exact.view(np.int32))

    out["asin"] = {"inputs": int(arg.size),
                   "port_not_correctly_rounded": int((port != exact).sum()),
                   "xla_not_correctly_rounded": int((xla != exact).sum()),
                   "port_max_ulp": int(ulps(port).max()), "xla_max_ulp": int(ulps(xla).max())}
    if args.gaussian >= 0:
        g = args.gaussian
        x = float(arg[g])
        out["gaussian_asin"] = {"input": x, "port": float(port[g]), "xla": float(xla[g]),
                                "exact": float(np.arcsin(np.float64(arg[g]))),
                                "degrees_from_pole": 90.0 - abs(math.degrees(math.asin(x))),
                                "gain": 1.0 / math.sqrt(1.0 - x * x)}
        out["gaussian_means2d"] = {
            "port32": prep32.means2d[g].tolist(), "jax32": np.asarray(prepj.means2d[g]).tolist(),
            "port64": prep64.means2d[g].tolist()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
