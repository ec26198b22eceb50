"""Evaluation and recording: the `renderAndRecordAllKeyframes` analog.

Counterpart of `omnigs_tpu/train/eval.py`: a timed forward render per
keyframe (the host clock around a render that ends in a device
synchronise, after one warm-up render), SSIM / PSNR / PSNR-GS against the
skip-bottom-cropped ground truth with the rendered image masked, image
dumps as PNG (PIL, as the JAX package writes them), and the four metric
files (`render_time.txt`, `dssim.txt`, `psnr.txt`,
`psnr_gaussian_splatting.txt`) in the same one-line-per-keyframe format.
The render is `train/renderer.render_model`: on a card, the segmented
forward kernel (`ops/composite_seg.py`).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from omnigs_torch.model.gaussians import GaussianModel
from omnigs_torch.ops import loss as loss_ops
from omnigs_torch.ops.rasterize import RasterConfig
from omnigs_torch.scene.scene import Scene
from omnigs_torch.train.renderer import render_model


def save_image(path: Path, img: np.ndarray) -> None:
    """Save a (3, H, W) channels-first (or (H, W, 3)) float image as PNG."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = arr.transpose(1, 2, 0)
    Image.fromarray(np.clip(arr * 255.0, 0, 255).astype(np.uint8)).save(path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def render_and_record_keyframe(
    model: GaussianModel,
    kf,
    sh_degree: int,
    raster_cfg: RasterConfig,
    bg: torch.Tensor,
    skip_bottom_ratio: float = 0.0,
    mask: Optional[np.ndarray] = None,
):
    """One keyframe: timed render + metrics. ``mask`` (the camera's
    undistort mask) multiplies the rendered image only. Returns (result,
    masked image, metrics)."""
    dev = model.xyz.device
    vm = torch.as_tensor(kf.viewmatrix, device=dev)
    campos = torch.as_tensor(kf.campos, device=dev)

    def render():
        return render_model(model, kf.camera, vm, campos, bg, sh_degree, raster_cfg)

    render()  # warm-up: the first call builds the kernels and caches
    _sync(dev)
    t0 = time.monotonic()
    res = render()
    _sync(dev)
    render_time_ms = (time.monotonic() - t0) * 1000.0

    image = res.image  # (3, H, W)
    if mask is not None:
        image = image * torch.as_tensor(mask, device=dev)
    metrics: Dict[str, float] = {"render_time_ms": render_time_ms}
    if kf.image is not None:
        gt = torch.as_tensor(kf.image, dtype=image.dtype, device=dev).permute(2, 0, 1)
        image_c, gt_c = image, gt
        if skip_bottom_ratio > 0.0:
            skip = int(round(kf.camera.height * skip_bottom_ratio))
            image_c, gt_c = image[:, :-skip], gt[:, :-skip]
        metrics["ssim"] = float(loss_ops.ssim(image_c, gt_c))
        metrics["psnr"] = float(loss_ops.psnr(image_c, gt_c))
        metrics["psnr_gs"] = float(loss_ops.psnr_gaussian_splatting(image_c, gt_c))
    return res, image, metrics


def render_and_record_all_keyframes(
    model: GaussianModel,
    scene: Scene,
    sh_degree: int,
    raster_cfg: RasterConfig,
    bg: torch.Tensor,
    result_dir: Optional[Path] = None,
    name_suffix: str = "",
    skip_bottom_ratio: float = 0.0,
    record_rendered_image: bool = True,
    record_ground_truth_image: bool = False,
    record_loss_image: bool = False,
) -> Dict[str, float]:
    """Every keyframe, in fid order; with ``result_dir``, the metric files
    and the rendered / ground-truth / |rendered − gt| images the three
    record flags ask for (``image<suffix>/<fid>.png`` and so on). Returns
    the mean metrics."""
    rows = []
    if result_dir is not None:
        result_dir = Path(result_dir)
        image_dir = result_dir / f"image{name_suffix}"
        gt_dir = result_dir / f"image_gt{name_suffix}"
        loss_dir = result_dir / f"image_loss{name_suffix}"
        for flag, d in ((record_rendered_image, image_dir),
                        (record_ground_truth_image, gt_dir),
                        (record_loss_image, loss_dir)):
            if flag:
                d.mkdir(parents=True, exist_ok=True)

    for fid in sorted(scene.keyframes):
        kf = scene.keyframes[fid]
        _, masked, m = render_and_record_keyframe(
            model, kf, sh_degree, raster_cfg, bg, skip_bottom_ratio,
            mask=scene.undistort_mask(kf.camera),
        )
        rows.append((fid, m))
        if result_dir is not None:
            masked = masked.cpu().numpy()
            if record_rendered_image:
                save_image(image_dir / f"{fid}.png", masked)
            gt = None if kf.image is None else np.asarray(kf.image)
            if record_ground_truth_image and gt is not None:
                save_image(gt_dir / f"{fid}.png", gt.transpose(2, 0, 1))
            if record_loss_image and gt is not None:
                save_image(loss_dir / f"{fid}.png", np.abs(masked - gt.transpose(2, 0, 1)))

    if result_dir is not None:
        files = {
            "render_time.txt": "render_time_ms",
            "dssim.txt": "ssim",
            "psnr.txt": "psnr",
            "psnr_gaussian_splatting.txt": "psnr_gs",
        }
        for fname, key in files.items():
            lines = [f"{fid} {m[key]:.6f}" for fid, m in rows if key in m]
            if lines:
                (result_dir / (fname[:-4] + name_suffix + ".txt")).write_text(
                    "\n".join(lines) + "\n"
                )

    means: Dict[str, float] = {}
    for key in ("render_time_ms", "ssim", "psnr", "psnr_gs"):
        vals = [m[key] for _, m in rows if key in m]
        if vals:
            means[key] = float(np.mean(vals))
    return means
