"""What the drivers share: the run's context, the port's configuration and
camera for a cell, the scene handed to the port, and the comparisons."""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from omnibench import harness, scene as S
from omnibench.reference import render as R
from omnibench.reference.train import PARAMS
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (and moves under Adam by round-off alone)
NOUGHT = 1e-3


@dataclasses.dataclass
class Ctx:
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # process start, host clock

    @property
    def scene(self) -> dict:
        return self.cell.config["scene"]

    @property
    def size(self):
        cam = self.cell.config["camera"]
        return cam["width"], cam["height"]

    @property
    def yaml(self) -> dict:
        return self.cell.config["yaml"]

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def now(self) -> float:
        self.sync()
        return time.perf_counter()


def log(ctx: Ctx, what: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    import sys

    print(f"omnibench: {time.perf_counter() - ctx.t0:8.2f} s  {what}", file=sys.stderr, flush=True)


def port_config(ctx: Ctx):
    from omnigs_torch.config import load_config

    name = ctx.cell.config["name"]
    return load_config(harness.write_yaml(ctx.cell.config, harness.BUILD / "configs" / f"{name}.yaml"))


def camera(ctx: Ctx):
    from omnigs_torch.cameras import Camera, CameraType

    w, h = ctx.size
    return Camera(CameraType.LONLAT, w, h)


def pose_tensors(p, device):
    rot, trans = p
    return (torch.from_numpy(S.viewmatrix(rot, trans)).to(device),
            torch.from_numpy(S.campos(rot, trans)).to(device))


def reference_images(ctx: Ctx, raw: Dict[str, torch.Tensor], poses, sh_degree: int,
                     bg: torch.Tensor) -> List[torch.Tensor]:
    """The reference's renders of ``raw`` at ``poses``: the ground truth."""
    w, h = ctx.size
    with R.matmul_precision(tf32=False):
        return [R.render(raw, w, h, *pose_tensors(p, ctx.device), bg, sh_degree)[0] for p in poses]


def port_scene(ctx: Ctx, poses, images: Sequence[torch.Tensor]):
    """The port's Scene of keyframes at ``poses`` with ground truths
    ``images`` ((3, H, W) each; the port's loaders give HWC)."""
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene

    cam = camera(ctx)
    sc = Scene()
    for fid, ((rot, trans), img) in enumerate(zip(poses, images)):
        sc.add_keyframe(Keyframe(fid, cam, rot, trans,
                                 image=img.permute(1, 2, 0).contiguous().cpu().numpy()))
    return sc


def port_model(raw: Dict[str, torch.Tensor], capacity: int, device):
    """A GaussianModel of ``capacity`` slots whose first rows are ``raw``'s
    Gaussians, live."""
    from omnigs_torch.model.gaussians import GaussianModel

    n = raw["xyz"].shape[0]
    m = GaussianModel.empty(capacity, device=device)
    with torch.no_grad():
        for k in PARAMS:
            getattr(m, k)[:n].copy_(raw[k])
        m.active[:n] = True
    return m


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least NOUGHT of the
    median leaf's (the others move under Adam by round-off alone)."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NOUGHT * med]


def worst_norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> float:
    """The worst of ``leaves``' gaps between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    med = statistics.median(ref.values())
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]
    return max(gaps) if gaps else float("nan")


def sampler_fids(seed: int, fids: Sequence[int], draws: int) -> List[int]:
    """The keyframes a times-of-use-1 sampler draws: each keyframe once a
    round, uniformly among those left (``random.Random(seed).choice``)."""
    import random

    rng = random.Random(seed)
    left: List[int] = []
    out = []
    for _ in range(draws):
        if not left:
            left = list(fids)
        f = rng.choice(left)
        left.remove(f)
        out.append(f)
    return out


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
