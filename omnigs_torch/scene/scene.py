"""Scene container: cameras, keyframes, SfM point cloud, spatial extent.

Counterpart of `omnigs_tpu/scene/scene.py`: holds the camera and keyframe
maps and computes the NeRF++-style normalization radius that scales the
densification thresholds. `KeyframeSampler` draws keyframes with Python's
``random.Random(seed)`` exactly as the JAX package does, so both packages
train on the same keyframe order. A distorted camera gets an undistort
mask (cv2 on the host) that multiplies rendered images in the loss, eval
and viewer.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from omnigs_torch.cameras import Camera, init_undistort_map_and_mask
from omnigs_torch.scene.keyframe import Keyframe


@dataclasses.dataclass
class Scene:
    cameras: Dict[int, Camera] = dataclasses.field(default_factory=dict)
    keyframes: Dict[int, Keyframe] = dataclasses.field(default_factory=dict)
    points: Optional[np.ndarray] = None  # (N, 3)
    colors: Optional[np.ndarray] = None  # (N, 3) in [0, 1]
    # per-camera (H, W) float32 undistort masks; none for distortion-free
    # cameras
    undistort_masks: Dict[Camera, np.ndarray] = dataclasses.field(
        default_factory=dict
    )

    def add_keyframe(self, kf: Keyframe):
        self.keyframes[kf.fid] = kf

    def build_undistort_masks(self):
        """Build the mask of every distorted camera (idempotent); call after
        the cameras are registered."""
        cams = set(self.cameras.values()) | {
            kf.camera for kf in self.keyframes.values()
        }
        for cam in cams:
            if cam.distortion and cam not in self.undistort_masks:
                _, _, mask = init_undistort_map_and_mask(cam)
                if mask is not None:
                    self.undistort_masks[cam] = mask

    def undistort_mask(self, camera: Camera) -> Optional[np.ndarray]:
        """(H, W) float mask for this camera, or None (no distortion)."""
        if camera.distortion and camera not in self.undistort_masks:
            self.build_undistort_masks()
        return self.undistort_masks.get(camera)

    def nerfpp_norm(self) -> Tuple[np.ndarray, float]:
        """(translate, radius): camera-centroid offset and 1.1× the max
        camera distance from it (the densification extent)."""
        centers = np.stack([kf.campos for kf in self.keyframes.values()])
        avg = centers.mean(axis=0)
        radius = float(np.linalg.norm(centers - avg, axis=-1).max() * 1.1)
        return -avg, radius


class KeyframeSampler:
    """Random keyframe scheduling with times-of-use budgets: each keyframe
    gets ``times_of_use`` charges, a random charged keyframe is drawn each
    iteration, and when every budget is spent all are refilled."""

    def __init__(self, scene: Scene, times_of_use: int = 1, seed: int = 0):
        self.scene = scene
        self.times_of_use = times_of_use
        self.rng = random.Random(seed)
        self.used_times: Dict[int, int] = {fid: 0 for fid in scene.keyframes}
        self._refill()

    def _refill(self):
        for kf in self.scene.keyframes.values():
            kf.remaining_times_of_use = self.times_of_use

    def sample(self) -> Keyframe:
        pool: List[int] = [
            fid
            for fid, kf in self.scene.keyframes.items()
            if kf.remaining_times_of_use > 0
        ]
        if not pool:
            self._refill()
            pool = list(self.scene.keyframes)
        fid = self.rng.choice(pool)
        kf = self.scene.keyframes[fid]
        kf.remaining_times_of_use -= 1
        self.used_times[fid] += 1
        return kf
