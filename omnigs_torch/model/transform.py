"""Point ops: visibility marking, Sim(3) re-transforms of the model and
mid-training point insertion (the SLAM-heritage surface of the reference).

Counterpart of `omnigs_tpu/model/transform.py`: masked, vectorized ops on
the fixed-capacity model. As in the rest of the port they update the model
and the Adam state in place (the JAX functions return new ones); the Adam
moments of rewritten fields are zeroed, the reference's
``replaceTensorToOptimizer`` surgery. No entry point of either package
calls them; their tests do.
"""

from __future__ import annotations

import torch

from omnigs_torch.cameras import CameraType, world_to_cam
from omnigs_torch.model.densify import _scatter_new_items
from omnigs_torch.model.gaussians import GaussianModel, inverse_sigmoid
from omnigs_torch.model.optimizer import AdamState, zero_moments
from omnigs_torch.ops import sh as sh_ops


def mark_visible(points: torch.Tensor, viewmatrix: torch.Tensor,
                 camera_type: CameraType) -> torch.Tensor:
    """Frustum-cull predicate. Reference quirk kept: the lonlat camera marks
    everything visible; pinhole culls camera-space z ≤ 0.2."""
    if camera_type == CameraType.LONLAT:
        return torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    return world_to_cam(points, viewmatrix)[..., 2] > 0.2


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) Hamilton product, broadcasting."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation → (w, x, y, z) unit quaternion (branch-free Shepperd:
    the candidate of the largest diagonal root, first on ties)."""
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = (row.unbind(0) for row in R)
    tr = m00 + m11 + m22
    qs = torch.sqrt(torch.clamp_min(torch.stack([
        1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22,
    ]), 1e-12))
    cands = torch.stack([
        torch.stack([qs[0], (m21 - m12) / qs[0], (m02 - m20) / qs[0], (m10 - m01) / qs[0]]),
        torch.stack([(m21 - m12) / qs[1], qs[1], (m01 + m10) / qs[1], (m02 + m20) / qs[1]]),
        torch.stack([(m02 - m20) / qs[2], (m01 + m10) / qs[2], qs[2], (m12 + m21) / qs[2]]),
        torch.stack([(m10 - m01) / qs[3], (m02 + m20) / qs[3], (m12 + m21) / qs[3], qs[3]]),
    ])
    q = 0.5 * cands[torch.argmax(qs)]
    return q / torch.linalg.vector_norm(q)


def _all_slots(model: GaussianModel) -> torch.Tensor:
    return torch.ones(model.capacity, dtype=torch.bool, device=model.xyz.device)


@torch.no_grad()
def apply_scaled_transformation(model: GaussianModel, opt_state: AdamState, s: float,
                                T: torch.Tensor) -> None:
    """Sim(3) re-transform of the whole model, in place: xyz ← T·(s·xyz),
    log-scales shifted by log(s), quaternions rotated by T's rotation; the
    xyz / scaling / rotation Adam moments zeroed. As in the JAX package,
    the mathematically intended ``+ log(s)`` (the reference multiplies the
    log-scales by s) and the rotated quaternions (the reference leaves them)."""
    R, t = T[:3, :3], T[:3, 3]
    model.xyz.copy_((s * model.xyz) @ R.T + t)
    model.scaling.add_(torch.log(torch.tensor(s, dtype=model.scaling.dtype)))
    model.rotation.copy_(quat_multiply(rotmat_to_quat(R)[None, :], model.rotation))
    zero_moments(opt_state, _all_slots(model), names=("xyz", "scaling", "rotation"))


@torch.no_grad()
def scaled_transform_visible_points(
    model: GaussianModel,
    opt_state: AdamState,
    not_transformed: torch.Tensor,
    diff_pose: torch.Tensor,
    kf_viewmatrix: torch.Tensor,
    kf_creation_iter: int,
    stable_num_iter_existence: int,
    camera_type: CameraType,
    scale: float = 1.0,
):
    """Loop-closure correction, in place: re-transform the unstable,
    visible, not yet transformed live points by ``diff_pose`` (rotations
    normalized first); xyz / rotation moments zeroed. Returns
    (not_transformed', number transformed)."""
    unstable = (model.exist_since_iter - kf_creation_iter).abs() < stable_num_iter_existence
    present = mark_visible(model.xyz, kf_viewmatrix, camera_type)
    mask = not_transformed & unstable & present & model.active
    R, t = diff_pose[:3, :3], diff_pose[:3, 3]
    new_xyz = (scale * model.xyz) @ R.T + t
    new_rot = quat_multiply(rotmat_to_quat(R)[None, :], model.get_rotation())
    model.xyz.copy_(torch.where(mask[:, None], new_xyz, model.xyz))
    model.rotation.copy_(torch.where(mask[:, None], new_rot, model.rotation))
    zero_moments(opt_state, _all_slots(model), names=("xyz", "rotation"))
    return not_transformed & ~mask, torch.sum(mask)


@torch.no_grad()
def increase_pcd(
    model: GaussianModel,
    opt_state: AdamState,
    points: torch.Tensor,
    colors: torch.Tensor,
    mean_sq_nn_dist: torch.Tensor,
    iteration: int,
) -> torch.Tensor:
    """Append SfM points mid-training into free slots, in place: RGB → SH
    dc, the knn scale, identity rotation, opacity 0.1, zeroed moments at
    the written slots. Returns the number of points dropped for want of
    free slots."""
    n, cap = points.shape[0], model.capacity
    if n > cap:
        raise ValueError(f"{n} new points exceed the capacity {cap}")
    dev, dt = points.device, points.dtype

    def padded(x):
        return torch.cat([x, x.new_zeros((cap - n,) + tuple(x.shape[1:]))])

    scale = torch.log(torch.sqrt(torch.clamp_min(mean_sq_nn_dist, 1e-7)))
    items = {
        "xyz": padded(points),
        "features_dc": padded(sh_ops.rgb2sh(colors)[:, None, :]),
        "features_rest": torch.zeros_like(model.features_rest),
        "scaling": padded(scale[:, None].expand(n, 3)),
        "rotation": padded(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt, device=dev).expand(n, 4)),
        "opacity": padded(inverse_sigmoid(torch.tensor(0.1, dtype=dt)).to(dev).expand(n, 1)),
        "exist_since_iter": torch.full((cap,), iteration, dtype=torch.int32, device=dev),
    }
    valid = torch.arange(cap, device=dev) < n
    slot_written, dropped = _scatter_new_items(model, items, valid)
    zero_moments(opt_state, slot_written)
    return dropped
