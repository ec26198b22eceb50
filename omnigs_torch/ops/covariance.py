"""Gaussian covariance math: quaternion → R, 3D covariance, EWA 2D covariance.

Counterpart of `omnigs_tpu/ops/covariance.py`:

  Σ₃         = R · diag(s²) · Rᵀ
  cov2D      = J · R_cw · Σ₃ · R_cwᵀ · Jᵀ + 0.3·I

with J the (2, 3) projection Jacobian and R_cw = viewmatrix[:3, :3].
Quaternions are (w, x, y, z) and consumed as-is (the model activation
normalizes). cov3d packing: [xx, xy, xz, yy, yz, zz].

The component (column) forms are what `preprocess` uses; they keep the
exact operation order of the JAX functions so both packages round alike.
"""

from __future__ import annotations

import torch

LOW_PASS = 0.3  # EWA anti-alias floor added to the cov2D diagonal


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) unit quaternion(s) → (..., 3, 3) rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def build_cov3d(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """(..., 3) activated scales + (..., 4) quats → packed (..., 6) Σ₃."""
    R = quat_to_rotmat(quats)
    s = scales * scale_modifier
    M = R * s[..., None, :]  # R @ diag(s)
    sigma = M @ M.transpose(-1, -2)
    return torch.stack(
        [
            sigma[..., 0, 0],
            sigma[..., 0, 1],
            sigma[..., 0, 2],
            sigma[..., 1, 1],
            sigma[..., 1, 2],
            sigma[..., 2, 2],
        ],
        dim=-1,
    )


def build_cov3d_components(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
):
    """Σ₃ = R diag(s²) Rᵀ as six (...,) component columns
    (xx, xy, xz, yy, yz, zz)."""
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )
    s = [scales[..., k] * scale_modifier for k in range(3)]
    m = [[r[i][k] * s[k] for k in range(3)] for i in range(3)]

    def dot(i, jj):
        return m[i][0] * m[jj][0] + m[i][1] * m[jj][1] + m[i][2] * m[jj][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def project_cov3d_components(cov6, j_rows, R_cw):
    """EWA projection in component form.

    Args:
      cov6: 6-tuple of (...,) Σ₃ components (xx, xy, xz, yy, yz, zz).
      j_rows: 2-tuple of 3-tuples of (...,) Jacobian entries J[r][k].
      R_cw: (3, 3) camera rotation.

    Returns (a, b, c) of the 2×2 cov2D with the +0.3 low-pass applied.
    """
    sig = (
        (cov6[0], cov6[1], cov6[2]),
        (cov6[1], cov6[3], cov6[4]),
        (cov6[2], cov6[4], cov6[5]),
    )
    t = [
        [
            j_rows[r][0] * R_cw[0, c]
            + j_rows[r][1] * R_cw[1, c]
            + j_rows[r][2] * R_cw[2, c]
            for c in range(3)
        ]
        for r in range(2)
    ]
    u = [
        [
            t[r][0] * sig[0][c] + t[r][1] * sig[1][c] + t[r][2] * sig[2][c]
            for c in range(3)
        ]
        for r in range(2)
    ]

    def dot(r, c):
        return u[r][0] * t[c][0] + u[r][1] * t[c][1] + u[r][2] * t[c][2]

    return dot(0, 0) + LOW_PASS, dot(0, 1), dot(1, 1) + LOW_PASS


def invert_cov2d_components(a, b, c):
    """(a, b, c) cov2D components → (conic components (A, B, C), det);
    det == 0 marks a degenerate Gaussian that preprocess drops."""
    det = a * c - b * b
    nonzero = det != 0.0
    safe = torch.where(nonzero, det, torch.ones_like(det))
    det_inv = torch.where(nonzero, 1.0 / safe, torch.zeros_like(det))
    return (c * det_inv, -b * det_inv, a * det_inv), det


def cov2d_extent_components(a, c, det, opacity=None):
    """Screen-space radius ⌈k·√λ_max⌉ with k = 3, or — given ``opacity`` —
    the opacity-aware tight k = min(3, √(2·ln(255·op))) beyond which α
    falls under the compositor's 1/255 skip threshold (output-identical,
    fewer binned instances)."""
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    if opacity is None:
        return torch.ceil(3.0 * torch.sqrt(lam_max))
    k = torch.clamp_max(
        torch.sqrt(2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1e-6))),
        3.0,
    )
    k = torch.clamp_min(k, 0.0)
    return torch.ceil(k * torch.sqrt(lam_max))
