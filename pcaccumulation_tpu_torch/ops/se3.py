"""SE(3) geometry over arbitrary leading batch dimensions (the port of the
JAX package's `ops/se3.py`, the parts the val forward calls).

The matrix products here are float32 products; callers keep TF32 off for
them, as the JAX package runs them at `Precision.HIGHEST`.
"""

from __future__ import annotations

import math

import torch


def make_transform(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] homogeneous transforms from [..., 3, 3] + [..., 3]."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    trans = trans.expand(batch + (3,))
    top = torch.cat([rot, trans[..., :, None]], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros(batch + (1, 4), dtype=rot.dtype, device=rot.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform_inverse(tsfm: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid transforms [..., 4, 4]."""
    rot_inv = tsfm[..., :3, :3].transpose(-1, -2)
    trans_inv = -torch.einsum("...ij,...j->...i", rot_inv, tsfm[..., :3, 3])
    return make_transform(rot_inv, trans_inv)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose rigid transforms: result = a @ b."""
    return a @ b


def apply_transform(points: torch.Tensor, tsfm: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] transform(s) to [..., N, 3] points."""
    rot = tsfm[..., :3, :3]
    trans = tsfm[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", rot, points) + trans[..., None, :]


def relative_pose(tsfm_src: torch.Tensor, tsfm_tgt: torch.Tensor) -> torch.Tensor:
    """T_rel with T_rel @ X_src = X_tgt-frame: inv(T_tgt) @ T_src."""
    return torch.linalg.solve(tsfm_tgt, tsfm_src)


def _apply_indexed_rows(points: torch.Tensor, rows: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Apply rows[idx[n]] (a flattened [R|t], [..., S, 12]) to points
    [..., N, 3]. idx is clamped into [0, S): an out-of-range index on the
    card would be a device-side assert."""
    idx = idx.long().clamp(0, rows.shape[-2] - 1)
    m = torch.gather(rows, -2, idx[..., None].expand(idx.shape + (12,)))
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack(
        [
            m[..., 0] * x + m[..., 1] * y + m[..., 2] * z + m[..., 3],
            m[..., 4] * x + m[..., 5] * y + m[..., 6] * z + m[..., 7],
            m[..., 8] * x + m[..., 9] * y + m[..., 10] * z + m[..., 11],
        ],
        dim=-1,
    )


def ego_motion_compensation(points: torch.Tensor, time_idx: torch.Tensor,
                            tsfm: torch.Tensor) -> torch.Tensor:
    """Transform each point by the pose of its frame.

    points [B, N, 3]; time_idx int [B, N]; tsfm [B, T, 4, 4].
    """
    t = tsfm.shape[-3]
    rows = tsfm[..., :3, :].reshape(tsfm.shape[:-3] + (t, 12))
    return _apply_indexed_rows(points, rows, time_idx)


def reconstruct_sequence(points: torch.Tensor, time_idx: torch.Tensor,
                         inst_idx: torch.Tensor, tsfm: torch.Tensor) -> torch.Tensor:
    """Per-(instance, frame) rigid motion: each point moves by
    tsfm[inst, t]. points [..., N, 3]; tsfm [..., K, T, 4, 4]."""
    k, t = tsfm.shape[-4], tsfm.shape[-3]
    rows = tsfm[..., :3, :].reshape(tsfm.shape[:-4] + (k * t, 12))
    idx = inst_idx.long() * t + time_idx.long()
    return _apply_indexed_rows(points, rows, idx)


def rotation_error_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Angular geodesic distance in degrees between [..., 3, 3] rotations."""
    m = r1.transpose(-1, -2) @ r2
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(cos) * (180.0 / math.pi)


def translation_error(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """L2 distance between [..., 3] translations."""
    return torch.linalg.norm(t1 - t2, dim=-1)


def quat_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion [x, y, z, w] (scipy order) to rotation matrix [..., 3, 3].
    The caller normalises the quaternion."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] to quaternion [x, y, z, w] with w >= 0.

    Branchless Shepperd-style extraction: all four candidate quaternions
    are computed and the one keyed by the largest diagonal element is kept.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01, tr + 1.0], dim=-1)
    qx = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    qy = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    qz = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1)

    cand = torch.stack([qx, qy, qz, qw], dim=-2)  # [..., 4(which), 4(xyzw)]
    key = torch.stack([m00, m11, m22, tr], dim=-1)
    best = torch.argmax(key, dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / (torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-12)) + 1e-7)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
