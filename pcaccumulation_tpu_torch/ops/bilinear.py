"""Bilinear BEV sampling, scattering and the shear warp (the port of the JAX
package's `ops/bilinear.py`).

The functions are batched: a leading batch dimension B stands where the JAX
package vmaps. Layouts after it are the JAX package's: BEV maps are NHWC,
the folded canvas is [B, H, W, T*C] with t-minor channel blocks.
Conventions follow `grid_sample(..., align_corners=False)`: normalised
coords u, v in [-1, 1], pixel centres at (i + 0.5) / size * 2 - 1.
Gather indices are clamped explicitly: on the card an out-of-range index
is a device-side assert, where JAX clamps.
"""

from __future__ import annotations

import torch

from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks


def _corners(x: torch.Tensor, y: torch.Tensor):
    """Integer corner (x0, y0) and fractions (tx, ty) of continuous pixel
    coordinates."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def _lerp4(v00, v01, v10, v11, tx, ty):
    return (
        v00 * ((1 - ty) * (1 - tx))[..., None]
        + v01 * ((1 - ty) * tx)[..., None]
        + v10 * (ty * (1 - tx))[..., None]
        + v11 * (ty * tx)[..., None]
    )


def _gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [B, R, C], idx [B, N] in [0, R) -> [B, N, C]."""
    return torch.gather(flat, 1, idx[..., None].expand(idx.shape + flat.shape[-1:]))


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Sample img [B, H, W, C] at normalised coords u (x), v (y) [B, N].

    grid_sample semantics with align_corners=False, mode='bilinear';
    padding_mode in {'zeros', 'border'}. Returns [B, N, C].
    """
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    x0, y0, tx, ty = _corners((u + 1.0) * (w * 0.5) - 0.5, (v + 1.0) * (h * 0.5) - 0.5)

    def gather(yi, xi):
        rows = _gather_rows(flat, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        if padding_mode == "border":
            return rows
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return rows * valid[..., None].to(img.dtype)

    return _lerp4(gather(y0, x0), gather(y0, x0 + 1), gather(y0 + 1, x0),
                  gather(y0 + 1, x0 + 1), tx, ty)


def ungrid(feats: torch.Tensor, points_xy: torch.Tensor, pc_range_min: float,
           padding_mode: str = "border") -> torch.Tensor:
    """Per-point bilinear feature lookup from a BEV map.

    feats [B, H, W, C]; points_xy [B, N, 2] in metres; u = x / |pc_range_min|.
    """
    scale = abs(pc_range_min)
    return bilinear_sample(feats, points_xy[..., 0] / scale, points_xy[..., 1] / scale,
                           padding_mode=padding_mode)


def _temporal_ungrid(flat, row_index, points_xy, pc_range_min, h, w):
    scale = abs(pc_range_min)
    x = (points_xy[..., 0] / scale + 1.0) * (w * 0.5) - 0.5
    y = (points_xy[..., 1] / scale + 1.0) * (h * 0.5) - 0.5
    x0, y0, tx, ty = _corners(x, y)

    def corner(yi, xi):
        return _gather_rows(flat, row_index(yi.clamp(0, h - 1), xi.clamp(0, w - 1)))

    return _lerp4(corner(y0, x0), corner(y0, x0 + 1), corner(y0 + 1, x0),
                  corner(y0 + 1, x0 + 1), tx, ty)


def temporal_ungrid(feats: torch.Tensor, points_xy: torch.Tensor,
                    time_idx: torch.Tensor, pc_range_min: float) -> torch.Tensor:
    """Per-point bilinear lookup (border padding) from the map of the
    point's frame. feats [B, T, H, W, C]; points_xy [B, N, 2]; time_idx
    [B, N] int -> [B, N, C]."""
    b, t, h, w, c = feats.shape
    base = time_idx.long().clamp(0, t - 1) * (h * w)
    return _temporal_ungrid(feats.reshape(b, t * h * w, c),
                            lambda yc, xc: base + yc * w + xc,
                            points_xy, pc_range_min, h, w)


def temporal_ungrid_folded(featsf: torch.Tensor, points_xy: torch.Tensor,
                           time_idx: torch.Tensor, pc_range_min: float,
                           n_frames: int) -> torch.Tensor:
    """`temporal_ungrid` on a folded canvas [B, H, W, T*C]: the same rows,
    indexed (y*W + x)*T + t in its [H*W*T, C] view."""
    b, h, w, ctot = featsf.shape
    t = n_frames
    tid = time_idx.long().clamp(0, t - 1)
    return _temporal_ungrid(featsf.reshape(b, h * w * t, ctot // t),
                            lambda yc, xc: (yc * w + xc) * t + tid,
                            points_xy, pc_range_min, h, w)


def _pixel_affine(pose: torch.Tensor, x_reso, y_reso, x_min, y_min, h, w):
    """Pixel-space affine (A, b) of the source-coordinate map of poses
    [..., 4, 4]: for output pixel (i=row, j=col), source pixel =
    A @ [j, i] + b. A [..., 2, 2], b [..., 2]."""
    pose_inv = torch.linalg.inv(pose)

    def src_pix(jd, id_):
        gx = (jd + 0.5) * x_reso + x_min
        gy = (id_ + 0.5) * y_reso + y_min
        tx = pose_inv[..., 0, 0] * gx + pose_inv[..., 0, 1] * gy + pose_inv[..., 0, 3]
        ty = pose_inv[..., 1, 0] * gx + pose_inv[..., 1, 1] * gy + pose_inv[..., 1, 3]
        xs = (tx / abs(x_min) + 1.0) * (w * 0.5) - 0.5
        ys = (ty / abs(y_min) + 1.0) * (h * 0.5) - 0.5
        return torch.stack([xs, ys], dim=-1)

    p00 = src_pix(0.0, 0.0)
    pj = src_pix(1.0, 0.0)
    pi = src_pix(0.0, 1.0)
    return torch.stack([pj - p00, pi - p00], dim=-1), p00


def _shear_params(poses: torch.Tensor, x_reso, y_reso, x_min, y_min, h, w):
    """alpha = -tan(phi/2), beta = sin(phi) of the rotation angle phi
    nearest to each pose's pixel-space 2x2 block (polar projection), and
    its translation (tx, ty) in pixels."""
    a_mat, b_vec = _pixel_affine(poses.float(), x_reso, y_reso, x_min, y_min, h, w)
    phi = torch.atan2(a_mat[..., 1, 0] - a_mat[..., 0, 1], a_mat[..., 0, 0] + a_mat[..., 1, 1])
    return -torch.tan(phi / 2.0), torch.sin(phi), b_vec[..., 0], b_vec[..., 1]


def _warp_gather(feats: torch.Tensor, poses: torch.Tensor, x_reso, y_reso, x_min,
                 y_min) -> torch.Tensor:
    """Per-pixel bilinear warp (grid_sample semantics, zero padding) of
    feats [F, H, W, C] by the inverse of poses [F, 4, 4]."""
    f, h, w, c = feats.shape
    pose_inv = torch.linalg.inv(poses.float())
    dev = feats.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * x_reso + x_min
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * y_reso + y_min
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]

    def row(i):
        return (pose_inv[:, i, 0, None, None] * gx + pose_inv[:, i, 1, None, None] * gy
                + pose_inv[:, i, 3, None, None])

    u = (row(0) / abs(x_min)).reshape(f, -1)
    v = (row(1) / abs(y_min)).reshape(f, -1)
    return bilinear_sample(feats, u, v, padding_mode="zeros").reshape(f, h, w, c)


def warp_bev(feats: torch.Tensor, pose: torch.Tensor, x_reso: float, y_reso: float,
             x_min: float, y_min: float, method: str = "shear") -> torch.Tensor:
    """Warp one BEV map feats [H, W, C] by the inverse of pose [4, 4]
    (frame -> anchor): each output pixel centre is mapped through the
    inverse's xy block and sampled bilinearly, zeros outside.

    method 'gather': the per-pixel bilinear sample (grid_sample parity).
    method 'shear': the three-pass shear decomposition of the rotation,
    R(phi) = Sx(-tan(phi/2)) @ Sy(sin phi) @ Sx(-tan(phi/2)), each pass a
    `row_shift` (kernel K3 on the card) with an H<->W swap around the
    middle one; exact for a z-rotation plus translation up to the
    interpolation kernel (three 1-D lerps against one 2-D lerp).
    """
    h, w, c = feats.shape
    if method == "gather":
        return _warp_gather(feats[None], pose[None], x_reso, y_reso, x_min, y_min)[0]
    alpha, beta, tx_p, ty_p = _shear_params(pose, x_reso, y_reso, x_min, y_min, h, w)
    i_idx = torch.arange(h, dtype=feats.dtype, device=feats.device)
    j_idx = torch.arange(w, dtype=feats.dtype, device=feats.device)
    # pass 1: x += alpha*i + (tx - alpha*ty)
    out = row_shift(feats, alpha * i_idx + tx_p - alpha * ty_p)
    # pass 2: y += beta*j + ty, a row shift of the transposed map
    out = row_shift(out.transpose(0, 1).contiguous(), beta * j_idx + ty_p)
    out = out.transpose(0, 1).contiguous()
    # pass 3: x += alpha*i
    return row_shift(out, alpha * i_idx)


def warp_bev_batch(feats: torch.Tensor, poses: torch.Tensor, x_reso: float, y_reso: float,
                   x_min: float, y_min: float, method: str = "shear") -> torch.Tensor:
    """`warp_bev` of F maps [F, H, W, C] by F poses [F, 4, 4] at once. The
    shear path folds the frame axis into the rows, so each of its three
    passes is one `row_shift` over [F*H, W, C]."""
    f, h, w, c = feats.shape
    if method == "gather":
        return _warp_gather(feats, poses, x_reso, y_reso, x_min, y_min)
    alpha, beta, tx_p, ty_p = _shear_params(poses, x_reso, y_reso, x_min, y_min, h, w)  # [F]
    i_idx = torch.arange(h, dtype=torch.float32, device=feats.device)
    j_idx = torch.arange(w, dtype=torch.float32, device=feats.device)
    s1 = alpha[:, None] * i_idx + (tx_p - alpha * ty_p)[:, None]  # [F, H]
    out = row_shift(feats.reshape(f * h, w, c), s1.reshape(-1))
    out = out.reshape(f, h, w, c).transpose(1, 2).contiguous()  # [F, W, H, C]
    s2 = beta[:, None] * j_idx + ty_p[:, None]  # [F, W]
    out = row_shift(out.reshape(f * w, h, c), s2.reshape(-1))
    out = out.reshape(f, w, h, c).transpose(1, 2).contiguous()
    s3 = (alpha[:, None] * i_idx).expand(f, h)
    return row_shift(out.reshape(f * h, w, c), s3.reshape(-1)).reshape(f, h, w, c)


def warp_bev_folded(bevf: torch.Tensor, poses: torch.Tensor, x_reso: float,
                    y_reso: float, x_min: float, y_min: float) -> torch.Tensor:
    """Shear-warp a folded BEV canvas [B, H, W, T*C] by the inverse of
    per-frame poses [B, T, 4, 4].

    Three-pass shear decomposition of the rotation,
    R(phi) = Sx(-tan(phi/2)) @ Sy(sin phi) @ Sx(-tan(phi/2)): each pass is
    one `row_shift_blocks` call over every frame at once (one shift per
    row and frame), with an H<->W swap around the middle pass. Frame 0
    with an identity pose shifts by ~0, i.e. passes through.
    """
    b, h, w, ctot = bevf.shape
    t = poses.shape[1]
    alpha, beta, tx_p, ty_p = _shear_params(poses, x_reso, y_reso, x_min, y_min, h, w)  # [B, T]
    i_idx = torch.arange(h, dtype=torch.float32, device=bevf.device)
    j_idx = torch.arange(w, dtype=torch.float32, device=bevf.device)

    def shift_rows(img, shifts):  # img [B, R, L, TC]; shifts [B, R, T]
        _, r, length, _ = img.shape
        return row_shift_blocks(img.reshape(b * r, length, ctot),
                                shifts.reshape(b * r, t), t).reshape(b, r, length, ctot)

    # pass 1: x += alpha*i + (tx - alpha*ty)
    s1 = alpha[:, None, :] * i_idx[None, :, None] + (tx_p - alpha * ty_p)[:, None, :]
    out = shift_rows(bevf, s1)
    # pass 2: y += beta*j + ty, a row shift of the transposed canvas
    s2 = beta[:, None, :] * j_idx[None, :, None] + ty_p[:, None, :]  # [B, W, T]
    out = shift_rows(out.transpose(1, 2).contiguous(), s2).transpose(1, 2).contiguous()
    # pass 3: x += alpha*i
    s3 = (alpha[:, None, :] * i_idx[None, :, None]).expand(b, h, t)
    return shift_rows(out, s3)


def scatter_bev(pillar_feats: torch.Tensor, flat_idx: torch.Tensor,
                valid: torch.Tensor, canvas_size: int) -> torch.Tensor:
    """Scatter pillar features [B, M, C] to flat canvases [B, S, C] at
    flat_idx [B, M]. Valid indices are unique (the voxelizer dedups
    coords); invalid and out-of-range ones go to a spare row, dropped."""
    b, m, c = pillar_feats.shape
    idx = flat_idx.long()
    idx = torch.where(valid & (idx >= 0) & (idx < canvas_size), idx, canvas_size)
    canvas = pillar_feats.new_zeros((b, canvas_size + 1, c))
    canvas.scatter_(1, idx[..., None].expand(b, m, c), pillar_feats)
    return canvas[:, :canvas_size]


def gather_bev(canvas_flat: torch.Tensor, flat_idx: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Inverse of scatter_bev: canvas [B, S, C], flat_idx [B, M] -> [B, M, C],
    invalid rows zero."""
    idx = flat_idx.long().clamp(0, canvas_flat.shape[1] - 1)
    return _gather_rows(canvas_flat, idx) * valid[..., None].to(canvas_flat.dtype)
