"""Camera geometry: projections, rotations, depth-pose warps, epipolar terms.

Port of ``unopticalflow_tpu/ops/geometry.py``: small batched 3x3 algebra and
per-pixel elementwise work in plain PyTorch (the JAX package has no kernel
here either).  The flow+pose branch (``models/flowpose_model.py``) uses
``fundamental_from_pose`` and ``sampson_epipolar_distance``; the rest is the
depth/pose API the JAX package keeps beside them.

Conventions: intrinsics K are (B, 3, 3); depth is (B, H, W); pose vectors are
(B, 6) [tx, ty, tz, rx, ry, rz]; ``pose_vec2mat(pose)`` maps the second
camera's points into the first's (p1 = R p2 + t).  Images are NCHW (B, C, H,
W) and a flow is the port's (B, 2, H, W), channel 0 the x (width)
displacement; normalized sampling positions are (B, H, W, 2), as
``F.grid_sample`` takes them.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops.warp import bilinear_warp


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(3, H, W) homogeneous pixel coordinate grid [x; y; 1]."""
    gx = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    gy = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return torch.stack([gx, gy, torch.ones_like(gx)], 0)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Back-project pixels to camera space: depth (B, H, W), K^-1 (B, 3, 3)
    -> (B, 3, H, W) camera coordinates."""
    b, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device).reshape(3, -1)
    rays = torch.einsum("bij,jn->bin", intrinsics_inv, grid)
    return (rays * depth.reshape(b, 1, -1)).reshape(b, 3, h, w)


def cam2pixel(cam_coords: torch.Tensor, proj_rot: torch.Tensor,
              proj_tr: torch.Tensor) -> torch.Tensor:
    """Project camera points (B, 3, H, W) by K R (B, 3, 3) and K t (B, 3, 1)
    to normalized [-1, 1] positions (B, H, W, 2) over the (W-1)/(H-1) span."""
    b, _, h, w = cam_coords.shape
    pts = cam_coords.reshape(b, 3, -1)
    pcoords = torch.einsum("bij,bjn->bin", proj_rot, pts) + proj_tr
    x, y, z = pcoords[:, 0], pcoords[:, 1], pcoords[:, 2]
    z = torch.clamp(z, min=1e-3)
    xn = 2.0 * (x / z) / max(w - 1, 1) - 1.0
    yn = 2.0 * (y / z) / max(h - 1, 1) - 1.0
    return torch.stack([xn, yn], -1).reshape(b, h, w, 2)


def _mat3(*entries) -> torch.Tensor:
    """Nine (B,) tensors, row-major -> (B, 3, 3)."""
    return torch.stack(entries, 1).reshape(-1, 3, 3)


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (B, 3) [rx, ry, rz] -> rotations (B, 3, 3), Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    cz, sz = torch.cos(z), torch.sin(z)
    rz = _mat3(cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones)
    cy, sy = torch.cos(y), torch.sin(y)
    ry = _mat3(cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy)
    cx, sx = torch.cos(x), torch.sin(x)
    rx = _mat3(ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx)
    return rx @ ry @ rz


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """The last three quaternion coefficients (B, 3) -> rotations (B, 3, 3):
    w = 1 is prepended before the normalization."""
    q = torch.cat([torch.ones_like(quat[:, :1]), quat], 1)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = qw * qw, qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    return _mat3(w2 + x2 - y2 - z2, 2 * (xy - wz), 2 * (xz + wy),
                 2 * (xy + wz), w2 - x2 + y2 - z2, 2 * (yz - wx),
                 2 * (xz - wy), 2 * (yz + wx), w2 - x2 - y2 + z2)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """Pose vector (B, 6) -> (B, 3, 4) [R | t]."""
    translation = vec[:, :3, None]
    rot = vec[:, 3:]
    if rotation_mode == "euler":
        rot_mat = euler2mat(rot)
    elif rotation_mode == "quat":
        rot_mat = quat2mat(rot)
    else:
        raise ValueError(f"unknown rotation_mode {rotation_mode!r}")
    return torch.cat([rot_mat, translation], 2)


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 intrinsics: torch.Tensor, rotation_mode: str = "euler"):
    """Depth+pose inverse warp of the source image (B, C, H, W) to the target
    frame: target depth (B, H, W), target->source pose (B, 6), K (B, 3, 3)
    -> (warped (B, C, H, W), valid mask (B, 1, H, W))."""
    cam_coords = pixel2cam(depth, torch.linalg.inv(intrinsics))
    proj = intrinsics @ pose_vec2mat(pose, rotation_mode)
    coords_norm = cam2pixel(cam_coords, proj[:, :, :3], proj[:, :, 3:])
    return _sample_normalized(img, coords_norm)


def inverse_warp2(img: torch.Tensor, depth: torch.Tensor, ref_depth: torch.Tensor,
                  pose_mat: torch.Tensor, intrinsics: torch.Tensor):
    """``inverse_warp`` by a (B, 3, 4) transform that also samples the source
    depth (B, H, W): (warped image, valid mask, warped depth (B, H, W))."""
    cam_coords = pixel2cam(depth, torch.linalg.inv(intrinsics))
    proj = intrinsics @ pose_mat
    coords_norm = cam2pixel(cam_coords, proj[:, :, :3], proj[:, :, 3:])
    warped, valid = _sample_normalized(img, coords_norm)
    warped_depth, _ = _sample_normalized(ref_depth[:, None], coords_norm)
    return warped, valid, warped_depth[:, 0]


def _sample_normalized(img: torch.Tensor, coords_norm: torch.Tensor):
    """Bilinear sampling (zeros outside) of ``img`` (B, C, H, W) at
    normalized positions (B, H, W, 2), through ``bilinear_warp``, and the
    mask (B, 1, H, W) of positions inside [-1, 1]."""
    _, _, h, w = img.shape
    x = (coords_norm[..., 0] + 1.0) * max(w - 1, 1) / 2.0
    y = (coords_norm[..., 1] + 1.0) * max(h - 1, 1) / 2.0
    gx = torch.arange(w, dtype=img.dtype, device=img.device)[None, None, :]
    gy = torch.arange(h, dtype=img.dtype, device=img.device)[None, :, None]
    flow = torch.stack([x - gx, y - gy], 1)
    warped = bilinear_warp(img, flow, use_mask=False)
    cx, cy = coords_norm[..., 0], coords_norm[..., 1]
    valid = ((cx >= -1) & (cx <= 1) & (cy >= -1) & (cy <= 1)).to(img.dtype)[:, None]
    return warped, valid


def skew_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (B, 3, 3) cross-product matrices [t]x."""
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    z = torch.zeros_like(tx)
    return _mat3(z, -tz, ty, tz, z, -tx, -ty, tx, z)


def fundamental_from_pose(pose: torch.Tensor, intrinsics: torch.Tensor,
                          intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Pose (B, 6) mapping camera 2 into camera 1 -> fundamental matrix
    F = K^-T [t]x R K^-1 (B, 3, 3), so that x1^T F x2 = 0.  The translation
    is normalized to unit length: the epipolar constraint is scale-free."""
    mat = pose_vec2mat(pose)
    rot, t = mat[:, :, :3], mat[:, :, 3]
    t = t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-8)
    essential = skew_matrix(t) @ rot
    return intrinsics_inv.transpose(1, 2) @ essential @ intrinsics_inv


def sampson_epipolar_distance(flow: torch.Tensor, fundamental: torch.Tensor,
                              row0: int = 0) -> torch.Tensor:
    """Squared Sampson (first-order geometric) epipolar distance per pixel.

    flow: (B, 2, H, W) frame1 -> frame2 in pixels: the match of pixel (u, v)
    is (u + flow[:, 0], v + flow[:, 1]).  fundamental: (B, 3, 3) with
    x1^T F x2 = 0.  ``row0``: the frame's row of the flow's first row (a
    row-shard's, ``parallel/spatial.py``), so its pixels sit at v = row0 ..
    row0 + H - 1.  Returns (B, H, W).
    """
    b, _, h, w = flow.shape
    dt = flow.dtype
    u = torch.arange(w, dtype=dt, device=flow.device)[None, None, :].expand(b, h, w)
    v = torch.arange(row0, row0 + h, dtype=dt, device=flow.device)[None, :, None].expand(b, h, w)
    x2, y2 = u + flow[:, 0], v + flow[:, 1]
    f = fundamental.to(dt)[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    # F x2 (the epiline in image 1) and F^T x1 (the epiline in image 2)
    fx2 = [f[:, i, 0] * x2 + f[:, i, 1] * y2 + f[:, i, 2] for i in range(3)]
    ftx1 = [f[:, 0, i] * u + f[:, 1, i] * v + f[:, 2, i] for i in range(2)]
    r = u * fx2[0] + v * fx2[1] + fx2[2]
    denom = fx2[0] ** 2 + fx2[1] ** 2 + ftx1[0] ** 2 + ftx1[1] ** 2
    return (r * r) / (denom + 1e-8)
