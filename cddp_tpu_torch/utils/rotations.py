"""Rotation and attitude helpers (port of ``cddp_tpu/utils/rotations.py``).

Euler-ZYX, quaternion ([w, x, y, z]), MRP and rotation-matrix conversions
and the skew operator, as plain functions on tensors, batched over any
leading axes: a vector argument is (..., 3) or (..., 4), a matrix (..., 3,
3). Each writes the JAX function's expressions in its order, so the two
agree to rounding in float64.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the cross-product matrix (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[w, x, y, z] (..., 4), assumed of unit norm -> R (..., 3, 3)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)


def rotation_matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) -> the unit quaternion (..., 4) by Shepperd's rule: four
    candidate branches (from w, x, y or z), of which exactly the one with the
    largest score (trace, R00, R11, R22) is kept, the first on a tie, as
    ``argmax`` picks it (rotations.py:78-82 of the JAX package): summing
    tied branches would cancel the sign-opposite candidates of a 180-degree
    rotation."""
    r = lambda i, j: R[..., i, j]  # noqa: E731
    tr = r(0, 0) + r(1, 1) + r(2, 2)
    floor = torch.tensor(1e-12, dtype=R.dtype, device=R.device)

    def scale(v):
        return 2.0 * torch.sqrt(torch.maximum(v, floor))

    s = scale(1.0 + tr)
    from_w = torch.stack([0.25 * s, (r(2, 1) - r(1, 2)) / s, (r(0, 2) - r(2, 0)) / s,
                          (r(1, 0) - r(0, 1)) / s], -1)
    s = scale(1.0 + r(0, 0) - r(1, 1) - r(2, 2))
    from_x = torch.stack([(r(2, 1) - r(1, 2)) / s, 0.25 * s, (r(0, 1) + r(1, 0)) / s,
                          (r(0, 2) + r(2, 0)) / s], -1)
    s = scale(1.0 + r(1, 1) - r(0, 0) - r(2, 2))
    from_y = torch.stack([(r(0, 2) - r(2, 0)) / s, (r(0, 1) + r(1, 0)) / s, 0.25 * s,
                          (r(1, 2) + r(2, 1)) / s], -1)
    s = scale(1.0 + r(2, 2) - r(0, 0) - r(1, 1))
    from_z = torch.stack([(r(1, 0) - r(0, 1)) / s, (r(0, 2) + r(2, 0)) / s,
                          (r(1, 2) + r(2, 1)) / s, 0.25 * s], -1)
    cands = torch.stack([from_w, from_x, from_y, from_z], -2)
    pick = torch.stack([tr, r(0, 0), r(1, 1), r(2, 2)], -1).argmax(-1)
    q = torch.gather(cands, -2, pick[..., None, None].expand(pick.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def euler_zyx_to_rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """[psi (yaw), theta (pitch), phi (roll)] (..., 3) -> R = Rz(psi) Ry(theta)
    Rx(phi) (..., 3, 3)."""
    psi, theta, phi = angles[..., 0], angles[..., 1], angles[..., 2]
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    o, i = torch.zeros_like(psi), torch.ones_like(psi)
    mat = lambda *rows: torch.stack([torch.stack(r, -1) for r in rows], -2)  # noqa: E731
    Rz = mat((cpsi, -spsi, o), (spsi, cpsi, o), (o, o, i))
    Ry = mat((cth, o, sth), (o, i, o), (-sth, o, cth))
    Rx = mat((i, o, o), (o, cphi, -sphi), (o, sphi, cphi))
    return Rz @ Ry @ Rx


def rotation_matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`euler_zyx_to_rotation_matrix`: (..., 3, 3) -> (..., 3)."""
    theta = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    psi = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    phi = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([psi, theta, phi], -1)


def quat_to_mrp(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> modified Rodrigues parameters (..., 3), taking
    the shadow set (-q) when qw < 0 (helper.cpp:70-93 of the reference)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    return q[..., 1:4] / (1.0 + q[..., :1])


def mrp_to_quat(sigma: torch.Tensor) -> torch.Tensor:
    """MRP (..., 3) -> quaternion [w, x, y, z] (..., 4)."""
    s2 = (sigma * sigma).sum(-1, keepdim=True)
    return torch.cat([(1.0 - s2) / (1.0 + s2), 2.0 * sigma / (1.0 + s2)], -1)


def mrp_to_rotation_matrix(sigma: torch.Tensor) -> torch.Tensor:
    return quat_to_rotation_matrix(mrp_to_quat(sigma))
