"""Rigid-body attitude models (nx = 6 or 7, nu = 3 body torques).

Port of ``cddp_tpu/models/attitude.py`` (reference
``src/dynamics_model/{euler,quaternion,mrp}_attitude.cpp``):

- Euler-ZYX: d(angles)/dt = E(theta, phi) omega, with the JAX model's guard
  on cos(theta) (its sign times 1e-9 below 1e-9, 1e-9 at zero);
- quaternion [w, x, y, z]: dq/dt = 0.5 Omega(omega) q, q first divided by
  its norm (the unit quaternion (1, 0, 0, 0) at a norm of 1e-9 or less);
- modified Rodrigues parameters: dsigma/dt = 0.25 B(sigma) omega, B = (1 -
  |s|^2) I + 2 skew(s) + 2 s s'.

All three share Euler's rotational dynamics I domega/dt = tau - omega x (I
omega), which the JAX model solves with ``jnp.linalg.solve(I, .)``. Here the
solve is LU with partial pivoting, the factorization ``torch.linalg.solve``
takes, computed once for each dtype, device and version of the inertia
(``lu_factors``) and applied by substitution written out term by term: the
Jacobian glue evaluates the model at every point of the horizon each
iteration, and the CUDA structs (``models.cuh``) read the same factors and
repeat the same substitution, so that kernel and plain version solve alike.
The 3x3 products are written out in the JAX model's order for the same
reason. The JAX models have no analytic Jacobians, so neither have these:
they come by forward-mode AD.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.models.base import DynamicalSystem
from cddp_tpu_torch.utils.rotations import skew

DEFAULT_INERTIA = ((1.0, 0.0, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 3.0))


class _RigidBody(DynamicalSystem):
    control_dim = 3

    def __init__(self, inertia=None, integration_type: str = "euler", device=None, dtype=None):
        """``inertia`` (3, 3), diag(1, 2, 3) when None. The buffer goes to
        ``device`` (the CUDA card when None) in ``dtype`` (float64 when
        None)."""
        super().__init__(integration_type)
        inertia = DEFAULT_INERTIA if inertia is None else inertia
        self.register_buffer("inertia", torch.as_tensor(
            inertia, dtype=torch.float64).reshape(3, 3).clone())
        self.to(device=devices.resolve(device), dtype=dtype or torch.float64)
        self._factors = {}

    def lu_factors(self):
        """(LU (3, 3), pivots (3,) 1-based): ``torch.linalg.lu_factor`` of the
        inertia, computed once for each dtype, device and version of it. The
        CUDA kernels read these same factors (``rollout._REGISTRY``: the
        struct's parameters after the lane vector)."""
        return self._cached()[:2]

    def _cached(self):
        """(LU, pivots, I's entries, LU's entries, pivots as Python ints), the
        entries as nested lists of 0-d views that ``forward`` reads without
        an indexing op per use."""
        I = self.inertia
        key = (I.dtype, I.device, I.data_ptr(), I._version)
        cached = self._factors.get(key)
        if cached is None:
            LU, piv = torch.linalg.lu_factor(I)
            cached = self._factors[key] = (
                LU, piv, *([r.unbind(-1) for r in M.unbind(-2)] for M in (I, LU)),
                [int(v) - 1 for v in piv.tolist()])
        return cached

    def _omega_dot(self, wx, wy, wz, tau):
        """I^-1 (tau - omega x (I omega)): the cross product and the
        right-hand side as the JAX model's ``-skew(omega) @ (I @ omega) +
        tau``, then the LU substitution."""
        _, _, I, LU, piv = self._cached()
        Iw = [I[i][0] * wx + I[i][1] * wy + I[i][2] * wz for i in range(3)]
        b = [tau[0] - (wy * Iw[2] - wz * Iw[1]),
             tau[1] - (wz * Iw[0] - wx * Iw[2]),
             tau[2] - (wx * Iw[1] - wy * Iw[0])]
        return lu_substitute(LU, piv, b)


def lu_substitute(LU, piv, b):
    """x with A x = b from A's packed LU factors (nested 3x3 lists) and its
    0-based pivots: the row swaps in order, forward substitution with the
    unit lower factor, back substitution dividing by U's diagonal."""
    b = list(b)
    for i, j in enumerate(piv):
        if j != i:
            b[i], b[j] = b[j], b[i]
    y1 = b[1] - LU[1][0] * b[0]
    y2 = (b[2] - LU[2][0] * b[0]) - LU[2][1] * y1
    x2 = y2 / LU[2][2]
    x1 = (y1 - LU[1][2] * x2) / LU[1][1]
    x0 = ((b[0] - LU[0][1] * x1) - LU[0][2] * x2) / LU[0][0]
    return [x0, x1, x2]


class EulerAttitude(_RigidBody):
    """x = (psi, theta, phi, omega (3)), ZYX Euler angles and body rates."""

    state_dim = 6

    def forward(self, x, u, t):
        theta, phi = x[..., 1], x[..., 2]
        wx, wy, wz = x[..., 3], x[..., 4], x[..., 5]
        c_phi, s_phi = torch.cos(phi), torch.sin(phi)
        c_theta = torch.cos(theta)
        tan_theta = torch.tan(theta)
        c_safe = torch.where(c_theta.abs() < 1e-9,
                             torch.sign(c_theta) * 1e-9 + (c_theta == 0).to(x.dtype) * 1e-9,
                             c_theta)
        e = [(s_phi / c_safe) * wy + (c_phi / c_safe) * wz,
             c_phi * wy - s_phi * wz,
             wx + (s_phi * tan_theta) * wy + (c_phi * tan_theta) * wz]
        return torch.stack(e + self._omega_dot(wx, wy, wz, u.unbind(-1)), dim=-1)


class QuaternionAttitude(_RigidBody):
    """x = (q [w, x, y, z], omega (3))."""

    state_dim = 7

    def forward(self, x, u, t):
        qw, qx, qy, qz = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        wx, wy, wz = x[..., 4], x[..., 5], x[..., 6]
        n = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        safe = n > 1e-9
        den = torch.clamp(n, min=1e-9)
        qw = torch.where(safe, qw / den, 1.0)
        qx = torch.where(safe, qx / den, 0.0)
        qy = torch.where(safe, qy / den, 0.0)
        qz = torch.where(safe, qz / den, 0.0)
        q_dot = [0.5 * ((-wx * qx - wy * qy) - wz * qz),
                 0.5 * ((wx * qw + wz * qy) - wy * qz),
                 0.5 * ((wy * qw - wz * qx) + wx * qz),
                 0.5 * ((wz * qw + wy * qx) - wx * qy)]
        return torch.stack(q_dot + self._omega_dot(wx, wy, wz, u.unbind(-1)), dim=-1)


class MrpAttitude(_RigidBody):
    """x = (sigma (3), omega (3)), modified Rodrigues parameters and body
    rates."""

    state_dim = 6

    def forward(self, x, u, t):
        s = x[..., :3]
        wx, wy, wz = x[..., 3], x[..., 4], x[..., 5]
        ss = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        B = ((1.0 - ss)[..., None, None] * eye + 2.0 * skew(s)
             + 2.0 * (s[..., :, None] * s[..., None, :]))
        s_dot = [0.25 * (B[..., i, 0] * wx + B[..., i, 1] * wy + B[..., i, 2] * wz)
                 for i in range(3)]
        return torch.stack(s_dot + self._omega_dot(wx, wy, wz, u.unbind(-1)), dim=-1)


def euler_attitude(inertia=None, integration_type: str = "rk4", device=None,
                   dtype=None) -> EulerAttitude:
    """Build an EulerAttitude (attitude.py:92-96 of the JAX package) on
    ``device``, the CUDA card when None, in ``dtype`` (float64 when None)."""
    return EulerAttitude(inertia, integration_type, device=device, dtype=dtype)


def quaternion_attitude(inertia=None, integration_type: str = "rk4", device=None,
                        dtype=None) -> QuaternionAttitude:
    """Build a QuaternionAttitude (attitude.py:99-103 of the JAX package)."""
    return QuaternionAttitude(inertia, integration_type, device=device, dtype=dtype)


def mrp_attitude(inertia=None, integration_type: str = "rk4", device=None,
                 dtype=None) -> MrpAttitude:
    """Build an MrpAttitude (attitude.py:106-110 of the JAX package)."""
    return MrpAttitude(inertia, integration_type, device=device, dtype=dtype)
