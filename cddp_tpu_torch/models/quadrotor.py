"""Quadrotor with quaternion attitude and per-rotor thrust controls
(nx=13: [p(3), q(wxyz), v(3), omega(3)]; nu=4: rotor forces).

Port of ``cddp_tpu/models/quadrotor.py`` (reference ``quadrotor.cpp:33-97``):
the quaternion normalized before use under the JAX model's guard, rotor
forces mapped to collective thrust and body torques tau = [L(f1-f3),
L(f2-f4), 0.1(f1-f2+f3-f4)], thrust along the body z axis, and the angular
acceleration I^-1 (tau - omega x I omega). The expressions are the JAX
model's, in its order, with the 3x3 products written out term by term so
that every device rounds them alike (the CUDA struct ``models.cuh::
Quadrotor`` repeats them). The JAX model has no analytic Jacobians, so
neither has this one: they come by forward-mode AD.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters

DEFAULT_INERTIA = ((0.01, 0.0, 0.0), (0.0, 0.01, 0.0), (0.0, 0.0, 0.02))


class Quadrotor(DynamicalSystem):
    state_dim = 13
    control_dim = 4

    def __init__(self, mass: float = 1.0, inertia=None, arm_length: float = 0.2,
                 gravity: float = 9.81, integration_type: str = "euler", device=None,
                 dtype=None):
        """``inertia`` (3, 3), the diagonal (0.01, 0.01, 0.02) when None. Every
        buffer goes to ``device`` (the CUDA card when None) in ``dtype``
        (float64 when None)."""
        super().__init__(integration_type)
        register_parameters(self, mass=mass, arm_length=arm_length, gravity=gravity)
        inertia = DEFAULT_INERTIA if inertia is None else inertia
        self.register_buffer("inertia", torch.as_tensor(
            inertia, dtype=torch.float64).reshape(3, 3).clone())
        self.to(device=devices.resolve(device), dtype=dtype or torch.float64)
        self._inverse = {}

    def inertia_inverse(self) -> torch.Tensor:
        """inv(I), computed once for each dtype and device the inertia takes
        (by LU, as the JAX model's ``jnp.linalg.inv``), not once per
        evaluation: the Jacobian glue evaluates the model at every point of
        the horizon each iteration. The CUDA kernels read this same matrix
        (``rollout._REGISTRY``: the struct's parameters after the lane
        vector)."""
        return self._inertia()[0]

    def _inertia(self):
        """(inv(I), I's entries, inv(I)'s entries), the entries as nested
        lists of 0-d views that ``forward`` reads without an indexing op per
        use; cached for each dtype, device and version of the inertia."""
        I = self.inertia
        key = (I.dtype, I.device, I.data_ptr(), I._version)
        cached = self._inverse.get(key)
        if cached is None:
            inv = torch.linalg.inv(I)
            cached = self._inverse[key] = (inv, *([r.unbind(-1) for r in M.unbind(-2)]
                                                  for M in (I, inv)))
        return cached

    def forward(self, x, u, t):
        qw, qx, qy, qz = x[..., 3], x[..., 4], x[..., 5], x[..., 6]
        vx, vy, vz = x[..., 7], x[..., 8], x[..., 9]
        wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]

        norm = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        safe = norm > 1e-6
        den = torch.clamp(norm, min=1e-6)
        qw = torch.where(safe, qw / den, 1.0)
        qx = torch.where(safe, qx / den, 0.0)
        qy = torch.where(safe, qy / den, 0.0)
        qz = torch.where(safe, qz / den, 0.0)

        # q_dot = 0.5 q (x) [0, omega] (quadrotor.cpp:63-73).
        q_dot = [0.5 * -(qx * wx + qy * wy + qz * wz),
                 0.5 * (qw * wx + qy * wz - qz * wy),
                 0.5 * (qw * wy - qx * wz + qz * wx),
                 0.5 * (qw * wz + qx * wy - qy * wx)]

        f1, f2, f3, f4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
        thrust = f1 + f2 + f3 + f4
        arm = self.arm_length
        tau = (arm * (f1 - f3), arm * (f2 - f4), 0.1 * (f1 - f2 + f3 - f4))

        # R @ [0, 0, T] = T * (the third column of R).
        tm = thrust / self.mass
        acc = [tm * (2.0 * (qx * qz + qw * qy)) - 0.0,
               tm * (2.0 * (qy * qz - qw * qx)) - 0.0,
               tm * (1.0 - 2.0 * (qx * qx + qy * qy)) - self.gravity]

        _, I, Ii = self._inertia()
        Iw = [I[i][0] * wx + I[i][1] * wy + I[i][2] * wz for i in range(3)]
        r = (tau[0] - (wy * Iw[2] - wz * Iw[1]),
             tau[1] - (wz * Iw[0] - wx * Iw[2]),
             tau[2] - (wx * Iw[1] - wy * Iw[0]))
        ang = [Ii[i][0] * r[0] + Ii[i][1] * r[1] + Ii[i][2] * r[2] for i in range(3)]
        return torch.stack([vx, vy, vz, *q_dot, *acc, *ang], dim=-1)


def quadrotor(mass: float = 1.0, inertia=None, arm_length: float = 0.2,
              integration_type: str = "euler", device=None, dtype=None) -> Quadrotor:
    """Build a Quadrotor (quadrotor.py:81-89 of the JAX package) on ``device``,
    the CUDA card when None, in ``dtype`` (float64 when None)."""
    return Quadrotor(mass=mass, inertia=inertia, arm_length=arm_length,
                     integration_type=integration_type, device=device, dtype=dtype)
