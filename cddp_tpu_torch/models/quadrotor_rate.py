"""Quadrotor with body-rate and collective-thrust controls
(nx=10: [p(3), v(3), q(wxyz)]; nu=4: [thrust, wx, wy, wz]).

Port of ``cddp_tpu/models/quadrotor_rate.py`` (reference
``quadrotor_rate.cpp``): the quaternion divided by its norm without a
guard, the acceleration R(q) [0, 0, T] / m + [0, 0, -g] through
``utils.rotations.quat_to_rotation_matrix``, and q_dot = 0.5 Omega(w) q.
``max_thrust`` and ``max_rate`` are the model's box, which the dynamics do
not read. The JAX model has no analytic Jacobians, so neither has this one.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters
from cddp_tpu_torch.utils.rotations import quat_to_rotation_matrix


class QuadrotorRate(DynamicalSystem):
    state_dim = 10
    control_dim = 4

    def __init__(self, mass: float = 1.0, max_thrust: float = 20.0, max_rate: float = 5.0,
                 gravity: float = 9.81, integration_type: str = "euler", device=None):
        """The parameters are float64 scalar buffers on ``device``, the CUDA
        card when None."""
        super().__init__(integration_type)
        register_parameters(self, mass=mass, max_thrust=max_thrust, max_rate=max_rate,
                            gravity=gravity)
        self.to(devices.resolve(device))

    def forward(self, x, u, t):
        v = x[..., 3:6]
        q = x[..., 6:10]
        qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        q = q / torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)[..., None]
        qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

        thrust, wx, wy, wz = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
        zero = torch.zeros_like(thrust)
        # R @ [0, 0, T] is R's third column times T, whatever the order of
        # the product's sum: its other terms are zeros.
        lift = (quat_to_rotation_matrix(q) @ torch.stack([zero, zero, thrust], -1)[..., None])
        acc = lift[..., 0] / self.mass + torch.stack(
            [zero + 0.0, zero + 0.0, zero - self.gravity], -1)

        # q_dot = 0.5 Omega(w) q (quadrotor_rate.cpp getOmegaMatrix).
        q_dot = 0.5 * torch.stack([-wx * qx - wy * qy - wz * qz,
                                   wx * qw + wz * qy - wy * qz,
                                   wy * qw - wz * qx + wx * qz,
                                   wz * qw + wy * qx - wx * qy], -1)
        return torch.cat([v, acc, q_dot], dim=-1)
