"""Inverted pendulum (nx=2: theta, theta_dot; nu=1: torque).

Port of ``cddp_tpu/models/pendulum.py`` (reference ``pendulum.cpp``). The
JAX model takes the analytic dynamics' + sign of the gravity term, and its
solver reads the analytic Jacobians (pendulum.cpp:46-66); both are copied
here expression for expression.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class Pendulum(DynamicalSystem):
    state_dim = 2
    control_dim = 1

    def __init__(self, length: float = 1.0, mass: float = 1.0, damping: float = 0.0,
                 gravity: float = 9.81, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, length=length, mass=mass, damping=damping,
                            gravity=gravity)

    def forward(self, x, u, t):
        theta, theta_dot = x[..., 0], x[..., 1]
        inertia = self.mass * self.length * self.length
        theta_ddot = (u[..., 0] - self.damping * theta_dot
                      + self.mass * self.gravity * self.length * torch.sin(theta)) / inertia
        return torch.stack([theta_dot, theta_ddot], dim=-1)

    def jacobians(self, x, u, t):
        # Analytic (pendulum.py:41-57 of the JAX package).
        theta = x[..., 0]
        z = torch.zeros_like(theta)
        ml2 = self.mass * (self.length * self.length)  # m * l**2, as the JAX model
        Fx = torch.stack([
            torch.stack([z, z + 1.0], -1),
            torch.stack([(self.gravity / self.length) * torch.cos(theta),
                         -self.damping / ml2 + z], -1),
        ], -2)
        Fu = torch.stack([z, 1.0 / ml2 + z], -1)[..., None]
        return Fx, Fu
