"""Unicycle kinematics (nx=3: x, y, theta; nu=2: v, omega).

Port of ``cddp_tpu/models/unicycle.py`` (reference ``unicycle.cpp:28-67``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem


class Unicycle(DynamicalSystem):
    state_dim = 3
    control_dim = 2

    def forward(self, x, u, t):
        theta = x[..., 2]
        v, omega = u[..., 0], u[..., 1]
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta), omega],
                           dim=-1)

    def jacobians(self, x, u, t):
        # Analytic (unicycle.cpp:43-66).
        theta, v = x[..., 2], u[..., 0]
        s, c = torch.sin(theta), torch.cos(theta)
        z = torch.zeros_like(theta)
        one = torch.ones_like(theta)
        Fx = torch.stack([
            torch.stack([z, z, -v * s], -1),
            torch.stack([z, z, v * c], -1),
            torch.stack([z, z, z], -1),
        ], -2)
        Fu = torch.stack([
            torch.stack([c, z], -1),
            torch.stack([s, z], -1),
            torch.stack([z, one], -1),
        ], -2)
        return Fx, Fu
