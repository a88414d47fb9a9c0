"""Dubins car: fixed forward speed, steering-rate control (nx=3: x, y,
theta; nu=1: omega).

Port of ``cddp_tpu/models/dubins_car.py`` (reference ``dubins_car.cpp``).
The JAX model has no analytic Jacobians, so neither has this one: they
come by forward-mode AD (``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class DubinsCar(DynamicalSystem):
    state_dim = 3
    control_dim = 1

    def __init__(self, speed: float = 1.0, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, speed=speed)

    def forward(self, x, u, t):
        theta = x[..., 2]
        return torch.stack([self.speed * torch.cos(theta), self.speed * torch.sin(theta),
                            u[..., 0]], dim=-1)
