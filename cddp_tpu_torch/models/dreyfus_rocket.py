"""Dreyfus rocket: vertical ascent with thrust-angle control (nx=2:
altitude, its rate; nu=1: the thrust angle).

Port of ``cddp_tpu/models/dreyfus_rocket.py`` (reference
``dreyfus_rocket.cpp``). The JAX model has no analytic Jacobians, so
neither has this one: they come by forward-mode AD
(``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class DreyfusRocket(DynamicalSystem):
    state_dim = 2
    control_dim = 1

    def __init__(self, thrust_acceleration: float = 64.0, gravity_acceleration: float = 32.0,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, thrust_acceleration=thrust_acceleration,
                            gravity_acceleration=gravity_acceleration)

    def forward(self, x, u, t):
        return torch.stack([x[..., 1], self.thrust_acceleration * torch.cos(u[..., 0])
                            - self.gravity_acceleration], dim=-1)
