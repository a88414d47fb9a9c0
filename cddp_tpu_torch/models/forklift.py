"""Forklift: kinematic bicycle with the steering angle as a state and the
rear-steer sign convention (nx=5: x, y, theta, v, delta; nu=2: a, ddelta).

Port of ``cddp_tpu/models/forklift.py`` (reference ``forklift.cpp:17-49``):
the continuous form, whose Euler step is the reference's discrete map.
The kernels' parameter vector is (wheelbase, steer_sign), steer_sign -1
for a rear-steered truck (the JAX lane registry's, rollout.py:498-505).
The JAX model has no analytic Jacobians, so neither has this one: they
come by forward-mode AD (``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class Forklift(DynamicalSystem):
    state_dim = 5
    control_dim = 2

    def __init__(self, wheelbase: float = 2.0, max_steering_angle: float = 0.785398,
                 rear_steer: bool = True, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, wheelbase=wheelbase, max_steering_angle=max_steering_angle)
        self.rear_steer = bool(rear_steer)

    @property
    def steer_sign(self) -> float:
        return -1.0 if self.rear_steer else 1.0

    def forward(self, x, u, t):
        theta, v, delta = x[..., 2], x[..., 3], x[..., 4]
        eff = self.steer_sign * delta
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta),
                            v * torch.tan(eff) / self.wheelbase, u[..., 0], u[..., 1]], dim=-1)
