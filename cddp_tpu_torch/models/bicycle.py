"""Kinematic bicycle (nx=4: x, y, theta, v; nu=2: a, delta).

Port of ``cddp_tpu/models/bicycle.py`` (reference ``bicycle.cpp:28-46``).
The yaw rate is the JAX model's (v / wheelbase) tan(delta), not its lane's
sin(delta) / cos(delta) (rollout.py:245-250 of the JAX package): the struct
of ``ops/csrc/models.cuh`` takes this form too, so that kernel and plain
version round alike. The JAX model has no analytic Jacobians, so neither
has this one: they come by forward-mode AD (``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class Bicycle(DynamicalSystem):
    state_dim = 4
    control_dim = 2

    def __init__(self, wheelbase: float = 1.0, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, wheelbase=wheelbase)

    def forward(self, x, u, t):
        theta, v = x[..., 2], x[..., 3]
        a, delta = u[..., 0], u[..., 1]
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta),
                            (v / self.wheelbase) * torch.tan(delta), a], dim=-1)
