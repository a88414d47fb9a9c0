"""Spacecraft relative motion: the Hill-Clohessy-Wiltshire model
(nx=6: x, y, z, vx, vy, vz in the LVLH frame; nu=3: thrust).

Port of ``cddp_tpu/models/spacecraft.py::HCW`` (reference
``spacecraft_linear.cpp:22-57``). The JAX model has no analytic Jacobians,
so neither has this one: they come by forward-mode AD
(``DynamicalSystem.jacobians``). The other spacecraft models of that module
are not ported.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class HCW(DynamicalSystem):
    state_dim = 6
    control_dim = 3

    def __init__(self, mean_motion: float = 0.001, mass: float = 1.0,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, mean_motion=mean_motion, mass=mass)

    def forward(self, x, u, t):
        px, pz = x[..., 0], x[..., 2]
        vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
        n = self.mean_motion
        ax = 2.0 * n * vy + 3.0 * n * n * px + u[..., 0] / self.mass
        ay = -2.0 * n * vx + u[..., 1] / self.mass
        az = -n * n * pz + u[..., 2] / self.mass
        return torch.stack([vx, vy, vz, ax, ay, az], dim=-1)
