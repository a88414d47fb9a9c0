"""Car with Tassa's rolling-distance discrete kinematics (nx=4: x, y,
theta, v; nu=2: steering angle delta, acceleration a).

Port of ``cddp_tpu/models/car.py`` (reference ``car.cpp:30-50``). The model
is natively discrete: over one step of length h the wheels roll

    f = h v,  b = d + f cos(delta) - sqrt(d^2 - (f sin(delta))^2)
    x+ = x + [b cos(theta), b sin(theta), asin(sin(delta) f / d), h a]

with d the wheelbase. ``discrete_dynamics`` is that map on its ``dt``, in
the JAX model's order of operations; the kernels step it in place of an
integrator (``models.cuh::Car::step``). ``forward`` is the finite
difference (f_d(x, u) - x) / h over the model's own ``timestep``, which
the solvers' Euler linearisation A = I + dt Fx turns back into the map's
Jacobian. Where |f sin(delta)| > d the map is NaN, as in the JAX model.
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class Car(DynamicalSystem):
    state_dim = 4
    control_dim = 2

    def __init__(self, wheelbase: float = 2.0, timestep: float = 0.03,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, wheelbase=wheelbase)
        self.timestep = float(timestep)

    def discrete_dynamics(self, x, u, t, dt):
        theta, v = x[..., 2], x[..., 3]
        delta, a = u[..., 0], u[..., 1]
        d = self.wheelbase
        f = dt * v
        sd = torch.sin(delta)
        b = d + f * torch.cos(delta) - torch.sqrt(d * d - (f * sd) * (f * sd))
        dtheta = torch.asin(sd * f / d)
        return x + torch.stack([b * torch.cos(theta), b * torch.sin(theta), dtheta, dt * a],
                               dim=-1)

    def forward(self, x, u, t):
        return (self.discrete_dynamics(x, u, t, self.timestep) - x) / self.timestep
