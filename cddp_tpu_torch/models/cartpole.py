"""Cart-pole (nx=4: x, theta, x_dot, theta_dot; nu=1: force).

Port of ``cddp_tpu/models/cartpole.py`` (reference ``cartpole.cpp:28-95``),
the damped form the reference's autodiff path takes. The JAX model has no
analytic Jacobians, so neither has this one: they come by forward-mode AD
(``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class CartPole(DynamicalSystem):
    state_dim = 4
    control_dim = 1

    def __init__(self, cart_mass: float = 1.0, pole_mass: float = 0.2,
                 pole_length: float = 0.5, gravity: float = 9.81, damping: float = 0.0,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, cart_mass=cart_mass, pole_mass=pole_mass,
                            pole_length=pole_length, gravity=gravity, damping=damping)

    def forward(self, x, u, t):
        theta, x_dot, theta_dot = x[..., 1], x[..., 2], x[..., 3]
        force = u[..., 0]
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        total_mass = self.cart_mass + self.pole_mass
        den = self.cart_mass + self.pole_mass * sin_t * sin_t
        x_ddot = (force + self.pole_mass * sin_t
                  * (self.pole_length * theta_dot ** 2 + self.gravity * cos_t)) / den
        theta_ddot = (
            -force * cos_t
            - self.pole_mass * self.pole_length * theta_dot ** 2 * cos_t * sin_t
            - total_mass * self.gravity * sin_t
            - self.damping * theta_dot
        ) / (self.pole_length * den)
        return torch.stack([x_dot, theta_dot, x_ddot, theta_ddot], dim=-1)
