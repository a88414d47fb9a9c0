"""The spacecraft model family.

Port of ``cddp_tpu/models/spacecraft.py`` (reference
``src/dynamics_model/spacecraft_{linear,linear_fuel,nonlinear,landing2d,
twobody}.cpp``):

- :class:`HCW`: Hill-Clohessy-Wiltshire linear relative motion in the LVLH
  frame (nx = 6: x, y, z, vx, vy, vz; nu = 3: thrust);
- :class:`SpacecraftLinearFuel`: HCW with the live mass, depleted at
  -||u||_eps / (isp g0), and the accumulated effort 0.5 |u|^2 (nx = 8);
- :class:`SpacecraftNonlinear`: nonlinear relative orbital motion beside the
  chief's orbit [r0, theta, dr0, dtheta] (nx = 10, nu = 3);
- :class:`SpacecraftLanding2D`: the planar powered-descent lander, x =
  [x, x_dot, y, y_dot, theta, theta_dot], u = [thrust percent, gimbal
  angle] (nx = 6, nu = 2);
- :class:`SpacecraftTwobody`: inertial two-body motion under thrust (nx = 6,
  nu = 3).

Each copies the JAX model's expressions in its order of operations (``u @ u``
summed in order, ``** 1.5``, ``linalg.norm`` and ``r ** 3``). The JAX models
have no analytic Jacobians, so neither have these: they come by
forward-mode AD (``DynamicalSystem.jacobians``). Parameters are float64
scalar buffers in the JAX field order.
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


class SpacecraftLinearFuel(DynamicalSystem):
    """x = [p (3), v (3), mass, effort]; the thrust divides by the live
    mass x[6]."""

    state_dim = 8
    control_dim = 3

    def __init__(self, mean_motion: float = 0.001, isp: float = 300.0, g0: float = 9.80665,
                 epsilon: float = 1e-10, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, mean_motion=mean_motion, isp=isp, g0=g0, epsilon=epsilon)

    def forward(self, x, u, t):
        px, pz = x[..., 0], x[..., 2]
        vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
        mass = x[..., 6]
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        n = self.mean_motion
        ax = 2.0 * n * vy + 3.0 * n * n * px + u0 / mass
        ay = -2.0 * n * vx + u1 / mass
        az = -n * n * pz + u2 / mass
        thrust_sq = u0 * u0 + u1 * u1 + u2 * u2
        thrust_norm = torch.sqrt(thrust_sq + self.epsilon)
        mdot = -thrust_norm / (self.isp * self.g0)
        effort = 0.5 * thrust_sq
        return torch.stack([vx, vy, vz, ax, ay, az, mdot, effort], dim=-1)


class SpacecraftNonlinear(DynamicalSystem):
    """x = [p (3), v (3), r0, theta, dr0, dtheta]: the deputy relative to
    the chief, and the chief's radius, anomaly and their rates."""

    state_dim = 10
    control_dim = 3

    def __init__(self, mass: float = 1.0, r_scale: float = 1.0, v_scale: float = 1.0,
                 mu: float = 1.0, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, mass=mass, r_scale=r_scale, v_scale=v_scale, mu=mu)

    def forward(self, x, u, t):
        px, py, pz = x[..., 0], x[..., 1], x[..., 2]
        vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
        r0, dr0, dtheta = x[..., 6], x[..., 8], x[..., 9]
        mu, mass = self.mu, self.mass
        den = ((r0 + px) ** 2 + py ** 2 + pz ** 2) ** 1.5
        r0_sq = r0 * r0
        ddr0 = -mu / r0_sq + r0 * dtheta * dtheta
        ddtheta = -2.0 * dr0 * dtheta / r0
        ddx = (2.0 * dtheta * vy + ddtheta * py + dtheta * dtheta * px
               - mu * (px + r0) / den + mu / r0_sq + u[..., 0] / mass)
        ddy = (-2.0 * dtheta * vx - ddtheta * px + dtheta * dtheta * py
               - mu * py / den + u[..., 1] / mass)
        ddz = -mu * pz / den + u[..., 2] / mass
        return torch.stack([vx, vy, vz, ddx, ddy, ddz, dr0, dtheta, ddr0, ddtheta], dim=-1)


class SpacecraftLanding2D(DynamicalSystem):
    """x = [x, x_dot, y, y_dot, theta, theta_dot], u = [thrust percent,
    gimbal angle]; the torque of the thrust offset at half the length."""

    state_dim = 6
    control_dim = 2

    def __init__(self, mass: float = 100000.0, length: float = 50.0,
                 max_thrust: float = 2210000.0, gravity: float = 9.81,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, mass=mass, length=length, max_thrust=max_thrust,
                            gravity=gravity)

    @property
    def inertia(self):
        """The rod's (1/12) m L^2, in the JAX model's order of operations."""
        return (1.0 / 12.0) * self.mass * self.length ** 2

    def forward(self, x, u, t):
        xdot, ydot, theta, theta_dot = x[..., 1], x[..., 3], x[..., 4], x[..., 5]
        thrust_percent, thrust_angle = u[..., 0], u[..., 1]
        total_angle = thrust_angle + theta
        thrust = self.max_thrust * thrust_percent
        Fx = thrust * torch.sin(total_angle)
        Fy = thrust * torch.cos(total_angle)
        T = -self.length / 2.0 * thrust * torch.sin(thrust_angle)
        return torch.stack([xdot, Fx / self.mass, ydot, Fy / self.mass - self.gravity,
                            theta_dot, T / self.inertia], dim=-1)


class SpacecraftTwobody(DynamicalSystem):
    """x = [p (3), v (3)] in an inertial frame, km and km/s for the Earth's
    mu; u the thrust acceleration times the mass."""

    state_dim = 6
    control_dim = 3

    def __init__(self, mu: float = 398600.4418, mass: float = 1.0,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, mu=mu, mass=mass)

    def forward(self, x, u, t):
        p, v = x[..., :3], x[..., 3:]
        r = torch.linalg.norm(p, dim=-1, keepdim=True)
        acc = -self.mu * p / r ** 3 + u / self.mass
        return torch.cat([v, acc], dim=-1)
