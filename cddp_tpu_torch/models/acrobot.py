"""Acrobot: two-link underactuated pendulum, torque on the second joint
(nx=4: theta1, theta2, dtheta1, dtheta2; nu=1: tau2).

Port of ``cddp_tpu/models/acrobot.py`` (reference ``acrobot.cpp``: mass
matrix, Coriolis, gravity and friction as the reference forms them). The
JAX model solves M ddq = tau - B - G - C with ``jnp.linalg.solve`` (an LU
factorization); this one solves the 2x2 system by Cramer's rule, as the
JAX lane does (rollout.py:272-292 of the JAX package), and so does the
struct of ``ops/csrc/models.cuh``, in the same order of operations: kernel
and plain version then round alike, and M is symmetric positive definite
(det >= m1 l1^2 J2 + ... > 0), so the two solves agree to roundoff. The
JAX model has no analytic Jacobians, so neither has this one: they come by
forward-mode AD (``DynamicalSystem.jacobians``).
"""

from __future__ import annotations

import torch

from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters


class Acrobot(DynamicalSystem):
    state_dim = 4
    control_dim = 1

    def __init__(self, l1: float = 1.0, l2: float = 1.0, m1: float = 1.0, m2: float = 1.0,
                 J1: float = 1.0, J2: float = 1.0, gravity: float = 9.81,
                 friction: float = 1.0, integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, l1=l1, l2=l2, m1=m1, m2=m2, J1=J1, J2=J2, gravity=gravity,
                            friction=friction)

    def forward(self, x, u, t):
        l1, l2, m1, m2 = self.l1, self.l2, self.m1, self.m2
        J1, J2, g, fric = self.J1, self.J2, self.gravity, self.friction
        th1, th2, dth1, dth2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        s2, c2 = torch.sin(th2), torch.cos(th2)
        c1, c12 = torch.cos(th1), torch.cos(th1 + th2)
        m11 = m1 * (l1 * l1) + J1 + m2 * (l1 * l1 + l2 * l2 + 2.0 * l1 * l2 * c2) + J2
        m12 = m2 * (l2 * l2 + l1 * l2 * c2) + J2
        m22 = (l2 * l2) * m2 + J2
        tmp = l1 * l2 * m2 * s2
        b1 = -(2.0 * dth1 * dth2 + dth2 * dth2) * tmp
        b2 = tmp * dth1 * dth1
        g1 = ((m1 + m2) * l1 * c1 + m2 * l2 * c12) * g
        g2 = m2 * l2 * c12 * g
        r1 = -b1 - g1 - fric * dth1
        r2 = u[..., 0] - b2 - g2 - fric * dth2
        det = m11 * m22 - m12 * m12
        return torch.stack([dth1, dth2, (m22 * r1 - m12 * r2) / det,
                            (m11 * r2 - m12 * r1) / det], dim=-1)
