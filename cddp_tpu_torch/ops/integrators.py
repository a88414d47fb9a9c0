"""Explicit fixed-step integrators (port of ``cddp_tpu/ops/integrators.py``).

euler / heun / rk3 / rk4 with the reference's Butcher tableaus
(``dynamical_system.cpp:28-83``), as combinators over a batch-first
continuous-dynamics callable ``f(x (B, nx), u (B, nu), t) -> (B, nx)``.
"""

from __future__ import annotations

from typing import Callable

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor, object], torch.Tensor]


def euler_step(f: Dynamics, x, u, t, dt):
    return x + dt * f(x, u, t)


def heun_step(f: Dynamics, x, u, t, dt):
    k1 = f(x, u, t)
    k2 = f(x + dt * k1, u, t + dt)
    return x + 0.5 * dt * (k1 + k2)


def rk3_step(f: Dynamics, x, u, t, dt):
    # Kutta's third-order rule, matching dynamical_system.cpp:44-55.
    k1 = f(x, u, t)
    k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
    k3 = f(x - dt * k1 + 2.0 * dt * k2, u, t + dt)
    return x + (dt / 6.0) * (k1 + 4.0 * k2 + k3)


def rk4_step(f: Dynamics, x, u, t, dt):
    k1 = f(x, u, t)
    k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
    k3 = f(x + 0.5 * dt * k2, u, t + 0.5 * dt)
    k4 = f(x + dt * k3, u, t + dt)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {
    "euler": euler_step,
    "heun": heun_step,
    "rk3": rk3_step,
    "rk4": rk4_step,
}


def integrate(f: Dynamics, method: str, x, u, t, dt):
    """Dispatch mirroring ``DynamicalSystem::getDiscreteDynamics``
    (dynamical_system.cpp:67-83)."""
    try:
        stepper = _STEPPERS[method]
    except KeyError as e:
        raise ValueError(
            f"Integration type {method!r} not supported "
            f"(expected one of {sorted(_STEPPERS)})"
        ) from e
    return stepper(f, x, u, t, dt)
