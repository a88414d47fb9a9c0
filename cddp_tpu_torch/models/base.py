"""Dynamical-system base (port of ``cddp_tpu/models/base.py``).

A model is an ``nn.Module``: physical parameters are buffers and
``forward(x, u, t)`` is the continuous ODE on batch-first ``(B, nx)`` /
``(B, nu)`` tensors. Jacobians default to ``torch.func.jacfwd`` under
``vmap``; models override them with analytic forms where the JAX package
does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from cddp_tpu_torch.ops.integrators import integrate


def register_parameters(model: nn.Module, **values: float) -> None:
    """The physical parameters as float64 scalar buffers, in the order given
    (the JAX model's field order). A solve casts them to its dtype
    (``solvers/base.py::canonicalize_problem_dtype``)."""
    for name, v in values.items():
        model.register_buffer(name, torch.tensor(float(v), dtype=torch.float64))


class DynamicalSystem(nn.Module):
    """Continuous ODE plus integrator dispatch. Subclasses set ``state_dim``
    and ``control_dim`` and implement ``forward``."""

    state_dim: int = 0
    control_dim: int = 0

    def __init__(self, integration_type: str = "euler"):
        super().__init__()
        self.integration_type = integration_type

    def forward(self, x: torch.Tensor, u: torch.Tensor, t) -> torch.Tensor:
        """dx/dt = f(x, u, t) for a batch: (B, nx), (B, nu) -> (B, nx)."""
        raise NotImplementedError

    def discrete_dynamics(self, x, u, t, dt) -> torch.Tensor:
        """x_{k+1} via the configured integrator (dynamical_system.cpp:67-83)."""
        return integrate(self.forward, self.integration_type, x, u, t, dt)

    def jacobians(self, x, u, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Fx (B, nx, nx), Fu (B, nx, nu)) of the continuous dynamics by
        forward-mode AD (base.py:55-66 of the JAX package)."""
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(x.shape[0])

        def one(xi, ui, ti):
            return self.forward(xi[None], ui[None], ti)[0]

        jac = torch.func.jacfwd(one, argnums=(0, 1))
        return torch.func.vmap(jac)(x, u, t)


def rollout(model: DynamicalSystem, x0: torch.Tensor, U: torch.Tensor,
            dt: float) -> torch.Tensor:
    """Open-loop rollout X[t+1] = f_d(X[t], U[t], t*dt) for a batch:
    x0 (B, nx), U (B, N, nu) -> X (B, N+1, nx) (base.py:93-117). Registered
    models run the open-loop rollout kernel on CUDA tensors
    (``ops/kernels/ip_rollout.py::open_loop_rollout``)."""
    from cddp_tpu_torch.ops.kernels.ip_rollout import open_loop_rollout

    return open_loop_rollout(model, x0, U, dt)
