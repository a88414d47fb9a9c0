"""Problem definition (port of ``cddp_tpu/problem.py:31-123``).

A :class:`Problem` is immutable: it bundles the model, objective, path
and terminal constraints, initial state and horizon, and every solve returns new
tensors. ``x0`` is (nx,) for one solve or (B, nx) for a batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.constraints.path import ControlConstraint
from cddp_tpu_torch.costs.objective import QuadraticObjective
from cddp_tpu_torch.models.base import DynamicalSystem


@dataclass(frozen=True)
class Problem:
    model: DynamicalSystem
    objective: object  # QuadraticObjective, or an Objective (costs/objective.py)
    x0: torch.Tensor
    horizon: int
    timestep: float
    constraints: Dict[str, ControlConstraint] = field(default_factory=dict)
    terminal_constraints: Dict[str, object] = field(default_factory=dict)

    @property
    def state_dim(self) -> int:
        return self.model.state_dim

    @property
    def control_dim(self) -> int:
        return self.model.control_dim

    def replace(self, **kw) -> "Problem":
        return dataclasses.replace(self, **kw)

    def add_constraint(self, name: str, constraint) -> "Problem":
        """Functional add-or-replace (detail::addOrReplaceConstraint)."""
        if constraint is None:
            raise ValueError("Cannot add null constraint.")
        return self.replace(constraints={**self.constraints, name: constraint})

    def add_terminal_constraint(self, name: str, constraint) -> "Problem":
        """Functional add-or-replace of a terminal constraint
        (problem.py:78-85 of the JAX package)."""
        if constraint is None:
            raise ValueError("Cannot add null constraint.")
        return self.replace(terminal_constraints={**self.terminal_constraints,
                                                  name: constraint})

    def get_constraint(self, name: str) -> Optional[ControlConstraint]:
        return self.constraints.get(name)

    def sorted_constraints(self):
        """(name, constraint) pairs in name order — the std::map iteration
        order the reference's stacked blocks use."""
        return sorted(self.constraints.items())

    def sorted_terminal_constraints(self):
        return sorted(self.terminal_constraints.items())

    def initial_trajectories(self, X=None, U=None):
        """Zero-initialized (X, U) with X[..., 0, :] = x0, unless warm-start
        tensors of the right shape are given (cddp_core.cpp:272-298). Warm
        starts adopt x0's dtype and device."""
        nx, nu, N = self.state_dim, self.control_dim, self.horizon
        batch = tuple(self.x0.shape[:-1])
        like = dict(dtype=self.x0.dtype, device=self.x0.device)
        if X is None or tuple(X.shape) != batch + (N + 1, nx):
            X = torch.zeros(batch + (N + 1, nx), **like)
        if U is None or tuple(U.shape) != batch + (N, nu):
            U = torch.zeros(batch + (N, nu), **like)
        X = X.to(**like).clone()
        X[..., 0, :] = self.x0
        return X, U.to(**like)


def problem(model: DynamicalSystem, objective: QuadraticObjective, x0,
            horizon: int, timestep: float,
            constraints: Optional[Dict[str, ControlConstraint]] = None,
            terminal_constraints: Optional[Dict[str, object]] = None, *,
            device=None, dtype=None) -> Problem:
    """Build a Problem; ``x0`` goes to ``device``, the CUDA card when None."""
    return Problem(
        model=model,
        objective=objective,
        x0=torch.as_tensor(x0, device=devices.resolve(device), dtype=dtype),
        horizon=int(horizon),
        timestep=float(timestep),
        constraints=dict(constraints or {}),
        terminal_constraints=dict(terminal_constraints or {}),
    )
