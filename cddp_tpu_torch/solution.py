"""Solver status codes and solution record (port of ``cddp_tpu/solution.py``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch


class Status:
    """Termination codes mapped to the reference's status_message strings
    (cddp_solver_base.cpp:69,83,127 etc.)."""

    RUNNING = -1
    MAX_ITERATIONS_REACHED = 0
    OPTIMAL_SOLUTION_FOUND = 1
    ACCEPTABLE_SOLUTION_FOUND = 2
    REGULARIZATION_LIMIT_NOT_CONVERGED = 3
    REGULARIZATION_LIMIT_CONVERGED = 4
    MAX_CPU_TIME_REACHED = 5

    MESSAGES = {
        -1: "Running",
        0: "MaxIterationsReached",
        1: "OptimalSolutionFound",
        2: "AcceptableSolutionFound",
        3: "RegularizationLimitReached_NotConverged",
        4: "RegularizationLimitReached_Converged",
        5: "MaxCpuTimeReached",
    }

    CONVERGED = (1, 2, 4)


@dataclass(frozen=True)
class Solution:
    """Solver output (CDDPSolution, cddp_core.hpp:54-103). Batch-first:
    a batched solve gives every tensor a leading batch axis."""

    solver_name: str
    status_code: torch.Tensor  # int32
    iterations_completed: torch.Tensor  # int32
    final_objective: torch.Tensor
    final_step_length: torch.Tensor
    final_regularization: torch.Tensor
    time_points: torch.Tensor  # (N+1,)
    state_trajectory: torch.Tensor  # (..., N+1, nx)
    control_trajectory: torch.Tensor  # (..., N, nu)
    feedback_gains: torch.Tensor  # (..., N, nu, nx)
    feedforward_gains: torch.Tensor  # (..., N, nu)
    inf_du: Optional[torch.Tensor] = None
    # Interior-point fields (IPDDP): duals and slacks per path constraint
    # name, (..., N, dual_dim); costates (..., N+1, nx); the final barrier
    # parameter and residuals. None for CLDDP.
    dual_trajectories: Optional[Dict[str, torch.Tensor]] = None
    slack_trajectories: Optional[Dict[str, torch.Tensor]] = None
    costate_trajectory: Optional[torch.Tensor] = None
    barrier_mu: Optional[torch.Tensor] = None
    inf_pr: Optional[torch.Tensor] = None
    inf_comp: Optional[torch.Tensor] = None
    # Terminal constraints (IPDDP): the inequalities' duals and the
    # equalities' multipliers by name, (..., dual_dim), and the
    # inequalities' slacks by name. None without terminal constraints.
    terminal_duals: Optional[Dict[str, torch.Tensor]] = None
    terminal_slacks: Optional[Dict[str, torch.Tensor]] = None

    def first(self) -> "Solution":
        """The first instance of a batched solution (the unbatched form):
        every per-instance tensor loses its leading batch axis."""

        def pick(f, v):
            if isinstance(v, torch.Tensor) and f != "time_points":
                return v[0]
            if isinstance(v, dict):
                return {k: t[0] for k, t in v.items()}
            return v

        return dataclasses.replace(self, **{
            f.name: pick(f.name, getattr(self, f.name))
            for f in dataclasses.fields(self)})

    def converged_mask(self) -> torch.Tensor:
        """Boolean convergence flags of every solve, the shape of
        ``status_code`` (solution.py:115-120 of the JAX package)."""
        code = self.status_code
        return torch.isin(code, torch.tensor(Status.CONVERGED, dtype=code.dtype,
                                             device=code.device))

    def status_messages(self) -> list:
        """One decoded status string per solve (flattened)."""
        return [Status.MESSAGES.get(int(c), "Unknown")
                for c in self.status_code.reshape(-1).tolist()]
