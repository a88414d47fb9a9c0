"""Quadratic objective (port of ``cddp_tpu/costs/objective.py:131-206``).

cost_k = (x - goal)' Q (x - goal) + u' R u with Q and R pre-scaled by the
timestep at construction (objective.cpp:37-39) and no 1/2 factor; the
terminal cost uses the unscaled Qf. Batch-first: ``x`` is (..., nx).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from cddp_tpu_torch import devices


@dataclass(frozen=True)
class QuadraticObjective:
    Q: torch.Tensor  # (nx, nx), already scaled by dt
    R: torch.Tensor  # (nu, nu), already scaled by dt
    Qf: torch.Tensor  # (nx, nx), unscaled
    reference_state: torch.Tensor  # (nx,)

    def replace(self, **kw) -> "QuadraticObjective":
        return dataclasses.replace(self, **kw)

    def running_cost(self, x, u, k=None):
        e = x - self.reference_state
        return ((e @ self.Q) * e).sum(-1) + ((u @ self.R) * u).sum(-1)

    def terminal_cost(self, x):
        e = x - self.reference_state
        return ((e @ self.Qf) * e).sum(-1)

    def evaluate(self, X, U):
        """Total cost of (..., N+1, nx), (..., N, nu) trajectories."""
        return self.running_cost(X[..., :-1, :], U).sum(-1) + self.terminal_cost(
            X[..., -1, :]
        )

    # Analytic derivatives (objective.cpp:103-160): gradients 2Qe / 2Ru,
    # Hessians 2Q / 2R, zero cross term.
    def running_cost_gradients(self, x, u, k=None):
        e = x - self.reference_state
        return e @ (2.0 * self.Q).T, u @ (2.0 * self.R).T

    def terminal_cost_gradient(self, x):
        return (x - self.reference_state) @ (2.0 * self.Qf).T

    def running_cost_hessians(self, x, u, k=None):
        batch = x.shape[:-1]
        nx, nu = self.Q.shape[0], self.R.shape[0]
        return (
            (2.0 * self.Q).expand(*batch, nx, nx),
            (2.0 * self.R).expand(*batch, nu, nu),
            self.Q.new_zeros(*batch, nu, nx),
        )

    def terminal_cost_hessian(self, x):
        nx = self.Qf.shape[0]
        return (2.0 * self.Qf).expand(*x.shape[:-1], nx, nx)


def quadratic_objective(Q, R, Qf, reference_state, timestep: float,
                        reference_states=None, *, device=None,
                        dtype=None) -> QuadraticObjective:
    """Build a QuadraticObjective with the reference's dt pre-scaling of Q
    and R (objective.cpp:37-39). Raises on non-square matrices. The tensors
    go to ``device``, the CUDA card when None."""
    if reference_states is not None:
        raise NotImplementedError(
            "reference_states tracking is not yet ported to cddp_tpu_torch"
        )
    device = devices.resolve(device)
    Q, R, Qf, ref = (torch.as_tensor(v, device=device, dtype=dtype)
                     for v in (Q, R, Qf, reference_state))
    for name, M in (("Q", Q), ("R", R), ("Qf", Qf)):
        if M.shape[0] != M.shape[1]:
            raise ValueError(f"{name} matrix must be square")
    return QuadraticObjective(Q=Q * timestep, R=R * timestep, Qf=Qf,
                              reference_state=ref)
