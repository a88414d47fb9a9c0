"""Quadratic objective (port of ``cddp_tpu/costs/objective.py:131-206``).

cost_k = (x - xref_k)' Q (x - xref_k) + u' R u with Q and R pre-scaled by
the timestep at construction (objective.cpp:37-39) and no 1/2 factor; the
terminal cost tracks ``reference_state`` with the unscaled Qf. Batch-first:
``x`` is (..., nx).

``reference_states`` is the optional per-step reference trajectory, (N, nx)
or (N+1, nx), one trajectory shared by every instance of a batch: step k's
running cost tracks row k (rows 0..N-1 only), and without it every step
tracks ``reference_state``. The running-cost functions take the step ``k``
as an int, or as a slice for an ``x`` whose axis -2 is the step axis
(``evaluate``, ``solvers/base.py::running_cost_derivatives``); a tracking
objective raises when no step is given, so no per-step loop can quietly
track the goal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from cddp_tpu_torch import devices


@dataclass(frozen=True)
class QuadraticObjective:
    Q: torch.Tensor  # (nx, nx), already scaled by dt
    R: torch.Tensor  # (nu, nu), already scaled by dt
    Qf: torch.Tensor  # (nx, nx), unscaled
    reference_state: torch.Tensor  # (nx,)
    reference_states: Optional[torch.Tensor] = None  # (N, nx) or (N+1, nx)

    def replace(self, **kw) -> "QuadraticObjective":
        return dataclasses.replace(self, **kw)

    def running_reference(self, k):
        """Step ``k``'s running reference: (nx,) for an int ``k``, (n, nx)
        rows for a slice."""
        if self.reference_states is None:
            return self.reference_state
        if k is None:
            raise ValueError("a tracking objective's running cost needs its step k")
        return self.reference_states[k]

    def running_cost(self, x, u, k=None):
        e = x - self.running_reference(k)
        return ((e @ self.Q) * e).sum(-1) + ((u @ self.R) * u).sum(-1)

    def terminal_cost(self, x):
        e = x - self.reference_state
        return ((e @ self.Qf) * e).sum(-1)

    def evaluate(self, X, U):
        """Total cost of (..., N+1, nx), (..., N, nu) trajectories."""
        steps = slice(0, U.shape[-2])
        return self.running_cost(X[..., :-1, :], U, steps).sum(-1) + self.terminal_cost(
            X[..., -1, :]
        )

    # Analytic derivatives (objective.cpp:103-160): gradients 2Qe / 2Ru,
    # Hessians 2Q / 2R, zero cross term.
    def running_cost_gradients(self, x, u, k=None):
        e = x - self.running_reference(k)
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
    and R (objective.cpp:37-39). Raises on non-square matrices and on a
    reference trajectory whose last row differs from ``reference_state``
    (objective.cpp:41-64). The tensors go to ``device``, the CUDA card when
    None."""
    device = devices.resolve(device)
    Q, R, Qf, ref = (torch.as_tensor(v, device=device, dtype=dtype)
                     for v in (Q, R, Qf, reference_state))
    for name, M in (("Q", Q), ("R", R), ("Qf", Qf)):
        if M.shape[0] != M.shape[1]:
            raise ValueError(f"{name} matrix must be square")
    if reference_states is not None:
        reference_states = torch.as_tensor(reference_states, device=device, dtype=ref.dtype)
        if float(torch.linalg.norm(reference_states[-1] - ref)) > 1e-6:
            raise ValueError("Last reference state must be same as the reference state")
    return QuadraticObjective(Q=Q * timestep, R=R * timestep, Qf=Qf,
                              reference_state=ref, reference_states=reference_states)
