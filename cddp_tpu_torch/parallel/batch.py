"""Batched solving (port of ``cddp_tpu/parallel/batch.py:27-58``).

Batch-first, with no vmap: the solvers take a (B, nx) ``x0`` and solve
every instance in one call.
"""

from __future__ import annotations

from typing import Optional

import torch

from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.problem import Problem


def batched_solve(
    problem: Problem,
    x0_batch: torch.Tensor,
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    U0_batch: Optional[torch.Tensor] = None,
):
    """Solve one problem structure for a batch of initial states.

    ``x0_batch``: (B, nx). Each instance is seeded with the constant-state
    nominal X0 = broadcast(x0) and U0 = 0 unless ``U0_batch`` (B, N, nu) is
    given. Returns a Solution whose tensors have a leading batch axis.
    """
    from cddp_tpu_torch.solvers import get_solver

    solve_fn = get_solver(solver)
    N = problem.horizon
    X0 = x0_batch[:, None, :].expand(-1, N + 1, -1)
    if U0_batch is None:
        U0_batch = x0_batch.new_zeros(x0_batch.shape[0], N, problem.control_dim)
    return solve_fn(problem.replace(x0=x0_batch), options, X0=X0, U0=U0_batch)
