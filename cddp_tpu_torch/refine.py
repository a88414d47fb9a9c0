"""float64 polish for float32 fleet solutions (port of ``cddp_tpu/refine.py``).

A float32 fleet's KKT residuals floor at about 1e-3 to 1e-4, and some
problem families cannot certify a tolerance of 1e-4 in float32 at all.
:func:`polish` re-solves in float64, warm-started from the fleet solution,
and returns a Solution whose ``status_code``, ``inf_pr`` and ``inf_du`` are
a float64 optimality certificate. On the card the float64 solve runs the
float64 builds of the whole-solve kernels.

An IPDDP or MSIPDDP fleet in which every instance converged polishes from
its duals: the stacked duals and slacks, gains and costates of the
Solution become a solver state, the barrier restarts at the fleet's mean
complementarity (floored at 10 tolerance, capped at 0.1), IPDDP's interior
repair clamps the float32 duals and slacks off the boundary, and the
staleness reinit is off (a converged iterate holds s ~ mu / y far below the
cold slack scale by construction). The gate is all-or-nothing over the
batch, as the JAX package's one trace is. Every other solution (CLDDP,
LogDDP, or a fleet with an unconverged instance, whose duals mislead the
restart) polishes from a cold start seeded with its trajectories.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution
from cddp_tpu_torch.solvers import base


def _restack(blocks: dict, names, dtype):
    """The per-constraint Solution maps concatenated back into the solver's
    stacked layout (the inverse of ``PathStacker.split``)."""
    return torch.cat([blocks[n].to(dtype) for n in names], -1)


def _ipddp_warm_state(problem, solution, X, options, dtype):
    """An IPDDPSolverState rebuilt from a recorded Solution (refine.py:80-126
    of the JAX package), and the warm iterate's mean complementarity. The
    terminal slacks are rebuilt on the constraint surface at the warm x_N,
    s_T = max(terminal_slack_init_scale, -g_T), as the JAX package does, and
    the equality multipliers start at zero."""
    from cddp_tpu_torch.solvers.ipddp import IPDDPSolverState

    stk, tstk = PathStacker(problem), TerminalStacker(problem)
    Y = _restack(solution.dual_trajectories, stk.names, dtype)
    S = _restack(solution.slack_trajectories, stk.names, dtype)
    batch = X.shape[:-2]
    Lam = (solution.costate_trajectory.to(dtype) if solution.costate_trajectory is not None
           else X.new_zeros(batch + (problem.horizon + 1, problem.state_dim)))
    if tstk.ineq_dim and solution.terminal_duals is not None:
        Y_T = _restack(solution.terminal_duals, tstk.ineq_names, dtype)
        S_T = torch.clamp(-tstk.ineq_evaluate(X[..., -1, :]),
                          min=options.ipddp.terminal_slack_init_scale)
    else:
        Y_T = S_T = X.new_zeros(batch + (tstk.ineq_dim,))
    state = IPDDPSolverState(
        k_u=solution.feedforward_gains.to(dtype), K_u=solution.feedback_gains.to(dtype),
        Y=Y, S=S, Lambda=Lam, Y_T=Y_T, S_T=S_T,
        Lambda_T_eq=X.new_zeros(batch + (tstk.eq_dim,)), x0=X[..., 0, :])
    return state, float((Y * S).mean())


def _msipddp_warm_state(problem, solution, X, dtype):
    """An MSIPDDPSolverState rebuilt from a recorded Solution
    (refine.py:129-149), and the mean complementarity; F is recomputed by
    the warm start from X."""
    from cddp_tpu_torch.solvers.msipddp import MSIPDDPSolverState

    stk = PathStacker(problem)
    Y = _restack(solution.dual_trajectories, stk.names, dtype)
    S = _restack(solution.slack_trajectories, stk.names, dtype)
    state = MSIPDDPSolverState(
        k_u=solution.feedforward_gains.to(dtype), K_u=solution.feedback_gains.to(dtype),
        Y=Y, S=S, Lambda=solution.costate_trajectory.to(dtype), F=X[..., 1:, :])
    return state, float((Y * S).mean())


def polish(
    problem: Problem,
    solution: Solution,
    solver: Optional[str] = None,
    options: Optional[CDDPOptions] = None,
    *,
    dtype=torch.float64,
    max_iterations: int = 500,
    tolerance: float = 1e-6,
) -> Solution:
    """Re-solve ``problem`` in ``dtype`` (float64 by default), warm-started
    from ``solution`` (one solve, or a batch-first fleet whose instance i
    starts from ``state_trajectory[i, 0]``), on the solution's device, and
    return the re-certified Solution.

    ``solver`` defaults to ``solution.solver_name``. ``options`` defaults to
    ``CDDPOptions(max_iterations, tolerance, acceptable_tolerance =
    tolerance**2)``, so that the acceptable exit's bar, its square root, is
    the tolerance itself; given ``options``, the keyword arguments are
    ignored and only the warm-start fields are set."""
    from cddp_tpu_torch.solvers import get_solver

    name = solver or solution.solver_name
    if not name:
        raise ValueError("solution carries no solver_name; pass solver='IPDDP' (etc.)")
    solve_fn = get_solver(name)
    if options is None:
        options = CDDPOptions(max_iterations=max_iterations, tolerance=tolerance,
                              acceptable_tolerance=tolerance * tolerance)
    X = solution.state_trajectory.to(dtype)
    U = solution.control_trajectory.to(dtype)
    prob = base.canonicalize_problem_dtype(problem.replace(x0=X[..., 0, :]))

    # Unconverged duals mislead the restart; a fleet dual-warms only when
    # every instance converged.
    warmable = (solution.dual_trajectories is not None
                and solution.feedforward_gains is not None
                and bool(solution.converged_mask().all()))
    kind = name.upper()
    if warmable and kind in ("IPDDP", "MSIPDDP"):
        if kind == "IPDDP":
            state, mu_warm = _ipddp_warm_state(prob, solution, X, options, dtype)
        else:
            state, mu_warm = _msipddp_warm_state(prob, solution, X, dtype)
        # Resume the barrier at the iterate's own complementarity; both warm
        # starts restart at 0.1 mu_initial, hence the 10x.
        mu0 = min(0.1, max(mu_warm, 10.0 * options.tolerance))
        group = options.ipddp if kind == "IPDDP" else options.msipddp
        extra = dict(warmstart_repair=True) if kind == "IPDDP" else {}
        group = dataclasses.replace(
            group, barrier=dataclasses.replace(group.barrier, mu_initial=10.0 * mu0),
            warmstart_staleness_check=False, **extra)
        options = options.replace(warm_start=True, **{kind.lower(): group})
        return solve_fn(prob, options, X0=X, U0=U, state=state)
    return solve_fn(prob, options.replace(warm_start=False), X0=X, U0=U)
