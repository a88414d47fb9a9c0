"""Batched solving and receding-horizon MPC (port of
``cddp_tpu/parallel/batch.py:27-162``).

Batch-first, with no vmap: the solvers take a (B, nx) ``x0`` and solve
every instance in one call, and the MPC controller steps a whole fleet of
controllers, one per instance, in one solve per tick.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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


class MPCState(NamedTuple):
    """A fleet's controller state carried between ticks: the shifted plans
    (the primal warm start; the reference keeps them through
    CDDP::setInitialTrajectory, cddp_core.cpp:126-141)."""

    U_plan: torch.Tensor  # (B, N, nu)
    X_plan: torch.Tensor  # (B, N+1, nx)


def make_mpc_controller(
    problem: Problem,
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    reference_fn: Optional[Callable] = None,
    warm_start_solver_state: bool = False,
):
    """Build (init_fn, step_fn) for warm-started receding-horizon MPC of a
    fleet of B controllers.

    ``init_fn(x0 (B, nx))`` gives zero control plans and state plans that
    hold x0. ``step_fn(state, x_current (B, nx), tick=0) -> (u_apply (B,
    nu), new_state, info)`` solves every controller from its plan with
    row 0 set to ``x_current``, applies each plan's first control and
    shifts the plans one step; ``info`` holds the (B,) cost, iterations and
    status. If ``reference_fn(tick) -> (N, nx)`` is given, each tick tracks
    that reference trajectory, shared by the fleet, and its last row is the
    terminal goal (the MPCC pattern, examples/ipddp_mpcc_rc.py:629-649).

    ``warm_start_solver_state=True`` (IPDDP and MSIPDDP) also threads the
    solver's dual, slack, costate and gain state from tick to tick,
    unshifted, as the JAX package does (the interior-point warm start of
    ipddp_solver.cpp:652-817): ``init_fn`` then returns (MPCState, solver
    state), the latter from one cold solve of one iteration, and each tick
    solves with ``warm_start=True`` from the last tick's state. CLDDP and
    LogDDP refuse it, as the JAX package does.
    """
    from cddp_tpu_torch.solvers import get_solver

    solve_fn = get_solver(solver)
    N, nu, nx = problem.horizon, problem.control_dim, problem.state_dim
    if warm_start_solver_state and solver not in ("IPDDP", "MSIPDDP"):
        raise ValueError(
            "warm_start_solver_state requires IPDDP or MSIPDDP (the solvers "
            f"with dual/slack state pytrees); got {solver!r}. CLDDP/LogDDP "
            "warm start through the primal plan, which the controller "
            "already threads."
        )
    stateful = warm_start_solver_state
    if stateful:
        options = options.replace(warm_start=True)

    def init_fn(x0):
        mpc = MPCState(U_plan=x0.new_zeros(x0.shape[0], N, nu),
                       X_plan=x0[:, None, :].expand(-1, N + 1, nx).clone())
        if not stateful:
            return mpc
        # One cold solve of one iteration gives the solver state's shapes.
        _, st = solve_fn(problem.replace(x0=x0),
                         options.replace(warm_start=False, max_iterations=1),
                         return_state=True)
        return mpc, st

    def step_fn(state, x_current, tick=0):
        mpc, sstate = state if stateful else (state, None)
        p = problem.replace(x0=x_current)
        if reference_fn is not None:
            obj = p.objective
            refs = torch.as_tensor(reference_fn(tick), dtype=obj.Q.dtype, device=obj.Q.device)
            # The last row is the terminal goal too, so that the unscaled Qf
            # term follows the moving reference (the invariant
            # quadratic_objective enforces).
            p = p.replace(objective=obj.replace(reference_states=refs,
                                                reference_state=refs[-1]))
        X0 = mpc.X_plan.clone()
        X0[:, 0] = x_current
        if stateful:
            sol, new_sstate = solve_fn(p, options, X0=X0, U0=mpc.U_plan, state=sstate,
                                       return_state=True)
        else:
            sol = solve_fn(p, options, X0=X0, U0=mpc.U_plan)
        U, X = sol.control_trajectory, sol.state_trajectory
        new_mpc = MPCState(U_plan=torch.cat([U[:, 1:], U[:, -1:]], 1),
                           X_plan=torch.cat([X[:, 1:], X[:, -1:]], 1))
        info = dict(cost=sol.final_objective, iterations=sol.iterations_completed,
                    status=sol.status_code)
        return U[:, 0], ((new_mpc, new_sstate) if stateful else new_mpc), info

    return init_fn, step_fn
