"""CLDDP — control-limited DDP/iLQR (port of ``cddp_tpu/solvers/clddp.py``).

Batch-first throughout: one call solves B instances of one problem
structure. ``_solve`` is the per-pass driver, and the plain version of the
whole-solve kernel: finished instances freeze under a per-instance done
mask, the same select semantics as the vmapped ``lax.while_loop`` of the JAX
driver (mega_clddp.py:29-31). Its backward and forward passes launch the
Riccati and rollout kernels on CUDA tensors (``backward_engine="auto"``) and
run their plain versions on CPU tensors or with ``backward_engine="scan"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cddp_tpu_torch.options import CDDPOptions, line_search_alphas
from cddp_tpu_torch.ops import linalg
from cddp_tpu_torch.ops.boxqp import enum_applies
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.ops.kernels.riccati import (
    KERNEL_SHAPES,
    LEFT_OUT_MODELS,
    q_expansion,
    riccati_backward,
    riccati_backward_plain,
    value_update,
)
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers import base


class BackwardPassResult(NamedTuple):
    k: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx)
    dV: torch.Tensor  # (B, 2)
    inf_du: torch.Tensor  # (B,)
    ok: torch.Tensor  # (B,) bool


def _use_kernels(problem: Problem, options: CDDPOptions) -> bool:
    """Whether the backward pass launches the Riccati kernel: a problem of
    a shape it is instantiated for, whatever its model (the kernel reads A
    and B, and the JAX op gates on shape alone, riccati.py:491-497), but a
    registered model of ``LEFT_OUT_MODELS``."""
    entry = rollout_ops.model_entry(problem.model)
    return (options.backward_engine != "scan"
            and (problem.state_dim, problem.control_dim) in KERNEL_SHAPES
            and (entry is None or entry.cuda_name not in LEFT_OUT_MODELS))


def _backward_pass(problem: Problem, options: CDDPOptions, X, U, reg
                   ) -> BackwardPassResult:
    """Backward Riccati recursion (clddp_solver.cpp:96-203) for every
    instance at its own regularization ``reg`` (B,)."""
    nx, N = problem.state_dim, problem.horizon
    cc = problem.get_constraint("ControlConstraint")
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    Vx = problem.objective.terminal_cost_gradient(X[:, -1])
    Vxx = problem.objective.terminal_cost_hessian(X[:, -1])

    if cc is None:
        return _backward_unconstrained(problem, options, A, Bm, lx, lu, lxx,
                                       luu, lux, Vx, Vxx, reg)
    if not enum_applies(options.box_qp, problem.control_dim):
        raise NotImplementedError(
            "only the enumerated BoxQP is ported (box_qp.method 'enum', or "
            "'auto' with nu <= enum_max_dim)"
        )
    backward = (riccati_backward if _use_kernels(problem, options)
                else riccati_backward_plain)
    ks, Ks, dV, qerr, nvx, ok = backward(
        A, Bm, lx, lu, lxx, luu, lux, cc.lower - U, cc.upper - U, Vx, Vxx, reg
    )
    scaling = base.kkt_scaling(nvx + Vx.abs().sum(-1), N, nx, options)
    return BackwardPassResult(k=ks, K=Ks, dV=dV, inf_du=qerr / scaling, ok=ok)


def _backward_unconstrained(problem, options, A, Bm, lx, lu, lxx, luu, lux,
                            Vx, Vxx, reg) -> BackwardPassResult:
    """Without a control box: PD check by Sylvester minors, then the
    closed-form gain solve (clddp_solver.cpp:133-139)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    ks, Ks = [None] * N, [None] * N
    dV = A.new_zeros(A.shape[0], 2)
    norm_Vx = Vx.abs().sum(-1)
    qerr = A.new_zeros(A.shape[0])
    ok = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    for t in reversed(range(N)):
        Qx, Qu, Qxx, Qux, Quu = q_expansion(
            A[:, t], Bm[:, t], lx[:, t], lu[:, t], lxx[:, t], luu[:, t],
            lux[:, t], Vx, Vxx)
        kK, pd_ok = linalg.solve_and_check(
            Quu + reg[:, None, None] * eye_u, torch.cat([Qu[..., None], Qux], -1)
        )
        ks[t], Ks[t] = -kK[..., 0], -kK[..., 1:]
        dV_t, Vx, Vxx = value_update(Qx, Qu, Qxx, Qux, Quu, ks[t], Ks[t])
        dV = dV + dV_t
        norm_Vx = norm_Vx + Vx.abs().sum(-1)
        qerr = torch.maximum(qerr, Qu.abs().amax(-1))
        ok = ok & pd_ok
    scaling = base.kkt_scaling(norm_Vx, N, nx, options)
    return BackwardPassResult(k=torch.stack(ks, 1), K=torch.stack(Ks, 1),
                              dV=dV, inf_du=qerr / scaling, ok=ok)


def _forward_pass(problem: Problem, options: CDDPOptions, consts, X, U, k, K,
                  dV, cost, alpha):
    """Closed-loop rollout at per-instance step ``alpha`` (B,) with the
    Armijo-ratio acceptance (clddp_solver.cpp:217-262). ``consts`` is the
    kernels' view of the problem, or None for the plain scan."""
    if consts is not None:
        X_tail, U_new, J = rollout_ops.forward_rollout(
            consts, X[:, :-1], U, k, K, X[:, 0], alpha)
    else:
        cc = problem.get_constraint("ControlConstraint")
        dt = problem.timestep
        x = X[:, 0]
        J = X.new_zeros(X.shape[0])
        xs, us = [], []
        for t in range(problem.horizon):
            u = U[:, t] + alpha[:, None] * k[:, t] + (
                K[:, t] @ (x - X[:, t])[..., None])[..., 0]
            if cc is not None:
                u = cc.clamp(u)
            J = J + problem.objective.running_cost(x, u, t)
            x = problem.model.discrete_dynamics(x, u, t * dt, dt)
            xs.append(x)
            us.append(u)
        J = J + problem.objective.terminal_cost(x)
        X_tail, U_new = torch.stack(xs, 1), torch.stack(us, 1)
    X_new = torch.cat([X[:, :1], X_tail], dim=1)
    dJ = cost - J
    expected = -alpha * (dV[:, 0] + 0.5 * alpha * dV[:, 1])
    ratio = torch.where(expected > 0.0, dJ / expected, torch.sign(dJ))
    return ratio > options.filter.armijo_constant, J, X_new, U_new


def _solve(problem: Problem, options: CDDPOptions, X0, U0, k0, K0) -> Solution:
    """Per-pass driver over a batch (cddp_solver_base.cpp:29-186)."""
    dtype, device = X0.dtype, X0.device
    Bsz = X0.shape[0]
    alphas = line_search_alphas(options.line_search)
    consts = (rollout_ops.lane_consts(problem)
              if options.backward_engine != "scan" else None)
    if consts is not None and not consts.rollout:
        consts = None

    X, U, k, K = X0, U0, k0, K0
    cost = base.compute_cost(problem, X, U)
    reg = torch.full((Bsz,), options.regularization.initial_value, dtype=dtype,
                     device=device)
    inf_du = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
    alpha_pr = torch.ones(Bsz, dtype=dtype, device=device)
    it = torch.zeros(Bsz, dtype=torch.int32, device=device)
    status = torch.full((Bsz,), Status.MAX_ITERATIONS_REACHED, dtype=torch.int32,
                        device=device)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)

    for _ in range(options.max_iterations):
        if bool(done.all()):
            break
        active = ~done
        it = torch.where(active, it + 1, it)

        # Backward pass with regularization retry (cddp_solver_base.cpp:94-111).
        bp_done = done.clone()
        bp_limit = torch.zeros_like(done)
        bp = None
        while not bool(bp_done.all()):
            pend = ~bp_done
            trial = _backward_pass(problem, options, X, U, reg)
            bp = trial if bp is None else BackwardPassResult(
                *(base.where_instances(pend, a, b) for a, b in zip(trial, bp)))
            reg_next = torch.where(trial.ok, reg,
                                   base.increase_regularization(reg, options))
            limit = ~trial.ok & base.regularization_limit_reached(reg_next, options)
            reg = torch.where(pend, reg_next, reg)
            bp_limit = torch.where(pend, limit, bp_limit)
            bp_done = bp_done | trial.ok | limit

        # Early convergence on inf_du (clddp_solver.cpp:206-213).
        early = bp.inf_du < options.tolerance
        participate = active & ~bp_limit & ~early
        J_new = torch.full_like(cost, float("inf"))
        X_sel, U_sel = X, U
        alpha_new = torch.ones_like(cost)
        any_success = torch.zeros_like(done)
        for a in alphas:
            if not options.enable_parallel and not bool(
                    (participate & ~any_success).any()):
                break
            alpha = torch.full_like(cost, a)
            ok, J, Xn, Un = _forward_pass(problem, options, consts, X, U, bp.k,
                                          bp.K, bp.dV, cost, alpha)
            if options.enable_parallel:
                # Best merit among successes; the first minimum wins ties
                # (select_forward_result's argmin).
                take = ok & (J < J_new)
            else:
                # First success in ladder order (cddp_solver_base.cpp:256-263).
                take = ok & ~any_success
            J_new = torch.where(take, J, J_new)
            X_sel = base.where_instances(take, Xn, X_sel)
            U_sel = base.where_instances(take, Un, U_sel)
            alpha_new = torch.where(take, alpha, alpha_new)
            any_success = any_success | ok
        fp_ok = any_success & ~early

        dJ = cost - J_new
        reg_new = torch.where(
            fp_ok, base.decrease_regularization(reg, options),
            torch.where(early, reg, base.increase_regularization(reg, options)),
        )
        fp_limit = ~fp_ok & ~early & base.regularization_limit_reached(reg_new, options)
        conv_acc = fp_ok & (dJ > 0.0) & (dJ < options.acceptable_tolerance)
        st = torch.where(
            early, Status.OPTIMAL_SOLUTION_FOUND,
            torch.where(conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND,
                        torch.where(fp_limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED,
                                    status)),
        ).to(torch.int32)
        step_done = early | conv_acc | fp_limit

        # Backward-pass regularization exhausted -> not converged
        # (cddp_solver_base.cpp:200-204); otherwise the line-search outcome.
        ok_upd = active & ~bp_limit
        fail = active & bp_limit
        take = ok_upd & fp_ok
        X = base.where_instances(take, X_sel, X)
        U = base.where_instances(take, U_sel, U)
        cost = torch.where(take, J_new, cost)
        alpha_pr = torch.where(take, alpha_new, alpha_pr)
        k = base.where_instances(active, bp.k, k)
        K = base.where_instances(active, bp.K, K)
        inf_du = torch.where(active, bp.inf_du, inf_du)
        reg = torch.where(ok_upd, reg_new, reg)
        status = torch.where(
            fail, torch.full_like(status, Status.REGULARIZATION_LIMIT_NOT_CONVERGED),
            torch.where(ok_upd, st, status))
        done = done | fail | (ok_upd & step_done)

    return Solution(
        solver_name="CLDDP",
        status_code=status,
        iterations_completed=it,
        final_objective=cost,
        final_step_length=alpha_pr,
        final_regularization=reg,
        time_points=torch.arange(problem.horizon + 1, dtype=dtype,
                                 device=device) * problem.timestep,
        state_trajectory=X,
        control_trajectory=U,
        feedback_gains=K,
        feedforward_gains=k,
        inf_du=inf_du,
    )


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[torch.Tensor] = None,
    U0: Optional[torch.Tensor] = None,
    gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Solution:
    """Solve with CLDDP. ``problem.x0`` is (nx,) for one solve or (B, nx)
    for a batch; ``X0``/``U0`` seed the nominal trajectories and
    ``gains=(k, K)`` warm-starts the gains when ``options.warm_start``."""
    from cddp_tpu_torch.ops.kernels import mega_clddp

    base.validate_options(options)
    problem = base.canonicalize_problem_dtype(problem)
    X, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    if options.warm_start and gains is not None:
        k0, K0 = (g.to(X.dtype) for g in gains)
    else:
        k0 = X.new_zeros(X.shape[:-2] + (N, nu))
        K0 = X.new_zeros(X.shape[:-2] + (N, nu, nx))

    unbatched = problem.x0.dim() == 1
    if unbatched:
        problem = problem.replace(x0=problem.x0[None])
        X, U, k0, K0 = X[None], U[None], k0[None], K0[None]

    whole = mega_clddp.mega_eligible(problem, options)
    if options.solve_engine == "fused" and not whole:
        raise ValueError(
            "solve_engine='fused' requires a problem the whole-solve kernel "
            "takes: a registered model with an explicit integrator, the "
            "quadratic objective, a ControlConstraint with the enum BoxQP "
            "and default driver options (see mega_clddp.mega_eligible)"
        )
    if whole:
        sol = mega_clddp.clddp_solve(problem, options, X, U, k0, K0)
    else:
        sol = _solve(problem, options, X, U, k0, K0)
    return sol.first() if unbatched else sol
