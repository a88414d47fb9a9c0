"""LogDDP — relaxed log-barrier DDP (port of ``cddp_tpu/solvers/logddp.py``).

Path constraints enter the Q-expansions as relaxed log-barrier gradients and
Hessians (logddp_solver.cpp:517-529), the joint feedforward/feedback solve
is one closed-form solve over the stacked right-hand side [Qu | Qux]
(:544-558), acceptance is the (merit, violation) rule against the nominal
point (:666-698), and the barrier coefficient decays on success and grows
x5 on failure, capped at ``mu_initial`` (:264-276). A quirk preserved:
regularization exhaustion in the backward pass counts as *converged*
(status 4, handleBackwardPassRegularizationLimit, :216-222).

The slice the port carries: box path constraints (or none), the quadratic
goal cost, iLQR Hessians, the sequential backward, both line-search modes,
cold starts and warm gains. Batch-first throughout, with a per-instance done mask (the
select semantics of the vmapped ``lax.while_loop``). ``_drive`` is the
plain driver and the plain version of the whole-solve kernel
(``ops/kernels/mega_logddp.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cddp_tpu_torch.constraints.barrier import RelaxedLogBarrier
from cddp_tpu_torch.ops import linalg
from cddp_tpu_torch.ops.kernels import ip_rollout
from cddp_tpu_torch.ops.kernels.riccati import q_expansion, value_update
from cddp_tpu_torch.options import CDDPOptions, line_search_alphas
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers import base


class _BP(NamedTuple):
    k: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx)
    dV: torch.Tensor  # (B, 2)
    inf_du: torch.Tensor  # (B,)
    ok: torch.Tensor  # (B,) bool


class _Trial(NamedTuple):
    success: torch.Tensor
    cost: torch.Tensor
    merit: torch.Tensor
    cv: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    alpha: torch.Tensor


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def validate_options(options: CDDPOptions) -> None:
    """Refuse the LogDDP options outside the ported slice."""
    for name, unported in (
        ("use_ilqr=False (full DDP)", not options.use_ilqr),
        (f"log_barrier.lqr_backend={options.log_barrier.lqr_backend!r}",
         options.log_barrier.lqr_backend != "sequential"),
    ):
        if unported:
            raise NotImplementedError(f"LogDDP {name} is not yet ported to cddp_tpu_torch")


def _barrier(options, mu) -> RelaxedLogBarrier:
    return RelaxedLogBarrier(barrier_coeff=mu,
                             relaxation_delta=options.log_barrier.relaxed_log_barrier_delta)


def _merit_and_violation(problem, barrier: RelaxedLogBarrier, X, U):
    """Barrier cost and l1 positive-part violation over the trajectory,
    (B,) each (resetFilter / forward-pass bookkeeping,
    logddp_solver.cpp:335-361, 652-663). ``barrier`` holds mu (B,)."""
    x, Bsz, N = X[:, :-1], X.shape[0], U.shape[1]
    step = RelaxedLogBarrier(barrier.barrier_coeff[:, None], barrier.relaxation_delta)
    bc = X.new_zeros(Bsz, N)
    viol = X.new_zeros(Bsz, N)
    for _, c in problem.sorted_constraints():
        bc = bc + step.evaluate(c, x, U)
        viol = viol + torch.clamp(c.evaluate(x, U) - c.upper_bound(), min=0.0).sum(-1)
    return bc.sum(-1), viol.sum(-1)


def _backward_pass(problem, options, barrier: RelaxedLogBarrier, X, U, reg) -> _BP:
    """Riccati recursion with the barrier terms folded into the
    Q-expansions (logddp_solver.cpp:365-612), iLQR, sequential, every
    instance at its own regularization ``reg`` (B,)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    Bsz = X.shape[0]
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    x = X[:, :-1]
    step = RelaxedLogBarrier(barrier.barrier_coeff[:, None], barrier.relaxation_delta)
    bx, bu = X.new_zeros(Bsz, N, nx), X.new_zeros(Bsz, N, nu)
    bxx, buu, bux = (X.new_zeros(Bsz, N, nx, nx), X.new_zeros(Bsz, N, nu, nu),
                     X.new_zeros(Bsz, N, nu, nx))
    for _, c in problem.sorted_constraints():
        gx, gu = step.gradients(c, x, U)
        hxx, huu, hux = step.hessians(c, x, U)
        bx, bu = bx + gx, bu + gu
        bxx, buu, bux = bxx + hxx, buu + huu, bux + hux

    Vx = problem.objective.terminal_cost_gradient(X[:, -1])
    Vxx = _sym(problem.objective.terminal_cost_hessian(X[:, -1]))
    eye_u = torch.eye(nu, dtype=X.dtype, device=X.device)
    ks, Ks = [None] * N, [None] * N
    dV = X.new_zeros(Bsz, 2)
    qerr = X.new_zeros(Bsz)
    ok = torch.ones(Bsz, dtype=torch.bool, device=X.device)
    for t in reversed(range(N)):
        Qx, Qu, Qxx, Qux, Quu = q_expansion(
            A[:, t], Bm[:, t], lx[:, t], lu[:, t], lxx[:, t], luu[:, t], lux[:, t],
            Vx, Vxx)
        Qx, Qu = Qx + bx[:, t], Qu + bu[:, t]
        Qxx, Qux, Quu = Qxx + bxx[:, t], Qux + bux[:, t], Quu + buu[:, t]
        # Joint [k | K] solve (logddp_solver.cpp:544-558).
        kK, pd_ok = linalg.solve_and_check(
            _sym(Quu + reg[:, None, None] * eye_u), torch.cat([Qu[..., None], Qux], -1))
        ks[t], Ks[t] = -kK[..., 0], -kK[..., 1:]
        dV_t, Vx, Vxx = value_update(Qx, Qu, Qxx, Qux, Quu, ks[t], Ks[t])
        dV = dV + dV_t
        qerr = torch.maximum(qerr, Qu.abs().amax(-1))
        ok = ok & pd_ok
    return _BP(k=torch.stack(ks, 1), K=torch.stack(Ks, 1), dV=dV, inf_du=qerr, ok=ok)


def _forward_pass(problem, options, barrier, X, U, k, K, dV, merit_old, cv_old,
                  alpha: float) -> _Trial:
    """Rollout and the (merit, violation) acceptance (logddp_solver.cpp:616-704)."""
    dt = problem.timestep
    x = problem.x0
    ok = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    xs, us = [x], []
    for t in range(problem.horizon):
        u = U[:, t] + alpha * k[:, t] + (K[:, t] @ (x - X[:, t])[..., None])[..., 0]
        x = problem.model.discrete_dynamics(x, u, t * dt, dt)
        ok = ok & x.isfinite().all(-1) & u.isfinite().all(-1)
        xs.append(x)
        us.append(u)
    X_new, U_new = torch.stack(xs, 1), torch.stack(us, 1)
    cost = problem.objective.evaluate(X_new, U_new)
    bc, cv = _merit_and_violation(problem, barrier, X_new, U_new)
    merit = cost + bc

    # Filter acceptance against the nominal point (logddp_solver.cpp:666-698).
    expected = alpha * dV[:, 0]
    fo = options.filter
    keep = 1.0 - fo.violation_acceptance_threshold
    br1 = cv > fo.max_violation_threshold
    acc1 = cv < keep * cv_old
    br2 = (torch.maximum(cv, cv_old) < fo.min_violation_for_armijo_check) & (expected < 0)
    acc2 = merit < merit_old + fo.armijo_constant * expected
    acc3 = (merit < merit_old - fo.merit_acceptance_threshold * cv_old) | (cv < keep * cv_old)
    accept = torch.where(br1, acc1, torch.where(br2, acc2, acc3))
    return _Trial(success=ok & accept, cost=cost, merit=merit, cv=cv, X=X_new, U=U_new,
                  alpha=torch.full_like(cost, alpha))


def _line_search(problem, options, barrier, X, U, bp, merit, cv, search):
    """The alpha ladder for the instances in ``search``: the first success
    in ladder order, or with ``enable_parallel`` the best merit among the
    successes. Returns (selected trial, any success)."""
    trials, sel = [], None
    found = torch.zeros_like(search)
    for a in line_search_alphas(options.line_search):
        if not options.enable_parallel and not bool((search & ~found).any()):
            break
        r = _forward_pass(problem, options, barrier, X, U, bp.k, bp.K, bp.dV, merit, cv, a)
        if options.enable_parallel:
            trials.append(r)
        else:
            sel = r if sel is None else base.select_instances(r.success & ~found, r, sel)
        found = found | r.success
    if options.enable_parallel:
        pick = base.select_forward_result(torch.stack([r.success for r in trials], -1),
                                          torch.stack([r.merit for r in trials], -1), True)
        sel = trials[0]
        for i, r in enumerate(trials[1:], 1):
            sel = base.select_instances(pick.index == i, r, sel)
    return sel, found


def _drive(problem: Problem, options: CDDPOptions, X, U, k0, K0) -> Solution:
    """The LogDDP iteration driver (logddp.py:244-470) from a batch whose X
    is the open-loop rollout of U from x0, as ``solve`` builds it (the JAX
    driver re-rolls X itself; here the rollout is the caller's, so that it
    can be the open-loop rollout kernel)."""
    N = problem.horizon
    Bsz, dtype, device = X.shape[0], X.dtype, X.device
    lb = options.log_barrier
    mu = torch.full((Bsz,), lb.barrier.mu_initial, dtype=dtype, device=device)
    cost = problem.objective.evaluate(X, U)
    bc0, cv = _merit_and_violation(problem, _barrier(options, mu), X, U)
    merit = cost + bc0
    k, K = k0, K0
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
        barrier = _barrier(options, mu)

        # preIterationSetup (logddp_solver.cpp:209-214): the nominal merit and
        # violation under the current barrier coefficient.
        bc_old, cv_old = _merit_and_violation(problem, barrier, X, U)
        merit = torch.where(active, cost + bc_old, merit)
        cv = torch.where(active, cv_old, cv)

        # Backward pass with regularization retry (logddp.py:296-319).
        pend = active.clone()
        bp, bp_limit = None, torch.zeros_like(active)
        while bool(pend.any()):
            trial = _backward_pass(problem, options, barrier, X, U, reg)
            bp = trial if bp is None else base.select_instances(pend, trial, bp)
            reg_next = torch.where(trial.ok, reg, base.increase_regularization(reg, options))
            limit = ~trial.ok & base.regularization_limit_reached(reg_next, options)
            reg = torch.where(pend, reg_next, reg)
            bp_limit = torch.where(pend, limit, bp_limit)
            pend = pend & ~(trial.ok | limit)
        k, K = base.where_instances(active, bp.k, k), base.where_instances(active, bp.K, K)
        inf_du = torch.where(active, bp.inf_du, inf_du)

        # Regularization exhaustion counts as converged (:216-222).
        fail_bp = active & bp_limit
        status = torch.where(fail_bp, Status.REGULARIZATION_LIMIT_CONVERGED, status)
        search = active & ~bp_limit
        done = done | fail_bp
        if not bool(search.any()):
            continue

        r, found = _line_search(problem, options, barrier, X, U, bp, merit, cv, search)
        ok = search & found
        dJ, dL = cost - r.cost, merit - r.merit
        X, U = base.where_instances(ok, r.X, X), base.where_instances(ok, r.U, U)
        cost = torch.where(ok, r.cost, cost)
        merit = torch.where(ok, r.merit, merit)
        cv = torch.where(ok, r.cv, cv)
        alpha_pr = torch.where(ok, r.alpha, alpha_pr)
        reg_new = torch.where(found, base.decrease_regularization(reg, options),
                              base.increase_regularization(reg, options))
        fp_limit = ~found & base.regularization_limit_reached(reg_new, options)

        # Convergence (logddp_solver.cpp:232-259): metric = max(inf_du, cv).
        metric = torch.maximum(bp.inf_du, cv)
        conv_opt = found & (metric <= options.tolerance)
        atol = options.acceptable_tolerance
        conv_acc = found & (dJ.abs() < atol) & (dL.abs() < atol)
        # Barrier update (postIterationUpdate, :264-276).
        mu_new = torch.where(
            found, torch.clamp(mu * lb.barrier.mu_update_factor, min=lb.barrier.mu_min_value),
            torch.clamp(mu * 5.0, max=lb.barrier.mu_initial))
        st = torch.where(conv_opt, Status.OPTIMAL_SOLUTION_FOUND, torch.where(
            conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND, torch.where(
                fp_limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED, status)))
        reg = torch.where(search, reg_new, reg)
        mu = torch.where(search, mu_new, mu)
        status = torch.where(search, st, status).to(torch.int32)
        done = done | (search & (conv_opt | conv_acc | fp_limit))

    return Solution(
        solver_name="LogDDP",
        status_code=status.to(torch.int32),
        iterations_completed=it,
        final_objective=cost,
        final_step_length=alpha_pr,
        final_regularization=reg,
        time_points=torch.arange(N + 1, dtype=dtype, device=device) * problem.timestep,
        state_trajectory=X,
        control_trajectory=U,
        feedback_gains=K,
        feedforward_gains=k,
        inf_du=inf_du,
        barrier_mu=mu,
        inf_pr=cv,
    )


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[torch.Tensor] = None,
    U0: Optional[torch.Tensor] = None,
    gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Solution:
    """Solve with LogDDP. ``problem.x0`` is (nx,) for one solve or (B, nx)
    for a batch; ``U0`` seeds the controls. The state sequence is always
    re-rolled open-loop from the controls (logddp_solver.cpp:140-151), so
    ``X0`` sets only shapes. With ``options.warm_start``, ``gains`` = (k
    (B, N, nu), K (B, N, nu, nx)) seed the control gains (logddp.py:531-536
    of the JAX package; zeros otherwise)."""
    from cddp_tpu_torch.ops.kernels import mega_logddp

    base.validate_options(options)
    validate_options(options)
    base.require_box_stack(problem, "LogDDP")
    problem = base.canonicalize_problem_dtype(problem)
    _, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    unbatched = problem.x0.dim() == 1
    if unbatched:
        problem = problem.replace(x0=problem.x0[None])
        U = U[None]
        gains = None if gains is None else tuple(g[None] for g in gains)

    whole = mega_logddp.mega_eligible(problem, options)
    if options.solve_engine == "fused" and not whole:
        raise ValueError(
            "solve_engine='fused' requires a problem the whole-solve kernel "
            "takes: a registered model with an explicit integrator, the "
            "quadratic objective, a box-only path stack, iLQR, the sequential "
            "line search and default driver options (see mega_logddp.mega_eligible)"
        )
    X = ip_rollout.open_loop_rollout(problem.model, problem.x0, U, problem.timestep,
                                     kernel=options.backward_engine != "scan")
    if options.warm_start and gains is not None:
        k0, K0 = (g.to(X) for g in gains)
    else:
        k0, K0 = X.new_zeros(X.shape[0], N, nu), X.new_zeros(X.shape[0], N, nu, nx)
    if whole:
        sol = mega_logddp.logddp_solve(problem, options, X, U, k0, K0)
    else:
        sol = _drive(problem, options, X, U, k0, K0)
    return sol.first() if unbatched else sol
