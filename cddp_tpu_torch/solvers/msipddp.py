"""MSIPDDP — multiple-shooting interior-point DDP (port of
``cddp_tpu/solvers/msipddp.py``).

Defect constraints d_t = f(x_t, u_t) - x_{t+1} with explicit costates
Lambda. What differs from IPDDP (msipddp_solver.cpp):

- defects enter the backward pass through the drift V_x + V_xx d
  (:1146-1147, 1283-1284), and the y/s ratios are not clipped (:1330-1345);
- costate gains k_lambda = -lambda + V_x + V_xx d, K_lambda = V_xx
  (:1192-1194, 1391-1393), so the costates are live solver state;
- the forward pass closes gaps only at segment boundaries
  ((t+1) % segment_length == 0) with the "nonlinear", "hybrid" or "dense"
  rollout (:1475-1512), and searches a separate dual step size over the
  alpha ladder (:1618-1676), first feasible;
- the filter violation adds the l1 defect norm (:1694-1700), the filter
  acceptance reads the best-violation entry (:789-827), and a failed line
  search tries filter restoration before regularization (:815-844);
- inf_du is IPOPT sd-scaled: sd = max(100, (|y|_1+|s|_1)/(m+n))/100
  (:1886-1931); the barrier is updated every non-terminal iteration.

The slice the port carries: box path constraints (or none: the Armijo
branch with mu0 = 1e-8), the quadratic goal cost, iLQR, the sequential
backward, both line-search modes, the three barrier strategies and the
three rollouts, cold starts and warm starts from an
``MSIPDDPSolverState``. Batch-first throughout, with a per-instance
done mask. ``_drive`` is the plain driver and the plain version of the
whole-solve kernel (``ops/kernels/mega_msipddp.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.ops import linalg
from cddp_tpu_torch.ops.kernels import ip_rollout
from cddp_tpu_torch.ops.linalg import true_div
from cddp_tpu_torch.options import BarrierStrategy, CDDPOptions, line_search_alphas
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers import base
from cddp_tpu_torch.solvers import filter as flt

ROLLOUT_TYPES = ("nonlinear", "hybrid", "dense")
FILTER_SLOTS = 7  # msipddp.py:714


class MSIPDDPSolverState(NamedTuple):
    """The warm-start checkpoint (msipddp.py:56-64 of the JAX package),
    batch-first."""

    k_u: torch.Tensor  # (B, N, nu)
    K_u: torch.Tensor  # (B, N, nu, nx)
    Y: torch.Tensor  # (B, N, m)
    S: torch.Tensor  # (B, N, m)
    Lambda: torch.Tensor  # (B, N, nx) costates
    F: torch.Tensor  # (B, N, nx) shooting-node dynamics values


class _BP(NamedTuple):
    k_u: torch.Tensor  # (B, N, nu)
    K_u: torch.Tensor  # (B, N, nu, nx)
    k_y: torch.Tensor  # (B, N, m)
    K_y: torch.Tensor  # (B, N, m, nx)
    k_s: torch.Tensor
    K_s: torch.Tensor
    k_lambda: torch.Tensor  # (B, N, nx)
    K_lambda: torch.Tensor  # (B, N, nx, nx)
    dV: torch.Tensor  # (B, 2)
    inf_pr: torch.Tensor  # (B,)
    inf_du: torch.Tensor
    inf_comp: torch.Tensor
    step_norm: torch.Tensor
    ok: torch.Tensor  # (B,) bool


class _Trial(NamedTuple):
    success: torch.Tensor
    cost: torch.Tensor
    merit: torch.Tensor
    cv: torch.Tensor
    inf_pr: torch.Tensor
    inf_comp: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    Y: torch.Tensor
    S: torch.Tensor
    G: torch.Tensor
    F: torch.Tensor
    Lambda: torch.Tensor
    alpha_pr: torch.Tensor
    alpha_du: torch.Tensor


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _maxabs(x):
    """max |x| over every axis but the batch; 0 for an empty stack."""
    if x[0].numel() == 0:
        return x.new_zeros(x.shape[0])
    return x.abs().flatten(1).amax(-1)


def _l1(x):
    return x.abs().flatten(1).sum(-1)


def validate_options(options: CDDPOptions) -> None:
    """Refuse the MSIPDDP options outside the ported slice."""
    ms = options.msipddp
    if ms.rollout_type not in ROLLOUT_TYPES:
        raise ValueError(f"options.msipddp.rollout_type must be one of {ROLLOUT_TYPES}, "
                         f"got {ms.rollout_type!r}")
    for name, unported in (
        ("use_ilqr=False (full DDP)", not options.use_ilqr),
        (f"msipddp.lqr_backend={ms.lqr_backend!r}", ms.lqr_backend != "sequential"),
    ):
        if unported:
            raise NotImplementedError(f"MSIPDDP {name} is not yet ported to cddp_tpu_torch")


def _scaled_inf_du(inf_du, Y, S, control_dim: int, has_path: bool):
    """IPOPT sd scaling (msipddp_solver.cpp:1886-1931)."""
    if not has_path:
        return inf_du
    n = Y[0].numel() + control_dim * Y.shape[1]
    sd = true_div(torch.clamp(true_div(_l1(Y) + _l1(S), n), min=100.0), 100.0)
    return inf_du / sd


def _reset_filter_quantities(stk, X, Y, S, G, F, mu, cost):
    """resetBarrierFilter (msipddp_solver.cpp:719-781): (merit, inf_pr with
    the defects, inf_comp, l1 filter violation with the defects)."""
    defects = F - X[:, 1:]
    if not stk:
        z = cost.new_zeros(cost.shape)
        return cost, z, z, z
    r_p = G + S
    merit = cost - mu * torch.log(S).sum((1, 2))
    cv = _l1(r_p) + _l1(defects)
    inf_comp = _maxabs(Y * S - mu[:, None, None])
    return merit, torch.maximum(_maxabs(r_p), _maxabs(defects)), inf_comp, cv


def _backward_pass(problem, stk, st, reg) -> _BP:
    """Defect-aware condensed Riccati recursion (msipddp_solver.cpp:1086-1440),
    iLQR, sequential, every instance at its own ``reg`` (B,). Unlike IPDDP
    the y/s ratios are not clipped (:1330-1345)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    X, U, Y, S, G = st["X"], st["U"], st["Y"], st["S"], st["G"]
    lam_all, mu = st["Lambda"], st["mu"]
    Bsz, m = X.shape[0], Y.shape[-1]
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    if stk:
        # Box stacks only (require_box_stack): constant rows, read once.
        Gx, Gu = stk.jacobian_rows(nx, nu)
    else:
        Gx, Gu = X.new_zeros(0, nx), X.new_zeros(0, nu)
    defects = st["F"] - X[:, 1:]
    Vx = problem.objective.terminal_cost_gradient(X[:, -1])
    Vxx = _sym(problem.objective.terminal_cost_hessian(X[:, -1]))
    eye_u = torch.eye(nu, dtype=X.dtype, device=X.device)
    mu_ = mu[:, None]
    outs = [[None] * N for _ in range(8)]
    dV = X.new_zeros(Bsz, 2)
    z = X.new_zeros(Bsz)
    inf_du, inf_pr, inf_comp, inf_def, step = z, z, z, z, z
    ok = torch.ones(Bsz, dtype=torch.bool, device=X.device)
    for t in reversed(range(N)):
        y, s, g, d, lam = Y[:, t], S[:, t], G[:, t], defects[:, t], lam_all[:, t]
        A_t, B_t = A[:, t], Bm[:, t]
        drift = Vx + _mv(Vxx, d)
        Qx = lx[:, t] + y @ Gx + _mv(A_t.mT, drift)
        Qu = lu[:, t] + y @ Gu + _mv(B_t.mT, drift)
        Qxx = lxx[:, t] + A_t.mT @ Vxx @ A_t
        Qux = lux[:, t] + B_t.mT @ Vxx @ A_t
        Quu = luu[:, t] + B_t.mT @ Vxx @ B_t

        ys_inv = y / s  # unclipped (msipddp_solver.cpp:1330-1334)
        pr = g + s
        comp = y * s - mu_
        rhat = y * pr - comp
        s_inv_rhat = rhat / s
        GuSGu = Gu.mT @ (ys_inv[..., None] * Gu)
        GuSGx = Gu.mT @ (ys_inv[..., None] * Gx)

        rhs_k = Qu + s_inv_rhat @ Gu
        rhs_K = Qux + GuSGx
        kK, pd_ok = linalg.solve_and_check(
            _sym(Quu) + GuSGu + reg[:, None, None] * eye_u,
            torch.cat([rhs_k[..., None], rhs_K], -1))
        k_u, K_u = -kK[..., 0], -kK[..., 1:]

        temp = k_u @ Gu.mT
        GuK = Gu @ K_u
        outs[0][t], outs[1][t] = k_u, K_u
        outs[2][t] = (rhat + y * temp) / s
        outs[3][t] = ys_inv[..., None] * (Gx + GuK)
        outs[4][t] = -pr - temp
        outs[5][t] = -Gx - GuK
        outs[6][t] = -lam + drift
        outs[7][t] = _sym(Vxx)

        Qx_c = Qx + s_inv_rhat @ Gx
        Qxx_c = Qxx + Gx.mT @ (ys_inv[..., None] * Gx)
        Quu_c = Quu + GuSGu
        dV = dV + torch.stack([(k_u * rhs_k).sum(-1),
                               (_mv(Quu_c.mT, 0.5 * k_u) * k_u).sum(-1)], -1)
        Vx = (Qx_c + _mv(K_u.mT, rhs_k) + _mv(rhs_K.mT, k_u)
              + _mv(K_u.mT @ Quu_c, k_u))
        Vxx = _sym(Qxx_c + K_u.mT @ rhs_K + rhs_K.mT @ K_u + K_u.mT @ Quu_c @ K_u)

        inf_du = torch.maximum(inf_du, rhs_k.abs().amax(-1))
        if m:
            inf_pr = torch.maximum(inf_pr, pr.abs().amax(-1))
            inf_comp = torch.maximum(inf_comp, comp.abs().amax(-1))
        inf_def = torch.maximum(inf_def, d.abs().amax(-1))
        step = torch.maximum(step, k_u.abs().amax(-1))
        ok = ok & pd_ok
    k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam = (torch.stack(o, 1) for o in outs)
    return _BP(k_u=k_u, K_u=K_u, k_y=k_y, K_y=K_y, k_s=k_s, K_s=K_s, k_lambda=k_lam,
               K_lambda=K_lam, dV=dV, inf_pr=torch.maximum(inf_pr, inf_def),
               inf_du=inf_du, inf_comp=inf_comp, step_norm=step, ok=ok)


def _is_filter_acceptable(filt, mf, cv, options, expected):
    """MSIPDDPSolver::isFilterAcceptable (msipddp_solver.cpp:789-827): an
    empty filter accepts; a dominated candidate is rejected; otherwise the
    best-violation entry is the reference point (the first minimum wins)."""
    fo = options.filter
    empty = flt.size(filt) == 0
    dominated = flt.candidate_dominated(filt, mf, cv)
    masked = torch.where(filt.valid, filt.violation, torch.full_like(filt.violation, math.inf))
    i_bv = masked.argmin(-1, keepdim=True)
    best_violation = filt.violation.gather(-1, i_bv)[:, 0]
    best_merit = filt.merit.gather(-1, i_bv)[:, 0]

    violation_improvement = cv < best_violation * (1.0 - fo.violation_acceptance_threshold)
    merit_improvement = mf < best_merit - fo.merit_acceptance_threshold * cv
    armijo_branch = (cv < fo.min_violation_for_armijo_check) & (expected < 0)
    armijo_ok = mf < best_merit + fo.armijo_constant * expected
    tiny_ok = (cv < 1e-6) & (mf <= best_merit * (1.0 + 1e-8))
    verdict = torch.where(armijo_branch, armijo_ok,
                          tiny_ok | violation_improvement | merit_improvement)
    return empty | (~dominated & verdict)


def _boundaries(options, N):
    """The gap-closing steps: (t+1) % segment_length == 0 inside the horizon."""
    seg = options.msipddp.segment_length
    return [seg > 1 and (t + 1) % seg == 0 and t + 1 < N for t in range(N)]


def _dual_step(Y, k_y, KydX, tau, alphas):
    """The dual step size: the first alpha_y of the ladder whose whole dual
    trajectory Y + alpha_y k_y + K_y dx passes the fraction-to-boundary test
    (msipddp_solver.cpp:1618-1676), else alphas[0]. Returns (Y_new,
    alpha_du, any feasible)."""
    Y_new, alpha_du = Y, Y.new_full(Y.shape[:1], alphas[0])
    any_y = torch.zeros(Y.shape[0], dtype=torch.bool, device=Y.device)
    for a_y in reversed(alphas):
        Yn = Y + a_y * k_y + KydX
        feas = base.ftb_ok(Yn, Y, tau[..., None]).flatten(1).all(-1)
        Y_new = base.where_instances(feas, Yn, Y_new)
        alpha_du = torch.where(feas, torch.full_like(alpha_du, a_y), alpha_du)
        any_y = any_y | feas
    Y_new = base.where_instances(any_y, Y_new, Y + alphas[0] * k_y + KydX)
    return Y_new, alpha_du, any_y


def _forward_pass(problem, options, stk, st, bp, alpha: float, alphas) -> _Trial:
    """Multiple-shooting rollout with segment gap closing and the separate
    dual step-size ladder (msipddp_solver.cpp:1443-1731)."""
    N, dt = problem.horizon, problem.timestep
    X, U, Y, S, F, Lam, mu = (st["X"], st["U"], st["Y"], st["S"], st["F"], st["Lambda"],
                              st["mu"])
    has_path = bool(stk)
    rollout_type = options.msipddp.rollout_type
    tau = torch.clamp(1.0 - mu, min=options.msipddp.barrier.min_fraction_to_boundary)[:, None]
    if rollout_type == "hybrid":
        A, Bm = base.discrete_jacobians(problem, X, U)
    x = problem.x0
    s_feasible = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    outs = [[] for _ in range(6)]
    for t, boundary in enumerate(_boundaries(options, N)):
        dx = x - X[:, t]
        s_new = S[:, t] + alpha * bp.k_s[:, t] + _mv(bp.K_s[:, t], dx)
        if has_path:
            s_feasible = s_feasible & base.ftb_ok(s_new, S[:, t], tau).all(-1)
        u = U[:, t] + alpha * bp.k_u[:, t] + _mv(bp.K_u[:, t], dx)
        f_new = problem.model.discrete_dynamics(x, u, t * dt, dt)
        x_next = f_new
        if boundary and rollout_type == "nonlinear":
            f_old, xb_next = F[:, t], X[:, t + 1]
            x_next = xb_next + (f_new - f_old) + alpha * (f_old - xb_next)
        elif boundary and rollout_type == "hybrid":
            f_old, xb_next, B_t = F[:, t], X[:, t + 1], Bm[:, t]
            x_next = (xb_next + _mv(A[:, t] + B_t @ bp.K_u[:, t], dx)
                      + alpha * (_mv(B_t, bp.k_u[:, t]) + f_old - xb_next))
        lam_new = Lam[:, t] + alpha * bp.k_lambda[:, t] + _mv(bp.K_lambda[:, t], dx)
        for o, v in zip(outs, (x_next, u, s_new, f_new, lam_new, dx)):
            o.append(v)
        x = x_next
    X_tail, U_new, S_new, F_new, Lam_new, dX = (torch.stack(o, 1) for o in outs)
    X_new = torch.cat([problem.x0[:, None], X_tail], 1)
    finite = X_new.isfinite().flatten(1).all(-1) & U_new.isfinite().flatten(1).all(-1)
    cost = problem.objective.evaluate(X_new, U_new)
    defects = F_new - X_new[:, 1:]
    alpha_t = torch.full_like(cost, alpha)

    if not has_path:
        # Armijo-ratio acceptance (msipddp_solver.cpp:1519-1531).
        dJ = st["cost"] - cost
        expected = -alpha * (bp.dV[:, 0] + 0.5 * alpha * bp.dV[:, 1])
        ratio = torch.where(expected > 0.0, dJ / expected, torch.sign(dJ))
        z = torch.zeros_like(cost)
        return _Trial(success=finite & (ratio > 1e-6), cost=cost, merit=cost, cv=z,
                      inf_pr=_maxabs(defects), inf_comp=z, X=X_new, U=U_new, Y=Y, S=S_new,
                      G=st["G"], F=F_new, Lambda=Lam_new, alpha_pr=alpha_t,
                      alpha_du=torch.ones_like(cost))

    KydX = (bp.K_y @ dX[..., None])[..., 0]
    Y_new, alpha_du, any_y = _dual_step(Y, bp.k_y, KydX, tau, alphas)

    G_new = stk.evaluate_shifted(X_new[:, :-1], U_new)
    merit = cost - mu * torch.log(S_new).sum((1, 2))
    r_p = G_new + S_new
    cv = _l1(r_p) + _l1(defects)
    accept = _is_filter_acceptable(st["filt"], merit, cv, options, alpha * bp.dV[:, 0])
    return _Trial(
        success=s_feasible & any_y & finite & accept, cost=cost, merit=merit, cv=cv,
        inf_pr=torch.maximum(_maxabs(r_p), _maxabs(defects)),
        inf_comp=_maxabs(Y_new * S_new - mu[:, None, None]), X=X_new, U=U_new, Y=Y_new,
        S=S_new, G=G_new, F=F_new, Lambda=Lam_new, alpha_pr=alpha_t, alpha_du=alpha_du)


def _line_search(problem, options, stk, st, bp, search):
    """The alpha ladder for the instances in ``search``: the first success
    in ladder order, or with ``enable_parallel`` the best merit among the
    successes. Returns (selected trial, any success)."""
    alphas = line_search_alphas(options.line_search)
    trials, sel = [], None
    found = torch.zeros_like(search)
    for a in alphas:
        if not options.enable_parallel and not bool((search & ~found).any()):
            break
        r = _forward_pass(problem, options, stk, st, bp, a, alphas)
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


def _update_barrier(problem, options, stk, st, fp_success, upd):
    """updateBarrierParameters (msipddp_solver.cpp:1766-1878) for the
    instances in ``upd``, and resetFilter where mu changed."""
    if not stk:
        return
    bopt = options.msipddp.barrier
    f = bopt.mu_update_factor
    mu = st["mu"]
    sdu = _scaled_inf_du(st["inf_du"], st["Y"], st["S"], problem.control_dim, True)
    metric = torch.maximum(torch.maximum(sdu, st["inf_pr"]), st["inf_comp"])
    c = lambda v: mu.new_tensor(v)  # noqa: E731
    if bopt.strategy == BarrierStrategy.MONOTONIC:
        mu_new = torch.clamp(f * mu, min=bopt.mu_min_value)
        changed = torch.ones_like(upd)
    elif bopt.strategy == BarrierStrategy.IPOPT:
        cand = torch.clamp(torch.minimum(f * mu, mu ** bopt.mu_update_power),
                           min=options.tolerance / 10.0)
        changed = metric <= 10.0 * mu
        mu_new = torch.where(changed, cand, mu)
    else:  # ADAPTIVE
        threshold = torch.where(mu < 1e-5, torch.maximum(metric * 10.0, mu * 100.0),
                                torch.maximum(f * mu, mu * 2.0))
        slow = fp_success & (st["alpha_pr"] > 0) & (metric < 1e-3)
        ratio = metric / mu
        factor = torch.where(ratio < 0.01, c(f * 0.1), torch.where(
            ratio < 0.1, c(f * 0.3), torch.where(ratio < 0.5, c(f * 0.6), c(f))))
        factor = torch.where(mu > 1e-12, factor, c(f))
        minls = torch.minimum(factor * mu, mu ** bopt.mu_update_power)
        cand = torch.where(slow & (mu > options.tolerance), minls,
                           torch.clamp(minls, min=options.tolerance / 100.0))
        changed = (metric <= threshold) | slow
        mu_new = torch.where(changed, cand, mu)

    merit, inf_pr, inf_comp, cv = _reset_filter_quantities(
        stk, st["X"], st["Y"], st["S"], st["G"], st["F"], mu_new, st["cost"])
    reset, _ = flt.accept_entry(flt.clear(st["filt"]), merit, cv)
    apply = upd & changed
    st["mu"] = torch.where(upd, mu_new, mu)
    st["filt"] = flt.select(apply, reset, st["filt"])
    for name, v in (("merit", merit), ("inf_pr", inf_pr), ("inf_comp", inf_comp)):
        st[name] = torch.where(apply, v, st[name])


def _restoration(filt, fail):
    """The failed instances whose filter is restored instead of raising the
    regularization (checkAndPerformFilterRestoration,
    msipddp_solver.cpp:829-862): more than five entries, or an invalid one."""
    return fail & ((flt.size(filt) > 5) | flt.contains_invalid(filt))


def _initialize(problem, options, stk, U0):
    """Cold start (msipddp_solver.cpp:192-265, 644-707): X rolled open-loop
    from U0 and F = X[1:] (no defects), the costates at
    ``costate_var_init_scale``, s = max(scale, -g), y = clip(mu0 / s) into
    [0.01, 100] x ``dual_var_init_scale``, mu0 = ``mu_initial`` (1e-8
    without path constraints). Returns (X, U, Y, S, G, F, Lambda, mu0)."""
    ms = options.msipddp
    x0 = problem.x0
    Bsz, N, nx = x0.shape[0], problem.horizon, problem.state_dim
    X = ip_rollout.open_loop_rollout(problem.model, x0, U0, problem.timestep,
                                     kernel=options.backward_engine != "scan")
    mu0 = torch.full((Bsz,), ms.barrier.mu_initial if stk else 1e-8, dtype=x0.dtype,
                     device=x0.device)
    Lam = torch.full((Bsz, N, nx), ms.costate_var_init_scale, dtype=x0.dtype,
                     device=x0.device)
    if stk:
        G = stk.evaluate_shifted(X[:, :-1], U0)
        Y, S = _cold_dual_slack(G, mu0, ms)
    else:
        G = S = Y = X.new_zeros(Bsz, N, 0)
    return X, U0, Y, S, G, X[:, 1:], Lam, mu0


def interpolated_states(problem):
    """X interpolated linearly from x0 to the objective's reference state
    (the X0 preamble of msipddp.solve, msipddp.py:964-972 of the JAX
    package), (B, N+1, nx)."""
    x0 = problem.x0
    frac = torch.linspace(0.0, 1.0, problem.horizon + 1, dtype=x0.dtype,
                          device=x0.device)[:, None]
    X = x0[:, None] * (1 - frac) + problem.objective.reference_state * frac
    X[:, 0] = x0
    return X


def _shooting_values(problem, X, U):
    """F = f_d(X[:-1], U), the shooting nodes' dynamics values (:597-600)."""
    x0, dt = problem.x0, problem.timestep
    Bsz, N, nx, nu = x0.shape[0], problem.horizon, problem.state_dim, problem.control_dim
    t = (torch.arange(N, dtype=x0.dtype, device=x0.device) * dt).repeat(Bsz)
    return problem.model.discrete_dynamics(X[:, :-1].reshape(-1, nx), U.reshape(-1, nu), t,
                                           dt).reshape(Bsz, N, nx)


def _cold_dual_slack(G, mu0, ms):
    """s = max(scale, -g), y = clip(mu0 / s) into [0.01, 100] x
    ``dual_var_init_scale`` (:644-707)."""
    S = torch.clamp(-G, min=ms.slack_var_init_scale)
    Y = torch.clamp(mu0[:, None, None] / torch.clamp(S, min=1e-12),
                    min=ms.dual_var_init_scale * 0.01, max=ms.dual_var_init_scale * 100.0)
    return Y, S


def defect_seed(problem, options, stk, U0):
    """A seed whose shooting nodes carry defects, for checks of the defect
    drift: X from ``interpolated_states``, F = f_d(X[:-1], U) as the warm
    branch builds F, and duals, slacks, costates and mu0 by the cold rule.
    A cold start re-rolls X, so no entry point starts here. Returns (X, U,
    Y, S, G, F, Lambda, mu0) as ``_initialize`` does."""
    ms = options.msipddp
    x0 = problem.x0
    Bsz, N, nx = x0.shape[0], problem.horizon, problem.state_dim
    X = interpolated_states(problem)
    F = _shooting_values(problem, X, U0)
    mu0 = torch.full((Bsz,), ms.barrier.mu_initial, dtype=x0.dtype, device=x0.device)
    G = stk.evaluate_shifted(X[:, :-1], U0)
    Y, S = _cold_dual_slack(G, mu0, ms)
    Lam = torch.full((Bsz, N, nx), ms.costate_var_init_scale, dtype=x0.dtype,
                     device=x0.device)
    return X, U0, Y, S, G, F, Lam, mu0


def warm_start(problem, options, stk, X0, U0, state: MSIPDDPSolverState):
    """The warm start from a solver state (msipddp.py:592-628): X and U as
    given (true multiple shooting: X may carry defects), F = f_d(X[:-1], U),
    the state's duals, slacks and costates, mu0 = 0.1 mu_initial. Each
    dual and slack that is not positive and finite (or, with
    ``warmstart_staleness_check``, each slack below 10% of its cold value)
    is re-initialised alone by the cold rule. Returns (X, U, Y, S, G, F,
    Lambda, mu0) as ``_initialize`` does; the gains seed is the state's."""
    ms = options.msipddp
    X, U = X0, U0
    mu0 = torch.full_like(X[:, 0, 0], ms.barrier.mu_initial * 0.1)
    F = _shooting_values(problem, X, U)
    Y, S = state.Y, state.S
    if stk:
        G = stk.evaluate_shifted(X[:, :-1], U)
        Y_init, S_init = _cold_dual_slack(G, mu0, ms)
        bad = (Y <= 1e-12) | (S <= 1e-12) | ~torch.isfinite(Y) | ~torch.isfinite(S)
        if ms.warmstart_staleness_check:
            bad = bad | (S < 0.1 * S_init)
        S, Y = torch.where(bad, S_init, S), torch.where(bad, Y_init, Y)
    else:
        G = X.new_zeros(X.shape[0], problem.horizon, 0)
    return X, U, Y, S, G, F, state.Lambda, mu0


def _drive(problem: Problem, options: CDDPOptions, X, U, Y, S, G, F, Lambda, mu0,
           ku0, Ku0):
    """The MSIPDDP iteration driver from a prepared batch (msipddp.py:699-945).
    Returns (Solution, MSIPDDPSolverState)."""
    stk = PathStacker(problem)
    has_path = bool(stk)
    N, nu, nx = problem.horizon, problem.control_dim, problem.state_dim
    Bsz, dtype, device = X.shape[0], X.dtype, X.device
    m = Y.shape[-1]
    tol, atol = options.tolerance, options.acceptable_tolerance

    cost = problem.objective.evaluate(X, U)
    merit, inf_pr, inf_comp, cv = _reset_filter_quantities(stk, X, Y, S, G, F, mu0, cost)
    filt, _ = flt.accept_entry(flt.empty_filter(Bsz, FILTER_SLOTS, dtype, device), merit, cv)
    zeros = X.new_zeros(Bsz)
    st = dict(
        X=X, U=U, Y=Y, S=S, G=G, F=F, Lambda=Lambda, mu=mu0, filt=filt, cost=cost,
        merit=merit, reg=torch.full_like(zeros, options.regularization.initial_value),
        inf_pr=inf_pr, inf_du=zeros, inf_comp=inf_comp, step_norm=zeros,
        alpha_pr=torch.ones_like(zeros), alpha_du=torch.ones_like(zeros),
    )
    k_u, K_u = ku0, Ku0
    it = torch.zeros(Bsz, dtype=torch.int32, device=device)
    status = torch.full((Bsz,), Status.MAX_ITERATIONS_REACHED, dtype=torch.int32,
                        device=device)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)

    def put(mask, **fields):
        for name, v in fields.items():
            st[name] = (flt.select(mask, v, st[name]) if name == "filt"
                        else base.where_instances(mask, v, st[name]))

    for _ in range(options.max_iterations):
        if bool(done.all()):
            break
        active = ~done
        it = torch.where(active, it + 1, it)

        # Backward pass with regularization retry (msipddp.py:763-781).
        pend = active.clone()
        reg = st["reg"]
        bp, bp_limit = None, torch.zeros_like(active)
        while bool(pend.any()):
            trial = _backward_pass(problem, stk, st, reg)
            bp = trial if bp is None else base.select_instances(pend, trial, bp)
            reg_next = torch.where(trial.ok, reg, base.increase_regularization(reg, options))
            limit = ~trial.ok & base.regularization_limit_reached(reg_next, options)
            reg = torch.where(pend, reg_next, reg)
            bp_limit = torch.where(pend, limit, bp_limit)
            pend = pend & ~(trial.ok | limit)
        put(active, reg=reg, inf_pr=bp.inf_pr, inf_du=bp.inf_du, inf_comp=bp.inf_comp,
            step_norm=bp.step_norm)
        k_u = base.where_instances(active, bp.k_u, k_u)
        K_u = base.where_instances(active, bp.K_u, K_u)
        fail_bp = active & bp_limit
        status = torch.where(fail_bp, Status.REGULARIZATION_LIMIT_NOT_CONVERGED, status)
        done = done | fail_bp
        search = active & ~bp_limit
        if not bool(search.any()):
            continue

        r, found = _line_search(problem, options, stk, st, bp, search)
        ok, fail = search & found, search & ~found

        # Commit (msipddp.py:827-884): the trial, the filter entry, the
        # convergence tests, then the barrier update if not converged.
        dJ = st["cost"] - r.cost
        accepted, _ = flt.accept_entry(st["filt"], r.merit, r.cv)
        put(ok, X=r.X, U=r.U, Y=r.Y, S=r.S, G=r.G, F=r.F, Lambda=r.Lambda, cost=r.cost,
            merit=r.merit, inf_pr=r.inf_pr, inf_comp=r.inf_comp, filt=accepted,
            alpha_pr=r.alpha_pr, alpha_du=r.alpha_du,
            reg=base.decrease_regularization(st["reg"], options))
        sdu = _scaled_inf_du(st["inf_du"], st["Y"], st["S"], nu, has_path)
        metric = torch.maximum(torch.maximum(sdu, st["inf_pr"]), st["inf_comp"])
        conv_opt = metric <= tol
        sqrt_atol = math.sqrt(atol)
        conv_acc = (((dJ.abs() < atol) & (it > 10) & (st["inf_pr"] < sqrt_atol)
                     & (st["inf_comp"] < sqrt_atol))
                    | ((it >= 1) & (st["step_norm"] < tol * 10.0) & (st["inf_pr"] < 1e-4)))
        status = torch.where(ok & conv_opt, Status.OPTIMAL_SOLUTION_FOUND, torch.where(
            ok & conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND, status))
        conv = ok & (conv_opt | conv_acc)

        # Failure (msipddp.py:886-908): filter restoration before
        # regularization, then the barrier update unless at the limit.
        restore = _restoration(st["filt"], fail)
        reg_n = torch.where(restore, st["reg"], base.increase_regularization(st["reg"], options))
        limit = fail & ~restore & base.regularization_limit_reached(reg_n, options)
        put(restore, filt=flt.prune_to_best(st["filt"]))
        put(fail, reg=reg_n)
        status = torch.where(limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED,
                             status).to(torch.int32)
        done = done | conv | limit
        _update_barrier(problem, options, stk, st, ok, (ok & ~conv) | (fail & ~limit))

    sol = Solution(
        solver_name="MSIPDDP",
        status_code=status.to(torch.int32),
        iterations_completed=it,
        final_objective=st["cost"],
        final_step_length=st["alpha_pr"],
        final_regularization=st["reg"],
        time_points=torch.arange(N + 1, dtype=dtype, device=device) * problem.timestep,
        state_trajectory=st["X"],
        control_trajectory=st["U"],
        feedback_gains=K_u,
        feedforward_gains=k_u,
        inf_du=st["inf_du"],
        dual_trajectories=stk.split(st["Y"]) if has_path else None,
        slack_trajectories=stk.split(st["S"]) if has_path else None,
        costate_trajectory=st["Lambda"],
        barrier_mu=st["mu"],
        inf_pr=st["inf_pr"],
        inf_comp=st["inf_comp"],
    )
    return sol, MSIPDDPSolverState(k_u=k_u, K_u=K_u, Y=st["Y"], S=st["S"],
                                   Lambda=st["Lambda"], F=st["F"])


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[torch.Tensor] = None,
    U0: Optional[torch.Tensor] = None,
    state: Optional[MSIPDDPSolverState] = None,
    return_state: bool = False,
):
    """Solve with MSIPDDP. ``problem.x0`` is (nx,) for one solve or (B, nx)
    for a batch; ``U0`` seeds the controls. A cold start re-rolls the
    states from the controls (msipddp_solver.cpp:426-455). With
    ``options.warm_start`` and a ``state`` from an earlier solve, the solve
    starts from ``X0`` as given (the interpolation from x0 to the goal
    without one; re-rolled from U0 under ``use_controlled_rollout``),
    with X0[0] = x0, and the state's duals, slacks, costates and gains
    (``warm_start``). With ``return_state`` returns (Solution,
    MSIPDDPSolverState)."""
    from cddp_tpu_torch.ops.kernels import mega_msipddp

    base.validate_options(options)
    validate_options(options)
    base.require_box_stack(problem, "MSIPDDP")
    problem = base.canonicalize_problem_dtype(problem)
    stk = PathStacker(problem)
    warm = state if options.warm_start else None
    _, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    unbatched = problem.x0.dim() == 1
    if unbatched:
        problem = problem.replace(x0=problem.x0[None])
        U = U[None]
        X0 = None if X0 is None else X0[None]
        if warm is not None:
            warm = MSIPDDPSolverState(*(t[None] for t in warm))

    whole = mega_msipddp.mega_eligible(problem, options)
    if options.solve_engine == "fused" and not whole:
        raise ValueError(
            "solve_engine='fused' requires a problem the whole-solve kernel "
            "takes: a registered model with an explicit integrator, the "
            "quadratic objective, a box-only path stack, iLQR, the sequential "
            "line search and default driver options (see mega_msipddp.mega_eligible)"
        )
    if warm is not None:
        if options.msipddp.use_controlled_rollout:
            X = ip_rollout.open_loop_rollout(problem.model, problem.x0, U, problem.timestep,
                                             kernel=options.backward_engine != "scan")
        else:
            X = (interpolated_states(problem) if X0 is None
                 else X0.to(U).clone())
            X[:, 0] = problem.x0
        seeds = warm_start(problem, options, stk, X, U,
                           MSIPDDPSolverState(*(t.to(U) for t in warm)))
        ku0, Ku0 = warm.k_u.to(U), warm.K_u.to(U)
    else:
        seeds = _initialize(problem, options, stk, U)
        ku0 = U.new_zeros(U.shape[0], N, nu)
        Ku0 = U.new_zeros(U.shape[0], N, nu, nx)
    if whole:
        sol, st = mega_msipddp.msipddp_solve(problem, options, *seeds, ku0, Ku0)
    else:
        sol, st = _drive(problem, options, *seeds, ku0, Ku0)
    if unbatched:
        sol, st = sol.first(), MSIPDDPSolverState(*(t[0] for t in st))
    return (sol, st) if return_state else sol
