"""IPDDP — primal-dual interior-point DDP (port of ``cddp_tpu/solvers/ipddp.py``).

Slack formulation g(x, u) + s = 0, s > 0, y > 0 (ipddp_solver.cpp). The
slice the port carries: path constraints of every type of
``constraints/path.py``, the quadratic goal cost, no terminal constraints,
iLQR Hessians, the sequential condensed backward, both line-search modes,
both barrier strategies, both theta norms, and cold starts. On a curved
stack (a ball, a norm or cone constraint) the "auto" slack second-order
correction and constraint-Hessian fold are traced behind the stall latch
(``stall_detector_update``), as the JAX driver traces them.

Batch-first throughout: one call solves B instances of one problem
structure, and finished instances freeze under a per-instance done mask —
the select semantics of the vmapped ``lax.while_loop`` of the JAX driver.
``_drive`` is the per-pass driver and the plain version of the whole-solve
kernel (``ops/kernels/mega_ipddp.py``). Its backward launches the condensed
backward kernel (``ops/kernels/ipddp_riccati.py``) and its line-search
trials the interior-point forward kernel (``ops/kernels/ip_rollout.py``) on
CUDA tensors; CPU tensors, ``backward_engine="scan"`` and
``ipddp.forward_engine="scan"`` run the plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.options import BarrierStrategy, CDDPOptions, line_search_alphas
from cddp_tpu_torch.ops.kernels import ip_rollout
from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers import base
from cddp_tpu_torch.solvers import filter as flt

# ipddp_solver.cpp:34-37.
SLACK_INTERIOR_OFFSET = 1e-4
EPS_SLACK = ric.EPS_SLACK


class _BP(NamedTuple):
    """Backward-pass products, batch-first."""

    k_u: torch.Tensor  # (B, N, nu)
    K_u: torch.Tensor  # (B, N, nu, nx)
    k_y: torch.Tensor  # (B, N, m)
    K_y: torch.Tensor  # (B, N, m, nx)
    k_s: torch.Tensor
    K_s: torch.Tensor
    k_lambda: torch.Tensor  # (B, N+1, nx)
    K_lambda: torch.Tensor  # (B, N+1, nx, nx)
    dY: torch.Tensor  # (B, N, m)
    dS: torch.Tensor
    dV: torch.Tensor  # (B, 2)
    folded: torch.Tensor  # (B,) bool: the constraint-Hessian fold changed lxx, luu or lux
    inf_pr: torch.Tensor  # (B,)
    inf_du: torch.Tensor
    inf_comp: torch.Tensor
    step_norm: torch.Tensor
    ok: torch.Tensor  # (B,) bool


class _Trial(NamedTuple):
    """One line-search trial, batch-first."""

    success: torch.Tensor
    cost: torch.Tensor
    merit: torch.Tensor
    theta: torch.Tensor
    inf_pr: torch.Tensor
    inf_comp: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    Y: torch.Tensor
    S: torch.Tensor
    G: torch.Tensor
    Lambda: torch.Tensor
    alpha_pr: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def validate_options(options: CDDPOptions) -> None:
    """Refuse the IPDDP options outside the ported slice."""
    ip = options.ipddp
    for name, value, allowed in (
        ("ipddp.forward_engine", ip.forward_engine, ("auto", "scan")),
        ("ipddp.theta_norm", ip.theta_norm, ("l1", "l2")),
    ):
        if value not in allowed:
            raise ValueError(f"options.{name} must be one of {allowed}, got {value!r}")
    for name, unported in (
        ("use_ilqr=False (full DDP)", not options.use_ilqr),
        ("ipddp.lqr_backend='parallel'", ip.lqr_backend != "sequential"),
        ("ipddp.check_state_stationarity", ip.check_state_stationarity),
        ("warm_start (IPDDPSolverState)", options.warm_start),
    ):
        if unported:
            raise NotImplementedError(f"IPDDP {name} is not yet ported to cddp_tpu_torch")


# ---------------------------------------------------------------------------
# shared evaluations (ipddp.py:253-324)
# ---------------------------------------------------------------------------


def _eval_path(stk: PathStacker, X, U):
    """Stacked shifted constraint values over the horizon, (B, N, m)."""
    return stk.evaluate_shifted(X[:, :-1], U)


def _barrier_merit(cost, S, mu):
    """computeBarrierMerit (ipddp_solver.cpp:2851-2881): cost - mu sum log s."""
    return cost - mu * torch.log(torch.maximum(S, S.new_tensor(EPS_SLACK))).sum((1, 2))


def _theta(options, G, S):
    """computeTheta (ipddp_solver.cpp:2778-2849): the l1 (default) or l2
    norm of the primal residuals g + s, maxed with their largest entry."""
    r = (G + S).flatten(1)
    if options.ipddp.theta_norm == "l2":
        theta = torch.sqrt((r * r).sum(-1))
    else:
        theta = r.abs().sum(-1)
    return torch.maximum(theta, r.abs().amax(-1))


def _primal_comp(G, S, Y, mu):
    """computePrimalAndComplementarity (ipddp_solver.cpp:2883-2937):
    inf-norms of g + s and y s - mu."""
    return ((G + S).abs().amax((1, 2)),
            (Y * S - mu[:, None, None]).abs().amax((1, 2)))


def _tau(options, mu):
    return torch.maximum(mu.new_tensor(options.ipddp.barrier.min_fraction_to_boundary),
                         1.0 - mu)


def _max_step_sizes(S, Y, dS, dY, mu, options):
    """Fraction-to-boundary maximum primal and dual steps
    (computeMaxStepSizes, ipddp_solver.cpp:2939-2988)."""
    tau = _tau(options, mu)[:, None, None]
    one = mu.new_ones(mu.shape)

    def shrink(v, dv):
        neg = dv < 0.0
        ratio = torch.where(neg, -tau * v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, float("inf")))
        return torch.minimum(one, ratio.amin((1, 2)))

    return (torch.clamp(shrink(S, dS), 0.0, 1.0), torch.clamp(shrink(Y, dY), 0.0, 1.0))


# ---------------------------------------------------------------------------
# the "auto" slack SOC / constraint-Hessian stall latch (ipddp.py:196-236,
# :558-580)
# ---------------------------------------------------------------------------


def stall_detector_update(mu_prev, mu_new, inf_pr, best_inf_pr, count, armed,
                          tolerance, stall_iterations):
    """One commit's update of the "auto" stall detector. The alpha-pinned
    limit cycle of a curved stack shows as inf_pr staying far from
    tolerance (``far``: above 100x) while the committed steps do not advance
    it: the barrier parameter did not move (``mu_stuck``) or inf_pr did not
    beat the best committed value by 0.1% (``improved``). Such commits are
    counted consecutively while the latch is unarmed; at
    ``stall_iterations`` it arms, for the rest of the solve. Each constant
    is formed in the tensors' type, as the JAX package's weak-typed
    arithmetic forms it (in float32, 1 - 1e-12 is 1). Returns (count,
    armed, best_inf_pr)."""
    mu_stuck = mu_new >= mu_prev * (1.0 - 1e-12)
    far = inf_pr > 100.0 * tolerance
    improved = inf_pr < best_inf_pr * (1.0 - 1e-3)
    stalled = far & (mu_stuck | ~improved) & ~armed
    count = torch.where(stalled, count + 1, torch.zeros_like(count))
    armed = armed | (count >= stall_iterations)
    return count, armed, torch.minimum(best_inf_pr, inf_pr)


def soc_traced(options, stk) -> bool:
    """Whether the slack SOC is traced: always for ``slack_soc=True``,
    never for False, and under "auto" only on a stack with a curved item
    (an affine stack's slack residual is linear: the correction would be
    rounding noise)."""
    v = options.ipddp.slack_soc
    if v == "auto":
        return bool(stk) and stk.has_curved
    return bool(v)


def chess_mode(options, stk) -> str:
    """The constraint-Hessian fold: "off", "static" (explicit True: always
    folded) or "latched" ("auto" on a curved stack: weighted by the stall
    latch, an exact no-op until it arms)."""
    v = options.ipddp.use_constraint_hessians
    if v == "auto":
        return "latched" if (bool(stk) and stk.has_curved) else "off"
    return "static" if v else "off"


# ---------------------------------------------------------------------------
# backward pass
# ---------------------------------------------------------------------------


def _rollout_linear(A, Bm, K, k):
    """rolloutLinearPolicy (ipddp_solver.cpp:368-395) from dx_0 = 0:
    du = k + K dx, dx+ = A dx + B du. Returns dX (B, N+1, nx)."""
    dx = A.new_zeros(A.shape[0], A.shape[-1])
    dX = [dx]
    for t in range(A.shape[1]):
        du = k[:, t] + _mv(K[:, t], dx)
        dx = _mv(A[:, t], dx) + _mv(Bm[:, t], du)
        dX.append(dx)
    return torch.stack(dX, 1)


def fold_terms(stk, X, U, Y, weight):
    """The y-weighted constraint Hessians, times ``weight`` (B,), that fold
    into (lxx, luu, lux) (ipddp.py:596-627): the Lagrangian curvature the
    Gauss-Newton condensation drops. A weight of 0 gives exact zeros and
    keeps a non-finite y's NaN, as the JAX driver's multiply does."""
    Yw = Y * weight[:, None, None]
    return tuple(torch.einsum("btm,btmjk->btjk", Yw, h)
                 for h in stk.hessians(X[:, :-1], U))


def backward_inputs(problem, stk, X, U, Y, S, G, mu, reg, fold=None):
    """The condensed backward's inputs (the ``ipddp_riccati`` signature):
    the Euler linearization, the cost derivatives (plus the ``fold_terms``
    when given), the stack's Jacobians at each step (broadcasts of one
    copy for a box stack) and the terminal value, batch-first."""
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    Gx, Gu = stk.jacobians(X[:, :-1], U)
    if fold is not None:
        lxx, luu, lux = lxx + fold[0], luu + fold[1], lux + fold[2]
    V_x = problem.objective.terminal_cost_gradient(X[:, -1])
    V_xx = ric._sym(problem.objective.terminal_cost_hessian(X[:, -1]))
    return (A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, V_x, V_xx, mu, reg)


def _fold_weight(options, stk, armed):
    """The constraint-Hessian fold's per-instance weight (None: not
    traced): 1 under "static", the armed latch (B,) as 0 or 1 under
    "latched"."""
    mode = chess_mode(options, stk)
    if mode == "off":
        return None
    return torch.ones_like(armed) if mode == "static" else armed


def _backward_condensed(problem, options, stk, X, U, Y, S, G, mu, reg,
                        soc_armed=None) -> _BP:
    """The path-constraint condensed Riccati recursion
    (ipddp_solver.cpp:1355-1568), iLQR, sequential. ``soc_armed`` (B,) is
    the stall latch; None counts as armed, as in the JAX driver."""
    nx, nu, m = problem.state_dim, problem.control_dim, Y.shape[-1]
    armed = (torch.ones_like(mu) if soc_armed is None else soc_armed.to(X.dtype))
    weight = _fold_weight(options, stk, armed)
    fold = None if weight is None else fold_terms(stk, X, U, Y, weight)
    ins = backward_inputs(problem, stk, X, U, Y, S, G, mu, reg, fold)
    folded = (torch.zeros_like(mu, dtype=torch.bool) if fold is None else
              torch.stack([(t != 0).flatten(1).any(-1) for t in fold]).any(0))
    A, Bm, V_x, V_xx = ins[0], ins[1], ins[12], ins[13]
    kernel = (options.backward_engine != "scan" and (nx, nu, m) in ric.KERNEL_SHAPES)
    backward = ric.ipddp_backward if kernel else ric.ipddp_backward_plain
    k_u, K_u, k_y, K_y, k_s, K_s, Vx_seq, Vxx_seq, stats = backward(*ins)
    # Costate gains: k_lambda[t] = V_x after step t; [N] = the terminal value.
    k_lambda = torch.cat([Vx_seq, V_x[:, None]], 1)
    K_lambda = torch.cat([Vxx_seq, V_xx[:, None]], 1)
    # The Newton step's dS and dY for the fraction-to-boundary rule
    # (ipddp_solver.cpp:1511-1566).
    dX = _rollout_linear(A, Bm, K_u, k_u)[:, :-1]
    cap = ric.max_ratio(X.dtype)
    dS = k_s + _mv(K_s, dX)
    dY = torch.clamp(k_y + _mv(K_y, dX), -cap, cap)
    return _BP(k_u=k_u, K_u=K_u, k_y=k_y, K_y=K_y, k_s=k_s, K_s=K_s,
               k_lambda=k_lambda, K_lambda=K_lambda, dY=dY, dS=dS,
               dV=stats[:, :2], folded=folded, inf_du=stats[:, 2], inf_pr=stats[:, 3],
               inf_comp=stats[:, 4], step_norm=stats[:, 5], ok=stats[:, 6] > 0.5)


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def _forward_scan(problem, stk, soc_on_path, X, U, Y, S, Lambda, bp, a_pr, a_du,
                  tau, soc, events=None):
    """The generic trial rollout (the scan body of ipddp.py:1091-1131), for
    problems or options the forward kernel does not take: every stack with
    an item other than a box. With ``events``, instances on which the
    slack SOC replaced a slack are or-ed into ``events["soc_replaced"]``."""
    dt = problem.timestep
    apr, adu, tau_ = a_pr[:, None], a_du[:, None], tau[:, None]
    x = X[:, 0]
    J = X.new_zeros(X.shape[0])
    feas = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    outs = [[] for _ in range(6)]
    for t in range(problem.horizon):
        dx = x - X[:, t]
        s, y = S[:, t], Y[:, t]
        lam_new = Lambda[:, t] + apr * bp.k_lambda[:, t] + _mv(bp.K_lambda[:, t], dx)
        s_new = s + apr * bp.k_s[:, t] + _mv(bp.K_s[:, t], dx)
        y_new = y + adu * bp.k_y[:, t] + _mv(bp.K_y[:, t], dx)
        u = U[:, t] + apr * bp.k_u[:, t] + _mv(bp.K_u[:, t], dx)
        J = J + problem.objective.running_cost(x, u, t)
        g = stk.evaluate_shifted(x, u)
        if soc_on_path:
            # Slack second-order correction: re-close s := -g at the trial
            # point where that passes the fraction-to-boundary test.
            ok_soc = base.ftb_ok(-g, s, tau_) & soc[:, None]
            s_new = torch.where(ok_soc, -g, s_new)
            if events is not None:
                events["soc_replaced"] |= ok_soc.any(-1)
        x_next = problem.model.discrete_dynamics(x, u, t * dt, dt)
        feas = (feas & base.ftb_ok(s_new, s, tau_).all(-1)
                & base.ftb_ok(y_new, y, tau_).all(-1)
                & s_new.isfinite().all(-1) & y_new.isfinite().all(-1)
                & x_next.isfinite().all(-1) & u.isfinite().all(-1)
                & lam_new.isfinite().all(-1))
        for o, v in zip(outs, (x_next, u, s_new, y_new, g, lam_new)):
            o.append(v)
        x = x_next
    return (*(torch.stack(o, 1) for o in outs), J, feas)


def _forward_pass(problem, options, stk, fc, soc_on_path, st, bp, alpha,
                  a_pr_max, a_du_max, events=None) -> _Trial:
    """Single-alpha interior-point rollout with the filter acceptance
    (ipddp_solver.cpp:1571-1876), the path-constraint regime."""
    X, U, Y, S, Lambda, mu = st["X"], st["U"], st["Y"], st["S"], st["Lambda"], st["mu"]
    tau = _tau(options, mu)
    alpha_pr = torch.minimum(torch.full_like(mu, alpha), a_pr_max)
    alpha_du = torch.minimum(torch.full_like(mu, alpha), a_du_max)
    soc = st["soc_on"] & st["soc_armed"]
    if fc is not None:
        X_tail, U_new, S_new, Y_new, G_new, Lam_head, J, feas = ip_rollout.ip_forward(
            fc, X[:, :-1], U, Y, S, bp.k_u, bp.K_u, bp.k_lambda[:, :-1],
            bp.K_lambda[:, :-1], Lambda[:, :-1], bp.k_y, bp.K_y, bp.k_s, bp.K_s,
            X[:, 0], alpha_pr, alpha_du, tau, soc)
    else:
        X_tail, U_new, S_new, Y_new, G_new, Lam_head, J, feas = _forward_scan(
            problem, stk, soc_on_path, X, U, Y, S, Lambda, bp, alpha_pr, alpha_du,
            tau, soc, events)
    x_last = X_tail[:, -1]
    J = J + problem.objective.terminal_cost(x_last)
    lam_last = (Lambda[:, -1] + alpha_pr[:, None] * bp.k_lambda[:, -1]
                + _mv(bp.K_lambda[:, -1], x_last - X[:, -1]))
    feas = feas & lam_last.isfinite().all(-1)

    phi = _barrier_merit(J, S_new, mu)
    theta = _theta(options, G_new, S_new)
    inf_pr, inf_comp = _primal_comp(G_new, S_new, Y_new, mu)
    feas = (feas & phi.isfinite() & theta.isfinite() & inf_pr.isfinite()
            & inf_comp.isfinite())

    # Filter acceptance (ipddp_solver.cpp:1784-1839).
    fo = options.filter
    expected = alpha_pr * bp.dV[:, 0]
    f_mf, f_cv, nonempty = flt.back(st["filt"])
    cv_old = torch.where(nonempty, f_cv, torch.zeros_like(f_cv))
    high_ref = torch.where(nonempty, f_cv, st["filter_theta"])
    merit_old = st["merit"]
    br1 = theta > fo.max_violation_threshold
    acc1 = theta < (1 - fo.violation_acceptance_threshold) * high_ref
    br2 = (torch.maximum(theta, cv_old) < fo.min_violation_for_armijo_check) & (expected < 0)
    acc2 = phi < merit_old + fo.armijo_constant * expected
    acc3 = ((phi < merit_old - fo.merit_acceptance_threshold * theta)
            | (theta < (1 - fo.violation_acceptance_threshold) * cv_old))
    accept = torch.where(br1, acc1, torch.where(br2, acc2, acc3))
    return _Trial(
        success=feas & accept, cost=J, merit=phi, theta=theta, inf_pr=inf_pr,
        inf_comp=inf_comp, X=torch.cat([X[:, :1], X_tail], 1), U=U_new, Y=Y_new,
        S=S_new, G=G_new, Lambda=torch.cat([Lam_head, lam_last[:, None]], 1),
        alpha_pr=alpha_pr)


def _line_search(problem, options, stk, fc, soc_on_path, st, bp, search, events=None):
    """The alpha ladder for the instances in ``search``: the first success
    in ladder order, or with ``enable_parallel`` the best merit among the
    successes. Returns (selected trial, any success)."""
    a_pr_max, a_du_max = _max_step_sizes(st["S"], st["Y"], bp.dS, bp.dY, st["mu"],
                                         options)
    trials = []
    found = torch.zeros_like(search)
    sel = None
    for a in line_search_alphas(options.line_search):
        if not options.enable_parallel and not bool((search & ~found).any()):
            break
        r = _forward_pass(problem, options, stk, fc, soc_on_path, st, bp, a,
                          a_pr_max, a_du_max, events)
        if options.enable_parallel:
            trials.append(r)
        else:
            sel = r if sel is None else base.select_instances(r.success & ~found, r, sel)
        found = found | r.success
    if options.enable_parallel:
        pick = base.select_forward_result(
            torch.stack([r.success for r in trials], -1),
            torch.stack([r.merit for r in trials], -1), True)
        sel = trials[0]
        for i, r in enumerate(trials[1:], 1):
            sel = base.select_instances(pick.index == i, r, sel)
    return sel, found


# ---------------------------------------------------------------------------
# barrier update (ipddp.py:1277-1363)
# ---------------------------------------------------------------------------


def _barrier_update(options, mu, inf_pr, inf_du, inf_comp):
    """updateBarrierParameters (ipddp_solver.cpp:2548-2660): the new mu."""
    bopt = options.ipddp.barrier
    f = bopt.mu_update_factor
    superlinear = mu ** bopt.mu_update_power
    if bopt.strategy == BarrierStrategy.ADAPTIVE:
        kkt = torch.maximum(torch.maximum(inf_pr, inf_du), inf_comp)
        threshold = torch.maximum(f * mu, 2.0 * mu)
        ratio = kkt / torch.maximum(mu, mu.new_tensor(1e-20))
        c = lambda v: mu.new_tensor(v)  # noqa: E731
        factor = torch.where(ratio < 0.01, c(0.1 * f), torch.where(
            ratio < 0.1, c(0.3 * f), torch.where(ratio < 0.5, c(0.6 * f), c(f))))
        factor = torch.where(mu > 1e-20, factor, c(f))
        mu_cand = torch.maximum(
            torch.minimum(factor * mu, superlinear),
            mu.new_tensor(max(bopt.mu_min_value, options.tolerance / 100.0)))
        return torch.where(kkt <= threshold, mu_cand, mu)
    weighted_du = inf_du * options.ipddp.barrier_update_dual_weight
    kkt = torch.maximum(torch.maximum(inf_pr, weighted_du), inf_comp)
    mu_cand = torch.maximum(mu.new_tensor(bopt.mu_min_value),
                            torch.minimum(f * mu, superlinear))
    return torch.where(kkt <= options.ipddp.mu_kappa_epsilon * mu, mu_cand, mu)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _init_dual_slack(G, mu, options):
    """s = max(s0, -g + offset); y = mu scale / max(s, eps)
    (initializeDualSlackVariables, ipddp_solver.cpp:2428-2480)."""
    S = torch.maximum(G.new_tensor(options.ipddp.slack_var_init_scale),
                      -G + SLACK_INTERIOR_OFFSET)
    Y = (mu[:, None, None] * options.ipddp.dual_var_init_scale) / torch.maximum(
        S, S.new_tensor(EPS_SLACK))
    return Y, S


def _initialize(problem, options, stk, U0):
    """Cold start (ipddp_solver.cpp:820-914): X rolled open-loop from U0,
    slacks and duals from the path values, zero costates, mu_initial.
    Returns (X, U, Y, S, G, Lambda, mu0)."""
    x0 = problem.x0
    kernel = options.backward_engine != "scan"
    X = ip_rollout.open_loop_rollout(problem.model, x0, U0, problem.timestep,
                                     kernel=kernel)
    mu0 = torch.full((x0.shape[0],), options.ipddp.barrier.mu_initial,
                     dtype=x0.dtype, device=x0.device)
    G = _eval_path(stk, X, U0)
    Y, S = _init_dual_slack(G, mu0, options)
    Lambda = X.new_zeros(X.shape)
    return X, U0, Y, S, G, Lambda, mu0


def _drive(problem: Problem, options: CDDPOptions, X, U, Y, S, G, Lambda, mu0,
           ku0, Ku0, events=None) -> Solution:
    """The IPDDP iteration driver from an initialized batch (ipddp.py:1576-
    2032, the path-constraint regime without terminal constraints).

    ``events``, a dict, receives per-instance (B,) bool flags of the stall
    latch's branches for checks that must reach them: "soc_replaced" (a
    trial's slack SOC replaced a slack), "folded" (a backward's
    constraint-Hessian fold was nonzero), "stall_armed" (the detector armed
    the latch at a commit), "fail_armed" (a failed line search at the
    regularization limit armed it), "dropped" (a failed line search near
    feasibility switched the SOC off), and at the end the latch's final
    "soc_on" and "soc_armed"."""
    stk = PathStacker(problem)
    N = problem.horizon
    Bsz, dtype, device = X.shape[0], X.dtype, X.device
    ip = options.ipddp
    tol = options.tolerance
    fc = ip_rollout.resolve_ip_forward(problem, options, stk)
    soc_on_path = soc_traced(options, stk)
    # The stall detector runs where "auto" traces the SOC or the fold.
    auto_latch = bool(stk) and stk.has_curved and (
        ip.slack_soc == "auto" or ip.use_constraint_hessians == "auto")
    if events is not None:
        for name in ("soc_replaced", "folded", "stall_armed", "fail_armed", "dropped"):
            events[name] = torch.zeros(Bsz, dtype=torch.bool, device=device)

    cost = problem.objective.evaluate(X, U)
    mu = mu0
    inf_pr, inf_comp = _primal_comp(G, S, Y, mu)
    merit = _barrier_merit(cost, S, mu)
    zeros = X.new_zeros(Bsz)
    st = dict(
        X=X, U=U, Y=Y, S=S, G=G, Lambda=Lambda, mu=mu, cost=cost, merit=merit,
        phi=merit, filter_theta=torch.clamp(_theta(options, G, S), min=1e-8),
        filt=flt.empty_filter(Bsz, ip.max_filter_size + 2, dtype, device),
        reg=torch.full_like(zeros, options.regularization.initial_value),
        inf_pr=inf_pr, inf_du=zeros, inf_comp=inf_comp, step_norm=zeros,
        alpha_pr=torch.ones_like(zeros),
        soc_on=torch.ones(Bsz, dtype=torch.bool, device=device),
        soc_armed=torch.full((Bsz,), ip.slack_soc is True, dtype=torch.bool,
                             device=device),
        stall_count=torch.zeros(Bsz, dtype=torch.int32, device=device),
        # +inf, not the initial inf_pr: the first commit sets the detector's
        # reference (ipddp.py:1651-1656).
        best_inf_pr=torch.full_like(zeros, math.inf),
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

        # Backward pass with regularization retry (ipddp.py:1694-1708).
        pend = active.clone()
        reg = st["reg"]
        bp_limit = torch.zeros_like(active)
        bp = None
        while bool(pend.any()):
            trial = _backward_condensed(problem, options, stk, st["X"], st["U"],
                                        st["Y"], st["S"], st["G"], st["mu"], reg,
                                        st["soc_armed"])
            bp = trial if bp is None else base.select_instances(pend, trial, bp)
            reg_next = torch.where(trial.ok, reg, base.increase_regularization(reg, options))
            limit = ~trial.ok & base.regularization_limit_reached(reg_next, options)
            reg = torch.where(pend, reg_next, reg)
            bp_limit = torch.where(pend, limit, bp_limit)
            pend = pend & ~(trial.ok | limit)
        put(active, reg=reg, inf_pr=bp.inf_pr, inf_du=bp.inf_du,
            inf_comp=bp.inf_comp, step_norm=bp.step_norm)
        if events is not None:
            events["folded"] |= active & bp.folded
        k_u = base.where_instances(active, bp.k_u, k_u)
        K_u = base.where_instances(active, bp.K_u, K_u)

        fail_bp = active & bp_limit
        status = torch.where(fail_bp, Status.REGULARIZATION_LIMIT_NOT_CONVERGED, status)
        live = active & ~bp_limit

        # Early convergence (checkEarlyConvergence, ipddp_solver.cpp:925-958).
        tol_e = torch.maximum(st["mu"].new_tensor(tol), ip.barrier_tol_mult * st["mu"])
        early = (live & (st["inf_pr"] < tol_e) & (st["inf_du"] < tol_e)
                 & (st["inf_comp"] < tol_e)
                 & (st["alpha_pr"].abs() * st["step_norm"] < tol * 10.0))
        status = torch.where(early, Status.OPTIMAL_SOLUTION_FOUND, status)
        search = live & ~early
        done = done | fail_bp | early
        if not bool(search.any()):
            continue

        r, found = _line_search(problem, options, stk, fc, soc_on_path, st, bp, search,
                                events)
        ok = search & found
        fail = search & ~found

        # Commit (ipddp.py:1788-1895): the trial, the barrier and filter
        # update, then the convergence test under the new mu.
        dJ = st["cost"] - r.cost
        mu_old = st["mu"]
        mu_new = _barrier_update(options, mu_old, r.inf_pr, st["inf_du"], r.inf_comp)
        filter_theta = torch.clamp(_theta(options, r.G, r.S), min=1e-8)
        reset = (mu_new < mu_old) & (mu_new > 0.0)
        kept, _ = flt.accept_entry(st["filt"], r.merit, filter_theta)
        kept = flt.select(flt.size(kept) > ip.max_filter_size, flt.prune_to_best(kept),
                          kept)
        inf_pr_c, inf_comp_c = _primal_comp(r.G, r.S, r.Y, mu_new)
        merit_c = _barrier_merit(r.cost, r.S, mu_new)
        tol2 = torch.maximum(mu_new.new_tensor(tol), ip.barrier_tol_mult * mu_new)
        step_small = st["step_norm"] < tol * 10.0
        conv_opt = ((inf_pr_c < tol2) & (st["inf_du"] < tol2) & (inf_comp_c < tol2)
                    & step_small)
        atol = options.acceptable_tolerance
        accept_tol = math.sqrt(atol)
        acc_kkt = ((inf_pr_c < accept_tol) & (st["inf_du"] < accept_tol)
                   & (inf_comp_c < accept_tol))
        barrier_done = mu_new <= max(ip.barrier.mu_min_value * 100.0, tol / 10.0)
        acc = acc_kkt & barrier_done & (((it > 10) & (dJ.abs() < atol))
                                        | ((it >= 1) & step_small & (inf_pr_c < 1e-4)))
        conv_acc = acc & (atol > 0)
        if auto_latch:
            count, armed, best = stall_detector_update(
                mu_old, mu_new, inf_pr_c, st["best_inf_pr"], st["stall_count"],
                st["soc_armed"], tol, ip.soc_stall_iterations)
            if events is not None:
                events["stall_armed"] |= ok & armed & ~st["soc_armed"]
            put(ok, stall_count=count, soc_armed=armed, best_inf_pr=best)
        put(ok, X=r.X, U=r.U, Y=r.Y, S=r.S, G=r.G, Lambda=r.Lambda, cost=r.cost,
            alpha_pr=r.alpha_pr, reg=base.decrease_regularization(st["reg"], options),
            mu=mu_new, filt=flt.select(reset, flt.clear(kept), kept), phi=merit_c,
            filter_theta=filter_theta, merit=merit_c, inf_pr=inf_pr_c,
            inf_comp=inf_comp_c)
        status = torch.where(ok & conv_opt, Status.OPTIMAL_SOLUTION_FOUND,
                             torch.where(ok & conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND,
                                         status))
        done = done | (ok & (conv_opt | conv_acc))

        # Line-search failure (handleForwardPassFailure, :2037-2082).
        reg_n = base.increase_regularization(st["reg"], options)
        limit = base.regularization_limit_reached(reg_n, options)
        accept_tol = torch.maximum(st["mu"].new_tensor(math.sqrt(max(atol, tol))),
                                   ip.barrier_tol_mult * st["mu"])
        acceptable = ((atol > 0) & (st["inf_pr"] < accept_tol)
                      & (st["inf_du"] < accept_tol) & (st["inf_comp"] < accept_tol))
        st_fail = torch.where(limit & acceptable, Status.ACCEPTABLE_SOLUTION_FOUND,
                              torch.where(limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED,
                                          status))
        if soc_on_path:
            # A rejected line search while primal-feasible switches the
            # armed slack SOC off and retries at the same regularization.
            drop = st["soc_on"] & st["soc_armed"] & (st["inf_pr"] < 10.0 * tol)
            reg_n = torch.where(drop, st["reg"], reg_n)
            st_fail = torch.where(drop, status, st_fail)
            limit = limit & ~drop
            if events is not None:
                events["dropped"] |= fail & drop
            put(fail, soc_on=st["soc_on"] & ~drop)
        if auto_latch:
            # The regularization exhausted far from feasibility with the
            # latch unarmed: arm it and retry from the initial
            # regularization instead of ending the solve.
            arm = limit & ~st["soc_armed"] & (st["inf_pr"] > 100.0 * tol)
            reg_n = torch.where(arm, reg_n.new_tensor(options.regularization.initial_value),
                                reg_n)
            st_fail = torch.where(arm, status, st_fail)
            limit = limit & ~arm
            if events is not None:
                events["fail_armed"] |= fail & arm
            put(fail, soc_armed=st["soc_armed"] | arm)
        put(fail, reg=reg_n)
        status = torch.where(fail, st_fail, status).to(torch.int32)
        done = done | (fail & limit)

    if events is not None:
        events.update(soc_on=st["soc_on"], soc_armed=st["soc_armed"])
    return Solution(
        solver_name="IPDDP",
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
        dual_trajectories=stk.split(st["Y"]),
        slack_trajectories=stk.split(st["S"]),
        costate_trajectory=st["Lambda"],
        barrier_mu=st["mu"],
        inf_pr=st["inf_pr"],
        inf_comp=st["inf_comp"],
    )


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[torch.Tensor] = None,
    U0: Optional[torch.Tensor] = None,
) -> Solution:
    """Solve with IPDDP. ``problem.x0`` is (nx,) for one solve or (B, nx)
    for a batch; ``U0`` seeds the controls (X is rolled out from it, as
    the reference's cold start does; ``X0`` is accepted and unused)."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp

    base.validate_options(options)
    validate_options(options)
    problem = base.canonicalize_problem_dtype(problem)
    stk = PathStacker(problem)
    TerminalStacker(problem)
    if not stk:
        raise NotImplementedError(
            "IPDDP without path constraints is not yet ported to cddp_tpu_torch")
    _, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    unbatched = problem.x0.dim() == 1
    if unbatched:
        problem = problem.replace(x0=problem.x0[None])
        U = U[None]

    whole = mega_ipddp.mega_eligible(problem, options)
    if options.solve_engine == "fused" and not whole:
        raise ValueError(
            "solve_engine='fused' requires a problem the whole-solve kernel "
            "takes: a registered model with an explicit integrator, the "
            "quadratic objective, a stack of control boxes, state boxes and "
            "keep-out balls the kernel is built for, iLQR, the sequential line "
            "search and default driver options (see mega_ipddp.mega_eligible)"
        )
    X, U, Y, S, G, Lambda, mu0 = _initialize(problem, options, stk, U)
    ku0 = X.new_zeros(X.shape[0], N, nu)
    Ku0 = X.new_zeros(X.shape[0], N, nu, nx)
    if whole:
        sol = mega_ipddp.ipddp_solve(problem, options, X, U, Y, S, G, Lambda, mu0,
                                     ku0, Ku0)
    else:
        sol = _drive(problem, options, X, U, Y, S, G, Lambda, mu0, ku0, Ku0)
    return sol.first() if unbatched else sol
