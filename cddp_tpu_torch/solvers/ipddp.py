"""IPDDP — primal-dual interior-point DDP (port of ``cddp_tpu/solvers/ipddp.py``).

Slack formulation g(x, u) + s = 0, s > 0, y > 0 (ipddp_solver.cpp). The
slice the port carries: path constraints of every type of
``constraints/path.py``, or none (the unconstrained regime, and problems
with terminal constraints alone), the quadratic cost, both terminal regimes (linear
terminal inequalities folded into the terminal value, and terminal
equalities through the p+1 reduced LQR), iLQR Hessians, the sequential
condensed backward, both line-search modes, both barrier strategies, both
theta norms, cold starts and warm starts (a trajectory, or an
``IPDDPSolverState`` carried from an earlier solve). On a curved
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
``ipddp.forward_engine="scan"`` run the plain versions. The terminal
equality's reduced LQR (``_backward_terminal_eq``) is plain torch on every
engine, as the JAX package has no per-pass kernel for it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.options import BarrierStrategy, CDDPOptions, line_search_alphas
from cddp_tpu_torch.ops import linalg
from cddp_tpu_torch.ops.kernels import ip_rollout
from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
from cddp_tpu_torch.problem import Problem
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers import base
from cddp_tpu_torch.solvers import filter as flt

# ipddp_solver.cpp:34-37.
SLACK_INTERIOR_OFFSET = 1e-4
EPS_SLACK = ric.EPS_SLACK
EPS_DUAL = 1e-10


class IPDDPSolverState(NamedTuple):
    """The warm-start checkpoint (ipddp.py:100-115 of the JAX package),
    batch-first: what the reference solver object keeps across solves."""

    k_u: torch.Tensor  # (B, N, nu)
    K_u: torch.Tensor  # (B, N, nu, nx)
    Y: torch.Tensor  # (B, N, m)
    S: torch.Tensor  # (B, N, m)
    Lambda: torch.Tensor  # (B, N+1, nx)
    Y_T: torch.Tensor  # (B, mT)
    S_T: torch.Tensor  # (B, mT)
    Lambda_T_eq: torch.Tensor  # (B, p)
    x0: torch.Tensor  # (B, nx): the initial state the state was solved from


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
    dS_T: torch.Tensor  # (B, mT): the terminal inequalities' Newton steps
    dY_T: torch.Tensor
    dLambda_T_eq: torch.Tensor  # (B, p): the terminal equalities' multiplier step
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
    S_T: torch.Tensor  # (B, mT)
    Y_T: torch.Tensor
    G_T: torch.Tensor
    Lambda_T_eq: torch.Tensor  # (B, p)
    h_T: torch.Tensor  # (B, p): the terminal equalities at the trial's x_N
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
    ):
        if unported:
            raise NotImplementedError(f"IPDDP {name} is not yet ported to cddp_tpu_torch")


# ---------------------------------------------------------------------------
# shared evaluations (ipddp.py:253-324)
# ---------------------------------------------------------------------------


def _eval_path(stk: PathStacker, X, U):
    """Stacked shifted constraint values over the horizon, (B, N, m)."""
    return stk.evaluate_shifted(X[:, :-1], U)


class _Terminal(NamedTuple):
    """The terminal constraints' state, batch-first: the inequalities'
    values g_T = A x_N - b, slacks and duals (B, mT), the equalities'
    values h_T = x_N - target and multipliers (B, p). Widths 0 without."""

    G_T: torch.Tensor
    S_T: torch.Tensor
    Y_T: torch.Tensor
    h_T: torch.Tensor
    Lambda_T_eq: torch.Tensor


def _barrier_merit(cost, S, mu, tm: Optional[_Terminal] = None):
    """computeBarrierMerit (ipddp_solver.cpp:2851-2881): cost - mu sum log s
    over the path and terminal slacks, + lambda_T . h_T for terminal
    equalities (``tm``; None: no terminal rows)."""
    eps = S.new_tensor(EPS_SLACK)
    merit = cost - mu * torch.log(torch.maximum(S, eps)).sum((1, 2))
    if tm is None:
        return merit
    if tm.S_T.shape[-1]:
        merit = merit - mu * torch.log(torch.maximum(tm.S_T, eps)).sum(-1)
    if tm.h_T.shape[-1]:
        merit = merit + (tm.Lambda_T_eq * tm.h_T).sum(-1)
    return merit


def _residual_groups(G, S, tm: Optional[_Terminal]):
    """The primal residuals by group: path g + s (B, N m), terminal
    g_T + s_T, terminal h_T; empty groups left out."""
    groups = [(G + S).flatten(1)] if G.shape[-1] else []
    if tm is None:
        return groups
    if tm.S_T.shape[-1]:
        groups.append(tm.G_T + tm.S_T)
    if tm.h_T.shape[-1]:
        groups.append(tm.h_T)
    return groups


def _theta(options, G, S, tm: Optional[_Terminal] = None):
    """computeTheta (ipddp_solver.cpp:2778-2849): the l1 (default) or l2
    norm of the primal residuals g + s (+ g_T + s_T, + h_T), maxed with
    their largest entry; the groups summed in that order (0 without
    constraints)."""
    l2 = options.ipddp.theta_norm == "l2"
    total, top = G.new_zeros(G.shape[0]), G.new_zeros(G.shape[0])
    for r in _residual_groups(G, S, tm):
        total = total + ((r * r).sum(-1) if l2 else r.abs().sum(-1))
        top = torch.maximum(top, r.abs().amax(-1))
    return torch.maximum(torch.sqrt(total) if l2 else total, top)


def _primal_comp(G, S, Y, mu, tm: Optional[_Terminal] = None):
    """computePrimalAndComplementarity (ipddp_solver.cpp:2883-2937):
    inf-norms of g + s (and g_T + s_T, h_T) and of y s - mu (and
    y_T s_T - mu); 0 for empty groups."""
    inf_pr = ric.maxabs((G + S).flatten(1))
    inf_comp = ric.maxabs((Y * S - mu[:, None, None]).flatten(1))
    if tm is None:
        return inf_pr, inf_comp
    if tm.S_T.shape[-1]:
        inf_pr = torch.maximum(inf_pr, (tm.G_T + tm.S_T).abs().amax(-1))
        inf_comp = torch.maximum(inf_comp, (tm.Y_T * tm.S_T - mu[:, None]).abs().amax(-1))
    if tm.h_T.shape[-1]:
        inf_pr = torch.maximum(inf_pr, tm.h_T.abs().amax(-1))
    return inf_pr, inf_comp


def _tau(options, mu):
    return torch.maximum(mu.new_tensor(options.ipddp.barrier.min_fraction_to_boundary),
                         1.0 - mu)


def _max_step_sizes(S, Y, dS, dY, mu, options, S_T=None, Y_T=None, dS_T=None, dY_T=None):
    """Fraction-to-boundary maximum primal and dual steps over the path and
    terminal slacks and duals (computeMaxStepSizes,
    ipddp_solver.cpp:2939-2988)."""
    tau = _tau(options, mu)
    one = mu.new_ones(mu.shape)

    def shrink(v, dv):
        if not v.shape[-1]:
            return one
        t = tau.reshape(tau.shape + (1,) * (v.dim() - 1))
        neg = dv < 0.0
        ratio = torch.where(neg, -t * v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, float("inf")))
        return ratio.flatten(1).amin(-1)

    a_pr, a_du = torch.minimum(one, shrink(S, dS)), torch.minimum(one, shrink(Y, dY))
    if S_T is not None and S_T.shape[-1]:
        a_pr = torch.minimum(a_pr, shrink(S_T, dS_T))
        a_du = torch.minimum(a_du, shrink(Y_T, dY_T))
    return torch.clamp(a_pr, 0.0, 1.0), torch.clamp(a_du, 0.0, 1.0)


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
    du = k + K dx, dx+ = A dx + B du. The step axis is the one before the
    matrix axes; leading axes broadcast (the terminal equality's variants
    share A, B and K). Returns dX (..., N+1, nx)."""
    lead = torch.broadcast_shapes(A.shape[:-3], K.shape[:-3], k.shape[:-2])
    dx = A.new_zeros(*lead, A.shape[-1])
    dX = [dx]
    for t in range(A.shape[-3]):
        du = k[..., t, :] + _mv(K[..., t, :, :], dx)
        dx = _mv(A[..., t, :, :], dx) + _mv(Bm[..., t, :, :], du)
        dX.append(dx)
    return torch.stack(dX, -2)


def fold_terms(stk, X, U, Y, weight):
    """The y-weighted constraint Hessians, times ``weight`` (B,), that fold
    into (lxx, luu, lux) (ipddp.py:596-627): the Lagrangian curvature the
    Gauss-Newton condensation drops. A weight of 0 gives exact zeros and
    keeps a non-finite y's NaN, as the JAX driver's multiply does."""
    Yw = Y * weight[:, None, None]
    return tuple(torch.einsum("btm,btmjk->btjk", Yw, h)
                 for h in stk.hessians(X[:, :-1], U))


def _terminal_value_fold(problem, tstk, X_last, S_T, Y_T, mu):
    """The terminal value at x_N with the terminal inequalities folded in
    (ipddp.py:332-350, ipddp_solver.cpp:999-1031): V_x += G_T' (y + clip((y
    g + mu) / s_safe)), V_xx = sym(V_xx + G_T' Sigma_T G_T), y floored at
    EPS_DUAL. Returns (V_x, V_xx, g_T, inf_pr_T, inf_comp_T), the last two
    None without terminal inequalities."""
    V_x = problem.objective.terminal_cost_gradient(X_last)
    V_xx = ric._sym(problem.objective.terminal_cost_hessian(X_last))
    g_T = tstk.ineq_evaluate(X_last)
    if not tstk.ineq_dim:
        return V_x, V_xx, g_T, None, None
    GT = tstk.ineq_jacobian(X_last)
    cap = ric.max_ratio(X_last.dtype)
    ss = ric.s_safe(S_T, mu)
    y = torch.maximum(Y_T, Y_T.new_tensor(EPS_DUAL))
    sigma = torch.clamp(y / ss, 0.0, cap)
    grad = y + torch.clamp((y * g_T + mu[:, None]) / ss, -cap, cap)
    V_x = V_x + grad @ GT
    V_xx = ric._sym(V_xx + GT.mT @ (sigma[..., None] * GT))
    return (V_x, V_xx, g_T, (g_T + S_T).abs().amax(-1),
            (Y_T * S_T - mu[:, None]).abs().amax(-1))


def _terminal_steps(tstk, X_last, g_T, S_T, Y_T, dx_last, mu):
    """The terminal inequalities' slack and dual Newton steps (dS_T, dY_T)
    for dx_N (ipddp.py:378-395, ipddp_solver.cpp:1315-1345), each (B, 0)
    without terminal inequalities."""
    if not tstk.ineq_dim:
        return S_T.new_zeros(S_T.shape), Y_T.new_zeros(Y_T.shape)
    cap = ric.max_ratio(S_T.dtype)
    dS_T = -(g_T + S_T) - _mv(tstk.ineq_jacobian(X_last), dx_last)
    ss = ric.s_safe(S_T, mu)
    ratio = torch.clamp(Y_T / ss, 0.0, cap)
    affine = torch.clamp(-(S_T * Y_T - mu[:, None]) / ss, -cap, cap)
    return dS_T, torch.clamp(affine - ratio * dS_T, -cap, cap)


def backward_inputs(problem, stk, X, U, Y, S, G, mu, reg, fold=None, terminal=None):
    """The condensed backward's inputs (the ``ipddp_riccati`` signature):
    the Euler linearization, the cost derivatives (plus the ``fold_terms``
    when given), the stack's Jacobians at each step (broadcasts of one
    copy for a box stack) and the terminal value (``terminal`` = (V_x,
    V_xx), per instance, when the terminal inequalities are folded in;
    else the terminal cost's), batch-first."""
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    Gx, Gu = stk.jacobians(X[:, :-1], U)
    if fold is not None:
        lxx, luu, lux = lxx + fold[0], luu + fold[1], lux + fold[2]
    if terminal is None:
        V_x = problem.objective.terminal_cost_gradient(X[:, -1])
        V_xx = ric._sym(problem.objective.terminal_cost_hessian(X[:, -1]))
    else:
        V_x, V_xx = terminal
    return (A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, V_x, V_xx, mu, reg)


def _fold_weight(options, stk, armed):
    """The constraint-Hessian fold's per-instance weight (None: not
    traced): 1 under "static", the armed latch (B,) as 0 or 1 under
    "latched"."""
    mode = chess_mode(options, stk)
    if mode == "off":
        return None
    return torch.ones_like(armed) if mode == "static" else armed


def _backward_condensed(problem, options, stk, X, U, Y, S, G, mu, reg, soc_armed=None,
                        terminal=None) -> _BP:
    """The path-constraint condensed Riccati recursion
    (ipddp_solver.cpp:1355-1568), iLQR, sequential, from the terminal value
    with the terminal inequalities folded in (``terminal`` = (TerminalStacker,
    _Terminal); None: the problem's stacker at its cold terminal state).
    ``soc_armed`` (B,) is the stall latch; None counts as armed, as in the
    JAX driver."""
    nx, nu, m = problem.state_dim, problem.control_dim, Y.shape[-1]
    if terminal is None:
        tstk = TerminalStacker(problem)
        S_T, Y_T, lam = initialize_terminal(problem, options, tstk, X, mu)
        terminal = (tstk, _Terminal(G_T=tstk.ineq_evaluate(X[:, -1]), S_T=S_T, Y_T=Y_T,
                                    h_T=tstk.eq_evaluate(X[:, -1]), Lambda_T_eq=lam))
    tstk, tm = terminal
    armed = (torch.ones_like(mu) if soc_armed is None else soc_armed.to(X.dtype))
    weight = _fold_weight(options, stk, armed)
    fold = None if weight is None else fold_terms(stk, X, U, Y, weight)
    V_x, V_xx, g_T, inf_pr_T, inf_comp_T = _terminal_value_fold(
        problem, tstk, X[:, -1], tm.S_T, tm.Y_T, mu)
    ins = backward_inputs(problem, stk, X, U, Y, S, G, mu, reg, fold, (V_x, V_xx))
    folded = (torch.zeros_like(mu, dtype=torch.bool) if fold is None else
              torch.stack([(t != 0).flatten(1).any(-1) for t in fold]).any(0))
    A, Bm = ins[0], ins[1]
    kernel = (options.backward_engine != "scan" and (nx, nu, m) in ric.KERNEL_SHAPES)
    backward = ric.ipddp_backward if kernel else ric.ipddp_backward_plain
    k_u, K_u, k_y, K_y, k_s, K_s, Vx_seq, Vxx_seq, stats = backward(*ins)
    # Costate gains: k_lambda[t] = V_x after step t; [N] = the terminal value.
    k_lambda = torch.cat([Vx_seq, V_x[:, None]], 1)
    K_lambda = torch.cat([Vxx_seq, V_xx[:, None]], 1)
    # The Newton step's dS and dY for the fraction-to-boundary rule
    # (ipddp_solver.cpp:1511-1566), and the terminal rows' from dx_N.
    dX = _rollout_linear(A, Bm, K_u, k_u)
    cap = ric.max_ratio(X.dtype)
    dS = k_s + _mv(K_s, dX[:, :-1])
    dY = torch.clamp(k_y + _mv(K_y, dX[:, :-1]), -cap, cap)
    dS_T, dY_T = _terminal_steps(tstk, X[:, -1], g_T, tm.S_T, tm.Y_T, dX[:, -1], mu)
    return _BP(k_u=k_u, K_u=K_u, k_y=k_y, K_y=K_y, k_s=k_s, K_s=K_s,
               k_lambda=k_lambda, K_lambda=K_lambda, dY=dY, dS=dS, dS_T=dS_T, dY_T=dY_T,
               dLambda_T_eq=tm.Lambda_T_eq.new_zeros(tm.Lambda_T_eq.shape),
               dV=stats[:, :2], folded=folded, inf_du=stats[:, 2],
               inf_pr=_max_with(stats[:, 3], inf_pr_T),
               inf_comp=_max_with(stats[:, 4], inf_comp_T),
               step_norm=stats[:, 5], ok=stats[:, 6] > 0.5)


def _max_with(v, other):
    """max(v, other), or v where ``other`` is None."""
    return v if other is None else torch.maximum(v, other)


def _all_finite(t, dims):
    return t.isfinite().flatten(-dims).all(-1)


def _solve_sequential_lqr(Q_T, q_T, Q, q, R, r, M, A, Bm):
    """solveSequentialLQR (ipddp.py:813-853, ipddp_solver.cpp:413-476)
    batch-first, as one reverse sweep over any leading shape: stage data
    (..., N, ·), the terminal block Q_T (..., nx, nx) and q_T (..., nx).
    Leading axes broadcast, so the terminal equality's p+1 variants, which
    differ in q_T alone, share one K and P. Returns (K (..., N, nu, nx), k,
    P (..., N+1, nx, nx), p, ok (...,))."""
    P = ric._sym(Q_T)
    p = q_T
    Ks, ks, Ps, ps = [], [], [P], [p]
    ok = None
    for t in reversed(range(A.shape[-3])):
        A_t, B_t = A[..., t, :, :], Bm[..., t, :, :]
        BtP = B_t.mT @ P
        Quu = ric._sym(R[..., t, :, :] + BtP @ B_t)
        Qux = BtP @ A_t + M[..., t, :, :].mT
        Qx = q[..., t, :] + _mv(A_t.mT, p)
        Qu = r[..., t, :] + _mv(B_t.mT, p)
        K_neg, pd_ok = linalg.solve_and_check(Quu, Qux)
        k_neg, _ = linalg.solve_and_check(Quu.expand(*Qu.shape[:-1], *Quu.shape[-2:]), Qu)
        K, k = -K_neg, -k_neg
        P = ric._sym(Q[..., t, :, :] + A_t.mT @ P @ A_t + Qux.mT @ K + K.mT @ Qux
                     + K.mT @ Quu @ K)
        p = Qx + _mv(Qux.mT, k) + _mv(K.mT, Qu) + _mv(K.mT @ Quu, k)
        good = (pd_ok & _all_finite(P, 2) & _all_finite(K, 2) & _all_finite(p, 1)
                & _all_finite(k, 1))
        ok = good if ok is None else ok & good
        Ks.append(K)
        ks.append(k)
        Ps.append(P)
        ps.append(p)
    flip = lambda xs, d: torch.stack(xs[::-1], d)  # noqa: E731
    return flip(Ks, -3), flip(ks, -2), flip(Ps, -3), flip(ps, -2), ok


def _condense_steps(Y, S, G, mu):
    """``ipddp_riccati.condense_path`` at every step: (s_safe, sigma, primal
    residual, complementarity residual, rhat, S^-1 rhat), each (B, N, m)."""
    Bsz, N, m = Y.shape
    flat = lambda t: t.reshape(Bsz * N, m)  # noqa: E731
    out = ric.condense_path(flat(Y), flat(S), flat(G), mu.repeat_interleave(N))
    return tuple(o.reshape(Bsz, N, m) for o in out)


def _backward_terminal_eq(problem, options, stk, tstk, X, U, Y, S, G, tm, mu, reg) -> _BP:
    """The terminal-equality reduced-LQR regime (ipddp.py:855-1063,
    ipddp_solver.cpp:1121-1351 and solveTerminalEqualityLQR :478-639),
    batch-first: the path constraints condensed into the stage data, the
    p+1 perturbed-q LQR variants as one sweep over a (B, p+1) leading shape
    (variant i > 0 adds row i-1 of H_T to the terminal q), the sensitivity
    S = dx_N / dlambda, the SVD-floored 5-scale Cholesky ladder for the
    multiplier step, and the gains recombined linearly (K and P from
    variant 0). dV is zero, as the JAX driver reports it."""
    nx, nu = problem.state_dim, problem.control_dim
    p_dim = tstk.eq_dim
    dtype, device = X.dtype, X.device
    cap = ric.max_ratio(dtype)
    A, Bm = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    V_x, V_xx, g_T, inf_pr_T, inf_comp_T = _terminal_value_fold(
        problem, tstk, X[:, -1], tm.S_T, tm.Y_T, mu)
    h_T = tstk.eq_evaluate(X[:, -1])
    H_T = tstk.eq_jacobian(X[:, -1])  # (p, nx)

    # Stagewise LQR data with the path condensation (ipddp_solver.cpp:1143-1258).
    Gx, Gu = stk.jacobians(X[:, :-1], U)
    ss, sigma, pr, comp, rhat, sir = _condense_steps(Y, S, G, mu)
    ysir = Y + sir
    qs = lx + torch.einsum("btmn,btm->btn", Gx, ysir)
    rs = lu + torch.einsum("btmn,btm->btn", Gu, ysir)
    Qs = ric._sym(ric._sym(lxx) + torch.einsum("btmn,btm,btmk->btnk", Gx, sigma, Gx))
    Ms = lux.mT + torch.einsum("btmn,btm,btmk->btnk", Gx, sigma, Gu)
    Rs = ric._sym(ric._sym(luu) + torch.einsum("btmn,btm,btmk->btnk", Gu, sigma, Gu))
    Rs = Rs + reg[:, None, None, None] * torch.eye(nu, dtype=dtype, device=device)
    inf_pr = torch.maximum(_max_with(h_T.abs().amax(-1), inf_pr_T),
                           ric.maxabs(pr.flatten(1)))
    inf_comp = _max_with(ric.maxabs(comp.flatten(1)), inf_comp_T)

    # The p+1 variants (ipddp_solver.cpp:509-550): the terminal q shifted by
    # the previous multiplier, then by row i-1 of H_T for variant i.
    q_base = V_x + tm.Lambda_T_eq @ H_T
    perturb = torch.cat([H_T.new_zeros(1, nx), H_T])
    q_T = q_base[:, None] + perturb
    v = lambda t: t[:, None]  # noqa: E731  (a variant axis of size 1, shared)
    K, k_v, P, p_v, ok = _solve_sequential_lqr(v(V_xx), q_T, v(Qs), v(qs), v(Rs), v(rs),
                                               v(Ms), v(A), v(Bm))
    ok = ok.all(-1)
    xT = _rollout_linear(v(A), v(Bm), K, k_v)[..., -1, :]  # (B, p+1, nx)

    # Sensitivity and the regularized least squares (ipddp_solver.cpp:550-617).
    S_mat = (xT[:, 1:] - xT[:, :1]).mT  # (B, nx, p)
    A_small = H_T @ S_mat
    rhs = -h_T - xT[:, 0] @ H_T.mT
    AtA = A_small.mT @ A_small
    Atb = _mv(A_small.mT, rhs)
    trace = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    one = trace.new_ones(())
    trace_term = torch.where(trace > 1.0, trace / max(p_dim, 1), one)
    ip = options.ipddp
    base_floor = torch.maximum(trace.new_tensor(1e-10), ip.jacobian_regularization_value
                               * torch.clamp(mu, min=0.0) ** ip.jacobian_regularization_exponent)
    reg0 = torch.maximum(base_floor, 1e-6 * trace_term)
    sv = torch.linalg.svdvals(A_small)
    svd_reg = torch.clamp(1e-8 * sv.amax(-1) - sv.amin(-1), min=0.0)
    reg_base = torch.maximum(reg0, svd_reg)
    lambda_cap = 100.0 * (1.0 + torch.linalg.vector_norm(rhs, dim=-1))
    eye_p = torch.eye(p_dim, dtype=dtype, device=device)
    lams, residuals = [], []
    for scale in (1.0, 10.0, 100.0, 1e3, 1e4):
        reg_i = torch.clamp(reg_base * scale, min=1e-12)
        chol, info = torch.linalg.cholesky_ex(AtA + reg_i[:, None, None] * eye_p)
        bad_chol = (info != 0) | chol.isnan().flatten(1).any(-1)
        chol_safe = torch.where(bad_chol[:, None, None], eye_p, chol)
        lam = torch.cholesky_solve(Atb[..., None], chol_safe)[..., 0]
        norm = torch.linalg.vector_norm(lam, dim=-1)
        shrunk = lam * lambda_cap[:, None] / torch.clamp(norm, min=1e-12)[:, None]
        lam = torch.where((norm > lambda_cap)[:, None], shrunk, lam)
        residual = torch.linalg.vector_norm(_mv(A_small, lam) - rhs, dim=-1)
        bad = bad_chol | ~lam.isfinite().all(-1) | ~residual.isfinite()
        lams.append(lam)
        residuals.append(torch.where(bad, torch.full_like(residual, math.inf), residual))
    residuals = torch.stack(residuals, -1)
    best = residuals.argmin(-1)  # the first minimum, as jnp.argmin
    lam_best = torch.stack(lams, 1)[torch.arange(X.shape[0], device=device), best]
    found = residuals.gather(-1, best[:, None])[:, 0].isfinite()
    coeff = torch.where(found[:, None], lam_best, torch.zeros_like(lam_best))

    # Recombined gains (ipddp_solver.cpp:619-634); K and P of variant 0.
    k_u = k_v[:, 0] + torch.einsum("bp,bptm->btm", coeff, k_v[:, 1:] - k_v[:, :1])
    p_comb = p_v[:, 0] + torch.einsum("bp,bptn->btn", coeff, p_v[:, 1:] - p_v[:, :1])
    K_u, P_comb = K[:, 0], P[:, 0]
    inf_du = torch.clamp((rs + torch.einsum("btnm,btn->btm", Bm, p_comb[:, 1:]))
                         .abs().amax((1, 2)), min=0.0)
    dX = _rollout_linear(A, Bm, K_u, k_u)
    k_y, K_y, k_s, K_s = ric.path_gains(Y, ss, sigma, pr, rhat, Gx, Gu, k_u, K_u)
    dS = k_s + _mv(K_s, dX[:, :-1])
    dY = torch.clamp(k_y + _mv(K_y, dX[:, :-1]), -cap, cap)
    dS_T, dY_T = _terminal_steps(tstk, X[:, -1], g_T, tm.S_T, tm.Y_T, dX[:, -1], mu)
    return _BP(k_u=k_u, K_u=K_u, k_y=k_y, K_y=K_y, k_s=k_s, K_s=K_s,
               k_lambda=p_comb, K_lambda=P_comb, dY=dY, dS=dS, dS_T=dS_T, dY_T=dY_T,
               dLambda_T_eq=coeff, dV=X.new_zeros(X.shape[0], 2),
               folded=torch.zeros_like(ok), inf_du=inf_du, inf_pr=inf_pr,
               inf_comp=inf_comp, step_norm=k_u.abs().amax((1, 2)), ok=ok)


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def _forward_scan(problem, stk, soc_on_path, X, U, Y, S, Lambda, bp, a_pr, a_du,
                  tau, soc, events=None):
    """The generic trial rollout (the scan body of ipddp.py:1091-1131), for
    problems or options the forward kernel does not take: every stack with
    an item other than a box, and the empty stack, whose absent rows take
    no slack, dual, fraction-to-boundary or finiteness step (ipddp.py:1101,
    :1118-1124). With ``events``, instances on which the slack SOC replaced
    a slack are or-ed into ``events["soc_replaced"]``."""
    dt = problem.timestep
    has_path = bool(stk)
    apr, adu, tau_ = a_pr[:, None], a_du[:, None], tau[:, None]
    x = X[:, 0]
    J = X.new_zeros(X.shape[0])
    feas = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    outs = [[] for _ in range(6)]
    for t in range(problem.horizon):
        dx = x - X[:, t]
        s, y = S[:, t], Y[:, t]
        lam_new = Lambda[:, t] + apr * bp.k_lambda[:, t] + _mv(bp.K_lambda[:, t], dx)
        u = U[:, t] + apr * bp.k_u[:, t] + _mv(bp.K_u[:, t], dx)
        J = J + problem.objective.running_cost(x, u, t)
        x_next = problem.model.discrete_dynamics(x, u, t * dt, dt)
        feas = (feas & x_next.isfinite().all(-1) & u.isfinite().all(-1)
                & lam_new.isfinite().all(-1))
        if not has_path:
            for o, v in zip(outs, (x_next, u, s, y, s, lam_new)):
                o.append(v)
            x = x_next
            continue
        s_new = s + apr * bp.k_s[:, t] + _mv(bp.K_s[:, t], dx)
        y_new = y + adu * bp.k_y[:, t] + _mv(bp.K_y[:, t], dx)
        g = stk.evaluate_shifted(x, u)
        if soc_on_path:
            # Slack second-order correction: re-close s := -g at the trial
            # point where that passes the fraction-to-boundary test.
            ok_soc = base.ftb_ok(-g, s, tau_) & soc[:, None]
            s_new = torch.where(ok_soc, -g, s_new)
            if events is not None:
                events["soc_replaced"] |= ok_soc.any(-1)
        feas = (feas & base.ftb_ok(s_new, s, tau_).all(-1)
                & base.ftb_ok(y_new, y, tau_).all(-1)
                & s_new.isfinite().all(-1) & y_new.isfinite().all(-1))
        for o, v in zip(outs, (x_next, u, s_new, y_new, g, lam_new)):
            o.append(v)
        x = x_next
    return (*(torch.stack(o, 1) for o in outs), J, feas)


def _terminal_trial(tstk, st, bp, x_last, a_pr, a_du, tau):
    """The terminal rows of a trial (ipddp.py:1169-1206): the terminal
    inequalities' slack and dual updates, with gains built at the old x_N
    and applied with the trial's real dx_N, their feasibility (the slack
    test with the fraction-to-boundary slop of ipddp_solver.cpp:1667-1725),
    and the equalities' multiplier step. Returns (_Terminal at the trial,
    feasible (B,); None without terminal constraints)."""
    S_T, Y_T, mu = st["S_T"], st["Y_T"], st["mu"]
    if not (tstk.ineq_dim or tstk.eq_dim):
        return _Terminal(G_T=st["G_T"], S_T=S_T, Y_T=Y_T, h_T=tstk.eq_evaluate(x_last),
                         Lambda_T_eq=st["Lambda_T_eq"]), None
    feas = torch.ones_like(mu, dtype=torch.bool)
    S_T_new, Y_T_new, G_T_new = S_T, Y_T, st["G_T"]
    if tstk.ineq_dim:
        dx_last = x_last - st["X"][:, -1]
        cap = ric.max_ratio(S_T.dtype)
        k_s_T = -(tstk.ineq_evaluate(st["X"][:, -1]) + S_T)
        K_s_T = -tstk.ineq_jacobian(st["X"][:, -1])
        S_T_new = S_T + a_pr[:, None] * k_s_T + _mv(K_s_T, dx_last)
        ss = ric.s_safe(S_T, mu)
        ratio = torch.clamp(Y_T / ss, 0.0, cap)
        K_y_T = -(ratio[..., None] * K_s_T)
        k_y_T = torch.clamp((-(Y_T * S_T - mu[:, None]) - Y_T * k_s_T) / ss, -cap, cap)
        Y_T_new = Y_T + a_du[:, None] * k_y_T + _mv(K_y_T, dx_last)
        floor = torch.maximum((1.0 - tau)[:, None] * S_T,
                              torch.maximum(mu * 1e-3, mu.new_tensor(EPS_SLACK))[:, None])
        slop = (base.FTB_SLOP_FACTOR * torch.finfo(S_T.dtype).eps) * (
            1.0 + S_T.abs() + S_T_new.abs())
        feas = (((S_T_new > 0.0) & (S_T_new >= floor - slop)).all(-1)
                & base.ftb_ok(Y_T_new, Y_T, tau[:, None]).all(-1)
                & S_T_new.isfinite().all(-1) & Y_T_new.isfinite().all(-1))
        G_T_new = tstk.ineq_evaluate(x_last)
    lam_eq = st["Lambda_T_eq"] + a_pr[:, None] * bp.dLambda_T_eq
    feas = feas & lam_eq.isfinite().all(-1)
    return _Terminal(G_T=G_T_new, S_T=S_T_new, Y_T=Y_T_new, h_T=tstk.eq_evaluate(x_last),
                     Lambda_T_eq=lam_eq), feas


def _forward_pass(problem, options, stk, tstk, fc, soc_on_path, st, bp, alpha,
                  a_pr_max, a_du_max, events=None) -> _Trial:
    """Single-alpha interior-point rollout with the filter acceptance
    (ipddp_solver.cpp:1571-1876), with the terminal rows. Without path
    constraints and terminal inequalities (no barrier) tau is 1, and
    without a terminal equality either the trial is accepted by the Armijo
    ratio of the unconstrained DDP (ipddp.py:1222-1226)."""
    X, U, Y, S, Lambda, mu = st["X"], st["U"], st["Y"], st["S"], st["Lambda"], st["mu"]
    no_barrier = not stk and not tstk.ineq_dim
    tau = torch.ones_like(mu) if no_barrier else _tau(options, mu)
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
    tm, feas_T = _terminal_trial(tstk, st, bp, x_last, alpha_pr, alpha_du, tau)
    if feas_T is not None:
        feas = feas & feas_T

    phi = _barrier_merit(J, S_new, mu, tm)
    theta = _theta(options, G_new, S_new, tm)
    inf_pr, inf_comp = _primal_comp(G_new, S_new, Y_new, mu, tm)
    feas = (feas & phi.isfinite() & theta.isfinite() & inf_pr.isfinite()
            & inf_comp.isfinite())

    if no_barrier and not tstk.eq_dim:
        dJ = st["cost"] - J
        expected = -alpha_pr * (bp.dV[:, 0] + 0.5 * alpha_pr * bp.dV[:, 1])
        accept = torch.where(expected > 0.0, dJ / expected, torch.sign(dJ)) > 1e-6
    else:
        # Filter acceptance (ipddp_solver.cpp:1784-1839).
        fo = options.filter
        expected = alpha_pr * bp.dV[:, 0]
        f_mf, f_cv, nonempty = flt.back(st["filt"])
        cv_old = torch.where(nonempty, f_cv, torch.zeros_like(f_cv))
        high_ref = torch.where(nonempty, f_cv, st["filter_theta"])
        merit_old = st["merit"]
        br1 = theta > fo.max_violation_threshold
        acc1 = theta < (1 - fo.violation_acceptance_threshold) * high_ref
        br2 = ((torch.maximum(theta, cv_old) < fo.min_violation_for_armijo_check)
               & (expected < 0))
        acc2 = phi < merit_old + fo.armijo_constant * expected
        acc3 = ((phi < merit_old - fo.merit_acceptance_threshold * theta)
                | (theta < (1 - fo.violation_acceptance_threshold) * cv_old))
        accept = torch.where(br1, acc1, torch.where(br2, acc2, acc3))
    return _Trial(
        success=feas & accept, cost=J, merit=phi, theta=theta, inf_pr=inf_pr,
        inf_comp=inf_comp, X=torch.cat([X[:, :1], X_tail], 1), U=U_new, Y=Y_new,
        S=S_new, G=G_new, Lambda=torch.cat([Lam_head, lam_last[:, None]], 1),
        S_T=tm.S_T, Y_T=tm.Y_T, G_T=tm.G_T, Lambda_T_eq=tm.Lambda_T_eq, h_T=tm.h_T,
        alpha_pr=alpha_pr)


def _line_search(problem, options, stk, tstk, fc, soc_on_path, st, bp, search,
                 events=None):
    """The alpha ladder for the instances in ``search``: the first success
    in ladder order, or with ``enable_parallel`` the best merit among the
    successes. Returns (selected trial, any success)."""
    a_pr_max, a_du_max = _max_step_sizes(st["S"], st["Y"], bp.dS, bp.dY, st["mu"],
                                         options, st["S_T"], st["Y_T"], bp.dS_T, bp.dY_T)
    trials = []
    found = torch.zeros_like(search)
    sel = None
    for a in line_search_alphas(options.line_search):
        if not options.enable_parallel and not bool((search & ~found).any()):
            break
        r = _forward_pass(problem, options, stk, tstk, fc, soc_on_path, st, bp, a,
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


def _initialize(problem, options, stk, U0, trajectory_warm=False, tstk=None):
    """Cold start (ipddp_solver.cpp:820-914): X rolled open-loop from U0,
    slacks and duals from the path values, zero costates, mu0 =
    mu_initial, or max(tolerance / 10, mu_min_value) for a problem without
    any constraint (``_cold_mu``, ipddp.py:1371-1374). ``trajectory_warm``
    (a warm start from a given U0 without a solver state, ipddp.py:1406-1428)
    tiers mu0 per instance by the seed's largest path and
    terminal-inequality violation. ``tstk`` is the problem's
    TerminalStacker (built here when None). Returns (X, U, Y, S, G,
    Lambda, mu0); the terminal constraints' state is
    ``initialize_terminal``'s."""
    x0 = problem.x0
    tstk = TerminalStacker(problem) if tstk is None else tstk
    kernel = options.backward_engine != "scan"
    X = ip_rollout.open_loop_rollout(problem.model, x0, U0, problem.timestep,
                                     kernel=kernel)
    b = options.ipddp.barrier
    unconstrained = not (stk or tstk.ineq_dim or tstk.eq_dim)
    mu0 = torch.full((x0.shape[0],), max(options.tolerance / 10.0, b.mu_min_value)
                     if unconstrained else b.mu_initial, dtype=x0.dtype, device=x0.device)
    G = _eval_path(stk, X, U0)
    if trajectory_warm and not unconstrained:
        mu0 = _tiered_mu(options, G, tstk, X)
    Y, S = _init_dual_slack(G, mu0, options)
    Lambda = X.new_zeros(X.shape)
    return X, U0, Y, S, G, Lambda, mu0


def _tiered_mu(options, G, tstk, X):
    """The trajectory-warm mu0 (ipddp.py:1413-1428): tolerance where the
    seed is feasible to it, 1% of mu_initial (floored at 10 tolerance)
    where no row is violated by more than 0.1, else 10% of mu_initial."""
    viol = ric.maxabs(torch.clamp(G, min=0.0).flatten(1))
    if tstk.ineq_dim:
        viol = torch.maximum(viol, torch.clamp(tstk.ineq_evaluate(X[:, -1]), min=0.0).amax(-1))
    tol, b = options.tolerance, options.ipddp.barrier
    c = lambda v: viol.new_tensor(v)  # noqa: E731
    return torch.where(viol <= tol, c(max(tol, b.mu_min_value)), torch.where(
        viol <= 0.1, c(max(tol * 10.0, b.mu_initial * 0.01)), c(b.mu_initial * 0.1)))


def initialize_terminal(problem, options, tstk, X, mu0, slack_scale=None, dual_scale=None):
    """The terminal constraints' cold state at X's x_N (ipddp.py:1435-1446):
    s_T = max(terminal_slack_init_scale, -g_T + offset), y_T = mu0
    terminal_dual_init_scale / max(s_T, eps), zero equality multipliers.
    ``slack_scale`` and ``dual_scale`` replace the two terminal scales (the
    x0-drift reset takes the path ones, ipddp.py:1476-1483). Returns (S_T
    (B, mT), Y_T (B, mT), Lambda_T_eq (B, p))."""
    ip = options.ipddp
    slack_scale = ip.terminal_slack_init_scale if slack_scale is None else slack_scale
    dual_scale = ip.terminal_dual_init_scale if dual_scale is None else dual_scale
    lam = X.new_zeros(X.shape[0], tstk.eq_dim)
    if not tstk.ineq_dim:
        return lam[:, :0], lam[:, :0], lam
    G_T = tstk.ineq_evaluate(X[:, -1])
    S_T = torch.maximum(G_T.new_tensor(slack_scale), -G_T + SLACK_INTERIOR_OFFSET)
    Y_T = (mu0[:, None] * dual_scale) / torch.maximum(S_T, S_T.new_tensor(EPS_SLACK))
    return S_T, Y_T, lam


def _interior(v, floor, factor):
    """repairWarmstartInterior (ipddp_solver.cpp:233-262): v floored, and
    scaled by ``factor`` where the smallest entry of its last axis (one
    step's rows, or the terminal rows) sits within ``factor`` of the
    floor."""
    if v.numel() == 0:
        return v
    v = torch.clamp(v, min=floor)
    near = v.amin(-1, keepdim=True) < floor * factor
    return torch.where(near, v * factor, v)


def warm_start(problem, options, stk, tstk, U0, state: IPDDPSolverState):
    """The warm start from a solver state (ipddp.py:1448-1545, :1563-1571):
    X re-rolled from U0 as in a cold start, the state's duals, slacks,
    costates, terminal state and gains kept, mu0 = 0.1 mu_initial; whole
    steps whose duals or slacks are stale re-initialised
    (``warmstart_staleness_check``), the interior repair
    (``warmstart_repair``), and the x0-drift reset
    (``warmstart_reset_x0_threshold`` > 0), which restarts an instance
    cold from zero controls where x0 moved further than the threshold from
    the state's. Returns (X, U, Y, S, G, Lambda, mu0, terminal, k_u0,
    K_u0)."""
    ip = options.ipddp
    X, U, _, _, G, _, _ = _initialize(problem, options, stk, U0)
    mu0 = torch.full_like(X[:, 0, 0], ip.barrier.mu_initial * 0.1)
    Y, S, Lambda = state.Y, state.S, state.Lambda
    S_T, Y_T, Lte = state.S_T, state.Y_T, state.Lambda_T_eq
    if ip.warmstart_staleness_check:
        # warmstartNeedsReinit (:264-292): a step is stale when any of its
        # rows is.
        required = torch.maximum(G.new_tensor(ip.slack_var_init_scale),
                                 -G + SLACK_INTERIOR_OFFSET)
        bad = ((Y <= EPS_DUAL) | (S <= EPS_SLACK) | (S < 0.1 * required)
               | ~torch.isfinite(Y) | ~torch.isfinite(S)).any(-1, keepdim=True)
        Y_new, S_new = _init_dual_slack(G, mu0, options)
        Y, S = torch.where(bad, Y_new, Y), torch.where(bad, S_new, S)
    if ip.warmstart_repair:
        f = ip.warmstart_interior_factor
        S = _interior(S, ip.warmstart_s_min, f)
        Y = _interior(Y, ip.warmstart_y_min, f)
        S_T = _interior(S_T, ip.warmstart_s_min, f)
        Y_T = _interior(Y_T, ip.warmstart_y_min, f)
    k_u, K_u = state.k_u, state.K_u
    if ip.warmstart_reset_x0_threshold > 0.0:
        reset = torch.linalg.vector_norm(problem.x0 - state.x0, dim=-1) > float(
            ip.warmstart_reset_x0_threshold)
        cold = _initialize(problem, options, stk, torch.zeros_like(U0))
        mu_c = cold[6]
        term_c = initialize_terminal(problem, options, tstk, cold[0], mu_c,
                                     ip.slack_var_init_scale, ip.dual_var_init_scale)
        sel = lambda c, w: base.where_instances(reset, c, w)  # noqa: E731
        X, U, Y, S, G = (sel(c, w) for c, w in zip(cold[:5], (X, U, Y, S, G)))
        Lambda = sel(torch.zeros_like(Lambda), Lambda)
        S_T, Y_T = sel(term_c[0], S_T), sel(term_c[1], Y_T)
        Lte = sel(torch.zeros_like(Lte), Lte)
        mu0 = sel(mu_c, mu0)
        k_u, K_u = sel(torch.zeros_like(k_u), k_u), sel(torch.zeros_like(K_u), K_u)
    return X, U, Y, S, G, Lambda, mu0, (S_T, Y_T, Lte), k_u, K_u


def solver_state(problem, sol: Solution) -> IPDDPSolverState:
    """The checkpoint a solve leaves (ipddp.py:1998-2002), from its
    batch-first Solution on any engine: the last backward's gains, the
    stacked duals and slacks, the costates, the terminal state and x0."""
    stk, tstk = PathStacker(problem), TerminalStacker(problem)
    X = sol.state_trajectory

    def cat(d, names, *lead):
        return (torch.cat([d[n] for n in names], -1) if names
                else X.new_zeros(X.shape[0], *lead, 0))

    td, ts = sol.terminal_duals or {}, sol.terminal_slacks or {}
    N = problem.horizon
    return IPDDPSolverState(
        k_u=sol.feedforward_gains, K_u=sol.feedback_gains,
        Y=cat(sol.dual_trajectories, stk.names, N),
        S=cat(sol.slack_trajectories, stk.names, N),
        Lambda=sol.costate_trajectory, Y_T=cat(td, tstk.ineq_names),
        S_T=cat(ts, tstk.ineq_names), Lambda_T_eq=cat(td, tstk.eq_names), x0=problem.x0)


def _drive(problem: Problem, options: CDDPOptions, X, U, Y, S, G, Lambda, mu0,
           ku0, Ku0, events=None, terminal=None) -> Solution:
    """The IPDDP iteration driver from an initialized batch (ipddp.py:1576-
    2032), with or without path constraints, and both terminal regimes.
    Without path constraints and terminal inequalities there is no barrier
    (``no_barrier``): mu stays at mu0, and the convergence tests read
    inf_pr and inf_du alone (ipddp.py:1729-1735, :1821-1838, :1903-1912).
    ``terminal`` is (S_T, Y_T, Lambda_T_eq) from ``initialize_terminal``;
    None takes the cold one at X's x_N.

    ``events``, a dict, receives per-instance (B,) bool flags of the stall
    latch's branches for checks that must reach them: "soc_replaced" (a
    trial's slack SOC replaced a slack), "folded" (a backward's
    constraint-Hessian fold was nonzero), "stall_armed" (the detector armed
    the latch at a commit), "fail_armed" (a failed line search at the
    regularization limit armed it), "dropped" (a failed line search near
    feasibility switched the SOC off), and at the end the latch's final
    "soc_on" and "soc_armed"."""
    stk, tstk = PathStacker(problem), TerminalStacker(problem)
    has_path, has_ti, has_te = bool(stk), tstk.ineq_dim > 0, tstk.eq_dim > 0
    no_barrier = not has_path and not has_ti
    N = problem.horizon
    Bsz, dtype, device = X.shape[0], X.dtype, X.device
    ip = options.ipddp
    tol = options.tolerance
    fc = ip_rollout.resolve_ip_forward(problem, options, stk)
    soc_on_path = has_path and soc_traced(options, stk)
    # The stall detector runs where "auto" traces the SOC or the fold.
    auto_latch = bool(stk) and stk.has_curved and (
        ip.slack_soc == "auto" or ip.use_constraint_hessians == "auto")
    if events is not None:
        for name in ("soc_replaced", "folded", "stall_armed", "fail_armed", "dropped"):
            events[name] = torch.zeros(Bsz, dtype=torch.bool, device=device)
    S_T, Y_T, Lambda_T_eq = (initialize_terminal(problem, options, tstk, X, mu0)
                             if terminal is None else terminal)
    tm0 = _Terminal(G_T=tstk.ineq_evaluate(X[:, -1]), S_T=S_T, Y_T=Y_T,
                    h_T=tstk.eq_evaluate(X[:, -1]), Lambda_T_eq=Lambda_T_eq)

    # resetFilter (ipddp_solver.cpp:2484-2524): with terminal constraints
    # the filter starts with the initial point.
    cost = problem.objective.evaluate(X, U)
    mu = mu0
    inf_pr, inf_comp = _primal_comp(G, S, Y, mu, tm0)
    merit = _barrier_merit(cost, S, mu, tm0)
    filter_theta = torch.clamp(_theta(options, G, S, tm0), min=1e-8)
    filt = flt.empty_filter(Bsz, ip.max_filter_size + 2, dtype, device)
    if has_ti or has_te:
        filt, _ = flt.accept_entry(filt, merit, filter_theta)
    zeros = X.new_zeros(Bsz)
    st = dict(
        X=X, U=U, Y=Y, S=S, G=G, Lambda=Lambda, mu=mu, cost=cost, merit=merit,
        phi=merit, filter_theta=filter_theta, filt=filt,
        G_T=tm0.G_T, S_T=S_T, Y_T=Y_T, Lambda_T_eq=Lambda_T_eq,
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

    def backward(reg):
        tm = _Terminal(G_T=st["G_T"], S_T=st["S_T"], Y_T=st["Y_T"],
                       h_T=tstk.eq_evaluate(st["X"][:, -1]), Lambda_T_eq=st["Lambda_T_eq"])
        if has_te:
            return _backward_terminal_eq(problem, options, stk, tstk, st["X"], st["U"],
                                         st["Y"], st["S"], st["G"], tm, st["mu"], reg)
        return _backward_condensed(problem, options, stk, st["X"], st["U"], st["Y"], st["S"],
                                   st["G"], st["mu"], reg, st["soc_armed"], (tstk, tm))

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
            trial = backward(reg)
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
        if no_barrier:
            early = live & (st["inf_pr"] < tol) & (st["inf_du"] < tol)
        else:
            tol_e = torch.maximum(st["mu"].new_tensor(tol), ip.barrier_tol_mult * st["mu"])
            early = (live & (st["inf_pr"] < tol_e) & (st["inf_du"] < tol_e)
                     & (st["inf_comp"] < tol_e)
                     & (st["alpha_pr"].abs() * st["step_norm"] < tol * 10.0))
        status = torch.where(early, Status.OPTIMAL_SOLUTION_FOUND, status)
        search = live & ~early
        done = done | fail_bp | early
        if not bool(search.any()):
            continue

        r, found = _line_search(problem, options, stk, tstk, fc, soc_on_path, st, bp,
                                search, events)
        ok = search & found
        fail = search & ~found

        # Commit (ipddp.py:1788-1895): the trial, the barrier and filter
        # update, then the convergence test under the new mu.
        dJ = st["cost"] - r.cost
        mu_old = st["mu"]
        mu_new = (mu_old if no_barrier
                  else _barrier_update(options, mu_old, r.inf_pr, st["inf_du"], r.inf_comp))
        tm_r = _Terminal(G_T=r.G_T, S_T=r.S_T, Y_T=r.Y_T, h_T=r.h_T,
                         Lambda_T_eq=r.Lambda_T_eq)
        filter_theta = torch.clamp(_theta(options, r.G, r.S, tm_r), min=1e-8)
        reset = (mu_new < mu_old) & (mu_new > 0.0)
        kept, _ = flt.accept_entry(st["filt"], r.merit, filter_theta)
        kept = flt.select(flt.size(kept) > ip.max_filter_size, flt.prune_to_best(kept),
                          kept)
        cleared = flt.clear(st["filt"])
        if has_ti or has_te:
            # The cleared filter is reseeded with the committed point (:1335).
            cleared, _ = flt.accept_entry(cleared, r.merit, filter_theta)
        inf_pr_c, inf_comp_c = _primal_comp(r.G, r.S, r.Y, mu_new, tm_r)
        merit_c = _barrier_merit(r.cost, r.S, mu_new, tm_r)
        atol = options.acceptable_tolerance
        accept_tol = math.sqrt(atol)
        if no_barrier:
            # The JAX driver's second acceptable clause (0 < dJ < atol, with
            # the same it and residual tests) lies inside the first.
            conv_opt = (inf_pr_c < tol) & (st["inf_du"] < tol)
            acc = (inf_pr_c < accept_tol) & (st["inf_du"] < accept_tol) & (it > 50)
        else:
            tol2 = torch.maximum(mu_new.new_tensor(tol), ip.barrier_tol_mult * mu_new)
            step_small = st["step_norm"] < tol * 10.0
            conv_opt = ((inf_pr_c < tol2) & (st["inf_du"] < tol2) & (inf_comp_c < tol2)
                        & step_small)
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
            G_T=r.G_T, S_T=r.S_T, Y_T=r.Y_T, Lambda_T_eq=r.Lambda_T_eq,
            alpha_pr=r.alpha_pr, reg=base.decrease_regularization(st["reg"], options),
            mu=mu_new, filt=flt.select(reset, cleared, kept), phi=merit_c,
            filter_theta=filter_theta, merit=merit_c, inf_pr=inf_pr_c,
            inf_comp=inf_comp_c)
        status = torch.where(ok & conv_opt, Status.OPTIMAL_SOLUTION_FOUND,
                             torch.where(ok & conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND,
                                         status))
        done = done | (ok & (conv_opt | conv_acc))

        # Line-search failure (handleForwardPassFailure, :2037-2082); a
        # terminal equality doubles the increase, unless there is no
        # barrier (ipddp.py:1900).
        reg_n = base.increase_regularization(st["reg"], options)
        if has_te and not no_barrier:
            reg_n = base.increase_regularization(reg_n, options)
        limit = base.regularization_limit_reached(reg_n, options)
        if no_barrier:
            accept_tol = math.sqrt(max(atol, tol))
            acceptable = ((atol > 0) & (st["inf_pr"] < accept_tol)
                          & (st["inf_du"] < accept_tol))
        else:
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
        dual_trajectories=stk.split(st["Y"]) if has_path else None,
        slack_trajectories=stk.split(st["S"]) if has_path else None,
        costate_trajectory=st["Lambda"],
        barrier_mu=st["mu"],
        inf_pr=st["inf_pr"],
        inf_comp=st["inf_comp"],
        **terminal_fields(tstk, st["S_T"], st["Y_T"], st["Lambda_T_eq"]),
    )


def terminal_fields(tstk, S_T, Y_T, Lambda_T_eq) -> dict:
    """The Solution's terminal maps (ipddp.py:2000-2004): duals of the
    inequalities and multipliers of the equalities by name, and the
    inequalities' slacks by name; None without terminal constraints."""
    if not (tstk.ineq_dim or tstk.eq_dim):
        return dict(terminal_duals=None, terminal_slacks=None)
    return dict(terminal_duals={**tstk.split_ineq(Y_T), **tstk.split_eq(Lambda_T_eq)},
                terminal_slacks=tstk.split_ineq(S_T))


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[torch.Tensor] = None,
    U0: Optional[torch.Tensor] = None,
    state: Optional[IPDDPSolverState] = None,
    return_state: bool = False,
):
    """Solve with IPDDP. ``problem.x0`` is (nx,) for one solve or (B, nx)
    for a batch; ``U0`` seeds the controls (X is rolled out from it, as
    the reference's start does; ``X0`` is accepted and unused). With
    ``options.warm_start``, a ``state`` from an earlier solve warm starts
    from its duals, slacks, costates and gains (``warm_start``), and
    without one a given ``U0`` tiers the initial barrier parameter by its
    violation. ``return_state=True`` also returns the
    :class:`IPDDPSolverState` the solve leaves (ipddp.py:2036-2082)."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp

    base.validate_options(options)
    validate_options(options)
    problem = base.canonicalize_problem_dtype(problem)
    stk, tstk = PathStacker(problem), TerminalStacker(problem)
    warm = state if options.warm_start else None
    trajectory_warm = bool(options.warm_start and state is None and U0 is not None)
    _, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    unbatched = problem.x0.dim() == 1
    if unbatched:
        problem = problem.replace(x0=problem.x0[None])
        U = U[None]
        if warm is not None:
            warm = IPDDPSolverState(*(t[None] for t in warm))

    whole = mega_ipddp.mega_eligible(problem, options)
    if options.solve_engine == "fused" and not whole:
        raise ValueError(
            "solve_engine='fused' requires a problem the whole-solve kernel "
            "takes: a registered model with an explicit integrator, the "
            "quadratic objective, a stack of control boxes, state boxes and "
            "keep-out balls with terminal constraints in a layout the kernel is "
            "built for, iLQR, the sequential line search and default driver "
            "options (see mega_ipddp.mega_eligible)"
        )
    if warm is not None:
        warm = IPDDPSolverState(*(t.to(U) for t in warm))
        X, U, Y, S, G, Lambda, mu0, terminal, ku0, Ku0 = warm_start(
            problem, options, stk, tstk, U, warm)
    else:
        X, U, Y, S, G, Lambda, mu0 = _initialize(problem, options, stk, U,
                                                 trajectory_warm, tstk)
        terminal = initialize_terminal(problem, options, tstk, X, mu0)
        ku0 = X.new_zeros(X.shape[0], N, nu)
        Ku0 = X.new_zeros(X.shape[0], N, nu, nx)
    if whole:
        sol = mega_ipddp.ipddp_solve(problem, options, X, U, Y, S, G, Lambda, mu0,
                                     ku0, Ku0, terminal=terminal)
    else:
        sol = _drive(problem, options, X, U, Y, S, G, Lambda, mu0, ku0, Ku0,
                     terminal=terminal)
    if not return_state:
        return sol.first() if unbatched else sol
    st = solver_state(problem, sol)
    if unbatched:
        return sol.first(), IPDDPSolverState(*(t[0] for t in st))
    return sol, st
