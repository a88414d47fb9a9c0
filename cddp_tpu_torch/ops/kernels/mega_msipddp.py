"""Whole-solve MSIPDDP: the complete batched multiple-shooting interior-point
solve as one CUDA kernel.

Replaces ``cddp_tpu/ops/pallas/mega_msipddp.py::make_ms_solve_kernel`` for
box-only path stacks (m > 0), the quadratic cost (the goal, or a tracked
``reference_states``: the tracking variant, launcher suffix ``_track``,
``dispatch_log`` name ``msipddp_solve_track``) and cold seeds, with all
three barrier strategies and all three gap-closing rollouts. The kernel
(``ops/csrc/msipddp_solve.cu``) gives each instance one thread that runs
``solvers/msipddp.py::_drive`` for it: per iteration the defect-aware
condensed backward with unclipped y/s and its regularization retries, the
first-success line search whose single rollout pass closes the segment
gaps and collects the fraction-to-boundary feasibility of every dual step
of the ladder as one bit mask, the MSIPDDP filter acceptance, the commit
with the sd-scaled convergence tests, restoration before regularization on
failure, and the barrier update with the filter reset. X, U, Y, S, F, the
costates and the control gains live in device memory (batch-last); the
dual and slack gains are recomputed from (y, s, g, mu) and the control gains
where they are needed, as the JAX kernel does.

Its plain version is ``solvers/msipddp.py::_drive``, which CPU tensors run.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.ops.kernels.mega_clddp import backward_retry_bound
from cddp_tpu_torch.ops.kernels.mega_ipddp import MS_BOX_ROWS, box_solve_eligible
from cddp_tpu_torch.options import BarrierStrategy, CDDPOptions, line_search_alphas
from cddp_tpu_torch.solution import Solution

STRATEGIES = (BarrierStrategy.ADAPTIVE, BarrierStrategy.MONOTONIC, BarrierStrategy.IPOPT)
ROLLOUT_TYPES = ("nonlinear", "hybrid", "dense")  # the kernel's kRoll* order
_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.POINTER(ctypes.c_double)] * 4
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def mega_eligible(problem, options: CDDPOptions) -> bool:
    """Static dispatch predicate (mega_msipddp.py:1266-1302 of the JAX
    package, restricted to the slice and without its TPU scratch-memory
    gate): ``mega_ipddp.box_solve_eligible`` with MSIPDDP's
    ``lqr_backend`` on the kernel's own table (``MS_BOX_ROWS``), a rollout
    type the kernel knows, and a horizon the kernel takes
    (``rollout.whole_horizon_ok``: the small models' follows the JAX
    gate's). Terminal constraints are declined."""
    ms = options.msipddp
    if options.solve_engine == "xla" or rollout_ops.lane_consts(problem) is None:
        return False
    # The JAX predicate builds a TerminalStacker here, so an unsupported
    # terminal type raises its TypeError before the stack is looked at.
    TerminalStacker(problem)
    return (box_solve_eligible(problem, options, ms.lqr_backend, MS_BOX_ROWS)
            and ms.rollout_type in ROLLOUT_TYPES
            and rollout_ops.whole_horizon_ok("msipddp_solve", rollout_ops.lane_consts(problem),
                                             problem.horizon))


def _solve_cfg(options: CDDPOptions, n_sd: int):
    """The solver options as the CUDA ``MsCfg`` struct reads them; every
    constant the driver folds from two options is folded here in double.
    ``n_sd`` is m N + nu N, the count the sd scaling divides by."""
    reg, fo, b = options.regularization, options.filter, options.msipddp.barrier
    tol, atol = options.tolerance, options.acceptable_tolerance
    f = b.mu_update_factor
    return [
        tol, atol, reg.initial_value, reg.update_factor, reg.max_value, reg.min_value,
        f, f * 0.1, f * 0.3, f * 0.6, b.mu_update_power, b.mu_min_value,
        b.min_fraction_to_boundary, tol / 10.0, tol / 100.0, fo.armijo_constant,
        fo.merit_acceptance_threshold, 1.0 - fo.violation_acceptance_threshold,
        fo.min_violation_for_armijo_check, math.sqrt(atol), tol * 10.0, float(n_sd),
    ]


def msipddp_solve(problem, options: CDDPOptions, X, U, Y, S, G, F, Lambda, mu0, ku0,
                  Ku0):
    """Batch-first whole solve from a prepared batch (``_initialize``):
    X (B,N+1,nx), U (B,N,nu), Y/S/G (B,N,m), F/Lambda (B,N,nx), mu0 (B,),
    ku0 (B,N,nu), Ku0 (B,N,nu,nx). Returns (Solution, MSIPDDPSolverState).
    CUDA tensors launch the kernel; CPU tensors run the plain driver."""
    from cddp_tpu_torch.solvers import msipddp

    if X.device.type == "cpu":
        lane = rollout_ops.lane_consts(problem)
        dispatch_log.plain("msipddp_solve" + lane.variant + lane.tag, X.shape[0])
        return msipddp._drive(problem, options, X, U, Y, S, G, F, Lambda, mu0, ku0, Ku0)
    return _launch(problem, options, X, U, Y, S, G, F, Lambda, mu0, ku0, Ku0)


def _launch(problem, options, X0, U0, Y0, S0, G0, F0, L0, mu0, ku0, Ku0):
    return launch_counting_work(problem, options, X0, U0, Y0, S0, G0, F0, L0, mu0, ku0,
                                Ku0)[:2]


def launch_counting_work(problem, options, X0, U0, Y0, S0, G0, F0, L0, mu0, ku0, Ku0):
    """Launch the kernel; returns (Solution, MSIPDDPSolverState, work (4, B)):
    each instance's count of each kind of pass, which a roofline bound's
    operation count reads: backward attempts, line-search trials (each with
    the whole dual-step ladder), commits (the accepted trial rewritten with
    its one dual step) and nominal resets (the initial one and each filter
    reset). G0 is recomputed from X0, U0 in the kernel and not read."""
    from cddp_tpu_torch.ops.kernels import build
    from cddp_tpu_torch.solvers.msipddp import MSIPDDPSolverState

    stk = PathStacker(problem)
    lane = rollout_ops.lane_consts(problem)
    rows = ip_rollout.box_rows(problem, stk)
    ins = (X0, U0, Y0, S0, F0, L0, ku0, Ku0, mu0)
    Bsz, N1, nx = X0.shape
    N, nu, m = N1 - 1, problem.control_dim, rows.m
    tag = build.dtype_tag("msipddp_solve", ins, (
        (N + 1, nx), (N, nu), (N, m), (N, m), (N, nx), (N, nx), (N, nu), (N, nu, nx), ()))
    name = f"cddp_msipddp_solve_{lane.entry.cuda_name}_m{m}{lane.variant}_{tag}"
    fn = build.function(name, _ARGTYPES)
    # The kernel updates its state in place: always fresh batch-last copies.
    X, U, Y, S, F, L, k, K = (t.movedim(0, -1).clone(memory_format=torch.contiguous_format)
                              for t in ins[:8])
    ms = options.msipddp
    hybrid = ms.rollout_type == "hybrid"
    kl = X0.new_empty(N, nx, Bsz)
    Kl = X0.new_empty(N, nx, nx, Bsz)
    # The hybrid rollout reads the backward's Jacobians at the nominal point.
    A = X0.new_empty((N, nx, nx, Bsz) if hybrid else (1,))
    Bm = X0.new_empty((N, nx, nu, Bsz) if hybrid else (1,))
    stats = X0.new_empty(13, Bsz)
    stats[4] = mu0
    alphas = line_search_alphas(options.line_search)
    ints = (N, Bsz, rollout_ops.INTEGRATORS.index(lane.integrator), options.max_iterations,
            len(alphas), backward_retry_bound(options), STRATEGIES.index(ms.barrier.strategy),
            ms.segment_length, ROLLOUT_TYPES.index(ms.rollout_type))
    err = fn(*(build.ptr(t) for t in (X, U, Y, S, F, L, k, K, kl, Kl, A, Bm, stats)),
             lane.refs_ptr(X0), build.doubles(lane.host), build.doubles(rows.host),
             build.doubles(_solve_cfg(options, m * N + nu * N)), build.doubles(alphas),
             *ints, build.stream_ptr(X0.device))
    build.check(err, name)
    dispatch_log.launched("msipddp_solve" + lane.variant + lane.tag, Bsz)
    Xb, Ub, Yb, Sb, Fb, Lb, kb, Kb = (t.movedim(-1, 0) for t in (X, U, Y, S, F, L, k, K))
    sol = Solution(
        solver_name="MSIPDDP",
        status_code=stats[8].to(torch.int32),
        iterations_completed=stats[7].to(torch.int32),
        final_objective=stats[0],
        final_step_length=stats[6],
        final_regularization=stats[5],
        time_points=torch.arange(N + 1, dtype=X0.dtype, device=X0.device) * problem.timestep,
        state_trajectory=Xb,
        control_trajectory=Ub,
        feedback_gains=Kb,
        feedforward_gains=kb,
        inf_du=stats[2],
        dual_trajectories=stk.split(Yb),
        slack_trajectories=stk.split(Sb),
        costate_trajectory=Lb,
        barrier_mu=stats[4],
        inf_pr=stats[1],
        inf_comp=stats[3],
    )
    return sol, MSIPDDPSolverState(k_u=kb, K_u=Kb, Y=Yb, S=Sb, Lambda=Lb, F=Fb), stats[9:]
