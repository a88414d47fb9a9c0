"""Whole-solve LogDDP: the complete batched relaxed log-barrier solve as one
CUDA kernel.

Replaces ``cddp_tpu/ops/pallas/mega_logddp.py::make_log_solve_kernel`` for
box-only path stacks, the quadratic cost (the goal, or a tracked
``reference_states``: the tracking variant, launcher suffix ``_track``,
``dispatch_log`` name ``logddp_solve_track``) and cold seeds. The kernel
(``ops/csrc/logddp_solve.cu``) gives each instance one thread that runs
``solvers/logddp.py::_drive`` for it: the initial cost, merit and violation;
per iteration the refresh of the nominal merit and violation under the
current barrier coefficient, the Jacobians and cost derivatives with the
barrier terms beta', beta'' of the box rows folded into the Q-expansion,
the gain solve with its regularization retries, the first-success
(merit, violation) line search, the barrier decay or x5 growth and the
convergence tests, with the status-4 quirk. Trajectories and gains live in
device memory, batch-last.

Its plain version is ``solvers/logddp.py::_drive``, which CPU tensors run.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.ops.kernels.mega_clddp import backward_retry_bound
from cddp_tpu_torch.ops.kernels.mega_ipddp import LOG_BOX_ROWS, box_solve_eligible
from cddp_tpu_torch.options import CDDPOptions, line_search_alphas
from cddp_tpu_torch.solution import Solution

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_double)] * 4
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def mega_eligible(problem, options: CDDPOptions) -> bool:
    """Static dispatch predicate (mega_logddp.py:756-789 of the JAX package,
    restricted to the slice and without its TPU scratch-memory gate):
    ``mega_ipddp.box_solve_eligible`` with LogDDP's ``lqr_backend``, at a
    horizon the kernel takes (``rollout.whole_horizon_ok``: the attitude
    trio's follows the JAX gate's)."""
    return (box_solve_eligible(problem, options, options.log_barrier.lqr_backend,
                               LOG_BOX_ROWS)
            and rollout_ops.whole_horizon_ok("logddp_solve", rollout_ops.lane_consts(problem),
                                             problem.horizon))


def _solve_cfg(options: CDDPOptions):
    """The solver options as the CUDA ``LogCfg`` struct reads them, every
    folded constant in double. ``log(delta)`` is taken here, in double, as
    the plain version takes it (``constraints/barrier.py``)."""
    reg, fo, lb = options.regularization, options.filter, options.log_barrier
    delta = lb.relaxed_log_barrier_delta
    return [
        options.tolerance, options.acceptable_tolerance, reg.initial_value,
        reg.update_factor, reg.max_value, reg.min_value, lb.barrier.mu_initial,
        lb.barrier.mu_update_factor, lb.barrier.mu_min_value, delta, 2.0 * delta,
        delta * delta, math.log(delta), fo.armijo_constant, fo.merit_acceptance_threshold,
        1.0 - fo.violation_acceptance_threshold, fo.max_violation_threshold,
        fo.min_violation_for_armijo_check,
    ]


def logddp_solve(problem, options: CDDPOptions, X, U, k0, K0) -> Solution:
    """Batch-first whole solve from X (B,N+1,nx), the open-loop rollout of U
    (B,N,nu) from x0, and the gains k0 (B,N,nu), K0 (B,N,nu,nx). CUDA
    tensors launch the kernel; CPU tensors run the plain driver."""
    from cddp_tpu_torch.solvers import logddp

    if X.device.type == "cpu":
        lane = rollout_ops.lane_consts(problem)
        dispatch_log.plain("logddp_solve" + lane.variant + lane.tag, X.shape[0])
        return logddp._drive(problem, options, X, U, k0, K0)
    return _launch(problem, options, X, U, k0, K0)


def _launch(problem, options, X0, U0, k0, K0) -> Solution:
    return launch_counting_work(problem, options, X0, U0, k0, K0)[0]


def launch_counting_work(problem, options, X0, U0, k0, K0):
    """Launch the kernel; returns (Solution, work (2, B)): each instance's
    backward attempts and trajectory sweeps (the nominal refresh, the
    line-search trials and the accepted trial's rewrite), which a roofline
    bound's operation count reads."""
    from cddp_tpu_torch.ops.kernels import build

    lane = rollout_ops.lane_consts(problem)
    rows = ip_rollout.box_rows(problem, PathStacker(problem))
    ins = (X0, U0, k0, K0)
    Bsz, N1, nx = X0.shape
    N, nu, m = N1 - 1, problem.control_dim, rows.m
    tag = build.dtype_tag("logddp_solve", ins, ((N + 1, nx), (N, nu), (N, nu), (N, nu, nx)))
    name = f"cddp_logddp_solve_{lane.entry.cuda_name}_m{m}{lane.variant}_{tag}"
    fn = build.function(name, _ARGTYPES)
    # The kernel updates its state in place: always fresh batch-last copies.
    X, U, k, K = (t.movedim(0, -1).clone(memory_format=torch.contiguous_format)
                  for t in ins)
    stats = X0.new_empty(10, Bsz)
    alphas = line_search_alphas(options.line_search)
    ints = (N, Bsz, rollout_ops.INTEGRATORS.index(lane.integrator), options.max_iterations,
            len(alphas), backward_retry_bound(options))
    err = fn(*(build.ptr(t) for t in (X, U, k, K, stats)), lane.refs_ptr(X0),
             build.doubles(lane.host),
             build.doubles(rows.host), build.doubles(_solve_cfg(options)),
             build.doubles(alphas), *ints, build.stream_ptr(X0.device))
    build.check(err, name)
    dispatch_log.launched("logddp_solve" + lane.variant + lane.tag, Bsz)
    return Solution(
        solver_name="LogDDP",
        status_code=stats[7].to(torch.int32),
        iterations_completed=stats[6].to(torch.int32),
        final_objective=stats[0],
        final_step_length=stats[5],
        final_regularization=stats[4],
        time_points=torch.arange(N + 1, dtype=X0.dtype, device=X0.device) * problem.timestep,
        state_trajectory=X.movedim(-1, 0),
        control_trajectory=U.movedim(-1, 0),
        feedback_gains=K.movedim(-1, 0),
        feedforward_gains=k.movedim(-1, 0),
        inf_du=stats[2],
        barrier_mu=stats[3],
        inf_pr=stats[1],
    ), stats[8:]
