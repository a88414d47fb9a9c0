"""Whole-solve CLDDP: the complete batched solve as one CUDA kernel.

Replaces ``cddp_tpu/ops/pallas/mega_clddp.py::make_solve_kernel``. The
kernel (``ops/csrc/clddp_solve.cu``) gives each problem instance one thread
that runs the whole solve: the initial cost; per iteration the analytic
Jacobians and quadratic-cost derivatives, the Riccati/BoxQP backward with
its regularization retries, the Armijo alpha ladder (sequential first
success, or best merit with ``enable_parallel``), and the acceptance,
regularization and convergence driver. Per-instance control flow replaces
the Pallas kernel's lane masks; finished instances simply stop.

A tracking objective (``reference_states``) launches the tracking variant
(launcher suffix ``_track``, ``dispatch_log`` name ``clddp_solve_track``),
which reads step t's running reference from the shared (N, nx) rows of
``rollout.LaneConsts.refs``.

Its plain version is the per-pass driver ``solvers/clddp.py::_solve``,
which CPU tensors run.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cddp_tpu_torch.ops.boxqp import enum_applies
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.options import CDDPOptions, line_search_alphas
from cddp_tpu_torch.solution import Solution

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_double)] * 2
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def mega_eligible(problem, options: CDDPOptions) -> bool:
    """Static dispatch predicate (mega_clddp.py:821-865 of the JAX package,
    without its TPU scratch-memory gate): a registered model with an explicit
    integrator the kernel is instantiated for (``rollout.CLDDP_MODELS``;
    never a discrete model, mega_clddp.py:843) at a horizon it takes
    (``rollout.whole_horizon_ok``: the attitude trio's follows the JAX
    gate's), the
    quadratic objective (the goal or a tracked ``reference_states``,
    mega_clddp.py:825,884), a control box with the enum BoxQP, and none of
    the driver features the kernel does not model."""
    return (
        problem.get_constraint("ControlConstraint") is not None
        and enum_applies(options.box_qp, problem.control_dim)
        and (lane := rollout_ops.lane_consts(problem)) is not None
        and lane.clddp
        and not lane.entry.discrete
        and options.solve_engine != "xla"
        and options.backward_engine != "scan"
        and not options.return_iteration_info
        and not options.verbose
        and not options.debug
        and options.max_cpu_time <= 0
        and options.max_iterations >= 1
        # update_factor <= 1 never reaches the regularization limit, so the
        # retry loop would have no bound.
        and options.regularization.update_factor > 1.0
        and rollout_ops.whole_horizon_ok("clddp_solve", lane, problem.horizon)
    )


def backward_retry_bound(options: CDDPOptions) -> int:
    """Worst-case backward attempts in one iteration: increases until the
    limit fires, from the lowest regularization an iteration can start at
    (mega_clddp.py:267-300)."""
    reg = options.regularization
    floor = max(min(reg.initial_value, reg.min_value), 1e-300)
    return int(math.ceil(math.log(reg.max_value / floor)
                         / math.log(reg.update_factor))) + 2


def _solve_cfg(options: CDDPOptions):
    reg, ls = options.regularization, options.line_search
    return [
        options.tolerance, options.acceptable_tolerance,
        options.filter.armijo_constant, reg.initial_value, reg.update_factor,
        reg.max_value, reg.min_value, options.termination_scaling_max_factor,
        ls.initial_step_size, ls.step_reduction_factor, ls.min_step_size,
    ]


def clddp_solve(problem, options: CDDPOptions, X0, U0, k0, K0) -> Solution:
    """Batch-first whole solve from the seeds X0 (B,N+1,nx), U0/k0 (B,N,nu),
    K0 (B,N,nu,nx). The rollouts start from X0[:, 0], which equals x0 on
    every input ``solve`` builds. CUDA tensors launch the kernel; CPU
    tensors run the plain driver."""
    from cddp_tpu_torch.solvers import clddp

    if X0.device.type == "cpu":
        lane = rollout_ops.lane_consts(problem)
        dispatch_log.plain("clddp_solve" + lane.variant + lane.tag, X0.shape[0])
        return clddp._solve(problem, options, X0, U0, k0, K0)
    return _launch(problem, options, X0, U0, k0, K0)


def _launch(problem, options, X0, U0, k0, K0) -> Solution:
    return launch_counting_work(problem, options, X0, U0, k0, K0)[0]


def launch_counting_work(problem, options, X0, U0, k0, K0):
    """Launch the kernel; returns (Solution, work (2, B)): each instance's
    backward attempts and rollouts (line-search trials and the accepted
    step's rewrite), which a roofline bound's operation count reads."""
    from cddp_tpu_torch.ops.kernels import build

    ins = (X0, U0, k0, K0)
    consts = rollout_ops.lane_consts(problem)
    Bsz, N1, nx = X0.shape
    N, nu = N1 - 1, problem.control_dim
    tag = build.dtype_tag("clddp_solve", ins, (
        (N + 1, nx), (N, nu), (N, nu), (N, nu, nx)))
    name = f"cddp_clddp_solve_{consts.entry.cuda_name}{consts.variant}_{tag}"
    fn = build.function(name, _ARGTYPES)
    # The kernel updates X, U, k, K in place: always fresh batch-last copies.
    X, U, k, K = (t.movedim(0, -1).clone(memory_format=torch.contiguous_format)
                  for t in ins)
    stats = X0.new_empty(8, Bsz)
    ints = (N, Bsz, rollout_ops.INTEGRATORS.index(consts.integrator),
            options.max_iterations, len(line_search_alphas(options.line_search)),
            backward_retry_bound(options), int(options.enable_parallel))
    err = fn(*(build.ptr(t) for t in (X, U, k, K, stats)), consts.refs_ptr(X0),
             build.doubles(consts.host), build.doubles(_solve_cfg(options)),
             *ints, build.stream_ptr(X0.device))
    build.check(err, name)
    dispatch_log.launched("clddp_solve" + consts.variant + consts.tag, Bsz)
    return Solution(
        solver_name="CLDDP",
        status_code=stats[5].to(torch.int32),
        iterations_completed=stats[4].to(torch.int32),
        final_objective=stats[0],
        final_step_length=stats[3],
        final_regularization=stats[2],
        time_points=torch.arange(N + 1, dtype=X0.dtype,
                                 device=X0.device) * problem.timestep,
        state_trajectory=X.movedim(-1, 0),
        control_trajectory=U.movedim(-1, 0),
        feedback_gains=K.movedim(-1, 0),
        feedforward_gains=k.movedim(-1, 0),
        inf_du=stats[1],
    ), stats[6:]
