"""Shared solver machinery (port of ``cddp_tpu/solvers/base.py``).

Batch-first: trajectories are (B, N+1, nx) / (B, N, nu) and per-instance
scalars are (B,) tensors.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch

from cddp_tpu_torch.ops.linalg import true_div
from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.problem import Problem


def discrete_jacobians(problem: Problem, X, U):
    """A_t = I + dt*Fx, B_t = dt*Fu of the continuous dynamics for every
    step (cddp_solver_base.cpp:319-358): the linearization is Euler whatever
    integrator rolls the trajectory. Returns (B, N, nx, nx), (B, N, nx, nu),
    row-major: forward-mode AD gives its Jacobians column-major, and the
    condensed backward kernel reads a block's values evenly spaced."""
    dt, N, nx, nu = problem.timestep, problem.horizon, problem.state_dim, problem.control_dim
    Bsz = X.shape[0]
    t = (torch.arange(N, dtype=X.dtype, device=X.device) * dt).repeat(Bsz)
    Fx, Fu = problem.model.jacobians(
        X[:, :-1].reshape(-1, nx), U.reshape(-1, nu), t
    )
    eye = torch.eye(nx, dtype=X.dtype, device=X.device)
    A = dt * Fx + eye
    return (A.reshape(Bsz, N, nx, nx).contiguous(),
            (dt * Fu).reshape(Bsz, N, nx, nu).contiguous())


def running_cost_derivatives(problem: Problem, X, U):
    """(lx, lu, lxx, luu, lux) stacked over the horizon: step t's running
    reference (a tracking objective's row t) against X[:, t]."""
    x, steps = X[:, :-1], slice(0, U.shape[1])
    lx, lu = problem.objective.running_cost_gradients(x, U, steps)
    lxx, luu, lux = problem.objective.running_cost_hessians(x, U, steps)
    return lx, lu, lxx, luu, lux


def where_instances(mask, a, b):
    """Per-instance select of batch-first tensors: ``a`` where ``mask`` (B,)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def select_instances(mask, a: NamedTuple, b: NamedTuple):
    """Per-instance select of two NamedTuples of batch-first tensors."""
    return type(a)(*(where_instances(mask, x, y) for x, y in zip(a, b)))


def compute_cost(problem: Problem, X, U):
    """Total objective (cddp_solver_base.cpp:416-425)."""
    return problem.objective.evaluate(X, U)


def increase_regularization(reg, options: CDDPOptions):
    """cddp_core.cpp:308-316."""
    return torch.clamp(reg * options.regularization.update_factor,
                       max=options.regularization.max_value)


def decrease_regularization(reg, options: CDDPOptions):
    """cddp_core.cpp:318-326."""
    return torch.clamp(true_div(reg, options.regularization.update_factor),
                       min=options.regularization.min_value)


def regularization_limit_reached(reg, options: CDDPOptions):
    """cddp_core.cpp:328-331."""
    return reg >= options.regularization.max_value


# Knife-edge slop multiplier for the fraction-to-boundary re-check; the
# CUDA kernels (ops/csrc/ipddp_step.cuh) use the same factor, so every engine
# resolves boundary ties alike.
FTB_SLOP_FACTOR = 16.0


def ftb_ok(v_new, v_old, tau):
    """Fraction-to-boundary re-check ``v_new >= (1 - tau) * v_old`` with a
    rounding-scale slop on the boundary (base.py:111-133 of the JAX
    package, bit for bit): at an alpha-capped rung the binding row lands on
    the bound exactly, and the slop makes that tie accept on every engine.
    ``tau`` broadcasts against ``v_new``."""
    eps = torch.finfo(v_new.dtype).eps
    slop = (FTB_SLOP_FACTOR * eps) * (1.0 + v_old.abs() + v_new.abs())
    return (v_new > 0.0) & (v_new >= (1.0 - tau) * v_old - slop)


class LineSearchSelection(NamedTuple):
    index: torch.Tensor  # selected alpha index (B,)
    success: torch.Tensor  # any alpha succeeded (B,)


def select_forward_result(success, merit, enable_parallel: bool
                          ) -> LineSearchSelection:
    """Which alpha's rollout to commit, per instance, from (B, n_alpha)
    flags and merits: the first success in ladder order, or with
    ``enable_parallel`` the lowest merit among successes (the first minimum
    wins ties) (cddp_solver_base.cpp:256-287)."""
    if enable_parallel:
        idx = torch.where(success, merit, torch.full_like(merit, float("inf"))).argmin(-1)
    else:
        idx = success.int().argmax(-1)
    return LineSearchSelection(index=idx, success=success.any(-1))


def kkt_scaling(norm_Vx, horizon, state_dim, options: CDDPOptions):
    """Dual-infeasibility scaling (clddp_solver.cpp:197-201):
    s = max(s_max, |Vx|_1/(H*nx)) / s_max. NaN propagates."""
    s_max = options.termination_scaling_max_factor
    return true_div(torch.maximum(true_div(norm_Vx, horizon * state_dim),
                                  norm_Vx.new_tensor(s_max)), s_max)


def canonicalize_problem_dtype(problem: Problem) -> Problem:
    """Cast every floating-point tensor of the problem to ``x0``'s dtype:
    the solve dtype is x0's (base.py:338 of the JAX package)."""
    dtype = problem.x0.dtype
    if not dtype.is_floating_point:
        return problem

    def cast(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(dtype)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: cast(getattr(v, f.name)) for f in dataclasses.fields(v)
            })
        if isinstance(v, dict):
            return {k: cast(c) for k, c in v.items()}
        return v

    model = problem.model
    if any(t.is_floating_point() and t.dtype != dtype
           for t in [*model.parameters(), *model.buffers()]):
        model = copy.deepcopy(model).to(dtype)
    return dataclasses.replace(
        problem, model=model, objective=cast(problem.objective),
        constraints=cast(problem.constraints),
        terminal_constraints=cast(problem.terminal_constraints),
    )


_ENGINE_CHOICES = {
    "backward_engine": ("auto", "scan", "fused"),
    "solve_engine": ("auto", "xla", "fused"),
}

# Driver features of the JAX package that this port does not carry yet:
# option -> its default. A non-default value raises instead of being ignored.
_UNPORTED = {
    "verbose": False,
    "debug": False,
    "print_solver_header": False,
    "print_solver_options": False,
    "return_iteration_info": False,
    "max_cpu_time": 0.0,
}


def require_box_stack(problem: Problem, solver: str) -> None:
    """Refuse path constraints other than control and state boxes: the
    LogDDP and MSIPDDP drivers on such stacks (plain only, as in the JAX
    package) are ROADMAP A, slice 4 item 10."""
    from cddp_tpu_torch.ops.kernels.ip_rollout import row_kind

    others = sorted(name for name, c in problem.constraints.items() if row_kind(c) is None)
    if others:
        raise NotImplementedError(
            f"{solver} with path constraints other than control and state boxes "
            f"({', '.join(others)}) is not yet ported to cddp_tpu_torch "
            f"(ROADMAP A, slice 4 item 10)")


def validate_options(options: CDDPOptions) -> None:
    """Reject typo'd engine selectors and options the port does not honour."""
    for name, choices in _ENGINE_CHOICES.items():
        value = getattr(options, name)
        if value not in choices:
            raise ValueError(f"options.{name} must be one of {choices}, got {value!r}")
    for name, default in _UNPORTED.items():
        if getattr(options, name) != default:
            raise NotImplementedError(
                f"options.{name}={getattr(options, name)!r} is not yet ported "
                "to cddp_tpu_torch"
            )
