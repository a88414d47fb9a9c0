"""Solver option trees (port of ``cddp_tpu/options.py``).

Field names and defaults mirror the JAX package, which mirrors the
reference structs — defaults are behaviour there (``max_iterations = 1``,
``tolerance = 1e-5``). Options are static configuration: plain frozen
dataclasses.

Not carried over: ``matmul_precision``. Its replacement is a fixed rule —
the port never enables TF32, so float32 matrix products stay exact float32
(``torch.get_float32_matmul_precision() == "highest"``, PyTorch's default).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class LineSearchOptions:
    """``options.hpp:41-52``."""

    max_iterations: int = 11
    initial_step_size: float = 1.0
    min_step_size: float = 1e-8
    step_reduction_factor: float = 0.5


@dataclass(frozen=True)
class RegularizationOptions:
    """``options.hpp:58-68``."""

    initial_value: float = 1e-6
    update_factor: float = 10.0
    max_value: float = 1e7
    min_value: float = 1e-10
    step_initial_value: float = 1.0


class BarrierStrategy(enum.Enum):
    """Barrier update strategy (``options.hpp:28-33``)."""

    ADAPTIVE = "adaptive"
    MONOTONIC = "monotonic"
    IPOPT = "ipopt"


@dataclass(frozen=True)
class BarrierOptions:
    """``SolverSpecificBarrierOptions`` (``options.hpp:73-88``)."""

    mu_initial: float = 1e-0
    mu_min_value: float = 1e-10
    mu_update_factor: float = 0.5
    mu_update_power: float = 1.2
    min_fraction_to_boundary: float = 0.99
    strategy: BarrierStrategy = BarrierStrategy.ADAPTIVE


@dataclass(frozen=True)
class FilterOptions:
    """``SolverSpecificFilterOptions`` (``options.hpp:93-108``). CLDDP reads
    only ``armijo_constant``."""

    merit_acceptance_threshold: float = 1e-6
    violation_acceptance_threshold: float = 1e-6
    max_violation_threshold: float = 1e4
    min_violation_for_armijo_check: float = 1e-7
    armijo_constant: float = 1e-4


@dataclass(frozen=True)
class LogBarrierOptions:
    """``options.hpp:135-143``. ``use_relaxed_log_barrier_penalty`` is
    print-only in the reference (LogDDP always evaluates the relaxed
    barrier); ``lqr_backend`` "parallel" is refused by the solver."""

    use_relaxed_log_barrier_penalty: bool = False
    relaxed_log_barrier_delta: float = 1e-10
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    lqr_backend: str = "sequential"


@dataclass(frozen=True)
class IPDDPOptions:
    """``IPDDPAlgorithmOptions`` (``options.hpp:148-185``), with the JAX
    package's additions under the same names and defaults.

    ``forward_engine``: "auto" runs the interior-point forward kernel on
    CUDA tensors of eligible problems (its plain version on CPU tensors);
    "scan" keeps the generic plain forward pass. ``slack_soc`` and
    ``use_constraint_hessians`` are "auto", True or False: "auto" traces the
    slack SOC and the constraint-Hessian fold on stacks with a curved item
    (a ball, a pole, a cone, a norm), behind the stall latch that arms them
    after ``soc_stall_iterations`` stalled commits (``solvers/ipddp.py::
    stall_detector_update``); on affine stacks it leaves both off. Fields
    the port does not honour yet (``check_state_stationarity``,
    ``lqr_backend="parallel"``, the warm-start fields, which ``warm_start``
    gates) are refused by the solver.
    """

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier_tol_mult: float = 0.1
    barrier_update_dual_weight: float = 0.01
    mu_kappa_epsilon: float = 10.0
    check_state_stationarity: bool = False
    theta_norm: str = "l1"
    max_filter_size: int = 5
    theta_0_floor: float = 1.0
    warmstart_repair: bool = False
    warmstart_s_min: float = 1e-4
    warmstart_y_min: float = 1e-4
    warmstart_interior_factor: float = 1.1
    warmstart_staleness_check: bool = True
    warmstart_reset_x0_threshold: float = -1.0
    jacobian_regularization_value: float = 1e-8
    jacobian_regularization_exponent: float = 0.25
    terminal_dual_init_scale: float = 1e-1
    terminal_slack_init_scale: float = 1e-2
    terminal_constraint_tolerance: float = 1e-6
    slack_soc: object = "auto"
    use_constraint_hessians: object = "auto"
    soc_stall_iterations: int = 8
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    lqr_backend: str = "sequential"
    forward_engine: str = "auto"


@dataclass(frozen=True)
class MultiShootingOptions:
    """``options.hpp:120-130``."""

    segment_length: int = 5
    rollout_type: str = "nonlinear"
    use_controlled_rollout: bool = False
    costate_var_init_scale: float = 1e-6


@dataclass(frozen=True)
class MSIPDDPOptions(MultiShootingOptions):
    """``MSIPDDPAlgorithmOptions`` = the interior-point fields plus the
    inherited :class:`MultiShootingOptions` (``options.hpp:113-131,190``),
    with the JAX package's additions under the same names and defaults.
    ``rollout_type`` is "nonlinear", "hybrid" or "dense". Warm starts
    (``warmstart_staleness_check`` reads only them) and ``lqr_backend``
    "parallel" or "sharded" are refused by the solver."""

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    warmstart_staleness_check: bool = True
    lqr_backend: str = "sequential"


@dataclass(frozen=True)
class BoxQPOptions:
    """``boxqp.hpp:30-41``. Only the exact enumeration solver is ported:
    ``method`` must resolve to "enum" (``"auto"`` does for n <= enum_max_dim)."""

    max_iterations: int = 100
    min_gradient_norm: float = 1e-8
    min_relative_improvement: float = 1e-8
    step_decrease_factor: float = 0.6
    min_step_size: float = 1e-22
    armijo_constant: float = 0.1
    verbose: bool = False
    max_ls_iterations: int = 99
    method: str = "auto"
    enum_max_dim: int = 4


@dataclass(frozen=True)
class CDDPOptions:
    """Top-level options (``options.hpp:208-251``).

    ``backward_engine``: "auto" (and, for IPDDP, "fused") runs the CUDA
    backward and rollout kernels on CUDA tensors (their plain versions on
    CPU tensors); "scan" forces the plain PyTorch passes everywhere.
    ``solve_engine``: "auto" runs the solver's whole-solve kernel when its
    ``mega_eligible`` holds (``ops/kernels/mega_clddp.py``,
    ``mega_ipddp.py``, ``mega_logddp.py``, ``mega_msipddp.py``); "xla" keeps
    the per-pass driver (the name is the JAX package's); "fused" asserts
    eligibility.
    """

    tolerance: float = 1e-5
    acceptable_tolerance: float = 1e-6
    max_iterations: int = 1
    max_cpu_time: float = 0.0
    verbose: bool = False
    debug: bool = False
    print_solver_header: bool = False
    print_solver_options: bool = False
    use_ilqr: bool = True
    enable_parallel: bool = False
    num_threads: int = 1
    backward_engine: str = "auto"
    solve_engine: str = "auto"
    return_iteration_info: bool = False
    warm_start: bool = False
    termination_scaling_max_factor: float = 100.0

    line_search: LineSearchOptions = field(default_factory=LineSearchOptions)
    regularization: RegularizationOptions = field(
        default_factory=RegularizationOptions
    )
    box_qp: BoxQPOptions = field(default_factory=BoxQPOptions)
    filter: FilterOptions = field(default_factory=FilterOptions)
    log_barrier: LogBarrierOptions = field(default_factory=LogBarrierOptions)
    ipddp: IPDDPOptions = field(default_factory=IPDDPOptions)
    msipddp: MSIPDDPOptions = field(default_factory=MSIPDDPOptions)

    def replace(self, **kw) -> "CDDPOptions":
        return dataclasses.replace(self, **kw)


def line_search_alphas(opts: LineSearchOptions) -> Tuple[float, ...]:
    """Geometric alpha ladder with min-step tail
    (``detail::buildLineSearchAlphas``, cddp_context_utils.cpp:37-57)."""
    alphas = []
    a = opts.initial_step_size
    for i in range(max(1, opts.max_iterations)):
        alphas.append(a)
        a *= opts.step_reduction_factor
        if a < opts.min_step_size and i < opts.max_iterations - 1:
            alphas.append(opts.min_step_size)
            break
    if not alphas:
        alphas.append(opts.initial_step_size)
    return tuple(alphas)
