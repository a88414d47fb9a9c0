"""Whole-solve IPDDP: the complete batched interior-point solve as one CUDA
kernel.

Replaces ``cddp_tpu/ops/pallas/mega_ipddp.py::make_solve_kernel`` for the
stacks its lane layout takes (``ip_rollout.box_rows`` with ``ball``):
control and state boxes and keep-out balls, in the layouts the kernel is
instantiated for (``solve_variant``); the
quadratic cost (the goal, or a tracked ``reference_states`` on the
``TRACK_LAYOUTS``: the tracking variant, launcher suffix ``_track``,
``dispatch_log`` name ``ipddp_solve_track``), terminal constraints on the
``TERMINAL_LAYOUTS`` (linear terminal inequalities, the terminal equality
x_N = target, or both: launcher suffixes ``_ti{mT}``, ``_te{p}``,
``_te{p}_ti{mT}``, built from ``ops/csrc/ipddp_solve_terminal.cu``, and
logged under the same suffixes, ``ipddp_solve_ti2`` for instance), costates
tracked, both barrier strategies and both theta norms. The kernel
(``ops/csrc/ipddp_solve.cuh``) gives each instance one thread that runs
``solvers/ipddp.py::_drive`` for it: the initial cost, merit and residuals;
per iteration the Jacobians and cost derivatives, the condensed backward
with its regularization retries, the fraction-to-boundary step caps, the
first-success filter line search, the barrier update with the fixed-size
filter and the convergence tests. On a ball stack it also runs the "auto"
stall latch: the armed constraint-Hessian fold, the armed slack SOC, the
stall detector and the latch's fail path. The trajectories, duals, slacks,
control gains and costate gains live in device memory (batch-last); the
dual and slack gains are recomputed from the control gains where they are
needed, as the JAX kernel does. The terminal inequalities' slacks and duals
and the equality's multipliers are per-instance state beside them, and the
constants A, b and the target one read-only array beside ``Consts``.

**Gauss-Newton cost lanes** (mega_ipddp.py:103-165, :603, :647-720 of the
JAX package). A residual objective whose class has a registered GN lane
(``register_gn_cost_lane``) runs the kernel with its cost as a template
policy: the running cost sum r^2 and the terminal cost sum r_T^2 + extra,
gradients 2 J'r, Hessians 2 J'J, the residual Jacobians one tangent column
at a time in forward mode (the lane's CUDA struct in its header, built by
``build.lane_library``). Its per-instance cost parameters cp (B, n_cp) are
one row per instance. The lane's kernel takes the model lane of the same
header on its control box (m = 2 nu), the goal form, no terminal
constraints, up to the JAX gate's horizon (``rollout.WHOLE_MAX_HORIZON``
under "ipddp_solve_gn", by the model's name and n_cp).

Its plain version is the per-pass driver ``solvers/ipddp.py::_drive``,
which CPU tensors run.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.costs.objective import QuadraticObjective
from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.ops.kernels.mega_clddp import backward_retry_bound
from cddp_tpu_torch.options import BarrierStrategy, CDDPOptions, line_search_alphas
from cddp_tpu_torch.solution import Solution

MAX_ALPHAS = 64  # the kernel's alpha-ladder capacity (ipddp_solve.cu)
# The kernel's filter slots (kFCap). An accepted entry joins at most
# max_filter_size kept ones, so max_filter_size <= 6 fits.
FILTER_SLOTS = 7
_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.POINTER(ctypes.c_double)] * 5
             + [ctypes.c_int] * 12 + [ctypes.c_void_p])
# Stats rows the kernel writes: cost, inf_pr, inf_du, inf_comp, mu, reg,
# alpha_pr, iterations, status, backward attempts, sweeps, and (ball
# variants only) the latch's final SOC-on and armed flags.
STATS_ROWS = 13
# A GN lane's launcher: the goal form's arguments, then cp (n_cp, B), n_cp
# and the lane's weights.
_GN_ARGTYPES = (_ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_double)] + [ctypes.c_void_p])
# Ball layouts kernel 7 is instantiated for, by model: (m, the ball's stack
# row). A control box and one keep-out ball, the ball's name sorted before
# the box's or after it.
BALL_LAYOUTS = {"unicycle": ((5, 0), (5, 4))}
# The layouts kernel 7 also has a tracking variant of (suffix "_track"), by
# model: the unicycle's box stacks and the ball's row first, the pendulum's
# control box.
TRACK_LAYOUTS = {"unicycle": ("m4", "m6", "m10", "m5_ball0"), "pendulum": ("m2",)}
# The terminal variants of kernel 7, by model and layout: (mT, p), the
# terminal inequality rows and terminal equality rows, suffix "_te{p}" then
# "_ti{mT}" (goal form only). A TerminalEqualityConstraint has p = nx: 3 on
# the unicycle, 6 on HCW (the rendezvous x_N = target).
TERMINAL_LAYOUTS = {"unicycle": {"m4": ((1, 0), (2, 0), (0, 3), (1, 3))},
                    "hcw": {"m6": ((0, 6),)}}
# The box-only stacks (m) the whole solves of IPDDP, MSIPDDP and LogDDP
# are instantiated for, by model, one table for each kernel: kernel 7
# (``IP_BOX_ROWS``, the goal form, and on TRACK_LAYOUTS the tracking form),
# kernel 8 (``MS_BOX_ROWS``) and kernel 9 (``LOG_BOX_ROWS``). A model with
# a box stack outside a kernel's table runs that solver per pass (IPDDP) or
# on its plain driver.
# - HCW's control box alone is in none: kernel 7 runs it in float32 at the
#   barrier merit's resolution, where it forks from the plain driver far
#   more often than the plain driver from itself (ROADMAP C.10); HCW runs
#   kernel 7 with the rendezvous's terminal equality (TERMINAL_LAYOUTS).
# - The quadrotors are in none: the JAX package's scratch-memory gates
#   refuse them at the horizons their users run (at the quadrotor golden's
#   N = 60 its whole IPDDP solve needs 104.1 MiB against a 12 MiB budget,
#   MSIPDDP 117.3 and LogDDP 40.0 against 10; QuadrotorRate is refused
#   already at N = 20). Those gates are not ported, so below about N = 10,
#   where JAX would admit QuadrotorRate, the two packages take different
#   routes to the same result (ROADMAP C.11).
# - The attitude trio's torque box (m = 6): kernel 9 takes all three (its
#   JAX gate admits them at the MPC horizon N = 20), kernel 8 none (its JAX
#   gate refuses them there: 15.6 and 18.2 MiB against 10), kernel 7 the
#   quaternion and MRP models: on the Euler model's box it agreed in
#   float32 with the plain driver on 96.78% of the plain driver's own
#   stable instances (ROADMAP C.12).
# - The other spacecraft models' control boxes (``rollout.SPACECRAFT_ROWS``)
#   up to the JAX gates' horizons (``rollout.WHOLE_MAX_HORIZON``): kernel 7
#   takes the nonlinear model's, kernel 9 the fuel model's; the other pairs
#   forked from their plain drivers in float32 or were held on too few
#   stable instances (kernel 7 on the two-body model; ROADMAP C.13). Kernel
#   8 takes none: its JAX gate refuses each at N = 20 (it would take them
#   below N = 9, 7, 15 and 13; ROADMAP C.11).
# - The small models' control boxes (``rollout.SMALL_ROWS``): all four
#   kernels up to the JAX gates' horizons (``rollout.WHOLE_MAX_HORIZON``),
#   goal form, but kernel 8 on the acrobot: in float64 over MS_EXACT_ITERS
#   iterations at N = 20 it agreed with the plain driver (statuses and
#   iterations on every instance) within 1e-8 on 99.19% of 4,096 instances,
#   below the 99.5% that kernel 8 is held to; on the same card the plain
#   driver itself agrees so with its run from x0 one ulp up on 99.37%
#   (``torch_tie_probe.py``; its filter ties, ROADMAP C.1, C.14), so the
#   acrobot's MSIPDDP runs the plain driver.
IP_BOX_ROWS = {"unicycle": (4, 6, 10), "pendulum": (2,), "quaternion_attitude": (6,),
               "mrp_attitude": (6,), "sc_nonlinear": (6,), **rollout_ops.SMALL_ROWS}
MS_BOX_ROWS = {"unicycle": (4, 6, 10), "pendulum": (2,),
               **{m: r for m, r in rollout_ops.SMALL_ROWS.items() if m != "acrobot"}}
LOG_BOX_ROWS = {"unicycle": (4, 6, 10), "pendulum": (2,),
                **{m: (6,) for m in rollout_ops.ATTITUDE_MODELS}, "sc_linear_fuel": (6,),
                **rollout_ops.SMALL_ROWS}


class GnCostSpec(NamedTuple):
    """A GN lane's structure (mega_ipddp.py:115-134 of the JAX package):
    ``n_cp`` parameters per instance. The residuals themselves are the CUDA
    struct's; their plain version is the objective's own
    ``running_residuals`` and ``terminal_residuals``, which the plain driver
    runs."""

    n_cp: int


class GnCostEntry(NamedTuple):
    """A resolved GN lane of one objective (mega_ipddp.py:137-147):
    ``cp_fn(objective)`` gives its parameters (n_cp,) or (B, n_cp);
    ``weights`` the constants its CUDA struct reads besides cp.
    ``gn_cost_lane`` fills in the registration's CUDA struct (``header``,
    ``struct``) and launcher ``name``."""

    cp_fn: Callable
    spec: GnCostSpec
    weights: Tuple[float, ...]
    header: Optional[Path] = None
    struct: Optional[str] = None
    name: Optional[str] = None

    def cp(self, objective, batch: int, like: torch.Tensor) -> torch.Tensor:
        """The parameters as (B, n_cp) in ``like``'s dtype and device."""
        return ip_rollout.lane_params(self.cp_fn(objective), batch, like)


# Exact objective class -> (factory, CUDA struct, launcher name).
_GN_COST_LANES = {}


def register_gn_cost_lane(cls, factory, *, header, struct, name):
    """Register a Gauss-Newton residual lane for an objective class (exact
    class): ``factory(objective)`` returns a :class:`GnCostEntry` (its
    CUDA fields unset), or None to decline; ``struct`` in ``header`` is its
    CUDA lane (``ipddp_solve.cuh``'s GN policy), ``name`` names its
    launchers."""
    _GN_COST_LANES[cls] = (factory, rollout_ops.CudaLane(Path(header).resolve(), struct),
                           name)


def gn_cost_lane(objective) -> Optional[GnCostEntry]:
    """The objective's resolved GN lane, or None."""
    reg = _GN_COST_LANES.get(type(objective))
    entry = None if reg is None else reg[0](objective)
    if entry is None:
        return None
    return entry._replace(weights=tuple(entry.weights), header=reg[1].header,
                          struct=reg[1].struct, name=reg[2])


def registered_gn_lanes(header) -> list:
    """The GN lanes [(name, struct)] registered with ``header``."""
    return [(name, cuda.struct) for _, cuda, name in _GN_COST_LANES.values()
            if cuda.header == Path(header).resolve()]


def gn_route(problem) -> Optional[GnCostEntry]:
    """The GN lane kernel 7 runs the problem with, or None: a registered GN
    lane, the model lane of its header with an explicit integrator on its
    control box alone (``ip_rollout.lane_box``), no terminal constraints,
    and a horizon the JAX gate takes (``WHOLE_MAX_HORIZON``)."""
    if isinstance(problem.objective, QuadraticObjective) or problem.terminal_constraints:
        return None
    gn = gn_cost_lane(problem.objective)
    if gn is None or ip_rollout.lane_box(problem, PathStacker(problem), gn.header) is None:
        return None
    lane = rollout_ops.lane_consts(problem, cost_lane=True)
    limit = rollout_ops.WHOLE_MAX_HORIZON["ipddp_solve_gn"].get(
        lane.entry.cuda_name, {}).get(gn.spec.n_cp) if lane is not None else None
    if limit is None or problem.horizon > limit:
        return None
    return gn


def _options_eligible(options: CDDPOptions, lqr_backend: str) -> bool:
    """The options every whole-solve kernel (7, 8, 9) requires."""
    return (
        options.use_ilqr
        and not options.enable_parallel
        and lqr_backend == "sequential"
        and options.backward_engine == "auto"
        and options.solve_engine != "xla"
        and not options.return_iteration_info
        and not options.verbose
        and not options.debug
        and options.max_cpu_time <= 0
        and options.max_iterations >= 1
        and options.regularization.update_factor > 1.0
        and len(line_search_alphas(options.line_search)) <= MAX_ALPHAS
    )


def driver_eligible(problem, options: CDDPOptions, lqr_backend: str) -> bool:
    """What the interior-point and log-barrier whole-solve kernels (7, 8, 9)
    all require of a problem besides its stack and terminal constraints: a
    registered model with an explicit integrator (never a discrete model:
    mega_ipddp.py:2559, mega_msipddp.py:1276 and mega_logddp.py:766 of the
    JAX package refuse one), the quadratic objective,
    iLQR with the sequential backward (``lqr_backend``) and line search, an
    alpha ladder that fits, and none of the driver features the kernels do
    not model."""
    lane = rollout_ops.lane_consts(problem)
    return (
        lane is not None
        and not lane.entry.discrete
        and isinstance(problem.objective, QuadraticObjective)
        and _options_eligible(options, lqr_backend)
    )


def box_solve_eligible(problem, options: CDDPOptions, lqr_backend: str, table) -> bool:
    """What the MSIPDDP and LogDDP whole-solve kernels (8, 9) require:
    ``driver_eligible``, no terminal constraints (mega_msipddp.py:1281-1284,
    mega_logddp.py:773 of the JAX package) and a box-only path stack of a
    size the kernel is built for (``table``: kernel 8's ``MS_BOX_ROWS`` or
    kernel 9's ``LOG_BOX_ROWS``)."""
    lane = rollout_ops.lane_consts(problem)
    rows = ip_rollout.box_rows(problem, PathStacker(problem))
    return (not problem.terminal_constraints
            and lane is not None and rows is not None
            and rows.m in table.get(lane.entry.cuda_name, ())
            and driver_eligible(problem, options, lqr_backend))


def solve_variant(problem, ball: bool = True):
    """Kernel 7's launcher suffix for the problem's stack, objective and
    terminal constraints, or None when the kernel is not instantiated for
    them: "m{m}" for a box stack of a size in ``IP_BOX_ROWS``,
    "m{m}_ball{row}" for a layout of ``BALL_LAYOUTS``, each followed by
    "_track" for a tracking objective on a layout of ``TRACK_LAYOUTS``, or
    by "_te{p}" and "_ti{mT}" for terminal constraints of a shape in
    ``TERMINAL_LAYOUTS``; box stacks without terminal constraints only
    without ``ball``."""
    lane = rollout_ops.lane_consts(problem)
    rows = ip_rollout.box_rows(problem, PathStacker(problem), ball=ball)
    if lane is None or rows is None:
        return None
    if problem.terminal_constraints:
        return None if not ball else _terminal_variant(problem, lane, rows)
    name, balls = lane.entry.cuda_name, rows.ball_rows
    layout = None
    if not balls and rows.m in IP_BOX_ROWS.get(name, ()):
        layout = f"m{rows.m}"
    elif len(balls) == 1 and (rows.m, balls[0]) in BALL_LAYOUTS.get(name, ()):
        layout = f"m{rows.m}_ball{balls[0]}"
    if layout is None or (lane.refs is not None
                          and layout not in TRACK_LAYOUTS.get(name, ())):
        return None
    return layout + lane.variant


def _terminal_variant(problem, lane, rows):
    """The terminal suffix of a goal-form box stack (``solve_variant``)."""
    tstk = TerminalStacker(problem)
    shape = (tstk.ineq_dim, tstk.eq_dim)
    layout = f"m{rows.m}"
    if (rows.ball_rows or lane.refs is not None
            or shape not in TERMINAL_LAYOUTS.get(lane.entry.cuda_name, {}).get(layout, ())):
        return None
    return (layout + (f"_te{tstk.eq_dim}" if tstk.eq_dim else "")
            + (f"_ti{tstk.ineq_dim}" if tstk.ineq_dim else ""))


def mega_eligible(problem, options: CDDPOptions) -> bool:
    """Static dispatch predicate (mega_ipddp.py:2536-2598 of the JAX package,
    restricted to the slice and without its TPU scratch-memory gates): a
    lane stack and terminal constraints of a layout the kernel is built for
    (``solve_variant``: a nonempty path stack, as mega_ipddp.py:2568 of the
    JAX package requires; terminal equalities are TerminalEqualityConstraint
    rows, the only equality type ``TerminalStacker`` takes),
    ``driver_eligible``, no IPDDP option the kernel does not model
    (explicit ``slack_soc=True`` or ``use_constraint_hessians=True``: the
    kernel carries only the "auto" latch), a filter that fits the
    kernel's slots, and a horizon the kernel takes
    (``rollout.whole_horizon_ok``: the attitude trio's follows the JAX
    gate's)."""
    ip = options.ipddp
    if not isinstance(problem.objective, QuadraticObjective):
        return (gn_route(problem) is not None
                and _options_eligible(options, ip.lqr_backend)
                and ip.slack_soc is not True
                and ip.use_constraint_hessians is not True
                and not ip.check_state_stationarity
                and ip.max_filter_size < FILTER_SLOTS)
    return (
        solve_variant(problem) is not None
        and driver_eligible(problem, options, ip.lqr_backend)
        and ip.slack_soc is not True
        and ip.use_constraint_hessians is not True
        and not ip.check_state_stationarity
        and ip.max_filter_size < FILTER_SLOTS
        and rollout_ops.whole_horizon_ok("ipddp_solve", rollout_ops.lane_consts(problem),
                                         problem.horizon)
    )


def _solve_cfg(options: CDDPOptions):
    """The solver options as the CUDA ``SolveCfg`` struct reads them; every
    constant the driver folds from two options is folded here in double."""
    reg, ip, fo = options.regularization, options.ipddp, options.filter
    b = ip.barrier
    tol, atol = options.tolerance, options.acceptable_tolerance
    f = b.mu_update_factor
    return [
        tol, atol, reg.initial_value, reg.update_factor, reg.max_value,
        reg.min_value, f, 0.1 * f, 0.3 * f, 0.6 * f, b.mu_update_power,
        max(b.mu_min_value, tol / 100.0), b.mu_min_value,
        b.min_fraction_to_boundary, ip.barrier_tol_mult,
        ip.barrier_update_dual_weight, ip.mu_kappa_epsilon, fo.armijo_constant,
        fo.merit_acceptance_threshold, 1 - fo.violation_acceptance_threshold,
        fo.max_violation_threshold, fo.min_violation_for_armijo_check,
        math.sqrt(atol), max(b.mu_min_value * 100.0, tol / 10.0), tol * 10.0,
        math.sqrt(max(atol, tol)), 100.0 * tol, ip.jacobian_regularization_value,
        ip.jacobian_regularization_exponent,
    ]


def dispatch_name(problem) -> str:
    """The name a launch of the problem's variant logs in ``dispatch_log``:
    "ipddp_solve", with "_track" for a tracking objective, or the terminal
    suffix ("_ti2", "_te3", "_te3_ti1", ...) of a terminal variant, then the
    model's tag ("ipddp_solve_te6@hcw")."""
    gn = gn_route(problem)
    if gn is not None:
        return f"ipddp_solve_{gn.name}" + rollout_ops.model_entry(problem.model).tag
    variant = solve_variant(problem) or ""
    lane = rollout_ops.lane_consts(problem)
    if problem.terminal_constraints:
        return "ipddp_solve" + variant[variant.index("_"):] + lane.tag
    return "ipddp_solve" + lane.variant + lane.tag


def ipddp_solve(problem, options: CDDPOptions, X, U, Y, S, G, Lambda, mu0, ku0,
                Ku0, terminal=None) -> Solution:
    """Batch-first whole solve from the initialized batch (``_initialize``):
    X/Lambda (B,N+1,nx), U (B,N,nu), Y/S/G (B,N,m), mu0 (B,), ku0 (B,N,nu),
    Ku0 (B,N,nu,nx), and ``terminal`` = (S_T (B,mT), Y_T (B,mT),
    Lambda_T_eq (B,p)) from ``ipddp.initialize_terminal`` (None: the cold
    one). CUDA tensors launch the kernel; CPU tensors run the plain
    driver."""
    from cddp_tpu_torch.solvers import ipddp

    if X.device.type == "cpu":
        dispatch_log.plain(dispatch_name(problem), X.shape[0])
        return ipddp._drive(problem, options, X, U, Y, S, G, Lambda, mu0, ku0, Ku0,
                            terminal=terminal)
    return _launch(problem, options, X, U, Y, S, G, Lambda, mu0, ku0, Ku0, terminal)


def _launch(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0,
            terminal=None) -> Solution:
    return _run(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0, terminal)[0]


def launch_counting_work(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0,
                         terminal=None):
    """Launch the kernel; returns (Solution, work (2, B)): each instance's
    backward attempts and trajectory sweeps (line-search trials and the
    accepted trial's rewrite), which a roofline bound's operation count
    reads."""
    sol, stats = _run(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0, terminal)
    return sol, stats[9:11]


def launch_with_latch(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0):
    """Launch a ball variant of the kernel; returns (Solution, soc_on (B,),
    soc_armed (B,)): the stall latch's final state, as the plain driver's
    ``events`` give it."""
    if "_ball" not in (solve_variant(problem) or ""):
        raise ValueError("launch_with_latch: the stack has no keep-out ball")
    sol, stats = _run(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0)
    return sol, stats[11] > 0.5, stats[12] > 0.5


def _terminal_consts(tstk, like):
    """The terminal constants the kernel reads beside Consts, one array:
    the inequalities' A (mT, nx) row-major and b (mT), then the equality's
    target (p)."""
    parts = [c.A.reshape(-1) for _, c in tstk.ineq_items]
    parts += [c.b for _, c in tstk.ineq_items]
    parts += [c.target_state for _, c in tstk.eq_items]
    return torch.cat([t.to(like) for t in parts])


def _run(problem, options, X0, U0, Y0, S0, G0, L0, mu0, ku0, Ku0, terminal=None):
    from cddp_tpu_torch.ops.kernels import build
    from cddp_tpu_torch.solvers import ipddp

    stk, tstk = PathStacker(problem), TerminalStacker(problem)
    gn = gn_route(problem)
    lane = rollout_ops.lane_consts(problem, cost_lane=gn is not None)
    rows = ip_rollout.box_rows(problem, stk, ball=True)
    has_ball = bool(rows.ball_rows)
    ins = (X0, U0, Y0, S0, G0, L0, ku0, Ku0, mu0)
    Bsz, N1, nx = X0.shape
    N, nu, m = N1 - 1, problem.control_dim, Y0.shape[-1]
    tag = build.dtype_tag("ipddp_solve", ins, (
        (N + 1, nx), (N, nu), (N, m), (N, m), (N, m), (N + 1, nx), (N, nu),
        (N, nu, nx), ()))
    if gn is None:
        name = f"cddp_ipddp_solve_{lane.entry.cuda_name}_{solve_variant(problem)}_{tag}"
        fn = build.function(name, _ARGTYPES)
    else:
        name = f"cddp_ipddp_solve_{lane.entry.cuda_name}_{gn.name}_m{m}_{tag}"
        fn = build.function(name, _GN_ARGTYPES, gn.header)
    # The kernel updates its state in place: always fresh batch-last copies.
    last = lambda t: t.movedim(0, -1).clone(memory_format=torch.contiguous_format)  # noqa: E731
    X, U, Y, S, G, L, k, K = (last(t) for t in ins[:8])
    if terminal is None:
        terminal = ipddp.initialize_terminal(problem, options, tstk, X0, mu0)
    S_T, Y_T, Lte = (last(t) for t in terminal)
    term_c = _terminal_consts(tstk, X0) if problem.terminal_constraints else None
    dlam = X0.new_empty(tstk.eq_dim, Bsz)  # the multiplier step, kernel scratch
    klam = X0.new_empty(N + 1, nx, Bsz)
    Klam = X0.new_empty(N + 1, nx, nx, Bsz)
    stats = X0.new_empty(STATS_ROWS, Bsz)
    stats[4] = mu0
    alphas = line_search_alphas(options.line_search)
    ip = options.ipddp
    # The latch's words (mega_ipddp.py::_make_cfg): traced on ball stacks
    # only, as the JAX kernel's latch_traced.
    ints = (N, Bsz, rollout_ops.INTEGRATORS.index(lane.integrator),
            options.max_iterations, len(alphas), backward_retry_bound(options),
            int(ip.barrier.strategy == BarrierStrategy.ADAPTIVE),
            int(ip.theta_norm == "l2"), ip.max_filter_size,
            int(has_ball and ip.slack_soc == "auto"),
            int(has_ball and ip.use_constraint_hessians == "auto"),
            ip.soc_stall_iterations)
    opt_ptr = lambda t: None if t is None or t.numel() == 0 else build.ptr(t)  # noqa: E731
    # A GN lane's kernel takes each instance's cost parameters batch-last,
    # (n_cp, B), and the lane's weights, after the goal form's arguments.
    gn_args = () if gn is None else (
        build.ptr(cp := gn.cp(problem.objective, Bsz, X0).movedim(0, -1).contiguous()),
        cp.shape[0], build.doubles(gn.weights))
    err = fn(*(build.ptr(t) for t in (X, U, Y, S, G, L, k, K, klam, Klam, stats)),
             lane.refs_ptr(X0), *(opt_ptr(t) for t in (term_c, S_T, Y_T, Lte, dlam)),
             build.doubles(lane.host), build.doubles(rows.host),
             build.doubles(rows.ball), build.doubles(_solve_cfg(options)), build.doubles(alphas),
             *ints, *gn_args, build.stream_ptr(X0.device))
    build.check(err, name)
    dispatch_log.launched(dispatch_name(problem), Bsz)
    Yb, Sb = Y.movedim(-1, 0), S.movedim(-1, 0)
    return Solution(
        solver_name="IPDDP",
        status_code=stats[8].to(torch.int32),
        iterations_completed=stats[7].to(torch.int32),
        final_objective=stats[0],
        final_step_length=stats[6],
        final_regularization=stats[5],
        time_points=torch.arange(N + 1, dtype=X0.dtype, device=X0.device) * problem.timestep,
        state_trajectory=X.movedim(-1, 0),
        control_trajectory=U.movedim(-1, 0),
        feedback_gains=K.movedim(-1, 0),
        feedforward_gains=k.movedim(-1, 0),
        inf_du=stats[2],
        dual_trajectories=stk.split(Yb),
        slack_trajectories=stk.split(Sb),
        costate_trajectory=L.movedim(-1, 0),
        barrier_mu=stats[4],
        inf_pr=stats[1],
        inf_comp=stats[3],
        **ipddp.terminal_fields(tstk, S_T.movedim(-1, 0), Y_T.movedim(-1, 0),
                                Lte.movedim(-1, 0)),
    ), stats
