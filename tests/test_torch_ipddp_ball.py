"""The IPDDP keep-out-obstacle fleet (``bench_ipddp_fleet.py:38-55``: the
unicycle, a control box and a keep-out ball, m = 5) through the port's
entry points on CPU against the JAX package's vmapped ``_drive`` (float64,
rtol = atol = 1e-8 on X, U, k, K, Y, S, Lambda, cost, inf_pr, inf_du,
inf_comp, mu, reg and alpha_pr; statuses and iteration counts exact), seeded
as tests/test_mega_ipddp.py::TestBallStackParity seeds it, with the default
"auto" stall latch. Cases reach each of the latch's branches, which the
plain driver's ``events`` show; a max-thrust stack runs the plain driver
only. Also the dispatch: which stacks and options reach kernels 5, 6 and 7,
and the solvers that refuse a ball; and the ``unicycle_obstacle_ipddp``
golden."""

import dataclasses
import functools
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints import path as jpath
from cddp_tpu_torch.constraints import path
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.models import Unicycle
from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp
from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
from cddp_tpu_torch.options import LineSearchOptions, RegularizationOptions
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import ipddp
import test_mega_ipddp
from test_mega_ipddp import _unicycle_box, _unicycle_obstacle
from test_torch_ipddp import assert_match, jax_drive, port_options

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens"
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}


def port_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX IPDDP problem, boxes and every other
    path-constraint type, through ``interop`` (field by field)."""
    o = jp.objective
    boxes, others = {}, {}
    for name, c in jp.constraints.items():
        kind = type(c).__name__
        if kind in BOXES:
            boxes[name] = (BOXES[kind], np.asarray(c.lower), np.asarray(c.upper),
                           c.scale_factor)
            continue
        fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(getattr(path, kind))}
        others[name] = (kind, {k: v if isinstance(v, (int, float)) else np.asarray(v)
                               for k, v in fields.items()})
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state, None, None,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes, constraints=others)


def _scaled_ball(scale):
    jp = _unicycle_obstacle(horizon=20)
    return jp.add_constraint("BallConstraint", ct.ball_constraint(
        jnp.asarray(0.4), jnp.asarray([1.0, 1.0]), scale))


def _opts(iterations, **kw):
    return ct.CDDPOptions(max_iterations=iterations, tolerance=1e-4, **kw)


SEEDS = test_mega_ipddp.TestBallStackParity.SEEDS
# Starts inside the keep-out ball.
INSIDE = np.array([[1.0, 0.9, 0.0], [0.9, 1.2, 0.4], [1.2, 1.05, -0.3]])

# id -> (JAX problem, JAX options, x0, latch events the case must reach)
CASES = {
    "obstacle_4": lambda: (_unicycle_obstacle(horizon=20), _opts(4), SEEDS, ()),
    "obstacle_8": lambda: (_unicycle_obstacle(horizon=20), _opts(8), SEEDS, ()),
    # One line-search rung and a latch that arms at the first stalled
    # commit: the SOC replaces slacks, the fold is nonzero, and failed line
    # searches near feasibility drop the SOC.
    "latch_drop": lambda: (
        _unicycle_obstacle(horizon=20),
        _opts(14, line_search=ct.LineSearchOptions(max_iterations=1),
              ipddp=ct.IPDDPOptions(soc_stall_iterations=1)),
        SEEDS, ("stall_armed", "soc_replaced", "folded", "dropped")),
    # From inside the ball at a low regularization limit: the line search
    # fails far from feasibility until the limit arms the latch.
    "latch_fail_arm": lambda: (
        _unicycle_obstacle(horizon=20),
        _opts(12, regularization=ct.RegularizationOptions(max_value=1e-3)),
        INSIDE, ("fail_armed", "soc_replaced", "folded")),
    # The JAX driver's order of the ball's g, (-s q) - (-s r^2), which the
    # kernel's s (r^2 - q) rounds apart from when s != 1.
    "ball_scale_2_5": lambda: (_scaled_ball(2.5), _opts(8), SEEDS, ()),
    # A curved norm on u: the plain driver only (no kernel takes it).
    "max_thrust": lambda: (
        _unicycle_box(horizon=12).add_constraint(
            "MaxThrust", jpath.max_thrust_magnitude_constraint(1.0)),
        _opts(8), SEEDS[:3], ()),
}


@functools.lru_cache(maxsize=None)
def _jax_result(case):
    jp, jopts, x0, _ = CASES[case]()
    return jax_drive(jp, jopts, jnp.asarray(x0))


def _events(p, opts, x0):
    """The plain driver's latch events on the cold seeds of x0."""
    p = p.replace(x0=x0)
    B, N, nu, nx = x0.shape[0], p.horizon, p.control_dim, p.state_dim
    seeds = ipddp._initialize(p, opts, PathStacker(p), x0.new_zeros(B, N, nu))
    ev = {}
    ipddp._drive(p, opts, *seeds, x0.new_zeros(B, N, nu), x0.new_zeros(B, N, nu, nx),
                 events=ev)
    return ev


@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_driver(case, engine):
    """Both dispatch paths (on CPU tensors the whole-solve dispatch runs the
    plain driver the kernel is held to; "xla" the per-pass driver) equal the
    JAX driver; each latch case reaches the branches it is there for."""
    jp, jopts, x0, reach = CASES[case]()
    p = port_problem(jp)
    opts = port_options(jopts).replace(solve_engine=engine)
    X0 = torch.as_tensor(np.array(x0))
    got = solution_to_numpy(batched_solve(p, X0, "IPDDP", opts))
    assert_match(got, _jax_result(case))
    if reach and engine == "auto":
        ev = _events(p, opts, X0)
        for name in reach:
            assert bool(ev[name].any()), (name, {k: v.tolist() for k, v in ev.items()})


def _obstacle(dtype=torch.float64, ball_name="BallConstraint"):
    kw = dict(device="cpu", dtype=dtype)
    obj = tt.quadratic_objective(torch.zeros(3, 3), 0.05 * torch.eye(2), 100.0 * torch.eye(3),
                                 [2.0, 2.0, np.pi / 2], 0.03, **kw)
    p = tt.problem(Unicycle(), obj, torch.zeros(3), 20, 0.03, **kw)
    p = p.add_constraint("ControlConstraint",
                         tt.control_constraint([-2.0, -np.pi], [2.0, np.pi], **kw))
    return p.add_constraint(ball_name, tt.ball_constraint(0.4, [1.0, 1.0], **kw))


def test_dispatch_of_the_obstacle_stack():
    """The m = 5 stack reaches kernel 7 (a ball first or last in the stack)
    and kernel 6, never kernel 5; explicit always-on SOC or constraint
    Hessians and other curved types leave kernel 7, as in the JAX package
    (tests/test_mega_ipddp.py::TestBallStackParity::test_eligibility)."""
    p = _obstacle()
    opts = tt.CDDPOptions(max_iterations=8, tolerance=1e-4)
    stk = PathStacker(p)
    assert stk.total_dim == 5 and stk.has_curved
    assert mega_ipddp.mega_eligible(p, opts)
    assert mega_ipddp.solve_variant(p) == "m5_ball0"
    assert mega_ipddp.solve_variant(_obstacle(ball_name="obstacle")) == "m5_ball4"
    assert (3, 2, 5) in ric.KERNEL_SHAPES
    assert ip_rollout.resolve_ip_forward(p, opts, stk) is None
    ip = tt.IPDDPOptions
    assert not mega_ipddp.mega_eligible(p, opts.replace(ipddp=ip(slack_soc=True)))
    assert not mega_ipddp.mega_eligible(p, opts.replace(ipddp=ip(use_constraint_hessians=True)))
    linear = p.add_constraint("LinearConstraint", tt.linear_constraint(
        torch.eye(3), torch.full((3,), 10.0), device="cpu", dtype=torch.float64))
    assert not mega_ipddp.mega_eligible(linear, opts)
    two = p.add_constraint("Ball2", tt.ball_constraint(0.3, [0.5, 1.5], device="cpu",
                                                        dtype=torch.float64))
    assert mega_ipddp.solve_variant(two) is None
    with pytest.raises(ValueError, match="whole-solve kernel"):
        tt.solve(linear.replace(x0=torch.zeros(2, 3, dtype=torch.float64)), "IPDDP",
                 opts.replace(solve_engine="fused"))


def test_engines_on_cpu_run_the_plain_versions(caplog):
    """On CPU tensors the default engine runs kernel 7's plain version and
    the per-pass engine kernel 6's; the forward trial is the driver's own
    plain rollout on both (kernel 5 takes boxes only)."""
    p = _obstacle()
    x0 = torch.as_tensor(SEEDS[:2])
    opts = tt.CDDPOptions(max_iterations=2, tolerance=1e-4)
    for engine, want in (("auto", {"ipddp_solve"}), ("xla", {"ipddp_backward"})):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
            batched_solve(p, x0, "IPDDP", opts.replace(solve_engine=engine))
        ops = {r.getMessage().split(":")[0] for r in caplog.records}
        assert want <= ops and "ip_forward" not in ops, (engine, ops)


@pytest.mark.parametrize("ball_name,row", [("BallConstraint", 0), ("obstacle", 4)])
def test_lane_rows_of_the_obstacle_stack(ball_name, row):
    """One classifier (``ip_rollout.row_kind``) for every lane kernel: with
    ``ball`` the obstacle stack is kernel 7's rows, the ball's host row [-1,
    0, 0, 0] among the box's and its parameters apart; without, it is no
    box stack (kernels 5, 8 and 9) and the barrier solvers' refusal names
    the ball alone."""
    p = _obstacle(ball_name=ball_name)
    stk = PathStacker(p)
    assert ip_rollout.box_rows(p, stk) is None
    assert mega_ipddp.solve_variant(p, ball=False) is None
    for table in (mega_ipddp.MS_BOX_ROWS, mega_ipddp.LOG_BOX_ROWS):
        assert not mega_ipddp.box_solve_eligible(p, tt.CDDPOptions(), "sequential", table)
    rows = ip_rollout.box_rows(p, stk, ball=True)
    assert rows.m == 5 and rows.ball_rows == [row]
    host = np.asarray(rows.host).reshape(5, 4)
    np.testing.assert_array_equal(host[row], [-1.0, 0.0, 0.0, 0.0])
    boxes = p.replace(constraints={"ControlConstraint": p.get_constraint("ControlConstraint")})
    box = ip_rollout.box_rows(boxes, PathStacker(boxes))
    np.testing.assert_array_equal(np.delete(host, row, 0), np.asarray(box.host).reshape(4, 4))
    assert rows.ball == [2.0, 0.4, 1.0, 1.0, 1.0, 0.0]
    assert box.ball == [0.0] * 6
    with pytest.raises(NotImplementedError, match=rf"\({ball_name}\)"):
        tt.solve(p.replace(x0=torch.zeros(1, 3, dtype=torch.float64)), "LogDDP",
                 tt.CDDPOptions(max_iterations=1))


@pytest.mark.parametrize("solver", ["LogDDP", "MSIPDDP"])
def test_barrier_solvers_refuse_a_ball(solver):
    p = _obstacle().replace(x0=torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="slice 4 item 10"):
        tt.solve(p, solver, tt.CDDPOptions(max_iterations=2))


def test_unicycle_obstacle_golden():
    """The ``unicycle_obstacle_ipddp`` golden (tests/make_goldens.py: N =
    100, U0 = (0.5, 0), 300 iterations, tolerance 1e-4, acceptable 1e-5),
    one solve through ``tt.solve``: status and iteration count exact, cost,
    X and U at the parity tolerance 1e-8 (26 iterations at N = 100 carry
    the port's rounding to 1.5e-8 of the cost, relative)."""
    g = np.load(GOLDENS / "unicycle_obstacle_ipddp.npz")
    kw = dict(device="cpu", dtype=torch.float64)
    obj = tt.quadratic_objective(torch.zeros(3, 3), 0.05 * torch.eye(2), 100.0 * torch.eye(3),
                                 [2.0, 2.0, np.pi / 2], 0.03, **kw)
    p = tt.problem(Unicycle(), obj, torch.zeros(3), 100, 0.03, **kw)
    p = p.add_constraint("ControlConstraint",
                         tt.control_constraint([-2.0, -np.pi], [2.0, np.pi], **kw))
    p = p.add_constraint("BallConstraint", tt.ball_constraint(0.4, [1.0, 1.0], **kw))
    opts = tt.CDDPOptions(max_iterations=300, tolerance=1e-4, acceptable_tolerance=1e-5)
    sol = tt.solve(p, "IPDDP", opts,
                   U0=torch.tensor([0.5, 0.0], dtype=torch.float64).repeat(100, 1))
    assert int(sol.status_code) == int(g["status"])
    assert int(sol.iterations_completed) == int(g["iterations"])
    np.testing.assert_allclose(float(sol.final_objective), g["cost"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sol.state_trajectory.numpy(), g["X"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sol.control_trajectory.numpy(), g["U"], rtol=1e-8, atol=1e-8)


def test_latch_arms_at_the_fail_path_in_the_solve_from_inside():
    """The fail-path arming alone, counted in the plain driver: every start
    inside the ball at the low regularization limit arms by failing at the
    limit, never by the detector (soc_stall_iterations above the budget)."""
    p = _obstacle()
    opts = tt.CDDPOptions(max_iterations=12, tolerance=1e-4,
                          regularization=RegularizationOptions(max_value=1e-3),
                          ipddp=tt.IPDDPOptions(soc_stall_iterations=100))
    ev = _events(p, opts, torch.as_tensor(INSIDE))
    assert bool(ev["fail_armed"].all()) and not bool(ev["stall_armed"].any())
    assert bool(ev["soc_armed"].all())


def test_one_rung_line_search_drops_the_soc():
    """Explicit ``slack_soc=True`` arms from the start (no detector): the
    drop path then switches the SOC off where a one-rung line search fails
    near feasibility."""
    p = _obstacle()
    opts = tt.CDDPOptions(max_iterations=14, tolerance=1e-4,
                          line_search=LineSearchOptions(max_iterations=1),
                          ipddp=tt.IPDDPOptions(slack_soc=True))
    ev = _events(p, opts, torch.as_tensor(SEEDS))
    assert bool(ev["soc_armed"].all()) and not bool(ev["stall_armed"].any())
    assert bool(ev["dropped"].any()) and bool((~ev["soc_on"] == ev["dropped"]).all())
