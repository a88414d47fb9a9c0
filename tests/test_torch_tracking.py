"""Tracking MPC: a per-step reference trajectory
(``QuadraticObjective.reference_states``) through the port on CPU against
the JAX package, float64.

The problem is the unicycle tracking a circular arc (sin t, 1 - cos t, t),
t in [0, 1] (tests/test_ip_rollout.py:537-559, with a heavier Q), with a control box of
+-2 and, for IPDDP, a keep-out ball on the arc. Its reference has N + 1
rows whose last, the terminal goal, lies far from the arc, so that a
running cost that tracked the goal, or a terminal cost that tracked row
N - 1, would show. The four solvers through ``batched_solve`` against the
JAX ``batched_solve`` (statuses and iteration counts exact; X, U and cost
within 1e-8); the plain versions of kernels 2 and 5 with the reference
against the JAX fused rollout in interpret mode and the JAX forward
trial's scan reference (1e-9 and 1e-10); the objective's reference rows and
``quadratic_objective``'s check of the last row; which kernel variant the
wrappers name for a tracking problem."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.models import Unicycle as JUnicycle
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import rollout as jroll
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import options_from_dict, problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout, mega_clddp, mega_ipddp
from cddp_tpu_torch.ops.kernels import mega_logddp, mega_msipddp
from cddp_tpu_torch.ops.kernels.rollout import forward_rollout_plain, lane_consts
from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.parallel.batch import batched_solve

torch.set_num_threads(1)

N, DT = 12, 0.05
FAR_GOAL = np.array([2.0, 2.0, np.pi / 2])
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}


def arc(n, shift=0.0):
    """(n, 3) rows (sin t, 1 - cos t, t), t = linspace(0, 1, n) + shift."""
    ts = np.linspace(0.0, 1.0, n) + shift
    return np.stack([np.sin(ts), 1.0 - np.cos(ts), ts], axis=1)


def tracking_jax(rows="far", ball=False, horizon=N):
    """The JAX tracking problem: Q = 50 I (so that the running reference,
    and not only the terminal goal, shapes the solution), R = 0.1 I,
    Qf = 50 I. ``rows``
    "far": N + 1 reference rows, the arc then the far goal; "arc": N rows,
    the arc, whose last row is the goal. ``ball``: a keep-out ball of
    radius 0.2 on the arc at (0.5, 0.1), its row before the box's."""
    refs = arc(horizon)
    if rows == "far":
        refs = np.concatenate([refs, FAR_GOAL[None]])
    obj = ct.quadratic_objective(50.0 * jnp.eye(3), 0.1 * jnp.eye(2), 50.0 * jnp.eye(3),
                                 jnp.asarray(refs[-1]), DT,
                                 reference_states=jnp.asarray(refs))
    prob = ct.problem(JUnicycle(), obj, jnp.zeros(3), horizon, DT).add_constraint(
        "ControlConstraint", ct.control_constraint(jnp.asarray([-2.0, -2.0]),
                                                   jnp.asarray([2.0, 2.0])))
    if ball:
        prob = prob.add_constraint("BallConstraint", ct.ball_constraint(
            jnp.asarray(0.2), jnp.asarray([0.5, 0.1]), 1.0))
    return prob


def port_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX tracking problem, boxes, balls and the
    reference trajectory, through ``interop.problem_from_arrays``."""
    o = jp.objective
    boxes, others = {}, {}
    for name, c in jp.constraints.items():
        kind = type(c).__name__
        if kind in BOXES:
            boxes[name] = (BOXES[kind], np.asarray(c.lower), np.asarray(c.upper),
                           c.scale_factor)
        else:
            others[name] = (kind, {"radius": np.asarray(c.radius),
                                   "center": np.asarray(c.center),
                                   "scale_factor": c.scale_factor})
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state, None, None,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type, device="cpu",
        dtype=dtype, boxes=boxes, constraints=others,
        reference_states=None if o.reference_states is None else np.asarray(o.reference_states))


def x0s(B=3, seed=0):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, size=(B, 3))


@functools.lru_cache(maxsize=None)
def _jax_solver(solver, jopts):
    return jax.jit(lambda jp, x0: jbatched_solve(jp, x0, solver, jopts))


def jax_fields(sol):
    return {"X": sol.state_trajectory, "U": sol.control_trajectory,
            "cost": sol.final_objective, "iterations": sol.iterations_completed,
            "status": sol.status_code}


def assert_match(got, want, tol=1e-8):
    for name in ("X", "U", "cost", "iterations", "status"):
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


# id -> (solver, JAX problem, JAX options, engines the port runs)
CASES = {
    "CLDDP": lambda: ("CLDDP", tracking_jax(), ct.CDDPOptions(max_iterations=7), ("auto", "xla")),
    # Four iterations: instance 0 has converged by the fourth, and from the
    # fifth its acceptance test dJ > 0 reads a cost change of one ulp (the
    # port's (e Q) . e against the JAX package's e Q e), a roundoff tie
    # (ROADMAP section C).
    "CLDDP_arc": lambda: ("CLDDP", tracking_jax(rows="arc"), ct.CDDPOptions(max_iterations=4),
                          ("auto",)),
    "IPDDP": lambda: ("IPDDP", tracking_jax(), ct.CDDPOptions(max_iterations=6, tolerance=1e-4),
                      ("auto", "xla")),
    "IPDDP_ball": lambda: ("IPDDP", tracking_jax(ball=True),
                           ct.CDDPOptions(max_iterations=6, tolerance=1e-4), ("auto",)),
    "LogDDP": lambda: ("LogDDP", tracking_jax(), ct.CDDPOptions(max_iterations=6, tolerance=1e-4),
                       ("auto",)),
    "MSIPDDP": lambda: ("MSIPDDP", tracking_jax(),
                        ct.CDDPOptions(max_iterations=5, tolerance=1e-4), ("auto",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solvers_track_as_the_jax_package(case):
    solver, jp, jopts, engines = CASES[case]()
    x0 = x0s()
    want = jax_fields(_jax_solver(solver, jopts)(jp, jnp.asarray(x0)))
    p = port_problem(jp)
    opts = options_from_dict(dataclasses.asdict(jopts))
    for engine in engines:
        dispatch_log.reset()
        got = solution_to_numpy(batched_solve(p, torch.as_tensor(x0), solver,
                                              opts.replace(solve_engine=engine)))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(got, want)
    assert got["iterations"].max() >= 1
    # The fleet follows the arc, not the goal: its mid-horizon states lie
    # nearer the arc's rows than the goal.
    mid = got["X"][:, N // 2, :2]
    assert np.all(np.linalg.norm(mid - arc(N)[N // 2, :2], axis=-1)
                  < np.linalg.norm(mid - FAR_GOAL[:2], axis=-1))


def test_goal_form_is_not_the_tracking_form():
    """The same problem with its reference dropped solves to something
    else, so the parity above cannot pass by tracking the goal."""
    jp = tracking_jax()
    p = port_problem(jp)
    x0 = torch.as_tensor(x0s())
    opts = CDDPOptions(max_iterations=7)
    track = solution_to_numpy(batched_solve(p, x0, "CLDDP", opts))
    goal = solution_to_numpy(batched_solve(
        p.replace(objective=p.objective.replace(reference_states=None)), x0, "CLDDP", opts))
    assert np.abs(track["X"] - goal["X"]).max() > 0.1


def test_objective_rows_and_terminal():
    """Row k of the reference at step k, rows 0..N-1 over a step axis, the
    terminal cost against the goal; a tracking objective refuses a running
    cost without its step."""
    jp = tracking_jax()
    o, jo = port_problem(jp).objective, jp.objective
    rng = np.random.default_rng(4)
    X, U = rng.normal(size=(2, N + 1, 3)), rng.normal(size=(2, N, 2))
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    for k in (0, 5, N - 1):
        want = jax.vmap(lambda x, u: jo.running_cost(x, u, k))(X[:, k], U[:, k])
        np.testing.assert_allclose(o.running_cost(Xt[:, k], Ut[:, k], k).numpy(),
                                   np.asarray(want), rtol=1e-12, atol=1e-12)
        gx, gu = o.running_cost_gradients(Xt[:, k], Ut[:, k], k)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jax.vmap(
            lambda x, u: jo.running_cost_gradients(x, u, k)[0])(X[:, k], U[:, k])),
            rtol=1e-12, atol=1e-12)
    want = sum(np.asarray(jax.vmap(lambda x, u: jo.running_cost(x, u, k))(X[:, k], U[:, k]))
               for k in range(N)) + np.asarray(jax.vmap(jo.terminal_cost)(X[:, -1]))
    np.testing.assert_allclose(o.evaluate(Xt, Ut).numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match="step"):
        o.running_cost(Xt[:, 0], Ut[:, 0])


def test_quadratic_objective_checks_the_last_row():
    refs = np.concatenate([arc(N), FAR_GOAL[None]])
    eye = np.eye(3)
    obj = tt.quadratic_objective(0.5 * eye, 0.1 * np.eye(2), 50.0 * eye, FAR_GOAL, DT,
                                 reference_states=refs, device="cpu")
    np.testing.assert_array_equal(obj.reference_states.numpy(), refs)
    np.testing.assert_allclose(obj.Q.numpy(), 0.5 * DT * eye)
    for builder in (ct.quadratic_objective,
                    functools.partial(tt.quadratic_objective, device="cpu")):
        with pytest.raises(ValueError, match="Last reference state must be same"):
            builder(0.5 * eye, 0.1 * np.eye(2), 50.0 * eye, np.zeros(3), DT,
                    reference_states=refs)


def _rollout_inputs(B, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 1.5, size=(B, N + 1, 3)), rng.uniform(-1.5, 1.5, size=(B, N, 2)),
            0.5 * rng.normal(size=(B, N, 2)), 0.5 * rng.normal(size=(B, N, 2, 3)),
            np.asarray([1.0, 0.5, 0.25, 0.125][:B]))


@pytest.mark.parametrize("rows", ["far", "arc"])
def test_plain_rollout_tracks_as_the_jax_kernel(rows):
    """Kernel 2's plain version with the reference against the JAX fused
    rollout in interpret mode (its tracking variant, rollout.py:616-713)."""
    jp = tracking_jax(rows=rows)
    Xb, Ub, k, K, alpha = _rollout_inputs(4, seed=2)
    Xw, Uw, Jw = jroll.forward_rollout_fused(
        jp, jp.get_constraint("ControlConstraint"),
        *(jnp.asarray(a) for a in (Xb, Ub, k, K, alpha)), interpret=True)
    consts = lane_consts(port_problem(jp))
    assert consts.variant == "_track" and tuple(consts.refs.shape) == (N, 3)
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    Xt, Ut, Jt = forward_rollout_plain(consts, t[0][:, :-1], t[1], t[2], t[3], t[0][:, 0], t[4])
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw)[:, 1:], **tol)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), **tol)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), **tol)


def test_plain_forward_trial_tracks_as_the_jax_scan():
    """Kernel 5's plain version with the reference against the JAX forward
    trial's scan reference on the "quadratic_track" cost lane
    (ip_rollout.py:136-163), the reference as its per-step stage params."""
    from test_torch_ip_rollout import _forward_inputs

    jp = tracking_jax()
    p = port_problem(jp)
    fc = ip_rollout.resolve_ip_forward(p, CDDPOptions(), PathStacker(p))
    assert fc is not None and fc.lane.variant == "_track"
    B, m = 5, 4
    a = _forward_inputs(B, N, m, seed=6)
    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    static, cparams, cstage, cost_f = jip.cost_lane(jp.objective)
    assert static[0] == "quadratic_track"
    cc = jp.get_constraint("ControlConstraint")
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(DT), bc(jnp.zeros(1)), bc(cparams), bc(jnp.asarray(cstage)[:N]),
              bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
        3, 2, m, model_f, model_discrete, "euler", cost_f, False, ("control",), *v)))(*jargs)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    got = ip_rollout.ip_forward(fc, *t.values())
    tol = dict(rtol=1e-10, atol=1e-10)
    for name, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[1]), **tol)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[2]))


def test_tracking_variants_the_wrappers_name():
    """A tracking problem is eligible for the whole-solve kernels and names
    their "_track" launchers: kernel 7 on the box layouts and the ball's
    row first, not on the ball's row last (no such instantiation)."""
    opts = CDDPOptions(max_iterations=3)
    p = port_problem(tracking_jax())
    assert mega_clddp.mega_eligible(p, opts)
    assert mega_logddp.mega_eligible(p, opts) and mega_msipddp.mega_eligible(p, opts)
    assert mega_ipddp.solve_variant(p) == "m4_track" and mega_ipddp.mega_eligible(p, opts)
    ball = port_problem(tracking_jax(ball=True))
    assert mega_ipddp.solve_variant(ball) == "m5_ball0_track"
    last = ball.replace(constraints={"Obstacle": ball.constraints["BallConstraint"],
                                     "ControlConstraint": ball.constraints["ControlConstraint"]})
    assert mega_ipddp.solve_variant(last) is None
    goal = p.replace(objective=p.objective.replace(reference_states=None))
    like = torch.zeros(1, dtype=torch.float64)
    assert mega_ipddp.solve_variant(goal) == "m4" and lane_consts(goal).refs_ptr(like) is None
    # The kernels read the reference where it lies: in the inputs' dtype only.
    assert lane_consts(p).refs_ptr(like) is not None
    with pytest.raises(ValueError, match="reference_states"):
        lane_consts(p).refs_ptr(like.float())
