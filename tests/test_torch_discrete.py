"""The discrete car (and the forklift, and the LTISystem where a kernel
takes it) through the port on CPU against the JAX package, float64:

- the plain versions of kernels 2, 4 and 5 on the car's exact map (N = 20,
  B = 4): kernel 2 against the JAX fused rollout in interpret mode, kernel
  4 against ``cddp_tpu.models.base.rollout`` and the Pallas open-loop
  kernel in interpret mode (also the forklift, under each integrator),
  kernel 5 at the car's m = 4 against the JAX scan and the Pallas forward
  kernel in interpret mode;
- the four solvers on the car's parking fleet (make_goldens.py:110-124 at
  N = 40, B = 3, 5 iterations) against the JAX drivers, rtol = atol = 1e-8,
  statuses and iteration counts exact, on both of the port's dispatch
  paths; CLDDP on the default LTISystem 4x2 with a control box, whose
  backward is kernel 1's ``4x2`` (the JAX op gates it on shape alone);
- the eligibility tables: no whole-solve predicate takes a discrete model
  (as the JAX package's refuse one), kernels 2 (goal form), 4, 5 and 6
  take the car, kernel 1 takes an LTISystem 4x2, and the route a CPU solve
  logs."""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.models import Car as JCar
from cddp_tpu.models import Forklift as JForklift
from cddp_tpu.models import lti_system as jlti_system
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import rollout as jroll
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.models import rollout
from cddp_tpu_torch.ops.kernels import (dispatch_log, ip_rollout, ipddp_riccati, mega_clddp,
                                        mega_ipddp, mega_logddp, mega_msipddp, riccati)
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from test_torch_ipddp import FIELDS as IP_FIELDS
from test_torch_ipddp import port_options
from test_torch_logddp import FIELDS as LOG_FIELDS
from test_torch_logddp import jax_drive as jax_log_drive
from test_torch_models import model_params
from test_torch_msipddp import NAMES as MS_FIELDS
from test_torch_msipddp import _jax_fleet as jax_ms_fleet
from test_torch_zoo import (CLDDP_FIELDS, _both_engines, assert_match, jax_ip_drive,
                            port_zoo_problem)

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)


def car_box(horizon=300):
    """The car-parking golden's problem (make_goldens.py:110-124): N = 300,
    dt = 0.03, the box [-0.5, -2]..[0.5, 2], x0 = (1, 1, 1.5 pi, 0), parked
    at the origin."""
    dt = 0.03
    return ct.problem(
        JCar(wheelbase=2.0, timestep=dt),
        ct.quadratic_objective(jnp.diag(jnp.array([1e-2, 1e-2, 1e-3, 1e-3])), 1e-2 * jnp.eye(2),
                               jnp.diag(jnp.array([100.0, 100.0, 50.0, 10.0])), jnp.zeros(4),
                               dt),
        jnp.array([1.0, 1.0, 1.5 * jnp.pi, 0.0]), horizon, dt,
    ).add_constraint("ControlConstraint",
                     ct.control_constraint(jnp.array([-0.5, -2.0]), jnp.array([0.5, 2.0])))


def lti_box(horizon=30):
    """tests/test_clddp.py:160-172's default 4x2 system with the control box
    [-1, 1]^2."""
    return ct.problem(
        jlti_system(0.1),
        ct.quadratic_objective(0.5 * jnp.eye(4), 0.1 * jnp.eye(2), 5.0 * jnp.eye(4),
                               jnp.zeros(4), 0.1),
        jnp.array([1.0, -1.0, 0.5, 0.2]), horizon, 0.1,
    ).add_constraint("ControlConstraint", ct.control_constraint(-jnp.ones(2), jnp.ones(2)))


def car_x0(B, seed):
    """The fleet's starts: (1, 1, 1.5 pi, 0) + U(-0.1, 0.1)^4."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.array([1.0, 1.0, 1.5 * np.pi, 0.0]) + rng.uniform(-0.1, 0.1, (B, 4)))


def _controls(B, N, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(B, N, 2)) * np.array([0.5, 2.0]) * scale


# --- the kernels' plain versions on the exact map ---------------------------------


def test_forward_rollout_plain_matches_jax_kernel_on_the_car():
    """Kernel 2's discrete branch (rollout.py:680-683): the closed-loop
    rollout at four step sizes against the JAX fused rollout in interpret
    mode; some controls clamp."""
    jp = car_box(20)
    N, nx, nu, B = 20, 4, 2, 4
    rng = np.random.default_rng(1)
    Xb = np.asarray(jp.x0) + rng.uniform(-0.3, 0.3, size=(B, N + 1, nx))
    Ub = _controls(B, N, 2, 0.8)
    k = 0.3 * rng.normal(size=(B, N, nu))
    K = 0.5 * rng.normal(size=(B, N, nu, nx))
    alpha = np.asarray([1.0, 0.5, 0.25, 0.125])
    cc = jp.get_constraint("ControlConstraint")
    Xw, Uw, Jw = jroll.forward_rollout_fused(
        jp, cc, *(jnp.asarray(a) for a in (Xb, Ub, k, K, alpha)), interpret=True)
    consts = rollout_ops.lane_consts(port_zoo_problem(jp))
    assert consts.rollout and not consts.clddp and consts.tag == "@car"
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    dispatch_log.reset()
    Xt, Ut, Jt = rollout_ops.forward_rollout(consts, t[0][:, :-1], t[1], t[2], t[3],
                                             t[0][:, 0], t[4])
    assert not dispatch_log.launches
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw)[:, 1:], **TOL)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), **TOL)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), **TOL)
    assert np.any(np.abs(Ut.numpy()) >= np.array([0.5, 2.0]) - 1e-12)


@pytest.mark.parametrize("case", ["car", "forklift_euler", "forklift_rk4", "forklift_front"])
def test_open_loop_rollout_plain_matches_jax(case):
    """Kernel 4: the car's exact map (whatever its integration_type) and
    the forklift under two integrators and both steering conventions,
    against ``cddp_tpu.models.base.rollout``, 1e-12."""
    if case == "car":
        jm, dt = JCar(wheelbase=2.0, timestep=0.03, integration_type="rk4"), 0.03
        x0 = np.asarray(car_x0(3, 3))
    else:
        jm = JForklift(wheelbase=1.6, rear_steer=case != "forklift_front",
                       integration_type="rk4" if case == "forklift_rk4" else "euler")
        dt = 0.05
        x0 = np.random.default_rng(3).uniform(-0.5, 0.5, size=(3, 5))
    U = _controls(3, 20, 4)
    want = np.stack([np.asarray(jrollout(jm, jnp.asarray(a), jnp.asarray(u), dt))
                     for a, u in zip(x0, U)])
    from test_torch_models import port_model

    model = port_model(jm)
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(U), dt)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_open_loop_rollout_plain_matches_pallas_interpret_on_the_car():
    """Kernel 4's discrete branch (ip_rollout.py:626-629) itself, in
    interpret mode."""
    jm = JCar(wheelbase=2.0, timestep=0.03)
    x0, U = np.asarray(car_x0(2, 5)), _controls(2, 20, 6)
    _, _, model_f, discrete = jip.model_lane(jm)
    assert discrete
    lane_key = (type(jm), True, "euler")
    jip._OL_LANES_BY_KEY[lane_key] = dict(model_f=model_f, model_discrete=True,
                                          integrator="euler")
    want = jip._ol_fused_impl(jnp.asarray(U), jnp.asarray(x0), jnp.full((2,), 0.03),
                              jnp.full((2, 1), 2.0), lane_key=lane_key, interpret=True)
    from test_torch_models import port_model

    got = ip_rollout.open_loop_rollout_plain(port_model(jm), torch.as_tensor(x0),
                                             torch.as_tensor(U), 0.03)
    np.testing.assert_allclose(got[:, 1:].numpy(), np.asarray(want), **TOL)


def _forward_inputs(jp, B, seed):
    N, nx, nu, m = jp.horizon, 4, 2, 4
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    hi = np.array([0.5, 2.0])
    return dict(Xb=np.asarray(jp.x0) + n(N, nx, scale=0.3), Ub=n(N, nu) * hi,
                Y=np.abs(n(N, m)) + 0.1, S=np.abs(n(N, m)) + 0.1, ku=n(N, nu) * hi,
                Ku=n(N, nu, nx) * hi[:, None], klam=n(N, nx), Klam=n(N, nx, nx), lam=n(N, nx),
                ky=n(N, m), Ky=n(N, m, nx, scale=0.01), ks=n(N, m),
                Ks=n(N, m, nx, scale=0.01), x0=np.asarray(jp.x0) + n(nx, scale=0.3),
                a_pr=rng.uniform(0.2, 1.0, B), a_du=rng.uniform(0.2, 1.0, B),
                tau=np.full(B, 0.99), soc=np.ones(B))


@pytest.mark.parametrize("engine", ["scan", "pallas_interpret"])
def test_ip_forward_plain_matches_jax_on_the_car(engine):
    """Kernel 5 at the car's m = 4 with its exact map (ip_rollout.py:341-344),
    against the JAX scan (B = 4) and the Pallas kernel in interpret mode
    (B = 2)."""
    jp = car_box(20)
    B = 4 if engine == "scan" else 2
    p = port_zoo_problem(jp)
    fc = ip_rollout.resolve_ip_forward(p, tt.CDDPOptions(), PathStacker(p))
    assert fc is not None and fc.rows.m == 4 and fc.lane.entry.discrete
    a = _forward_inputs(jp, B, 7)
    _, _, model_f, discrete = jip.model_lane(jp.model)
    c_entry = jip.cost_lane(jp.objective)
    cc = jp.get_constraint("ControlConstraint")
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(jp.timestep), bc(jnp.asarray(model_params(jp.model))), bc(c_entry[1]),
              jnp.zeros((B, 20, 1)), bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    if engine == "scan":
        want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
            4, 2, 4, model_f, discrete, "euler", c_entry[3], False, ("control",), *v)))(*jargs)
    else:
        model_key, cost_key = type(jp.model), (type(jp.objective),) + c_entry[0]
        jip._LANES_BY_KEY[(model_key, cost_key)] = dict(
            model_f=model_f, model_discrete=discrete, integrator="euler", cost_f=c_entry[3])
        want = jax.jit(lambda *v: jip._ip_forward_fused_impl(
            *v, model_key=model_key, cost_key=cost_key, slack_soc=False,
            box_layout=("control",), interpret=True))(*jargs)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    dispatch_log.reset()
    got = ip_rollout.ip_forward(fc, *t.values())
    assert not dispatch_log.launches
    for name, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[2]))
    assert 0 < int(got[7].sum())


# --- the four solvers on the car against the JAX drivers --------------------------


@pytest.mark.parametrize("solver", ["CLDDP", "IPDDP", "LogDDP", "MSIPDDP"])
def test_car_fleet_matches_jax(solver):
    """The parking fleet at N = 40, B = 3 over 5 iterations: CLDDP per pass
    (kernels 1 and 2's plain versions), IPDDP per pass (4, 6, 5), LogDDP
    and MSIPDDP on their plain drivers (seeded by 4), on both dispatch
    paths; CPU tensors launch nothing."""
    jp = car_box(40)
    x0 = car_x0(3, 8)
    jopts = ct.CDDPOptions(max_iterations=5, tolerance=1e-4)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    if solver == "CLDDP":
        jsol = jbatched_solve(jp, x0, "CLDDP", jopts)
        want = dict(zip(CLDDP_FIELDS, (
            jsol.state_trajectory, jsol.control_trajectory, jsol.feedforward_gains,
            jsol.feedback_gains, jsol.final_objective, jsol.inf_du, jsol.final_regularization,
            jsol.final_step_length, jsol.iterations_completed, jsol.status_code)))
        got = _both_engines(p, x0, "CLDDP", opts, want, CLDDP_FIELDS)
    elif solver == "IPDDP":
        got = _both_engines(p, x0, "IPDDP", opts, jax_ip_drive(jp, jopts, x0), IP_FIELDS)
    elif solver == "LogDDP":
        got = _both_engines(p, x0, "LogDDP", opts, jax_log_drive(jp, jopts, x0), LOG_FIELDS)
    else:
        want = jax_ms_fleet(jopts, False)(jp, x0)
        p = p.replace(x0=torch.as_tensor(np.asarray(x0)))
        for engine in ("auto", "xla"):
            dispatch_log.reset()
            got = solution_to_numpy(*tt.solve(p, "MSIPDDP", opts.replace(solve_engine=engine),
                                              return_state=True))
            assert not dispatch_log.launches
            assert_match(got, want, MS_FIELDS)
    assert got["iterations"].max() >= 2


def test_lti_box_fleet_matches_jax():
    """CLDDP on the LTISystem 4x2 with a control box: kernel 1's plain
    version (``riccati_backward@4x2``) and the plain rollout, against the
    JAX batched_solve."""
    jp = lti_box(30)
    x0 = jnp.asarray(np.asarray(jp.x0) + np.random.default_rng(9).uniform(-0.5, 0.5, (3, 4)))
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-6)
    jsol = jbatched_solve(jp, x0, "CLDDP", jopts)
    want = dict(zip(CLDDP_FIELDS, (
        jsol.state_trajectory, jsol.control_trajectory, jsol.feedforward_gains,
        jsol.feedback_gains, jsol.final_objective, jsol.inf_du, jsol.final_regularization,
        jsol.final_step_length, jsol.iterations_completed, jsol.status_code)))
    p, opts = port_zoo_problem(jp), port_options(jopts)
    got = _both_engines(p, x0, "CLDDP", opts, want, CLDDP_FIELDS)
    assert np.any(np.abs(got["U"]) >= 1.0 - 1e-12)


# --- eligibility -------------------------------------------------------------------


def test_whole_solve_predicates_refuse_the_car():
    """mega_clddp.py:843, mega_ipddp.py:2559, mega_msipddp.py:1276 and
    mega_logddp.py:766 of the JAX package refuse a discrete model; so do
    the port's, and ``solve_engine="fused"`` raises."""
    p, opts = port_zoo_problem(car_box(10)), tt.CDDPOptions(max_iterations=2)
    for mega in (mega_clddp, mega_ipddp, mega_logddp, mega_msipddp):
        assert not mega.mega_eligible(p, opts), mega.__name__
    assert not mega_ipddp.driver_eligible(p, opts, "sequential")
    for solver in ("CLDDP", "IPDDP", "LogDDP", "MSIPDDP"):
        with pytest.raises(ValueError, match="fused"):
            tt.solve(p, solver, opts.replace(solve_engine="fused"))


def test_kernel_tables_take_the_car_and_the_lti_shape():
    opts = tt.CDDPOptions(max_iterations=2)
    car = port_zoo_problem(car_box(10))
    lane = rollout_ops.lane_consts(car)
    assert lane.entry.discrete and lane.rollout and not lane.clddp
    assert clddp._use_kernels(car, opts) and (4, 2) in riccati.KERNEL_SHAPES
    assert ip_rollout.resolve_ip_forward(car, opts, PathStacker(car)) is not None
    assert (4, 2, 4) in ipddp_riccati.KERNEL_SHAPES
    # Kernel 1 gates on shape alone: an LTISystem 4x2 with a control box.
    lti = port_zoo_problem(lti_box(10))
    assert rollout_ops.model_entry(lti.model) is None and clddp._use_kernels(lti, opts)
    assert rollout_ops.lane_consts(lti) is None
    assert not clddp._use_kernels(lti, opts.replace(backward_engine="scan"))
    # The forklift: kernel 4 only.
    fl = rollout_ops.model_entry(tt.Forklift())
    assert fl.cuda_name == "forklift" and not fl.discrete


@pytest.mark.parametrize("case,solver,engine,plain_ops", [
    ("car", "CLDDP", "auto", ["riccati_backward@4x2", "forward_rollout@car"]),
    ("car", "IPDDP", "auto", ["open_loop_rollout@car", "ipddp_backward@4x2x4",
                              "ip_forward@car"]),
    ("car", "LogDDP", "auto", ["open_loop_rollout@car"]),
    ("car", "MSIPDDP", "auto", ["open_loop_rollout@car"]),
    ("lti", "CLDDP", "auto", ["riccati_backward@4x2"]),
    ("lti", "IPDDP", "auto", ["ipddp_backward@4x2x4"]),
])
def test_route_is_chosen_before_any_launch(case, solver, engine, plain_ops, caplog):
    """What a CPU solve's dispatch logs where a CUDA one would launch: the
    car reaches kernels 1, 2, 4, 5 and 6 under its name or shape and no
    whole solve; the LTISystem, which has no lane, only the shape-keyed
    kernels 1 and 6."""
    jp = car_box(6) if case == "car" else lti_box(6)
    p = port_zoo_problem(jp)
    x0 = torch.as_tensor(np.asarray(car_x0(2, 10) if case == "car" else
                                    jnp.tile(jp.x0, (2, 1))))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=2, solve_engine=engine))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(plain_ops)


def test_car_map_is_nan_past_its_reach():
    """Where |h v sin(delta)| > d the exact map is NaN, as the JAX model's:
    neither the plain model nor the kernels' lane clamps it."""
    car = tt.Car(wheelbase=2.0, timestep=0.03)
    x = torch.tensor([[0.0, 0.0, 0.0, 200.0]], dtype=torch.float64)
    u = torch.tensor([[0.5, 0.0]], dtype=torch.float64)
    want = np.asarray(JCar(wheelbase=2.0, timestep=0.03).discrete_dynamics(
        jnp.asarray(x[0]), jnp.asarray(u[0]), 0.0, 0.03))
    got = car.discrete_dynamics(x, u, None, 0.03)[0].numpy()
    assert math.isnan(got[0]) and np.array_equal(np.isnan(got), np.isnan(want))
