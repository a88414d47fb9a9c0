"""Pendulum, CartPole and HCW through the port on CPU against the JAX
package (float64, rtol = atol = 1e-8, statuses and iteration counts exact):

- the whole solves, on both of the port's dispatch paths (the whole-solve
  dispatch, which CPU tensors take to the plain driver each kernel is held
  to, and ``solve_engine="xla"``): CLDDP on the pendulum and the cart-pole
  against the JAX ``batched_solve``; IPDDP on the pendulum and on the HCW
  rendezvous (x_N = 0) against the JAX vmapped ``_drive`` seeded by its
  ``_initialize``; LogDDP and MSIPDDP on the pendulum against theirs;
- the plain versions of kernels 1, 2, 4, 5 and 6 at the new shapes against
  the JAX package's Pallas kernels in interpret mode or their scan
  references;
- the eligibility tables: each (model, m, variant) is eligible exactly where
  a kernel is instantiated for it, and a registered model without one takes
  the plain route before any launch is tried.

The problems are the goldens' (tests/make_goldens.py:49-67) and the JAX
rendezvous bench's (bench_ipddp_fleet.py:56-82), cut to short horizons."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.models import HCW as JHCW
from cddp_tpu.models import CartPole as JCartPole
from cddp_tpu.models import Pendulum as JPendulum
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import rollout as jroll
from cddp_tpu.ops.pallas.riccati import _scan_backward_single, clddp_backward_fused
from cddp_tpu.constraints.stack import PathStacker as JPathStacker
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu.solvers import base as jbase
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.models import rollout
from cddp_tpu_torch.ops.kernels import (dispatch_log, ip_rollout, ipddp_riccati, mega_clddp,
                                        mega_ipddp, mega_logddp, mega_msipddp, riccati)
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from test_ipddp_pallas import _random_stage_data
from test_torch_ipddp import FIELDS as IP_FIELDS
from test_torch_ipddp import port_options
from test_mega_ipddp import _seed_batch
from test_torch_ipddp_terminal import TERMINAL_FIELDS
from test_torch_logddp import FIELDS as LOG_FIELDS
from test_torch_logddp import jax_drive as jax_log_drive
from test_torch_models import model_params
from test_torch_msipddp import NAMES as MS_FIELDS
from test_torch_msipddp import _jax_fleet as jax_ms_fleet

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
CLDDP_FIELDS = ("X", "U", "k", "K", "cost", "inf_du", "reg", "alpha_pr", "iterations",
                "status")
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}


def pendulum_box(horizon=100):
    """The pendulum goldens' problem (make_goldens.py:50-56) at ``horizon``."""
    dt = 0.02
    return ct.problem(
        JPendulum(length=0.5, damping=0.01),
        ct.quadratic_objective(jnp.zeros((2, 2)), 0.1 * jnp.eye(1), 100.0 * jnp.eye(2),
                               jnp.zeros(2), dt),
        jnp.array([jnp.pi, 0.0]), horizon, dt,
    ).add_constraint("ControlConstraint", ct.control_constraint([-20.0], [20.0]))


def cartpole_box(horizon=200):
    """The cart-pole golden's problem (make_goldens.py:58-67) at ``horizon``."""
    return ct.problem(
        JCartPole(),
        ct.quadratic_objective(jnp.diag(jnp.array([0.1, 1.0, 0.1, 0.1])), 0.05 * jnp.eye(1),
                               jnp.diag(jnp.array([100.0, 500.0, 10.0, 10.0])),
                               jnp.array([0.0, jnp.pi, 0.0, 0.0]), 0.02),
        jnp.zeros(4), horizon, 0.02,
    ).add_constraint("ControlConstraint", ct.control_constraint([-100.0], [100.0]))


def hcw_box(horizon=20, terminal=True):
    """The JAX rendezvous bench's problem (bench_ipddp_fleet.py:56-82): HCW,
    dt = 30, a control box of +-0.004 and, with ``terminal``, x_N = 0."""
    dt = 30.0
    p = ct.problem(
        JHCW(),
        ct.quadratic_objective(jnp.eye(6) * 1e-4, jnp.eye(3) * 1e-2, jnp.eye(6), jnp.zeros(6),
                               dt),
        jnp.asarray([10.0, 5.0, 2.0, 0.0, 0.0, 0.0]), horizon, dt,
    ).add_constraint("ControlConstraint",
                     ct.control_constraint(jnp.full((3,), -0.004), jnp.full((3,), 0.004)))
    if terminal:
        p = p.add_terminal_constraint("TerminalEquality",
                                      ct.terminal_equality_constraint(jnp.zeros(6)))
    return p


def x0_batch(jp, B, seed):
    """The fleets' initial states: the pendulum (pi, 0) + U(-0.1, 0.1); the
    cart-pole U(-0.05, 0.05); HCW (10, 5, 2, 0, 0, 0) + U(-1, 1) scaled 0.5
    on positions and 0.005 on velocities (bench_ipddp_fleet.py:124-132)."""
    rng = np.random.default_rng(seed)
    nx = jp.state_dim
    u = rng.uniform(-1.0, 1.0, size=(B, nx))
    name = type(jp.model).__name__
    if name == "Pendulum":
        return jnp.asarray(np.array([np.pi, 0.0]) + 0.1 * u)
    if name == "CartPole":
        return jnp.asarray(0.05 * u)
    scale = np.array([0.5, 0.5, 0.5, 0.005, 0.005, 0.005])
    return jnp.asarray(np.asarray(jp.x0) + scale * u)


def port_zoo_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX box problem, its model's parameters and its
    terminal constraints included, through ``interop.problem_from_arrays``."""
    o = jp.objective
    boxes = {name: (BOXES[type(c).__name__], np.asarray(c.lower), np.asarray(c.upper),
                    c.scale_factor) for name, c in jp.constraints.items()}
    term = {}
    for name, c in jp.terminal_constraints.items():
        kind = type(c).__name__
        term[name] = (kind, {"target_state": np.asarray(c.target_state)}
                      if kind == "TerminalEqualityConstraint"
                      else {"A": np.asarray(c.A), "b": np.asarray(c.b)})
    return problem_from_arrays(
        type(jp.model).__name__, model_params(jp.model), o.Q, o.R, o.Qf, o.reference_state,
        None, None, jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes, terminal_constraints=term)


def assert_match(got, want, names):
    for name in names:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _both_engines(p, x0, solver, opts, want, names, **kw):
    """The port's fleet on its two dispatch paths, each held to ``want``."""
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        sol = batched_solve(p, torch.as_tensor(np.asarray(x0)), solver,
                            opts.replace(solve_engine=engine), **kw)
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        got = solution_to_numpy(sol)
        assert_match(got, want, names)
    return got


# --- whole solves against the JAX drivers --------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_ip_fleet(jopts):
    """The jitted JAX vmapped IPDDP ``_drive`` for one option set, from the
    ``_initialize`` seeds (tests/test_mega_ipddp.py::_run_both), returning
    the terminal state too; the problem is an argument."""

    def one(p, x, Xi, Ui, Yi, Si, Li, mu0i, STi, YTi, LTEi):
        p = p.replace(x0=x)
        stk, tstk = JPathStacker(p), JTerminalStacker(p)
        N, nu, nx = p.horizon, p.control_dim, p.state_dim
        sol, st = jipddp._drive(
            p, jopts, Xi, Ui, Yi, Si, jipddp._eval_path(p, stk, Xi, Ui),
            tstk.ineq_evaluate(Xi[-1]), STi, YTi, Li, LTEi, mu0i,
            jnp.zeros((N, nu)), jnp.zeros((N, nu, nx)))
        return dict(zip(TERMINAL_FIELDS, (
            sol.state_trajectory, sol.control_trajectory, st.k_u, st.K_u, st.Y,
            st.S, st.Lambda, sol.final_objective, sol.inf_pr, sol.inf_du,
            sol.inf_comp, sol.barrier_mu, sol.final_regularization,
            sol.final_step_length, sol.iterations_completed, sol.status_code,
            st.S_T, st.Y_T, st.Lambda_T_eq)))

    return jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 10))


def jax_ip_drive(jp, jopts, x0):
    return _jax_ip_fleet(jopts)(jp, x0, *_seed_batch(jp, jopts, x0))


@pytest.mark.parametrize("case,iters", [("pendulum", 8), ("cartpole", 6)])
def test_clddp_fleet_matches_jax(case, iters):
    jp = pendulum_box(30) if case == "pendulum" else cartpole_box(30)
    x0 = x0_batch(jp, 4, seed=1)
    jopts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-3, acceptable_tolerance=1e-4)
    jsol = jbatched_solve(jp, x0, "CLDDP", jopts)
    want = dict(zip(CLDDP_FIELDS, (
        jsol.state_trajectory, jsol.control_trajectory, jsol.feedforward_gains,
        jsol.feedback_gains, jsol.final_objective, jsol.inf_du, jsol.final_regularization,
        jsol.final_step_length, jsol.iterations_completed, jsol.status_code)))
    p, opts = port_zoo_problem(jp), port_options(jopts)
    assert mega_clddp.mega_eligible(p, opts)
    got = _both_engines(p, x0, "CLDDP", opts, want, CLDDP_FIELDS)
    assert got["iterations"].max() >= 2


@pytest.mark.parametrize("case", ["pendulum", "hcw_rendezvous"])
def test_ipddp_fleet_matches_jax(case):
    """The pendulum's control box (kernel 7's ``m2``) and the rendezvous
    (``m6_te6``): the per-pass engine runs the plain reduced LQR of the
    terminal equality, the whole-solve dispatch the plain driver."""
    jp, variant, names = ((pendulum_box(20), "m2", IP_FIELDS) if case == "pendulum"
                          else (hcw_box(10), "m6_te6", TERMINAL_FIELDS))
    x0 = x0_batch(jp, 4, seed=2)
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-4)
    want = jax_ip_drive(jp, jopts, x0)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    assert mega_ipddp.solve_variant(p) == variant and mega_ipddp.mega_eligible(p, opts)
    got = _both_engines(p, x0, "IPDDP", opts, want, names)
    assert got["iterations"].max() >= 2


def test_logddp_pendulum_matches_jax():
    jp = pendulum_box(20)
    x0 = x0_batch(jp, 4, seed=3)
    jopts = ct.CDDPOptions(max_iterations=8, tolerance=1e-4)
    want = jax_log_drive(jp, jopts, x0)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    assert mega_logddp.mega_eligible(p, opts)
    got = _both_engines(p, x0, "LogDDP", opts, want, LOG_FIELDS)
    assert got["iterations"].max() >= 2


def test_msipddp_pendulum_matches_jax():
    jp = pendulum_box(20)
    x0 = x0_batch(jp, 4, seed=4)
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-4)
    want = jax_ms_fleet(jopts, False)(jp, x0)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    p = p.replace(x0=torch.as_tensor(np.asarray(x0)))
    assert mega_msipddp.mega_eligible(p, opts)
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        got = solution_to_numpy(*tt.solve(p, "MSIPDDP", opts.replace(solve_engine=engine),
                                          return_state=True))
        assert not dispatch_log.launches
        assert_match(got, want, MS_FIELDS)
    assert got["iterations"].max() >= 2


# --- the kernels' plain versions at the new shapes -------------------------------


def _stage_inputs(jp, B, seed):
    """Random nominal trajectories about the problem's and the stage data
    the CLDDP backward reads there, batch-first numpy."""
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    cc = jp.get_constraint("ControlConstraint")
    rng = np.random.default_rng(seed)
    X = jnp.asarray(np.asarray(jp.x0) + rng.uniform(-0.5, 0.5, size=(B, N + 1, nx)))
    U = jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, N, nu)) * np.asarray(cc.upper) / 2)

    def one(Xi, Ui):
        A, Bm = jbase.discrete_jacobians(jp, Xi, Ui)
        lx, lu, lxx, luu, lux = jbase.running_cost_derivatives(jp, Xi, Ui)
        return (A, Bm, lx, lu, lxx, luu, lux, cc.lower - Ui, cc.upper - Ui,
                jp.objective.terminal_cost_gradient(Xi[-1]),
                jp.objective.terminal_cost_hessian(Xi[-1]))

    return [np.asarray(a) for a in jax.vmap(one)(X, U)] + [
        1e-6 * rng.uniform(0.5, 2.0, size=B)], np.asarray(X), np.asarray(U)


@pytest.mark.parametrize("case", ["pendulum", "cartpole"])
def test_riccati_plain_matches_jax_kernel_and_scan(case):
    """Kernel 1 at (2, 1) and (4, 1): nu = 1, three BoxQP active sets.
    Against the scan reference, and on the pendulum also against the Pallas
    kernel in interpret mode."""
    jp = pendulum_box(6) if case == "pendulum" else cartpole_box(6)
    args, _, _ = _stage_inputs(jp, 4, seed=5)
    got = riccati.riccati_backward_plain(*(torch.as_tensor(a) for a in args))
    wants = [jax.vmap(_scan_backward_single)(*(jnp.asarray(a) for a in args))]
    if case == "pendulum":
        wants.append(clddp_backward_fused(*(jnp.asarray(a) for a in args), interpret=True))
    for want in wants:
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 5:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                           err_msg=f"output {i}")
    assert got[5].all()
    # Some steps clamp the control, some leave it free.
    k, lb, ub = got[0].numpy(), args[7], args[8]
    clamped = np.isclose(k, lb) | np.isclose(k, ub)
    assert clamped.any() and not clamped.all()


@pytest.mark.parametrize("case", ["pendulum", "cartpole"])
def test_forward_rollout_plain_matches_jax_kernel(case):
    """Kernel 2 on the model's lane: the closed-loop rollout at four step
    sizes against the JAX fused rollout in interpret mode."""
    jp = pendulum_box(8) if case == "pendulum" else cartpole_box(8)
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    rng = np.random.default_rng(6)
    B = 4
    Xb = np.asarray(jp.x0) + rng.uniform(-0.5, 0.5, size=(B, N + 1, nx))
    cc = jp.get_constraint("ControlConstraint")
    hi = np.asarray(cc.upper)
    Ub = rng.uniform(-0.8, 0.8, size=(B, N, nu)) * hi
    k, K = 0.5 * hi * rng.normal(size=(B, N, nu)), 5.0 * rng.normal(size=(B, N, nu, nx))
    alpha = np.asarray([1.0, 0.5, 0.25, 0.125])
    Xw, Uw, Jw = jroll.forward_rollout_fused(
        jp, cc, *(jnp.asarray(a) for a in (Xb, Ub, k, K, alpha)), interpret=True)
    consts = rollout_ops.lane_consts(port_zoo_problem(jp))
    assert consts.clddp and consts.tag == "@" + case
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    dispatch_log.reset()
    Xt, Ut, Jt = rollout_ops.forward_rollout(consts, t[0][:, :-1], t[1], t[2], t[3],
                                             t[0][:, 0], t[4])
    assert not dispatch_log.launches
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw)[:, 1:], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), rtol=1e-9, atol=1e-9)
    assert np.any(np.abs(Ut.numpy()) >= np.asarray(cc.upper) - 1e-12)


@pytest.mark.parametrize("integrator", ["euler", "heun", "rk3", "rk4"])
@pytest.mark.parametrize("case", ["pendulum", "cartpole", "hcw"])
def test_open_loop_rollout_plain_matches_jax(case, integrator):
    """Kernel 4's plain version against ``cddp_tpu.models.base.rollout``."""
    jp = {"pendulum": pendulum_box, "cartpole": cartpole_box, "hcw": hcw_box}[case](10)
    jm = jp.model.replace(integration_type=integrator)
    rng = np.random.default_rng(7)
    x0 = np.asarray(x0_batch(jp, 3, seed=8))
    U = rng.uniform(-1.0, 1.0, size=(3, 10, jp.control_dim)) * np.asarray(
        jp.get_constraint("ControlConstraint").upper)
    want = np.stack([np.asarray(jrollout(jm, jnp.asarray(a), jnp.asarray(u), jp.timestep))
                     for a, u in zip(x0, U)])
    model = port_zoo_problem(jp.replace(model=jm)).model
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(U), jp.timestep)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["pendulum", "hcw"])
def test_ip_forward_plain_matches_jax_scan(case):
    """Kernel 5 at the pendulum's m = 2 and HCW's m = 6."""
    jp = pendulum_box(8) if case == "pendulum" else hcw_box(8, terminal=False)
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    p = port_zoo_problem(jp)
    stk = PathStacker(p)
    m = stk.total_dim
    fc = ip_rollout.resolve_ip_forward(p, tt.CDDPOptions(), stk)
    assert fc is not None and fc.rows.m == m == 2 * nu
    B = 5
    rng = np.random.default_rng(9)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    hi = np.asarray(jp.get_constraint("ControlConstraint").upper)
    # HCW's velocities move its positions by dt = 30 s a step: keep them small.
    xs = np.full(nx, 0.3) if nx == 2 else np.asarray([0.3] * 3 + [0.003] * 3)
    a = dict(Xb=np.asarray(jp.x0) + n(N, nx, scale=1.0) * xs, Ub=n(N, nu) * hi,
             Y=np.abs(n(N, m)) + 0.1, S=np.abs(n(N, m)) + 0.1, ku=n(N, nu) * hi,
             Ku=n(N, nu, nx) * hi[:, None], klam=n(N, nx), Klam=n(N, nx, nx), lam=n(N, nx),
             ky=n(N, m), Ky=n(N, m, nx, scale=0.01), ks=n(N, m), Ks=n(N, m, nx, scale=0.01),
             x0=np.asarray(jp.x0) + n(nx, scale=1.0) * xs, a_pr=rng.uniform(0.2, 1.0, B),
             a_du=rng.uniform(0.2, 1.0, B), tau=np.full(B, 0.99), soc=np.ones(B))
    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    _, cparams, _, cost_f = jip.cost_lane(jp.objective)
    cc = jp.get_constraint("ControlConstraint")
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(jp.timestep), bc(jnp.asarray(model_params(jp.model))), bc(cparams),
              jnp.zeros((B, N, 1)), bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
        nx, nu, m, model_f, model_discrete, "euler", cost_f, False, ("control",), *v)))(*jargs)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    dispatch_log.reset()
    got = ip_rollout.ip_forward(fc, *t.values())
    assert not dispatch_log.launches
    for name, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[1]), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[2]))
    assert 0 < int(got[7].sum())


def test_ipddp_backward_plain_matches_jax_scan_at_2x1x2():
    """Kernel 6 at the pendulum's (nx, nu, m) = (2, 1, 2), on random stage
    data (tests/test_ipddp_pallas.py's), rtol 1e-9 and atol 1e-11."""
    args = list(_random_stage_data(jax.random.PRNGKey(3), B=6, N=8, nx=2, nu=1, m=2,
                                   dtype=jnp.float64))
    want = jax.jit(jax.vmap(_condensed_scan_single))(*args)
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*targs)
    assert not dispatch_log.launches
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=f"output {i}")
    assert bool((got[-1][:, 6] == 1.0).all())


# --- eligibility: instantiated where a kernel is built ---------------------------


def _tracking(jp):
    N, nx = jp.horizon, jp.state_dim
    ref = np.zeros((N + 1, nx))
    ref[:, 0] = np.linspace(0.1, 0.0, N + 1)
    return port_zoo_problem(jp).replace(objective=tt.quadratic_objective(
        torch.as_tensor(np.asarray(jp.objective.Q)) / jp.timestep,
        torch.as_tensor(np.asarray(jp.objective.R)) / jp.timestep,
        torch.as_tensor(np.asarray(jp.objective.Qf)), torch.as_tensor(ref[-1]), jp.timestep,
        reference_states=torch.as_tensor(ref), device="cpu", dtype=torch.float64))


def test_eligibility_tables():
    opts = tt.CDDPOptions(max_iterations=3)
    pend, cart = port_zoo_problem(pendulum_box(6)), port_zoo_problem(cartpole_box(6))
    hcw_te, hcw = port_zoo_problem(hcw_box(6)), port_zoo_problem(hcw_box(6, terminal=False))
    # Kernels 1-3: the pendulum and the cart-pole, goal and tracking forms;
    # HCW is registered but has no CLDDP instantiation: kernel 1 takes its
    # 6x3 shape (the Euler and MRP attitude models'), which it gates on.
    for p, ok in ((pend, True), (cart, True), (hcw, False)):
        assert mega_clddp.mega_eligible(p, opts) == ok
        assert clddp._use_kernels(p, opts) == (ok or p is hcw)
        assert rollout_ops.lane_consts(p).clddp == ok
    assert mega_clddp.mega_eligible(_tracking(pendulum_box(6)), opts)
    assert (2, 1) in riccati.KERNEL_SHAPES and (4, 1) in riccati.KERNEL_SHAPES
    # Kernel 7: the pendulum's m2 in both forms, HCW's m6_te6 in the goal
    # form; no cart-pole layout.
    assert mega_ipddp.solve_variant(pend) == "m2"
    assert mega_ipddp.solve_variant(_tracking(pendulum_box(6))) == "m2_track"
    # HCW's control box alone has no kernel-7 layout (ROADMAP C.10).
    assert mega_ipddp.solve_variant(hcw) is None and not mega_ipddp.mega_eligible(hcw, opts)
    assert mega_ipddp.solve_variant(hcw_te) == "m6_te6"
    assert mega_ipddp.dispatch_name(hcw_te) == "ipddp_solve_te6@hcw"
    assert mega_ipddp.dispatch_name(pend) == "ipddp_solve@pendulum"
    assert mega_ipddp.solve_variant(_tracking(hcw_box(6, terminal=False))) is None
    assert mega_ipddp.solve_variant(cart) is None
    ti = port_zoo_problem(hcw_box(6).add_terminal_constraint(
        "TerminalInequality", ct.terminal_inequality_constraint(jnp.eye(6)[:1],
                                                                jnp.asarray([20.0]))))
    assert mega_ipddp.solve_variant(ti) is None and not mega_ipddp.mega_eligible(ti, opts)
    assert not mega_ipddp.mega_eligible(cart, opts)
    # Kernel 5: the pendulum's m = 2 and HCW's m = 6; kernel 6: (2, 1, 2).
    for p, ok in ((pend, True), (hcw, True), (cart, False)):
        assert (ip_rollout.resolve_ip_forward(p, opts, PathStacker(p)) is not None) == ok
    assert (2, 1, 2) in ipddp_riccati.KERNEL_SHAPES
    assert (6, 3, 6) in ipddp_riccati.KERNEL_SHAPES  # HCW's box: the attitude trio's shape
    # Kernels 8 and 9: the pendulum only.
    for p, ok in ((pend, True), (hcw, False), (cart, False)):
        assert mega_logddp.mega_eligible(p, opts) == ok
        assert mega_msipddp.mega_eligible(p, opts) == ok


@pytest.mark.parametrize("case,solver,engine,plain_ops", [
    # On CPU tensors the whole-solve dispatch runs the per-pass plain driver,
    # whose passes log too.
    ("pendulum", "CLDDP", "auto", ["clddp_solve@pendulum", "riccati_backward@2x1",
                                   "forward_rollout@pendulum"]),
    ("cartpole", "CLDDP", "xla", ["riccati_backward@4x1", "forward_rollout@cartpole"]),
    ("hcw", "CLDDP", "auto", ["riccati_backward@6x3"]),
    ("hcw", "CLDDP", "xla", ["riccati_backward@6x3"]),
    ("hcw", "LogDDP", "auto", ["open_loop_rollout@hcw"]),
    # Kernel 6 gates on shape: the acrobot's (4, 1, 2) takes the cart-pole's box.
    ("cartpole", "IPDDP", "auto", ["open_loop_rollout@cartpole", "ipddp_backward@4x1x2"]),
    ("pendulum", "IPDDP", "xla", ["open_loop_rollout@pendulum", "ip_forward@pendulum",
                                  "ipddp_backward@2x1x2"]),
    ("hcw", "IPDDP", "xla", ["open_loop_rollout@hcw", "ip_forward@hcw",
                             "ipddp_backward@6x3x6"]),
    ("hcw", "IPDDP", "auto", ["open_loop_rollout@hcw", "ip_forward@hcw",
                              "ipddp_backward@6x3x6"]),
    ("hcw_te", "IPDDP", "auto", ["open_loop_rollout@hcw", "ipddp_solve_te6@hcw",
                                 "ip_forward@hcw"]),
])
def test_route_is_chosen_before_any_launch(case, solver, engine, plain_ops, caplog):
    """What a solve's dispatch decides, read from ``dispatch_log``'s records
    of the plain versions a CPU solve runs where a CUDA one would launch: a
    registered model whose (model, m, variant) has no kernel never reaches a
    kernel wrapper (HCW's CLDDP, the cart-pole's forward trial, HCW's
    LogDDP, kernel 6 at HCW's (6, 3, 6)), and one with a kernel reaches it
    under the model's name, or for the shape-keyed kernels 1 and 6 under
    its shape (the cart-pole's box at (4, 1, 2), the acrobot's)."""
    jp = {"pendulum": lambda: pendulum_box(6), "cartpole": lambda: cartpole_box(6),
          "hcw": lambda: hcw_box(6, terminal=False), "hcw_te": lambda: hcw_box(6)}[case]()
    p = port_zoo_problem(jp)
    x0 = torch.as_tensor(np.asarray(x0_batch(jp, 2, seed=10)))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=2, solve_engine=engine))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(plain_ops)
