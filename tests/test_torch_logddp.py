"""The LogDDP box fleet: LogDDP through the port's public entry points on CPU
against the JAX package's vmapped ``_drive``, seeded as
tests/test_mega_logddp.py::_run_both seeds it (float64, rtol = atol = 1e-8
on X, U, k, K, cost, cv (inf_pr), inf_du, mu, reg and alpha_pr; statuses and
iteration counts exact). Both engines run: the whole-solve dispatch (on CPU
tensors, the plain driver the kernel is held to) and ``solve_engine="xla"``.
Also the relaxed log-barrier against ``cddp_tpu.constraints.barrier``, the
unbatched entry point and the options the port refuses."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints import barrier as jbarrier
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.solvers import logddp as jlogddp
from cddp_tpu_torch.constraints import barrier
from cddp_tpu_torch.interop import options_from_dict, solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_logddp
from cddp_tpu_torch.parallel.batch import batched_solve
from test_mega_logddp import SEEDS, _unicycle_box
from test_torch_ipddp import port_ip_problem, port_options

torch.set_num_threads(1)

FIELDS = ("X", "U", "k", "K", "cost", "inf_pr", "inf_du", "mu", "reg", "alpha_pr",
          "iterations", "status")


@functools.lru_cache(maxsize=None)
def _jax_fleet(jopts):
    """The jitted JAX vmapped ``_drive`` for one option set; the problem is
    an argument, so cases with equal options share one compile."""

    def one(p, x0):
        p = p.replace(x0=x0)
        N, nu, nx = p.horizon, p.control_dim, p.state_dim
        U0 = jnp.zeros((N, nu), x0.dtype)
        X = jrollout(p.model, p.x0, U0, p.timestep)
        sol = jlogddp._drive(p, jopts, X, U0, jnp.zeros((N, nu)), jnp.zeros((N, nu, nx)))
        return dict(zip(FIELDS, (
            sol.state_trajectory, sol.control_trajectory, sol.feedforward_gains,
            sol.feedback_gains, sol.final_objective, sol.inf_pr, sol.inf_du,
            sol.barrier_mu, sol.final_regularization, sol.final_step_length,
            sol.iterations_completed, sol.status_code)))

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def jax_drive(jp, jopts, x0):
    return _jax_fleet(jopts)(jp, x0)


def assert_match(got, want, tol=1e-8):
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _x0(B, seed, scale):
    return jnp.asarray(np.random.default_rng(seed).uniform(-scale, scale, size=(B, 3)))


def _opts(**kw):
    return ct.CDDPOptions(tolerance=1e-4, **kw)


def _indefinite(jp):
    return jp.replace(objective=jp.objective.replace(R=jnp.asarray(-np.eye(2) * 5.0)))


# id -> (problem, JAX options, x0, the statuses the case is there for)
CASES = {
    "seeds_4": lambda: (_unicycle_box(horizon=20), _opts(max_iterations=4),
                        jnp.asarray(SEEDS), None),
    "seeds_10": lambda: (_unicycle_box(horizon=20), _opts(max_iterations=10),
                         jnp.asarray(SEEDS), None),
    "control_and_state_box": lambda: (_unicycle_box(horizon=12, state_box=True),
                                      _opts(max_iterations=6), _x0(4, 3, 0.4), None),
    # delta = 0.5 reaches the quadratic extension of beta on early iterates.
    "quadratic_branch": lambda: (_unicycle_box(horizon=12), _opts(
        max_iterations=6, log_barrier=ct.LogBarrierOptions(relaxed_log_barrier_delta=0.5)),
        jnp.asarray(SEEDS), None),
    # An indefinite R fails the PD check at every reachable regularization:
    # the backward retry loop ends in the status-4 quirk.
    "regularization_exhausted": lambda: (_indefinite(_unicycle_box(horizon=8)), _opts(
        max_iterations=4, regularization=ct.RegularizationOptions(max_value=1e-2)),
        _x0(2, 4, 0.2), {4}),
    # A negative violation threshold sends every trial to the first branch,
    # which needs cv < (1 - eps) cv_old = 0: every line search fails and the
    # regularization climbs to its limit (status 3).
    "forward_failure": lambda: (_unicycle_box(horizon=8), _opts(
        max_iterations=6, filter=ct.FilterOptions(max_violation_threshold=-1.0),
        regularization=ct.RegularizationOptions(max_value=1e-3)), _x0(2, 5, 0.3), {3}),
    "to_convergence": lambda: (_unicycle_box(horizon=12), ct.CDDPOptions(
        max_iterations=60, tolerance=1e-4, acceptable_tolerance=1e-4),
        _x0(3, 6, 0.3), {1, 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_matches_jax_driver(case):
    jp, jopts, x0, statuses = CASES[case]()
    want = jax_drive(jp, jopts, x0)
    p, opts = port_ip_problem(jp), port_options(jopts)
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        got = solution_to_numpy(batched_solve(p, torch.as_tensor(np.asarray(x0)), "LogDDP",
                                              opts.replace(solve_engine=engine)))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(got, want)
    assert got["iterations"].max() >= 1
    if statuses is not None:
        assert set(got["status"].tolist()) <= statuses


@pytest.mark.parametrize("variant", ["parallel_line_search", "unconstrained"])
def test_driver_variants_match_jax(variant):
    # enable_parallel (the best merit among the successes) and a problem
    # without path constraints keep the plain driver: the whole-solve kernel
    # takes neither.
    jp = _unicycle_box(horizon=12)
    jopts = _opts(max_iterations=6)
    if variant == "parallel_line_search":
        jopts = jopts.replace(enable_parallel=True)
    else:
        jp = jp.replace(constraints={})
    x0 = _x0(3, 13, 0.5)
    p, opts = port_ip_problem(jp), port_options(jopts)
    assert not mega_logddp.mega_eligible(p, opts)
    got = solution_to_numpy(batched_solve(p, torch.as_tensor(np.asarray(x0)), "LogDDP", opts))
    assert_match(got, jax_drive(jp, jopts, x0))


def test_unbatched_solve_matches_jax_solve():
    jp = _unicycle_box(horizon=10, state_box=True).replace(x0=jnp.asarray([0.3, -0.2, 0.1]))
    jopts = _opts(max_iterations=5)
    for name in ("LogDDP", "LOGDDP"):
        sol = tt.solve(port_ip_problem(jp), name, port_options(jopts))
        assert sol.state_trajectory.shape == (11, 3) and sol.status_code.shape == ()
        assert sol.solver_name == "LogDDP" and sol.dual_trajectories is None
    jsol = ct.solve(jp, "LogDDP", jopts)
    got = solution_to_numpy(sol)
    want = dict(zip(FIELDS, (
        jsol.state_trajectory, jsol.control_trajectory, jsol.feedforward_gains,
        jsol.feedback_gains, jsol.final_objective, jsol.inf_pr, jsol.inf_du,
        jsol.barrier_mu, jsol.final_regularization, jsol.final_step_length,
        jsol.iterations_completed, jsol.status_code)))
    assert_match(got, want)


def test_dispatch_and_unported_options():
    p = port_ip_problem(_unicycle_box(horizon=6))
    opts = tt.CDDPOptions(max_iterations=2)
    assert mega_logddp.mega_eligible(p, opts)
    for o in (opts.replace(solve_engine="xla"), opts.replace(backward_engine="scan"),
              opts.replace(enable_parallel=True)):
        assert not mega_logddp.mega_eligible(p, o)
    assert not mega_logddp.mega_eligible(p.replace(constraints={}), opts)
    with pytest.raises(ValueError, match="solve_engine='fused'"):
        tt.solve(p, "LogDDP", opts.replace(solve_engine="fused", enable_parallel=True))
    for o, kw, match in (
        (opts.replace(use_ilqr=False), {}, "full DDP"),
        (opts.replace(log_barrier=tt.LogBarrierOptions(lqr_backend="parallel")), {},
         "parallel"),
        (opts.replace(verbose=True), {}, "verbose"),
        (opts.replace(max_cpu_time=1.0), {}, "max_cpu_time"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            tt.solve(p, "LogDDP", o, **kw)


def test_log_barrier_options_carried_across():
    jopts = ct.CDDPOptions(log_barrier=ct.LogBarrierOptions(
        relaxed_log_barrier_delta=0.25, barrier=dataclasses.replace(
            ct.BarrierOptions(), mu_initial=3.0, mu_update_factor=0.3)))
    opts = options_from_dict(dataclasses.asdict(jopts))
    lb = opts.log_barrier
    assert (lb.relaxed_log_barrier_delta, lb.barrier.mu_initial,
            lb.barrier.mu_update_factor, lb.lqr_backend) == (0.25, 3.0, 0.3, "sequential")
    assert lb == port_options(jopts).log_barrier


@pytest.mark.parametrize("delta", [1e-10, 0.5])
def test_beta_derivatives_match_jax(delta):
    # Both branches, the 1e-12 guard (z at and below it) and negative z.
    z = np.concatenate([np.linspace(-1.0, 2.0, 41), [1e-13, 1e-12, 0.5, 0.5 + 1e-9]])
    got = barrier.beta_derivatives(torch.as_tensor(z), delta)
    want = jbarrier.beta_derivatives(jnp.asarray(z), delta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("state_box", [False, True])
def test_relaxed_log_barrier_matches_jax(state_box):
    jp = _unicycle_box(horizon=4, state_box=state_box)
    p = port_ip_problem(jp)
    rng = np.random.default_rng(11)
    x, u = rng.normal(size=(8, 3)) * 3.0, rng.normal(size=(8, 2)) * 2.0
    mu = rng.uniform(0.1, 2.0, size=8)
    for delta in (1e-10, 0.5):
        pb = barrier.RelaxedLogBarrier(barrier_coeff=torch.as_tensor(mu),
                                       relaxation_delta=delta)
        for name, c in p.sorted_constraints():
            jc = jp.constraints[name]
            xt, ut = torch.as_tensor(x), torch.as_tensor(u)
            got = (pb.evaluate(c, xt, ut), *pb.gradients(c, xt, ut), *pb.hessians(c, xt, ut))

            def terms(mu_i, xi, ui, jc=jc, delta=delta):
                jb = jbarrier.RelaxedLogBarrier(barrier_coeff=mu_i, relaxation_delta=delta)
                return (jb.evaluate(jc, xi, ui), *jb.gradients(jc, xi, ui),
                        *jb.hessians(jc, xi, ui))

            want = jax.vmap(terms)(jnp.asarray(mu), jnp.asarray(x), jnp.asarray(u))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
            np.testing.assert_array_equal(c.lower_bound().numpy(), np.asarray(jc.lower_bound()))
