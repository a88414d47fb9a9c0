"""The whole slice: CLDDP through the port's public entry points on CPU
against the JAX package — its vmapped driver and its whole-solve kernel in
interpret mode (float64, rtol = atol = 1e-8, statuses and iteration counts
exact; the tolerance of tests/test_mega_clddp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.models import Unicycle as JUnicycle
from cddp_tpu.ops.pallas import mega_clddp as jmega
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu.solvers import clddp as jclddp
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_clddp
from cddp_tpu_torch.options import RegularizationOptions
from cddp_tpu_torch.parallel.batch import batched_solve
from test_torch_foundation import flagship_jax, port_problem

torch.set_num_threads(1)

FIELDS = ("X", "U", "k", "K", "cost", "inf_du", "reg", "alpha_pr", "iterations",
          "status")


def _jax_fields(sol):
    return dict(zip(FIELDS, (
        sol.state_trajectory, sol.control_trajectory, sol.feedforward_gains,
        sol.feedback_gains, sol.final_objective, sol.inf_du,
        sol.final_regularization, sol.final_step_length,
        sol.iterations_completed, sol.status_code)))


def _assert_match(got, want):
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8, err_msg=name)


def _jax_driver(jp, jopts, x0):
    """The JAX per-pass driver, vmapped, seeded as batched_solve seeds."""
    B, N = x0.shape[0], jp.horizon
    X0 = jnp.broadcast_to(x0[:, None], (B, N + 1, 3))
    z = jnp.zeros((B, N, 2))

    def one(x, X, U, k, K):
        return _jax_fields(jclddp._solve(jp.replace(x0=x), jopts, X, U, k, K))

    return jax.vmap(one)(x0, X0, z, z, jnp.zeros((B, N, 2, 3)))


def _x0(B, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(B, 3))


def test_flagship_fleet_matches_jax_driver_and_kernel():
    jp = flagship_jax(horizon=20)
    x0 = _x0(8, seed=0)
    kw = dict(max_iterations=10, tolerance=1e-4)
    dispatch_log.reset()
    got = solution_to_numpy(batched_solve(port_problem(jp), torch.as_tensor(x0),
                                          "CLDDP", tt.CDDPOptions(**kw)))
    assert not dispatch_log.launches  # CPU tensors: the plain driver
    want = _jax_fields(jbatched_solve(jp, jnp.asarray(x0), "CLDDP", ct.CDDPOptions(**kw)))
    _assert_match(got, want)

    B, N = x0.shape[0], 20
    X0 = jnp.broadcast_to(jnp.asarray(x0)[:, None], (B, N + 1, 3))
    z = jnp.zeros((B, N, 2))
    kern = jmega.build_fused_solve(jp, ct.CDDPOptions(**kw), interpret=True)(
        jnp.asarray(x0), X0, z, z, jnp.zeros((B, N, 2, 3)))
    _assert_match(got, dict(zip(FIELDS, kern)))
    assert np.all(np.isfinite(got["cost"])) and got["iterations"].max() >= 1


def test_regularization_limit_matches_jax():
    # tests/test_mega_clddp.py::TestMegaEdgeCases::test_regularization_limit_parity:
    # an indefinite R makes the BoxQP's PD check fail at every reachable
    # regularization, through the backward retry loop, to status 3.
    jp = flagship_jax(horizon=8)
    jp = jp.replace(objective=jp.objective.replace(R=jnp.asarray(-np.eye(2) * 5.0)))
    jopts = ct.CDDPOptions(max_iterations=4, regularization=ct.RegularizationOptions(
        initial_value=1e-6, update_factor=10.0, max_value=1e-2))
    opts = tt.CDDPOptions(max_iterations=4, regularization=RegularizationOptions(
        initial_value=1e-6, update_factor=10.0, max_value=1e-2))
    x0 = np.linspace(-0.2, 0.2, 9).reshape(3, 3)
    sol = batched_solve(port_problem(jp), torch.as_tensor(x0), options=opts)
    got = solution_to_numpy(sol)
    _assert_match(got, _jax_driver(jp, jopts, jnp.asarray(x0)))
    assert np.all(got["status"] == tt.Status.REGULARIZATION_LIMIT_NOT_CONVERGED)
    assert sol.status_messages() == ["RegularizationLimitReached_NotConverged"] * 3


@pytest.mark.parametrize("horizon,kw,statuses", [
    (12, dict(enable_parallel=True), None),
    (12, dict(backward_engine="scan"), None),
    # inf_du sits near 9.6 here: the fleet stops early (status 1).
    (12, dict(solve_engine="xla", tolerance=9.65), {1}),
    # Longer runs end on the acceptable-cost test (2) or on the line-search
    # regularization limit (3).
    (6, dict(solve_engine="xla", max_iterations=30, tolerance=1e-3), {2, 3}),
], ids=["parallel_ls", "scan_engine", "early_exit", "acceptable_and_limit"])
def test_driver_options_match_jax(horizon, kw, statuses):
    jp = flagship_jax(horizon=horizon)
    x0 = _x0(5, seed=13)
    opts = dict(max_iterations=8, tolerance=1e-4)
    opts.update(kw)
    got = solution_to_numpy(batched_solve(port_problem(jp), torch.as_tensor(x0),
                                          options=tt.CDDPOptions(**opts)))
    _assert_match(got, _jax_driver(jp, ct.CDDPOptions(**opts), jnp.asarray(x0)))
    if statuses is not None:
        assert set(got["status"].tolist()) == statuses


def test_unbatched_heun_and_unconstrained_match_jax():
    jp = flagship_jax(horizon=10, integrator="heun").replace(
        x0=jnp.asarray([0.3, -0.2, 0.1]))
    opts = dict(max_iterations=6, tolerance=1e-5)
    got = solution_to_numpy(tt.solve(port_problem(jp), "CLDDP", tt.CDDPOptions(**opts)))
    want = _jax_fields(ct.solve(jp, "CLDDP", ct.CDDPOptions(**opts)))
    _assert_match(got, want)
    assert got["X"].shape == (11, 3) and got["status"].shape == ()

    free = jp.replace(constraints={}, model=JUnicycle())
    got = solution_to_numpy(tt.solve(port_problem(free), "CLDDP", tt.CDDPOptions(**opts)))
    _assert_match(got, _jax_fields(ct.solve(free, "CLDDP", ct.CDDPOptions(**opts))))


def test_dispatch_and_unported_options():
    p = port_problem(flagship_jax(horizon=6))
    opts = tt.CDDPOptions(max_iterations=2)
    assert mega_clddp.mega_eligible(p, opts)
    for o in (opts.replace(solve_engine="xla"), opts.replace(backward_engine="scan")):
        assert not mega_clddp.mega_eligible(p, o)
    free = p.replace(constraints={})
    assert not mega_clddp.mega_eligible(free, opts)
    with pytest.raises(ValueError, match="solve_engine='fused'"):
        tt.solve(free, "CLDDP", opts.replace(solve_engine="fused"))
    with pytest.raises(ValueError, match="backward_engine"):
        tt.solve(p, "CLDDP", opts.replace(backward_engine="pallas"))
    with pytest.raises(NotImplementedError, match="return_iteration_info"):
        tt.solve(p, "CLDDP", opts.replace(return_iteration_info=True))
