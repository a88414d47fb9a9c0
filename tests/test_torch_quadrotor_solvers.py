"""The quadrotor's solves through the port's per-pass drivers against the
JAX package (CPU, float64, statuses and iteration counts exact, values at
1e-8): CLDDP on the quadrotor golden's problem cut to N = 10 (kernels 1 at
13x4 and 2 in their plain versions) against the JAX ``batched_solve``, and
IPDDP with ``bench_quadrotor.py``'s options (the best-merit ladder of
``enable_parallel``, the IPOPT barrier rule with factor 0.2,
``acceptable_tolerance=0``, 15 rungs, the fused backward engine; kernels 4,
5 and 6 in their plain versions) against the JAX vmapped ``_drive`` from
hover seeds. Both packages run both solves per pass: their whole solves
refuse the quadrotor. The golden's own options run through ``tt.solve`` in
``tests/test_torch_goldens.py``. Apart from the model tests
(``tests/test_torch_quadrotor.py``) because the JAX drivers' tracing and
compiling take most of the time of each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints.stack import PathStacker as JPathStacker
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu.options import BarrierOptions as JBarrierOptions
from cddp_tpu.options import BarrierStrategy as JBarrierStrategy
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_clddp, mega_ipddp
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from test_torch_ipddp import FIELDS as IP_FIELDS
from test_torch_ipddp import port_options
from test_torch_quadrotor import quad_box, x0_batch
from test_torch_zoo import CLDDP_FIELDS, assert_match, port_zoo_problem

torch.set_num_threads(1)


def _per_pass(p, x0, solver, opts, want, names, **kw):
    """The port's fleet by its default dispatch, which takes the per-pass
    driver for the quadrotor (the whole solves refuse it), held to
    ``want``."""
    dispatch_log.reset()
    sol = batched_solve(p, torch.as_tensor(np.asarray(x0)), solver, opts, **kw)
    assert not dispatch_log.launches  # CPU tensors: the plain versions
    got = solution_to_numpy(sol)
    assert_match(got, want, names)
    return got


def test_clddp_per_pass_matches_jax():
    """The golden's problem at N = 10, three iterations from x0 offsets."""
    jp = quad_box(10)
    x0 = x0_batch(jp, 4, seed=11)
    jopts = ct.CDDPOptions(max_iterations=3, tolerance=1e-4, acceptable_tolerance=1e-5,
                           regularization=ct.RegularizationOptions(initial_value=1e-4))
    U0 = jnp.full((4, 10, 4), 9.81 / 4.0)
    jsol = jbatched_solve(jp, x0, "CLDDP", jopts, U0_batch=U0)
    want = dict(zip(CLDDP_FIELDS, (
        jsol.state_trajectory, jsol.control_trajectory, jsol.feedforward_gains,
        jsol.feedback_gains, jsol.final_objective, jsol.inf_du, jsol.final_regularization,
        jsol.final_step_length, jsol.iterations_completed, jsol.status_code)))
    p, opts = port_zoo_problem(jp), port_options(jopts)
    assert not mega_clddp.mega_eligible(p, opts) and clddp._use_kernels(p, opts)
    got = _per_pass(p, x0, "CLDDP", opts, want, CLDDP_FIELDS,
                    U0_batch=torch.as_tensor(np.asarray(U0)))
    assert got["iterations"].min() == 3


def bench_options(iterations):
    """``bench_quadrotor.py:59-71``'s options, ``iterations`` of them."""
    return ct.CDDPOptions(
        max_iterations=iterations, tolerance=1e-4, acceptable_tolerance=0.0,
        line_search=ct.LineSearchOptions(max_iterations=15),
        regularization=ct.RegularizationOptions(initial_value=1e-4),
        enable_parallel=True, backward_engine="fused",
        ipddp=ct.IPDDPOptions(barrier=JBarrierOptions(strategy=JBarrierStrategy.IPOPT,
                                                      mu_update_factor=0.2)))


@functools.lru_cache(maxsize=None)
def _jax_ip_fleet(jopts):
    """The jitted JAX vmapped ``_initialize`` and ``_drive`` from hover
    controls, the problem an argument."""

    def one(p, x):
        p = p.replace(x0=x)
        stk, tstk = JPathStacker(p), JTerminalStacker(p)
        N, nu, nx = p.horizon, p.control_dim, p.state_dim
        U0 = jnp.full((N, nu), 9.81 / 4.0)
        X, U, Y, S, G, G_T, S_T, Y_T, Lam, Lam_te, mu0, _ = jipddp._initialize(
            p, jopts, stk, tstk, U0, None, False, x.dtype)
        sol, st = jipddp._drive(p, jopts, X, U, Y, S, G, G_T, S_T, Y_T, Lam, Lam_te, mu0,
                                jnp.zeros((N, nu)), jnp.zeros((N, nu, nx)))
        return dict(zip(IP_FIELDS, (
            sol.state_trajectory, sol.control_trajectory, st.k_u, st.K_u, st.Y, st.S,
            st.Lambda, sol.final_objective, sol.inf_pr, sol.inf_du, sol.inf_comp,
            sol.barrier_mu, sol.final_regularization, sol.final_step_length,
            sol.iterations_completed, sol.status_code)))

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def test_ipddp_bench_options_match_jax():
    """``bench_quadrotor.py``'s options on its problem's structure (the
    golden's, N = 10) from hover seeds: the per-pass driver with the
    best-merit ladder and the IPOPT barrier rule, against the JAX
    ``_drive``; the whole solve refuses ``enable_parallel`` on both
    packages."""
    jp = quad_box(10)
    x0 = x0_batch(jp, 4, seed=12)
    jopts = bench_options(6)
    want = _jax_ip_fleet(jopts)(jp, x0)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    assert opts.enable_parallel and opts.backward_engine == "fused"
    assert opts.ipddp.barrier.strategy == tt.BarrierStrategy.IPOPT
    assert not mega_ipddp.mega_eligible(p, opts)
    U0 = torch.full((4, 10, 4), 9.81 / 4.0, dtype=torch.float64)
    got = _per_pass(p, x0, "IPDDP", opts, want, IP_FIELDS, U0_batch=U0)
    assert got["iterations"].min() >= 4
    assert len(np.unique(got["mu"])) >= 1 and got["mu"].max() < 0.1
