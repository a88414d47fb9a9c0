"""The port's other spacecraft models (SpacecraftLinearFuel,
SpacecraftNonlinear, SpacecraftLanding2D, SpacecraftTwobody) against the
JAX package (CPU, float64):

- each model's continuous dynamics and AD Jacobians against the JAX model
  (1e-12), on the oracle states of tests/test_model_oracles.py:270-345, on
  the fleets' states and, for the fuel model, at u = 0;
- the registry's parameter vectors against the JAX lane vectors,
  ``interop`` carrying each model across, the lane step against the JAX
  lane;
- the CUDA structs of ``models.cuh`` built for the host (g++) against the
  plain models: ``f`` and every stepper of ``integrate`` (1e-12), ``fxfu``
  against the AD Jacobians (1e-10 relative), the fuel model's at u = 0;
- the plain versions of kernels 1, 2, 4, 5 and 6 at the new shapes (8x3,
  10x3, 6x2; m = 6 and 4) against the JAX scan references, and the fuel
  model's open-loop rollout against the Pallas kernel in interpret mode;
- ``rollout.WHOLE_MAX_HORIZON`` derived from the JAX gates, and the routes
  a solve takes.

The problems are ``chip_smoke.py``'s (``SC_SPECS``), built here in JAX. The
solves are in ``tests/test_torch_spacecraft_solvers.py``.
"""

import ctypes
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import chip_smoke
import cddp_tpu_torch as tt
from cddp_tpu.models import spacecraft as jsc
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import mega_clddp as jclddp
from cddp_tpu.ops.pallas import mega_ipddp as jipddp
from cddp_tpu.ops.pallas import mega_logddp as jlogddp
from cddp_tpu.ops.pallas import mega_msipddp as jmsipddp
from cddp_tpu.ops.pallas import rollout as jlane
from cddp_tpu.ops.pallas.riccati import _scan_backward_single
from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.models import rollout
from cddp_tpu_torch.ops.kernels import (dispatch_log, ip_rollout, ipddp_riccati, mega_clddp,
                                        mega_ipddp, mega_logddp, mega_msipddp, riccati)
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from test_torch_attitude import _HOST_ATTITUDE
from test_torch_models import model_params
from test_torch_quadrotor import _stage_data
from test_torch_zoo import _stage_inputs, port_zoo_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
MODELS = chip_smoke.SC_MODELS
JAX_CLASS = {m: c for c, m in chip_smoke.SC_CLASSES.items()}
# (JAX model with non-default parameters, the oracle state and control of
# tests/test_model_oracles.py:270-345).
ORACLES = {
    "sc_linear_fuel": (jsc.SpacecraftLinearFuel(mean_motion=0.0011, isp=310.0),
                       [10.0, -5.0, 2.0, 0.1, 0.2, -0.3, 50.0, 0.0], [0.5, -0.2, 0.1]),
    "sc_nonlinear": (jsc.SpacecraftNonlinear(mass=1.3, mu=1.1),
                     [0.1, -0.2, 0.05, 0.01, 0.02, -0.01, 1.2, 0.3, 0.01, 0.9],
                     [0.001, -0.002, 0.003]),
    "sc_landing2d": (jsc.SpacecraftLanding2D(mass=90000.0, length=45.0),
                     [5.0, -1.0, 100.0, -10.0, 0.1, 0.02], [0.5, 0.05]),
    "sc_twobody": (jsc.SpacecraftTwobody(mass=1.2),
                   [7000.0, 100.0, -200.0, 0.1, 7.5, 0.2], [0.001, 0.002, -0.003]),
}


def jax_model(name, integration_type="rk4"):
    return ORACLES[name][0].replace(integration_type=integration_type)


def port_model(jm):
    p = problem_from_arrays(type(jm).__name__, model_params(jm), np.eye(jm.state_dim),
                            np.eye(jm.control_dim), np.eye(jm.state_dim),
                            np.zeros(jm.state_dim), None, None, np.zeros(jm.state_dim), 2, 0.1,
                            jm.integration_type, device="cpu", dtype=torch.float64)
    return p.model


def _states(name, B, seed):
    """The oracle state and control first, then states about the fleets'
    x0 (``SC_SPECS``; the fuel model's live mass about 1) with controls
    across twice the box, the fuel model's second control zero."""
    rng = np.random.default_rng(seed)
    _, x_or, u_or = ORACLES[name]
    dt, x0, widths, *_, lower, upper = chip_smoke.SC_SPECS[name]
    x0 = chip_smoke.circular_state(0.0) if x0 is None else x0
    spread = np.maximum(np.asarray(widths), 0.05 * np.abs(np.asarray(x0)) + 0.01)
    X = np.asarray(x0) + spread * rng.uniform(-1.0, 1.0, (B - 1, len(x0)))
    mid, half = (np.asarray(upper) + np.asarray(lower)) / 2, (np.asarray(upper)
                                                               - np.asarray(lower))
    U = mid + half * rng.uniform(-1.0, 1.0, (B - 1, len(lower)))
    X, U = np.vstack([x_or, X]), np.vstack([u_or, U])
    if name == "sc_linear_fuel":
        U[1] = 0.0
    return X, U


def _jax_rows(fn, X, U):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(X), jnp.asarray(U)))


@pytest.mark.parametrize("name", MODELS)
def test_dynamics_and_jacobians_match_jax(name):
    jm = jax_model(name)
    X, U = _states(name, 16, seed=1)
    model = port_model(jm)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(model(Xt, Ut, None).numpy(), _jax_rows(
        lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **TOL)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    jFx, jFu = (_jax_rows(lambda x, u, i=i: jm.jacobians(x, u, 0.0)[i], X, U) for i in (0, 1))
    np.testing.assert_allclose(Fx.numpy(), jFx, **TOL)
    np.testing.assert_allclose(Fu.numpy(), jFu, **TOL)


def test_models_are_exported_with_the_jax_defaults():
    """The four classes in ``cddp_tpu_torch`` and its ``models``, their
    buffers float64 in the JAX field order with the JAX defaults; the
    lander's inertia (1/12) m L^2 as the JAX model computes it."""
    for cls_name in JAX_CLASS.values():
        cls = getattr(tt, cls_name)
        port, jm = cls(), getattr(jsc, cls_name)()
        fields = [n for n, _ in port.named_buffers()]
        assert all(getattr(port, n).dtype == torch.float64 for n in fields)
        assert fields == [f for f in type(jm).__dataclass_fields__
                          if f not in ("state_dim", "control_dim", "integration_type")]
        assert [float(getattr(port, n)) for n in fields] == [getattr(jm, n) for n in fields]
        assert (port.state_dim, port.control_dim) == (jm.state_dim, jm.control_dim)
        assert port.integration_type == "euler"
    assert float(tt.SpacecraftLanding2D().inertia) == jsc.SpacecraftLanding2D().inertia


@pytest.mark.parametrize("name", MODELS)
def test_registry_parameters_are_the_jax_lanes(name):
    jm = jax_model(name)
    model = port_model(jm)
    entry = rollout_ops.model_entry(model)
    assert entry.cuda_name == name and entry.tag == "@" + name and not entry.discrete
    np.testing.assert_array_equal(entry.params(model), model_params(jm))
    assert entry.kernel_params(model) == model_params(jm).tolist()
    assert len(model_params(jm)) == jlane._REGISTRY[type(jm).__name__][0]


@pytest.mark.parametrize("name", MODELS)
def test_interop_carries_the_models(name):
    jm = jax_model(name)
    nx, nu = jm.state_dim, jm.control_dim
    model = port_model(jm)
    assert type(model).__name__ == type(jm).__name__ and model.integration_type == "rk4"
    X, U = _states(name, 6, seed=3)
    np.testing.assert_allclose(
        model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), 0.0, 0.1).numpy(),
        _jax_rows(lambda x, u: jm.discrete_dynamics(x, u, 0.0, 0.1), X, U), **TOL)
    n = len(model_params(jm))
    with pytest.raises(ValueError, match=f"takes {n}"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(nu),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, 0.1, "rk4",
                            device="cpu", dtype=torch.float64)
    if name == "sc_landing2d":
        with pytest.raises(ValueError, match="inertia"):
            problem_from_arrays(type(jm).__name__, model_params(jm) * 1.5, np.eye(nx),
                                np.eye(nu), np.eye(nx), np.zeros(nx), None, None, np.zeros(nx),
                                5, 0.1, "rk4", device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("name", MODELS)
def test_lane_step_matches_jax_lane(name):
    """One rk4 step of the kernels' stage arithmetic on the plain model
    (``rollout.lane_step``) against the JAX lane's integrator over its lane
    function (s sqrt(s) and r^2 sqrt(r^2) against the models' powers and
    norm: 1e-12)."""
    jm = jax_model(name)
    X, U = _states(name, 8, seed=4)
    model = port_model(jm)
    got = rollout_ops.lane_step(model, rollout_ops.model_entry(model), "rk4",
                                torch.as_tensor(X), torch.as_tensor(U),
                                torch.tensor(0.1, dtype=torch.float64)).numpy()
    lane_f = jlane._REGISTRY[type(jm).__name__][2]
    want = np.stack([np.asarray(v) for v in jlane._integrate_lane(
        lane_f, "rk4", [jnp.asarray(X[:, i]) for i in range(X.shape[1])],
        [jnp.asarray(U[:, i]) for i in range(U.shape[1])], jnp.asarray(model_params(jm)),
        jnp.full(X.shape[0], 0.1))], -1)
    np.testing.assert_allclose(got, want, **TOL)


# --- the CUDA structs as host C++ ----------------------------------------------------

_HOST_SPACECRAFT = (_HOST_ATTITUDE.split("#define ATTITUDE")[0] + r"""
#define SPACECRAFT(S)                                                                  \
  extern "C" void sc_##S(const double* x, const double* u, const double* p, double dt,  \
                         int kind, double* out, int B) {                                \
    run<cddp::S>(x, u, p, dt, kind, out, B);                                            \
  }
SPACECRAFT(SpacecraftLinearFuel)
SPACECRAFT(SpacecraftNonlinear)
SPACECRAFT(SpacecraftLanding2D)
SPACECRAFT(SpacecraftTwobody)
""")


@pytest.fixture(scope="module")
def spacecraft_structs(tmp_path_factory):
    """``models.cuh``'s spacecraft structs compiled for the host with g++
    (``-ffp-contract=off``, as the float64 build's ``--fmad=false``) against
    the stand-in ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA structs for the host")
    d = tmp_path_factory.mktemp("spacecraft_structs")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "sc.cpp").write_text(_HOST_SPACECRAFT)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", str(d / "sc.cpp"), "-o",
                    str(d / "sc.so")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "sc.so"))


def _struct_call(lib, model, X, U, kind):
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).kernel_params(model), np.float64)
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    nx, nu = X.shape[1], U.shape[1]
    out = np.zeros((len(X), nx * (nx + nu)) if kind == -2 else X.shape)
    getattr(lib, f"sc_{type(model).__name__}")(ptr(X), ptr(U), ptr(p), ctypes.c_double(0.1),
                                               ctypes.c_int(kind), ptr(out),
                                               ctypes.c_int(len(X)))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_cuda_struct_matches_plain_model(name, spacecraft_structs):
    """``f`` on the struct's parameter vector against the plain model's
    forward, and each stepper of ``integrate`` against the plain lane step
    (1e-12: the nonlinear and two-body structs take the lanes' s sqrt(s)
    where the models take a power and a norm); ``fxfu``, the analytic
    Jacobians the whole solves linearize with, against the plain model's
    AD Jacobians (1e-10 relative), the fuel model's at u = 0 too, where
    u / sqrt(|u|^2 + eps) is steepest."""
    model = port_model(jax_model(name))
    X, U = _states(name, 64, seed=5)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(_struct_call(spacecraft_structs, model, X, U, -1),
                               model(Xt, Ut, None).numpy(), **TOL)
    entry = rollout_ops.model_entry(model)
    for kind, stepper in enumerate(rollout_ops.INTEGRATORS):
        want = rollout_ops.lane_step(model, entry, stepper, Xt, Ut,
                                     torch.tensor(0.1, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(_struct_call(spacecraft_structs, model, X, U, kind), want,
                                   **TOL)
    nx, nu = X.shape[1], U.shape[1]
    got = _struct_call(spacecraft_structs, model, X, U, -2)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    scale = lambda a: 1e-12 * np.abs(a).max()  # noqa: E731
    np.testing.assert_allclose(got[:, :nx * nx].reshape(-1, nx, nx), Fx.numpy(), rtol=1e-10,
                               atol=scale(Fx.numpy()))
    np.testing.assert_allclose(got[:, nx * nx:].reshape(-1, nx, nu), Fu.numpy(), rtol=1e-10,
                               atol=scale(Fu.numpy()))
    if name == "sc_linear_fuel":
        assert not U[1].any() and np.all(got[1, nx * nx + 6 * nu:nx * nx + 8 * nu] == 0.0)


# --- the kernels' plain versions at the new shapes -----------------------------------


def sc_box(name, horizon):
    """``chip_smoke.sc_problem``'s problem in JAX: the model's defaults, rk4,
    the spec's costs, goal, x0 and control box."""
    dt, x0, _, Q, R, Qf, lower, upper = chip_smoke.SC_SPECS[name]
    twobody = name == "sc_twobody"
    goal = chip_smoke.circular_state(horizon * dt) if twobody else np.zeros(len(Q))
    x0 = chip_smoke.circular_state(0.0) if twobody else x0
    model = getattr(jsc, JAX_CLASS[name])(integration_type="rk4")
    return ct.problem(
        model, ct.quadratic_objective(jnp.diag(jnp.asarray(Q)), jnp.diag(jnp.asarray(R)),
                                      jnp.diag(jnp.asarray(Qf)), jnp.asarray(goal), dt),
        jnp.asarray(x0), horizon, dt,
    ).add_constraint("ControlConstraint", ct.control_constraint(jnp.asarray(lower),
                                                                jnp.asarray(upper)))


def x0_batch(name, B, seed):
    """The fleets' x0: x0 + widths (U(0, 1) - 0.5) (``chip_smoke.fleet_x0``)."""
    jp = sc_box(name, 2)
    widths = np.asarray(chip_smoke.SC_SPECS[name][2])
    return np.asarray(jp.x0) + widths * (np.random.default_rng(seed).uniform(size=(B, len(
        widths))) - 0.5)


@pytest.mark.parametrize("name", ["sc_linear_fuel", "sc_nonlinear", "sc_landing2d"])
def test_riccati_plain_matches_jax_scan(name):
    """Kernel 1 at 8x3, 10x3 (27 BoxQP active sets) and 6x2 (9)."""
    jp = sc_box(name, 5)
    args, _, _ = _stage_inputs(jp, 3, seed=6)
    got = riccati.riccati_backward_plain(*(torch.as_tensor(np.array(a)) for a in args))
    want = jax.jit(jax.vmap(_scan_backward_single))(*(jnp.asarray(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                       err_msg=f"output {i}")
    assert (jp.state_dim, jp.control_dim) in riccati.KERNEL_SHAPES


def _rollout_inputs(name, jp, B, seed):
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    rng = np.random.default_rng(seed)
    X = np.asarray([np.asarray(jrollout(jp.model, jnp.asarray(x), jnp.asarray(
        np.asarray(jp.get_constraint("ControlConstraint").upper) * 0.5 * np.ones((N, nu))),
        jp.timestep)) for x in x0_batch(name, B, seed)])
    cc = jp.get_constraint("ControlConstraint")
    lo, hi = np.asarray(cc.lower), np.asarray(cc.upper)
    Ub = lo + (hi - lo) * rng.uniform(-0.2, 1.2, size=(B, N, nu))
    k = 0.5 * (hi - lo) * rng.normal(size=(B, N, nu))
    K = 0.01 * rng.normal(size=(B, N, nu, nx))
    return X, Ub, k, K, np.asarray([1.0, 0.5, 0.25])[:B]


@pytest.mark.parametrize("name", MODELS)
def test_forward_rollout_plain_matches_jax_scan(name):
    """Kernel 2's goal form on the model's lane, clamped to the box."""
    jp = sc_box(name, 6)
    Xb, Ub, k, K, alpha = _rollout_inputs(name, jp, 3, seed=7)
    cc, o = jp.get_constraint("ControlConstraint"), jp.objective
    single = functools.partial(jlane._scan_forward_single, type(jp.model).__name__, "rk4",
                               True, False)
    Xw, Uw, Jw = jax.jit(jax.vmap(single, in_axes=(0,) * 5 + (None,) * 8))(
        *(jnp.asarray(a) for a in (Xb[:, :-1], Ub, k, K, alpha)), jnp.asarray(jp.timestep),
        jnp.asarray(model_params(jp.model)), o.Q, o.R, o.Qf, o.reference_state, cc.lower,
        cc.upper)
    consts = rollout_ops.lane_consts(port_zoo_problem(jp))
    assert consts.rollout and consts.tag == "@" + name
    assert consts.clddp == chip_smoke.whole_takes("clddp_solve", name)
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    dispatch_log.reset()
    Xt, Ut, Jt = rollout_ops.forward_rollout(consts, t[0][:, :-1], t[1], t[2], t[3],
                                             t[0][:, 0], t[4])
    assert not dispatch_log.launches
    for g, w in ((Xt, Xw), (Ut, Uw), (Jt, Jw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9 * max(1.0, float(np.abs(np.asarray(w)).max())))
    assert np.any(Ut.numpy() == np.asarray(cc.upper)) and np.any(Ut.numpy()
                                                                 == np.asarray(cc.lower))


@pytest.mark.parametrize("name", MODELS)
def test_open_loop_rollout_plain_matches_jax(name):
    """Kernel 4's plain version against ``cddp_tpu.models.base.rollout``
    (the JAX model's own rk4) from the fleets' x0."""
    jp = sc_box(name, 10)
    _, Ub, _, _, _ = _rollout_inputs(name, jp, 3, seed=8)
    x0 = x0_batch(name, 3, seed=9)
    want = np.stack([np.asarray(jrollout(jp.model, jnp.asarray(a), jnp.asarray(u),
                                         jp.timestep)) for a, u in zip(x0, Ub)])
    model = port_zoo_problem(jp).model
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(Ub), jp.timestep)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_fuel_open_loop_matches_pallas_interpret():
    """The fuel model's open-loop Pallas kernel in interpret mode (float32,
    as tests/test_model_lanes.py:133-160 runs it) against the port's plain
    rollout in float32 on the same inputs, and both near the float64 one."""
    jp = sc_box("sc_linear_fuel", 7)
    model = jp.model
    n_mp, mp_fn, model_f, disc = jip.model_lane(model)
    lane_key = (type(model), disc, model.integration_type)
    jip._OL_LANES_BY_KEY[lane_key] = dict(model_f=model_f, model_discrete=disc,
                                          integrator=model.integration_type)
    B, N = 3, jp.horizon
    x0 = x0_batch("sc_linear_fuel", B, seed=10).astype(np.float32)
    U = np.random.default_rng(11).uniform(-0.004, 0.004, (B, N, 3)).astype(np.float32)
    U[0, :2] = 0.0
    mp = jnp.broadcast_to(jnp.asarray(mp_fn(model), jnp.float32)[None], (B, n_mp))
    want = np.asarray(jax.jit(lambda *a: jip._ol_fused_impl(*a, lane_key=lane_key,
                                                             interpret=True))(
        jnp.asarray(U), jnp.asarray(x0), jnp.full((B,), 30.0, jnp.float32), mp))
    port = port_zoo_problem(jp).model
    got = ip_rollout.open_loop_rollout_plain(port.to(torch.float32), torch.as_tensor(x0),
                                             torch.as_tensor(U), 30.0).numpy()
    np.testing.assert_allclose(got[:, 1:], want, rtol=2e-5, atol=2e-6)  # x_1..x_N
    truth = ip_rollout.open_loop_rollout_plain(port.double(), torch.as_tensor(x0).double(),
                                               torch.as_tensor(U).double(), 30.0).numpy()
    np.testing.assert_allclose(got, truth, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["sc_nonlinear", "sc_landing2d"])
def test_ip_forward_plain_matches_jax_scan(name):
    """Kernel 5 on the control box, goal form, at m = 6 (10x3) and m = 4
    (6x2)."""
    jp = sc_box(name, 5)
    N, nx, nu, m, B = jp.horizon, jp.state_dim, jp.control_dim, 2 * jp.control_dim, 4
    p = port_zoo_problem(jp)
    stk = PathStacker(p)
    fc = ip_rollout.resolve_ip_forward(p, tt.CDDPOptions(), stk)
    assert fc is not None and fc.rows.m == stk.total_dim == m and fc.lane.variant == ""
    rng = np.random.default_rng(12)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    Xb, Ub, _, _, _ = _rollout_inputs(name, jp, B, seed=13)
    a = dict(Xb=Xb[:, :-1], Ub=Ub, Y=np.abs(n(N, m)) + 0.1, S=np.abs(n(N, m)) + 0.1,
             ku=n(N, nu) * 0.1, Ku=n(N, nu, nx) * 0.01, klam=n(N, nx), Klam=n(N, nx, nx),
             lam=n(N, nx), ky=n(N, m), Ky=n(N, m, nx, scale=0.01), ks=n(N, m),
             Ks=n(N, m, nx, scale=0.01), x0=Xb[:, 0], a_pr=rng.uniform(0.2, 1.0, B),
             a_du=rng.uniform(0.2, 1.0, B), tau=np.full(B, 0.99), soc=np.ones(B))
    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    _, cparams, _, cost_f = jip.cost_lane(jp.objective)
    cc = jp.get_constraint("ControlConstraint")
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(jp.timestep), bc(jnp.asarray(model_params(jp.model))), bc(cparams),
              jnp.zeros((B, N, 1)), bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
        nx, nu, m, model_f, model_discrete, "rk4", cost_f, False, ("control",), *v)))(*jargs)
    t = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    dispatch_log.reset()
    got = ip_rollout.ip_forward(fc, *t.values())
    assert not dispatch_log.launches
    for label, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                   err_msg=label)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[1]), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("shape", [(8, 3, 6), (10, 3, 6), (6, 2, 4)])
def test_ipddp_backward_plain_matches_jax_scan(shape):
    """Kernel 6 at (8, 3, 6), (10, 3, 6) and (6, 2, 4), on random stage
    data, rtol 1e-9 and atol 1e-11."""
    args = _stage_data(3, 4, *shape, seed=sum(shape))
    want = jax.jit(jax.vmap(_condensed_scan_single))(*(jnp.asarray(a) for a in args))
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*(torch.as_tensor(a) for a in args))
    assert dispatch_log.launches == {} and shape in ipddp_riccati.KERNEL_SHAPES
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=f"output {i}")


# --- the kernels' tables and routes ---------------------------------------------------


def _longest(gate, name, jopts, stop=80):
    """The longest horizon at which the JAX ``gate`` takes the model's
    problem, by bisection (the gates' scratch estimates grow with N)."""
    lo, hi = 1, stop
    assert gate(sc_box(name, lo), jopts) and not gate(sc_box(name, hi), jopts)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gate(sc_box(name, mid), jopts) else (lo, mid)
    return lo


@pytest.mark.parametrize("name", MODELS)
def test_whole_solve_horizons_follow_jax_gates(name):
    """``rollout.WHOLE_MAX_HORIZON`` is, for each whole solve of CLDDP,
    IPDDP and LogDDP that takes the model, the longest horizon the JAX
    package's gate takes it at; the port's predicates take it there and
    refuse it one step further. The whole solves the tables leave out
    (``chip_smoke.whole_takes``: their float32 forks, ROADMAP C.13) refuse
    it at every horizon, where JAX takes them. Kernel 8's JAX gate refuses each
    model at N = 20 and takes it only at short horizons, where the port
    refuses it (a route difference, ROADMAP C.11)."""
    jopts, opts = ct.CDDPOptions(max_iterations=10), tt.CDDPOptions(max_iterations=10)
    gates = (("clddp_solve", jclddp.mega_eligible, mega_clddp.mega_eligible),
             ("ipddp_solve", jipddp.mega_eligible, mega_ipddp.mega_eligible),
             ("logddp_solve", jlogddp.mega_log_eligible, mega_logddp.mega_eligible))
    for kernel, jax_gate, gate in gates:
        limit = _longest(jax_gate, name, jopts)
        taken = chip_smoke.whole_takes(kernel, name)
        assert (name in rollout_ops.WHOLE_MAX_HORIZON[kernel]) == taken, kernel
        if taken:
            assert rollout_ops.WHOLE_MAX_HORIZON[kernel][name] == limit, kernel
        for horizon, admitted in ((min(limit, 20), True), (limit, True), (limit + 1, False)):
            assert gate(port_zoo_problem(sc_box(name, horizon)), opts) == (admitted and taken), (
                kernel, horizon)
    ms = _longest(jmsipddp.mega_ms_eligible, name, jopts)
    assert ms < 20 and not jmsipddp.mega_ms_eligible(sc_box(name, 20), jopts)
    assert not mega_msipddp.mega_eligible(port_zoo_problem(sc_box(name, ms)), opts)


def test_tables_take_the_models_but_kernel_8():
    """Every per-pass kernel takes the four models but kernel 1 the
    two-body model (``riccati.LEFT_OUT_MODELS``: float32 cannot carry its
    recursion); of the whole solves, kernels 3 and 7 take the nonlinear
    model (up to N = 18 and 19) and kernel 9 the fuel model (at the MPC
    horizon N = 20), the others none of them (ROADMAP C.13); kernel 8 none
    at all."""
    opts = tt.CDDPOptions(max_iterations=3)
    whole = {"sc_linear_fuel": {"logddp_solve": 20}, "sc_nonlinear": {
        "clddp_solve": 18, "ipddp_solve": 19}, "sc_landing2d": {}, "sc_twobody": {}}
    gates = {"clddp_solve": mega_clddp, "ipddp_solve": mega_ipddp, "logddp_solve": mega_logddp}
    for name in MODELS:
        p = port_zoo_problem(sc_box(name, 20))
        nx, nu, m = chip_smoke.SC_SHAPES[name]
        assert (nx, nu) in riccati.KERNEL_SHAPES and (nx, nu, m) in ipddp_riccati.KERNEL_SHAPES
        assert clddp._use_kernels(p, opts) == (name != "sc_twobody")
        assert ip_rollout.resolve_ip_forward(p, opts, PathStacker(p)).rows.m == m
        assert not mega_msipddp.mega_eligible(p, opts)
        assert {k for k in gates if chip_smoke.whole_takes(k, name)} == set(whole[name])
        for kernel, gate in gates.items():
            if kernel in whole[name]:
                short = port_zoo_problem(sc_box(name, whole[name][kernel]))
                assert gate.mega_eligible(short, opts)
                assert gate.mega_eligible(p, opts) == (whole[name][kernel] == 20)
            else:
                assert not gate.mega_eligible(p, opts)
        assert (mega_ipddp.solve_variant(p) == f"m{m}") == (name in mega_ipddp.IP_BOX_ROWS)


@pytest.mark.parametrize("name,solver,engine,logged", [
    # On CPU tensors the whole-solve dispatch runs the per-pass plain driver,
    # whose passes log too.
    ("sc_linear_fuel", "CLDDP", "auto", ["riccati_backward@8x3",
                                         "forward_rollout@sc_linear_fuel"]),
    ("sc_linear_fuel", "LogDDP", "auto", ["open_loop_rollout@sc_linear_fuel",
                                          "logddp_solve@sc_linear_fuel"]),
    ("sc_nonlinear", "CLDDP", "auto", ["riccati_backward@10x3", "forward_rollout@sc_nonlinear"]),
    ("sc_nonlinear", "IPDDP", "auto", ["open_loop_rollout@sc_nonlinear",
                                       "ip_forward@sc_nonlinear", "ipddp_backward@10x3x6"]),
    ("sc_landing2d", "IPDDP", "auto", ["open_loop_rollout@sc_landing2d",
                                       "ip_forward@sc_landing2d", "ipddp_backward@6x2x4"]),
    ("sc_twobody", "IPDDP", "auto", ["open_loop_rollout@sc_twobody",
                                     "ip_forward@sc_twobody", "ipddp_backward@6x3x6"]),
    ("sc_twobody", "LogDDP", "auto", ["open_loop_rollout@sc_twobody"]),
    ("sc_twobody", "MSIPDDP", "auto", ["open_loop_rollout@sc_twobody"]),
    ("sc_twobody", "CLDDP", "auto", ["forward_rollout@sc_twobody"]),
])
def test_route_is_chosen_before_any_launch(name, solver, engine, logged, caplog):
    """What a CPU solve at the MPC horizon logs where a CUDA one would
    launch: kernel 8 never, the nonlinear model's CLDDP and IPDDP per pass
    (past the JAX gates), the two-body model's CLDDP without kernel 1 (its
    plain Riccati recursion logs nothing), the whole solves the tables
    take, per pass (or,
    for LogDDP, the plain driver after kernel 4's seed) where they leave the
    model out, the per-pass kernels under the model's name or shape."""
    p = port_zoo_problem(sc_box(name, 20))
    x0 = torch.as_tensor(x0_batch(name, 2, seed=14))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=1, solve_engine=engine))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(logged)
