"""The port's small models (Bicycle, DubinsCar, DreyfusRocket, Acrobot)
against the JAX package (CPU, float64):

- each model's continuous dynamics and AD Jacobians against the JAX model,
  on the oracle states of tests/test_model_oracles.py:171-350 and on states
  about the fleets' (1e-12; the acrobot's Cramer solve against the JAX
  model's LU solve 1e-10);
- the registry's parameter vectors against the JAX lane vectors,
  ``interop`` carrying each model across and refusing a short vector, the
  lane step against the JAX lane;
- the CUDA structs of ``models.cuh`` built for the host (g++) against the
  plain models: ``f`` and every stepper of ``integrate`` (1e-12), ``fxfu``
  against the AD Jacobians (1e-10 relative);
- the plain versions of kernels 1, 2, 4, 5 and 6 at the models' shapes
  (the new 3x1, 3x1x2 and 4x1x2 among them) against the JAX scan
  references, and the acrobot's open-loop rollout against the Pallas kernel
  in interpret mode;
- ``rollout.WHOLE_MAX_HORIZON`` derived from the JAX gates, kernel 8's
  included, and the routes a solve takes.

The problems are ``chip_smoke.py``'s (``SMALL_SPECS``), built here in JAX.
The solves are in ``tests/test_torch_ground_models_solvers.py``.
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
from cddp_tpu import models as jmodels
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
MODELS = chip_smoke.SMALL_MODELS
JAX_CLASS = {m: c for c, m in chip_smoke.SMALL_CLASSES.items()}
# (JAX model with non-default parameters where the oracle has them, the
# oracle state and control of tests/test_model_oracles.py:171-350).
ORACLES = {
    "bicycle": (jmodels.Bicycle(wheelbase=2.0), [0.0, 0.0, 0.0, 1.0], [0.0, 0.1]),
    "dubins_car": (jmodels.DubinsCar(speed=1.5), [0.0, 0.0, -0.9], [0.7]),
    "dreyfus_rocket": (jmodels.DreyfusRocket(), [1.0, 3.0], [0.2]),
    "acrobot": (jmodels.Acrobot(), [0.3, -0.5, 0.8, 0.2], [0.9]),
}
# The acrobot's plain model solves its mass matrix by Cramer's rule, the
# JAX model by LU: the two round apart (M is well conditioned).
DYN_TOL = {"acrobot": dict(rtol=1e-10, atol=1e-12)}


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
    x0 (``SMALL_SPECS``) with controls across twice the box."""
    rng = np.random.default_rng(seed)
    _, x_or, u_or = ORACLES[name]
    s = chip_smoke.SMALL_SPECS[name]
    spread = np.maximum(np.asarray(s.widths), 0.5)
    X = np.asarray(s.x0) + spread * rng.uniform(-1.0, 1.0, (B - 1, len(s.x0)))
    lo, hi = np.asarray(s.lower), np.asarray(s.upper)
    U = (lo + hi) / 2 + (hi - lo) * rng.uniform(-1.0, 1.0, (B - 1, len(lo)))
    return np.vstack([x_or, X]), np.vstack([u_or, U])


def _jax_rows(fn, X, U):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(X), jnp.asarray(U)))


@pytest.mark.parametrize("name", MODELS)
def test_dynamics_and_jacobians_match_jax(name):
    jm = jax_model(name)
    X, U = _states(name, 16, seed=1)
    model = port_model(jm)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    tol = DYN_TOL.get(name, TOL)
    np.testing.assert_allclose(model(Xt, Ut, None).numpy(), _jax_rows(
        lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **tol)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    jFx, jFu = (_jax_rows(lambda x, u, i=i: jm.jacobians(x, u, 0.0)[i], X, U) for i in (0, 1))
    np.testing.assert_allclose(Fx.numpy(), jFx, **tol)
    np.testing.assert_allclose(Fu.numpy(), jFu, **tol)


def test_models_are_exported_with_the_jax_defaults():
    """The four classes in ``cddp_tpu_torch`` and its ``models``, their
    buffers float64 in the JAX field order with the JAX defaults."""
    for cls_name in JAX_CLASS.values():
        cls = getattr(tt, cls_name)
        port, jm = cls(), getattr(jmodels, cls_name)()
        fields = [n for n, _ in port.named_buffers()]
        assert all(getattr(port, n).dtype == torch.float64 for n in fields)
        assert fields == [f for f in type(jm).__dataclass_fields__
                          if f not in ("state_dim", "control_dim", "integration_type")]
        assert [float(getattr(port, n)) for n in fields] == [getattr(jm, n) for n in fields]
        assert (port.state_dim, port.control_dim) == (jm.state_dim, jm.control_dim)
        assert port.integration_type == "euler"


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
    """Each model crosses with its parameters and integrator, steps as the
    JAX model does, and a vector one value short is refused."""
    jm = jax_model(name)
    nx, nu = jm.state_dim, jm.control_dim
    model = port_model(jm)
    assert type(model).__name__ == type(jm).__name__ and model.integration_type == "rk4"
    X, U = _states(name, 6, seed=3)
    np.testing.assert_allclose(
        model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), 0.0, 0.1).numpy(),
        _jax_rows(lambda x, u: jm.discrete_dynamics(x, u, 0.0, 0.1), X, U),
        **DYN_TOL.get(name, TOL))
    n = len(model_params(jm))
    with pytest.raises(ValueError, match=f"takes {n}"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(nu),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, 0.1, "rk4",
                            device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("name", MODELS)
def test_lane_step_matches_jax_lane(name):
    """One rk4 step of the kernels' stage arithmetic on the plain model
    (``rollout.lane_step``) against the JAX lane's integrator over its lane
    function (the bicycle's tan against the lane's sin / cos: 1e-12)."""
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

_HOST_SMALL = (_HOST_ATTITUDE.split("#define ATTITUDE")[0] + r"""
#define SMALL(S)                                                                       \
  extern "C" void small_##S(const double* x, const double* u, const double* p, double dt, \
                            int kind, double* out, int B) {                               \
    run<cddp::S>(x, u, p, dt, kind, out, B);                                              \
  }
SMALL(Bicycle)
SMALL(DubinsCar)
SMALL(DreyfusRocket)
SMALL(Acrobot)
""")


@pytest.fixture(scope="module")
def small_structs(tmp_path_factory):
    """``models.cuh``'s small-model structs compiled for the host with g++
    (``-ffp-contract=off``, as the float64 build's ``--fmad=false``) against
    the stand-in ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA structs for the host")
    d = tmp_path_factory.mktemp("small_structs")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "small.cpp").write_text(_HOST_SMALL)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", str(d / "small.cpp"), "-o",
                    str(d / "small.so")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "small.so"))


def _struct_call(lib, model, X, U, kind):
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).kernel_params(model), np.float64)
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    nx, nu = X.shape[1], U.shape[1]
    out = np.zeros((len(X), nx * (nx + nu)) if kind == -2 else X.shape)
    getattr(lib, f"small_{type(model).__name__}")(ptr(X), ptr(U), ptr(p), ctypes.c_double(0.1),
                                                  ctypes.c_int(kind), ptr(out),
                                                  ctypes.c_int(len(X)))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_cuda_struct_matches_plain_model(name, small_structs):
    """``f`` on the struct's parameter vector against the plain model's
    forward, and each stepper of ``integrate`` against the plain lane step
    (the same expressions in the same order: 1e-12, the host's libm against
    torch's); ``fxfu``, the analytic Jacobians the whole solves linearize
    with (the acrobot's and DreyfusRocket's written by hand), against the
    plain model's AD Jacobians (1e-10 relative: the two round apart)."""
    model = port_model(jax_model(name))
    X, U = _states(name, 64, seed=5)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(_struct_call(small_structs, model, X, U, -1),
                               model(Xt, Ut, None).numpy(), **TOL)
    entry = rollout_ops.model_entry(model)
    for kind, stepper in enumerate(rollout_ops.INTEGRATORS):
        want = rollout_ops.lane_step(model, entry, stepper, Xt, Ut,
                                     torch.tensor(0.1, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(_struct_call(small_structs, model, X, U, kind), want, **TOL)
    nx, nu = X.shape[1], U.shape[1]
    got = _struct_call(small_structs, model, X, U, -2)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    scale = lambda a: 1e-12 * np.abs(a).max()  # noqa: E731
    np.testing.assert_allclose(got[:, :nx * nx].reshape(-1, nx, nx), Fx.numpy(), rtol=1e-10,
                               atol=scale(Fx.numpy()))
    np.testing.assert_allclose(got[:, nx * nx:].reshape(-1, nx, nu), Fu.numpy(), rtol=1e-10,
                               atol=scale(Fu.numpy()))


# --- the kernels' plain versions at the models' shapes ---------------------------------


def small_box(name, horizon):
    """``chip_smoke.small_problem``'s problem in JAX: the spec's parameters,
    rk4, its costs, goal, x0 and control box."""
    s = chip_smoke.SMALL_SPECS[name]
    model = getattr(jmodels, JAX_CLASS[name])(**s.params, integration_type="rk4")
    return ct.problem(
        model, ct.quadratic_objective(jnp.diag(jnp.asarray(s.Q)), jnp.diag(jnp.asarray(s.R)),
                                      jnp.diag(jnp.asarray(s.Qf)), jnp.asarray(s.goal), s.dt),
        jnp.asarray(s.x0), horizon, s.dt,
    ).add_constraint("ControlConstraint", ct.control_constraint(jnp.asarray(s.lower),
                                                                jnp.asarray(s.upper)))


def x0_batch(name, B, seed):
    """The fleets' x0: x0 + widths (U(0, 1) - 0.5) (``chip_smoke.fleet_x0``)."""
    s = chip_smoke.SMALL_SPECS[name]
    widths = np.asarray(s.widths)
    return np.asarray(s.x0) + widths * (np.random.default_rng(seed).uniform(size=(B, len(
        widths))) - 0.5)


@pytest.mark.parametrize("name", ["dubins_car", "bicycle"])
def test_riccati_plain_matches_jax_scan(name):
    """Kernel 1 at DubinsCar's new 3x1 (3 BoxQP active sets) and the
    bicycle's 4x2 (9)."""
    jp = small_box(name, 5)
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
    cc = jp.get_constraint("ControlConstraint")
    lo, hi = np.asarray(cc.lower), np.asarray(cc.upper)
    X = np.asarray([np.asarray(jrollout(jp.model, jnp.asarray(x), jnp.asarray(
        (lo + hi) / 2 * np.ones((N, nu))), jp.timestep)) for x in x0_batch(name, B, seed)])
    Ub = lo + (hi - lo) * rng.uniform(-0.2, 1.2, size=(B, N, nu))
    k = 0.5 * (hi - lo) * rng.normal(size=(B, N, nu))
    K = 0.01 * rng.normal(size=(B, N, nu, nx))
    return X, Ub, k, K, np.asarray([1.0, 0.5, 0.25, 0.125])[:B]


@pytest.mark.parametrize("name", MODELS)
def test_forward_rollout_plain_matches_jax_scan(name):
    """Kernel 2's goal form on the model's lane, clamped to the box."""
    jp = small_box(name, 6)
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
    jp = small_box(name, 10)
    _, Ub, _, _, _ = _rollout_inputs(name, jp, 3, seed=8)
    x0 = x0_batch(name, 3, seed=9)
    want = np.stack([np.asarray(jrollout(jp.model, jnp.asarray(a), jnp.asarray(u),
                                         jp.timestep)) for a, u in zip(x0, Ub)])
    model = port_zoo_problem(jp).model
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(Ub), jp.timestep)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, **DYN_TOL.get(name, TOL))


def test_acrobot_open_loop_matches_pallas_interpret():
    """The acrobot's open-loop Pallas kernel in interpret mode (float32, as
    tests/test_model_lanes.py:133-160 runs it) against the port's plain
    rollout in float32 on the same inputs, and both near the float64 one."""
    jp = small_box("acrobot", 7)
    model = jp.model
    n_mp, mp_fn, model_f, disc = jip.model_lane(model)
    lane_key = (type(model), disc, model.integration_type)
    jip._OL_LANES_BY_KEY[lane_key] = dict(model_f=model_f, model_discrete=disc,
                                          integrator=model.integration_type)
    B, N = 3, jp.horizon
    x0 = x0_batch("acrobot", B, seed=10).astype(np.float32)
    U = np.random.default_rng(11).uniform(-5.0, 5.0, (B, N, 1)).astype(np.float32)
    mp = jnp.broadcast_to(jnp.asarray(mp_fn(model), jnp.float32)[None], (B, n_mp))
    want = np.asarray(jax.jit(lambda *a: jip._ol_fused_impl(*a, lane_key=lane_key,
                                                             interpret=True))(
        jnp.asarray(U), jnp.asarray(x0), jnp.full((B,), jp.timestep, jnp.float32), mp))
    port = port_zoo_problem(jp).model
    got = ip_rollout.open_loop_rollout_plain(port.to(torch.float32), torch.as_tensor(x0),
                                             torch.as_tensor(U), jp.timestep).numpy()
    np.testing.assert_allclose(got[:, 1:], want, rtol=2e-5, atol=2e-6)  # x_1..x_N
    truth = ip_rollout.open_loop_rollout_plain(port.double(), torch.as_tensor(x0).double(),
                                               torch.as_tensor(U).double(),
                                               jp.timestep).numpy()
    np.testing.assert_allclose(got, truth, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", MODELS)
def test_ip_forward_plain_matches_jax_scan(name):
    """Kernel 5 on the control box, goal form, at m = 4 (the bicycle) and m
    = 2 (the others)."""
    jp = small_box(name, 5)
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


@pytest.mark.parametrize("shape", [(3, 1, 2), (4, 1, 2)])
def test_ipddp_backward_plain_matches_jax_scan(shape):
    """Kernel 6 at the new (3, 1, 2) and (4, 1, 2), on random stage data,
    rtol 1e-9 and atol 1e-11."""
    args = _stage_data(3, 4, *shape, seed=sum(shape))
    want = jax.jit(jax.vmap(_condensed_scan_single))(*(jnp.asarray(a) for a in args))
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*(torch.as_tensor(a) for a in args))
    assert dispatch_log.launches == {} and shape in ipddp_riccati.KERNEL_SHAPES
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=f"output {i}")


# --- the kernels' tables and routes ---------------------------------------------------

GATES = (("clddp_solve", jclddp.mega_eligible, mega_clddp.mega_eligible),
         ("ipddp_solve", jipddp.mega_eligible, mega_ipddp.mega_eligible),
         ("msipddp_solve", jmsipddp.mega_ms_eligible, mega_msipddp.mega_eligible),
         ("logddp_solve", jlogddp.mega_log_eligible, mega_logddp.mega_eligible))


def _longest(gate, name, jopts, stop=256):
    """The longest horizon at which the JAX ``gate`` takes the model's
    problem, by bisection (the gates' scratch estimates grow with N)."""
    lo, hi = 1, stop
    assert gate(small_box(name, lo), jopts) and not gate(small_box(name, hi), jopts)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gate(small_box(name, mid), jopts) else (lo, mid)
    return lo


@pytest.mark.parametrize("name", MODELS)
def test_whole_solve_horizons_follow_jax_gates(name):
    """``rollout.WHOLE_MAX_HORIZON`` is, for each whole solve of CLDDP,
    IPDDP, MSIPDDP and LogDDP that takes the model, the longest horizon the
    JAX package's gate takes it at; the port's predicates take it at the
    MPC horizon and there and refuse it one step further. A whole solve the
    tables leave out (``chip_smoke.whole_takes``: a float32 fork, ROADMAP
    C.14) refuses it at every horizon, where JAX takes it."""
    jopts, opts = ct.CDDPOptions(max_iterations=10), tt.CDDPOptions(max_iterations=10)
    for kernel, jax_gate, gate in GATES:
        limit = _longest(jax_gate, name, jopts)
        taken = chip_smoke.whole_takes(kernel, name)
        assert (name in rollout_ops.WHOLE_MAX_HORIZON[kernel]) == taken, kernel
        if taken:
            assert rollout_ops.WHOLE_MAX_HORIZON[kernel][name] == limit, kernel
        for horizon, admitted in ((min(limit, 20), True), (limit, True), (limit + 1, False)):
            assert gate(port_zoo_problem(small_box(name, horizon)), opts) == (
                admitted and taken), (kernel, horizon)


def test_tables_take_the_models():
    """Every per-pass kernel takes the four models at their shapes (kernel
    1 at 4x2, 3x1, 2x1, 4x1; kernel 6 at 4x2x4, 3x1x2, 2x1x2, 4x1x2; kernel
    5 at m = 4 and 2); the whole solves their tables keep
    (``chip_smoke.whole_takes``) take them at the MPC horizon N = 20, and
    kernel 8 is held to its gate's horizon, which no table held before."""
    opts = tt.CDDPOptions(max_iterations=3)
    gates = {"clddp_solve": mega_clddp, "ipddp_solve": mega_ipddp,
             "msipddp_solve": mega_msipddp, "logddp_solve": mega_logddp}
    assert set(rollout_ops.WHOLE_MAX_HORIZON["msipddp_solve"]) <= set(MODELS)
    for name in MODELS:
        p = port_zoo_problem(small_box(name, 20))
        nx, nu, m = chip_smoke.SMALL_SHAPES[name]
        assert (nx, nu) in riccati.KERNEL_SHAPES and (nx, nu, m) in ipddp_riccati.KERNEL_SHAPES
        assert clddp._use_kernels(p, opts)
        assert ip_rollout.resolve_ip_forward(p, opts, PathStacker(p)).rows.m == m
        for kernel, mod in gates.items():
            assert mod.mega_eligible(p, opts) == chip_smoke.whole_takes(kernel, name), kernel
        assert (mega_ipddp.solve_variant(p) == f"m{m}") == (name in mega_ipddp.IP_BOX_ROWS)


@pytest.mark.parametrize("name,solver,horizon,logged", [
    # On CPU tensors the whole-solve dispatch runs the per-pass plain driver,
    # whose passes log too.
    ("bicycle", "CLDDP", 20, ["clddp_solve@bicycle", "riccati_backward@4x2",
                              "forward_rollout@bicycle"]),
    ("bicycle", "CLDDP", 100, ["riccati_backward@4x2", "forward_rollout@bicycle"]),
    ("dubins_car", "IPDDP", 100, ["open_loop_rollout@dubins_car", "ip_forward@dubins_car",
                                  "ipddp_backward@3x1x2"]),
    ("dubins_car", "CLDDP", 100, ["clddp_solve@dubins_car", "riccati_backward@3x1",
                                  "forward_rollout@dubins_car"]),
    ("dreyfus_rocket", "IPDDP", 100, ["open_loop_rollout@dreyfus_rocket",
                                      "ipddp_solve@dreyfus_rocket", "ip_forward@dreyfus_rocket",
                                      "ipddp_backward@2x1x2"]),
    ("bicycle", "MSIPDDP", 22, ["open_loop_rollout@bicycle", "msipddp_solve@bicycle"]),
    ("bicycle", "MSIPDDP", 23, ["open_loop_rollout@bicycle"]),
    ("acrobot", "MSIPDDP", 20, ["open_loop_rollout@acrobot"]),
    ("acrobot", "LogDDP", 20, ["open_loop_rollout@acrobot", "logddp_solve@acrobot"]),
])
def test_route_is_chosen_before_any_launch(name, solver, horizon, logged, caplog):
    """What a CPU solve logs where a CUDA one would launch: the whole solve
    up to its JAX gate's horizon (kernel 8 on the bicycle to N = 22, then
    the plain driver after kernel 4's seed), per pass past it (the bicycle's
    CLDDP at N = 100, DubinsCar's IPDDP at N = 100, where its CLDDP and
    DreyfusRocket's IPDDP stay whole), the plain driver where a table leaves
    the pair out (kernel 8 on the acrobot, ROADMAP C.14), the per-pass
    kernels under the model's name or shape."""
    p = port_zoo_problem(small_box(name, horizon))
    x0 = torch.as_tensor(x0_batch(name, 2, seed=14))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=1))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(logged)
