"""The port's attitude trio (EulerAttitude, QuaternionAttitude, MrpAttitude)
against the JAX package (CPU, float64):

- each model's continuous dynamics and AD Jacobians against the JAX model
  (1e-12), on states at Euler's cos(theta) guard and on unnormalized
  quaternions (one below the norm guard), for a diagonal and a full
  inertia; the hoisted LU factors; the builders' device;
- the registry's parameter vectors against the JAX lane vectors,
  ``interop`` carrying each model across, the lane step against the JAX
  lane (whose adjugate inverse and sin/cos tangent round apart: 1e-12);
- the CUDA structs of ``models.cuh`` built for the host (g++) against the
  plain models: ``f`` and every stepper of ``integrate`` at 1e-12, ``fxfu``
  against the AD Jacobians (1e-10 relative);
- the plain versions of kernels 1, 2, 4, 5 and 6 at the trio's shapes (6x3,
  7x3; m = 6) against the JAX scan references, and the MRP lane's open-loop
  rollout against the Pallas kernel in interpret mode;
- the kernels' tables and the routes a solve takes: the whole solves of
  CLDDP, IPDDP and LogDDP take the trio, MSIPDDP's does not.

The solves are in ``tests/test_torch_attitude_solvers.py``.
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
import cddp_tpu_torch as tt
from cddp_tpu.models import euler_attitude as jeuler
from cddp_tpu.models import mrp_attitude as jmrp
from cddp_tpu.models import quaternion_attitude as jquat
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import rollout as jlane
from cddp_tpu.ops.pallas.riccati import _scan_backward_single
from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.models import (EulerAttitude, MrpAttitude, QuaternionAttitude,
                                   euler_attitude, rollout)
from cddp_tpu_torch.models.attitude import lu_substitute
from cddp_tpu_torch.ops.kernels import (dispatch_log, ip_rollout, ipddp_riccati, mega_clddp,
                                        mega_ipddp, mega_logddp, mega_msipddp, riccati)
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from cddp_tpu_torch.utils import rotations
from test_torch_models import model_params
from test_torch_quadrotor import _stage_data
from test_torch_zoo import _stage_inputs, port_zoo_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
DIAG = np.diag([10.0, 15.0, 20.0])  # examples/spacecraft_examples.py:61
# A full symmetric positive-definite inertia whose LU factorization pivots.
FULL = np.array([[2.0, 0.5, 3.0], [0.5, 4.0, 0.2], [3.0, 0.2, 6.0]])
FACTORIES = {"euler_attitude": jeuler, "quaternion_attitude": jquat, "mrp_attitude": jmrp}
PORT = {"EulerAttitude": EulerAttitude, "QuaternionAttitude": QuaternionAttitude,
        "MrpAttitude": MrpAttitude}
MODELS = sorted(FACTORIES)


def jax_model(name, inertia=DIAG):
    return FACTORIES[name](inertia=jnp.asarray(inertia))


def port_model(jm):
    return PORT[type(jm).__name__](np.reshape(model_params(jm), (3, 3)), device="cpu")


def at_rest(name, sigma):
    """States (B, nx) at rest at the MRPs ``sigma`` (B, 3) in the model's
    coordinates, through the port's ``utils/rotations.py``."""
    s = torch.as_tensor(sigma, dtype=torch.float64)
    if name == "mrp_attitude":
        att = s
    elif name == "quaternion_attitude":
        att = rotations.mrp_to_quat(s)
    else:
        att = rotations.rotation_matrix_to_euler_zyx(rotations.mrp_to_rotation_matrix(s))
    return torch.cat([att, torch.zeros_like(s)], -1).numpy()


def _states(name, B, seed):
    """Turning bodies at random attitudes (unnormalized quaternions: the
    model normalizes) and torques; the first state at Euler's guard (theta
    = pi/2, |cos| < 1e-9) or a quaternion below the norm guard, the second
    an unnormalized quaternion of norm 3."""
    rng = np.random.default_rng(seed)
    nx = 7 if name == "quaternion_attitude" else 6
    X = rng.normal(size=(B, nx))
    X[:, -3:] *= 0.5
    if name == "euler_attitude":
        X[0, 1] = np.pi / 2
    if name == "quaternion_attitude":
        X[:, :4] += np.array([1.0, 0.0, 0.0, 0.0])
        X[0, :4] = 1e-10
        X[1, :4] *= 3.0 / np.linalg.norm(X[1, :4])
    return X, rng.uniform(-2.0, 2.0, size=(B, 3))


def _jax_rows(fn, X, U):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(X), jnp.asarray(U)))


@pytest.mark.parametrize("inertia", ["diag", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_dynamics_and_jacobians_match_jax(name, inertia):
    jm = jax_model(name, DIAG if inertia == "diag" else FULL)
    X, U = _states(name, 16, seed=1)
    model = port_model(jm)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(model(Xt, Ut, None).numpy(), _jax_rows(
        lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **TOL)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    jFx, jFu = (_jax_rows(lambda x, u, i=i: jm.jacobians(x, u, 0.0)[i], X, U) for i in (0, 1))
    np.testing.assert_allclose(Fx.numpy(), jFx, **TOL)
    np.testing.assert_allclose(Fu.numpy(), jFu, **TOL)


def test_lu_factors_are_hoisted_once():
    """The factors are ``torch.linalg.lu_factor``'s, computed once for each
    dtype (anew after a cast), and the substitution solves as
    ``torch.linalg.solve`` does to rounding (the diagonal inertia exactly)."""
    rng = np.random.default_rng(2)
    for inertia, rtol in ((DIAG, 0.0), (FULL, 1e-14)):
        model = euler_attitude(inertia, device="cpu")
        LU, piv = model.lu_factors()
        want = torch.linalg.lu_factor(torch.as_tensor(inertia))
        assert torch.equal(LU, want[0]) and torch.equal(piv, want[1])
        assert model.lu_factors()[0] is LU
        b = torch.as_tensor(rng.normal(size=(5, 3)))
        rows = [r.unbind(-1) for r in LU.unbind(-2)]
        got = torch.stack(lu_substitute(rows, [int(p) - 1 for p in piv], b.unbind(-1)), -1)
        np.testing.assert_allclose(got.numpy(), torch.linalg.solve(
            torch.as_tensor(inertia), b[..., None])[..., 0].numpy(), rtol=rtol, atol=1e-15)
        f32 = model.to(torch.float32).lu_factors()[0]
        assert f32.dtype == torch.float32 and f32 is not LU
    assert model.lu_factors()[1].tolist() != [1, 2, 3]  # the full inertia pivots


def test_builders_default_to_the_card(monkeypatch):
    """No device: the CUDA card, and no fallback to the CPU without one;
    the factories integrate with rk4 (the JAX factories' default)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tt.euler_attitude, tt.quaternion_attitude, tt.mrp_attitude,
                  tt.EulerAttitude, tt.QuaternionAttitude, tt.MrpAttitude):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    model = tt.mrp_attitude(DIAG, device="cpu", dtype=torch.float32)
    assert model.inertia.dtype == torch.float32 and model.integration_type == "rk4"
    assert tt.MrpAttitude(device="cpu").integration_type == "euler"
    np.testing.assert_array_equal(tt.QuaternionAttitude(device="cpu").inertia.numpy(),
                                  np.diag([1.0, 2.0, 3.0]))


@pytest.mark.parametrize("name", MODELS)
def test_registry_parameters_are_the_jax_lanes(name):
    """The lane vector is the JAX ``_inertia_params`` (rollout.py:547-553);
    the struct reads the plain model's LU factors and 0-based pivots after
    it."""
    jm = jax_model(name, FULL)
    model = port_model(jm)
    entry = rollout_ops.model_entry(model)
    assert entry.cuda_name == name and entry.tag == "@" + name and not entry.discrete
    np.testing.assert_array_equal(entry.params(model), model_params(jm))
    assert len(model_params(jm)) == jlane._REGISTRY[type(jm).__name__][0] == 9
    LU, piv = model.lu_factors()
    assert entry.kernel_params(model) == (model_params(jm).tolist() + LU.reshape(-1).tolist()
                                          + [float(p - 1) for p in piv.tolist()])


@pytest.mark.parametrize("name", MODELS)
def test_interop_carries_the_models(name):
    jm = jax_model(name, FULL).replace(integration_type="rk4")
    nx = jm.state_dim
    p = problem_from_arrays(
        type(jm).__name__, model_params(jm), np.eye(nx), np.eye(3), np.eye(nx), np.zeros(nx),
        -np.ones(3), np.ones(3), np.zeros(nx), 5, 0.05, "rk4", device="cpu",
        dtype=torch.float64)
    assert type(p.model) is PORT[type(jm).__name__] and p.model.integration_type == "rk4"
    X, U = _states(name, 6, seed=3)
    np.testing.assert_allclose(
        p.model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), 0.0, 0.05).numpy(),
        _jax_rows(lambda x, u: jm.discrete_dynamics(x, u, 0.0, 0.05), X, U), **TOL)
    with pytest.raises(ValueError, match="takes 9"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(3),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, 0.05, "rk4",
                            device="cpu", dtype=torch.float64)


def _jax_lane_step(jm, X, U, dt=0.05):
    lane_f = jlane._REGISTRY[type(jm).__name__][2]
    return np.stack([np.asarray(v) for v in jlane._integrate_lane(
        lane_f, "rk4", [jnp.asarray(X[:, i]) for i in range(X.shape[1])],
        [jnp.asarray(U[:, i]) for i in range(3)], jnp.asarray(model_params(jm)),
        jnp.full(X.shape[0], dt))], -1)


@pytest.mark.parametrize("name", MODELS)
def test_lane_step_matches_jax_lane(name):
    """One rk4 step of the kernels' stage arithmetic on the plain model
    (``rollout.lane_step``) against the JAX lane's integrator over its lane
    function, away from the guards."""
    jm = jax_model(name, FULL)
    X, U = _states(name, 8, seed=4)
    model = port_model(jm)
    got = rollout_ops.lane_step(model, rollout_ops.model_entry(model), "rk4",
                                torch.as_tensor(X[2:]), torch.as_tensor(U[2:]),
                                torch.tensor(0.05, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, _jax_lane_step(jm, X[2:], U[2:]), **TOL)


# --- the CUDA structs as host C++ ----------------------------------------------------

_HOST_ATTITUDE = r"""
#include "models.cuh"

// kind -1: the struct's f; -2: fxfu (out nx*nx then nx*3 per state); else
// one integrate<> step of stepper `kind`.
template <class M>
void run(const double* x, const double* u, const double* p, double dt, int kind, double* out,
         int B) {
  constexpr int NX = M::NX, NU = M::NU;
  for (int b = 0; b < B; ++b) {
    double xb[NX], ub[NU], o[NX], Fx[NX][NX], Fu[NX][NU];
    for (int i = 0; i < NX; ++i) xb[i] = x[b * NX + i];
    for (int i = 0; i < NU; ++i) ub[i] = u[b * NU + i];
    if (kind == -2) {
      M::fxfu(xb, ub, p, Fx, Fu);
      double* ob = out + b * NX * (NX + NU);
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) ob[i * NX + j] = Fx[i][j];
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NU; ++j) ob[NX * NX + i * NU + j] = Fu[i][j];
      continue;
    }
    if (kind == -1)
      M::f(xb, ub, p, o);
    else
      cddp::integrate<double, M>(kind, xb, ub, p, dt, o);
    for (int i = 0; i < NX; ++i) out[b * NX + i] = o[i];
  }
}

#define ATTITUDE(S)                                                                    \
  extern "C" void att_##S(const double* x, const double* u, const double* p, double dt, \
                          int kind, double* out, int B) {                               \
    run<cddp::S>(x, u, p, dt, kind, out, B);                                            \
  }
ATTITUDE(EulerAttitude)
ATTITUDE(QuaternionAttitude)
ATTITUDE(MrpAttitude)
"""


@pytest.fixture(scope="module")
def attitude_structs(tmp_path_factory):
    """``models.cuh``'s attitude structs compiled for the host with g++
    (``-ffp-contract=off``, as the float64 build's ``--fmad=false``) against
    the stand-in ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA structs for the host")
    d = tmp_path_factory.mktemp("attitude_structs")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "att.cpp").write_text(_HOST_ATTITUDE)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", str(d / "att.cpp"), "-o",
                    str(d / "att.so")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "att.so"))


def _struct_call(lib, model, X, U, kind):
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).kernel_params(model), np.float64)
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    nx = X.shape[1]
    out = np.zeros((len(X), nx * (nx + 3)) if kind == -2 else X.shape)
    getattr(lib, f"att_{type(model).__name__}")(ptr(X), ptr(U), ptr(p), ctypes.c_double(0.05),
                                                ctypes.c_int(kind), ptr(out),
                                                ctypes.c_int(len(X)))
    return out


@pytest.mark.parametrize("inertia", ["diag", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_cuda_struct_matches_plain_model(name, inertia, attitude_structs):
    """``f`` on the struct's parameter vector (``kernel_params``) against the
    plain model's forward and each stepper of ``integrate`` against the
    plain lane step (the same expressions and LU substitution in the same
    order: 1e-12, the host's libm against torch's); ``fxfu``, the analytic
    Jacobians the whole solves linearize with, against the plain model's AD
    Jacobians, on the guard states too (1e-10 relative: the two round
    apart, never bit for bit)."""
    jm = jax_model(name, DIAG if inertia == "diag" else FULL)
    model = port_model(jm)
    X, U = _states(name, 64, seed=5)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(_struct_call(attitude_structs, model, X, U, -1),
                               model(Xt, Ut, None).numpy(), **TOL)
    entry = rollout_ops.model_entry(model)
    for kind, stepper in enumerate(rollout_ops.INTEGRATORS):
        want = rollout_ops.lane_step(model, entry, stepper, Xt[1:], Ut[1:],
                                     torch.tensor(0.05, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(_struct_call(attitude_structs, model, X[1:], U[1:], kind),
                                   want, **TOL)
    nx = X.shape[1]
    got = _struct_call(attitude_structs, model, X, U, -2)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    np.testing.assert_allclose(got[:, :nx * nx].reshape(-1, nx, nx), Fx.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got[:, nx * nx:].reshape(-1, nx, 3), Fu.numpy(), rtol=1e-10,
                               atol=1e-12)


# --- the kernels' plain versions at the trio's shapes --------------------------------


def att_box(name, horizon, x0_sigma=(0.3, 0.2, -0.25)):
    """The MRP slew of examples/spacecraft_examples.py:59-82 on ``name``:
    inertia diag(10, 15, 20), rk4, dt = 0.05, Q = 0.1 diag(1, 1, 1, 0.1,
    0.1, 0.1), R = 0.01 I, Qf = diag(500 x3, 50 x3) (the quaternion's
    attitude weight repeated), the torque box +-2, from the attitude
    ``x0_sigma`` (an MRP) at rest to the identity at rest."""
    n_att = 4 if name == "quaternion_attitude" else 3
    goal = at_rest(name, np.zeros((1, 3)))[0]
    x0 = at_rest(name, np.asarray([x0_sigma]))[0]
    Q = 0.1 * jnp.diag(jnp.asarray([1.0] * n_att + [0.1] * 3))
    Qf = jnp.diag(jnp.asarray([500.0] * n_att + [50.0] * 3))
    return ct.problem(
        FACTORIES[name](inertia=jnp.asarray(DIAG)),
        ct.quadratic_objective(Q, 0.01 * jnp.eye(3), Qf, jnp.asarray(goal), 0.05),
        jnp.asarray(x0), horizon, 0.05,
    ).add_constraint("ControlConstraint", ct.control_constraint(jnp.full(3, -2.0),
                                                                jnp.full(3, 2.0)))


def x0_batch(name, B, seed):
    """The fleets' initial states: at rest at MRPs from U(-0.3, 0.3)^3."""
    return jnp.asarray(at_rest(name, np.random.default_rng(seed).uniform(-0.3, 0.3, (B, 3))))


@pytest.mark.parametrize("name", ["euler_attitude", "quaternion_attitude"])
def test_riccati_plain_matches_jax_scan(name):
    """Kernel 1 at 6x3 and 7x3: nu = 3, 27 BoxQP active sets."""
    args, _, _ = _stage_inputs(att_box(name, 5), 3, seed=6)
    got = riccati.riccati_backward_plain(*(torch.as_tensor(np.array(a)) for a in args))
    want = jax.jit(jax.vmap(_scan_backward_single))(*(jnp.asarray(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                       err_msg=f"output {i}")
    assert got[0].shape[-1] == 3


def _rollout_inputs(name, jp, B, seed):
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    rng = np.random.default_rng(seed)
    X, _ = _states(name, B * (N + 1), seed)
    Xb = 0.2 * X.reshape(B, N + 1, nx) + np.asarray(jp.x0)
    Ub = rng.uniform(-1.5, 1.5, size=(B, N, nu))
    k = 0.5 * rng.normal(size=(B, N, nu))
    K = 2.0 * rng.normal(size=(B, N, nu, nx))
    return Xb, Ub, k, K, np.asarray([1.0, 0.5, 0.25])[:B]


@pytest.mark.parametrize("name", MODELS)
def test_forward_rollout_plain_matches_jax_scan(name):
    """Kernel 2's goal form on the model's lane, clamped to the box."""
    jp = att_box(name, 6)
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
    assert consts.clddp == (name != "mrp_attitude")  # kernel 3 leaves it out (C.12)
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    dispatch_log.reset()
    Xt, Ut, Jt = rollout_ops.forward_rollout(consts, t[0][:, :-1], t[1], t[2], t[3],
                                             t[0][:, 0], t[4])
    assert not dispatch_log.launches
    for g, w in ((Xt, Xw), (Ut, Uw), (Jt, Jw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)
    assert np.any(Ut.numpy() >= 2.0) and np.any(Ut.numpy() <= -2.0)


@pytest.mark.parametrize("name", MODELS)
def test_open_loop_rollout_plain_matches_jax(name):
    """Kernel 4's plain version against ``cddp_tpu.models.base.rollout``
    (the JAX model's own rk4) from the fleets' x0."""
    jp = att_box(name, 10)
    _, Ub, _, _, _ = _rollout_inputs(name, jp, 3, seed=8)
    x0 = np.asarray(x0_batch(name, 3, seed=9))
    want = np.stack([np.asarray(jrollout(jp.model, jnp.asarray(a), jnp.asarray(u),
                                         jp.timestep)) for a, u in zip(x0, Ub)])
    model = port_zoo_problem(jp).model
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(Ub), jp.timestep)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_mrp_open_loop_matches_pallas_interpret():
    """The MRP lane's open-loop Pallas kernel in interpret mode (float32, as
    tests/test_model_lanes.py:133-160 runs it) against the port's plain
    rollout in float32 on the same inputs, and both near the float64 one."""
    jp = att_box("mrp_attitude", 7)
    model = jp.model.replace(integration_type="rk4")
    n_mp, mp_fn, model_f, disc = jip.model_lane(model)
    lane_key = (type(model), disc, model.integration_type)
    jip._OL_LANES_BY_KEY[lane_key] = dict(model_f=model_f, model_discrete=disc,
                                          integrator=model.integration_type)
    B, N = 3, jp.horizon
    x0 = np.asarray(x0_batch("mrp_attitude", B, seed=10), np.float32)
    U = np.random.default_rng(11).uniform(-2.0, 2.0, (B, N, 3)).astype(np.float32)
    mp = jnp.broadcast_to(jnp.asarray(mp_fn(model), jnp.float32)[None], (B, n_mp))
    want = np.asarray(jax.jit(lambda *a: jip._ol_fused_impl(*a, lane_key=lane_key,
                                                             interpret=True))(
        jnp.asarray(U), jnp.asarray(x0), jnp.full((B,), 0.05, jnp.float32), mp))
    port = port_zoo_problem(jp).model
    got = ip_rollout.open_loop_rollout_plain(port.to(torch.float32), torch.as_tensor(x0),
                                             torch.as_tensor(U), 0.05).numpy()
    np.testing.assert_allclose(got[:, 1:], want, rtol=2e-5, atol=2e-6)  # x_1..x_N
    truth = ip_rollout.open_loop_rollout_plain(port.double(), torch.as_tensor(x0).double(),
                                               torch.as_tensor(U).double(), 0.05).numpy()
    np.testing.assert_allclose(got, truth, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["euler_attitude", "quaternion_attitude"])
def test_ip_forward_plain_matches_jax_scan(name):
    """Kernel 5 on the torque box (m = 6), goal form, at 6x3 and 7x3."""
    jp = att_box(name, 5)
    N, nx, nu, m, B = jp.horizon, jp.state_dim, jp.control_dim, 6, 4
    p = port_zoo_problem(jp)
    stk = PathStacker(p)
    fc = ip_rollout.resolve_ip_forward(p, tt.CDDPOptions(), stk)
    assert fc is not None and fc.rows.m == stk.total_dim == m and fc.lane.variant == ""
    rng = np.random.default_rng(12)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    Xb, Ub, _, _, _ = _rollout_inputs(name, jp, B, seed=13)
    a = dict(Xb=Xb[:, :-1], Ub=Ub, Y=np.abs(n(N, m)) + 0.1, S=np.abs(n(N, m)) + 0.1,
             ku=n(N, nu) * 2.0, Ku=n(N, nu, nx) * 2.0, klam=n(N, nx), Klam=n(N, nx, nx),
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


@pytest.mark.parametrize("nx", [6, 7])
def test_ipddp_backward_plain_matches_jax_scan(nx):
    """Kernel 6 at (6, 3, 6) and (7, 3, 6), on random stage data, rtol 1e-9
    and atol 1e-11."""
    args = _stage_data(3, 4, nx, 3, 6, seed=nx)
    want = jax.jit(jax.vmap(_condensed_scan_single))(*(jnp.asarray(a) for a in args))
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*(torch.as_tensor(a) for a in args))
    assert dispatch_log.launches == {} and (nx, 3, 6) in ipddp_riccati.KERNEL_SHAPES
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=f"output {i}")


# --- eligibility and routes -------------------------------------------------------


def test_tables_take_the_trio_but_kernel_8():
    """Every per-pass kernel and kernel 9 take the trio; kernel 8 none of
    it; kernel 3 all but the MRP model and kernel 7 all but the Euler model
    (their float32 forks, ROADMAP C.12)."""
    opts = tt.CDDPOptions(max_iterations=3)
    for name in MODELS:
        p = port_zoo_problem(att_box(name, 6))
        nx = p.state_dim
        whole3, whole7 = name != "mrp_attitude", name != "euler_attitude"
        assert mega_clddp.mega_eligible(p, opts) == whole3 and clddp._use_kernels(p, opts)
        assert (nx, 3) in riccati.KERNEL_SHAPES and (nx, 3, 6) in ipddp_riccati.KERNEL_SHAPES
        assert mega_ipddp.solve_variant(p) == ("m6" if whole7 else None)
        assert mega_ipddp.mega_eligible(p, opts) == whole7
        if whole7:
            assert mega_ipddp.dispatch_name(p) == f"ipddp_solve@{name}"
        assert mega_logddp.mega_eligible(p, opts) and not mega_msipddp.mega_eligible(p, opts)
        assert ip_rollout.resolve_ip_forward(p, opts, PathStacker(p)) is not None
        lane = rollout_ops.lane_consts(p)
        assert lane.clddp == whole3 and lane.rollout
        track = p.replace(objective=p.objective.replace(
            reference_states=p.x0.expand(p.horizon + 1, -1)))
        assert not rollout_ops.lane_consts(track).clddp
        assert mega_ipddp.solve_variant(track) is None


# The longest horizon the JAX package's whole CLDDP, IPDDP and LogDDP solves
# take each model at (their scratch-memory gates, default options).
JAX_WHOLE_HORIZON = {"euler_attitude": (29, 27, 34), "quaternion_attitude": (25, 25, 30),
                     "mrp_attitude": (29, 27, 34)}


@pytest.mark.parametrize("name", MODELS)
def test_whole_solve_horizons_follow_jax_gates(name):
    """``rollout.WHOLE_MAX_HORIZON`` is the JAX gates' longest horizon for
    each whole solve that takes the model; the port's predicates take it
    there and refuse it one step further; the two whole solves the tables
    leave out (kernel 3 on MRP, kernel 7 on Euler; ROADMAP C.12) refuse it
    at every horizon, where JAX takes them."""
    from cddp_tpu.ops.pallas import mega_clddp as jclddp
    from cddp_tpu.ops.pallas import mega_ipddp as jipddp
    from cddp_tpu.ops.pallas import mega_logddp as jlogddp

    jopts, opts = ct.CDDPOptions(max_iterations=10), tt.CDDPOptions(max_iterations=10)
    gates = (("clddp_solve", jclddp.mega_eligible, mega_clddp.mega_eligible),
             ("ipddp_solve", jipddp.mega_eligible, mega_ipddp.mega_eligible),
             ("logddp_solve", jlogddp.mega_log_eligible, mega_logddp.mega_eligible))
    for (kernel, jax_gate, gate), limit in zip(gates, JAX_WHOLE_HORIZON[name]):
        taken = name in rollout_ops.WHOLE_MAX_HORIZON[kernel]
        assert taken == ((kernel, name) not in {("clddp_solve", "mrp_attitude"),
                                                ("ipddp_solve", "euler_attitude")})
        if taken:
            assert rollout_ops.WHOLE_MAX_HORIZON[kernel][name] == limit
        for horizon, admitted in ((20, True), (limit, True), (limit + 1, False)):
            jp = att_box(name, horizon)
            assert jax_gate(jp, jopts) == admitted, (kernel, horizon)
            assert gate(port_zoo_problem(jp), opts) == (admitted and taken), (kernel, horizon)


@pytest.mark.parametrize("name,solver,engine,logged", [
    # On CPU tensors the whole-solve dispatch runs the per-pass plain driver,
    # whose passes log too.
    ("euler_attitude", "CLDDP", "auto", ["clddp_solve@euler_attitude", "riccati_backward@6x3",
                                         "forward_rollout@euler_attitude"]),
    ("quaternion_attitude", "CLDDP", "xla", ["riccati_backward@7x3",
                                             "forward_rollout@quaternion_attitude"]),
    ("mrp_attitude", "IPDDP", "auto", ["open_loop_rollout@mrp_attitude",
                                       "ipddp_solve@mrp_attitude", "ip_forward@mrp_attitude",
                                       "ipddp_backward@6x3x6"]),
    ("quaternion_attitude", "IPDDP", "xla", ["open_loop_rollout@quaternion_attitude",
                                             "ip_forward@quaternion_attitude",
                                             "ipddp_backward@7x3x6"]),
    ("mrp_attitude", "LogDDP", "auto", ["open_loop_rollout@mrp_attitude",
                                        "logddp_solve@mrp_attitude"]),
    ("euler_attitude", "MSIPDDP", "auto", ["open_loop_rollout@euler_attitude"]),
    # The two whole solves the tables leave out run per pass (ROADMAP C.12).
    ("mrp_attitude", "CLDDP", "auto", ["riccati_backward@6x3", "forward_rollout@mrp_attitude"]),
    ("euler_attitude", "IPDDP", "auto", ["open_loop_rollout@euler_attitude",
                                         "ip_forward@euler_attitude", "ipddp_backward@6x3x6"]),
])
def test_route_is_chosen_before_any_launch(name, solver, engine, logged, caplog):
    """What a CPU solve logs where a CUDA one would launch: kernel 8 never,
    the other whole solves and the per-pass kernels under the model's name
    or shape."""
    p = port_zoo_problem(att_box(name, 4))
    x0 = torch.as_tensor(np.asarray(x0_batch(name, 2, seed=14)))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=1, solve_engine=engine))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(logged)
