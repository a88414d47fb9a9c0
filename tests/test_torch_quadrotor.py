"""The port's Quadrotor and QuadrotorRate against the JAX package (CPU,
float64):

- the models' continuous dynamics and Jacobians against the JAX models
  (1e-12), the hoisted inverse inertia against ``jnp.linalg.inv``, the
  registry's parameter vectors against the JAX lane vectors, ``interop``
  carrying both models across, and the builders' device;
- the CUDA structs of ``models.cuh`` built for the host (g++) against the
  plain models, and their rk4 ``integrate`` against the JAX lane;
- the plain versions of kernels 1, 2, 4, 5 and 6 at the new shapes (13x4,
  10x4; m = 8) against the JAX scan references (1e-9: the JAX lane inverts
  the inertia by its adjugate and normalizes q by a multiplied inverse
  norm, so it rounds apart from the model, which the port's plain versions
  follow); kernel 1 at 13x4, kernel 2 and kernel 5's goal form on the
  quadrotor are held through the solves of
  ``tests/test_torch_quadrotor_solvers.py``, which run them;
- the whole-solve predicates refusing both models, the per-pass kernels'
  tables taking them, and the routes the solves log.
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
from cddp_tpu.models import QuadrotorRate as JQuadrotorRate
from cddp_tpu.models import quadrotor as jquadrotor
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu.ops.pallas import rollout as jlane
from cddp_tpu.ops.pallas.riccati import _scan_backward_single
from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.models import Quadrotor, QuadrotorRate, quadrotor, rollout
from cddp_tpu_torch.ops.kernels import (dispatch_log, ip_rollout, ipddp_riccati, mega_clddp,
                                        mega_ipddp, mega_logddp, mega_msipddp, riccati)
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import clddp
from test_torch_models import model_params
from test_torch_zoo import _stage_inputs, port_zoo_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
DIAG = np.diag([0.01, 0.01, 0.02])
# A full symmetric positive-definite inertia, where the two packages' LU
# inverses may round apart.
FULL = np.array([[0.012, 0.001, -0.0005], [0.001, 0.011, 0.0007], [-0.0005, 0.0007, 0.021]])


def quad_box(horizon=60, inertia=DIAG):
    """The quadrotor golden's problem (tests/make_goldens.py:69-84): N = 60,
    dt = 0.02, rk4, the goal (1.5, 0, 1) at hover, the rotor box [0, 9]^4."""
    goal = jnp.zeros(13).at[0].set(1.5).at[2].set(1.0).at[3].set(1.0)
    Q = jnp.zeros((13, 13)).at[4, 4].set(0.1).at[5, 5].set(0.1).at[6, 6].set(0.1)
    Qf = jnp.diag(jnp.array([500.0, 500.0, 500.0, 1.0, 1.0, 1.0, 1.0, 10.0, 10.0, 10.0,
                             0.0, 0.0, 0.0]))
    return ct.problem(
        jquadrotor(mass=1.0, inertia=jnp.asarray(inertia), arm_length=0.2,
                   integration_type="rk4"),
        ct.quadratic_objective(Q, 0.1 * jnp.eye(4), Qf, goal, 0.02),
        jnp.zeros(13).at[3].set(1.0), horizon, 0.02,
    ).add_constraint("ControlConstraint", ct.control_constraint(jnp.zeros(4), jnp.full(4, 9.0)))


def rate_box(horizon=50):
    """QuadrotorRate at N = 50, dt = 0.02, rk4, from hover to (1, 0, 1):
    Q = 0.1 I on position and velocity, R = 0.1 I, Qf = diag(100 x3, 10 x3,
    1 x4), the box [0, 20] x [-5, 5]^3 (the model's max_thrust, max_rate)."""
    goal = jnp.zeros(10).at[0].set(1.0).at[2].set(1.0).at[6].set(1.0)
    Q = jnp.diag(jnp.array([0.1] * 6 + [0.0] * 4))
    Qf = jnp.diag(jnp.array([100.0] * 3 + [10.0] * 3 + [1.0] * 4))
    return ct.problem(
        JQuadrotorRate(integration_type="rk4"),
        ct.quadratic_objective(Q, 0.1 * jnp.eye(4), Qf, goal, 0.02),
        jnp.zeros(10).at[6].set(1.0), horizon, 0.02,
    ).add_constraint("ControlConstraint",
                     ct.control_constraint(jnp.array([0.0, -5.0, -5.0, -5.0]),
                                           jnp.array([20.0, 5.0, 5.0, 5.0])))


def x0_batch(jp, B, seed):
    """Hover plus U(-0.5, 0.5)^3 position offsets (the fleets' x0)."""
    x0 = np.tile(np.asarray(jp.x0), (B, 1))
    x0[:, :3] += np.random.default_rng(seed).uniform(-0.5, 0.5, size=(B, 3))
    return jnp.asarray(x0)


def _states(nx, B, seed):
    """Attitudes away from hover (unnormalized quaternions: the models
    normalize), turning bodies, and rotor or thrust-and-rate controls."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, nx)) * 0.5
    q = slice(3, 7) if nx == 13 else slice(6, 10)
    X[:, q] = rng.normal(size=(B, 4)) * 0.6 + np.array([1.0, 0.0, 0.0, 0.0])
    if nx == 13:
        X[:, 10:] = rng.normal(size=(B, 3)) * 2.0
        U = rng.uniform(0.0, 9.0, size=(B, 4))
    else:
        U = np.concatenate([rng.uniform(0.0, 20.0, (B, 1)), rng.uniform(-5, 5, (B, 3))], 1)
    return X, U


def _jax_rows(fn, X, U):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(X), jnp.asarray(U)))


MODELS = {
    "quadrotor": lambda: jquadrotor(mass=1.3, inertia=jnp.asarray(DIAG), arm_length=0.17),
    "quadrotor_full": lambda: jquadrotor(mass=0.9, inertia=jnp.asarray(FULL), arm_length=0.22),
    "quadrotor_rate": lambda: JQuadrotorRate(mass=1.2, gravity=9.7),
}


def port_model(jm):
    p = model_params(jm).tolist()
    if type(jm).__name__ == "Quadrotor":
        return Quadrotor(mass=p[0], arm_length=p[1], gravity=p[2],
                         inertia=np.reshape(p[3:], (3, 3)), device="cpu")
    return QuadrotorRate(mass=jm.mass, max_thrust=jm.max_thrust, max_rate=jm.max_rate,
                         gravity=jm.gravity, device="cpu")


@pytest.mark.parametrize("case", sorted(MODELS))
def test_dynamics_and_jacobians_match_jax(case):
    """``forward`` against ``continuous_dynamics`` and the AD Jacobians
    against the JAX ``jacobians``, at attitudes away from hover, unit and
    not, and on a quaternion below the guard (the quadrotor's (1, 0, 0, 0)
    fallback)."""
    jm = MODELS[case]()
    X, U = _states(jm.state_dim, 12, seed=1)
    if jm.state_dim == 13:
        X[0, 3:7] = 1e-8
    model = port_model(jm)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(model(Xt, Ut, None).numpy(), _jax_rows(
        lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **TOL)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    jFx, jFu = (_jax_rows(lambda x, u, i=i: jm.jacobians(x, u, 0.0)[i], X, U) for i in (0, 1))
    np.testing.assert_allclose(Fx.numpy(), jFx, **TOL)
    np.testing.assert_allclose(Fu.numpy(), jFu, **TOL)


def test_inertia_inverse_is_the_jax_inverse_hoisted():
    """Bit for bit for the diagonal inertia (LU gives 1/d exactly), within
    1e-15 relative for a full one; computed once for each dtype and device,
    anew after a cast."""
    for inertia, rtol in ((DIAG, 0.0), (FULL, 1e-15)):
        model = quadrotor(inertia=inertia, device="cpu")
        want = np.asarray(jnp.linalg.inv(jnp.asarray(inertia)))
        got = model.inertia_inverse()
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0.0)
        assert model.inertia_inverse() is got
        if rtol == 0.0:
            np.testing.assert_array_equal(got.numpy(), want)
        f32 = model.to(torch.float32).inertia_inverse()
        assert f32.dtype == torch.float32 and f32 is not got
        np.testing.assert_allclose(f32.numpy(), want, rtol=1e-6)


def test_builders_default_to_the_card(monkeypatch):
    """No device: the CUDA card, and no fallback to the CPU without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: quadrotor(), lambda: tt.QuadrotorRate(), lambda: Quadrotor()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    model = tt.quadrotor(mass=1.5, integration_type="rk4", device="cpu", dtype=torch.float32)
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert model.inertia.device.type == "cpu" and model.integration_type == "rk4"


@pytest.mark.parametrize("case", sorted(MODELS))
def test_registry_parameters_are_the_jax_lanes(case):
    """The registry's vector is the JAX lane's (rollout.py:161-169, :515-516);
    the quadrotor's struct also reads the plain model's inverse inertia
    after it."""
    jm = MODELS[case]()
    model = port_model(jm)
    entry = rollout_ops.model_entry(model)
    name = case.replace("_full", "")
    assert entry.cuda_name == name and entry.tag == "@" + name and not entry.discrete
    np.testing.assert_array_equal(entry.params(model), model_params(jm))
    assert len(model_params(jm)) == jlane._REGISTRY[type(jm).__name__][0]
    extra = model.inertia_inverse().reshape(-1).tolist() if name == "quadrotor" else []
    assert entry.kernel_params(model) == model_params(jm).tolist() + extra


@pytest.mark.parametrize("case", sorted(MODELS))
def test_interop_carries_the_models(case):
    jm = MODELS[case]().replace(integration_type="rk4")
    nx, nu = jm.state_dim, jm.control_dim
    p = problem_from_arrays(
        type(jm).__name__, model_params(jm), np.eye(nx), np.eye(nu), np.eye(nx),
        np.zeros(nx), np.zeros(nu), np.ones(nu), np.zeros(nx), 5, 0.02, "rk4",
        device="cpu", dtype=torch.float64)
    assert type(p.model) is type(port_model(jm)) and p.model.integration_type == "rk4"
    np.testing.assert_array_equal(rollout_ops.model_entry(p.model).params(p.model),
                                  model_params(jm))
    X, U = _states(nx, 6, seed=2)
    np.testing.assert_allclose(
        p.model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), 0.0, 0.02).numpy(),
        _jax_rows(lambda x, u: jm.discrete_dynamics(x, u, 0.0, 0.02), X, U), **TOL)
    with pytest.raises(ValueError, match="takes"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(nu),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, 0.02,
                            "rk4", device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_lane_step_matches_jax_lane(case):
    """One rk4 step of the kernels' stage arithmetic on the plain model
    (``rollout.lane_step``) against the JAX lane integrator over the JAX
    lane function, on the lane's parameter vector."""
    jm = MODELS[case]()
    X, U = _states(jm.state_dim, 8, seed=3)
    model = port_model(jm)
    got = rollout_ops.lane_step(model, rollout_ops.model_entry(model), "rk4",
                                torch.as_tensor(X), torch.as_tensor(U),
                                torch.tensor(0.02, dtype=torch.float64)).numpy()
    lane_f = jlane._REGISTRY[type(jm).__name__][2]
    want = np.stack([np.asarray(v) for v in jlane._integrate_lane(
        lane_f, "rk4", [jnp.asarray(X[:, i]) for i in range(X.shape[1])],
        [jnp.asarray(U[:, i]) for i in range(4)], jnp.asarray(model_params(jm)),
        jnp.full(X.shape[0], 0.02))], -1)
    np.testing.assert_allclose(got, want, **TOL)


# --- the CUDA structs as host C++ ----------------------------------------------------

STRUCTS = {"quadrotor": "Quadrotor", "quadrotor_full": "Quadrotor",
           "quadrotor_rate": "QuadrotorRate"}

_HOST_QUAD = r"""
#include "models.cuh"

// kind < 0: the struct's f; else one integrate<> step of stepper `kind`.
template <class M>
void run(const double* x, const double* u, const double* p, double dt, int kind, double* out,
         int B) {
  for (int b = 0; b < B; ++b) {
    double xb[M::NX], ub[M::NU], o[M::NX];
    for (int i = 0; i < M::NX; ++i) xb[i] = x[b * M::NX + i];
    for (int i = 0; i < M::NU; ++i) ub[i] = u[b * M::NU + i];
    if (kind < 0)
      M::f(xb, ub, p, o);
    else
      cddp::integrate<double, M>(kind, xb, ub, p, dt, o);
    for (int i = 0; i < M::NX; ++i) out[b * M::NX + i] = o[i];
  }
}

extern "C" {
void quad_Quadrotor(const double* x, const double* u, const double* p, double dt, int kind,
                    double* out, int B) { run<cddp::Quadrotor>(x, u, p, dt, kind, out, B); }
void quad_QuadrotorRate(const double* x, const double* u, const double* p, double dt,
                        int kind, double* out, int B) {
  run<cddp::QuadrotorRate>(x, u, p, dt, kind, out, B);
}
}
"""


@pytest.fixture(scope="module")
def quad_structs(tmp_path_factory):
    """``models.cuh``'s quadrotor structs compiled for the host with g++
    (``-ffp-contract=off``, as the float64 build's ``--fmad=false``) against
    the stand-in ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA structs for the host")
    d = tmp_path_factory.mktemp("quad_structs")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "quad.cpp").write_text(_HOST_QUAD)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", str(d / "quad.cpp"), "-o",
                    str(d / "quad.so")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "quad.so"))


def _struct_call(lib, case, X, U, p, kind):
    """The struct's f (kind -1) or one integrate<> step of stepper ``kind``."""
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    out = np.zeros_like(X)
    getattr(lib, f"quad_{STRUCTS[case]}")(ptr(X), ptr(U), ptr(p), ctypes.c_double(0.02),
                                          ctypes.c_int(kind), ptr(out), ctypes.c_int(len(X)))
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_cuda_struct_matches_plain_model(case, quad_structs):
    """f on the struct's parameter vector (``kernel_params``) against the
    plain model's forward, each stepper of ``integrate`` against the plain
    lane step (the same expressions in the same order: 1e-12, the host's
    sqrt against torch's), and the rk4 step against the JAX lane."""
    jm = MODELS[case]()
    model = port_model(jm)
    X, U = _states(jm.state_dim, 64, seed=4)
    if jm.state_dim == 13:
        X[0, 3:7] = 1e-8
    p = np.asarray(rollout_ops.model_entry(model).kernel_params(model), np.float64)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(_struct_call(quad_structs, case, X, U, p, -1),
                               model(Xt, Ut, None).numpy(), **TOL)
    entry = rollout_ops.model_entry(model)
    for kind, name in enumerate(rollout_ops.INTEGRATORS):
        want = rollout_ops.lane_step(model, entry, name, Xt, Ut,
                                     torch.tensor(0.02, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(_struct_call(quad_structs, case, X, U, p, kind), want,
                                   **TOL)
    lane_f = jlane._REGISTRY[type(jm).__name__][2]
    jane = np.stack([np.asarray(v) for v in jlane._integrate_lane(
        lane_f, "rk4", [jnp.asarray(X[1:, i]) for i in range(X.shape[1])],
        [jnp.asarray(U[1:, i]) for i in range(4)], jnp.asarray(model_params(jm)),
        jnp.full(X.shape[0] - 1, 0.02))], -1)
    np.testing.assert_allclose(_struct_call(quad_structs, case, X, U, p, 3)[1:], jane, **TOL)


_HOST_BOXQP = r"""
#include "clddp_step.cuh"

// Both walks of kernel 1's enumerated BoxQP at NU = 4 on B problems: the
// unrolled one (boxqp_enum) and the runtime loop the kernel takes from
// NU = 3 on (boxqp_enum_loop); out: k (4), the free block's inverse (16),
// taken (1) per problem and walk.
extern "C" void walks(const double* H, const double* g, const double* lb, const double* ub,
                      double* out, int B) {
  for (int b = 0; b < B; ++b) {
    double Hb[4][4], gb[4], lo[4], hi[4];
    for (int i = 0; i < 4; ++i) {
      gb[i] = g[4 * b + i], lo[i] = lb[4 * b + i], hi[i] = ub[4 * b + i];
      for (int j = 0; j < 4; ++j) Hb[i][j] = H[16 * b + 4 * i + j];
    }
    cddp::BoxQPSel<double, 4> sel[2] = {};
    cddp::boxqp_enum<double, 4, 0>(Hb, gb, lo, hi, sel[0]);
    cddp::boxqp_enum_loop<double, 4>(Hb, gb, lo, hi, sel[1]);
    for (int w = 0; w < 2; ++w) {
      double* o = out + (2 * b + w) * 21;
      for (int i = 0; i < 4; ++i) {
        o[i] = sel[w].k[i];
        for (int j = 0; j < 4; ++j) o[4 + 4 * i + j] = sel[w].Hinv[i][j];
      }
      o[20] = sel[w].taken;
    }
  }
}
"""


def test_boxqp_loop_walk_is_the_unrolled_walk(tmp_path):
    """Kernel 1 walks the 81 active sets of nu = 4 in a runtime loop over
    identity-padded free blocks (``clddp_step.cuh::boxqp_enum_loop``; the
    unrolled walk took nvcc and ptxas over ten minutes at nx = 13): built
    for the host (g++, ``-ffp-contract=off``), it gives the unrolled walk's
    k, free-block inverse and selection bit for bit, on positive-definite
    and indefinite Hessians and on a degenerate box, and the plain
    version's ``boxqp_solve_enum`` to rounding."""
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.boxqp import boxqp_solve_enum
    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the BoxQP walks for the host")
    (tmp_path / "cuda_runtime.h").write_text(STAND_IN)
    (tmp_path / "walks.cpp").write_text(_HOST_BOXQP)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{tmp_path}", f"-I{build.CSRC}", str(tmp_path / "walks.cpp"),
                    "-o", str(tmp_path / "walks.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "walks.so"))
    rng = np.random.default_rng(21)
    B = 4000
    W = rng.normal(size=(B, 4, 4))
    H = W @ W.transpose(0, 2, 1) + np.where(np.arange(B) % 7 == 0, -1.0, 0.3)[:, None,
                                                                               None] * np.eye(4)
    g = 3.0 * rng.normal(size=(B, 4))
    lb, ub = -np.abs(rng.normal(size=(B, 4))), np.abs(rng.normal(size=(B, 4)))
    lb[::11, 1] = ub[::11, 1] = 0.0
    out = np.zeros((B, 2, 21))
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.walks(ptr(H), ptr(g), ptr(lb), ptr(ub), out.ctypes.data_as(ctypes.c_void_p),
              ctypes.c_int(B))
    np.testing.assert_array_equal(out[:, 1], out[:, 0])
    assert out[:, 0, 20].all()
    qp = boxqp_solve_enum(*(torch.as_tensor(a) for a in (H, g, lb, ub)))
    np.testing.assert_allclose(out[:, 1, :4], qp.x.numpy(), rtol=1e-9, atol=1e-9)


# --- the kernels' plain versions at the new shapes ----------------------------------


def test_riccati_plain_matches_jax_scan():
    """Kernel 1 at QuadrotorRate's (10, 4): nu = 4, 81 BoxQP active sets (at
    the quadrotor's (13, 4) through test_torch_quadrotor_solvers.py's CLDDP
    solve)."""
    args, _, _ = _stage_inputs(rate_box(4), 3, seed=5)
    got = riccati.riccati_backward_plain(*(torch.as_tensor(a) for a in args))
    want = jax.jit(jax.vmap(_scan_backward_single))(*(jnp.asarray(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                       err_msg=f"output {i}")
    k, lb, ub = got[0].numpy(), args[7], args[8]
    clamped = np.isclose(k, lb) | np.isclose(k, ub)
    assert clamped.any() and not clamped.all()


def _rollout_inputs(jp, B, seed):
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    rng = np.random.default_rng(seed)
    X, _ = _states(nx, B * (N + 1), seed)
    Xb = 0.3 * X.reshape(B, N + 1, nx) + np.asarray(jp.x0)
    cc = jp.get_constraint("ControlConstraint")
    lo, hi = np.asarray(cc.lower), np.asarray(cc.upper)
    Ub = lo + (hi - lo) * rng.uniform(0.2, 0.8, size=(B, N, nu))
    k = 0.3 * (hi - lo) * rng.normal(size=(B, N, nu))
    K = 2.0 * rng.normal(size=(B, N, nu, nx))
    return Xb, Ub, k, K, np.asarray([1.0, 0.5, 0.25])[:B]


@pytest.mark.parametrize("case", ["quadrotor", "quadrotor_rate"])
def test_forward_rollout_plain_matches_jax_scan(case):
    """Kernel 2's goal form on the model's lane, clamped to the box."""
    jp = quad_box(6) if case == "quadrotor" else rate_box(6)
    Xb, Ub, k, K, alpha = _rollout_inputs(jp, 3, seed=6)
    cc, o = jp.get_constraint("ControlConstraint"), jp.objective
    single = functools.partial(jlane._scan_forward_single, type(jp.model).__name__, "rk4",
                               True, False)
    Xw, Uw, Jw = jax.jit(jax.vmap(single, in_axes=(0,) * 5 + (None,) * 8))(
        *(jnp.asarray(a) for a in (Xb[:, :-1], Ub, k, K, alpha)), jnp.asarray(jp.timestep),
        jnp.asarray(model_params(jp.model)), o.Q, o.R, o.Qf, o.reference_state, cc.lower,
        cc.upper)
    consts = rollout_ops.lane_consts(port_zoo_problem(jp))
    assert consts.rollout and not consts.clddp and consts.tag == "@" + case
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    dispatch_log.reset()
    Xt, Ut, Jt = rollout_ops.forward_rollout(consts, t[0][:, :-1], t[1], t[2], t[3],
                                             t[0][:, 0], t[4])
    assert not dispatch_log.launches
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), rtol=1e-9, atol=1e-9)
    hi = np.asarray(cc.upper)
    assert np.any(Ut.numpy() >= hi - 1e-12) and np.any(Ut.numpy() <= np.asarray(cc.lower))


@pytest.mark.parametrize("case", ["quadrotor", "quadrotor_rate"])
def test_open_loop_rollout_plain_matches_jax(case):
    """Kernel 4's plain version against ``cddp_tpu.models.base.rollout``
    (the JAX model's own rk4)."""
    jp = quad_box(10) if case == "quadrotor" else rate_box(10)
    _, Ub, _, _, _ = _rollout_inputs(jp, 3, seed=7)
    x0 = np.asarray(x0_batch(jp, 3, seed=8))
    want = np.stack([np.asarray(jrollout(jp.model, jnp.asarray(a), jnp.asarray(u),
                                         jp.timestep)) for a, u in zip(x0, Ub)])
    model = port_zoo_problem(jp).model
    dispatch_log.reset()
    got = rollout(model, torch.as_tensor(x0), torch.as_tensor(Ub), jp.timestep)
    assert not dispatch_log.launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case,tracking", [("quadrotor", True), ("quadrotor_rate", False)])
def test_ip_forward_plain_matches_jax_scan(case, tracking):
    """Kernel 5 at m = 8: the quadrotor's tracking form (the figure-8's) and
    QuadrotorRate's goal form (the quadrotor's through
    test_torch_quadrotor_solvers.py's IPDDP solve)."""
    jp = quad_box(5) if case == "quadrotor" else rate_box(5)
    N, nx, nu = jp.horizon, jp.state_dim, jp.control_dim
    p = port_zoo_problem(jp)
    refs = None
    if tracking:
        refs = np.tile(np.asarray(jp.objective.reference_state), (N + 1, 1))
        refs[:, 0] = np.linspace(0.0, 1.5, N + 1)
        o = jp.objective
        jp = jp.replace(objective=ct.quadratic_objective(
            o.Q / jp.timestep, o.R / jp.timestep, o.Qf, jnp.asarray(refs[-1]), jp.timestep,
            reference_states=jnp.asarray(refs)))
        p = port_zoo_problem(jp)
        p = p.replace(objective=tt.quadratic_objective(
            torch.as_tensor(np.asarray(o.Q)) / jp.timestep,
            torch.as_tensor(np.asarray(o.R)) / jp.timestep, torch.as_tensor(np.asarray(o.Qf)),
            torch.as_tensor(refs[-1]), jp.timestep, reference_states=torch.as_tensor(refs),
            device="cpu", dtype=torch.float64))
    stk = PathStacker(p)
    fc = ip_rollout.resolve_ip_forward(p, tt.CDDPOptions(), stk)
    assert fc is not None and fc.rows.m == stk.total_dim == 8
    assert fc.lane.variant == ("_track" if tracking else "")
    B, m = 4, 8
    rng = np.random.default_rng(9)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    Xb, Ub, _, _, _ = _rollout_inputs(jp, B, seed=10)
    hi = np.asarray(jp.get_constraint("ControlConstraint").upper)
    a = dict(Xb=Xb[:, :-1], Ub=Ub, Y=np.abs(n(N, m)) + 0.1, S=np.abs(n(N, m)) + 0.1,
             ku=n(N, nu) * hi, Ku=n(N, nu, nx) * hi[:, None], klam=n(N, nx), Klam=n(N, nx, nx),
             lam=n(N, nx), ky=n(N, m), Ky=n(N, m, nx, scale=0.01), ks=n(N, m),
             Ks=n(N, m, nx, scale=0.01), x0=Xb[:, 0], a_pr=rng.uniform(0.2, 1.0, B),
             a_du=rng.uniform(0.2, 1.0, B), tau=np.full(B, 0.99), soc=np.ones(B))
    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    _, cparams, _, cost_f = jip.cost_lane(jp.objective)
    cc = jp.get_constraint("ControlConstraint")
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    stage = (np.broadcast_to(refs[:N], (B, N, nx)) if tracking else np.zeros((B, N, 1)))
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(jp.timestep), bc(jnp.asarray(model_params(jp.model))), bc(cparams),
              jnp.asarray(stage), bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
        nx, nu, m, model_f, model_discrete, "rk4", cost_f, False, ("control",), *v)))(*jargs)
    t = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    dispatch_log.reset()
    got = ip_rollout.ip_forward(fc, *t.values())
    assert not dispatch_log.launches
    for name, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[1]), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[2]))


def _stage_data(B, N, nx, nu, m, seed):
    """Random condensed-backward operands of the distribution
    tests/test_ipddp_pallas.py::_random_stage_data draws, from numpy."""
    rng = np.random.default_rng(seed)
    rnd = lambda *shape, scale=1.0: scale * rng.normal(size=shape)  # noqa: E731
    W, Wu, Wt = rnd(B, N, nx, nx, scale=0.1), rnd(B, N, nu, nu, scale=0.1), rnd(
        B, nx, nx, scale=0.2)
    T = lambda a: a.swapaxes(-1, -2)  # noqa: E731
    return [np.eye(nx) + rnd(B, N, nx, nx, scale=0.05), rnd(B, N, nx, nu, scale=0.2),
            rnd(B, N, nx, scale=0.5), rnd(B, N, nu, scale=0.5), 0.5 * np.eye(nx) + W @ T(W),
            np.eye(nu) + Wu @ T(Wu), rnd(B, N, nu, nx, scale=0.05),
            rng.uniform(0.05, 1.0, (B, N, m)), rng.uniform(0.05, 1.0, (B, N, m)),
            rnd(B, N, m, scale=0.2) - 0.3, rnd(B, N, m, nx, scale=0.3),
            rnd(B, N, m, nu, scale=0.3), rnd(B, nx, scale=0.5), 2.0 * np.eye(nx) + Wt @ T(Wt),
            np.full(B, 0.1), np.full(B, 1e-6)]


@pytest.mark.parametrize("nx", [13, 10])
def test_ipddp_backward_plain_matches_jax_scan(nx):
    """Kernel 6 at (13, 4, 8) and (10, 4, 8), on random stage data, rtol
    1e-9 and atol 1e-11."""
    args = _stage_data(3, 4, nx, 4, 8, seed=nx)
    want = jax.jit(jax.vmap(_condensed_scan_single))(*(jnp.asarray(a) for a in args))
    targs = [torch.as_tensor(a) for a in args]
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*targs)
    assert dispatch_log.launches == {} and (nx, 4, 8) in ipddp_riccati.KERNEL_SHAPES
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=f"output {i}")
    assert bool((got[-1][:, 6] == 1.0).all())


# --- eligibility and routes -------------------------------------------------------


def test_whole_solves_refuse_and_per_pass_kernels_take_them():
    opts = tt.CDDPOptions(max_iterations=3)
    for jp, shape in ((quad_box(6), (13, 4)), (rate_box(6), (10, 4))):
        p = port_zoo_problem(jp)
        assert not mega_clddp.mega_eligible(p, opts)
        assert mega_ipddp.solve_variant(p) is None and not mega_ipddp.mega_eligible(p, opts)
        assert not mega_logddp.mega_eligible(p, opts)
        assert not mega_msipddp.mega_eligible(p, opts)
        assert clddp._use_kernels(p, opts) and shape in riccati.KERNEL_SHAPES
        assert shape + (8,) in ipddp_riccati.KERNEL_SHAPES
        assert rollout_ops.lane_consts(p).rollout and not rollout_ops.lane_consts(p).clddp
        assert ip_rollout.resolve_ip_forward(p, opts, PathStacker(p)) is not None


@pytest.mark.parametrize("case,solver,engine,plain_ops", [
    ("quadrotor", "CLDDP", "auto", ["riccati_backward@13x4", "forward_rollout@quadrotor"]),
    ("quadrotor_rate", "CLDDP", "xla", ["riccati_backward@10x4",
                                        "forward_rollout@quadrotor_rate"]),
    ("quadrotor", "IPDDP", "auto", ["open_loop_rollout@quadrotor", "ip_forward@quadrotor",
                                    "ipddp_backward@13x4x8"]),
    ("quadrotor_rate", "IPDDP", "auto", ["open_loop_rollout@quadrotor_rate",
                                         "ip_forward@quadrotor_rate", "ipddp_backward@10x4x8"]),
    ("quadrotor", "LogDDP", "auto", ["open_loop_rollout@quadrotor"]),
    ("quadrotor_rate", "MSIPDDP", "auto", ["open_loop_rollout@quadrotor_rate"]),
])
def test_route_is_chosen_before_any_launch(case, solver, engine, plain_ops, caplog):
    """What a CPU solve logs where a CUDA one would launch: the per-pass
    kernels under the model's name or shape, never a whole solve."""
    jp = quad_box(4) if case == "quadrotor" else rate_box(4)
    p = port_zoo_problem(jp)
    x0 = torch.as_tensor(np.asarray(x0_batch(jp, 2, seed=13)))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        batched_solve(p, x0, solver, tt.CDDPOptions(max_iterations=1, solve_engine=engine))
    assert {r.getMessage().split(":")[0] for r in caplog.records} == set(plain_ops)
