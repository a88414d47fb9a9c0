"""The port's Pendulum, CartPole, HCW, Car, Forklift and LTISystem against
the JAX package's models (CPU, float64): the continuous dynamics against
the JAX models and the reference formulas and pins of
tests/test_model_oracles.py, the Jacobians against the JAX ``jacobians``
and against finite differences, the car's exact map against the JAX model
and lane, each model's parameter vector against the JAX lane registry's,
one step of each of the four lane integrators against the JAX lane
integrator, ``interop`` carrying each JAX model across with its parameters,
and the CUDA structs of ``models.cuh`` built for the host. ``model_params`` is
how the other parity tests give a JAX problem's model to the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.models import HCW as JHCW
from cddp_tpu.models import CartPole as JCartPole
from cddp_tpu.models import Pendulum as JPendulum
from cddp_tpu.ops.pallas import rollout as jlane
from cddp_tpu.utils.fd import finite_difference_jacobian
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.models import HCW, Car, CartPole, Forklift, LTISystem, Pendulum
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
INTEGRATORS = ("euler", "heun", "rk3", "rk4")


def model_params(jax_model) -> np.ndarray:
    """A JAX model's parameter vector in the JAX lane registry's order
    (cddp_tpu/ops/pallas/rollout.py:138-203), which the port's registry and
    ``interop.problem_from_arrays`` take; an LTISystem's A and B flattened
    and concatenated (it has no lane)."""
    if type(jax_model).__name__ == "LTISystem":
        return np.concatenate([np.asarray(jax_model.A, np.float64).ravel(),
                               np.asarray(jax_model.B, np.float64).ravel()])
    return np.asarray(jlane._REGISTRY[type(jax_model).__name__][1](jax_model), np.float64)


def port_model(jax_model):
    """The port's copy of a JAX model, with its parameters and integrator."""
    name, kind = type(jax_model).__name__, jax_model.integration_type
    p = model_params(jax_model).tolist()
    if name == "Car":
        return Car(p[0], timestep=jax_model.timestep, integration_type=kind)
    if name == "Forklift":
        return Forklift(p[0], jax_model.max_steering_angle, jax_model.rear_steer,
                        integration_type=kind)
    if name == "LTISystem":
        return LTISystem(torch.as_tensor(np.asarray(jax_model.A, np.float64)),
                         torch.as_tensor(np.asarray(jax_model.B, np.float64)),
                         jax_model.timestep, integration_type=kind)
    cls = {"Pendulum": Pendulum, "CartPole": CartPole, "HCW": HCW}[name]
    return cls(*p, integration_type=kind)


# (JAX model with non-default parameters, x, u): states away from the
# models' equilibria, so that every term counts.
CASES = {
    "pendulum": (JPendulum(length=0.7, mass=1.2, damping=0.05, gravity=9.7),
                 [0.8, -0.3], [0.4]),
    "cartpole": (JCartPole(cart_mass=1.1, pole_mass=0.3, pole_length=0.6, gravity=9.8,
                           damping=0.02),
                 [0.1, 0.7, -0.4, 0.9], [1.1]),
    "hcw": (JHCW(mean_motion=0.0011, mass=1.5),
            [10.0, -5.0, 2.0, 0.1, 0.2, -0.3], [0.01, -0.02, 0.03]),
}


def _batch(case, B=6, seed=0):
    """B states and controls around the case's, as numpy."""
    _, x, u = CASES[case]
    rng = np.random.default_rng(seed)
    X = np.asarray(x) + 0.3 * rng.standard_normal((B, len(x)))
    U = np.asarray(u) + 0.3 * rng.standard_normal((B, len(u)))
    return X, U


def _jax_rows(fn, X, U):
    return np.stack([np.asarray(fn(jnp.asarray(x), jnp.asarray(u))) for x, u in zip(X, U)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_model(case):
    jm = CASES[case][0]
    X, U = _batch(case)
    got = port_model(jm)(torch.as_tensor(X), torch.as_tensor(U), None).numpy()
    want = _jax_rows(lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U)
    np.testing.assert_allclose(got, want, **TOL)


def _oracle(case, x, u, jm):
    """The reference formulas of tests/test_model_oracles.py
    (test_pendulum_formula :198, test_cartpole_formula :223 with the damped
    term of models/cartpole.py, test_hcw_formula :257)."""
    if case == "pendulum":
        m, l, b, g = jm.mass, jm.length, jm.damping, jm.gravity
        th, w = x
        return [w, (u[0] - b * w + m * g * l * np.sin(th)) / (m * l * l)]
    if case == "cartpole":
        mc, mp, l, g, b = jm.cart_mass, jm.pole_mass, jm.pole_length, jm.gravity, jm.damping
        _, th, xd, thd = x
        s, c = np.sin(th), np.cos(th)
        den = mc + mp * s * s
        xdd = (u[0] + mp * s * (l * thd * thd + g * c)) / den
        thdd = (-u[0] * c - mp * l * thd * thd * c * s - (mc + mp) * g * s - b * thd) / (l * den)
        return [xd, thd, xdd, thdd]
    n, mass = jm.mean_motion, jm.mass
    px, _, pz, vx, vy, vz = x
    return [vx, vy, vz, 2 * n * vy + 3 * n * n * px + u[0] / mass,
            -2 * n * vx + u[1] / mass, -n * n * pz + u[2] / mass]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference_formula(case):
    jm, x, u = CASES[case]
    got = port_model(jm)(torch.tensor([x], dtype=torch.float64),
                         torch.tensor([u], dtype=torch.float64), None)[0].numpy()
    np.testing.assert_allclose(got, _oracle(case, x, u, jm), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobians_match_jax(case):
    """The pendulum's analytic Jacobians (copied from the JAX model), the
    cart-pole's and HCW's by AD, as the JAX models give theirs."""
    jm = CASES[case][0]
    X, U = _batch(case, seed=1)
    Fx, Fu = port_model(jm).jacobians(torch.as_tensor(X), torch.as_tensor(U), 0.0)
    np.testing.assert_allclose(Fx.numpy(), _jax_rows(lambda x, u: jm.jacobians(x, u, 0.0)[0],
                                                     X, U), **TOL)
    np.testing.assert_allclose(Fu.numpy(), _jax_rows(lambda x, u: jm.jacobians(x, u, 0.0)[1],
                                                     X, U), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobians_match_finite_differences(case):
    """As tests/test_models.py:94 holds the JAX models."""
    jm, x, u = CASES[case]
    model = port_model(jm)
    xt, ut = torch.tensor([x], dtype=torch.float64), torch.tensor([u], dtype=torch.float64)
    Fx, Fu = (J[0].numpy() for J in model.jacobians(xt, ut, 0.0))
    f = lambda xx, uu: model(torch.as_tensor(np.asarray(xx))[None],  # noqa: E731
                             torch.as_tensor(np.asarray(uu))[None], None)[0].numpy()
    Fx_fd = finite_difference_jacobian(lambda xx: f(xx, u), np.asarray(x), h=1e-6)
    Fu_fd = finite_difference_jacobian(lambda uu: f(x, uu), np.asarray(u), h=1e-6)
    np.testing.assert_allclose(Fx, Fx_fd, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Fu, Fu_fd, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_parameters_are_the_jax_lanes(case):
    """Each registry entry's parameter vector is the JAX lane registry's, in
    its order, and names the model's CUDA struct."""
    jm = CASES[case][0]
    entry = rollout_ops.model_entry(port_model(jm))
    assert entry is not None and entry.cuda_name == case
    assert entry.tag == "@" + case
    np.testing.assert_array_equal(entry.params(port_model(jm)), model_params(jm))
    assert len(model_params(jm)) == jlane._REGISTRY[type(jm).__name__][0]


def test_subclasses_keep_the_plain_path():
    class Heavier(Pendulum):
        pass

    assert rollout_ops.model_entry(Heavier()) is None


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_integrate_lane_matches_jax_lane(case, integrator):
    """One step of the kernels' stage arithmetic (``integrate_lane``)
    against the JAX lane integrator over the JAX lane function, on the
    registry's parameter vector."""
    jm = CASES[case][0]
    X, U = _batch(case, seed=2)
    dt = 0.05 if case != "hcw" else 30.0
    model = port_model(jm)
    got = rollout_ops.integrate_lane(lambda x, u: model(x, u, None), integrator,
                                     torch.as_tensor(X), torch.as_tensor(U),
                                     torch.tensor(dt, dtype=torch.float64)).numpy()
    lane_f = jlane._REGISTRY[type(jm).__name__][2]
    p = jnp.asarray(model_params(jm))
    xs = [jnp.asarray(X[:, i]) for i in range(X.shape[1])]
    us = [jnp.asarray(U[:, i]) for i in range(U.shape[1])]
    want = np.stack([np.asarray(v) for v in jlane._integrate_lane(
        lane_f, integrator, xs, us, p, jnp.full(X.shape[0], dt))], -1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interop_carries_the_model_and_its_parameters(case):
    jm = CASES[case][0].replace(integration_type="rk4")
    nx, nu = jm.state_dim, jm.control_dim
    p = problem_from_arrays(
        type(jm).__name__, model_params(jm), np.eye(nx), np.eye(nu), np.eye(nx),
        np.zeros(nx), -np.ones(nu), np.ones(nu), np.zeros(nx), 5, 0.1, "rk4",
        device="cpu", dtype=torch.float64)
    assert type(p.model) is type(port_model(jm)) and p.model.integration_type == "rk4"
    np.testing.assert_array_equal(rollout_ops.model_entry(p.model).params(p.model),
                                  model_params(jm))
    X, U = _batch(case, seed=3)
    np.testing.assert_allclose(
        p.model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), 0.0, 0.1).numpy(),
        _jax_rows(lambda x, u: jm.discrete_dynamics(x, u, 0.0, 0.1), X, U), **TOL)


def test_interop_names_the_ported_models():
    with pytest.raises(ValueError, match="Acrobot.*Bicycle.*CartPole.*DreyfusRocket.*DubinsCar"
                                         ".*HCW.*Pendulum.*Quadrotor.*Unicycle"):
        problem_from_arrays("Manipulator", [], np.eye(4), np.eye(2), np.eye(4), np.zeros(4),
                            None, None, np.zeros(4), 5, 0.1, "euler", device="cpu",
                            dtype=torch.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interop_refuses_a_short_parameter_vector(case):
    """A model's parameters are carried in full, never left at defaults."""
    jm = CASES[case][0]
    nx, nu = jm.state_dim, jm.control_dim
    with pytest.raises(ValueError, match="takes"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(nu),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, 0.1, "euler",
                            device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_parameters_follow_the_solve_dtype(case):
    """Parameters are float64 buffers; a float32 solve casts them, as it
    casts every tensor of the problem (``canonicalize_problem_dtype``)."""
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    jm = CASES[case][0]
    nx, nu = jm.state_dim, jm.control_dim
    p = problem_from_arrays(
        type(jm).__name__, model_params(jm), np.eye(nx), np.eye(nu), np.eye(nx),
        np.zeros(nx), None, None, np.zeros(nx), 5, 0.1, "euler", device="cpu",
        dtype=torch.float32)
    assert all(b.dtype == torch.float64 for b in p.model.buffers())
    cast = canonicalize_problem_dtype(p).model
    assert all(b.dtype == torch.float32 for b in cast.buffers())
    np.testing.assert_array_equal(rollout_ops.model_entry(cast).params(cast),
                                  model_params(jm).astype(np.float32))


# --- the CUDA structs (ops/csrc/models.cuh) as host C++ ------------------------------

_HOST_EVAL = r"""
#include "models.cuh"

template <class M>
void eval(const double* x, const double* u, const double* p, double* dx, double* Fx,
          double* Fu, int B) {
  for (int b = 0; b < B; ++b) {
    double xb[M::NX], ub[M::NU], d[M::NX], A[M::NX][M::NX], G[M::NX][M::NU];
    for (int i = 0; i < M::NX; ++i) xb[i] = x[b * M::NX + i];
    for (int i = 0; i < M::NU; ++i) ub[i] = u[b * M::NU + i];
    M::f(xb, ub, p, d);
    M::fxfu(xb, ub, p, A, G);
    for (int i = 0; i < M::NX; ++i) {
      dx[b * M::NX + i] = d[i];
      for (int j = 0; j < M::NX; ++j) Fx[(b * M::NX + i) * M::NX + j] = A[i][j];
      for (int j = 0; j < M::NU; ++j) Fu[(b * M::NX + i) * M::NU + j] = G[i][j];
    }
  }
}

extern "C" {
void eval_pendulum(const double* x, const double* u, const double* p, double* dx, double* Fx,
                   double* Fu, int B) { eval<cddp::Pendulum>(x, u, p, dx, Fx, Fu, B); }
void eval_cartpole(const double* x, const double* u, const double* p, double* dx, double* Fx,
                   double* Fu, int B) { eval<cddp::CartPole>(x, u, p, dx, Fx, Fu, B); }
void eval_hcw(const double* x, const double* u, const double* p, double* dx, double* Fx,
              double* Fu, int B) { eval<cddp::HCW>(x, u, p, dx, Fx, Fu, B); }
}
"""


@pytest.fixture(scope="module")
def host_structs(tmp_path_factory):
    """``models.cuh`` compiled for the host with g++ (``-ffp-contract=off``,
    as the float64 build's ``--fmad=false``) against the stand-in
    ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    import ctypes
    import shutil
    import subprocess

    from cddp_tpu_torch.ops.kernels import build
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA structs for the host")
    d = tmp_path_factory.mktemp("host_structs")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "eval.cpp").write_text(_HOST_EVAL + _HOST_EVAL_NEW.replace('#include "models.cuh"', ""))
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", str(d / "eval.cpp"), "-o",
                    str(d / "eval.so")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "eval.so"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_struct_matches_plain_model(case, host_structs):
    """Each model's CUDA struct (f and fxfu on its registry parameter
    vector) against the plain model's forward and Jacobians: the same
    expressions, so equal but for the last bits of the host libm's sin and
    cos against torch's (1e-12)."""
    import ctypes

    jm = CASES[case][0]
    model = port_model(jm)
    X, U = _batch(case, B=64, seed=4)
    nx, nu, B = X.shape[1], U.shape[1], X.shape[0]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).params(model), np.float64)
    dx, Fx, Fu = np.zeros((B, nx)), np.zeros((B, nx, nx)), np.zeros((B, nx, nu))
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    getattr(host_structs, f"eval_{case}")(ptr(X), ptr(U), ptr(p), ptr(dx), ptr(Fx), ptr(Fu),
                                          ctypes.c_int(B))
    want_Fx, want_Fu = model.jacobians(torch.as_tensor(X), torch.as_tensor(U), 0.0)
    np.testing.assert_allclose(dx, model(torch.as_tensor(X), torch.as_tensor(U), None).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Fx, want_Fx.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Fu, want_Fu.numpy(), rtol=1e-12, atol=1e-12)


# --- the car, the forklift and the LTISystem -----------------------------------------

from cddp_tpu.models import Car as JCar  # noqa: E402
from cddp_tpu.models import Forklift as JForklift  # noqa: E402
from cddp_tpu.models import lti_system as jlti_system  # noqa: E402
from cddp_tpu_torch.models import lti_system  # noqa: E402

# (JAX model with non-default parameters, x, u, dt of its discrete map).
NEW_CASES = {
    "car": (JCar(wheelbase=2.3, timestep=0.04), [0.3, -0.2, 0.7, 1.5], [0.2, 0.6], 0.04),
    "forklift": (JForklift(wheelbase=1.7, rear_steer=True), [0.3, -0.2, 0.7, 1.1, 0.3],
                 [0.4, -0.2], 0.05),
    "forklift_front": (JForklift(wheelbase=1.7, rear_steer=False), [0.3, -0.2, 0.7, 1.1, 0.3],
                       [0.4, -0.2], 0.05),
    "lti": (jlti_system(0.1), [1.0, -0.5, 0.2, 0.8], [0.3, -0.1], 0.1),
}


def _new_batch(case, B=6, seed=0):
    _, x, u, _ = NEW_CASES[case]
    rng = np.random.default_rng(seed)
    X = np.asarray(x) + 0.2 * rng.standard_normal((B, len(x)))
    U = np.asarray(u) + 0.1 * rng.standard_normal((B, len(u)))
    return X, U


@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_new_models_match_jax(case):
    """forward (the continuous form: the car's and the LTISystem's finite
    difference of their map over their own timestep), the Jacobians (by
    AD, as the JAX models give theirs) and the discrete map, 1e-12."""
    jm, _, _, dt = NEW_CASES[case]
    X, U = _new_batch(case)
    model = port_model(jm)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(model(Xt, Ut, None).numpy(), _jax_rows(
        lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **TOL)
    Fx, Fu = model.jacobians(Xt, Ut, 0.0)
    np.testing.assert_allclose(Fx.numpy(), _jax_rows(lambda x, u: jm.jacobians(x, u, 0.0)[0],
                                                     X, U), **TOL)
    np.testing.assert_allclose(Fu.numpy(), _jax_rows(lambda x, u: jm.jacobians(x, u, 0.0)[1],
                                                     X, U), **TOL)
    np.testing.assert_allclose(model.discrete_dynamics(Xt, Ut, 0.0, dt).numpy(), _jax_rows(
        lambda x, u: jm.discrete_dynamics(x, u, 0.0, dt), X, U), **TOL)


def test_car_map_is_the_jax_lane():
    """The car's exact map on a tensor dt, as the kernels' plain versions
    step it (``rollout.lane_step``), against the JAX lane function
    (rollout.py:183-194) on the registry's parameter vector."""
    jm, _, _, dt = NEW_CASES["car"]
    X, U = _new_batch("car", seed=2)
    model = port_model(jm)
    entry = rollout_ops.model_entry(model)
    got = rollout_ops.lane_step(model, entry, "rk4", torch.as_tensor(X), torch.as_tensor(U),
                                torch.tensor(dt, dtype=torch.float64)).numpy()
    lane_f = jlane._REGISTRY["Car"][2]
    want = np.stack([np.asarray(v) for v in lane_f(
        [jnp.asarray(X[:, i]) for i in range(4)], [jnp.asarray(U[:, i]) for i in range(2)],
        jnp.asarray(model_params(jm)), jnp.full(X.shape[0], dt))], -1)
    np.testing.assert_allclose(got, want, **TOL)


def test_car_and_forklift_pins():
    """tests/test_model_oracles.py:32-47 (test_car.cpp:66-81, the MATLAB
    demo's steps) and :150-171 (test_forklift.cpp's straight line, steering
    rate, acceleration and the rear-steer sign) on the port's models."""
    f = lambda *v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    car = Car(wheelbase=2.0, timestep=0.03)
    np.testing.assert_allclose(car.discrete_dynamics(
        f(1.0, 1.0, 3 * np.pi / 2, 0.0), f(0.01, 0.01), 0.0, 0.03)[0].numpy(),
        [1.0, 1.0, 4.7124, 0.0003], atol=1e-4)
    np.testing.assert_allclose(car.discrete_dynamics(
        f(1.0, 1.0, 3 * np.pi / 2, 1.0), f(0.3, 0.1), 0.0, 0.03)[0].numpy(),
        [1.0, 0.9713, 4.7168, 1.0030], atol=1e-4)
    fl = Forklift(wheelbase=2.0, rear_steer=True)
    step = lambda m, x, u: m.discrete_dynamics(f(*x), f(*u), 0.0, 0.01)[0].numpy()  # noqa: E731
    np.testing.assert_allclose(step(fl, (0.0, 0.0, 0.0, 1.0, 0.0), (0.0, 0.0)),
                               [0.01, 0, 0, 1.0, 0], atol=1e-6)
    assert abs(step(fl, (0.0,) * 5, (0.0, 0.5))[4] - 0.005) < 1e-6
    assert abs(step(fl, (0.0,) * 5, (2.0, 0.0))[3] - 0.02) < 1e-6
    x = (0.0, 0.0, 0.0, 1.0, np.pi / 6)
    tr = step(fl, x, (0.0, 0.0))[2]
    tf = step(Forklift(wheelbase=2.0, rear_steer=False), x, (0.0, 0.0))[2]
    assert abs(tr + tf) < 1e-6 and abs(tf) > 0


def test_lti_builder_matches_jax():
    """The default 4x2 system (expm(dt A0), dt B0; lti_system.cpp:15-31),
    user matrices as given, and the seeded random path: skew-symmetric
    continuous A, so A_d is orthogonal, B within dt of zero."""
    jm = jlti_system(0.05)
    sys = lti_system(0.05, device="cpu")
    np.testing.assert_allclose(sys.A.numpy(), np.asarray(jm.A), **TOL)
    np.testing.assert_allclose(sys.B.numpy(), np.asarray(jm.B), **TOL)
    assert (sys.state_dim, sys.control_dim) == (4, 2)
    user = lti_system(1.0, A=np.eye(1), B=2.0 * np.eye(1), device="cpu")
    assert user.A.item() == 1.0 and user.B.item() == 2.0 and user.state_dim == 1
    rnd = lti_system(0.1, generator=torch.Generator().manual_seed(3), state_dim=3,
                     control_dim=2, device="cpu")
    np.testing.assert_allclose((rnd.A @ rnd.A.T).numpy(), np.eye(3), atol=1e-12)
    assert rnd.B.shape == (3, 2) and float(rnd.B.abs().max()) <= 0.1
    again = lti_system(0.1, generator=torch.Generator().manual_seed(3), state_dim=3,
                       control_dim=2, device="cpu")
    assert torch.equal(again.A, rnd.A) and torch.equal(again.B, rnd.B)
    with pytest.raises(ValueError, match="square"):
        lti_system(0.1, A=np.ones((2, 3)), B=np.ones((2, 1)), device="cpu")


@pytest.mark.parametrize("case", ["car", "forklift", "forklift_front"])
def test_new_registry_parameters_are_the_jax_lanes(case):
    jm = NEW_CASES[case][0]
    entry = rollout_ops.model_entry(port_model(jm))
    name = case.split("_")[0]
    assert entry.cuda_name == name and entry.tag == "@" + name
    assert entry.discrete == (name == "car")
    np.testing.assert_array_equal(entry.params(port_model(jm)), model_params(jm))
    assert len(model_params(jm)) == jlane._REGISTRY[type(jm).__name__][0]
    assert len(jlane._REGISTRY[type(jm).__name__]) == (4 if name == "car" else 3)
    assert rollout_ops.model_entry(port_model(NEW_CASES["lti"][0])) is None


@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_interop_carries_the_new_models(case):
    """The car takes the problem's timestep, the forklift its steering
    convention from the sign, the LTISystem its A and B."""
    jm, _, _, dt = NEW_CASES[case]
    nx, nu = jm.state_dim, jm.control_dim
    p = problem_from_arrays(
        type(jm).__name__, model_params(jm), np.eye(nx), np.eye(nu), np.eye(nx),
        np.zeros(nx), -np.ones(nu), np.ones(nu), np.zeros(nx), 5, dt, "euler",
        device="cpu", dtype=torch.float64)
    assert type(p.model) is type(port_model(jm))
    X, U = _new_batch(case, seed=3)
    np.testing.assert_allclose(
        p.model(torch.as_tensor(X), torch.as_tensor(U), None).numpy(),
        _jax_rows(lambda x, u: jm.continuous_dynamics(x, u, 0.0), X, U), **TOL)
    with pytest.raises(ValueError, match="takes"):
        problem_from_arrays(type(jm).__name__, model_params(jm)[:-1], np.eye(nx), np.eye(nu),
                            np.eye(nx), np.zeros(nx), None, None, np.zeros(nx), 5, dt,
                            "euler", device="cpu", dtype=torch.float64)


_HOST_EVAL_NEW = r"""
#include "models.cuh"

extern "C" {
void eval_forklift(const double* x, const double* u, const double* p, double* dx, double* Fx,
                   double* Fu, int B) { eval<cddp::Forklift>(x, u, p, dx, Fx, Fu, B); }
// integrate()'s discrete branch: Car::step in place of the stepper `kind`.
void step_car(const double* x, const double* u, const double* p, double dt, int kind,
              double* out, int B) {
  using M = cddp::Car;
  for (int b = 0; b < B; ++b) {
    double xb[M::NX], ub[M::NU], o[M::NX];
    for (int i = 0; i < M::NX; ++i) xb[i] = x[b * M::NX + i];
    for (int i = 0; i < M::NU; ++i) ub[i] = u[b * M::NU + i];
    cddp::integrate<double, M>(kind, xb, ub, p, dt, o);
    for (int i = 0; i < M::NX; ++i) out[b * M::NX + i] = o[i];
  }
}
}
"""


def test_cuda_car_step_matches_plain_map(host_structs):
    """``integrate<Car>`` takes ``Car::step`` whatever the stepper code, and
    it rounds like the plain map (1e-12: the host libm against torch's
    sin, cos, sqrt and asin); past the map's reach both are NaN."""
    import ctypes

    jm, _, _, dt = NEW_CASES["car"]
    model = port_model(jm)
    X, U = _new_batch("car", B=64, seed=4)
    X[0, 3], U[0, 0] = 400.0, 0.5  # |dt v sin(delta)| > d: NaN
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).params(model), np.float64)
    want = model.discrete_dynamics(torch.as_tensor(X), torch.as_tensor(U), None, dt).numpy()
    assert np.isnan(want[0, 0])
    for kind in range(4):
        out = np.zeros_like(X)
        host_structs.step_car(ptr(X), ptr(U), ptr(p), ctypes.c_double(dt), ctypes.c_int(kind),
                              ptr(out), ctypes.c_int(X.shape[0]))
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["forklift", "forklift_front"])
def test_cuda_forklift_struct_matches_plain_model(case, host_structs):
    import ctypes

    jm = NEW_CASES[case][0]
    model = port_model(jm)
    X, U = _new_batch(case, B=64, seed=5)
    X, U = np.ascontiguousarray(X), np.ascontiguousarray(U)
    B, nx, nu = X.shape[0], 5, 2
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    p = np.asarray(rollout_ops.model_entry(model).params(model), np.float64)
    dx, Fx, Fu = np.zeros((B, nx)), np.zeros((B, nx, nx)), np.zeros((B, nx, nu))
    host_structs.eval_forklift(ptr(X), ptr(U), ptr(p), ptr(dx), ptr(Fx), ptr(Fu),
                               ctypes.c_int(B))
    want_Fx, want_Fu = model.jacobians(torch.as_tensor(X), torch.as_tensor(U), 0.0)
    np.testing.assert_allclose(dx, model(torch.as_tensor(X), torch.as_tensor(U), None).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Fx, want_Fx.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Fu, want_Fu.numpy(), rtol=1e-12, atol=1e-12)
