"""The pendulum, cart-pole, quadrotor, scalar terminal-equality and
car-parking goldens (tests/goldens/, made by tests/make_goldens.py:49-97,
:110-124 and :135-189) through the port's ``tt.solve`` on CPU tensors in
float64, at ``test_golden``'s tolerances (tests/test_goldens.py:51-60):
cost rtol 1e-9, X and U rtol 1e-7 and atol 1e-9, status and iteration count
exact. The four pendulum goldens run N = 100, the cart-pole's N = 200 over
177 iterations (about 50 s on one core), the quadrotor's IPDDP N = 60 over
26 iterations from hover controls, the car's MSIPDDP N = 300 over 49
iterations (about 17 s), the scalar LTISystem's IPDDP without path
constraints N = 8 (the reduced LQR of its terminal equality). The
quadrotor figure-8 anchor (tests/test_parity_anchors.py:72-120) runs as its
JAX test does, marked slow."""

from pathlib import Path

import numpy as np
import pytest
import torch

import cddp_tpu_torch as tt
from cddp_tpu_torch.models import Car, CartPole, LTISystem, Pendulum, quadrotor
from cddp_tpu_torch.options import RegularizationOptions

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens"
KW = dict(device="cpu", dtype=torch.float64)


def _t(v):
    return torch.as_tensor(v, dtype=torch.float64)


def pendulum_problem():
    """make_goldens.py:50-56: N = 100, dt = 0.02, the box +-20."""
    obj = tt.quadratic_objective(_t(np.zeros((2, 2))), _t(0.1 * np.eye(1)),
                                 _t(100.0 * np.eye(2)), [0.0, 0.0], 0.02, **KW)
    p = tt.problem(Pendulum(length=0.5, damping=0.01), obj, [np.pi, 0.0], 100, 0.02, **KW)
    return p.add_constraint("ControlConstraint", tt.control_constraint([-20.0], [20.0], **KW))


def cartpole_problem():
    """make_goldens.py:58-67: N = 200, dt = 0.02, the box +-100."""
    obj = tt.quadratic_objective(_t(np.diag([0.1, 1.0, 0.1, 0.1])), _t(0.05 * np.eye(1)),
                                 _t(np.diag([100.0, 500.0, 10.0, 10.0])),
                                 [0.0, np.pi, 0.0, 0.0], 0.02, **KW)
    p = tt.problem(CartPole(), obj, np.zeros(4), 200, 0.02, **KW)
    return p.add_constraint("ControlConstraint", tt.control_constraint([-100.0], [100.0], **KW))


def quadrotor_problem():
    """make_goldens.py:69-84: the quadrotor (rk4, inertia diag(0.01, 0.01,
    0.02)), N = 60, dt = 0.02, from hover at the origin to (1.5, 0, 1), the
    rotor box [0, 9]^4."""
    goal = np.zeros(13)
    goal[[0, 2, 3]] = (1.5, 1.0, 1.0)
    Q = np.zeros((13, 13))
    Q[[4, 5, 6], [4, 5, 6]] = 0.1
    Qf = np.diag([500.0, 500.0, 500.0, 1.0, 1.0, 1.0, 1.0, 10.0, 10.0, 10.0, 0.0, 0.0, 0.0])
    obj = tt.quadratic_objective(_t(Q), _t(0.1 * np.eye(4)), _t(Qf), goal, 0.02, **KW)
    model = quadrotor(mass=1.0, inertia=np.diag([0.01, 0.01, 0.02]), arm_length=0.2,
                      integration_type="rk4", device="cpu")
    x0 = np.zeros(13)
    x0[3] = 1.0
    p = tt.problem(model, obj, x0, 60, 0.02, **KW)
    return p.add_constraint("ControlConstraint",
                            tt.control_constraint(np.zeros(4), np.full(4, 9.0), **KW))


def scalar_terminal_eq_problem():
    """make_goldens.py:87-97: x+ = x + u, N = 8, dt = 1, x_N = 0.6."""
    obj = tt.quadratic_objective(_t(np.zeros((1, 1))), _t(1e-2 * np.eye(1)),
                                 _t(100.0 * np.eye(1)), [0.6], 1.0, **KW)
    p = tt.problem(LTISystem(_t(np.eye(1)), _t(np.eye(1)), 1.0), obj, [0.0], 8, 1.0, **KW)
    return p.add_terminal_constraint("TerminalEqualityConstraint",
                                     tt.terminal_equality_constraint([0.6], **KW))


def car_problem():
    """make_goldens.py:110-124: N = 300, dt = 0.03, the box [-0.5, -2]..[0.5, 2]."""
    dt = 0.03
    obj = tt.quadratic_objective(_t(np.diag([1e-2, 1e-2, 1e-3, 1e-3])), _t(1e-2 * np.eye(2)),
                                 _t(np.diag([100.0, 100.0, 50.0, 10.0])), [0.0] * 4, dt, **KW)
    p = tt.problem(Car(wheelbase=2.0, timestep=dt), obj, [1.0, 1.0, 1.5 * np.pi, 0.0], 300,
                   dt, **KW)
    return p.add_constraint("ControlConstraint",
                            tt.control_constraint([-0.5, -2.0], [0.5, 2.0], **KW))


IP_OPTS = dict(max_iterations=300, tolerance=1e-4, acceptable_tolerance=1e-5)
# name -> (problem, solver, options, solve keywords), as make_goldens.configs
CASES = {
    "pendulum_clddp": (pendulum_problem, "CLDDP",
                       dict(max_iterations=100, tolerance=1e-3, acceptable_tolerance=1e-4),
                       lambda: {"X0": _t([np.pi, 0.0]).repeat(101, 1)}),
    "pendulum_ipddp": (pendulum_problem, "IPDDP", IP_OPTS, dict),
    "pendulum_logddp": (pendulum_problem, "LogDDP", IP_OPTS, dict),
    "pendulum_msipddp": (pendulum_problem, "MSIPDDP", IP_OPTS, dict),
    "cartpole_clddp": (cartpole_problem, "CLDDP",
                       dict(max_iterations=300, tolerance=1e-4, acceptable_tolerance=1e-6),
                       dict),
    "quadrotor_ipddp": (quadrotor_problem, "IPDDP",
                        dict(max_iterations=120, tolerance=1e-4, acceptable_tolerance=1e-5,
                             regularization=RegularizationOptions(initial_value=1e-4)),
                        lambda: {"U0": _t(np.full((60, 4), 9.81 / 4.0))}),
    "scalar_terminal_eq_ipddp": (
        scalar_terminal_eq_problem, "IPDDP",
        dict(max_iterations=60, tolerance=1e-6, acceptable_tolerance=1e-6,
             ipddp=tt.IPDDPOptions(barrier=tt.BarrierOptions(mu_initial=1e-1))), dict),
    "car_msipddp": (
        car_problem, "MSIPDDP",
        dict(max_iterations=150, tolerance=1e-4, acceptable_tolerance=1e-6,
             regularization=RegularizationOptions(initial_value=1e-2),
             msipddp=tt.MSIPDDPOptions(segment_length=50, rollout_type="nonlinear",
                                       barrier=tt.BarrierOptions(mu_initial=1.0))), dict),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    g = np.load(GOLDENS / f"{name}.npz")
    make, solver, opts, kw = CASES[name]
    sol = tt.solve(make(), solver, tt.CDDPOptions(**opts), **kw())
    assert int(sol.status_code) == int(g["status"])
    assert int(sol.iterations_completed) == int(g["iterations"])
    np.testing.assert_allclose(float(sol.final_objective), g["cost"], rtol=1e-9)
    np.testing.assert_allclose(sol.state_trajectory.numpy(), g["X"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sol.control_trajectory.numpy(), g["U"], rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_quadrotor_figure8():
    """tests/test_parity_anchors.py:72-120 through the port: the quadrotor
    (mass 1.2, inertia diag(7.782e-3, 7.782e-3, 1.439e-2), arm 0.165, rk4)
    tracking a figure-8 of 3 m at 2 m altitude over N = 150 steps of 0.02 s
    with the rotor box [0, 4]^4, IPDDP from hover thrust, tolerance 1e-6;
    the reference's assertions: final position error < 0.5 and every
    quaternion norm within 0.1 of 1, and the mean tracking error < 2."""
    dt, N, mass = 0.02, 150, 1.2
    model = quadrotor(mass=mass, inertia=np.diag([7.782e-3, 7.782e-3, 1.439e-2]),
                      arm_length=0.165, integration_type="rk4", device="cpu")
    Q = np.zeros((13, 13))
    Q[np.arange(7), np.arange(7)] = 1.0
    omega = 2.0 * np.pi / (N * dt)
    ts = np.arange(N + 1) * dt
    refs = np.zeros((N + 1, 13))
    refs[:, 0] = 3.0 * np.cos(omega * ts)
    refs[:, 1] = 3.0 * np.sin(omega * ts) * np.cos(omega * ts)
    refs[:, 2] = 2.0
    refs[:, 3] = 1.0
    obj = tt.quadratic_objective(_t(Q), _t(0.01 * np.eye(4)), _t(Q), refs[-1], dt,
                                 reference_states=_t(refs), **KW)
    p = tt.problem(model, obj, refs[0], N, dt, **KW).add_constraint(
        "ControlConstraint", tt.control_constraint(np.zeros(4), np.full(4, 4.0), **KW))
    sol = tt.solve(p, "IPDDP", tt.CDDPOptions(
        max_iterations=300, tolerance=1e-6, acceptable_tolerance=1e-5,
        regularization=RegularizationOptions(initial_value=1e-4)),
        U0=_t(np.full((N, 4), mass * 9.81 / 4.0)))
    X = sol.state_trajectory.numpy()
    assert np.linalg.norm(X[-1, :3] - refs[-1, :3]) < 0.5, sol.status_messages()
    assert np.abs(np.linalg.norm(X[:, 3:7], axis=1) - 1.0).max() < 0.1
    assert np.linalg.norm(X[:, :3] - refs[:, :3], axis=1).mean() < 2.0
