"""cddp_tpu_torch foundations against the JAX package (CPU, float64):
options, status codes, integrators, the unicycle, the quadratic objective,
problems built from arrays, the solver registry, and that the port never
imports JAX."""

import dataclasses
import enum
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.models import Unicycle as JUnicycle
from cddp_tpu.ops.integrators import integrate as jintegrate
from cddp_tpu.options import line_search_alphas as jalphas
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.models import DynamicalSystem, Unicycle
from cddp_tpu_torch.ops.integrators import integrate
from cddp_tpu_torch.options import LineSearchOptions, line_search_alphas

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-12, atol=1e-12)


def port_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX CLDDP problem, through numpy arrays."""
    o, cc = jp.objective, jp.get_constraint("ControlConstraint")
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state,
        None if cc is None else cc.lower, None if cc is None else cc.upper,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype,
    )


def flagship_jax(horizon=20, integrator="euler"):
    """``__graft_entry__._flagship_problem`` in float64."""
    obj = ct.quadratic_objective(0.1 * jnp.eye(3), 0.05 * jnp.eye(2),
                                 100.0 * jnp.eye(3),
                                 jnp.asarray([2.0, 2.0, jnp.pi / 2]), 0.05)
    prob = ct.problem(JUnicycle(integration_type=integrator), obj, jnp.zeros(3),
                      horizon, 0.05)
    return prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.asarray([-2.0, -jnp.pi]),
                              jnp.asarray([2.0, jnp.pi])))


def _assert_same_fields(port, ref):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            _assert_same_fields(mine, theirs)
        elif isinstance(mine, enum.Enum):
            assert (type(mine).__name__, mine.value) == (type(theirs).__name__,
                                                        theirs.value), f.name
        else:
            assert mine == theirs, f.name


def test_options_defaults_match_jax():
    _assert_same_fields(tt.CDDPOptions(), ct.CDDPOptions())
    assert tt.CDDPOptions().max_iterations == 1  # the reference's default
    assert not hasattr(tt.CDDPOptions(), "matmul_precision")


@pytest.mark.parametrize("kw", [
    {}, dict(max_iterations=30), dict(step_reduction_factor=0.1),
    dict(max_iterations=1), dict(initial_step_size=0.7, min_step_size=0.3),
])
def test_line_search_alphas_match_jax(kw):
    assert line_search_alphas(LineSearchOptions(**kw)) == jalphas(
        ct.LineSearchOptions(**kw))


def test_status_codes_match_jax():
    from cddp_tpu.solution import Status as JStatus

    for name in ("RUNNING", "MAX_ITERATIONS_REACHED", "OPTIMAL_SOLUTION_FOUND",
                 "ACCEPTABLE_SOLUTION_FOUND", "REGULARIZATION_LIMIT_NOT_CONVERGED",
                 "REGULARIZATION_LIMIT_CONVERGED", "MAX_CPU_TIME_REACHED"):
        assert getattr(tt.Status, name) == getattr(JStatus, name)
    assert tt.Status.MESSAGES == JStatus.MESSAGES
    assert tt.Status.CONVERGED == JStatus.CONVERGED


def _states(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)), rng.normal(size=(n, 2))


@pytest.mark.parametrize("method", ["euler", "heun", "rk3", "rk4"])
def test_integrators_match_jax(method):
    x, u = _states()
    jm = JUnicycle()
    want = np.stack([
        np.asarray(jintegrate(jm.continuous_dynamics, method, jnp.asarray(xi),
                              jnp.asarray(ui), 0.0, 0.05))
        for xi, ui in zip(x, u)
    ])
    got = integrate(Unicycle(), method, torch.as_tensor(x), torch.as_tensor(u),
                    0.0, 0.05)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unicycle_dynamics_and_jacobians_match_jax():
    x, u = _states(seed=1)
    jm, m = JUnicycle(), Unicycle()
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    f = np.stack([np.asarray(jm.continuous_dynamics(jnp.asarray(a), jnp.asarray(b), 0.0))
                  for a, b in zip(x, u)])
    np.testing.assert_allclose(m(xt, ut, 0.0).numpy(), f, **TOL)
    Fx, Fu = m.jacobians(xt, ut, 0.0)
    # The base class's jacfwd path must agree with the analytic override.
    Fx_ad, Fu_ad = DynamicalSystem.jacobians(m, xt, ut, 0.0)
    for i, (a, b) in enumerate(zip(x, u)):
        jFx, jFu = jm.jacobians(jnp.asarray(a), jnp.asarray(b), 0.0)
        for got in (Fx[i], Fx_ad[i]):
            np.testing.assert_allclose(got.numpy(), np.asarray(jFx), **TOL)
        for got in (Fu[i], Fu_ad[i]):
            np.testing.assert_allclose(got.numpy(), np.asarray(jFu), **TOL)


def test_quadratic_objective_matches_jax():
    rng = np.random.default_rng(2)
    Q, R, Qf = (np.eye(n) + 0.1 * (lambda a: a + a.T)(rng.normal(size=(n, n)))
                for n in (3, 2, 3))
    goal = rng.normal(size=3)
    jo = ct.quadratic_objective(Q, R, Qf, goal, 0.05)
    po = tt.quadratic_objective(Q, R, Qf, goal, 0.05, device="cpu", dtype=torch.float64)
    X, U = rng.normal(size=(4, 7, 3)), rng.normal(size=(4, 6, 2))
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    np.testing.assert_allclose(po.evaluate(Xt, Ut).numpy(),
                               [float(jo.evaluate(jnp.asarray(a), jnp.asarray(b)))
                                for a, b in zip(X, U)], **TOL)
    x, u = X[:, 0], U[:, 0]
    lx, lu = po.running_cost_gradients(torch.as_tensor(x), torch.as_tensor(u))
    lxx, luu, lux = po.running_cost_hessians(torch.as_tensor(x), torch.as_tensor(u))
    Vx = po.terminal_cost_gradient(torch.as_tensor(x))
    Vxx = po.terminal_cost_hessian(torch.as_tensor(x))
    for i in range(4):
        xi, ui = jnp.asarray(x[i]), jnp.asarray(u[i])
        for got, want in zip(
            (lx[i], lu[i], lxx[i], luu[i], lux[i], Vx[i], Vxx[i]),
            (*jo.running_cost_gradients(xi, ui, 0),
             *jo.running_cost_hessians(xi, ui, 0),
             jo.terminal_cost_gradient(xi), jo.terminal_cost_hessian(xi)),
        ):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            float(po.running_cost(torch.as_tensor(x[i]), torch.as_tensor(u[i]))),
            float(jo.running_cost(xi, ui, 0)), **TOL)
    # A reference trajectory whose last row is not the goal: the JAX
    # package's ValueError (tracking itself: tests/test_torch_tracking.py).
    for build in (ct.quadratic_objective,
                  lambda *a, **k: tt.quadratic_objective(*a, **k, device="cpu")):
        with pytest.raises(ValueError, match="Last reference state must be same"):
            build(Q, R, Qf, goal, 0.05, reference_states=np.zeros((5, 3)))
    with pytest.raises(ValueError):
        tt.quadratic_objective(np.ones((3, 2)), R, Qf, goal, 0.05, device="cpu")


def test_problem_from_arrays_matches_jax_problem():
    jp = flagship_jax(horizon=7).replace(x0=jnp.asarray([0.1, -0.2, 0.3]))
    p = port_problem(jp)
    assert (p.horizon, p.timestep, p.state_dim, p.control_dim) == (7, 0.05, 3, 2)
    assert isinstance(p.model, Unicycle) and p.model.integration_type == "euler"
    o, jo = p.objective, jp.objective
    for got, want in ((o.Q, jo.Q), (o.R, jo.R), (o.Qf, jo.Qf),
                      (o.reference_state, jo.reference_state), (p.x0, jp.x0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cc, jcc = p.get_constraint("ControlConstraint"), jp.get_constraint("ControlConstraint")
    np.testing.assert_array_equal(cc.lower.numpy(), np.asarray(jcc.lower))
    np.testing.assert_array_equal(cc.upper.numpy(), np.asarray(jcc.upper))
    u = torch.tensor([[3.0, -4.0], [0.5, 0.1]], dtype=torch.float64)
    np.testing.assert_array_equal(
        cc.clamp(u).numpy(), [np.asarray(jcc.clamp(jnp.asarray(r))) for r in u.numpy()])
    X, U = p.initial_trajectories()
    jX, jU = jp.initial_trajectories()
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    with pytest.raises(ValueError):
        problem_from_arrays("Pendulum", [], *(np.eye(1),) * 3, [0.0], None, None,
                            [0.0], 5, 0.1, "euler", device="cpu", dtype=torch.float64)


def test_canonicalize_problem_dtype_follows_x0():
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    p = port_problem(flagship_jax(horizon=5)).replace(x0=torch.zeros(3))
    c = canonicalize_problem_dtype(p)
    assert c.objective.Q.dtype == torch.float32
    assert c.get_constraint("ControlConstraint").lower.dtype == torch.float32
    assert p.objective.Q.dtype == torch.float64  # the input is untouched


def test_solver_registry():
    from cddp_tpu_torch.solvers import clddp, get_solver, ipddp, logddp, msipddp

    for name in ("CLDDP", "CLCDDP", "CDDP", "iLQR"):
        assert get_solver(name) is clddp.solve
    assert get_solver("IPDDP") is ipddp.solve
    assert get_solver("LogDDP") is logddp.solve
    assert get_solver("LOGDDP") is logddp.solve
    assert get_solver("MSIPDDP") is msipddp.solve
    with pytest.raises(ValueError, match="Unknown solver"):
        get_solver("Nope")


def test_port_never_imports_jax():
    # Neither JAX nor any module of the JAX package, not even a JAX-free one:
    # `cddp_tpu` is a whole word, so `cddp_tpu_torch` does not match.
    pattern = re.compile(r"^\s*(import|from) (jax|flax|cddp_tpu)\b")
    files = [*(REPO / "cddp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [
        f"{path.relative_to(REPO)}:{n}"
        for path in files
        for n, line in enumerate(path.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert not offenders, offenders
    code = (
        "import sys\n"
        "import cddp_tpu_torch\n"
        "from cddp_tpu_torch.solvers import clddp\n"
        "from cddp_tpu_torch.ops.kernels import mega_clddp, riccati, rollout\n"
        "from cddp_tpu_torch.solvers import ipddp\n"
        "from cddp_tpu_torch.ops.kernels import ip_rollout, ipddp_riccati, mega_ipddp\n"
        "from cddp_tpu_torch.solvers import logddp, msipddp\n"
        "from cddp_tpu_torch.ops.kernels import mega_logddp, mega_msipddp\n"
        "from cddp_tpu_torch.constraints import barrier\n"
        "from cddp_tpu_torch import interop\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cddp_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'cddp_tpu_torch.ops.kernels.build' not in sys.modules\n"
        "print('clean')\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and "clean" in run.stdout, run.stderr[-2000:]


def test_builders_default_to_the_card():
    # Without a device the builders put their tensors on CUDA; with no CUDA
    # device they raise instead of falling back to the CPU.
    from cddp_tpu_torch.models import Unicycle

    builds = (
        lambda: tt.problem(Unicycle(), None, torch.zeros(3), 20, 0.05),
        lambda: tt.quadratic_objective(np.eye(3), np.eye(2), np.eye(3), np.zeros(3), 0.05),
        lambda: tt.control_constraint([-2.0, -1.0], [2.0, 1.0]),
        lambda: tt.state_constraint([-1.0] * 3, [1.0] * 3),
    )
    if torch.cuda.is_available():
        assert tt.problem(Unicycle(), None, torch.zeros(3), 20, 0.05).x0.is_cuda
        assert tt.control_constraint([-2.0], [2.0]).lower.is_cuda
        return
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    p = tt.problem(Unicycle(), None, [0.0, 0.0, 0.0], 20, 0.05, device="cpu")
    assert p.x0.device.type == "cpu"
