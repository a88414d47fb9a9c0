"""The port's ResidualObjective and NonlinearObjective against the JAX
package's (CPU, float64, 1e-12): values, Gauss-Newton gradients and
Hessians (and the AD derivatives of the extras), on batch-first inputs with
and without a step axis, with one set of parameters for the batch and with
one per instance (``batched``, a leaf-batched JAX objective under vmap).
Inputs are made with numpy from a seed."""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.costs import objective as jobj
import cddp_tpu_torch as tt

torch.set_num_threads(1)

B, N, NX, NU = 5, 4, 3, 2


class JToy(jobj.ResidualObjective):
    w: jax.Array = None

    def running_residuals(self, x, u, k):
        return jnp.stack([self.w[0] * jnp.sin(x[0]) * u[0], x[1] * x[2] - u[1],
                          jnp.cos(x[2]) + self.w[1] * u[0] * u[1], x[0] - 0.5])

    def terminal_residuals(self, x):
        return jnp.stack([x[0] * x[1], self.w[1] * jnp.sin(x[2])])

    def running_cost_extra(self, x, u, k):
        return 0.3 * x[0] ** 2 * u[1]

    def terminal_cost_extra(self, x):
        return -2.0 * x[1] + self.w[0] * x[2]


@dataclass(frozen=True)
class Toy(tt.ResidualObjective):
    w: torch.Tensor = None

    def running_residuals(self, x, u, k):
        return torch.stack([self.w[0] * torch.sin(x[0]) * u[0], x[1] * x[2] - u[1],
                            torch.cos(x[2]) + self.w[1] * u[0] * u[1], x[0] - 0.5])

    def terminal_residuals(self, x):
        return torch.stack([x[0] * x[1], self.w[1] * torch.sin(x[2])])

    def running_cost_extra(self, x, u, k):
        return 0.3 * x[0] ** 2 * u[1]

    def terminal_cost_extra(self, x):
        return -2.0 * x[1] + self.w[0] * x[2]


@dataclass(frozen=True)
class ToyNoExtra(tt.ResidualObjective):
    w: torch.Tensor = None

    def running_residuals(self, x, u, k):
        return torch.stack([self.w[0] * torch.sin(x[0]) * u[0], x[1] * x[2] - u[1]])


class JToyNoExtra(jobj.ResidualObjective):
    w: jax.Array = None

    def running_residuals(self, x, u, k):
        return jnp.stack([self.w[0] * jnp.sin(x[0]) * u[0], x[1] * x[2] - u[1]])


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N + 1, NX)), rng.normal(size=(B, N, NU)),
            rng.normal(size=(B, 2)) + 1.0)


def _jax_all(jo, X, U, batched):
    """Per instance (vmapped over the objective when ``batched``): running
    cost, gradients and Hessians over the steps, terminal cost, gradient,
    Hessian, total."""
    def one(o, Xi, Ui):
        ks = jnp.arange(N)
        run = jax.vmap(o.running_cost)(Xi[:-1], Ui, ks)
        g = jax.vmap(o.running_cost_gradients)(Xi[:-1], Ui, ks)
        h = jax.vmap(o.running_cost_hessians)(Xi[:-1], Ui, ks)
        return (run, *g, *h, o.terminal_cost(Xi[-1]), o.terminal_cost_gradient(Xi[-1]),
                o.terminal_cost_hessian(Xi[-1]), o.evaluate(Xi, Ui))

    return jax.jit(jax.vmap(one, in_axes=(0 if batched else None, 0, 0)))(jo, X, U)


def _port_all(o, X, U):
    x, steps = X[:, :-1], slice(0, N)
    return (o.running_cost(x, U, steps), *o.running_cost_gradients(x, U, steps),
            *o.running_cost_hessians(x, U, steps), o.terminal_cost(X[:, -1]),
            o.terminal_cost_gradient(X[:, -1]), o.terminal_cost_hessian(X[:, -1]),
            o.evaluate(X, U))


@pytest.mark.parametrize("batched", [False, True])
def test_residual_objective_matches_jax(batched):
    """Values, GN gradients 2 J'r and Hessians 2 J'J plus the extras' AD
    derivatives, over (B, N) steps and at the terminal, with one w for the
    batch or one per instance."""
    X, U, W = _inputs()
    w = W if batched else W[0]
    want = _jax_all(JToy(w=jnp.asarray(w)), jnp.asarray(X), jnp.asarray(U), batched)
    got = _port_all(Toy(batched=batched, w=torch.as_tensor(w)), torch.as_tensor(X),
                    torch.as_tensor(U))
    for i, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-12, atol=1e-12,
                                   err_msg=str(i))


def test_residual_objective_per_step_calls_match_the_stacked_ones():
    """A per-step call on (B, nx) (the drivers' trial loop) gives the stacked
    call's step; no extras: GN alone, the extras' zeros not added."""
    X, U, W = _inputs(5)
    o = ToyNoExtra(w=torch.as_tensor(W[0]))
    jo = JToyNoExtra(w=jnp.asarray(W[0]))
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    stacked = o.running_cost_hessians(Xt[:, :-1], Ut, slice(0, N))
    for t in range(N):
        step = o.running_cost_hessians(Xt[:, t], Ut[:, t], t)
        for a, b in zip(step, stacked):
            torch.testing.assert_close(a, b[:, t], rtol=0, atol=0)
        want = jax.vmap(lambda x, u: jo.running_cost_gradients(x, u, t))(
            jnp.asarray(X[:, t]), jnp.asarray(U[:, t]))
        for a, b in zip(o.running_cost_gradients(Xt[:, t], Ut[:, t], t), want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(o.terminal_cost(Xt[:, -1]).numpy(), 0.0)


def test_nonlinear_objective_matches_jax():
    """User callables with parameters, differentiated by AD in both."""
    X, U, W = _inputs(7)

    def jrun(x, u, k, p):
        return p[0] * jnp.sum(x ** 2) * u[0] + jnp.sin(x[1] * u[1]) + p[1] * x[2] ** 3

    def jterm(x, p):
        return p[1] * jnp.sum(jnp.cos(x)) + x[0] * x[2]

    def run(x, u, k, p):
        return p[0] * (x ** 2).sum() * u[0] + torch.sin(x[1] * u[1]) + p[1] * x[2] ** 3

    def term(x, p):
        return p[1] * torch.cos(x).sum() + x[0] * x[2]

    jo = jobj.NonlinearObjective(running_fn=jrun, terminal_fn=jterm, params=jnp.asarray(W[0]))
    o = tt.NonlinearObjective(running_fn=run, terminal_fn=term, params=torch.as_tensor(W[0]))
    want = _jax_all(jo, jnp.asarray(X), jnp.asarray(U), False)
    got = _port_all(o, torch.as_tensor(X), torch.as_tensor(U))
    for i, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-12, atol=1e-12,
                                   err_msg=str(i))


def test_float32_jacobians_stay_float32():
    """The Gauss-Newton derivatives of a float32 objective are float32
    (forward-mode tangents through a product with a Python float come back
    in float64 from torch.func.jacfwd; ``_jac`` casts them)."""
    X, U, W = _inputs(9)
    o = Toy(w=torch.as_tensor(W[0], dtype=torch.float32))
    Xt, Ut = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(U, dtype=torch.float32)
    for t in (*o.running_cost_gradients(Xt[:, :-1], Ut, slice(0, N)),
              *o.running_cost_hessians(Xt[:, :-1], Ut, slice(0, N)),
              o.terminal_cost_gradient(Xt[:, -1]), o.terminal_cost_hessian(Xt[:, -1])):
        assert t.dtype == torch.float32


def test_residual_objective_solves_like_jax():
    """An IPDDP solve of the unicycle's box problem with a residual cost
    (the flagship's quadratic terms as residuals plus a curved one), the
    plain driver against the JAX driver: statuses, iterations, X, U, cost."""
    from cddp_tpu.models import Unicycle as JUnicycle
    from cddp_tpu_torch.models import Unicycle

    class JRes(jobj.ResidualObjective):
        goal: jax.Array = None

        def running_residuals(self, x, u, k):
            return jnp.concatenate([0.3 * u, jnp.stack([0.2 * jnp.sin(x[2] - self.goal[2])])])

        def terminal_residuals(self, x):
            return 3.0 * (x - self.goal)

    @dataclass(frozen=True)
    class Res(tt.ResidualObjective):
        goal: torch.Tensor = None

        def running_residuals(self, x, u, k):
            return torch.cat([0.3 * u, torch.stack([0.2 * torch.sin(x[2] - self.goal[2])])])

        def terminal_residuals(self, x):
            return 3.0 * (x - self.goal)

    import cddp_tpu as ct
    from cddp_tpu.parallel.batch import batched_solve as jbatched

    goal = np.array([2.0, 2.0, np.pi / 2])
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-0.5, 0.5, size=(3, 3))
    jp = ct.problem(JUnicycle(), JRes(goal=jnp.asarray(goal)), jnp.zeros(3), 20, 0.05)
    jp = jp.add_constraint("ControlConstraint", ct.control_constraint([-2.0, -np.pi],
                                                                      [2.0, np.pi]))
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-4)
    jsol = jbatched(jp, jnp.asarray(x0), "IPDDP", jopts)
    p = tt.problem(Unicycle(), Res(goal=torch.as_tensor(goal)), torch.zeros(3), 20, 0.05,
                   device="cpu")
    p = p.add_constraint("ControlConstraint", tt.control_constraint(
        [-2.0, -np.pi], [2.0, np.pi], device="cpu", dtype=torch.float64))
    sol = tt.batched_solve(p, torch.as_tensor(x0), "IPDDP",
                           tt.CDDPOptions(max_iterations=6, tolerance=1e-4))
    np.testing.assert_array_equal(sol.status_code.numpy(), np.asarray(jsol.status_code))
    np.testing.assert_array_equal(sol.iterations_completed.numpy(),
                                  np.asarray(jsol.iterations_completed))
    for a, b in ((sol.state_trajectory, jsol.state_trajectory),
                 (sol.control_trajectory, jsol.control_trajectory),
                 (sol.final_objective, jsol.final_objective)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)
