"""The open-loop rollout and the interior-point forward trial: their plain
versions (the CUDA kernels' references, ``ops/kernels/ip_rollout.py``)
against the JAX package on CPU in float64 — the open-loop rollout against
``cddp_tpu.models.base.rollout`` (rtol = atol = 1e-12, all four
integrators), the forward trial against ``jax.vmap`` of
``ip_rollout._scan_ip_forward_single`` (rtol = atol = 1e-10, flags equal)
and, on a tiny batch, against the Pallas forward kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.models import Unicycle as JUnicycle
from cddp_tpu.models.base import rollout as jrollout
from cddp_tpu.ops.pallas import ip_rollout as jip
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.models import DynamicalSystem, Unicycle, rollout
from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout
from cddp_tpu_torch.options import CDDPOptions, IPDDPOptions
from test_mega_ipddp import _unicycle_box
from test_torch_ipddp import port_ip_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("integrator", ["euler", "heun", "rk3", "rk4"])
def test_open_loop_rollout_matches_jax(integrator):
    rng = np.random.default_rng(0)
    x0, U = rng.normal(size=(5, 3)), rng.normal(size=(5, 12, 2)) * 2.0
    jm = JUnicycle(integration_type=integrator)
    want = np.stack([np.asarray(jrollout(jm, jnp.asarray(a), jnp.asarray(u), 0.05))
                     for a, u in zip(x0, U)])
    dispatch_log.reset()
    got = rollout(Unicycle(integration_type=integrator), torch.as_tensor(x0),
                  torch.as_tensor(U), 0.05)
    assert not dispatch_log.launches  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_unregistered_model_steps_its_own_dynamics():
    class Slow(Unicycle):  # a subclass keeps the plain path: its dynamics win
        def forward(self, x, u, t):
            return 0.5 * super().forward(x, u, t)

    x0, U = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 4, 2, dtype=torch.float64)
    X = rollout(Slow(), x0, U, 0.1)
    want = x0.clone()
    for t in range(4):
        want = DynamicalSystem.discrete_dynamics(Slow(), want, U[:, t], t * 0.1, 0.1)
    np.testing.assert_array_equal(X[:, -1].numpy(), want.numpy())


def _forward_inputs(B, N, m, seed, ftb_break=False):
    """Random nominal trajectories, duals, slacks and gains of a box
    problem's forward trial, batch-first numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=0.05: rng.normal(size=(B,) + s) * scale  # noqa: E731
    nx, nu = 3, 2
    Xb = n(N, nx, scale=0.3)
    Ub = n(N, nu, scale=0.5)
    Y = np.abs(n(N, m)) + 0.1
    S = np.abs(n(N, m)) + 0.1
    ks = n(N, m)
    if ftb_break:
        # A large negative slack step on every other instance: its trial
        # crosses the fraction-to-boundary bound.
        ks[::2] -= 5.0
    args = dict(Xb=Xb, Ub=Ub, Y=Y, S=S, ku=n(N, nu), Ku=n(N, nu, nx),
                klam=n(N, nx), Klam=n(N, nx, nx), lam=n(N, nx), ky=n(N, m),
                Ky=n(N, m, nx), ks=ks, Ks=n(N, m, nx), x0=n(nx, scale=0.3),
                a_pr=rng.uniform(0.2, 1.0, B), a_du=rng.uniform(0.2, 1.0, B),
                tau=np.full(B, 0.99), soc=np.ones(B))
    return args


@pytest.mark.parametrize("state_box,slack_soc,ftb_break", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (False, False, True),
], ids=["control_box", "control_box_soc", "two_boxes", "two_boxes_soc", "ftb_fails"])
def test_forward_trial_matches_jax_scan(state_box, slack_soc, ftb_break):
    jp = _unicycle_box(horizon=8, state_box=state_box)
    p = port_ip_problem(jp)
    stk = PathStacker(p)
    m = stk.total_dim
    fc = ip_rollout.resolve_ip_forward(
        p, CDDPOptions(ipddp=IPDDPOptions(slack_soc=slack_soc)), stk)
    assert fc is not None and fc.slack_soc == slack_soc and fc.rows.m == m
    a = _forward_inputs(6, 8, m, seed=1, ftb_break=ftb_break)

    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    _, cparams, _, cost_f = jip.cost_lane(jp.objective)
    boxes = [c for _, c in sorted(jp.constraints.items())]
    layout = tuple("control" if type(c).__name__ == "ControlConstraint" else "state"
                   for c in boxes)
    B = a["Xb"].shape[0]
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (B,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(a[k]) for k in ("Xb", "Ub", "Y", "S", "ku", "Ku", "klam", "Klam",
                                         "lam", "ky", "Ky", "ks", "Ks", "x0", "a_pr",
                                         "a_du", "tau", "soc")]
    jargs += [bc(0.05), bc(jnp.zeros(1)), bc(cparams), jnp.zeros((B, 8, 1)),
              bc(jnp.concatenate([c.lower for c in boxes])),
              bc(jnp.concatenate([c.upper for c in boxes])),
              bc(jnp.asarray([c.scale_factor for c in boxes], jnp.float64))]
    want = jax.jit(jax.vmap(lambda *v: jip._scan_ip_forward_single(
        3, 2, m, model_f, model_discrete, "euler", cost_f, slack_soc, layout, *v)))(*jargs)

    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    dispatch_log.reset()
    got = ip_rollout.ip_forward(fc, *t.values())
    assert not dispatch_log.launches
    x_last, J, F = want[:3]
    for name, g, w in zip(("X", "U", "S", "Y", "G", "Lam"), got[:6], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    np.testing.assert_allclose(got[0][:, -1].numpy(), np.asarray(x_last), **TOL)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(J), **TOL)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(F))
    assert 0 < int(got[7].sum()) <= B
    if ftb_break:
        assert not bool(got[7][::2].any())


def test_forward_trial_matches_pallas_interpret():
    # The Pallas forward kernel itself, in interpret mode, on a tiny batch.
    jp = _unicycle_box(horizon=5)
    p = port_ip_problem(jp)
    stk = PathStacker(p)
    fc = ip_rollout.resolve_ip_forward(p, CDDPOptions(), stk)
    a = _forward_inputs(2, 5, 4, seed=3)
    _, _, model_f, model_discrete = jip.model_lane(jp.model)
    c_entry = jip.cost_lane(jp.objective)
    cc = jp.get_constraint("ControlConstraint")
    model_key, cost_key = type(jp.model), (type(jp.objective),) + c_entry[0]
    jip._LANES_BY_KEY[(model_key, cost_key)] = dict(
        model_f=model_f, model_discrete=model_discrete, integrator="euler",
        cost_f=c_entry[3])
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v), (2,) + jnp.shape(v))  # noqa: E731
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs += [bc(0.05), bc(jnp.zeros(1)), bc(c_entry[1]), jnp.zeros((2, 5, 1)),
              bc(cc.lower), bc(cc.upper), bc(jnp.ones(1))]
    out = jax.jit(lambda *v: jip._ip_forward_fused_impl(
        *v, model_key=model_key, cost_key=cost_key, slack_soc=False,
        box_layout=("control",), interpret=True))(*jargs)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["soc"] = t["soc"] > 0.5
    got = ip_rollout.ip_forward_plain(fc, *t.values())
    for g, w in zip(got[:6], out[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(out[1]), **TOL)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(out[2]))
