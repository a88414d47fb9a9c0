"""The port's plain line-search rollout (the CUDA kernel's plain version)
against the JAX fused forward kernel in interpret mode and its scan
reference (CPU, float64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.ops.pallas import rollout as jroll
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.ops.kernels.rollout import (
    forward_rollout,
    forward_rollout_plain,
    lane_consts,
    model_entry,
)
from cddp_tpu_torch.models import Unicycle
from test_torch_foundation import flagship_jax, port_problem

torch.set_num_threads(1)

B, N = 4, 10
TOL = dict(rtol=1e-9, atol=1e-9)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    Xb = rng.uniform(-0.5, 2.0, size=(B, N + 1, 3))
    Ub = rng.uniform(-1.5, 1.5, size=(B, N, 2))
    k = 0.5 * rng.normal(size=(B, N, 2))
    K = 0.5 * rng.normal(size=(B, N, 2, 3))
    alpha = np.asarray([1.0, 0.5, 0.25, 0.125])
    return Xb, Ub, k, K, alpha


def _port(jp, Xb, Ub, k, K, alpha):
    consts = lane_consts(port_problem(jp))
    t = [torch.as_tensor(a) for a in (Xb, Ub, k, K, alpha)]
    return consts, t[0][:, :-1], t[1], t[2], t[3], t[0][:, 0], t[4]


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_plain_rollout_matches_jax_kernel(integrator):
    jp = flagship_jax(horizon=N, integrator=integrator)
    cc = jp.get_constraint("ControlConstraint")
    Xb, Ub, k, K, alpha = _inputs(seed=len(integrator))
    Xw, Uw, Jw = jroll.forward_rollout_fused(
        jp, cc, *(jnp.asarray(a) for a in (Xb, Ub, k, K, alpha)), interpret=True)
    Xt, Ut, Jt = forward_rollout_plain(*_port(jp, Xb, Ub, k, K, alpha))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw)[:, 1:], **TOL)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), **TOL)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), **TOL)
    # Some controls hit the box, so the clamp is exercised.
    assert np.any(np.abs(Ut.numpy()) >= np.asarray(cc.upper) - 1e-12)


@pytest.mark.parametrize("integrator", ["heun", "rk3"])
@pytest.mark.parametrize("clamp", [True, False])
def test_plain_rollout_matches_jax_scan(integrator, clamp):
    jp = flagship_jax(horizon=N, integrator=integrator)
    if not clamp:
        jp = jp.replace(constraints={})
    Xb, Ub, k, K, alpha = _inputs(seed=7)
    cc = jp.get_constraint("ControlConstraint")
    lb = np.asarray(cc.lower) if clamp else np.zeros(2)
    ub = np.asarray(cc.upper) if clamp else np.zeros(2)
    o = jp.objective
    single = functools.partial(jroll._scan_forward_single, "Unicycle", integrator,
                               clamp, False)
    Xw, Uw, Jw = jax.vmap(single, in_axes=(0, 0, 0, 0, 0) + (None,) * 8)(
        *(jnp.asarray(a) for a in (Xb[:, :-1], Ub, k, K, alpha)),
        jnp.asarray(0.05), jnp.zeros(1), o.Q, o.R, o.Qf, o.reference_state,
        jnp.asarray(lb), jnp.asarray(ub))
    Xt, Ut, Jt = forward_rollout_plain(*_port(jp, Xb, Ub, k, K, alpha))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xw), **TOL)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uw), **TOL)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), **TOL)


def test_registry_and_cpu_dispatch():
    class MyUnicycle(Unicycle):
        pass

    assert model_entry(Unicycle()).cuda_name == "unicycle"
    assert model_entry(MyUnicycle()) is None  # subclasses keep the plain path
    jp = flagship_jax(horizon=N)
    assert lane_consts(port_problem(jp).replace(model=MyUnicycle())) is None
    args = _port(jp, *_inputs(seed=1))
    dispatch_log.reset()
    got = forward_rollout(*args)
    assert not dispatch_log.launches
    for g, w in zip(got, forward_rollout_plain(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        forward_rollout(args[0], *(a.to("meta") for a in args[1:]))
