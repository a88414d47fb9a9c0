"""The port's plain Riccati backward pass (the CUDA kernel's plain version)
against the JAX streamed backward kernel in interpret mode and its scan
reference (CPU, float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.ops.pallas.riccati import _scan_backward_single, clddp_backward_fused
from cddp_tpu.solvers import base as jbase
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.ops.kernels.riccati import riccati_backward, riccati_backward_plain
from test_torch_foundation import flagship_jax

torch.set_num_threads(1)

B, N = 4, 8


def _inputs(seed, reg_scale):
    """Stage data linearized about random trajectories of the flagship
    problem, batch-first, as numpy arrays."""
    prob = flagship_jax(horizon=N)
    cc = prob.get_constraint("ControlConstraint")
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.uniform(-1.0, 2.0, size=(B, N + 1, 3)))
    U = jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, N, 2)))

    def one(Xi, Ui):
        A, Bm = jbase.discrete_jacobians(prob, Xi, Ui)
        lx, lu, lxx, luu, lux = jbase.running_cost_derivatives(prob, Xi, Ui)
        return (A, Bm, lx, lu, lxx, luu, lux, cc.lower - Ui, cc.upper - Ui,
                prob.objective.terminal_cost_gradient(Xi[-1]),
                prob.objective.terminal_cost_hessian(Xi[-1]))

    args = [np.asarray(a) for a in jax.vmap(one)(X, U)]
    reg = reg_scale * rng.uniform(0.5, 2.0, size=B)
    return args + [reg]


@pytest.mark.parametrize("reg_scale", [1e-6, 1e-2, -3.0], ids=["reg1e-6", "reg1e-2", "indefinite"])
def test_plain_backward_matches_jax_kernel_and_scan(reg_scale):
    args = _inputs(seed=int(abs(reg_scale) * 1e6) % 97, reg_scale=reg_scale)
    got = riccati_backward_plain(*(torch.as_tensor(a) for a in args))
    kern = clddp_backward_fused(*(jnp.asarray(a) for a in args), interpret=True)
    scan = jax.vmap(_scan_backward_single)(*(jnp.asarray(a) for a in args))
    for want in (kern, scan):
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 5:  # ok flags
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                           atol=1e-9, err_msg=f"output {i}")
    if reg_scale < 0:
        assert not got[5].any()  # the indefinite case reaches the failure path
    else:
        assert got[5].all()


def test_wrapper_runs_plain_on_cpu_and_never_falls_back():
    args = [torch.as_tensor(a) for a in _inputs(seed=3, reg_scale=1e-6)]
    dispatch_log.reset()
    got = riccati_backward(*args)
    assert not dispatch_log.launches  # plain version, no kernel
    for g, w in zip(got, riccati_backward_plain(*args)):
        assert torch.equal(g, w)
    # Any other device must launch the kernel or raise: never the plain path.
    with pytest.raises(ValueError, match="CUDA"):
        riccati_backward(*(a.to("meta") for a in args))
