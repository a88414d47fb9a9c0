"""The condensed IPDDP backward's plain version (the CUDA kernel's
reference, ``ops/kernels/ipddp_riccati.py``) against the JAX package's
``jax.vmap(_condensed_scan_single)`` on random stage data (CPU, float64,
rtol 1e-9 and atol 1e-11: the tolerance of tests/test_ipddp_pallas.py), and
the kernel wrapper's dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.ops.kernels import dispatch_log, ipddp_riccati
from test_ipddp_pallas import _random_stage_data

torch.set_num_threads(1)

NAMES = ("k_u", "K_u", "k_y", "K_y", "k_s", "K_s", "Vx", "Vxx", "stats")
# One batch and horizon for every case, so the JAX scan compiles once per m.
B, N = 6, 8
_jax_scan = jax.jit(jax.vmap(_condensed_scan_single))


def _data(seed, m):
    return list(_random_stage_data(jax.random.PRNGKey(seed), B=B, N=N, nx=3, nu=2,
                                   m=m, dtype=jnp.float64))


def _both(args):
    want = _jax_scan(*args)
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*targs)
    assert not dispatch_log.launches  # CPU tensors: the plain version
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=name)
    return got


@pytest.mark.parametrize("m", [4, 10], ids=["box_fleet_m4", "two_boxes_m10"])
def test_backward_matches_jax_scan(m):
    stats = _both(_data(0, m))[-1]
    assert bool((stats[:, 6] == 1.0).all())


def test_indefinite_batch_mixes_ok_and_failed():
    # A negative regularization on half of the batch makes the condensed
    # Quu indefinite there: those instances fail the leading-minors check,
    # with zero control gains at the failing steps, as in the JAX scan.
    args = _data(1, 4)
    args[-1] = jnp.asarray([1e-6, -50.0] * (B // 2))
    stats = _both(args)[-1]
    ok = stats[:, 6].numpy()
    assert ok.min() == 0.0 and ok.max() == 1.0


def test_barrier_ratio_cap_is_1e12_in_float64():
    # Tiny slacks push y / s_safe past 1e6: the float64 cap is 1e12, as in
    # the JAX scan (ipddp.py:64-73), and 1e6 in float32.
    args = _data(2, 4)
    args[8] = jnp.full_like(args[8], 1e-9)  # S
    args[14] = jnp.full_like(args[14], 1e-9)  # mu
    _both(args)
    assert ipddp_riccati.max_ratio(torch.float64) == 1e12
    assert ipddp_riccati.max_ratio(torch.float32) == 1e6
