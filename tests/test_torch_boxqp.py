"""cddp_tpu_torch's closed-form small-matrix algebra and enumerated BoxQP
against the JAX package (CPU, float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.ops import boxqp as jbox
from cddp_tpu.ops import linalg as jlin
from cddp_tpu_torch.ops import boxqp, linalg

torch.set_num_threads(1)

B = 12


def _case(nu, kind, seed):
    """A batch of box QPs: strictly convex ("pd"), indefinite, or convex with
    a gradient that pushes every coordinate onto a bound ("clamped")."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, nu, nu))
    H = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(nu)
    g = rng.normal(size=(B, nu))
    if kind == "indefinite":
        H = H - (np.linalg.eigvalsh(H)[:, -1] + 1.0)[:, None, None] * np.eye(nu)
    if kind == "clamped":
        g = 100.0 * np.sign(g)
    lower = -rng.uniform(0.2, 1.5, size=(B, nu))
    upper = rng.uniform(0.2, 1.5, size=(B, nu))
    return H, g, lower, upper


@pytest.mark.parametrize("kind", ["pd", "indefinite", "clamped"])
@pytest.mark.parametrize("nu", [1, 2, 3, 4])
def test_boxqp_enum_and_masked_solve_match_jax(nu, kind):
    H, g, lower, upper = _case(nu, kind, seed=10 * nu + len(kind))
    want = jax.vmap(jbox.boxqp_solve_enum)(*map(jnp.asarray, (H, g, lower, upper)))
    got = boxqp.boxqp_solve_enum(*map(torch.as_tensor, (H, g, lower, upper)))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(want.free))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.Hfree.numpy(), np.asarray(want.Hfree),
                               rtol=1e-10, atol=1e-10)
    if kind == "indefinite":
        assert np.all(got.status.numpy() == boxqp.BoxQPStatus.HESSIAN_NOT_PD)
    if kind == "clamped":
        assert np.all(got.status.numpy() == boxqp.BoxQPStatus.ALL_CLAMPED)

    rhs = np.random.default_rng(nu).normal(size=(B, nu, 3))
    want_K = jax.vmap(jbox.solve_masked_free)(want.Hfree, jnp.asarray(rhs), want.free)
    got_K = boxqp.solve_masked_free(got.Hfree, torch.as_tensor(rhs), got.free)
    np.testing.assert_allclose(got_K.numpy(), np.asarray(want_K), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_small_linalg_matches_jax(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(B, n, n))
    H = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n)
    H[::3] -= 2.0 * np.eye(n)  # some indefinite
    rhs = rng.normal(size=(B, n))
    Ht, Hj = torch.as_tensor(H), jnp.asarray(H)
    np.testing.assert_allclose(linalg.det_small(Ht).numpy(),
                               np.asarray(jlin.det_small(Hj)), rtol=1e-12)
    np.testing.assert_allclose(linalg.inv_small(Ht).numpy(),
                               np.asarray(jlin.inv_small(Hj)), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(linalg.is_pd(Ht).numpy(), np.asarray(jlin.is_pd(Hj)))
    X, ok = linalg.solve_and_check(Ht, torch.as_tensor(rhs))
    jX, jok = jlin.solve_and_check(Hj, jnp.asarray(rhs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        linalg.psd_solve(torch.eye(5, dtype=torch.float64), torch.ones(5, dtype=torch.float64))
