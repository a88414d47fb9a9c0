"""cddp_tpu_torch's closed-form small-matrix algebra and enumerated BoxQP
against the JAX package (CPU, float64)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.ops import boxqp as jbox
from cddp_tpu.ops import linalg as jlin
from cddp_tpu.ops.pallas.riccati import _scan_backward_single, clddp_backward_fused
from cddp_tpu_torch.ops import boxqp, linalg
from cddp_tpu_torch.ops.kernels.riccati import riccati_backward_plain

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


# --- several valid active sets: the first in itertools.product order wins ------


def _tie_cases(nu):
    """Box QPs on which two or more of the 3^nu configurations satisfy the
    KKT test, built from powers of two so that every implementation solves
    them exactly and the ties are exact: the unconstrained minimizer on a
    bound (configuration 0 valid, and the one clamping that coordinate);
    one coordinate clamped at its upper bound with another's minimizer on
    its lower bound (configuration 0 invalid, the first valid one clamps
    the first coordinate at its upper bound); a negative-definite Hessian
    whose box corners are all stationary (configuration 0 invalid, the
    first valid one all at lower bounds); and an indefinite coupled one."""
    h = 2.0 ** np.arange(1, nu + 1)
    H, g, lo, hi = [], [], [], []

    def add(Hc, gc, loc, hic):
        H.append(Hc)
        g.append(gc)
        lo.append(loc)
        hi.append(hic)

    lower, upper = -0.5 * np.ones(nu), 0.5 * np.ones(nu)
    for i in range(nu):  # minimizer -g/h on lower[i], inside elsewhere
        x = np.full(nu, 0.25)
        x[i] = lower[i]
        add(np.diag(h), -h * x, lower, upper)
    x = np.full(nu, 0.25)
    x[-1] = upper[-1]
    add(np.diag(h), -h * x, lower, upper)  # minimizer on the last upper bound
    # x[0] pushed past its upper bound; x[1] lands exactly on its lower one.
    x = np.full(nu, 0.25)
    x[0], x[1] = 1.0, lower[1]
    add(np.diag(h), -h * x, lower, upper)
    add(-np.diag(h), np.zeros(nu), -np.ones(nu), np.ones(nu))
    Hc = -2.0 * np.eye(nu)
    Hc[0, 1] = Hc[1, 0] = 1.0
    add(Hc, np.zeros(nu), -np.ones(nu), np.ones(nu))
    return tuple(np.stack(a) for a in (H, g, lo, hi))


def _valid_configs(H, g, lo, hi):
    """Indices (itertools.product order) of the configurations that pass
    the enumerated BoxQP's test on one QP, computed here in numpy."""
    nu = H.shape[0]
    out = []
    for c, cfg in enumerate(itertools.product(range(3), repeat=nu)):
        cfg = np.array(cfg)
        free = cfg == 0
        x = np.where(cfg == 1, lo, np.where(cfg == 2, hi, 0.0))
        if free.any():
            Hff = H[np.ix_(free, free)]
            if not all(np.linalg.det(Hff[:k, :k]) > 0 for k in range(1, free.sum() + 1)):
                continue
            x[free] = np.linalg.solve(Hff, -(g[free] + H[np.ix_(free, ~free)] @ x[~free]))
        grad = g + H @ x
        if (np.all((x >= lo) | ~free) & np.all((x <= hi) | ~free)
                & np.all((grad >= 0) | (cfg != 1)) & np.all((grad <= 0) | (cfg != 2))):
            out.append(c)
    return out


def _picked(x, free, lo, hi):
    """Configuration index a solution took: free, at its lower or its upper
    bound per coordinate."""
    digits = np.where(free, 0, np.where(x == lo, 1, np.where(x == hi, 2, -1)))
    assert (digits >= 0).all()
    nu = x.shape[-1]
    return digits @ (3 ** np.arange(nu - 1, -1, -1))


@pytest.mark.parametrize("nu", [2, 3])
def test_boxqp_first_valid_active_set_matches_jax(nu):
    """Where several active sets are valid, the port's enumerated BoxQP takes
    the first in product order, as the JAX package does (riccati.py:175-176
    of the TPU kernel, and the CUDA kernels' clddp_step.cuh::boxqp_enum)."""
    H, g, lo, hi = _tie_cases(nu)
    valid = [_valid_configs(*a) for a in zip(H, g, lo, hi)]
    assert all(len(v) >= 2 for v in valid)
    first = np.array([v[0] for v in valid])
    assert (first != 0).sum() >= 3  # the clamped tie and the two indefinite cases
    want = jax.vmap(jbox.boxqp_solve_enum)(*map(jnp.asarray, (H, g, lo, hi)))
    got = boxqp.boxqp_solve_enum(*map(torch.as_tensor, (H, g, lo, hi)))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(want.free))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.Hfree.numpy(), np.asarray(want.Hfree), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_picked(got.x.numpy(), got.free.numpy(), lo, hi), first)
    np.testing.assert_array_equal(_picked(np.asarray(want.x), np.asarray(want.free), lo, hi),
                                  first)


def test_riccati_first_valid_active_set_matches_jax():
    """The same ties as one Riccati step (nx=3, nu=2, Vx = Vxx = 0, so Qu =
    lu and Quu = luu): the port's plain backward takes the same
    configuration, k and free-block inverse (K = -Hfree^-1 Qux with Qux =
    [I | 0], so K's first two columns are minus the inverse) as the JAX
    kernel in interpret mode and its scan reference."""
    H, g, lo, hi = _tie_cases(2)
    B, nx, nu = H.shape[0], 3, 2
    rng = np.random.default_rng(5)
    lux = np.broadcast_to(np.eye(nu, nx), (B, 1, nu, nx))
    args = [np.broadcast_to(np.eye(nx), (B, 1, nx, nx)), rng.normal(size=(B, 1, nx, nu)),
            rng.normal(size=(B, 1, nx)), g[:, None], np.broadcast_to(np.eye(nx), (B, 1, nx, nx)),
            H[:, None], lux, lo[:, None], hi[:, None], np.zeros((B, nx)),
            np.zeros((B, nx, nx)), np.zeros(B)]
    args = [np.ascontiguousarray(a) for a in args]
    got = riccati_backward_plain(*(torch.as_tensor(a) for a in args))
    kern = clddp_backward_fused(*(jnp.asarray(a) for a in args), interpret=True)
    scan = jax.vmap(_scan_backward_single)(*(jnp.asarray(a) for a in args))
    first = np.array([_valid_configs(*a)[0] for a in zip(H, g, lo, hi)])
    k, K = got[0].numpy()[:, 0], got[1].numpy()[:, 0]
    np.testing.assert_array_equal(_picked(k, K[:, :, :nu].any(-1), lo, hi), first)
    for want in (kern, scan):
        for i, (a, w) in enumerate(zip(got, want)):
            if i == 5:  # ok flags
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-12,
                                           err_msg=f"output {i}")
    free_inv = np.zeros((B, nu, nu))
    for b in range(B):
        f = K[b, :, :nu].any(-1)
        free_inv[b][np.ix_(f, f)] = np.linalg.inv(H[b][np.ix_(f, f)])
    np.testing.assert_allclose(-K[:, :, :nu], free_inv, rtol=0, atol=1e-12)
