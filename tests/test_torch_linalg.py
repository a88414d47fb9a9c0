"""The closed-form small-matrix algebra of ``cddp_tpu_torch/ops/linalg.py``
held bit for bit to its earlier expressions, which index H once per use
(``H[..., i, j]``) where the module now reads each entry once: the same
products in the same order, odd Leibniz terms subtracted where they were
negated and added (a + (-b) rounds as a - b), cofactor signs by negation
where they were products with (-1) ** (i + j) (exact)."""

from itertools import permutations

import numpy as np
import pytest
import torch

from cddp_tpu_torch.ops import linalg

torch.set_num_threads(1)


def det_ref(H):
    n = H.shape[-1]
    if n == 1:
        return H[..., 0, 0]
    if n == 2:
        return H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    if n == 3:
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    m01 = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    m02 = H[..., 0, 0] * H[..., 1, 2] - H[..., 0, 2] * H[..., 1, 0]
    m03 = H[..., 0, 0] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 0]
    m12 = H[..., 0, 1] * H[..., 1, 2] - H[..., 0, 2] * H[..., 1, 1]
    m13 = H[..., 0, 1] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 1]
    m23 = H[..., 0, 2] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 2]
    n01 = H[..., 2, 0] * H[..., 3, 1] - H[..., 2, 1] * H[..., 3, 0]
    n02 = H[..., 2, 0] * H[..., 3, 2] - H[..., 2, 2] * H[..., 3, 0]
    n03 = H[..., 2, 0] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 0]
    n12 = H[..., 2, 1] * H[..., 3, 2] - H[..., 2, 2] * H[..., 3, 1]
    n13 = H[..., 2, 1] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 1]
    n23 = H[..., 2, 2] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 2]
    return m01 * n23 - m02 * n13 + m03 * n12 + m12 * n03 - m13 * n02 + m23 * n01


def det_idx_ref(H, rows, cols):
    n = len(rows)
    total = None
    for perm in permutations(range(n)):
        inv = sum(1 for a in range(n) for b in range(a + 1, n) if perm[a] > perm[b])
        term = H[..., rows[0], cols[perm[0]]]
        for a in range(1, n):
            term = term * H[..., rows[a], cols[perm[a]]]
        term = -term if inv % 2 else term
        total = term if total is None else total + term
    return total


def inv_ref(H):
    n = H.shape[-1]
    det = det_ref(H)
    if n == 1:
        return 1.0 / H
    idx = list(range(n))
    adj_rows = []
    for j in range(n):
        row = []
        for i in range(n):
            rs = tuple(r for r in idx if r != i)
            cs = tuple(c for c in idx if c != j)
            row.append((-1.0) ** (i + j) * det_idx_ref(H, rs, cs))
        adj_rows.append(torch.stack(row, dim=-1))
    return torch.stack(adj_rows, dim=-2) / det[..., None, None]


def is_pd_ref(H):
    n = H.shape[-1]
    ok = H[..., 0, 0] > 0
    for k in range(2, n + 1):
        idx = tuple(range(k))
        ok = ok & (det_idx_ref(H, idx, idx) > 0)
    return ok & torch.isfinite(H).all(dim=-1).all(dim=-1)


def matrices(n, dtype, seed):
    """General, symmetric positive definite, indefinite and ill-scaled
    (n, n) matrices, one batch, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((256, n, n))
    L = rng.standard_normal((256, n, n))
    spd = L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(n)
    sym = G + G.transpose(0, 2, 1)
    scaled = G * 10.0 ** rng.uniform(-8, 8, (256, 1, 1))
    return torch.as_tensor(np.concatenate([G, spd, sym, scaled]), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_small_algebra_keeps_its_bits(n, dtype):
    H = matrices(n, dtype, seed=10 * n + (dtype == torch.float32))
    assert torch.equal(linalg.det_small(H), det_ref(H))
    assert torch.equal(linalg.inv_small(H), inv_ref(H))
    assert torch.equal(linalg.is_pd(H), is_pd_ref(H))
    for k in range(1, n + 1):
        rows = tuple(range(n - k, n))
        cols = tuple(range(k))
        assert torch.equal(linalg._det_idx(H, rows, cols), det_idx_ref(H, rows, cols))
