"""Closed-form small-matrix algebra for n <= 4 (port of ``cddp_tpu/ops/linalg.py``).

Batched over leading axes: every function takes (..., n, n). Determinants,
adjugate inverses and Sylvester positive-definiteness checks are unrolled
over static indices, in the same operation order as the JAX package, so
the two agree to rounding. CLDDP never solves anything larger than Quu
(nu <= 4); larger n raises.
"""

from __future__ import annotations

from itertools import permutations

import torch

_SMALL_N = 4


def true_div(t: torch.Tensor, s: float) -> torch.Tensor:
    """t / s, rounded as one division. On CUDA, torch computes a tensor
    divided by a Python scalar as a product with the scalar's reciprocal,
    which can land one bit away from the division the kernels and the JAX
    package do; a divisor on t's device keeps the true division."""
    return t / t.new_tensor(s)


def _check_small(n: int) -> None:
    if n > _SMALL_N:
        raise ValueError(f"closed-form small-matrix algebra supports n<={_SMALL_N}, got {n}")


def _entries(H: torch.Tensor):
    """H's entries as a nested list of (...,) views, E[i][j] = H[..., i, j],
    taken once (a row at a time) so that the unrolled expansions below read
    them without an indexing op per use."""
    return [row.unbind(-1) for row in H.unbind(-2)]


def det_small(H: torch.Tensor) -> torch.Tensor:
    """Determinant of a trailing (n, n), n <= 4, in closed form."""
    n = H.shape[-1]
    _check_small(n)
    return _det_entries(_entries(H), n)


def _det_entries(E, n: int) -> torch.Tensor:
    """``det_small`` on H's entries."""
    if n == 1:
        return E[0][0]
    if n == 2:
        return E[0][0] * E[1][1] - E[0][1] * E[1][0]
    if n == 3:
        a, b, c = E[0]
        d, e, f = E[1]
        g, h, i = E[2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    m01 = E[0][0] * E[1][1] - E[0][1] * E[1][0]
    m02 = E[0][0] * E[1][2] - E[0][2] * E[1][0]
    m03 = E[0][0] * E[1][3] - E[0][3] * E[1][0]
    m12 = E[0][1] * E[1][2] - E[0][2] * E[1][1]
    m13 = E[0][1] * E[1][3] - E[0][3] * E[1][1]
    m23 = E[0][2] * E[1][3] - E[0][3] * E[1][2]
    n01 = E[2][0] * E[3][1] - E[2][1] * E[3][0]
    n02 = E[2][0] * E[3][2] - E[2][2] * E[3][0]
    n03 = E[2][0] * E[3][3] - E[2][3] * E[3][0]
    n12 = E[2][1] * E[3][2] - E[2][2] * E[3][1]
    n13 = E[2][1] * E[3][3] - E[2][3] * E[3][1]
    n23 = E[2][2] * E[3][3] - E[2][3] * E[3][2]
    return m01 * n23 - m02 * n13 + m03 * n12 + m12 * n03 - m13 * n02 + m23 * n01


def _det_idx(H, rows, cols):
    """Determinant of H[rows, cols] by the unrolled Leibniz expansion."""
    return _leibniz(_entries(H), rows, cols)


def _leibniz(E, rows, cols):
    """``_det_idx`` on H's entries E: each term the product of its entries
    in row order, the terms summed in permutation order, the odd ones
    subtracted (adding the negated term rounds the same)."""
    n = len(rows)
    total = None
    for perm in permutations(range(n)):
        inv = sum(1 for a in range(n) for b in range(a + 1, n)
                  if perm[a] > perm[b])
        term = E[rows[0]][cols[perm[0]]]
        for a in range(1, n):
            term = term * E[rows[a]][cols[perm[a]]]
        if total is None:
            total = term  # the identity permutation, even
        else:
            total = total - term if inv % 2 else total + term
    return total


def inv_small(H: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of a trailing (n, n), n <= 4."""
    n = H.shape[-1]
    if n == 1:
        return 1.0 / H
    E = _entries(H)
    det = _det_entries(E, n)
    idx = list(range(n))
    adj_rows = []
    for j in range(n):
        row = []
        for i in range(n):
            rs = tuple(r for r in idx if r != i)
            cs = tuple(c for c in idx if c != j)
            minor = _leibniz(E, rs, cs)
            row.append(-minor if (i + j) % 2 else minor)
        adj_rows.append(torch.stack(row, dim=-1))
    adj = torch.stack(adj_rows, dim=-2)  # adj[j, i] = cofactor(i, j)
    return adj / det[..., None, None]


def psd_solve(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve H X = B for symmetric PD H; ``B`` is (..., n) or (..., n, m)."""
    n = H.shape[-1]
    _check_small(n)
    if n == 0:
        return B
    vec = B.dim() == H.dim() - 1
    X = inv_small(H) @ (B[..., None] if vec else B)
    return X[..., 0] if vec else X


def is_pd(H: torch.Tensor) -> torch.Tensor:
    """Sylvester's criterion: every leading principal minor > 0, and H finite."""
    n = H.shape[-1]
    _check_small(n)
    E = _entries(H)
    ok = E[0][0] > 0
    for k in range(2, n + 1):
        idx = tuple(range(k))
        ok = ok & (_leibniz(E, idx, idx) > 0)
    return ok & torch.isfinite(H).all(dim=-1).all(dim=-1)


def solve_and_check(H: torch.Tensor, B: torch.Tensor):
    """(solution, pd_flag): the solution is zeroed where H is not PD."""
    ok = is_pd(H)
    X = psd_solve(H, B)
    mask = ok[..., None] if B.dim() == H.dim() - 1 else ok[..., None, None]
    return torch.where(mask, X, torch.zeros((), dtype=X.dtype, device=X.device)), ok
