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


def det_small(H: torch.Tensor) -> torch.Tensor:
    """Determinant of a trailing (n, n), n <= 4, in closed form."""
    n = H.shape[-1]
    _check_small(n)
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


def _det_idx(H, rows, cols):
    """Determinant of H[rows, cols] by the unrolled Leibniz expansion."""
    n = len(rows)
    if n == 0:
        return H.new_ones(H.shape[:-2])
    total = None
    for perm in permutations(range(n)):
        inv = sum(1 for a in range(n) for b in range(a + 1, n)
                  if perm[a] > perm[b])
        term = H[..., rows[0], cols[perm[0]]]
        for a in range(1, n):
            term = term * H[..., rows[a], cols[perm[a]]]
        term = -term if inv % 2 else term
        total = term if total is None else total + term
    return total


def inv_small(H: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of a trailing (n, n), n <= 4."""
    n = H.shape[-1]
    det = det_small(H)
    if n == 1:
        return 1.0 / H
    idx = list(range(n))
    adj_rows = []
    for j in range(n):
        row = []
        for i in range(n):
            rs = tuple(r for r in idx if r != i)
            cs = tuple(c for c in idx if c != j)
            row.append((-1.0) ** (i + j) * _det_idx(H, rs, cs))
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
    ok = H[..., 0, 0] > 0
    for k in range(2, n + 1):
        idx = tuple(range(k))
        ok = ok & (_det_idx(H, idx, idx) > 0)
    return ok & torch.isfinite(H).all(dim=-1).all(dim=-1)


def solve_and_check(H: torch.Tensor, B: torch.Tensor):
    """(solution, pd_flag): the solution is zeroed where H is not PD."""
    ok = is_pd(H)
    X = psd_solve(H, B)
    mask = ok[..., None] if B.dim() == H.dim() - 1 else ok[..., None, None]
    return torch.where(mask, X, torch.zeros((), dtype=X.dtype, device=X.device)), ok
