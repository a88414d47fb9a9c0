"""Box-constrained QP by exact active-set enumeration
(port of ``cddp_tpu/ops/boxqp.py:32-176``).

min 0.5 x'Hx + g'x  s.t.  lower <= x <= upper, batch-first over leading
axes. For a strictly convex QP in n variables exactly one of the 3^n
free / at-lower / at-upper configurations satisfies the KKT conditions;
all are solved at once with the identity-padded free block and the first
valid one is selected. The projected-Newton ``boxqp`` of the JAX package
is not ported.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from cddp_tpu_torch.ops.linalg import is_pd, psd_solve


class BoxQPStatus:
    """Mirror of the reference enum (boxqp.hpp:46-54)."""

    HESSIAN_NOT_PD = -1
    NO_DESCENT = 0
    MAX_ITER_EXCEEDED = 1
    MAX_LS_EXCEEDED = 2
    NO_BOUNDS = 3
    SUCCESS = 4
    ALL_CLAMPED = 5


class BoxQPResult(NamedTuple):
    x: torch.Tensor  # (..., n) solution
    status: torch.Tensor  # (...,) int32 BoxQPStatus
    free: torch.Tensor  # (..., n) bool free-variable mask
    Hfree: torch.Tensor  # (..., n, n) identity-padded free-block Hessian


def enum_applies(options, n: int) -> bool:
    """Whether ``options`` (BoxQPOptions) select the enumerated solver for n
    variables ("enum", or "auto" up to ``enum_max_dim``)."""
    return options.method == "enum" or (
        options.method == "auto" and n <= options.enum_max_dim
    )


def _masked_free_hessian(H, fmask):
    """Identity-padded free block: PD iff the true free block is PD."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H * (fmask[..., :, None] * fmask[..., None, :]) + eye * (1.0 - fmask[..., None, :])


def solve_masked_free(Hfree, rhs, free):
    """Solve the free-block system with clamped rows forced to zero
    (boxqp.cpp:227-233, clddp_solver.cpp:162-178). ``rhs`` is (..., n) or
    (..., n, m)."""
    f = free.to(rhs.dtype)
    if rhs.dim() == Hfree.dim():
        f = f[..., None]
    return psd_solve(Hfree, rhs * f) * f


def boxqp_solve_enum(H, g, lower, upper) -> BoxQPResult:
    n = H.shape[-1]
    dtype, device = H.dtype, H.device
    hess_not_pd = ~is_pd(0.5 * (H + H.transpose(-1, -2)))

    # configs[c, i] in {0: free, 1: at lower, 2: at upper}, itertools order.
    cfg = torch.tensor(list(itertools.product(range(3), repeat=n)),
                       device=device)
    free = cfg == 0  # (C, n)
    fmask = free.to(dtype)
    Hc, gc = H[..., None, :, :], g[..., None, :]
    lo, hi = lower[..., None, :], upper[..., None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    x_clamped = torch.where(cfg == 1, lo, torch.where(cfg == 2, hi, zero))
    Hff = _masked_free_hessian(Hc, fmask)
    bad = ~is_pd(Hff)
    rhs = -(gc + (Hc @ (x_clamped * (1.0 - fmask))[..., None])[..., 0]) * fmask
    x = psd_solve(Hff, rhs) * fmask + x_clamped * (1.0 - fmask)
    grad = gc + (Hc @ x[..., None])[..., 0]
    # KKT: free coords inside the box; lower-clamped grad >= 0; upper-clamped
    # grad <= 0 (sign rule of boxqp.cpp:67-73).
    ok = torch.where(free, (x >= lo) & (x <= hi), True)
    ok = ok & torch.where(cfg == 1, grad >= 0.0, True)
    ok = ok & torch.where(cfg == 2, grad <= 0.0, True)
    valid = ok.all(dim=-1) & ~bad  # (..., C)
    # Ties (a boundary optimum validates under several configs) keep the
    # first valid config; selection is a masked sum over configs.
    first = valid & (torch.cumsum(valid.to(torch.int32), dim=-1) == 1)
    w = first.to(dtype)
    x_sel = torch.einsum("...c,...cn->...n", w, x)
    free_sel = torch.einsum("...c,cn->...n", w, fmask) > 0.5
    Hfree = torch.einsum("...c,...cij->...ij", w, Hff)
    none_valid = ~first.any(dim=-1)
    eye = torch.eye(n, dtype=dtype, device=device)
    Hfree = torch.where(none_valid[..., None, None], eye, Hfree)

    all_clamped = ~free_sel.any(dim=-1)
    status = torch.where(
        hess_not_pd,
        BoxQPStatus.HESSIAN_NOT_PD,
        torch.where(all_clamped, BoxQPStatus.ALL_CLAMPED, BoxQPStatus.SUCCESS),
    ).to(torch.int32)
    return BoxQPResult(x=x_sel, status=status, free=free_sel, Hfree=Hfree)
