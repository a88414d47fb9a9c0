"""Fixed-size IPOPT-style filter (port of ``cddp_tpu/solvers/filter.py``).

The reference filter (``FilterPoint::dominates``, cddp_core.hpp:153-175;
``acceptFilterEntry`` / ``pruneFilterToBestPoints``,
interior_point_utils.cpp:79-139) is pruned to at most ``max_filter_size``
entries, so ``max_filter_size + 2`` slots with a validity mask represent it
exactly. Batch-first: every field is (B, F) and every operation acts on
each instance's filter. Valid entries always form a prefix in insertion
order, so ``back`` is the last valid slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = float("inf")


class Filter(NamedTuple):
    merit: torch.Tensor  # (B, F)
    violation: torch.Tensor  # (B, F)
    valid: torch.Tensor  # (B, F) bool


def empty_filter(batch: int, capacity: int, dtype, device) -> Filter:
    return Filter(
        merit=torch.full((batch, capacity), _BIG, dtype=dtype, device=device),
        violation=torch.full((batch, capacity), _BIG, dtype=dtype, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
    )


def size(f: Filter) -> torch.Tensor:
    return f.valid.sum(-1)


def candidate_dominated(f: Filter, mf, cv) -> torch.Tensor:
    """isFilterCandidateDominated (interior_point_utils.cpp:97-105): an
    entry dominates the candidate (mf, cv) (B,). Returns (B,) bool."""
    return (f.valid & (f.merit <= mf[:, None]) & (f.violation <= cv[:, None])).any(-1)


def contains_invalid(f: Filter) -> torch.Tensor:
    """filterContainsInvalidValues (interior_point_utils.cpp:107-112), (B,)."""
    bad = ~(torch.isfinite(f.merit) & torch.isfinite(f.violation))
    return (f.valid & bad).any(-1)


def accept_entry(f: Filter, mf, cv):
    """acceptFilterEntry: reject a candidate (mf, cv) (B,) that an entry
    dominates; otherwise drop the entries it dominates, keep the rest in
    order and append it. Returns (filter, accepted (B,))."""
    mf_, cv_ = mf[:, None], cv[:, None]
    dominated = candidate_dominated(f, mf, cv)
    keep = f.valid & ~((mf_ <= f.merit) & (cv_ <= f.violation))
    # Stable compaction: kept entries first, original order preserved.
    order = torch.argsort((~keep).int(), dim=-1, stable=True)
    merit_c = f.merit.gather(-1, order)
    viol_c = f.violation.gather(-1, order)
    n_kept = keep.sum(-1, keepdim=True)
    idx = torch.arange(f.merit.shape[-1], device=f.merit.device)
    big = torch.full_like(f.merit, _BIG)
    merit_new = torch.where(idx == n_kept, mf_, torch.where(idx < n_kept, merit_c, big))
    viol_new = torch.where(idx == n_kept, cv_, torch.where(idx < n_kept, viol_c, big))
    d = dominated[:, None]
    out = Filter(
        merit=torch.where(d, f.merit, merit_new),
        violation=torch.where(d, f.violation, viol_new),
        valid=torch.where(d, f.valid, idx <= n_kept),
    )
    return out, ~dominated


def back(f: Filter):
    """(merit, violation, nonempty) of the most recent entry, (B,) each."""
    n = size(f)
    i = (n - 1).clamp(min=0)[:, None]
    return f.merit.gather(-1, i)[:, 0], f.violation.gather(-1, i)[:, 0], n > 0


def prune_to_best(f: Filter) -> Filter:
    """pruneFilterToBestPoints: keep the min-violation entry, plus the
    min-merit entry when distinct (1e-12); the first minimum wins ties."""
    nonempty = f.valid.any(-1, keepdim=True)
    big = torch.full_like(f.merit, _BIG)
    i_bv = torch.where(f.valid, f.violation, big).argmin(-1, keepdim=True)
    i_bm = torch.where(f.valid, f.merit, big).argmin(-1, keepdim=True)
    bv = (f.merit.gather(-1, i_bv), f.violation.gather(-1, i_bv))
    bm = (f.merit.gather(-1, i_bm), f.violation.gather(-1, i_bm))
    distinct = ((bm[1] - bv[1]).abs() > 1e-12) | ((bm[0] - bv[0]).abs() > 1e-12)
    idx = torch.arange(f.merit.shape[-1], device=f.merit.device)
    second = (idx == 1) & distinct
    merit_new = torch.where(idx == 0, bv[0], torch.where(second, bm[0], big))
    viol_new = torch.where(idx == 0, bv[1], torch.where(second, bm[1], big))
    return Filter(
        merit=torch.where(nonempty, merit_new, f.merit),
        violation=torch.where(nonempty, viol_new, f.violation),
        valid=torch.where(nonempty, (idx == 0) | second, f.valid),
    )


def clear(f: Filter) -> Filter:
    return empty_filter(f.merit.shape[0], f.merit.shape[1], f.merit.dtype,
                        f.merit.device)


def select(mask, a: Filter, b: Filter) -> Filter:
    """Per-instance choice between two filters: ``a`` where ``mask`` (B,)."""
    m = mask[:, None]
    return Filter(*(torch.where(m, x, y) for x, y in zip(a, b)))
