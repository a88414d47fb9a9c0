"""The kernels' view of their inputs: each one read where it lies.

The wrappers of the per-pass kernels (1: ``riccati.py``, 5:
``ip_rollout.py``, 6: ``ipddp_riccati.py``) copy no input. Each hands its
kernel every input's address and its batch, step and value strides, and
the kernel reads the values of one instance and step from there: a
batch-first tensor, a slice of one (``X[:, :-1]``), a batch-last view
(``movedim`` of a (..., B) tensor, as kernels 1, 5 and 6 return their
outputs), or a broadcast (a stride of 0 on the batch axis, or on the batch
and step axes, as the quadratic objective expands its Hessians), which
the kernel reads from its one copy.
"""

from __future__ import annotations

import ctypes


def operand_strides(kernel: str, ins, step_operands: int):
    """Each of ``ins``' (batch stride, step stride, value stride) in
    elements: the first ``step_operands`` are (B, N, ...) tensors, the
    rest (B, ...), whose step stride is 0. The values of one instance and
    step (the axes after batch and step, row-major) must be evenly spaced:
    the value stride is 1 for a dense batch-first tensor and B for a
    batch-last view. Raises ValueError otherwise, rather than copy."""
    out = []
    for k, t in enumerate(ins):
        lead = 2 if k < step_operands else 1
        inner = [(n, st) for n, st in zip(t.shape[lead:], t.stride()[lead:]) if n != 1]
        vs = inner[-1][1] if inner else 1
        want = vs
        for n, st in reversed(inner):
            if st != want or vs == 0:
                raise ValueError(f"{kernel}: input {k} of shape {tuple(t.shape)} and "
                                 f"strides {t.stride()} has no evenly spaced values")
            want *= n
        out.append((t.stride(0), t.stride(1) if lead == 2 else 0, vs))
    return out


def pointers(tensors) -> ctypes.Array:
    """The tensors' device addresses as a C array (a null for None)."""
    return (ctypes.c_void_p * len(tensors))(*(None if t is None else t.data_ptr()
                                              for t in tensors))


def strides_array(strides) -> ctypes.Array:
    """The (batch, step, value) triples of ``operand_strides``, flattened,
    as a C array of long long."""
    flat = [s for triple in strides for s in triple]
    return (ctypes.c_longlong * len(flat))(*flat)
