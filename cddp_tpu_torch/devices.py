"""Where the public builders put their tensors.

The port runs on the card unless the caller asks for the CPU: a builder
called with ``device=None`` puts every tensor it builds on CUDA, and raises
when no CUDA device is present rather than falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cddp_tpu_torch builds on the card by default; "
            "pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")
