"""Record of which engine ran (counterpart of ``cddp_tpu/ops/pallas/dispatch_log.py``).

Every kernel wrapper calls :func:`launched` right where it launches its
CUDA kernel, and nowhere else, so ``launches`` proves which kernels a run
went through. Each engine decision also goes to the
``cddp_tpu_torch.dispatch`` logger at INFO level.
"""

from __future__ import annotations

import logging
from collections import Counter

logger = logging.getLogger("cddp_tpu_torch.dispatch")

# kernel name -> launches since the last reset()
launches: Counter = Counter()


def launched(kernel: str, batch: int) -> None:
    launches[kernel] += 1
    logger.info("%s: cuda kernel (batch=%d)", kernel, batch)


def plain(op: str, batch: int) -> None:
    logger.info("%s: plain torch (batch=%d)", op, batch)


def reset() -> None:
    launches.clear()
