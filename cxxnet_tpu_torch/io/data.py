"""Data pipeline ABI: DataBatch and the IIterator protocol.

The port's own copy of the part of cxxnet_tpu/io/data.py (the reference's
src/io/data.h:18-188) that the trainer reads: a batch of dense 4-D data and
2-D labels with its padding count, and the iterator protocol
(``before_first`` / ``next`` / ``value``) that ``Trainer.evaluate`` walks.
The concrete iterators (mnist, imgbin, the buffers) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DataBatch:
    """Batch of instances (src/io/data.h:79): dense 4-D data, 2-D label and
    the number of padding rows at its end."""

    def __init__(self):
        self.data: Optional[np.ndarray] = None       # (b, c, h, w) float32
        self.label: Optional[np.ndarray] = None      # (b, label_width) float32
        self.batch_size: int = 0
        self.num_batch_padd: int = 0


class IIterator:
    """Iterator ABI (src/io/data.h:18-38): BeforeFirst / Next / Value."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self) -> DataBatch:
        raise NotImplementedError
