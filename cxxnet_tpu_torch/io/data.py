"""Data pipeline ABI: DataInst / SparseInst / DataBatch / IIterator.

The port's own copy of cxxnet_tpu/io/data.py (the reference's
src/io/data.h:18-188). Iterators compose into chains declared in a config
(``iter = mnist .. iter = threadbuffer .. iter = end``); the factory is
``cxxnet_tpu_torch.io.create_iterator``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


# CSR element dtype: feature index + value pairs (reference
# SparseInst::Entry, src/io/data.h:52-66)
sparse_entry_t = np.dtype([("findex", np.uint32), ("fvalue", np.float32)])


class DataInst:
    """Single instance (src/io/data.h:41)."""

    def __init__(self, data: np.ndarray, label: np.ndarray, index: int = 0):
        self.data = data          # (c, h, w)
        self.label = label        # (label_width,)
        self.index = index


class SparseInst:
    """Single sparse instance (src/io/data.h:48-77): label + CSR entries."""

    def __init__(self, entries: np.ndarray, label: np.ndarray, index: int = 0):
        self.entries = np.asarray(entries, sparse_entry_t)  # (nnz,)
        self.label = label
        self.index = index

    def __len__(self) -> int:
        return len(self.entries)


class DataBatch:
    """Batch of instances (src/io/data.h:79): dense 4-D data, 2-D label,
    optional extra data, the number of padding rows at its end, and an
    optional CSR block."""

    def __init__(self):
        self.data: Optional[np.ndarray] = None       # (b, c, h, w)
        self.label: Optional[np.ndarray] = None      # (b, label_width) float32
        self.inst_index: Optional[np.ndarray] = None  # (b,) uint32
        self.batch_size: int = 0
        self.num_batch_padd: int = 0
        self.extra_data: List[np.ndarray] = []
        # sparse part, CSR (src/io/data.h:96-100): row_ptr[batch_size+1]
        # offsets into sparse_data, entries typed sparse_entry_t
        self.sparse_row_ptr: Optional[np.ndarray] = None   # (b+1,) int64
        self.sparse_data: Optional[np.ndarray] = None      # (nnz,) sparse_entry_t

    def shallow_copy(self) -> "DataBatch":
        out = DataBatch()
        out.data, out.label = self.data, self.label
        out.inst_index = self.inst_index
        out.batch_size = self.batch_size
        out.num_batch_padd = self.num_batch_padd
        out.extra_data = list(self.extra_data)
        out.sparse_row_ptr = self.sparse_row_ptr
        out.sparse_data = self.sparse_data
        return out

    def deep_copy(self) -> "DataBatch":
        """Field-complete copy for the buffering iterators (threadbuffer /
        membuffer)."""
        out = DataBatch()
        out.data = np.array(self.data, copy=True)
        out.label = np.array(self.label, copy=True)
        out.inst_index = (np.array(self.inst_index, copy=True)
                          if self.inst_index is not None else None)
        out.batch_size = self.batch_size
        out.num_batch_padd = self.num_batch_padd
        out.extra_data = [np.array(e, copy=True) for e in self.extra_data]
        if self.sparse_row_ptr is not None:
            out.sparse_row_ptr = np.array(self.sparse_row_ptr, copy=True)
            out.sparse_data = np.array(self.sparse_data, copy=True)
        return out

    # --- sparse helpers ----------------------------------------------------
    def set_sparse(self, insts: List["SparseInst"]) -> None:
        """Fill the CSR fields from per-instance entry lists."""
        counts = [len(si) for si in insts]
        self.sparse_row_ptr = np.zeros(len(insts) + 1, np.int64)
        np.cumsum(counts, out=self.sparse_row_ptr[1:])
        if sum(counts):
            self.sparse_data = np.concatenate(
                [np.asarray(si.entries, sparse_entry_t) for si in insts])
        else:
            self.sparse_data = np.empty(0, sparse_entry_t)

    def sparse_to_dense(self, num_feature: int) -> np.ndarray:
        """Densify the CSR block to (b, num_feature) float32, summing
        duplicate entries."""
        assert self.sparse_row_ptr is not None and self.sparse_data is not None
        b = len(self.sparse_row_ptr) - 1
        out = np.zeros((b, num_feature), np.float32)
        rp = self.sparse_row_ptr
        rows = np.repeat(np.arange(b), np.diff(rp))
        np.add.at(out, (rows, self.sparse_data["findex"].astype(np.int64)),
                  self.sparse_data["fvalue"])
        return out


class IIterator:
    """Iterator ABI (src/io/data.h:18-38): SetParam / Init / BeforeFirst /
    Next / Value."""

    # True when before_first() replays the same batch sequence on a freshly
    # built iterator (fixed-seed one-shot shuffles, stream order). An
    # iterator whose order depends on random state carried across epochs
    # (the sliding-window shuffle) sets it False in init(): a mid-round
    # resume then skips a different prefix, and learn_task warns. Wrappers
    # inherit their chain's stability through learn_task's walk over
    # ``.base``.
    stable_epoch_order = True

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self):
        raise NotImplementedError

    def close(self) -> None:
        """Release host resources (threads, pools, files). Wrapper
        iterators delegate down the chain; safe to call twice."""

    def skip(self, n: int) -> int:
        """Move past ``n`` batches without using their values; returns the
        number skipped (< n when the epoch ends first): the resume cursor
        of a mid-round checkpoint. The default drains batches through
        next(), which is right for every chained or buffered iterator and
        uses up the random draws of the batches it passes; base iterators
        with random access override it with an O(1) seek."""
        k = 0
        while k < n and self.next():
            k += 1
        return k

    def epoch_rng_state(self, mid_epoch: bool) -> dict:
        """The host random state of the chain's augmenters that an epoch
        starts from: the current epoch's (``mid_epoch``) or the next
        one's; {} for a chain that draws nothing across epochs. A resumed
        run sets it back (``set_epoch_rng_state``), so that its crops and
        mirrors are those of the uninterrupted run."""
        base = getattr(self, "base", None)
        return base.epoch_rng_state(mid_epoch) if base is not None else {}

    def set_epoch_rng_state(self, state: dict) -> None:
        """Start the next epoch (at ``before_first``) from ``state``, a
        dict that ``epoch_rng_state`` returned."""
        base = getattr(self, "base", None)
        if base is not None:
            base.set_epoch_rng_state(state)

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value()
