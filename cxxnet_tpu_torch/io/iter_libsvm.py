"""LibSVM-format sparse iterator, the producer for DataBatch's CSR surface:
the port's copy of cxxnet_tpu/io/iter_libsvm.py.

The reference declares the CSR fields (src/io/data.h:48-100, SparseInst +
sparse_row_ptr/sparse_data) but ships no iterator that fills them; this
closes that gap with the standard sparse text format::

    <label> <findex>:<fvalue> <findex>:<fvalue> ...

Each batch carries both representations: the CSR block and a densified
``(b, 1, 1, num_feature)`` float32 view, which is what the trainer feeds
(DataBatch.sparse_to_dense).

Config::

    iter = libsvm
      path_data = "train.svm"
      num_feature = 784
      batch_size = 100
      shuffle = 1
      round_batch = 1
    iter = end
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .data import DataBatch, IIterator, SparseInst, sparse_entry_t


def parse_libsvm(path: str) -> List[SparseInst]:
    insts = []
    with open(path) as f:
        for i, line in enumerate(f):
            toks = line.split()
            if not toks:
                continue
            label = np.asarray([float(toks[0])], np.float32)
            pairs = (t.split(":", 1) for t in toks[1:])
            entries = np.asarray([(int(i), float(v)) for i, v in pairs],
                                 sparse_entry_t)
            insts.append(SparseInst(entries, label, index=i))
    return insts


class LibSVMIterator(IIterator):
    """Batch-level sparse iterator (the corpus is held in host memory, as
    the mnist iterator holds its own)."""

    def __init__(self):
        self.path_data = ""
        self.batch_size = 0
        self.num_feature = 0
        self.shuffle = 0
        self.round_batch = 0
        self.seed_data = 0
        self.silent = 0
        self.insts: List[SparseInst] = []
        self._order: Optional[np.ndarray] = None
        self._rnd = None
        self._pos = 0
        self.out: Optional[DataBatch] = None

    def set_param(self, name, val):
        if name == "path_data":
            self.path_data = val
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "num_feature":
            self.num_feature = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "round_batch":
            self.round_batch = int(val)
        if name == "seed_data":
            self.seed_data = int(val)
        if name == "silent":
            self.silent = int(val)

    def init(self):
        if not self.path_data:
            raise ValueError("libsvm: must set path_data")
        if self.batch_size <= 0:
            raise ValueError("libsvm: must set batch_size")
        if self.num_feature <= 0:
            raise ValueError("libsvm: must set num_feature")
        self.insts = parse_libsvm(self.path_data)
        if not self.insts:
            raise ValueError("libsvm: empty data file %s" % self.path_data)
        max_idx = max((int(si.entries["findex"].max())
                       for si in self.insts if len(si)), default=-1)
        if max_idx >= self.num_feature:
            raise ValueError("libsvm: feature index %d >= num_feature %d"
                             % (max_idx, self.num_feature))
        self._rnd = np.random.RandomState(self.seed_data)
        self._order = np.arange(len(self.insts))
        if self.silent == 0:
            print("LibSVMIterator: load %d instances, %d features, "
                  "shuffle=%d" % (len(self.insts), self.num_feature,
                                  self.shuffle))

    def before_first(self):
        self._pos = 0
        if self.shuffle:
            self._rnd.shuffle(self._order)

    def next(self) -> bool:
        n = len(self.insts)
        if self._pos >= n:
            return False
        take = list(range(self._pos, min(self._pos + self.batch_size, n)))
        self._pos += self.batch_size
        pad = 0
        if len(take) < self.batch_size:
            if self.round_batch and n >= self.batch_size:
                pad = self.batch_size - len(take)
                take += list(range(pad))      # wrap to the epoch start
            else:
                pad = self.batch_size - len(take)
                take += [take[-1]] * pad      # repeat-pad the short tail
        insts = [self.insts[self._order[i]] for i in take]
        b = DataBatch()
        b.batch_size = self.batch_size
        b.num_batch_padd = pad
        b.set_sparse(insts)
        b.data = b.sparse_to_dense(self.num_feature).reshape(
            self.batch_size, 1, 1, self.num_feature)
        b.label = np.stack([si.label for si in insts])
        b.inst_index = np.asarray([si.index for si in insts], np.uint32)
        self.out = b
        return True

    def value(self) -> DataBatch:
        return self.out
