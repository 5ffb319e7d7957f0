"""attachtxt: join per-instance side features from a text file into
batch.extra_data; the port's copy of cxxnet_tpu/io/attach_txt.py (the
reference's src/io/iter_attach_txt-inl.hpp:15-101).

File format: first token is the feature dim d; then repeated records of
``inst_id f1 .. fd`` (whitespace separated). Features are matched to batch
rows by inst_index and fed to net input nodes in_1..in_k.
"""

from __future__ import annotations

import numpy as np

from .data import DataBatch, IIterator


class AttachTxtIterator(IIterator):
    def __init__(self, base: IIterator):
        self.base = base
        self.filename = ""
        self.batch_size = 0
        self.round_batch = 0

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "filename":
            self.filename = val
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "round_batch":
            self.round_batch = int(val)

    def init(self):
        self.base.init()
        with open(self.filename) as f:
            toks = f.read().split()
        if not toks:
            raise ValueError("AttachTxt: first token should indicate the "
                             "data dim")
        self.dim = int(toks[0])
        self.id_map = {}
        rows = []
        i = 1
        while i < len(toks):
            data_id = int(toks[i])
            feats = [float(x) for x in toks[i + 1: i + 1 + self.dim]]
            if len(feats) != self.dim:
                raise ValueError("AttachTxt: data do not match dimension "
                                 "specified")
            self.id_map[data_id] = len(rows)
            rows.append(feats)
            i += 1 + self.dim
        self.all_data = np.asarray(rows, np.float32)
        self.extra = np.zeros((self.batch_size, 1, 1, self.dim), np.float32)

    def before_first(self):
        self.base.before_first()

    def next(self) -> bool:
        if not self.base.next():
            return False
        self.out = self.base.value().shallow_copy()
        for top in range(self.batch_size):
            idx = int(self.out.inst_index[top])
            if idx in self.id_map:
                self.extra[top, 0, 0, :] = self.all_data[self.id_map[idx]]
        self.out.extra_data = [self.extra]
        return True

    def value(self) -> DataBatch:
        return self.out

    def close(self) -> None:
        self.base.close()
