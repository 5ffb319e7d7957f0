"""MNIST idx(.gz) iterator: the port's copy of cxxnet_tpu/io/iter_mnist.py
(the reference's src/io/iter_mnist-inl.hpp:14-158).

Loads the image and label files into host memory, scales pixels to
[0, 1), optionally shuffles with a seed, and serves full batches as views
(a tail that does not fill a batch is dropped, as in the reference)."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .data import DataBatch, IIterator

kRandMagic = 0  # the reference seeds its generator with a fixed magic


class MNISTIterator(IIterator):
    def __init__(self):
        self.mode = 1           # input_flat
        self.inst_offset = 0
        self.silent = 0
        self.shuffle = 0
        self.batch_size = 0
        self.path_img = ""
        self.path_label = ""
        self.seed = kRandMagic
        self.loc = 0

    def set_param(self, name, val):
        if name == "silent":
            self.silent = int(val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "input_flat":
            self.mode = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "index_offset":
            self.inst_offset = int(val)
        if name == "path_img":
            self.path_img = val
        if name == "path_label":
            self.path_label = val
        if name == "seed_data":
            self.seed = kRandMagic + int(val)

    def init(self):
        self._load_image()
        self._load_label()
        if self.img.shape[0] != self.labels.shape[0]:
            raise ValueError("MNISTIterator: image/label count mismatch")
        self.inst = (np.arange(self.img.shape[0], dtype=np.uint32)
                     + self.inst_offset)
        if self.shuffle:
            self._shuffle()
        n, rows, cols = self.img.shape
        if self.mode == 1:
            self.data_view = self.img.reshape(n, 1, 1, rows * cols)
        else:
            self.data_view = self.img.reshape(n, 1, rows, cols)
        if self.silent == 0:
            print("MNISTIterator: load %d images, shuffle=%d, shape=%s" %
                  (n, self.shuffle,
                   (self.batch_size,) + self.data_view.shape[1:]))
        self.loc = 0

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") \
            else open(path, "rb")

    def _load_image(self):
        with self._open(self.path_img) as f:
            _, count, rows, cols = struct.unpack(">iiii", f.read(16))
            raw = np.frombuffer(f.read(count * rows * cols), dtype=np.uint8)
        self.img = (raw.reshape(count, rows, cols).astype(np.float32)
                    * (1.0 / 256.0))

    def _load_label(self):
        with self._open(self.path_label) as f:
            _, count = struct.unpack(">ii", f.read(8))
            raw = np.frombuffer(f.read(count), dtype=np.uint8)
        self.labels = raw.astype(np.float32)

    def _shuffle(self):
        """Shuffle keeping inst_index consistent: row i's inst names its
        original instance (reference Shuffle, iter_mnist-inl.hpp:110-122)."""
        rnd = np.random.RandomState(self.seed)
        perm = np.arange(self.img.shape[0])
        rnd.shuffle(perm)
        self.img = self.img[perm]
        self.labels = self.labels[perm]
        self.inst = (perm + self.inst_offset).astype(np.uint32)

    def before_first(self):
        self.loc = 0

    def skip(self, n: int) -> int:
        """O(1): the corpus is in memory, so the cursor jumps n full
        batches ahead."""
        avail = max(0, (self.img.shape[0] - self.loc) // self.batch_size)
        k = min(int(n), avail)
        self.loc += k * self.batch_size
        return k

    def next(self) -> bool:
        if self.loc + self.batch_size > self.img.shape[0]:
            return False
        rows = slice(self.loc, self.loc + self.batch_size)
        self.out = DataBatch()
        self.out.data = self.data_view[rows]
        self.out.label = self.labels[rows].reshape(self.batch_size, 1)
        self.out.inst_index = self.inst[rows]
        self.out.batch_size = self.batch_size
        self.loc += self.batch_size
        return True

    def value(self) -> DataBatch:
        return self.out
