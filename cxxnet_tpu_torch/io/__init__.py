"""Data pipeline of the port: iterators composing into config-declared
chains; the counterpart of cxxnet_tpu/io/__init__.py.

The factory reproduces the reference's chain assembly
(src/io/data.cpp:24-74): base iterators (mnist / libsvm / imgbin / imgbinx
/ img) and stacked adapters (threadbuffer / membuffer / attachtxt); image
base iterators come wrapped as Batch(Augment(reader)).
"""

from __future__ import annotations

from typing import List, Tuple

from .attach_txt import AttachTxtIterator
from .batch import (BatchAdaptIterator, DenseBufferIterator,  # noqa: F401
                    ThreadBufferIterator)
from .data import DataBatch, DataInst, IIterator  # noqa: F401
from .iter_mnist import MNISTIterator


def create_iterator(cfg: List[Tuple[str, str]]) -> IIterator:
    """Config-driven chain assembly (reference CreateIterator,
    src/io/data.cpp:24-74)."""
    it = None
    for name, val in cfg:
        if name == "iter":
            if val == "mnist":
                assert it is None, "mnist can not chain over other iterator"
                it = MNISTIterator()
                continue
            if val == "libsvm":
                assert it is None, "libsvm can not chain over other iterator"
                from .iter_libsvm import LibSVMIterator
                it = LibSVMIterator()
                continue
            if val in ("imgbin", "imgbinx", "img"):
                assert it is None, \
                    "image iterators can not chain over other iterator"
                from .iter_image import create_image_base
                it = create_image_base(val)
                continue
            if val == "threadbuffer":
                assert it is not None, "must specify input of threadbuffer"
                it = ThreadBufferIterator(it)
                continue
            if val == "membuffer":
                assert it is not None, "must specify input of memory buffer"
                it = DenseBufferIterator(it)
                continue
            if val == "attachtxt":
                assert it is not None, "must specify input of attach txt buffer"
                it = AttachTxtIterator(it)
                continue
            raise ValueError("unknown iterator type %s" % val)
        if it is not None:
            it.set_param(name, val)
    assert it is not None, "must specify iterator by iter=itername"
    return it
