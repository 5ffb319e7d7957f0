"""Data pipeline of the port: the batch type and the iterator protocol
(io/data.py). The concrete iterators belong to a later slice."""

from .data import DataBatch, IIterator  # noqa: F401
