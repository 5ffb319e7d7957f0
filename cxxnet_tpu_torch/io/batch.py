"""Instance->batch packing and prefetching adapters: the port's copy of
cxxnet_tpu/io/batch.py.

* BatchAdaptIterator (src/io/iter_batch_proc-inl.hpp:16-133): packs DataInst
  streams into fixed-size batches; the tail either wraps around
  (``round_batch``, counting num_batch_padd) or is zero-padded;
  ``test_skipread`` serves one cached batch forever to measure the
  non-IO ceiling.
* ThreadBufferIterator (:136-226): batch-level prefetch on a host thread
  through a bounded queue; each batch handed out is the loader's own copy.
* DenseBufferIterator (src/io/iter_mem_buffer-inl.hpp:17): caches the first
  max_nbatch batches in host memory at init and serves only those.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ..utils import health
from .data import DataBatch, DataInst, IIterator


class BatchAdaptIterator(IIterator):
    def __init__(self, base: IIterator):
        self.base = base
        self.test_skipread = 0
        self.round_batch = 0
        self.num_overflow = 0
        self.silent = 0
        self.label_width = 1
        self.batch_size = 0
        self.shape = (0, 0, 0)
        self.head = 1

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "input_shape":
            dims = [int(x) for x in val.split(",")]
            if len(dims) != 3:
                raise ValueError("input_shape must be three consecutive "
                                 "integers")
            self.shape = tuple(dims)
        if name == "label_width":
            self.label_width = int(val)
        if name == "round_batch":
            self.round_batch = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "test_skipread":
            self.test_skipread = int(val)

    def init(self):
        self.base.init()
        c, h, w = self.shape
        if h == 1 and c == 1:
            dshape = (self.batch_size, 1, 1, w)
        else:
            dshape = (self.batch_size, c, h, w)
        self.out = DataBatch()
        self.out.data = np.zeros(dshape, np.float32)
        self.out.label = np.zeros((self.batch_size, self.label_width),
                                  np.float32)
        self.out.inst_index = np.zeros((self.batch_size,), np.uint32)
        self.out.batch_size = self.batch_size

    def before_first(self):
        if self.round_batch == 0 or self.num_overflow == 0:
            self.base.before_first()
        else:
            self.num_overflow = 0
        self.head = 1

    def _store(self, top: int, d: DataInst):
        self.out.label[top] = d.label
        self.out.inst_index[top] = d.index
        if self.out.data.dtype != d.data.dtype:
            # follow the producer's dtype (output_uint8 keeps uint8)
            self.out.data = self.out.data.astype(d.data.dtype)
        self.out.data[top] = d.data.reshape(self.out.data.shape[1:])

    def next(self) -> bool:
        self.out.num_batch_padd = 0
        if self.test_skipread != 0 and self.head == 0:
            return True
        self.head = 0
        if self.num_overflow != 0:
            return False
        top = 0
        while self.base.next():
            self._store(top, self.base.value())
            top += 1
            if top >= self.batch_size:
                return True
        if top == 0:
            return False
        if self.round_batch != 0:
            self.num_overflow = 0
            self.base.before_first()
            while top < self.batch_size:
                if not self.base.next():
                    raise ValueError("number of input must be bigger than "
                                     "batch size")
                self._store(top, self.base.value())
                top += 1
                self.num_overflow += 1
            self.out.num_batch_padd = self.num_overflow
        else:
            self.out.num_batch_padd = self.batch_size - top
        return True

    def value(self) -> DataBatch:
        assert self.head == 0, "must call Next to get value"
        return self.out

    def close(self) -> None:
        self.base.close()


class _LoaderError:
    """Queue marker carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ThreadBufferIterator(IIterator):
    """Host-thread batch prefetcher (double buffering)."""

    def __init__(self, base: IIterator):
        self.base = base
        self.silent = 0
        self.buffer_size = 2
        self.thread: Optional[threading.Thread] = None
        self.q: Optional[queue.Queue] = None
        self._cmd: queue.Queue = queue.Queue()

    def set_param(self, name, val):
        if name == "silent":
            self.silent = int(val)
        if name == "buffer_size":
            self.buffer_size = int(val)
        self.base.set_param(name, val)

    def init(self):
        self.base.init()
        if self.silent == 0:
            print("ThreadBufferIterator: buffer_size=%d" % self.buffer_size)
        self._start_loader()

    def _poll_stop(self) -> bool:
        try:
            return self._cmd.get_nowait() == "stop"
        except queue.Empty:
            return False

    def _loader(self):
        while True:
            cmd = self._cmd.get()
            if cmd == "stop":
                return
            # one pass: prefetch until exhausted, polling for a stop so that
            # close() mid-pass never leaves the thread blocked on a full queue
            try:
                self.base.before_first()
                while self.base.next():
                    item = self.base.value().deep_copy()
                    # watchdog liveness: a beat per produced batch and per
                    # poll of a full queue, so that only a producer wedged
                    # inside base.next() (a hung read, a dead decoder)
                    # goes silent
                    health.beat("io.prefetch")
                    while True:
                        if self._poll_stop():
                            return
                        try:
                            self.q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            health.beat("io.prefetch")
                self.q.put(None)  # end marker
                # between passes the loader idles at _cmd.get()
                health.pause("io.prefetch")
            except Exception as exc:   # surface in the consumer's next()
                self.q.put(_LoaderError(exc))
                return

    def _start_loader(self):
        self.q = queue.Queue(maxsize=self.buffer_size)
        self.thread = threading.Thread(target=self._loader, daemon=True)
        self.thread.start()
        self._pass_started = False
        self._dead = None          # first loader exception; iterator is done

    def _raise_dead(self, item):
        self._pass_started = False
        self._dead = item.exc
        raise item.exc

    def _get_item(self):
        """q.get that cannot hang on a dead producer: a loader thread that
        died without posting its end marker or an error fails the consumer
        instead of blocking it forever."""
        while True:
            try:
                return self.q.get(timeout=1.0)
            except queue.Empty:
                if self.thread is None or not self.thread.is_alive():
                    self._pass_started = False
                    self._dead = RuntimeError(
                        "ThreadBufferIterator: prefetch thread died "
                        "without delivering a batch or an end marker")
                    raise self._dead

    def before_first(self):
        if self._dead is not None:
            raise self._dead
        # drain any in-flight pass
        if self._pass_started:
            while True:
                item = self._get_item()
                if item is None:
                    break
                if isinstance(item, _LoaderError):
                    self._raise_dead(item)
        self._cmd.put("start")
        self._pass_started = True

    def next(self) -> bool:
        if self._dead is not None:
            raise self._dead
        if not self._pass_started:
            self.before_first()
        item = self._get_item()
        if isinstance(item, _LoaderError):
            self._raise_dead(item)
        if item is None:
            self._pass_started = False
            return False
        self.out = item
        return True

    def value(self) -> DataBatch:
        return self.out

    def close(self) -> None:
        if self.thread is not None:
            self._cmd.put("stop")
            # the loader polls for the stop between queue puts, so it
            # exits promptly whether idle, mid-pass or blocked
            self.thread.join(timeout=5.0)
            if self.thread.is_alive():
                # never tear down base under a live producer
                return
            self.thread = None
        self.base.close()

    def __del__(self):
        try:
            self._cmd.put("stop")
        except Exception:
            pass


class DenseBufferIterator(IIterator):
    """membuffer: cache the first max_nbatch batches in host memory."""

    def __init__(self, base: IIterator):
        self.base = base
        self.max_nbatch = 100
        self.data_index = 0
        self.silent = 0

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "max_nbatch":
            self.max_nbatch = int(val)
        if name == "silent":
            self.silent = int(val)

    def init(self):
        self.base.init()
        self.buffer = []
        self.base.before_first()
        while self.base.next():
            self.buffer.append(self.base.value().deep_copy())
            if len(self.buffer) >= self.max_nbatch:
                break
        if self.silent == 0:
            print("DenseBufferIterator: load %d batches" % len(self.buffer))

    def before_first(self):
        self.data_index = 0

    def next(self) -> bool:
        if self.data_index < len(self.buffer):
            self.data_index += 1
            return True
        return False

    def value(self) -> DataBatch:
        assert self.data_index > 0, "Iterator.Value: at beginning of iterator"
        return self.buffer[self.data_index - 1]

    def close(self) -> None:
        self.base.close()
