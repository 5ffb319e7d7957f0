"""Image iterators: the imgbin / imgbinx page readers, the plain img
iterator and the augmentation adapter; the port's copy of
cxxnet_tpu/io/iter_image.py.

* ImagePageIterator <- the reference's ThreadImagePageIterator/X
  (src/io/iter_thread_imbin-inl.hpp:16, iter_thread_imbin_x-inl.hpp:18):
  records from BinaryPage packs with .lst label files, read ahead on a C++
  thread (utils/native.py NativePageReader); multi-part lists via
  image_conf_prefix / image_conf_ids; file sharding by dist_num_worker /
  dist_worker_rank (env PS_RANK), set by the user alone: as in the JAX
  package, every rank of a multi-process run reads the whole stream and the
  trainer takes its rows of each batch; a decode pool with decode_timeout.
* ImageIterator <- src/io/iter_img-inl.hpp:16 (one file per record).
* GeometricAugmenter <- src/io/image_augmenter-inl.hpp:13: rotation,
  shear, aspect ratio and random scale in one bicubic affine warp
  (csrc/host/warp_affine.cc), then a crop.
* AugmentIterator <- src/io/iter_augment_proc-inl.hpp:21: crop, mirror,
  mean image (created, cached and loaded) or mean value, divideby / scale,
  random contrast and illumination.

Records decode to float32 RGB (c, h, w) in [0, 255], chosen by their
magic bytes, never by what is installed: JPEG through the port's own
decoder (csrc/host/jpeg_decode.cc, libjpeg-turbo's arithmetic), binary
PPM (P6) and PGM (P5) with maxval 255 through csrc/host/pnm_decode.cc,
both in C++ off the GIL. A JPEG in a form that decoder does not implement
(arithmetic coding, 12-bit, lossless, CMYK, other sampling layouts), and
every other format, goes through cv2.imdecode as in the JAX package, and
raises MissingCodecError where cv2 is not installed.
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ..utils import native, serializer, telemetry
from ..utils.binary_page import KPAGE_INTS, BinaryPage
from . import warp
from .batch import BatchAdaptIterator
from .data import DataInst, IIterator


class RecordDecodeError(ValueError):
    """A single record's bytes do not decode to an image (corrupt or torn
    record). The page iterator skips and quarantines such records
    (``skip_corrupt = 1``)."""


class MissingCodecError(RuntimeError):
    """A record in a format that only cv2 decodes (not JPEG or PPM/PGM, or
    a JPEG form the port's decoder does not implement), on a machine
    without cv2. Never skipped: the data is fine, the machine cannot read
    it."""


class PackReadError(RuntimeError):
    """The .bin pack ended or went unreadable before the .lst did. Record
    and label alignment past this point is lost, so the epoch ends early
    (warned) rather than serving mislabeled images."""


_MAGICS = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG", "PNG"), (b"BM", "BMP"),
           (b"GIF8", "GIF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
           (b"P", "PNM"))


def _pnm_header(buf: bytes):
    """(channels, width, height, maxval, data offset) of a binary P5/P6
    record; raises RecordDecodeError on a malformed header."""
    fields = []
    i = 2
    n = len(buf)
    while len(fields) < 3:
        while i < n and buf[i:i + 1].isspace():
            i += 1
        if i < n and buf[i:i + 1] == b"#":
            while i < n and buf[i:i + 1] not in (b"\n", b"\r"):
                i += 1
            continue
        j = i
        while j < n and buf[j:j + 1].isdigit():
            j += 1
        if j == i:
            raise RecordDecodeError("malformed PNM header")
        fields.append(int(buf[i:j]))
        i = j
    if i >= n or not buf[i:i + 1].isspace():
        raise RecordDecodeError("malformed PNM header")
    channels = 3 if buf[1:2] == b"6" else 1
    return channels, fields[0], fields[1], fields[2], i + 1


def _decode_pnm(buf: bytes) -> Optional[np.ndarray]:
    """Binary PPM/PGM with maxval 255 as (3, h, w) float32 RGB (gray
    expanded to three equal channels, as cv2.IMREAD_COLOR does); None for
    another maxval."""
    c, w, h, maxval, off = _pnm_header(buf)
    if maxval != 255:
        return None
    if w <= 0 or h <= 0 or len(buf) - off < w * h * c:
        raise RecordDecodeError("truncated PNM record (%dx%dx%d, %d bytes)"
                                % (w, h, c, len(buf)))
    pix = np.frombuffer(buf, np.uint8, w * h * c, off).reshape(h, w, c)
    out = np.empty((3, h, w), np.float32)
    out[...] = pix.transpose(2, 0, 1)
    return out


# records decoded by each route since the process started (or the counts
# were last set to 0): "jpeg" the port's JPEG decoder, "pnm" its PPM/PGM
# decoder, "cv2" cv2.imdecode
decode_routes = {"jpeg": 0, "pnm": 0, "cv2": 0}
_routes_lock = threading.Lock()


def _count_route(route: str) -> None:
    with _routes_lock:
        decode_routes[route] += 1


def _decode_cv2(buf: bytes, what: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise MissingCodecError(
            "image record in %s (%d bytes): the port decodes JPEG and binary "
            "PPM/PGM with maxval 255 itself; this one needs cv2 (OpenCV), "
            "which is not installed" % (what, len(buf))) from None
    bgr = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise RecordDecodeError("undecodable image record (%d bytes)"
                                % len(buf))
    _count_route("cv2")
    return np.ascontiguousarray(
        bgr[:, :, ::-1].transpose(2, 0, 1).astype(np.float32))


def decode_image(buf: bytes) -> np.ndarray:
    """One record's bytes as float32 RGB (3, h, w) in [0, 255]. The decoder
    is chosen by the record's magic bytes, never by what is installed."""
    with telemetry.span("io.decode"):
        telemetry.count("io.decode_bytes", len(buf))
        buf = bytes(buf)
        if buf[:3] == b"\xff\xd8\xff":
            route, decode, what = "jpeg", native.decode_jpeg_chw, "JPEG"
        elif buf[:2] in (b"P5", b"P6"):
            route, decode, what = "pnm", native.decode_pnm_chw, "PNM"
        else:
            kind = next((k for m, k in _MAGICS if buf.startswith(m)),
                        "an unrecognized format")
            return _decode_cv2(buf, kind)
        try:
            out = decode(buf)
        except native.NativeError as e:
            if not e.refused:
                raise RecordDecodeError("undecodable %s record (%d bytes): "
                                        "%s" % (what, len(buf), e.what))
            return _decode_cv2(buf, "%s with %s" % (what,
                                                    native.REFUSED[e.code]))
        _count_route(route)
        return out


class PythonPageReader:
    """The objects of a chain of BinaryPage .bin files, read in Python on
    the caller's thread: the plain version of utils/native.py's
    NativePageReader, with its interface."""

    def __init__(self, paths: List[str], page_ints: int):
        self.paths = list(paths)
        self.page_ints = page_ints
        self.f = None
        self.before_first()

    def before_first(self) -> None:
        self.close()
        self.idx = 0
        self.page = None
        self.ptop = 0
        self.f = open(self.paths[0], "rb")

    def next_obj(self) -> Optional[bytes]:
        while self.page is None or self.ptop >= self.page.size():
            if self.f is None:
                return None
            try:
                page = BinaryPage.load(self.f, self.page_ints)
            except Exception as e:   # garbage page header/layout
                raise IOError("corrupt BinaryPage in %s: %s"
                              % (self.paths[self.idx], e))
            if page is None:
                self.f.close()
                self.f = None
                self.idx += 1
                if self.idx >= len(self.paths):
                    return None
                self.f = open(self.paths[self.idx], "rb")
                continue
            self.page = page
            self.ptop = 0
        obj = self.page[self.ptop]
        self.ptop += 1
        return obj

    def close(self) -> None:
        if self.f is not None:
            self.f.close()
            self.f = None


class _ListReader:
    """Reads .lst files: lines of ``index label[ label..] filename``."""

    def __init__(self, paths: List[str], label_width: int):
        self.paths = paths
        self.label_width = label_width
        self.idx = 0
        self.f = open(self.paths[0])

    def close(self):
        if self.f is not None:
            self.f.close()
            self.f = None

    def next_record(self):
        while True:
            line = self.f.readline()
            if line.strip():
                toks = line.split()
                index = int(toks[0])
                label = np.asarray(
                    [float(x) for x in toks[1:1 + self.label_width]],
                    np.float32)
                fname = toks[1 + self.label_width] \
                    if len(toks) > 1 + self.label_width else ""
                return index, label, fname
            if not line:
                self.idx += 1
                if self.idx >= len(self.paths):
                    return None
                self.f.close()
                self.f = open(self.paths[self.idx])


class ImagePageIterator(IIterator):
    """imgbin / imgbinx: records from BinaryPage packs with .lst labels.

    The packs are read ahead on a C++ thread (``reader``, utils/native.py
    NativePageReader; PythonPageReader is its plain version).
    ``decode_thread > 1`` (imgbinx's default is 4) decodes ahead of the
    consumer in a thread pool, ``buffer_size`` records deep;
    ``decode_timeout > 0`` bounds one record's decode there: a worker
    wedged past it is presumed dead, the pool is rebuilt with the pending
    records resubmitted, and the record is quarantined. ``shuffle``
    permutes the part files every epoch and draws records from a seeded
    window of ``shuffle_window`` upcoming ones, with the JAX package's
    draws (RandomState(seed_data + 121)). ``skip_corrupt`` (default 1)
    skips an undecodable record with a warning and drops its index in
    later epochs; a truncated pack ends the epoch early."""

    reader = native.NativePageReader

    def __init__(self):
        self.silent = 0
        self.label_width = 1
        self.path_imglst: List[str] = []
        self.path_imgbin: List[str] = []
        self.img_conf_prefix = ""
        self.img_conf_ids = ""
        self.dist_num_worker = 0
        self.dist_worker_rank = 0
        self.page_ints = KPAGE_INTS
        self.lst: Optional[_ListReader] = None
        self.pages = None
        self.decode_thread = 1
        self.buffer_size = 64
        self.decode_timeout = 0.0
        self._pool = None
        self._pending: deque = deque()
        self._lst_done = False
        self.skip_corrupt = 1
        self._quarantined = set()
        self._corrupt_seen = 0
        self.shuffle = 0
        self.seed_data = 0
        self.shuffle_window = 1024
        self._rnd = None
        self._window: List = []
        self._part_order: List[int] = []

    def set_param(self, name, val):
        if name == "image_list":
            self.path_imglst.append(val)
        if name == "image_bin":
            self.path_imgbin.append(val)
        if name == "image_conf_prefix":
            self.img_conf_prefix = val
        if name == "image_conf_ids":
            self.img_conf_ids = val
        if name == "dist_num_worker":
            self.dist_num_worker = int(val)
        if name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "page_size":
            self.page_ints = int(val)
        if name == "decode_thread":
            self.decode_thread = int(val)
        if name == "buffer_size":
            self.buffer_size = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "seed_data":
            self.seed_data = int(val)
        if name == "shuffle_window":
            self.shuffle_window = int(val)
            if self.shuffle_window < 1:
                raise ValueError("shuffle_window must be >= 1 "
                                 "(1 = stream order)")
        if name == "skip_corrupt":
            self.skip_corrupt = int(val)
        if name == "decode_timeout":
            self.decode_timeout = float(val)

    def _parse_image_conf(self):
        """Multi-part list + distributed sharding
        (reference ParseImageConf, iter_thread_imbin-inl.hpp:189-220)."""
        ps_rank = os.environ.get("PS_RANK")
        if ps_rank is not None:
            self.dist_worker_rank = int(ps_rank)
        if not self.img_conf_prefix:
            return
        assert not self.path_imglst and not self.path_imgbin, \
            "you can either set image_conf_prefix or image_bin/image_list"
        lb, ub = (int(x) for x in self.img_conf_ids.split("-"))
        n = ub + 1 - lb
        if self.dist_num_worker > 1:
            step = (n + self.dist_num_worker - 1) // self.dist_num_worker
            begin = min(self.dist_worker_rank * step, n) + lb
            end = min((self.dist_worker_rank + 1) * step, n) + lb
            lb, ub = begin, end - 1
            assert lb <= ub, ("ThreadImagePageIterator: too many workers "
                              "such that idlist cannot be divided between "
                              "them")
        for i in range(lb, ub + 1):
            tmp = self.img_conf_prefix % i
            self.path_imglst.append(tmp + ".lst")
            self.path_imgbin.append(tmp + ".bin")

    def init(self):
        self._parse_image_conf()
        assert len(self.path_imgbin) == len(self.path_imglst), \
            "List/Bin number not consist"
        if self.silent == 0:
            print("ImagePageIterator: image_list=%s, bin=%s" %
                  (",".join(self.path_imglst), ",".join(self.path_imgbin)))
        # kRandMagic = 121, the reference's sampler seed
        self._rnd = np.random.RandomState(self.seed_data + 121)
        self._part_order = list(range(len(self.path_imgbin)))
        # the sliding-window shuffle draws from _rnd at every instance, so
        # an epoch's order depends on every earlier epoch's draws: a fresh
        # process cannot replay it, and a mid-round resume is approximate
        self.stable_epoch_order = not self.shuffle
        self.before_first()

    def _epoch_paths(self):
        if self.shuffle and len(self._part_order) > 1:
            self._rnd.shuffle(self._part_order)
        return ([self.path_imglst[i] for i in self._part_order],
                [self.path_imgbin[i] for i in self._part_order])

    def before_first(self):
        lst_paths, bin_paths = self._epoch_paths()
        if self.lst is not None:
            self.lst.close()
        self.lst = _ListReader(lst_paths, self.label_width)
        if self.pages is not None and self.shuffle \
                and len(self._part_order) > 1:
            # the part files were reordered: a reader over the new chain
            self.pages.close()
            self.pages = None
        if self.pages is None:
            self.pages = self.reader(bin_paths, self.page_ints)
        else:
            self.pages.before_first()
        self._epoch_bin_paths = bin_paths
        self._pending = deque()
        self._lst_done = False
        self._window = []

    def _next_buffer(self) -> bytes:
        try:
            obj = self.pages.next_obj()
        except IOError as e:
            raise PackReadError(str(e))
        if obj is None:
            raise PackReadError("binary pack exhausted before list file "
                                "(truncated pack?)")
        return obj

    def _next_pair(self):
        """Next (index, label, record bytes) in on-disk stream order;
        quarantined indices are consumed and dropped, and a truncated or
        corrupt pack ends the epoch early."""
        while True:
            rec = self.lst.next_record()
            if rec is None:
                return None
            index, label, _ = rec
            try:
                buf = self._next_buffer()
            except PackReadError as e:
                if not self.skip_corrupt:
                    raise
                sys.stderr.write("WARNING: %s; ending epoch early\n" % e)
                return None
            if int(index) in self._quarantined:
                continue
            return index, label, buf

    def _note_corrupt(self, index, reason) -> None:
        """Skip and quarantine a corrupt record by instance index: later
        epochs drop it before decode."""
        self._quarantined.add(int(index))
        self._corrupt_seen += 1
        if self.silent == 0 and self._corrupt_seen <= 10:
            sys.stderr.write(
                "WARNING: imgbin record %d undecodable (%s); skipped and "
                "quarantined by index\n" % (int(index), reason))

    def _next_shuffled(self):
        """Instance-level shuffle: draw uniformly from a seeded window of
        upcoming records (each record enters and leaves exactly once, so an
        epoch is a permutation of the corpus)."""
        if not self.shuffle:
            return self._next_pair()
        while len(self._window) < self.shuffle_window:
            p = self._next_pair()
            if p is None:
                break
            self._window.append(p)
        if not self._window:
            return None
        j = int(self._rnd.randint(len(self._window)))
        self._window[j], self._window[-1] = \
            self._window[-1], self._window[j]
        return self._window.pop()

    def _new_pool(self):
        from concurrent.futures import ThreadPoolExecutor
        return ThreadPoolExecutor(max_workers=self.decode_thread,
                                  thread_name_prefix="cxn-decode")

    def _fill_pending(self) -> None:
        if self._pool is None:
            self._pool = self._new_pool()
        while len(self._pending) < self.buffer_size and not self._lst_done:
            p = self._next_shuffled()
            if p is None:
                self._lst_done = True
                break
            index, label, buf = p
            # the bytes ride along so that a restarted pool can resubmit
            self._pending.append(
                (index, label, buf, self._pool.submit(decode_image, buf)))

    def _restart_pool(self) -> None:
        """Tear down a pool with a presumed-dead worker and resubmit the
        pending decodes to a fresh one. The wedged thread cannot be killed
        from Python: it is left to finish, and nothing waits on it."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = self._new_pool()
        self._pending = deque(
            (i, l, b, self._pool.submit(decode_image, b))
            for (i, l, b, _f) in self._pending)
        telemetry.count("io.decode_worker_restarts")

    def _take_decoded(self, index, fut) -> np.ndarray:
        if self.decode_timeout <= 0:
            return fut.result()
        from concurrent.futures import TimeoutError as FutureTimeout
        try:
            return fut.result(timeout=self.decode_timeout)
        except FutureTimeout:
            telemetry.event({"ev": "watchdog_stall", "channel": "io.decode",
                             "stalled_s": self.decode_timeout,
                             "timeout_s": self.decode_timeout,
                             "index": int(index),
                             "action": "restart_pool"})
            telemetry.flush()
            self._restart_pool()
            raise RecordDecodeError(
                "decode of record %d exceeded decode_timeout=%.2fs (worker "
                "presumed dead; pool restarted)"
                % (int(index), self.decode_timeout))

    def next(self) -> bool:
        while True:
            try:
                if self.decode_thread > 1:
                    self._fill_pending()
                    if not self._pending:
                        return False
                    index, label, _, fut = self._pending.popleft()
                    data = self._take_decoded(index, fut)
                else:
                    p = self._next_shuffled()
                    if p is None:
                        return False
                    index, label, buf = p
                    data = decode_image(buf)
            except RecordDecodeError as e:
                if not self.skip_corrupt:
                    raise
                self._note_corrupt(index, e)
                continue
            self.out = DataInst(data, label, index)
            return True

    def value(self) -> DataInst:
        return self.out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self.pages is not None:
            self.pages.close()
            self.pages = None
        if self.lst is not None:
            self.lst.close()


class ImageIterator(IIterator):
    """img: plain per-file image list iterator (src/io/iter_img-inl.hpp:16)."""

    def __init__(self):
        self.silent = 0
        self.label_width = 1
        self.path_imglst = ""
        self.path_root = ""
        self.shuffle = 0
        self.seed = 0

    def set_param(self, name, val):
        if name == "image_list":
            self.path_imglst = val
        if name == "image_root":
            self.path_root = val
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "seed_data":
            self.seed = int(val)

    def init(self):
        self.records = []
        with open(self.path_imglst) as f:
            for line in f:
                if not line.strip():
                    continue
                toks = line.split()
                index = int(toks[0])
                label = np.asarray(
                    [float(x) for x in toks[1:1 + self.label_width]],
                    np.float32)
                self.records.append((index, label,
                                     toks[1 + self.label_width]))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(self.records)
        self.loc = 0

    def before_first(self):
        self.loc = 0

    def next(self) -> bool:
        if self.loc >= len(self.records):
            return False
        index, label, fname = self.records[self.loc]
        self.loc += 1
        path = os.path.join(self.path_root, fname) if self.path_root \
            else fname
        with open(path, "rb") as f:
            data = decode_image(f.read())
        self.out = DataInst(data, label, index)
        return True

    def value(self) -> DataInst:
        return self.out


# warps done by GeometricAugmenter.process since the process started (or
# the counts were last set to 0), and their seconds
warp_calls = 0
warp_seconds = 0.0


class GeometricAugmenter:
    """Rotation (and rotate_list), shear, aspect ratio and random scale as
    one bicubic affine warp with a constant border (fill_value), then a crop
    to input_shape (reference ImageAugmenter, image_augmenter-inl.hpp:
    13-140). The draws, the float32 matrix and the output size are the JAX
    package's; the warp is the host library's (csrc/host/warp_affine.cc)."""

    def __init__(self):
        self.shape = (0, 0, 0)
        self.rand_crop = 0
        self.max_rotate_angle = 0.0
        self.max_aspect_ratio = 0.0
        self.max_shear_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.rotate = -1.0
        self.rotate_list: List[int] = []
        self.max_random_scale = 1.0
        self.min_random_scale = 1.0
        self.min_img_size = 0.0
        self.max_img_size = 1e10
        self.fill_value = 255

    def set_param(self, name, val):
        if name == "input_shape":
            self.shape = tuple(int(x) for x in val.split(","))
        if name == "rand_crop":
            self.rand_crop = int(val)
        if name == "max_rotate_angle":
            self.max_rotate_angle = float(val)
        if name == "max_shear_ratio":
            self.max_shear_ratio = float(val)
        if name == "max_aspect_ratio":
            self.max_aspect_ratio = float(val)
        if name == "min_crop_size":
            self.min_crop_size = int(val)
        if name == "max_crop_size":
            self.max_crop_size = int(val)
        if name == "min_random_scale":
            self.min_random_scale = float(val)
        if name == "max_random_scale":
            self.max_random_scale = float(val)
        if name == "min_img_size":
            self.min_img_size = float(val)
        if name == "max_img_size":
            self.max_img_size = float(val)
        if name == "fill_value":
            self.fill_value = int(val)
        if name == "rotate":
            self.rotate = int(val)
        if name == "rotate_list":
            self.rotate_list = [int(x) for x in val.split(",") if x]

    def need_process(self) -> bool:
        return (self.max_rotate_angle > 0 or self.max_shear_ratio > 0
                or self.max_aspect_ratio > 0 or self.rotate > 0
                or len(self.rotate_list) > 0
                or self.max_random_scale != 1.0
                or self.min_random_scale != 1.0 or self.min_crop_size > 0)

    def draw_matrix(self, h: int, w: int, rnd: np.random.RandomState):
        """The float32 forward map of an h x w image and the output's
        (height, width), from the draws of shear, angle, rotate_list,
        scale and ratio in the JAX package's order."""
        s = rnd.rand() * self.max_shear_ratio * 2 - self.max_shear_ratio
        angle = (rnd.randint(0, max(int(self.max_rotate_angle * 2), 1))
                 - self.max_rotate_angle)
        if self.rotate > 0:
            angle = self.rotate
        if self.rotate_list:
            angle = self.rotate_list[rnd.randint(0, len(self.rotate_list))]
        a = math.cos(angle / 180.0 * math.pi)
        b = math.sin(angle / 180.0 * math.pi)
        scale = rnd.rand() * (self.max_random_scale
                              - self.min_random_scale) + self.min_random_scale
        ratio = rnd.rand() * self.max_aspect_ratio * 2 \
            - self.max_aspect_ratio + 1
        hs = 2 * scale / (1 + ratio)
        ws = ratio * hs
        new_w = max(self.min_img_size, min(self.max_img_size, scale * w))
        new_h = max(self.min_img_size, min(self.max_img_size, scale * h))
        M = np.zeros((2, 3), np.float32)
        M[0, 0] = hs * a - s * b * ws
        M[1, 0] = -b * ws
        M[0, 1] = hs * b + s * a * ws
        M[1, 1] = a * ws
        ori_cw = M[0, 0] * w + M[0, 1] * h
        ori_ch = M[1, 0] * w + M[1, 1] * h
        M[0, 2] = (new_w - ori_cw) / 2
        M[1, 2] = (new_h - ori_ch) / 2
        return M, (int(new_h), int(new_w))

    def process(self, data: np.ndarray,
                rnd: np.random.RandomState) -> np.ndarray:
        """data: (3, h, w) float RGB in [0, 255]; returns the warped and
        cropped (3, H, W), or data itself when no key turns the warp on."""
        global warp_calls, warp_seconds
        if not self.need_process():
            return data
        t0 = time.perf_counter()
        # HWC uint8, truncating as the JAX package does (the warp treats
        # the three channels alike, so RGB order serves as well as BGR)
        src = data.transpose(1, 2, 0).astype(np.uint8)
        M, out_hw = self.draw_matrix(src.shape[0], src.shape[1], rnd)
        temp = native.warp_affine(src, warp.inverse_map(M), out_hw,
                                  self.fill_value)
        # crop to input_shape (reference crops (shape_[1], shape_[2]))
        ch, cw = self.shape[1], self.shape[2]
        y = max(temp.shape[0] - ch, 0)
        x = max(temp.shape[1] - cw, 0)
        if self.rand_crop != 0:
            y = rnd.randint(0, y + 1)
            x = rnd.randint(0, x + 1)
        else:
            y //= 2
            x //= 2
        res = temp[y: y + ch, x: x + cw]
        out = np.ascontiguousarray(res.transpose(2, 0, 1).astype(np.float32))
        warp_calls += 1
        warp_seconds += time.perf_counter() - t0
        return out


class AugmentIterator(IIterator):
    """Per-instance augmentation: the geometric augmenter's warp and crop,
    then crop (random, centred or fixed), mirror, scale, mean image or mean
    value, random contrast and illumination (reference AugmentIterator),
    with the JAX package's draws from RandomState(seed_data) in its order:
    the warp's (shear, angle, rotate_list, scale, ratio, its crop y and x),
    crop y, crop x, contrast, illumination, mirror."""

    kRandMagic = 0
    # mean-image cache header, shared with the JAX package
    _MEAN_MAGIC = b"CXNMEAN2"

    def __init__(self, base: IIterator):
        self.base = base
        self.rand_crop = 0
        self.rand_mirror = 0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.scale = 1.0
        self.silent = 0
        self.name_meanimg = ""
        self.mean_r = 0.0
        self.mean_g = 0.0
        self.mean_b = 0.0
        self.mirror = 0
        self.max_random_illumination = 0.0
        self.max_random_contrast = 0.0
        # output_uint8 = 1: emit raw uint8 pixels (crop and mirror only) and
        # leave mean and scale to the trainer's input_divideby /
        # input_scale / input_mean_value, applied on the device
        self.output_uint8 = 0
        self.shape = (0, 0, 0)
        self.aug = GeometricAugmenter()
        self.rnd = np.random.RandomState(self.kRandMagic)
        # the draws' state at the start of the current epoch, and a state
        # the next epoch is to start from (a resumed run's)
        self._epoch_rng = None
        self._rng_resume = None

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "input_shape":
            self.shape = tuple(int(x) for x in val.split(","))
        if name == "seed_data":
            self.rnd = np.random.RandomState(self.kRandMagic + int(val))
        if name == "rand_crop":
            self.rand_crop = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "divideby":
            self.scale = 1.0 / float(val)
        if name == "scale":
            self.scale = float(val)
        if name == "image_mean":
            self.name_meanimg = val
        if name == "crop_y_start":
            self.crop_y_start = int(val)
        if name == "crop_x_start":
            self.crop_x_start = int(val)
        if name == "rand_mirror":
            self.rand_mirror = int(val)
        if name == "mirror":
            self.mirror = int(val)
        if name == "max_random_contrast":
            self.max_random_contrast = float(val)
        if name == "max_random_illumination":
            self.max_random_illumination = float(val)
        if name == "mean_value":
            self.mean_b, self.mean_g, self.mean_r = \
                (float(x) for x in val.split(","))
        if name == "output_uint8":
            self.output_uint8 = int(val)
        self.aug.set_param(name, val)

    def init(self):
        self.base.init()
        if self.output_uint8:
            assert not self.name_meanimg, \
                "output_uint8 cannot defer a mean *image*; use " \
                "mean_value/input_mean_value or drop output_uint8"
            assert self.max_random_contrast == 0.0 and \
                self.max_random_illumination == 0.0, \
                "output_uint8 does not support random contrast/illumination"
            assert self.mean_r == self.mean_g == self.mean_b == 0.0, \
                "with output_uint8, move mean_value to the global " \
                "input_mean_value key (subtracted on device)"
            assert self.scale == 1.0, \
                "with output_uint8, move divideby/scale to the global " \
                "input_divideby/input_scale key (applied on device)"
        self.meanfile_ready = False
        self.meanimg = None
        if self.name_meanimg:
            ready = False
            if os.path.exists(self.name_meanimg):
                with open(self.name_meanimg, "rb") as f:
                    ready = f.read(len(self._MEAN_MAGIC)) == self._MEAN_MAGIC
                if not ready:
                    print("mean image %s predates the versioned "
                          "format; regenerating" % self.name_meanimg)
            # every rank of a world takes rank 0's finding: a rank that
            # found the file rank 0 was writing would skip the mean's
            # augmented pass, and its draws would part from the others'
            from ..parallel.multihost import rank0_value
            if rank0_value(ready):
                with open(self.name_meanimg, "rb") as f:
                    f.read(len(self._MEAN_MAGIC))
                    self.meanimg = serializer.Reader(f).read_tensor()
                self.meanfile_ready = True
                if self.silent == 0:
                    print("loading mean image from %s" % self.name_meanimg)
            else:
                self._create_mean_img()

    def before_first(self):
        if self._rng_resume is not None:
            self.rnd.set_state(self._rng_resume)
            self._rng_resume = None
        self._epoch_rng = self.rnd.get_state()
        self.base.before_first()

    def epoch_rng_state(self, mid_epoch: bool) -> dict:
        st = self._epoch_rng if mid_epoch and self._epoch_rng is not None \
            else self.rnd.get_state()
        _, keys, pos, has_gauss, gauss = st
        out = dict(self.base.epoch_rng_state(mid_epoch))
        out["augment"] = [[int(k) for k in keys], int(pos), int(has_gauss),
                          float(gauss)]
        return out

    def set_epoch_rng_state(self, state: dict) -> None:
        self.base.set_epoch_rng_state(state)
        if "augment" in state:
            keys, pos, has_gauss, gauss = state["augment"]
            self._rng_resume = ("MT19937", np.asarray(keys, np.uint32),
                                int(pos), int(has_gauss), float(gauss))

    def _set_data(self, d: DataInst):
        data = self.aug.process(d.data, self.rnd)
        c, th, tw = self.shape
        if th == 1:
            img = data.reshape(data.shape[0], 1, -1) if data.ndim == 3 \
                else data
            if self.output_uint8:
                self.out = DataInst(self._to_uint8(img), d.label, d.index)
                return
            out = img * self.scale
            self.out = DataInst(out.astype(np.float32), d.label, d.index)
            return
        assert data.shape[1] >= th and data.shape[2] >= tw, \
            "Data size must be bigger than the input size to net."
        yy = data.shape[1] - th
        xx = data.shape[2] - tw
        if self.rand_crop != 0 and (yy != 0 or xx != 0):
            yy = self.rnd.randint(0, yy + 1)
            xx = self.rnd.randint(0, xx + 1)
        else:
            yy //= 2
            xx //= 2
        if data.shape[1] != th and self.crop_y_start != -1:
            yy = self.crop_y_start
        if data.shape[2] != tw and self.crop_x_start != -1:
            xx = self.crop_x_start
        contrast = (self.rnd.rand() * self.max_random_contrast * 2
                    - self.max_random_contrast + 1)
        illumination = (self.rnd.rand() * self.max_random_illumination * 2
                        - self.max_random_illumination)
        do_mirror = (self.rand_mirror != 0 and self.rnd.rand() < 0.5) \
            or self.mirror == 1
        if self.mean_r > 0.0 or self.mean_g > 0.0 or self.mean_b > 0.0:
            base = data.copy()
            base[0] -= self.mean_b
            base[1] -= self.mean_g
            base[2] -= self.mean_r
            img = base[:, yy: yy + th, xx: xx + tw] * contrast + illumination
        elif not self.meanfile_ready or not self.name_meanimg:
            img = data[:, yy: yy + th, xx: xx + tw].astype(np.float32)
        elif data.shape == self.meanimg.shape:
            img = ((data - self.meanimg)[:, yy: yy + th, xx: xx + tw]
                   * contrast + illumination)
        else:
            img = ((data[:, yy: yy + th, xx: xx + tw] - self.meanimg)
                   * contrast + illumination)
        if do_mirror:
            img = img[:, :, ::-1]
        if self.output_uint8:
            self.out = DataInst(self._to_uint8(img), d.label, d.index)
            return
        self.out = DataInst(
            np.ascontiguousarray(img * self.scale, dtype=np.float32),
            d.label, d.index)

    def next(self) -> bool:
        if not self.base.next():
            return False
        self._set_data(self.base.value())
        return True

    def value(self) -> DataInst:
        return self.out

    def close(self) -> None:
        self.base.close()

    @staticmethod
    def _to_uint8(img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            np.clip(np.rint(img), 0, 255).astype(np.uint8))

    def _create_mean_img(self):
        """Compute and cache the dataset mean image (reference
        CreateMeanImg, iter_augment_proc-inl.hpp:171-198): the float64
        mean of one augmented pass's unscaled crops, stored as float32
        after the CXNMEAN2 magic in the JAX package's layout, so each
        package loads the other's file."""
        if self.silent == 0:
            print("cannot find %s: create mean image, this will take "
                  "some time..." % self.name_meanimg)
        self.base.before_first()
        mean = None
        cnt = 0
        saved_scale, self.scale = self.scale, 1.0
        try:
            while self.base.next():
                self._set_data(self.base.value())
                d = self.out.data
                if mean is None:
                    mean = d.astype(np.float64).copy()
                else:
                    mean += d
                cnt += 1
        finally:
            self.scale = saved_scale
        assert cnt > 0, "input iterator failed."
        self.meanimg = (mean / cnt).astype(np.float32)
        # every rank of a world computes the same mean; rank 0 alone
        # writes it
        from ..parallel.multihost import worker_shard_params
        if worker_shard_params()[1] == 0:
            parent = os.path.dirname(self.name_meanimg)
            if parent:
                os.makedirs(parent, exist_ok=True)
            # written whole, then renamed: a reader never sees half a file
            tmp = "%s.%d.tmp" % (self.name_meanimg, os.getpid())
            with open(tmp, "wb") as f:
                f.write(self._MEAN_MAGIC)
                serializer.Writer(f).write_tensor(self.meanimg)
            os.replace(tmp, self.name_meanimg)
            if self.silent == 0:
                print("save mean image to %s.." % self.name_meanimg)
        self.meanfile_ready = True
        self.base.before_first()


def create_image_base(kind: str) -> IIterator:
    """Image chains come wrapped Batch(Augment(reader)) (reference
    data.cpp:35-50)."""
    if kind in ("imgbin", "imgbinx"):
        page_it = ImagePageIterator()
        if kind == "imgbinx":
            # imgbinx is the pipelined variant: decode pool on by default
            page_it.decode_thread = 4
        return BatchAdaptIterator(AugmentIterator(page_it))
    if kind == "img":
        return BatchAdaptIterator(AugmentIterator(ImageIterator()))
    raise ValueError("unknown image iterator %s" % kind)
