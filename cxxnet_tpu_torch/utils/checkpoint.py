"""Preemption-tolerant checkpoint IO of the port: the JAX package's
cxxnet_tpu/utils/checkpoint.py (its own copy: the port imports nothing of
``cxxnet_tpu``).

* **durable atomic writes** — ``atomic_write`` puts the bytes in
  ``<name>.tmp``, fsyncs it, renames it over the final name and fsyncs
  the directory, so a kill or a failed write at any point leaves either
  the old file or the new one, never a torn one; transient OS errors
  retry with exponential backoff (``retry_io``). ``write_checkpoint``
  frames a payload and writes it so.
* **integrity framing** — ``CXCKHDR1 + payload + footer`` where the
  20-byte footer is ``<IQ8s``: CRC32(payload), payload length, magic
  ``CXCKPT01``. A file without the header is a legacy (unframed) model
  file and passes through as is; ``read_verified`` checks the rest.
* **training state** — ``STATE_MAGIC`` opens the section the trainer
  appends (rng counter, accumulators, the learn task's cursor);
  ``peek_state`` reads its metadata without building a net.

Standard library only.
* **recovery helpers** — ``scan_checkpoints`` lists a model directory's
  ``<counter>.model`` files (gaps fine), ``quarantine`` moves a corrupt
  file to ``<name>.corrupt`` (telemetry event ``ckpt_corrupt``),
  ``gc_stale_tmp`` removes the leftovers of dead writers, and
  ``apply_retention`` keeps the newest ``keep_last`` files plus every
  ``keep_every``-th. ``EMERGENCY_NAME`` is the mid-round file of a
  preempted run.
* **preemption** — ``PreemptionGuard`` turns the first SIGTERM / SIGINT
  into a request to checkpoint and stop (training) or to drain (serving);
  a second signal falls through to the default handler.
"""

from __future__ import annotations

import errno
import json
import os
import re
import signal
import struct
import sys
import time
import zlib
from typing import List, Optional, Tuple

from . import telemetry

HEADER_MAGIC = b"CXCKHDR1"
FOOTER_MAGIC = b"CXCKPT01"
# magic of the training-state section the trainer appends INSIDE the
# payload, after the model and optimizer sections
STATE_MAGIC = b"CXTSTA01"

_FOOTER_FMT = "<IQ8s"   # crc32(payload), payload length, FOOTER_MAGIC
FOOTER_SIZE = struct.calcsize(_FOOTER_FMT)

_NAME_RE = re.compile(r"^(\d+)\.model$")
EMERGENCY_NAME = "emergency.model"


class CheckpointError(Exception):
    """Base class for checkpoint IO failures."""


class CheckpointCorruptError(CheckpointError):
    """The file's integrity framing does not validate (truncated / torn /
    bit-flipped). Callers must NOT fall back to loading the raw bytes."""


def crc32(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """Wrap a serialized model payload in the v1 integrity framing."""
    return (HEADER_MAGIC + payload
            + struct.pack(_FOOTER_FMT, crc32(payload), len(payload),
                          FOOTER_MAGIC))


def split_footer(blob: bytes) -> Tuple[bytes, str]:
    """Strip and verify the integrity framing. Returns ``(payload, fmt)``
    with fmt ``"v1"`` (framed, CRC verified) or ``"legacy"`` (unframed,
    returned as is); raises CheckpointCorruptError when the framing is
    present but inconsistent."""
    has_header = blob.startswith(HEADER_MAGIC)
    body = blob[len(HEADER_MAGIC):] if has_header else blob
    if len(body) >= FOOTER_SIZE and body.endswith(FOOTER_MAGIC):
        crc, plen, _ = struct.unpack(_FOOTER_FMT, body[-FOOTER_SIZE:])
        payload = body[:-FOOTER_SIZE]
        if plen != len(payload):
            raise CheckpointCorruptError(
                "footer declares %d payload bytes but %d are present "
                "(truncated or torn write)" % (plen, len(payload)))
        actual = crc32(payload)
        if actual != crc:
            raise CheckpointCorruptError(
                "CRC mismatch: footer %08x != payload %08x (bit "
                "corruption)" % (crc, actual))
        return payload, "v1"
    if has_header:
        raise CheckpointCorruptError(
            "header magic present but footer missing or invalid "
            "(truncated / torn write)")
    return blob, "legacy"


def verify_blob(blob: bytes):
    """Classify checkpoint bytes without raising: returns
    ``(status, reason, payload_or_None)`` with status ``ok``, ``legacy`` or
    ``corrupt``."""
    try:
        payload, fmt = split_footer(blob)
    except CheckpointCorruptError as e:
        return "corrupt", str(e), None
    return ("ok" if fmt == "v1" else "legacy"), "", payload


def peek_state(payload: bytes) -> Optional[dict]:
    """The training-state metadata dict (round counter, batch cursor, rng
    counter, ...) of a verified payload, read without building the net;
    None without a state section. The section is the payload's last, so a
    hit must end exactly at the payload's end: a spurious occurrence of
    the magic inside tensor data fails that length check."""
    end = len(payload)
    i = payload.rfind(STATE_MAGIC)
    while i >= 0:
        try:
            # uint64 section length, then the meta as a uint64-length
            # string (the serializer's encodings)
            at = i + len(STATE_MAGIC)
            (nbytes,) = struct.unpack_from("<Q", payload, at)
            if at + 8 + nbytes == end:
                (n,) = struct.unpack_from("<Q", payload, at + 8)
                meta = json.loads(bytes(payload[at + 16: at + 16 + n])
                                  .decode("utf-8"))
                if isinstance(meta, dict):
                    return meta
        except Exception:
            pass
        i = payload.rfind(STATE_MAGIC, 0, i)
    return None


# OSErrors that no retry fixes fail at once: a mistyped path surfaces
# immediately and does not count as a flaky-mount retry
_NON_TRANSIENT_ERRNO = frozenset(
    e for e in (errno.ENOENT, errno.EISDIR, errno.ENOTDIR) if e is not None)


def backoff_delay(attempt: int, base_delay: float = 0.05,
                  cap: float = 30.0) -> float:
    """The shared exponential-backoff schedule: ``base_delay`` doubled
    per attempt, capped. ``retry_io`` and the serving frontend's
    circuit-breaker cooldown follow it."""
    return min(cap, base_delay * (2.0 ** max(0, int(attempt))))


def retry_io(fn, retries: int = 2, base_delay: float = 0.05,
             retriable=(OSError,)):
    """Run ``fn`` with exponential-backoff retries on transient IO errors
    (flaky NFS / fuse mounts). ``retries`` counts the RE-tries; the last
    failure re-raises; permanent errors (missing path, not a file) are
    never retried."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except retriable as e:
            if getattr(e, "errno", None) in _NON_TRANSIENT_ERRNO \
                    or attempt >= retries:
                raise
            telemetry.count("ckpt.io_retry")
            time.sleep(backoff_delay(attempt, base_delay))


def _fsync_dir(dirname: str) -> None:
    """fsync the directory entry so that the rename itself is durable;
    best effort (some filesystems cannot open a directory)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data, fsync: bool = True,
                 retries: int = 2, base_delay: float = 0.05) -> None:
    """Write ``data`` (bytes, or a sequence of byte-like chunks written in
    order) to ``path`` atomically: tmp file, fsync, rename. A failure at
    any instant leaves the previous contents of ``path`` or the complete
    new ones, never a partial file; the tmp file is removed on failure,
    and transient OSErrors retry with backoff."""
    tmp = path + ".tmp"
    chunks = data if isinstance(data, (list, tuple)) else (data,)

    def _once():
        try:
            with open(tmp, "wb") as f:
                for c in chunks:
                    f.write(c)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass
            raise
        if fsync:
            _fsync_dir(os.path.dirname(os.path.abspath(path)))

    retry_io(_once, retries=retries, base_delay=base_delay)


def write_checkpoint(path: str, payload, fsync: bool = True,
                     retries: int = 2, base_delay: float = 0.05) -> None:
    """Frame ``payload`` (bytes or memoryview) with the header and CRC
    footer and atomic-write it, without building the framed blob."""
    footer = struct.pack(_FOOTER_FMT, crc32(payload), len(payload),
                         FOOTER_MAGIC)
    atomic_write(path, (HEADER_MAGIC, payload, footer), fsync=fsync,
                 retries=retries, base_delay=base_delay)


def read_verified(path: str, retries: int = 0,
                  base_delay: float = 0.05) -> Tuple[bytes, str]:
    """Read a model file and verify/strip its framing; ``(payload, fmt)``.
    Raises CheckpointCorruptError (with the path in the message) when the
    framing does not validate; ``retries`` retries transient read
    errors."""
    def _read():
        with open(path, "rb") as f:
            return f.read()

    blob = retry_io(_read, retries=retries, base_delay=base_delay) \
        if retries > 0 else _read()
    try:
        return split_footer(blob)
    except CheckpointCorruptError as e:
        raise CheckpointCorruptError("%s: %s" % (path, e)) from None


def scan_checkpoints(model_dir: str) -> List[Tuple[int, str]]:
    """All ``<counter>.model`` files in ``model_dir``, sorted ascending by
    counter; gaps in the numbering (save_period > 1) are fine."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(model_dir)
    except OSError:
        return out
    for nm in names:
        m = _NAME_RE.match(nm)
        if m:
            out.append((int(m.group(1)), os.path.join(model_dir, nm)))
    out.sort()
    return out


def quarantine(path: str, reason: str = "") -> Optional[str]:
    """Move a corrupt checkpoint aside to ``<path>.corrupt`` (kept for
    forensics, never deleted) and emit the ``ckpt_corrupt`` telemetry
    event. Returns the new path, or None when the move failed."""
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = "%s.corrupt.%d" % (path, n)
    try:
        os.replace(path, dst)
    except OSError:
        return None
    telemetry.event({"ev": "ckpt_corrupt", "path": path,
                     "reason": str(reason)[:300], "quarantined_to": dst})
    sys.stderr.write("WARNING: corrupt checkpoint %s (%s) quarantined "
                     "to %s\n" % (path, reason, dst))
    return dst


def gc_stale_tmp(model_dir: str) -> List[str]:
    """Remove ``*.tmp`` leftovers of writes that died before their rename.
    Call only from the single live writer of ``model_dir``."""
    removed = []
    try:
        names = os.listdir(model_dir)
    except OSError:
        return removed
    for nm in names:
        if nm.endswith(".tmp"):
            p = os.path.join(model_dir, nm)
            try:
                os.remove(p)
                removed.append(p)
            except OSError:
                pass
    if removed:
        telemetry.event({"ev": "ckpt_gc_tmp", "removed": len(removed)})
    return removed


def apply_retention(model_dir: str, keep_last: int = 0,
                    keep_every: int = 0, protect=()) -> List[str]:
    """Delete old numbered checkpoints: keep the newest ``keep_last``,
    every counter divisible by ``keep_every`` (long-horizon anchors) and
    anything in ``protect``. ``keep_last <= 0`` keeps everything."""
    if keep_last <= 0:
        return []
    ckpts = scan_checkpoints(model_dir)
    keep = {c for c, _ in ckpts[-keep_last:]}
    if keep_every > 0:
        keep |= {c for c, _ in ckpts if c % keep_every == 0}
    keep |= set(protect)
    removed = []
    for c, p in ckpts:
        if c in keep:
            continue
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    if removed:
        telemetry.event({"ev": "ckpt_retention", "removed": len(removed),
                         "keep_last": keep_last, "keep_every": keep_every})
    return removed


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a cooperative request to stop.

    While installed, the FIRST signal sets ``requested`` (the train loop
    checks it at step boundaries, writes one emergency checkpoint and
    exits cleanly; ``task = serve`` drains) and restores the previous
    handlers, so a second signal gets default handling: an operator can
    still hard-kill a hung save or drain. Installing outside the main thread is a silent
    no-op (``signal.signal`` is main-thread-only); ``enabled=False``
    builds an inert guard so call sites need no branching."""

    def __init__(self, signals=None, enabled: bool = True):
        self.signals = tuple(signals) if signals is not None else \
            (signal.SIGTERM, signal.SIGINT)
        self.enabled = enabled
        self.requested = False
        self.signum: Optional[int] = None
        self._old = {}

    def __enter__(self) -> "PreemptionGuard":
        if not self.enabled:
            return self
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._handle)
        except ValueError:        # not the main thread
            self._restore()
        return self

    def _handle(self, signum, frame) -> None:
        # async-signal-safe by construction: ONLY set flags; the loop that
        # polls ``requested`` does the rest
        self.requested = True
        self.signum = int(signum)
        self._restore()

    def _restore(self) -> None:
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._old = {}

    def __exit__(self, *exc) -> bool:
        self._restore()
        return False
