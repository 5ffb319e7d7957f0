"""Integrity framing of model files: the framing and the read side of
cxxnet_tpu/utils/checkpoint.py (``frame``, ``split_footer``, ``verify_blob``,
``read_verified``), enough to load a CRC-framed model file that the JAX
package wrote, and ``write_framed`` to write one that it loads (a plain
write: the JAX package's atomic, retried write is not ported yet).

For serving: ``scan_checkpoints`` lists a model directory's
``<counter>.model`` files (the hot reload takes the newest one that
parses), ``backoff_delay`` is the shared exponential schedule of the
circuit breaker's cooldown, and ``PreemptionGuard`` turns SIGTERM / SIGINT
into a drain request. The emergency file, quarantine and retention are not
ported yet.

Framed files are ``CXCKHDR1 + payload + footer`` where the 20-byte footer is
``<IQ8s``: CRC32(payload), payload length, magic ``CXCKPT01``. A file without
the header is a legacy (unframed) model file and passes through as is.
"""

from __future__ import annotations

import os
import re
import signal
import struct
import zlib
from typing import List, Optional, Tuple

HEADER_MAGIC = b"CXCKHDR1"
FOOTER_MAGIC = b"CXCKPT01"

_FOOTER_FMT = "<IQ8s"   # crc32(payload), payload length, FOOTER_MAGIC
FOOTER_SIZE = struct.calcsize(_FOOTER_FMT)

_NAME_RE = re.compile(r"^(\d+)\.model$")


class CheckpointCorruptError(Exception):
    """The file's integrity framing does not validate (truncated / torn /
    bit-flipped). Callers must NOT fall back to loading the raw bytes."""


def crc32(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """Wrap a serialized model payload in the v1 integrity framing."""
    return (HEADER_MAGIC + payload
            + struct.pack(_FOOTER_FMT, crc32(payload), len(payload),
                          FOOTER_MAGIC))


def write_framed(path: str, payload: bytes) -> None:
    """Write ``payload`` to ``path`` inside the v1 integrity framing."""
    with open(path, "wb") as f:
        f.write(frame(payload))


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


def read_verified(path: str) -> Tuple[bytes, str]:
    """Read a model file and verify/strip its framing; raises
    CheckpointCorruptError (with the path in the message) when the framing
    does not validate."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        return split_footer(blob)
    except CheckpointCorruptError as e:
        raise CheckpointCorruptError("%s: %s" % (path, e)) from None


def backoff_delay(attempt: int, base_delay: float = 0.05,
                  cap: float = 30.0) -> float:
    """The shared exponential-backoff schedule: ``base_delay`` doubled
    per attempt, capped (cxxnet_tpu/utils/checkpoint.py:161). The serving
    frontend's circuit-breaker cooldown follows it."""
    return min(cap, base_delay * (2.0 ** max(0, int(attempt))))


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


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a cooperative request to stop
    (cxxnet_tpu/utils/checkpoint.py:354).

    While installed, the FIRST signal sets ``requested`` (``task = serve``
    polls it and drains) and immediately restores the previous handlers,
    so a second signal gets default handling: an operator can still
    hard-kill a hung drain. Installing outside the main thread is a silent
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
