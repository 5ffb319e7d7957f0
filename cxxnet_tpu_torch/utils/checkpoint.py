"""Integrity framing of model files: the framing and the read side of
cxxnet_tpu/utils/checkpoint.py (``frame``, ``split_footer``, ``verify_blob``,
``read_verified``), enough to load a CRC-framed model file that the JAX
package wrote, and ``write_framed`` to write one that it loads (a plain
write: the JAX package's atomic, retried write is not ported yet).

Framed files are ``CXCKHDR1 + payload + footer`` where the 20-byte footer is
``<IQ8s``: CRC32(payload), payload length, magic ``CXCKPT01``. A file without
the header is a legacy (unframed) model file and passes through as is.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

HEADER_MAGIC = b"CXCKHDR1"
FOOTER_MAGIC = b"CXCKPT01"

_FOOTER_FMT = "<IQ8s"   # crc32(payload), payload length, FOOTER_MAGIC
FOOTER_SIZE = struct.calcsize(_FOOTER_FMT)


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
