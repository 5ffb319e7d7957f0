"""Versioned framing for the port's exported serving artifacts: the port's
own copy of cxxnet_tpu/utils/artifact.py, with the same frame.

The reference versions its model blobs so that a stale file fails with a
message instead of undefined behaviour (src/nnet/nnet_config.h:126-145). The
serving artifacts (``Trainer.export_forward`` / ``export_decode``) bake in a
cache-layout contract (``_decode_cache_specs``) that can change between
versions of the port, so they get the same guard: a fixed magic, a format
version, and a JSON header with the artifact kind and a fingerprint of the
layout contract. Loaders fail with a message of the port on a mismatch
instead of whatever ``torch.export.load`` does with alien bytes.

Frame layout: b"CXTF" | uint32 version | uint32 header_len |
header JSON (utf-8) | payload (``torch.export.save`` of the program).
"""

import hashlib
import json
import struct

MAGIC = b"CXTF"
VERSION = 1


def frame(kind: str, meta: dict, payload: bytes) -> bytes:
    header = dict(meta)
    header["kind"] = kind
    hb = json.dumps(header, sort_keys=True).encode("utf-8")
    return MAGIC + struct.pack("<II", VERSION, len(hb)) + hb + payload


def unframe(data: bytes, expect_kind: str):
    """-> (meta, payload); raises ValueError with a message of the port on
    any mismatch (wrong magic / future version / wrong artifact kind /
    truncated frame)."""
    if len(data) < 12 or data[:4] != MAGIC:
        raise ValueError(
            "not a cxxnet_tpu_torch serving artifact (bad magic): this file "
            "is either corrupt or a pre-versioning export — re-export it "
            "with this version of the port")
    version, hlen = struct.unpack("<II", data[4:12])
    if version > VERSION:
        raise ValueError(
            "serving artifact format v%d is newer than this framework "
            "supports (v%d): upgrade cxxnet_tpu_torch or re-export"
            % (version, VERSION))
    if len(data) < 12 + hlen:
        raise ValueError("serving artifact truncated (header)")
    try:
        meta = json.loads(data[12:12 + hlen].decode("utf-8"))
    except ValueError:
        raise ValueError("serving artifact header is not valid JSON "
                         "(corrupt file)")
    kind = meta.get("kind")
    if kind != expect_kind:
        raise ValueError(
            "serving artifact kind mismatch: file holds %r, loader "
            "expects %r (did you swap the prefill/step files?)"
            % (kind, expect_kind))
    return meta, data[12 + hlen:]


def cache_fingerprint(cache_keys, cache_shapes, cache_dtype) -> str:
    """Stable digest of the decode cache-layout contract: the prefill and
    step artifacts of one export share it, and a loader refuses to pair
    artifacts whose layouts disagree. The dtype has one spelling whatever
    names it (``torch.bfloat16`` and ``"bfloat16"`` both read
    ``bfloat16``)."""
    desc = repr((list(cache_keys),
                 [tuple(int(d) for d in sh) for sh in cache_shapes],
                 str(cache_dtype).replace("torch.", "")))
    return hashlib.sha1(desc.encode("utf-8")).hexdigest()
