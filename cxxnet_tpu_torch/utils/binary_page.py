"""BinaryPage: the reference's packed-image page format, byte-compatible.

Layout (reference: src/utils/io.h:254-327): a page is one fixed-size block of
``page_ints`` int32 little-endian words (reference kPageSize = 64<<18 words =
64 MiB). Word 0 is the object count n; words 1..n+1 are cumulative object
sizes (word 1 is always 0); object r's bytes occupy
``[page_bytes - cum[r+1], page_bytes - cum[r])`` — payloads pack backward
from the end of the page.

page_ints is parameterizable here (tests use small pages); the default is the
reference's constant, and files written with it are interchangeable with
im2bin output.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional

KPAGE_INTS = 64 << 18  # reference kPageSize (number of int32 words)


class BinaryPage:
    def __init__(self, page_ints: int = KPAGE_INTS):
        self.page_ints = page_ints
        self.page_bytes = page_ints * 4
        self.clear()

    def clear(self) -> None:
        self.objs: List[bytes] = []
        self.used_payload = 0

    def size(self) -> int:
        return len(self.objs)

    def _free_bytes(self) -> int:
        return (self.page_ints - (len(self.objs) + 2)) * 4 - self.used_payload

    def push(self, data: bytes) -> bool:
        """Append one object; False if the page is full (reference Push)."""
        if self._free_bytes() < len(data) + 4:
            return False
        self.objs.append(bytes(data))
        self.used_payload += len(data)
        return True

    def __getitem__(self, r: int) -> bytes:
        return self.objs[r]

    def save(self, f: BinaryIO) -> None:
        buf = bytearray(self.page_bytes)
        n = len(self.objs)
        struct.pack_into("<i", buf, 0, n)
        cum = 0
        pos = 4  # word index 1
        struct.pack_into("<i", buf, pos, 0)
        for r, obj in enumerate(self.objs):
            cum += len(obj)
            struct.pack_into("<i", buf, 4 * (r + 2), cum)
            start = self.page_bytes - cum
            buf[start: start + len(obj)] = obj
        f.write(bytes(buf))

    @classmethod
    def load(cls, f: BinaryIO,
             page_ints: int = KPAGE_INTS) -> Optional["BinaryPage"]:
        raw = f.read(page_ints * 4)
        if len(raw) < page_ints * 4:
            return None
        page = cls(page_ints)
        n = struct.unpack_from("<i", raw, 0)[0]
        cums = struct.unpack_from("<%di" % (n + 1), raw, 4)
        for r in range(n):
            start = page.page_bytes - cums[r + 1]
            end = page.page_bytes - cums[r]
            page.objs.append(raw[start:end])
            page.used_payload += end - start
        return page
