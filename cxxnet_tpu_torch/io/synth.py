"""Synthetic image data for the image iterators, made from a seed with
numpy: binary PPM records, a .lst label file and a BinaryPage pack, the
layout that tools/im2bin.py writes for the JAX package. Nothing is
downloaded.

    python -m cxxnet_tpu_torch.io.synth <dir> <name> <n> <hw> <n_class> [seed]

writes ``<dir>/<name>.lst`` and ``<dir>/<name>.bin`` (n images of hw x hw,
labels ``i % n_class``, each class a color of its own under noise).
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Tuple

import numpy as np

from ..utils.binary_page import KPAGE_INTS, BinaryPage


def ppm_bytes(img: np.ndarray) -> bytes:
    """A binary PPM (P6, maxval 255) of an (h, w, 3) uint8 RGB image, or a
    PGM (P5) of an (h, w) one."""
    img = np.ascontiguousarray(img, np.uint8)
    magic = b"P6" if img.ndim == 3 else b"P5"
    h, w = img.shape[:2]
    return b"%s\n%d %d\n255\n" % (magic, w, h) + img.tobytes()


def images(n: int, hw: int, n_class: int,
           seed: int = 0) -> Iterable[Tuple[int, np.ndarray]]:
    """(label, (hw, hw, 3) uint8 RGB) for image i = 0 .. n-1: label
    i % n_class, the class's color in [0, 176) plus uniform noise in
    [0, 80)."""
    rs = np.random.RandomState(seed)
    colors = rs.randint(0, 176, (n_class, 3), dtype=np.uint8)
    for i in range(n):
        label = i % n_class
        yield label, colors[label] + rs.randint(0, 80, (hw, hw, 3),
                                                dtype=np.uint8)


def write_pack(records: Iterable[Tuple[int, bytes]], lst_path: str,
               bin_path: str, page_ints: int = KPAGE_INTS) -> int:
    """Pack (label, record bytes) pairs into ``bin_path`` as BinaryPages
    and list them in ``lst_path`` as ``index label name``; returns the
    count."""
    n = 0
    page = BinaryPage(page_ints)
    with open(bin_path, "wb") as fo, open(lst_path, "w") as lst:
        for label, rec in records:
            if not page.push(rec):
                page.save(fo)
                page.clear()
                if not page.push(rec):
                    raise ValueError("record %d (%d bytes) larger than a "
                                     "page" % (n, len(rec)))
            lst.write("%d %d img_%05d.ppm\n" % (n, label, n))
            n += 1
        if page.size():
            page.save(fo)
    return n


def make_ppm_pack(dirname: str, name: str, n: int, hw: int, n_class: int,
                  seed: int = 0, page_ints: int = KPAGE_INTS
                  ) -> Tuple[str, str]:
    """``images`` as a PPM pack ``<dirname>/<name>.lst`` + ``.bin``;
    returns the two paths."""
    os.makedirs(dirname, exist_ok=True)
    lst = os.path.join(dirname, name + ".lst")
    binp = os.path.join(dirname, name + ".bin")
    write_pack(((lab, ppm_bytes(img))
                for lab, img in images(n, hw, n_class, seed)),
               lst, binp, page_ints)
    return lst, binp


if __name__ == "__main__":
    if len(sys.argv) < 6:
        print(__doc__)
        sys.exit(1)
    a = sys.argv[1:]
    paths = make_ppm_pack(a[0], a[1], int(a[2]), int(a[3]), int(a[4]),
                          int(a[5]) if len(a) > 5 else 0)
    print("wrote %s and %s" % paths)
