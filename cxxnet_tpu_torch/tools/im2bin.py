"""im2bin: pack an image list into BinaryPage bins (reference
tools/im2bin.cpp), the port's twin of tools/im2bin.py on the port's
utils/binary_page.py; the files are byte for byte the JAX tool's.

Usage:
    python -m cxxnet_tpu_torch.tools.im2bin <image.lst> <image_root> \
        <out.bin> [page_ints]

Reads lines of ``index label[ label..] filename`` from the list and appends
each image file's raw bytes as one object per record into fixed-size
BinaryPages (the default page size is the reference's 64 MiB).
"""

from __future__ import annotations

import os
import sys

from ..utils.binary_page import KPAGE_INTS, BinaryPage


def im2bin(lst_path: str, image_root: str, out_path: str,
           page_ints: int = KPAGE_INTS) -> int:
    """Pack the list's images into ``out_path``; returns the count."""
    count = 0
    with open(out_path, "wb") as fo:
        page = BinaryPage(page_ints)
        with open(lst_path) as f:
            for line in f:
                if not line.strip():
                    continue
                fname = line.split()[-1]
                path = os.path.join(image_root, fname) if image_root \
                    else fname
                with open(path, "rb") as fimg:
                    data = fimg.read()
                if not page.push(data):
                    page.save(fo)
                    page.clear()
                    if not page.push(data):
                        raise ValueError("image %s larger than a page"
                                         % fname)
                count += 1
        if page.size():
            page.save(fo)
    return count


def main(argv) -> int:
    if len(argv) < 4:
        print(__doc__)
        return 1
    pi = int(argv[4]) if len(argv) > 4 else KPAGE_INTS
    n = im2bin(argv[1], argv[2], argv[3], pi)
    print("packed %d images into %s" % (n, argv[3]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
