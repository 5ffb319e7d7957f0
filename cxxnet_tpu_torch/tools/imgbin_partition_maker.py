"""Shard an imgbin corpus (.lst + .bin) into N worker partitions: the
port's twin of tools/imgbin_partition_maker.py on the port's
utils/binary_page.py; the shards are byte for byte the JAX tool's.

Counterpart of the reference's tools/imgbin-partition-maker.py (which
emitted a Makefile re-packing an image list into per-worker shards,
reference: src/io/iter_thread_imbin-inl.hpp:189-220). Records are split
into contiguous blocks: partition i gets ``out_prefix%i.lst`` +
``out_prefix%i.bin``, readable by the imgbin / imgbinx iterators with
``image_conf_prefix=out_prefix`` and ``image_conf_ids=0-<n-1>``.

Usage:
    python -m cxxnet_tpu_torch.tools.imgbin_partition_maker <in.lst> \
        <in.bin> <npart> <out_prefix> [page_ints]
"""

from __future__ import annotations

import sys

from ..utils.binary_page import KPAGE_INTS, BinaryPage


def partition(lst_path: str, bin_path: str, npart: int, out_prefix: str,
              page_ints: int = KPAGE_INTS) -> int:
    """Split the records contiguously: partition i gets records
    [i*ceil(n/npart), (i+1)*ceil(n/npart)), the iterators' contiguous rank
    sharding of multi-part lists. Returns the record count."""
    with open(lst_path) as f:
        lines = [ln for ln in f if ln.strip()]
    n = len(lines)
    step = (n + npart - 1) // npart
    with open(bin_path, "rb") as fbin:
        page, ptop = None, 0

        def next_obj():
            nonlocal page, ptop
            while page is None or ptop >= page.size():
                page = BinaryPage.load(fbin, page_ints)
                if page is None:
                    raise ValueError("%s ends before its list %s"
                                     % (bin_path, lst_path))
                ptop = 0
            obj = page[ptop]
            ptop += 1
            return obj

        for i in range(npart):
            lo, hi = min(i * step, n), min((i + 1) * step, n)
            with open((out_prefix % i) + ".lst", "w") as fl:
                fl.writelines(lines[lo:hi])
            with open((out_prefix % i) + ".bin", "wb") as fo:
                opage = BinaryPage(page_ints)
                for _ in range(lo, hi):
                    data = next_obj()
                    if not opage.push(data):
                        opage.save(fo)
                        opage.clear()
                        if not opage.push(data):
                            raise ValueError("record larger than a page")
                if opage.size():
                    opage.save(fo)
    return n


def main(argv) -> int:
    if len(argv) < 5:
        print(__doc__)
        return 1
    lst, binf, npart, prefix = argv[1], argv[2], int(argv[3]), argv[4]
    page_ints = int(argv[5]) if len(argv) > 5 else KPAGE_INTS
    if "%" not in prefix:
        prefix += "_%d"
    n = partition(lst, binf, npart, prefix, page_ints)
    print("partitioned %d records into %d shards at %s" % (n, npart, prefix))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
