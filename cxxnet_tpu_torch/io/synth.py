"""Synthetic image data for the image iterators, made from a seed with
numpy: binary PPM or baseline JPEG records, a .lst label file and a
BinaryPage pack, the layout that tools/im2bin.py writes for the JAX
package. Nothing is downloaded, and no image library is needed: the JPEG
encoder here (``jpeg_bytes``) is numpy's, for making test data on machines
without an encoder, not for users.

    python -m cxxnet_tpu_torch.io.synth <dir> <name> <n> <hw> <n_class> \
        [seed] [jpeg]

writes ``<dir>/<name>.lst`` and ``<dir>/<name>.bin`` (n images of hw x hw,
labels ``i % n_class``, each class a color of its own under noise; JPEG
records at quality 90, 4:2:0, with ``jpeg`` as the last argument).
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


# ITU T.81 Annex K: the example quantization tables (natural order) and
# Huffman tables (bits[1..16], values)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] +
    [99] * 32)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "0001020311040521310612415107617113223281081442" "91a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
_C = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG quality rule (jcparam.c jpeg_quality_scaling) on an Annex K
    table, clamped to baseline's 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huff_codes(table):
    """(code, length) arrays indexed by symbol, canonical from bits."""
    bits, vals = table
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]] = c
            size[vals[k]] = length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v).astype(np.int64)
    cat = np.zeros_like(a)
    while np.any(a >> cat):
        cat += (a >> cat) > 0
    return cat


def _pack_bits(vals: np.ndarray, nbits: np.ndarray,
               seg: np.ndarray) -> list:
    """The codes (nbits bits each, MSB first) of each segment ``seg``
    (ascending) packed into bytes, each segment padded with 1 bits to a
    whole byte and its 0xFF bytes stuffed with 0x00; one bytes per
    segment."""
    nseg = int(seg[-1]) + 1
    seg_bits = np.bincount(seg, nbits, nseg).astype(np.int64)
    pad = (-seg_bits) % 8
    # a padding code after each segment's last code
    at = np.searchsorted(seg, np.arange(nseg), side="right")
    vals = np.insert(vals, at, (1 << pad) - 1)
    nbits = np.insert(nbits, at, pad)
    total = int(nbits.sum())
    starts = np.cumsum(nbits) - nbits
    # each code (at most 32 bits) lands in the 5 bytes from its first one:
    # its bits aligned there, the bytes summed (codes share no bit)
    chunk = vals << (40 - (starts & 7) - nbits)
    idx = (starts >> 3)[:, None] + np.arange(5)
    part = (chunk[:, None] >> (32 - 8 * np.arange(5))) & 0xFF
    data = np.bincount(idx.ravel(), part.ravel(),
                       total // 8 + 5)[:total // 8].astype(np.uint8)
    ends = np.cumsum((seg_bits + pad) // 8)
    out = []
    for part in np.split(data, ends[:-1]):
        ff = np.nonzero(part == 0xFF)[0]
        out.append(np.insert(part, ff + 1, 0).tobytes())
    return out


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows, cols, 8, 8) blocks of a plane whose sides are multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def jpeg_bytes(img: np.ndarray, quality: int = 90,
               subsampling: str = "420", restart: int = 0) -> bytes:
    """A baseline JFIF stream of an (h, w, 3) uint8 RGB image (YCbCr, chroma
    ``subsampling`` "444" or "420") or an (h, w) gray one, with the Annex K
    tables, the quantization scaled by the IJG quality rule, and a restart
    marker every ``restart`` MCUs (0: none)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
        samp = [(1, 1)]
    else:
        rgb = img.astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        if subsampling == "444":
            samp = [(1, 1)] * 3
        elif subsampling == "420":
            samp = [(2, 2), (1, 1), (1, 1)]
        else:
            raise ValueError("subsampling must be 444 or 420, not %r"
                             % subsampling)
    hmax, vmax = samp[0]
    mh, mw = 8 * vmax, 8 * hmax
    ph, pw = -(-h // mh) * mh, -(-w // mw) * mw
    qtabs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    comps = []   # (blocks in MCU order (mcu, block, 64 zigzag), table)
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, samp)):
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        if (hs, vs) != (hmax, vmax):   # 2x2 box average
            plane = plane.reshape(ph // 2, 2, pw // 2, 2).mean((1, 3))
        blk = _blocks(plane - 128.0)
        coef = _C @ blk @ _C.T
        q = qtabs[min(ci, 1)].reshape(8, 8)
        zz = np.round(coef / q).astype(np.int64).reshape(
            blk.shape[0], blk.shape[1], 64)[..., _ZIGZAG]
        # blocks of each MCU: vs rows by hs columns, raster order
        rows, cols = blk.shape[0] // vs, blk.shape[1] // hs
        zz = zz.reshape(rows, vs, cols, hs, 64).transpose(0, 2, 1, 3, 4)
        comps.append(zz.reshape(rows * cols, vs * hs, 64))
    n_mcu = comps[0].shape[0]
    zz = np.concatenate(comps, axis=1)              # (mcu, blocks, 64)
    per_mcu = zz.shape[1]
    comp = np.concatenate([np.full(c.shape[1], i) for i, c in
                           enumerate(comps)])
    zz = zz.reshape(-1, 64)
    block_comp = np.tile(comp, n_mcu)
    block_mcu = np.repeat(np.arange(n_mcu), per_mcu)
    # DC differences, the predictor reset at each restart interval
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in range(len(comps)):
        sel = np.nonzero(block_comp == c)[0]
        d = dc[sel]
        prev = np.concatenate([[0], d[:-1]])
        mcu = block_mcu[sel]
        first = np.concatenate([[True], mcu[1:] != mcu[:-1]])
        if restart:
            prev[first & (mcu % restart == 0)] = 0
        diff[sel] = d - prev
    dc_codes = [_huff_codes(_DC_LUMA), _huff_codes(_DC_CHROMA)]
    ac_codes = [_huff_codes(_AC_LUMA), _huff_codes(_AC_CHROMA)]
    tsel = np.minimum(block_comp, 1)
    ev_block, ev_key, ev_val, ev_len = [], [], [], []

    def emit(blocks, key, val, length):
        ev_block.append(blocks)
        ev_key.append(key)
        ev_val.append(val)
        ev_len.append(length)

    def code(tables, t, sym):
        c = np.where(t == 0, tables[0][0][sym], tables[1][0][sym])
        n = np.where(t == 0, tables[0][1][sym], tables[1][1][sym])
        return c, n

    nb = np.arange(len(zz))
    cat = _category(diff)
    c, n = code(dc_codes, tsel, cat)
    mag = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    emit(nb, np.zeros_like(nb), (c << cat) | mag, n + cat)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    start = np.concatenate([[True], b[1:] != b[:-1]])
    prevk = np.where(start, 0, np.concatenate([[0], k[:-1]]))
    run = k - prevk - 1
    nzrl = run // 16
    zb = np.repeat(b, nzrl)
    zc, zn = code(ac_codes, tsel[zb], np.full(len(zb), 0xF0))
    emit(zb, np.repeat(2 * k, nzrl), zc, zn)
    cat = _category(v)
    c, n = code(ac_codes, tsel[b], (run % 16) * 16 + cat)
    mag = np.where(v < 0, v + (1 << cat) - 1, v)
    emit(b, 2 * k + 1, (c << cat) | mag, n + cat)
    last = np.zeros(len(zz), np.int64)
    last[b] = k                      # k ascends within a block
    eb = np.nonzero(last < 63)[0]
    c, n = code(ac_codes, tsel[eb], np.zeros(len(eb), np.int64))
    emit(eb, np.full(len(eb), 200), c, n)
    ev_block = np.concatenate(ev_block)
    order = np.lexsort((np.concatenate(ev_key), ev_block))
    ev_block = ev_block[order]
    ev_val = np.concatenate(ev_val)[order]
    ev_len = np.concatenate(ev_len)[order]
    seg = block_mcu[ev_block] // restart if restart else \
        np.zeros(len(ev_block), np.int64)
    parts = _pack_bits(ev_val, ev_len, seg)
    data = parts[0]
    for i, part in enumerate(parts[1:]):
        data += bytes([0xFF, 0xD0 + i % 8]) + part

    def segment(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + body

    out = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                       b"\x00\x01\x00\x00")
    for t in range(min(len(comps), 2)):
        out += segment(0xDB, bytes([t]) + bytes(
            qtabs[t][_ZIGZAG].astype(np.uint8)))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([len(comps)])
    for i, (hs, vs) in enumerate(samp):
        sof += bytes([i + 1, hs * 16 + vs, min(i, 1)])
    out += segment(0xC0, sof)
    for cls, tables in ((0, (_DC_LUMA, _DC_CHROMA)),
                        (1, (_AC_LUMA, _AC_CHROMA))):
        for t in range(min(len(comps), 2)):
            bits, vals = tables[t]
            out += segment(0xC4, bytes([cls * 16 + t]) + bytes(bits)
                           + bytes(vals))
    if restart:
        out += segment(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(comps)])
    for i in range(len(comps)):
        sos += bytes([i + 1, min(i, 1) * 17])
    out += segment(0xDA, sos + b"\x00\x3f\x00")
    return out + data + b"\xff\xd9"


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


def jpeg_records(n: int, hw: int, n_class: int, seed: int = 0,
                 quality: int = 90, subsampling: str = "420",
                 restart: int = 4, restart_every: int = 4,
                 distinct: int = 0) -> Iterable[Tuple[int, bytes]]:
    """(label, JPEG bytes) of ``images``: ``jpeg_bytes`` records, every
    ``restart_every``-th with a restart marker every ``restart`` MCUs.
    With ``distinct`` > 0 only the first ``distinct`` images are encoded
    and record i repeats image i % distinct's bytes under its own label."""
    encoded = []
    for i, (lab, img) in enumerate(images(n, hw, n_class, seed)):
        if distinct and i >= distinct:
            yield lab, encoded[i % distinct]
            continue
        rec = jpeg_bytes(img, quality, subsampling,
                         restart if restart_every and i % restart_every == 0
                         else 0)
        if distinct:
            encoded.append(rec)
        yield lab, rec


def make_jpeg_pack(dirname: str, name: str, n: int, hw: int, n_class: int,
                   seed: int = 0, page_ints: int = KPAGE_INTS, **kw
                   ) -> Tuple[str, str]:
    """``jpeg_records`` (keywords ``kw``) as a pack ``<dirname>/<name>.lst``
    + ``.bin``; returns the two paths."""
    os.makedirs(dirname, exist_ok=True)
    lst = os.path.join(dirname, name + ".lst")
    binp = os.path.join(dirname, name + ".bin")
    write_pack(jpeg_records(n, hw, n_class, seed, **kw), lst, binp,
               page_ints)
    return lst, binp


if __name__ == "__main__":
    if len(sys.argv) < 6:
        print(__doc__)
        sys.exit(1)
    a = sys.argv[1:]
    make = make_jpeg_pack if a[-1] == "jpeg" else make_ppm_pack
    a = a[:-1] if a[-1] == "jpeg" else a
    paths = make(a[0], a[1], int(a[2]), int(a[3]), int(a[4]),
                 int(a[5]) if len(a) > 5 else 0)
    print("wrote %s and %s" % paths)
