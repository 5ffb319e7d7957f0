"""The geometric augmenter's bicubic affine warp, spelled out in numpy.

``warp_affine_ref`` is the plain version of the host library's warp
(csrc/host/warp_affine.cc, called through ``utils.native.warp_affine``):
the same arithmetic in the same order, so the two agree bit for bit. The
tests and the card hold the C++ warp to it. ``inverse_map`` turns the
augmenter's forward matrix into the float32 inverse both take.

The arithmetic is that of OpenCV 5.0's ``warpAffine(src, M, dsize,
INTER_CUBIC, BORDER_CONSTANT, fill)`` on 8-bit images up to a rounding at
a few values in a hundred thousand (tests/test_torch_warp.py counts them):
the map inverted in double, source coordinates in float32, Keys' cubic
weights (A = -0.75) and the 4x4 sums in double, a tap outside the image
taking the fill value, one rounding at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

A = -0.75


def inverse_map(M: np.ndarray) -> np.ndarray:
    """The float32 inverse of a 2 x 3 affine map, inverted in double as
    OpenCV's warpAffine inverts it."""
    m = np.asarray(M, np.float64).reshape(6)
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    a12, a21 = m[1] * -D, m[3] * -D
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float32)


def keys_weights(t: np.ndarray) -> np.ndarray:
    """Keys' cubic weights of taps -1, 0, 1, 2 at fraction t (float64),
    stacked on a last axis."""
    t1, u = t + 1.0, 1.0 - t
    w0 = ((A * t1 - 5.0 * A) * t1 + 8.0 * A) * t1 - 4.0 * A
    w1 = ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0
    w2 = ((A + 2.0) * u - (A + 3.0)) * u * u + 1.0
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], -1)


def warp_affine_ref(src: np.ndarray, inv: np.ndarray,
                    out_hw: Tuple[int, int], fill: int) -> np.ndarray:
    """Warp an (h, w, c) uint8 image to (out_h, out_w, c) under the float32
    inverse map ``inv``: output pixel (x, y) samples the source at
    X = a*x + (b*y + c), Y = d*x + (e*y + f), every step in float32."""
    src = np.asarray(src, np.uint8)
    h, w, c = src.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    a, b, cc, d, e, f = np.asarray(inv, np.float32).reshape(6)
    fx = np.arange(out_w, dtype=np.float32)[None, :]
    fy = np.arange(out_h, dtype=np.float32)[:, None]
    X = a * fx + (b * fy + cc)
    Y = d * fx + (e * fy + f)
    flx, fly = np.floor(X), np.floor(Y)
    near = ((flx > np.float32(-8)) & (flx < np.float32(w + 8))
            & (fly > np.float32(-8)) & (fly < np.float32(h + 8)))
    x0 = np.where(near, flx, 0).astype(np.int64)
    y0 = np.where(near, fly, 0).astype(np.int64)
    outside = ~near | (x0 + 2 < 0) | (x0 - 1 >= w) | (y0 + 2 < 0) \
        | (y0 - 1 >= h)
    wx = keys_weights((X - flx).astype(np.float64))
    wy = keys_weights((Y - fly).astype(np.float64))
    fillv = np.float64(fill)
    out = np.empty((out_h, out_w, c), np.uint8)
    for ch in range(c):
        plane = src[:, :, ch]
        acc = np.zeros((out_h, out_w), np.float64)
        for j in range(4):
            yy = y0 - 1 + j
            row = np.zeros((out_h, out_w), np.float64)
            for i in range(4):
                xx = x0 - 1 + i
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                v = np.where(inside, plane[np.clip(yy, 0, h - 1),
                                           np.clip(xx, 0, w - 1)], fillv)
                row = row + wx[..., i] * v
            acc = acc + wy[..., j] * row
        res = np.clip(np.rint(acc), 0, 255)
        res[outside] = fill
        out[:, :, ch] = res.astype(np.uint8)
    return out
