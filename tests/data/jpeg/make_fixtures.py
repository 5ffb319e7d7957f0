"""Writes the JPEG fixtures of this directory and expected.json with cv2
(OpenCV's libjpeg-turbo encoder): python tests/data/jpeg/make_fixtures.py

Each fixture's expected entry is its shape and the SHA-256 of its
libjpeg-turbo decode as uint8 HWC RGB: cv2.imdecode's, or for the truncated
stream (which cv2 refuses) the JAX package's native libjpeg decoder's.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

SF = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
      "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
      "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
      "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
      "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# name: (height, width, sampling, quality, progressive, restart interval)
FIXTURES = {
    "base444": (37, 53, "444", 75, 0, 0),
    "base422": (37, 53, "422", 75, 0, 0),
    "base420": (37, 53, "420", 75, 0, 0),
    "base440": (45, 61, "440", 75, 0, 0),
    "base411": (45, 61, "411", 75, 0, 0),
    "prog420": (37, 53, "420", 75, 1, 0),
    "prog444": (64, 48, "444", 80, 1, 0),
    "rst3": (64, 48, "420", 75, 0, 3),
    "q30": (37, 53, "420", 30, 0, 0),
    "q95": (64, 48, "444", 95, 0, 0),
    "gray": (37, 53, "gray", 75, 0, 0),
    "trunc": (64, 48, "420", 90, 0, 0),
}


def image(h, w, seed):
    """Smooth color ramps under noise, edges that ring."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 110 * np.sin(x / 5.0 + seed),
                    128 + 100 * np.cos(y / 4.0),
                    255 * ((x + y) % 16 < 8)], -1)
    return np.clip(img + rs.randint(-24, 25, img.shape), 0, 255) \
        .astype(np.uint8)


def main():
    from cxxnet_tpu.utils import native
    expected = {}
    for seed, (name, (h, w, sf, q, prog, rst)) in enumerate(
            sorted(FIXTURES.items())):
        img = image(h, w, seed)
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE,
                  prog, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if sf == "gray":
            img = img[:, :, 1]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF[sf]]
            img = img[:, :, ::-1]
        buf = cv2.imencode(".jpg", img, params)[1].tobytes()
        if name == "trunc":
            buf = buf[:len(buf) // 2]
            rgb = native.decode_jpeg_chw(buf).transpose(1, 2, 0)
        else:
            rgb = cv2.imdecode(np.frombuffer(buf, np.uint8),
                               cv2.IMREAD_COLOR)[:, :, ::-1]
        rgb = np.ascontiguousarray(rgb.astype(np.uint8))
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(buf)
        expected[name + ".jpg"] = {
            "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
