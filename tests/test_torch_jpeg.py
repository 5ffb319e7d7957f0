"""The port's JPEG decoder (csrc/host/jpeg_decode.cc through
cxxnet_tpu_torch.utils.native and io.iter_image.decode_image) against
libjpeg-turbo as the JAX package runs it: its native decoder
(cxxnet_tpu.utils.native.decode_jpeg_chw, lib/libcxxnet_tpu_core.so on the
system's libjpeg-turbo, where lib/ loads) and cv2.imdecode (OpenCV's
libjpeg-turbo). Tolerance 0: the port does libjpeg-turbo's integer
arithmetic, so every pixel is bitwise theirs.

Covered: the committed fixtures of tests/data/jpeg (their SHA-256 in
expected.json was taken from libjpeg-turbo and is checked here against the
live decoders too); a seeded matrix of sizes, qualities, the five chroma
layouts, baseline and progressive, with and without restart markers; gray;
streams cut short (held to the JAX native route, which decodes them, where
cv2 refuses); the forms the decoder refuses (CMYK, arithmetic coding,
12-bit) taking the cv2 route or raising MissingCodecError without cv2;
garbage; the port's own encoder (io.synth.jpeg_bytes); four threads at
once.
"""

import hashlib
import json
import os
import sys
import threading

import numpy as np
import pytest

from cxxnet_tpu.utils import native as jnative
from cxxnet_tpu_torch.io import iter_image as timage
from cxxnet_tpu_torch.io import synth
from cxxnet_tpu_torch.utils import native

cv2 = pytest.importorskip("cv2")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
EXPECTED = json.load(open(os.path.join(DATA, "expected.json")))
SF = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
      "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
      "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
      "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
      "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _cv2(buf):
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else \
        bgr[:, :, ::-1].transpose(2, 0, 1).astype(np.float32)


def _jax_native(buf):
    if jnative.load() is None:
        return None
    return jnative.decode_jpeg_chw(buf)


def _hash(chw):
    hwc = np.ascontiguousarray(chw.transpose(1, 2, 0).astype(np.uint8))
    return hashlib.sha256(hwc.tobytes()).hexdigest()


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _same_as_libjpeg(buf, what):
    got = native.decode_jpeg_chw(buf)
    assert got.dtype == np.float32 and got.shape[0] == 3
    seen = 0
    for ref in (_cv2(buf), _jax_native(buf)):
        if ref is not None:
            np.testing.assert_array_equal(got, ref, what)
            seen += 1
    assert seen, what
    return got


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_is_libjpeg_bitwise(name):
    buf = _read(name)
    got = native.decode_jpeg_chw(buf)
    want = EXPECTED[name]
    assert list(got.transpose(1, 2, 0).shape) == want["shape"]
    assert _hash(got) == want["sha256"]
    # the recorded hash is live libjpeg-turbo's here, on both routes
    live = [r for r in (_cv2(buf), _jax_native(buf)) if r is not None]
    assert live or name == "trunc.jpg"
    for ref in live:
        assert _hash(ref) == want["sha256"]
        np.testing.assert_array_equal(got, ref)


def _image(rs, h, w, smooth):
    if not smooth:
        return rs.randint(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 120 * np.sin(x / 3.0), 128 + 120 * np.cos(y / 5.0),
                    (x * 7 + y * 3) % 256], -1) + rs.randint(-9, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("layout", sorted(SF))
def test_seeded_matrix_is_libjpeg_bitwise(layout, progressive):
    rs = np.random.RandomState(17 + progressive)
    for h, w in ((1, 1), (2, 3), (7, 9), (8, 8), (16, 17), (37, 53),
                 (45, 61), (33, 100)):
        for quality in (10, 50, 90, 100):
            for restart in (0, 1, 4):
                img = _image(rs, h, w, smooth=quality % 20 == 10)
                buf = cv2.imencode(".jpg", img, [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF[layout],
                    cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                    cv2.IMWRITE_JPEG_RST_INTERVAL, restart])[1].tobytes()
                _same_as_libjpeg(buf, "%dx%d %s q%d prog %d rst %d"
                                 % (h, w, layout, quality, progressive,
                                    restart))


@pytest.mark.parametrize("progressive", [0, 1])
def test_gray_is_libjpeg_bitwise(progressive):
    rs = np.random.RandomState(5)
    for h, w in ((1, 1), (9, 7), (37, 53), (64, 48)):
        for quality in (20, 75, 98):
            img = rs.randint(0, 256, (h, w), np.uint8)
            buf = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])[1].tobytes()
            got = _same_as_libjpeg(buf, "gray %dx%d" % (h, w))
            np.testing.assert_array_equal(got[0], got[1])
            np.testing.assert_array_equal(got[0], got[2])


def test_truncated_matches_the_jax_native_route():
    """A stream cut short decodes as the JAX native route decodes it
    (libjpeg warns and fills the rest as zero coefficients); cv2 refuses
    it. Cuts fall in the entropy data of baseline streams, with and
    without restart markers."""
    if jnative.load() is None:
        pytest.skip("lib/libcxxnet_tpu_core.so is not built here")
    buf = _read("trunc.jpg")
    assert _cv2(buf) is None
    np.testing.assert_array_equal(native.decode_jpeg_chw(buf),
                                  jnative.decode_jpeg_chw(buf))
    rs = np.random.RandomState(23)
    for k in range(24):
        h, w = rs.randint(8, 80, 2)
        img = _image(rs, h, w, smooth=k % 2 == 0)
        full = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, int(rs.randint(20, 100)),
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF[sorted(SF)[k % 5]],
            cv2.IMWRITE_JPEG_RST_INTERVAL, k % 3])[1].tobytes()
        sos = full.index(b"\xff\xda")
        for cut in (len(full) - 2, int(rs.randint(sos + 14, len(full) - 2))):
            want = jnative.decode_jpeg_chw(full[:cut])
            assert want is not None
            np.testing.assert_array_equal(
                native.decode_jpeg_chw(full[:cut]), want,
                "case %d cut %d of %d" % (k, cut, len(full)))


def _sof_patched(buf, precision=None, marker=None, cmyk=False):
    """A baseline stream with its SOF0 changed: another precision, another
    SOF marker, or a fourth component declared."""
    i = buf.index(b"\xff\xc0")
    length = int.from_bytes(buf[i + 2:i + 4], "big")
    seg = bytearray(buf[i:i + 2 + length])
    if precision is not None:
        seg[4] = precision
    if marker is not None:
        seg[1] = marker
    if cmyk:
        seg[9] = 4
        seg += bytes([4, 0x11, 0])
        seg[2:4] = (length + 3).to_bytes(2, "big")
    return buf[:i] + bytes(seg) + buf[i + 2 + length:]


class _FakeCv2:
    """Stands in for cv2 and records that the cv2 route was taken."""
    IMREAD_COLOR = 1

    def __init__(self):
        self.calls = 0

    def imdecode(self, arr, flags):
        self.calls += 1
        return np.full((5, 6, 3), 9, np.uint8)


@pytest.mark.parametrize("form, patch, feature", [
    ("cmyk", dict(cmyk=True), "four components"),
    ("arithmetic", dict(marker=0xC9), "arithmetic coding"),
    ("12-bit", dict(precision=12), "precision other than 8")])
def test_refused_forms_take_the_cv2_route(monkeypatch, form, patch,
                                          feature):
    base = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8))[1].tobytes()
    buf = _sof_patched(base, **patch)
    with pytest.raises(native.NativeError) as e:
        native.decode_jpeg_chw(buf)
    assert e.value.refused and feature in native.REFUSED[e.value.code]
    fake = _FakeCv2()
    monkeypatch.setitem(sys.modules, "cv2", fake)
    out = timage.decode_image(buf)
    assert fake.calls == 1 and out.shape == (3, 5, 6)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(timage.MissingCodecError,
                       match="JPEG with .*%s.*cv2" % feature):
        timage.decode_image(buf)


def test_garbage_after_soi_raises_record_decode_error():
    rs = np.random.RandomState(3)
    for k in range(20):
        junk = bytes(rs.randint(0, 256, int(rs.randint(0, 400)),
                                dtype=np.uint8))
        buf = b"\xff\xd8\xff" + junk
        with pytest.raises(timage.RecordDecodeError):
            timage.decode_image(buf)
    with pytest.raises(native.NativeError) as e:
        native.decode_jpeg_chw(b"\xff\xd8" + bytes(32))
    assert e.value.code == native.CORRUPT and not e.value.refused


@pytest.mark.parametrize("subsampling", ["444", "420", "gray"])
@pytest.mark.parametrize("restart", [0, 2])
def test_synth_jpeg_bytes_decode_alike(subsampling, restart):
    rs = np.random.RandomState(11)
    for h, w in ((1, 1), (8, 8), (17, 33), (37, 53), (64, 48)):
        img = _image(rs, h, w, smooth=True)
        if subsampling == "gray":
            img = img[:, :, 0]
        buf = synth.jpeg_bytes(img, 85, "444" if subsampling == "gray"
                               else subsampling, restart)
        got = _same_as_libjpeg(buf, "%dx%d" % (h, w))
        src = img if img.ndim == 3 else img[:, :, None]
        # and close to the image it encodes
        assert np.abs(got.transpose(1, 2, 0) - src).mean() < 12


def test_four_threads_give_the_one_thread_bytes():
    bufs = [_read(n) for n in sorted(EXPECTED)]
    want = [native.decode_jpeg_chw(b) for b in bufs]
    errors = []

    def work(k):
        try:
            for r in range(20):
                i = (k + r) % len(bufs)
                if not np.array_equal(native.decode_jpeg_chw(bufs[i]),
                                      want[i]):
                    errors.append((k, i))
        except Exception as e:   # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
