"""The port's host library (cxxnet_tpu_torch/utils/native.py,
csrc/host/*.cc): twins of the JAX package's tests/test_native.py cases on
the BinaryPage read-ahead reader (parity, multi-file chain, restart
stress, the threadbuffer loader thread's restart stress), the image page
iterator's object stream bitwise the plain Python page loop's, the PPM/PGM
decoder bitwise the numpy _decode_pnm, and the library's build by two
processes at once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu_torch import io as tio
from cxxnet_tpu_torch.io import iter_image as timage
from cxxnet_tpu_torch.io import synth
from cxxnet_tpu_torch.utils import native
from cxxnet_tpu_torch.utils.binary_page import BinaryPage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, objs, page_ints):
    with open(path, "wb") as f:
        p = BinaryPage(page_ints)
        for o in objs:
            if not p.push(o):
                p.save(f)
                p.clear()
                assert p.push(o)
        if p.size():
            p.save(f)


def _drain(r):
    got = []
    while True:
        o = r.next_obj()
        if o is None:
            return got
        got.append(o)


def test_page_reader_parity(tmp_path):
    rs = np.random.RandomState(3)
    page_ints = 128
    objs = [rs.bytes(int(rs.randint(1, 300))) for _ in range(200)]
    path = str(tmp_path / "t.bin")
    _write(path, objs, page_ints)
    r = native.NativePageReader([path], page_ints)
    assert _drain(r) == objs
    assert _drain(timage.PythonPageReader([path], page_ints)) == objs
    # restart semantics (before_first)
    r.before_first()
    assert r.next_obj() == objs[0]
    r.close()


def test_page_reader_multi_file_chain(tmp_path):
    page_ints = 64
    paths, all_objs = [], []
    for k in range(3):
        objs = [bytes([k * 40 + i]) * (i + 1) for i in range(20)]
        all_objs += objs
        paths.append(str(tmp_path / ("part%d.bin" % k)))
        _write(paths[-1], objs, page_ints)
    r = native.NativePageReader(paths, page_ints)
    assert _drain(r) == all_objs
    r.close()
    assert _drain(timage.PythonPageReader(paths, page_ints)) == all_objs


def test_page_reader_restart_stress(tmp_path):
    """Rapid before_first restarts neither deadlock nor corrupt the
    stream: the C++ reader's stop / join / restart, hammered."""
    page_ints = 64
    objs = [bytes([i]) * (i % 50 + 1) for i in range(200)]
    path = str(tmp_path / "s.bin")
    _write(path, objs, page_ints)
    r = native.NativePageReader([path], page_ints, lookahead=2)
    for trial in range(30):
        for k in range(trial % 7):
            assert r.next_obj() == objs[k]
        r.before_first()
    assert _drain(r) == objs
    r.close()


def test_page_reader_reports_a_broken_page(tmp_path):
    page_ints = 64
    path = str(tmp_path / "b.bin")
    _write(path, [b"x" * 10] * 30, page_ints)
    raw = bytearray(open(path, "rb").read())
    raw[page_ints * 4: page_ints * 4 + 4] = (10 ** 6).to_bytes(4, "little")
    open(path, "wb").write(bytes(raw))
    r = native.NativePageReader([path], page_ints)
    with pytest.raises(IOError):
        _drain(r)
    r.close()


def _image_pack(d, n=60, page=1 << 12):
    lst, binp = os.path.join(d, "p.lst"), os.path.join(d, "p.bin")
    recs = []
    for i, (lab, img) in enumerate(synth.images(n, 20, 3, seed=4)):
        recs.append((lab, synth.jpeg_bytes(img, 80) if i % 2
                     else synth.ppm_bytes(img)))
    synth.write_pack(recs, lst, binp, page)
    return lst, binp, page


def test_threadbuffer_iterator_restart_stress(tmp_path):
    """The read-ahead thread under threadbuffer's loader thread:
    interleaved restarts and full drains, on an imgbin pack."""
    lst, binp, page = _image_pack(str(tmp_path))
    it = tio.create_iterator([
        ("iter", "imgbin"), ("image_list", lst), ("image_bin", binp),
        ("page_size", str(page)), ("silent", "1"),
        ("input_shape", "3,16,16"), ("batch_size", "6"),
        ("iter", "threadbuffer")])
    it.init()
    for trial in range(10):
        it.before_first()
        for _ in range(trial % 4):
            assert it.next()
    it.before_first()
    n = 0
    while it.next():
        n += 1
    assert n == 10
    it.close()


@pytest.mark.parametrize("cfg", [
    dict(), dict(shuffle=1, seed_data=3, shuffle_window=9),
    dict(decode_thread=3, buffer_size=5, rand_crop=1)])
def test_image_pages_match_the_python_page_loop(tmp_path, monkeypatch,
                                                cfg):
    """Two epochs of the image page iterator read through the native
    reader and through the plain Python loop: the same records, labels and
    pixels, bitwise; the native reader is rebuilt when shuffle reorders
    the part files."""
    d = str(tmp_path)
    parts = []
    for k in range(3):
        lst, binp = os.path.join(d, "q%d.lst" % k), \
            os.path.join(d, "q%d.bin" % k)
        synth.write_pack(((lab, synth.ppm_bytes(img)) for lab, img in
                          synth.images(7 + k, 20, 3, seed=k)), lst, binp,
                         1 << 11)
        parts += [("image_list", lst), ("image_bin", binp)]
    conf = [("iter", "imgbin")] + parts + [
        ("page_size", str(1 << 11)), ("silent", "1"),
        ("input_shape", "3,16,16"), ("batch_size", "4")] + \
        [(k, str(v)) for k, v in cfg.items()]

    def run():
        it = tio.create_iterator(conf)
        it.init()
        out = []
        for _ in range(2):
            it.before_first()
            while it.next():
                b = it.value()
                out.append((np.array(b.data), np.array(b.label),
                            np.array(b.inst_index)))
        it.close()
        return out
    got = run()
    monkeypatch.setattr(timage.ImagePageIterator, "reader",
                        timage.PythonPageReader)
    want = run()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_pnm_decode_matches_numpy():
    rs = np.random.RandomState(2)
    cases = []
    for h, w in ((1, 1), (3, 5), (17, 9)):
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        cases += [synth.ppm_bytes(img), synth.ppm_bytes(img[:, :, 0]),
                  b"P6 # a comment\n%d\t%d\r255\n" % (w, h) + img.tobytes()
                  + b"trailing"]
    for buf in cases:
        np.testing.assert_array_equal(native.decode_pnm_chw(buf),
                                      timage._decode_pnm(buf))
        np.testing.assert_array_equal(timage.decode_image(buf),
                                      timage._decode_pnm(buf))
    for bad in (b"P6\n4 4\n255\n" + bytes(10), b"P6\n4 x\n255\n",
                b"P5\n4 4 255"):
        with pytest.raises(timage.RecordDecodeError):
            timage._decode_pnm(bad)
        with pytest.raises(native.NativeError) as e:
            native.decode_pnm_chw(bad)
        assert e.value.code == native.CORRUPT
    sixteen = b"P5\n2 2\n65535\n" + bytes(8)
    assert timage._decode_pnm(sixteen) is None
    with pytest.raises(native.NativeError) as e:
        native.decode_pnm_chw(sixteen)
    assert e.value.refused


BUILD_CHILD = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
from cxxnet_tpu_torch.utils import native
native.BUILD_DIR = %(build)r
while not os.path.exists(%(go)r):
    time.sleep(0.005)
path = native.build()
lib = native.load()
out = native.decode_pnm_chw(b"P6\n1 1\n255\n\x01\x02\x03")
print(path, out.ravel().tolist(), native.build_seconds is not None)
"""


def test_two_processes_build_one_library(tmp_path):
    build = str(tmp_path / "host")
    go = str(tmp_path / "go")
    code = BUILD_CHILD % {"repo": REPO, "build": build, "go": go}
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    open(go, "w").close()
    outs = [p.communicate(timeout=240) for p in procs]
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0][0] == lines[1][0]
    assert all("[1.0, 2.0, 3.0]" in out for out, _ in outs)
    # one of the two built it, the other waited on the lock and loaded it
    assert sorted(ln[-1] for ln in lines) == ["False", "True"]
    libs = [f for f in os.listdir(build) if f.endswith(".so")]
    assert libs == [os.path.basename(lines[0][0])]
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
