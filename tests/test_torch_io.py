"""The port's iterators (cxxnet_tpu_torch.io) against the JAX package's
(cxxnet_tpu.io), on the CPU, over the same files made from a numpy seed.

Every chain is built from the same config pairs by both factories and run
for two epochs; each batch's data, label, inst_index and num_batch_padd
must be bitwise equal. That holds for JPEG packs too: the JAX package
decodes JPEG with libjpeg-turbo (its native decoder where lib/ holds it,
else cv2), the port with its own decoder, which does libjpeg-turbo's
arithmetic; the bar is 0. The one exception is the geometric augmenter,
whose warp the JAX package takes from cv2 and the port from its host
library: there a value may part by 1 in [0, 255] on at most 0.1% of the
values (tests/test_torch_warp.py counts them).
"""

import os
import sys
import time

import numpy as np
import pytest

from cxxnet_tpu import io as jio
from cxxnet_tpu_torch import io as tio
from cxxnet_tpu_torch.io import batch as tbatch
from cxxnet_tpu_torch.io import iter_image as timage
from cxxnet_tpu_torch.io import synth
from cxxnet_tpu_torch.io.data import DataBatch, IIterator

from tests.synth_mnist import make_dataset

PAGE = 1 << 14   # 64 KiB pages, so a pack spans several


def _epochs(it, n=2):
    """Every batch of n epochs, copied out of the iterator's buffers."""
    out = []
    for _ in range(n):
        it.before_first()
        while it.next():
            b = it.value()
            out.append((np.array(b.data), np.array(b.label),
                        None if b.inst_index is None
                        else np.array(b.inst_index), b.num_batch_padd,
                        [np.array(e) for e in b.extra_data]))
    return out


def _run(factory, cfg, **kw):
    it = factory(cfg, **kw)
    it.init()
    try:
        return _epochs(it)
    finally:
        it.close()


# the warp's bar: a value may part by 1 on at most this share of values
WARP_SHARE = 1e-3


def _same(cfg, atol_pixels=0.0):
    got = _run(tio.create_iterator, cfg)
    want = _run(jio.create_iterator, cfg)
    assert len(got) == len(want) > 0
    apart = total = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if atol_pixels:
            assert g[0].shape == w[0].shape
            d = np.abs(g[0].astype(np.float64) - w[0])
            assert d.max() <= atol_pixels, "batch %d data" % k
            apart += int(np.count_nonzero(d))
            total += d.size
        else:
            assert g[0].dtype == w[0].dtype
            np.testing.assert_array_equal(g[0], w[0], "batch %d data" % k)
        np.testing.assert_array_equal(g[1], w[1], "batch %d label" % k)
        if w[2] is not None:
            np.testing.assert_array_equal(g[2], w[2], "batch %d inst" % k)
        assert g[3] == w[3], "batch %d num_batch_padd" % k
        assert len(g[4]) == len(w[4])
        for ge, we in zip(g[4], w[4]):
            np.testing.assert_array_equal(ge, we)
    assert apart <= WARP_SHARE * total, "%d of %d values apart" % (apart,
                                                                   total)
    return got


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist"))
    return make_dataset(d, n_train=230, n_test=60)


def _mnist_cfg(paths, **kw):
    cfg = [("iter", "mnist"), ("path_img", paths["train_img"]),
           ("path_label", paths["train_lab"]), ("silent", "1")]
    cfg += [(k, str(v)) for k, v in kw.items()]
    return cfg


@pytest.mark.parametrize("flat", [0, 1])
@pytest.mark.parametrize("shuffle, seed", [(0, 0), (1, 0), (1, 7)])
@pytest.mark.parametrize("adapter", ["", "threadbuffer", "membuffer"])
def test_mnist_chain_matches_jax(mnist, flat, shuffle, seed, adapter):
    cfg = _mnist_cfg(mnist, input_flat=flat, shuffle=shuffle,
                     seed_data=seed, index_offset=3)
    if adapter:
        cfg += [("iter", adapter), ("batch_size", "50")]
    else:
        cfg += [("batch_size", "50")]
    got = _same(cfg)
    # full batches only: 230 rows give 4 batches an epoch
    assert len(got) == 8


def test_mnist_skip_is_a_seek(mnist):
    it = tio.create_iterator(_mnist_cfg(mnist, batch_size=50))
    it.init()
    assert it.skip(3) == 3 and it.next() and not it.next()
    it.before_first()
    assert it.skip(9) == 4


def _write_libsvm(path, n, nfeat, seed):
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            idx = np.sort(rs.choice(nfeat, rs.randint(0, 6), replace=False))
            f.write("%d %s\n" % (rs.randint(0, 3), " ".join(
                "%d:%g" % (i, rs.randn()) for i in idx)))


@pytest.mark.parametrize("shuffle", [0, 1])
@pytest.mark.parametrize("round_batch", [0, 1])
def test_libsvm_matches_jax(tmp_path, shuffle, round_batch):
    path = str(tmp_path / "d.svm")
    _write_libsvm(path, 23, 40, seed=3)
    cfg = [("iter", "libsvm"), ("path_data", path), ("num_feature", "40"),
           ("batch_size", "5"), ("shuffle", str(shuffle)),
           ("round_batch", str(round_batch)), ("seed_data", "2"),
           ("silent", "1")]
    _same(cfg)
    it = tio.create_iterator(cfg)
    it.init()
    it.before_first()
    assert it.next()
    b = it.value()
    np.testing.assert_array_equal(
        b.sparse_to_dense(40).reshape(b.data.shape), b.data)


def test_attachtxt_matches_jax(mnist, tmp_path):
    path = str(tmp_path / "extra.txt")
    rs = np.random.RandomState(4)
    with open(path, "w") as f:
        f.write("3\n")
        for i in range(0, 230, 2):
            f.write("%d %s\n" % (i, " ".join("%g" % v for v in rs.randn(3))))
    cfg = _mnist_cfg(mnist, shuffle=1) + [
        ("iter", "attachtxt"), ("filename", path), ("batch_size", "50")]
    got = _same(cfg)
    assert got[0][4][0].shape == (50, 1, 1, 3)


# ---------------------------------------------------------------- images
def _ppm_pack(d, name, n, hw=36, n_class=3, seed=0, gray=False):
    recs = []
    for lab, img in synth.images(n, hw, n_class, seed):
        recs.append((lab, synth.ppm_bytes(img[:, :, 0] if gray else img)))
    lst, binp = os.path.join(d, name + ".lst"), os.path.join(d, name + ".bin")
    synth.write_pack(recs, lst, binp, PAGE)
    return lst, binp


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("packs"))
    out = {"dir": d, "ppm": _ppm_pack(d, "ppm", 45),
           "pgm": _ppm_pack(d, "pgm", 20, gray=True, seed=1),
           "big": _ppm_pack(d, "big", 20, hw=48, seed=2)}
    for part in range(3):
        _ppm_pack(d, "part%d" % part, 9 + part, seed=10 + part)
    return out


def _img_cfg(lst, binp, kind="imgbin", **kw):
    cfg = [("iter", kind), ("image_list", lst), ("image_bin", binp),
           ("page_size", str(PAGE)), ("silent", "1"),
           ("input_shape", "3,32,32"), ("batch_size", "8")]
    return cfg + [(k, str(v)) for k, v in kw.items()]


AUGMENT = {
    "plain": {},
    "crop_mirror": dict(rand_crop=1, rand_mirror=1, seed_data=3),
    "shuffle_contrast": dict(shuffle=1, shuffle_window=7, seed_data=5,
                             rand_crop=1, max_random_contrast=0.3,
                             max_random_illumination=20, mean_value="10,20,30",
                             divideby=256),
    "round_batch": dict(round_batch=1, rand_crop=1, crop_y_start=1,
                        mirror=1, scale=0.5),
    "fixed_crop": dict(crop_y_start=2, crop_x_start=3),
    "uint8": dict(output_uint8=1, rand_crop=1, rand_mirror=1),
}


@pytest.mark.parametrize("aug", sorted(AUGMENT))
@pytest.mark.parametrize("adapter", ["", "threadbuffer"])
def test_imgbin_chain_matches_jax(packs, aug, adapter):
    cfg = _img_cfg(*packs["ppm"], **AUGMENT[aug])
    if adapter:
        cfg.insert(3, ("iter", adapter))
    got = _same(cfg)
    # 45 images at batch 8: 6 batches an epoch, the last padded
    assert len(got) == 12
    assert got[5][3] == 3
    if aug == "uint8":
        assert got[0][0].dtype == np.uint8


def test_pgm_records_expand_gray_like_cv2(packs):
    got = _same(_img_cfg(*packs["pgm"], rand_crop=1))
    d = got[0][0]
    np.testing.assert_array_equal(d[:, 0], d[:, 1])
    np.testing.assert_array_equal(d[:, 0], d[:, 2])


def test_imgbinx_decode_pool_matches_jax(packs):
    cfg = _img_cfg(*packs["ppm"], kind="imgbinx", decode_thread=2,
                   buffer_size=5, shuffle=1, seed_data=1, rand_crop=1)
    _same(cfg)
    # and the pool gives imgbin's batches
    one = _run(tio.create_iterator, _img_cfg(*packs["ppm"], shuffle=1,
                                             seed_data=1, rand_crop=1))
    two = _run(tio.create_iterator, cfg)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("workers, rank", [(0, 0), (2, 0), (2, 1), (3, 2)])
def test_image_conf_prefix_shards_match_jax(packs, workers, rank):
    cfg = [("iter", "imgbin"),
           ("image_conf_prefix", os.path.join(packs["dir"], "part%d")),
           ("image_conf_ids", "0-2"), ("dist_num_worker", str(workers)),
           ("dist_worker_rank", str(rank)), ("page_size", str(PAGE)),
           ("silent", "1"), ("input_shape", "3,32,32"), ("batch_size", "4"),
           ("shuffle", "1"), ("seed_data", "9")]
    _same(cfg)


def test_img_iterator_matches_jax(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "img.lst"), "w") as lst:
        for i, (lab, img) in enumerate(synth.images(11, 34, 2, seed=6)):
            with open(os.path.join(d, "f%d.ppm" % i), "wb") as f:
                f.write(synth.ppm_bytes(img))
            lst.write("%d %d f%d.ppm\n" % (i, lab, i))
    cfg = [("iter", "img"), ("image_list", os.path.join(d, "img.lst")),
           ("image_root", d), ("shuffle", "1"), ("seed_data", "3"),
           ("silent", "1"), ("input_shape", "3,32,32"), ("batch_size", "4"),
           ("rand_crop", "1")]
    _same(cfg)


def test_jpeg_pack_matches_jax_within_the_decoders(tmp_path):
    cv2 = pytest.importorskip("cv2")
    recs = []
    for lab, img in synth.images(20, 36, 3, seed=2):
        ok, enc = cv2.imencode(".jpg", img[:, :, ::-1])
        assert ok
        recs.append((lab, enc.tobytes()))
    # and the port's own encoder's streams, with restart markers
    recs += [(lab, synth.jpeg_bytes(img, 80, "420", 2)) for lab, img in
             synth.images(6, 40, 3, seed=3)]
    lst, binp = str(tmp_path / "j.lst"), str(tmp_path / "j.bin")
    synth.write_pack(recs, lst, binp, PAGE)
    cfg = _img_cfg(lst, binp, rand_crop=1, seed_data=2)
    # JAX: libjpeg through lib/libcxxnet_tpu_core.so when it loads, else
    # cv2; the port: its own decoder. Bitwise either way.
    routes = dict(timage.decode_routes)
    _same(cfg)
    assert timage.decode_routes["jpeg"] - routes["jpeg"] == 2 * len(recs)
    assert timage.decode_routes["cv2"] == routes["cv2"]


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


PNG = b"\x89PNG\r\n\x1a\n" + bytes(64)


def test_jpeg_record_without_cv2_raises_naming_the_codec(no_cv2):
    """Without cv2 a JPEG record decodes (the port's decoder needs no
    codec); a PNG record raises, naming its format and cv2."""
    jpeg = synth.jpeg_bytes(np.full((9, 11, 3), 77, np.uint8), 90, "444")
    out = timage.decode_image(jpeg)
    assert out.shape == (3, 9, 11) and out.dtype == np.float32
    with pytest.raises(timage.MissingCodecError, match="PNG.*cv2"):
        timage.decode_image(PNG)
    # PPM needs no codec either
    img = synth.ppm_bytes(np.zeros((2, 3, 3), np.uint8) + 7)
    assert timage.decode_image(img).shape == (3, 2, 3)


def test_jpeg_pack_without_cv2_is_never_skipped(tmp_path, no_cv2):
    """With cv2 hidden, the JPEG and PPM records of a pack decode and its
    PNG record raises MissingCodecError: never skipped, even with
    skip_corrupt."""
    img = np.zeros((36, 36, 3), np.uint8)
    recs = [(0, synth.ppm_bytes(img)), (1, synth.jpeg_bytes(img + 90)),
            (0, PNG)]
    lst, binp = str(tmp_path / "m.lst"), str(tmp_path / "m.bin")
    synth.write_pack(recs, lst, binp, PAGE)
    it = tio.create_iterator(_img_cfg(lst, binp, skip_corrupt=1,
                                      batch_size=1))
    it.init()
    it.before_first()
    assert it.next() and it.next()
    assert float(it.value().data.mean()) == 90.0
    with pytest.raises(timage.MissingCodecError):
        it.next()


GEOMETRIC = [("max_rotate_angle", "10"), ("max_shear_ratio", "0.1"),
             ("max_aspect_ratio", "0.2"), ("rotate", "90"),
             ("rotate_list", "0,90"), ("min_random_scale", "0.8"),
             ("max_random_scale", "1.2"), ("min_crop_size", "32")]


@pytest.mark.parametrize("key, val", GEOMETRIC)
def test_geometric_key_matches_jax(packs, key, val):
    """Each key of the geometric augmenter alone: the port's chain against
    the JAX factory's over two epochs (48x48 records, random crops and
    mirrors), within the warp's bar."""
    cfg = _img_cfg(*packs["big"], rand_crop=1, rand_mirror=1, seed_data=6,
                   **{key: val})
    got = _same(cfg, atol_pixels=1.0)
    assert len(got) == 6


def test_geometric_keys_at_their_identity_are_accepted(packs):
    _same(_img_cfg(*packs["ppm"], max_rotate_angle=0, min_random_scale=1,
                   max_crop_size=48, fill_value=0))


def test_decode_timeout_restarts_dead_worker(tmp_path, monkeypatch):
    """The twin of the JAX tests/test_health_faults.py case: a decode
    wedged past decode_timeout is quarantined, the pool restarted and
    counted, and a watchdog_stall event emitted on io.decode."""
    from cxxnet_tpu_torch.utils import telemetry
    bufs = [b"REC-A", b"REC-B", b"SLOW!", b"REC-C"]
    lst, binp = str(tmp_path / "t.lst"), str(tmp_path / "t.bin")
    synth.write_pack(((0, b) for b in bufs), lst, binp, PAGE)

    def fake_decode(buf):
        if bytes(buf) == b"SLOW!":
            time.sleep(0.8)                  # wedged decode worker
        return np.zeros((3, 4, 4), np.float32)

    monkeypatch.setattr(timage, "decode_image", fake_decode)
    telemetry.enable(None)
    try:
        it = timage.ImagePageIterator()
        for k, v in (("image_list", lst), ("image_bin", binp),
                     ("page_size", str(PAGE)), ("silent", "1"),
                     ("decode_thread", "2"), ("decode_timeout", "0.2")):
            it.set_param(k, v)
        it.init()
        seen = []
        while it.next():
            seen.append(it.value().index)
        assert sorted(seen) == [0, 1, 3]             # SLOW! quarantined
        assert it._quarantined == {2}
        c = telemetry.summary()["counters"]
        assert c["io.decode_worker_restarts"] == 1
        assert any(e.get("ev") == "watchdog_stall"
                   and e.get("channel") == "io.decode"
                   for e in telemetry.events())
        it.close()
    finally:
        telemetry.disable()


@pytest.mark.parametrize("skip", [0, 1])
def test_corrupt_record_like_jax(tmp_path, skip):
    recs = [(i % 2, synth.ppm_bytes(img)) for i, (_, img) in
            enumerate(synth.images(10, 36, 2, seed=8))]
    recs[4] = (0, b"P6\n36 36\n255\n" + bytes(10))       # torn PPM
    lst, binp = str(tmp_path / "c.lst"), str(tmp_path / "c.bin")
    synth.write_pack(recs, lst, binp, PAGE)
    cfg = _img_cfg(lst, binp, skip_corrupt=skip, batch_size=3)
    if skip:
        got = _same(cfg)
        assert sum(len(b[0]) - b[3] for b in got) == 2 * 9
    else:
        it = tio.create_iterator(cfg)
        it.init()
        with pytest.raises(timage.RecordDecodeError):
            list(iter(it))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mean_image_file_is_shared(packs, tmp_path, writer):
    """The mean image each package writes is byte-identical, and each
    loads the other's (the loader's batches then match)."""
    lst, binp = packs["ppm"]
    files = {}
    for side, factory in (("port", tio.create_iterator),
                          ("jax", jio.create_iterator)):
        files[side] = str(tmp_path / side / "mean.bin")
        it = factory(_img_cfg(lst, binp, image_mean=files[side],
                              rand_crop=1, seed_data=4))
        it.init()
        it.close()
    with open(files["port"], "rb") as a, open(files["jax"], "rb") as b:
        assert a.read() == b.read()
    # both read the other side's file
    _same(_img_cfg(lst, binp, image_mean=files[writer], rand_crop=1,
                   max_random_contrast=0.2, seed_data=4))


class _Boom(IIterator):
    def __init__(self, fail_at):
        self.fail_at = fail_at

    def before_first(self):
        self.k = 0

    def next(self):
        self.k += 1
        if self.k == self.fail_at:
            raise OSError("disk went away at batch %d" % self.k)
        self.out = DataBatch()
        self.out.data = np.full((2, 1, 1, 3), self.k, np.float32)
        self.out.label = np.zeros((2, 1), np.float32)
        self.out.batch_size = 2
        return True

    def value(self):
        return self.out


@pytest.mark.parametrize("buffer_size", [1, 2])
def test_threadbuffer_reraises_loader_errors(buffer_size):
    it = tbatch.ThreadBufferIterator(_Boom(fail_at=4))
    it.set_param("silent", "1")
    it.set_param("buffer_size", str(buffer_size))
    it.init()
    seen = []
    with pytest.raises(OSError, match="disk went away at batch 4"):
        while it.next():
            seen.append(float(it.value().data[0, 0, 0, 0]))
    assert seen == [1.0, 2.0, 3.0]
    with pytest.raises(OSError):
        it.next()
    it.close()
    assert it.thread is None
