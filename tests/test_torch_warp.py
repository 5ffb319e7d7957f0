"""The geometric augmenter's warp: io/warp.py warp_affine_ref (numpy) and
csrc/host/warp_affine.cc (through utils.native.warp_affine) against
OpenCV 5.0's cv2.warpAffine(INTER_CUBIC, BORDER_CONSTANT), and the port's
GeometricAugmenter against the JAX package's, on seeded matrices drawn as
example/kaggle_bowl/bowl.conf's keys draw them.

The C++ warp and the numpy one are held to each other bit for bit. Against
cv2 the bar is a difference of at most 1 on at most 0.1% of the values:
cv2 computes in floating point (it is not OpenCV 4's fixed-point grid), and
the port's pinned arithmetic (float32 coordinates, double weights and sums)
rounds apart from it at a few values in a million: on the cases below, 8
of 1,066,830 warped values (all at 256x256) and 11 of 864,000 augmenter
outputs against the JAX one's, each by 1 (measured).
"""


import numpy as np
import pytest

from cxxnet_tpu.io import iter_image as jimage
from cxxnet_tpu_torch.io import iter_image as timage
from cxxnet_tpu_torch.io.warp import inverse_map, warp_affine_ref
from cxxnet_tpu_torch.utils import native

cv2 = pytest.importorskip("cv2")

SHARE = 1e-3
BOWL = dict(max_rotate_angle=180, max_aspect_ratio=0.5, max_shear_ratio=0.3)


def draw_matrix(rs, w, h, scale_range=(1.0, 1.0)):
    """The augmenter's float32 forward matrix under bowl.conf's keys (and
    a random scale range) and its output (w, h)."""
    aug = timage.GeometricAugmenter()
    for k, v in dict(BOWL, min_random_scale=scale_range[0],
                     max_random_scale=scale_range[1]).items():
        aug.set_param(k, str(v))
    M, (out_h, out_w) = aug.draw_matrix(h, w, rs)
    return M, (out_w, out_h)


def _cases(seed, hw, n, scale_range=(1.0, 1.0)):
    rs = np.random.RandomState(seed)
    for k in range(n):
        h, w = hw
        src = rs.randint(0, 256, (h, w, 3), np.uint8)
        M, dsize = draw_matrix(rs, w, h, scale_range=scale_range)
        yield src, M, dsize, [255, 0, 17][k % 3]


@pytest.mark.parametrize("hw, n, scale_range", [
    ((48, 48), 20, (1.0, 1.0)), ((256, 256), 4, (1.0, 1.0)),
    ((37, 53), 20, (0.7, 1.3)), ((5, 7), 30, (0.5, 2.0))])
def test_warp_matches_cv2_within_the_bar(hw, n, scale_range):
    apart = total = 0
    for src, M, dsize, fill in _cases(7, hw, n, scale_range):
        want = cv2.warpAffine(src, M, dsize, flags=cv2.INTER_CUBIC,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(fill,) * 3)
        inv = inverse_map(M)
        ref = warp_affine_ref(src, inv, (dsize[1], dsize[0]), fill)
        got = native.warp_affine(src, inv, (dsize[1], dsize[0]), fill)
        np.testing.assert_array_equal(got, ref)
        d = np.abs(ref.astype(np.int64) - want)
        assert d.max() <= 1
        apart += int(np.count_nonzero(d))
        total += d.size
    assert apart <= SHARE * total, "%d of %d values apart" % (apart, total)


def test_cpp_warp_is_the_numpy_warp_bitwise():
    """Edge cases as well: one-channel and four-channel images, maps that
    send every pixel outside, a degenerate (singular) map, huge
    coordinates."""
    rs = np.random.RandomState(3)
    mats = [np.array([[1, 0, 0], [0, 1, 0]], np.float32),
            np.array([[1, 0, 500], [0, 1, -900]], np.float32),
            np.array([[0, 0, 0], [0, 0, 0]], np.float32),
            np.array([[1e-6, 0, 0], [0, 1e-6, 0]], np.float32),
            np.array([[0.1, 2.0, 3.5], [-1.7, 0.3, 40.25]], np.float32)]
    for c in (1, 3, 4):
        src = rs.randint(0, 256, (19, 23, c), np.uint8)
        for M in mats + [draw_matrix(rs, 23, 19)[0] for _ in range(10)]:
            inv = inverse_map(M)
            for out_hw in ((19, 23), (1, 40), (31, 2)):
                np.testing.assert_array_equal(
                    native.warp_affine(src, inv, out_hw, 200),
                    warp_affine_ref(src, inv, out_hw, 200))


def _augmenters(**keys):
    port, jax = timage.GeometricAugmenter(), jimage.GeometricAugmenter()
    for k, v in dict(input_shape="3,40,40", rand_crop=1, **keys).items():
        port.set_param(k, str(v))
        jax.set_param(k, str(v))
    return port, jax


@pytest.mark.parametrize("keys", [
    BOWL, dict(BOWL, min_crop_size=32, max_crop_size=48),
    dict(rotate=90), dict(rotate_list="0,90,180"),
    dict(min_random_scale=0.9, max_random_scale=1.3, fill_value=0),
    dict(max_random_scale=1.5, min_img_size=50, max_img_size=60)])
def test_geometric_augmenter_matches_jax(keys):
    """Same draws from the same RandomState, the same output shape, and
    values within the warp's bar."""
    port, jax = _augmenters(**keys)
    rp, rj = np.random.RandomState(5), np.random.RandomState(5)
    src = np.random.RandomState(9)
    apart = total = 0
    for _ in range(30):
        img = src.randint(0, 256, (3, 48, 48)).astype(np.float32)
        got = port.process(img, rp)
        want = jax.process(img, rj)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        d = np.abs(got - want)
        assert d.max() <= 1
        apart += int(np.count_nonzero(d))
        total += d.size
        assert rp.randint(1 << 30) == rj.randint(1 << 30)
    assert apart <= SHARE * total, "%d of %d values apart" % (apart, total)


def test_geometric_augmenter_rotation():
    """The JAX package's case (tests/test_io_image.py): after a rotation
    of 90 degrees the bright top half lies on a side."""
    aug = timage.GeometricAugmenter()
    aug.set_param("input_shape", "3,24,24")
    aug.set_param("rotate", "90")
    aug.set_param("max_rotate_angle", "1")
    assert aug.need_process()
    rs = np.random.RandomState(0)
    img = np.zeros((3, 32, 32), np.float32)
    img[:, :16, :] = 200.0
    out = aug.process(img, rs)
    assert out.shape == (3, 24, 24)
    top_mean = out[:, :8, :].mean()
    left_mean = out[:, :, :8].mean()
    right_mean = out[:, :, -8:].mean()
    assert max(left_mean, right_mean) > top_mean + 30
