"""The arithmetic of the flash forward's tensor-core body
(cxxnet_tpu_torch/csrc/flash_fwd_tc.cuh, run by flash_fwd.cu and
ring_fwd_step.cu), emulated with numpy on the CPU.

The body forms S = Q K^T and P V as m16n8k8 TF32 mma.sync. An fp32 operand
x is split into big = rna(x), x rounded to TF32 to nearest with ties away
from zero, and small = x - big, of which the mma reads the top 19 bits; a
product is small*big + big*small + big*big (3xTF32). The tensor cores sum
each mma's products into its accumulator and round the result toward zero,
so every pair of k-steps (6 products) goes into a fresh accumulator and
reaches the running f32 sum by one rounded addition, in both products.
Head dims up to 128 run in the smallest of the widths 16, 32, 64, 128
(zero-filled columns), above that in chunks of 128 whose partial scores
are summed in chunk order. The online softmax folds one kv tile at a time
(64 keys up to width 64, 32 above), masked mass set to 0 outright. bf16
operands are exact in TF32: S is one product a k-step, summed straight in;
P stays f32 and split, V exact: two products a k-step.

Here each mma is emulated as an exact sum rounded toward zero to f32, and
out and lse are held to a float64 reference within 1e-5 of their largest
magnitude (fp32 inputs; the bar the card holds the kernel to) or 2e-2 (bf16
inputs, out rounded to bf16 as the kernel stores it; lse within 1e-5). The
ring's forward step is the same body with the carry (m, l, acc) read and
written: n steps reproduce the whole sequence, and a step that keeps no
pair leaves the carry bitwise as it was. One TF32 product per term misses
the 1e-5 bar: that is why the body takes three. The card holds the kernel
itself (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import flash_attn

F32, F64 = np.float32, np.float64
NEG_INF = F32(-1e30)
BAR = {"float32": 1e-5, "bfloat16": 2e-2}

CASES = [
    # (L, d, h, nkv, causal, window): ragged lengths, causal, windowed,
    # GQA, head dims in a compiled width (8 in 16) and in chunks of 128
    (100, 8, 4, 2, True, 0),
    (200, 64, 4, 1, True, 48),
    (130, 64, 2, 2, False, 0),
    (72, 256, 2, 1, True, 0),
    (96, 512, 2, 2, True, 32),
]


def tf32_rna(x):
    """float32 x rounded to TF32, to nearest with ties away from zero."""
    u = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(F32)


def tf32_read(x):
    """What the mma reads of a 32-bit operand: its top 19 bits."""
    u = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(F32)


def split(x):
    """(big, small as the mma reads it) of float32 x."""
    x = np.asarray(x, dtype=F32)
    big = tf32_rna(x)
    return big, tf32_read(x - big)


def round_toward_zero(x):
    """float64 x as float32, rounded toward zero."""
    f = x.astype(F32)
    over = np.abs(f.astype(F64)) > np.abs(x)
    f[over] = np.nextafter(f[over], F32(0))
    return f


def mma(c, a, b):
    """c + a b for TF32-valued float32 operands (..., M, 8) and (..., 8, N):
    the products summed exactly with c and rounded toward zero to f32."""
    return round_toward_zero(c.astype(F64) + a.astype(F64) @ b.astype(F64))


def products(acc, a, b, split_a, split_b, paired=True, n_products=3):
    """acc + a b over the last axis of a (..., M, K) and b (..., K, N), K a
    multiple of 8, as the body forms it: paired, every pair of k-steps in a
    fresh accumulator added to acc by one rounded f32 addition; otherwise
    every k-step's products straight into acc. 3xTF32 for a split (f32)
    operand, the exact value for a bf16 one; n_products=1 rounds each
    operand to TF32 once (1xTF32)."""
    K = a.shape[-1]
    if n_products == 1:
        ab, bb = tf32_rna(a), tf32_rna(b)
        a_s = b_s = None
    else:
        ab, a_s = split(a) if split_a else (np.asarray(a, F32), None)
        bb, b_s = split(b) if split_b else (np.asarray(b, F32), None)
    step = 16 if paired else 8
    for j in range(0, K, step):
        t = np.zeros_like(acc) if paired else acc
        for jj in range(j, min(j + step, K), 8):
            ka, kb = (Ellipsis, slice(jj, jj + 8)), \
                (Ellipsis, slice(jj, jj + 8), slice(None))
            if a_s is not None:
                t = mma(t, a_s[ka], bb[kb])
            if b_s is not None:
                t = mma(t, ab[ka], b_s[kb])
            t = mma(t, ab[ka], bb[kb])
        acc = (acc + t).astype(F32) if paired else t
    return acc


def widths(d):
    """(padded head dim, chunk width) of the body's layout for d."""
    if d <= 128:
        w = next(x for x in (16, 32, 64, 128) if x >= d)
        return w, w
    return -(-d // 128) * 128, 128


def mask(sq, skv, q_off, kv_off, causal, window):
    qpos = q_off + np.arange(sq)[:, None]
    kpos = kv_off + np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep = (qpos >= kpos) & ((qpos - kpos < window) if window else True)
    return keep


def step(q, k, v, carry, offs, causal, window, f32, n_products=3):
    """One pass of the body over the K/V block k, v (b, nkv, skv, d) for q
    (b, h, sq, d), folding it into carry = (m, l, acc) (f32; None starts
    empty) tile by tile; returns the new carry."""
    b, h, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = h // nkv
    dp, cw = widths(d)
    bk = 64 if dp <= 64 else 32
    n_tiles = -(-skv // bk)

    def pad(x, rows):
        out = np.zeros(x.shape[:2] + (rows, dp), F32)
        out[:, :, :x.shape[2], :d] = x
        return out
    qp = pad(q, sq)
    kp = np.repeat(pad(k, n_tiles * bk), g, axis=1)
    vp = np.repeat(pad(v, n_tiles * bk), g, axis=1)
    keep = np.zeros((sq, n_tiles * bk), bool)
    keep[:, :skv] = mask(sq, skv, offs[0], offs[1], causal, window)
    scale = F32(d ** -0.5)
    if carry is None:
        carry = (np.full((b, h, sq), NEG_INF, F32), np.zeros((b, h, sq), F32),
                 np.zeros((b, h, sq, d), F32))
    m, l, acc = (np.array(c, F32) for c in carry)
    acc = np.concatenate([acc, np.zeros(acc.shape[:3] + (dp - acc.shape[3],),
                                        F32)], axis=-1)
    for j in range(n_tiles):
        cols = slice(j * bk, (j + 1) * bk)
        kk, vv = kp[:, :, cols], vp[:, :, cols]
        s = np.zeros((b, h, sq, bk), F32)
        for c0 in range(0, dp, cw):
            part = products(np.zeros_like(s), qp[..., c0:c0 + cw],
                            np.swapaxes(kk[..., c0:c0 + cw], -1, -2),
                            f32, f32, paired=f32, n_products=n_products)
            s = (s + part).astype(F32)
        tile_keep = keep[:, cols]
        s = np.where(tile_keep, (s * scale).astype(F32), NEG_INF)
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp(m - m_new).astype(F32)
        p = np.where(tile_keep, np.exp(s - m_new[..., None]), 0).astype(F32)
        l = (l * alpha + p.sum(-1, dtype=F32)).astype(F32)
        acc = (acc * alpha[..., None]).astype(F32)
        acc = products(acc, p, vv, True, f32, n_products=n_products)
        m = m_new
    return m, l, acc[..., :d]


def emulated(q, k, v, causal, window, f32, n_products=3):
    """(out, lse) of the flash forward: one pass from an empty carry, out =
    acc / max(l, 1e-30), lse = m + log(l)."""
    m, l, acc = step(q, k, v, None, (0, 0), causal, window, f32, n_products)
    li = np.maximum(l, F32(1e-30))
    return (acc / li[..., None]).astype(F32), (m + np.log(li)).astype(F32)


def reference(q, k, v, causal, window):
    """(out, lse) in float64."""
    b, h, L, d = q.shape
    g = h // k.shape[1]
    kk = np.repeat(k, g, axis=1).astype(F64)
    vv = np.repeat(v, g, axis=1).astype(F64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(F64), kk) * d ** -0.5
    s = np.where(mask(L, L, 0, 0, causal, window), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    e = np.exp(s - mx)
    lse = (mx + np.log(e.sum(-1, keepdims=True)))[..., 0]
    return np.einsum("bhqk,bhkd->bhqd", e / e.sum(-1, keepdims=True), vv), lse


def inputs(L, d, h, nkv, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, n, L, d).astype(F32) for n in (h, nkv, nkv))
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(t).bfloat16().float().numpy()
                   for t in (q, k, v))
    return q, k, v


def errors(out, lse, want_out, want_lse, dtype):
    """max |got - want| / max |want| of out and lse; a bf16 out rounded to
    bf16 first, as the kernel stores it."""
    if dtype == "bfloat16":
        out = torch.from_numpy(out).bfloat16().float().numpy()
    return (float(np.abs(out - want_out).max() / np.abs(want_out).max()),
            float(np.abs(lse - want_lse).max() / np.abs(want_lse).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_tensor_core_forward_meets_the_bar(case, dtype):
    L, d, h, nkv, causal, window = case
    q, k, v = inputs(L, d, h, nkv, dtype, seed=L + d)
    want = reference(q, k, v, causal, window)
    got = emulated(q, k, v, causal, window, dtype == "float32")
    err_out, err_lse = errors(*got, *want, dtype)
    assert err_out <= BAR[dtype], err_out
    assert err_lse <= BAR["float32"], err_lse


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_one_tf32_product_misses_the_fp32_bar(case):
    L, d, h, nkv, causal, window = case
    q, k, v = inputs(L, d, h, nkv, "float32", seed=L + d)
    want = reference(q, k, v, causal, window)
    one = errors(*emulated(q, k, v, causal, window, True, n_products=1),
                 *want, "float32")
    three = errors(*emulated(q, k, v, causal, window, True), *want,
                   "float32")
    assert one[0] > BAR["float32"], one
    assert max(three) <= BAR["float32"], three


@pytest.mark.parametrize("n, L, d, h, nkv, window", [
    (4, 256, 64, 4, 2, 100),
    (2, 128, 256, 2, 1, 0),
])
def test_ring_steps_carry_the_forward(n, L, d, h, nkv, window):
    # n ring steps, device i folding the blocks of devices i, i - 1, ...
    # into its carry, give the whole sequence's out and lse; a step whose
    # block keeps no pair (a later device's block under the causal mask)
    # leaves the carry bitwise as it was
    q, k, v = inputs(L, d, h, nkv, "float32", seed=n + d)
    want_out, want_lse = reference(q, k, v, True, window)
    sh = L // n
    for i in range(n):
        rows = slice(i * sh, (i + 1) * sh)
        carry = None
        for t in range(n):
            src = (i - t) % n
            blk = slice(src * sh, (src + 1) * sh)
            new = step(q[:, :, rows], k[:, :, blk], v[:, :, blk], carry,
                       (i * sh, src * sh), True, window, True)
            if src > i:
                for a, b in zip(new, carry):
                    np.testing.assert_array_equal(a, b)
            carry = new
        m, l, acc = carry
        out = acc / np.maximum(l, F32(1e-30))[..., None]
        lse = m + np.log(l)
        assert np.abs(out - want_out[:, :, rows]).max() <= \
            BAR["float32"] * np.abs(want_out).max()
        assert np.abs(lse - want_lse[:, :, rows]).max() <= \
            BAR["float32"] * np.abs(want_lse).max()


@pytest.mark.parametrize("d", [64, 128])
def test_paired_accumulators_drift_less_than_a_straight_sum(d):
    # S = Q K^T summed straight into its accumulator rounds the whole score
    # toward zero at every mma (24 over 64 columns in fp32), a drift that
    # missed the forward's bar of 8 f32 epsilons of the largest |out| on the
    # card; a fresh accumulator per pair of k-steps rounds only the pair's
    # partial sum, as the body forms S and P V
    rng = np.random.RandomState(d)
    q, k = (rng.randn(2, 256, d).astype(F32) for _ in range(2))
    want = np.einsum("bqd,bkd->bqk", q.astype(F64), k.astype(F64))
    zero = np.zeros((2, 256, 256), F32)
    kt = np.swapaxes(k, -1, -2)
    err = {paired: products(zero, q, kt, True, True, paired=paired) - want
           for paired in (True, False)}
    toward_zero = float((-np.sign(want) * err[False]).mean())
    assert toward_zero > 0.5 * np.abs(err[False]).mean()
    assert np.abs(err[True]).mean() < 0.5 * np.abs(err[False]).mean()


def test_reference_is_the_ports_plain_forward():
    # the float64 reference above against flash_fwd_ref, which the card
    # tests hold the kernel to
    L, d, h, nkv, causal, window = CASES[1]
    q, k, v = inputs(L, d, h, nkv, "float32", seed=1)
    want_out, want_lse = reference(q, k, v, causal, window)
    out, lse = flash_attn.flash_fwd_ref(
        *(torch.from_numpy(t) for t in (q, k, v)), causal, None, window)
    assert np.abs(out.double().numpy() - want_out).max() <= \
        1e-5 * np.abs(want_out).max()
    assert np.abs(lse.double().numpy() - want_lse).max() <= \
        1e-5 * np.abs(want_lse).max()
