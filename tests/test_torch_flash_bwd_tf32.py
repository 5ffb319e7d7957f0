"""The arithmetic of the flash backward kernels' tensor-core products
(cxxnet_tpu_torch/csrc/flash_bwd_dq.cu, flash_bwd_dkv.cu, flash_mma.cuh),
emulated with numpy bit operations on the CPU.

The kernels run the backward's five products (S = Q K^T, dP = dO V^T,
dQ = dS K, dV = P^T dO, dK = dS^T Q) as m16n8k8 TF32 mma.sync. An fp32
operand x is split into big = rna(x), x rounded to TF32 (10 mantissa
bits) to nearest with ties away from zero as cvt.rna.tf32.f32 rounds, and
small = x - big, of which the mma reads the top 19 bits; a product is
small*big + big*small + big*big (3xTF32). A bf16 operand is exact in TF32:
two bf16 operands take one product, a bf16 and an f32 one (P or dS) two.

Here each product term is emulated that way and summed in float64, and
dq, dk, dv are held to a float64 reference within 1e-5 of their largest
magnitude (fp32 inputs; the bar the card holds the kernels to) or 2e-2
(bf16 inputs, the result rounded to bf16 as the kernels store it). One
TF32 product per term (the operands rounded once) misses the 1e-5 bar:
that is why the kernels take three. The order and rounding of the f32
sums are the card's and are held there (tests/test_torch_cuda.py,
chip_smoke.py).

The ring's dQ and dK/dV steps (ring_dq_step.cu, ring_dkv_step.cu) run the
same bodies with f32 carries read and written in place. Their ring is
emulated with the tensor cores' sums as well: each mma rounds toward zero
to f32, S and dP go straight into their accumulators, and every pair of
k-steps of dQ, dK and dV is summed in a fresh accumulator and added to the
carry by one rounded f32 addition (the paired products of
tests/test_torch_flash_fwd_tf32.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import _build, flash_attn
from tests.test_torch_flash_fwd_tf32 import mask, products

BAR = {"float32": 1e-5, "bfloat16": 2e-2}

CASES = [
    # (L, d, h, nkv, causal, window): ragged lengths, causal, windowed, GQA
    (100, 8, 4, 2, True, 0),
    (200, 64, 4, 1, True, 48),
    (130, 64, 2, 2, False, 0),
    (72, 256, 2, 1, True, 0),
    (96, 256, 4, 2, True, 32),
]


def tf32_rna(x):
    """float32 x rounded to TF32, to nearest with ties away from zero (as
    the kernels do it: half a TF32 ulp added to the magnitude bits, the low
    13 bits dropped; cvt.rna.tf32.f32 on finite x)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def tf32_read(x):
    """What the mma reads of a 32-bit operand: its top 19 bits."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    """(big, small as the mma reads it) of float32 x."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_rna(x)
    return big, tf32_read(x - big)


def product(spec, a, b, split_a, split_b, products=3):
    """einsum(spec, a, b) as the kernels' tensor cores form each term, in
    float64: 3xTF32 for a split (f32) operand, the exact value for a bf16
    one; products=1 rounds each operand to TF32 once (1xTF32)."""
    f64 = np.float64
    if products == 1:
        return np.einsum(spec, tf32_rna(a).astype(f64),
                         tf32_rna(b).astype(f64))
    ab, as_ = split(a) if split_a else (np.asarray(a, np.float32), None)
    bb, bs = split(b) if split_b else (np.asarray(b, np.float32), None)
    out = np.einsum(spec, ab.astype(f64), bb.astype(f64))
    if split_a:
        out += np.einsum(spec, as_.astype(f64), bb.astype(f64))
    if split_b:
        out += np.einsum(spec, ab.astype(f64), bs.astype(f64))
    return out


def keep_mask(L, causal, window):
    i = np.arange(L)[:, None]
    j = np.arange(L)[None, :]
    keep = np.ones((L, L), bool)
    if causal:
        keep = (i >= j) & ((i - j < window) if window else True)
    return keep


def inputs(L, d, h, nkv, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(2, n, L, d).astype(np.float32)
                   for n in (h, nkv, nkv, h))
    if dtype == "bfloat16":
        q, k, v, do = (torch.from_numpy(t).bfloat16().float().numpy()
                       for t in (q, k, v, do))
    return q, k, v, do


def forward_stats(q, k, v, do, causal, window):
    """f32 lse and D = rowsum(dO o O) of the forward, from float64, as the
    forward kernel and bwd_delta hand them to the backward kernels."""
    b, h, L, d = q.shape
    g = h // k.shape[1]
    keep = keep_mask(L, causal, window)
    kk = np.repeat(k, g, axis=1).astype(np.float64)
    vv = np.repeat(v, g, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) * d ** -0.5
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    p = np.exp(s - lse[..., None])
    out = np.einsum("bhqk,bhkd->bhqd", p, vv)
    delta = (do.astype(np.float64) * out).sum(-1)
    return lse.astype(np.float32), delta.astype(np.float32)


def backward(q, k, v, do, lse, delta, causal, window, emulate, f32_inputs,
             products=3):
    """(dq, dk, dv) in float64: the exact gradient at f32 lse and D
    (emulate=False), or the kernels' products (emulate=True) with f32 S,
    dP, P and dS between them as the kernels hold them in registers."""
    b, h, L, d = q.shape
    nkv = k.shape[1]
    g = h // nkv
    scale = d ** -0.5
    keep = keep_mask(L, causal, window)
    f64 = np.float64

    def mm(spec, a, x, split_a, split_x):
        if not emulate:
            return np.einsum(spec, np.asarray(a, f64), np.asarray(x, f64))
        return product(spec, a, x, split_a, split_x, products)

    qg = q.reshape(b, nkv, g, L, d)
    dog = do.reshape(b, nkv, g, L, d)
    lse_g = lse.reshape(b, nkv, g, L)[..., None].astype(f64)
    d_g = delta.reshape(b, nkv, g, L)[..., None].astype(f64)
    s = mm("bngqd,bnkd->bngqk", qg, k, f32_inputs, f32_inputs)
    dp = mm("bngqd,bnkd->bngqk", dog, v, f32_inputs, f32_inputs)
    if emulate:
        s, dp = s.astype(np.float32), dp.astype(np.float32)
    p = np.where(keep, np.exp(s.astype(f64) * scale - lse_g), 0.0)
    ds = p * (dp.astype(f64) - d_g) * scale
    if emulate:
        p, ds = p.astype(np.float32), ds.astype(np.float32)
    dq = mm("bngqk,bnkd->bngqd", ds, k, True, f32_inputs)
    dk = mm("bngqk,bngqd->bnkd", ds, qg, True, f32_inputs)
    dv = mm("bngqk,bngqd->bnkd", p, dog, True, f32_inputs)
    return dq.reshape(b, h, L, d), dk, dv


def errors(got, want, dtype):
    """max |got - want| / max |want| per gradient; bf16 results rounded to
    bf16 first, as the kernels store them."""
    out = []
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            g = torch.from_numpy(g.astype(np.float32)).bfloat16().double() \
                .numpy()
        out.append(float(np.abs(g - w).max() / np.abs(w).max()))
    return out


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)     # a TF32 ulp at 1
    half = np.float32(2.0 ** -11)
    below = np.nextafter(one + half, np.float32(0))
    x = np.array([one + half, -(one + half), below, one + half + 2 ** -20,
                  np.float32(3.0), np.float32(0.0), np.float32(np.inf),
                  np.finfo(np.float32).max], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                     np.inf, np.inf], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    assert not np.any(tf32_rna(x).view(np.uint32) & np.uint32(0x1fff))


def test_split_is_exact_and_small_is_within_half_a_tf32_ulp():
    x = np.random.RandomState(3).randn(100000).astype(np.float32) * 7
    big = tf32_rna(x)
    small = x - big
    np.testing.assert_array_equal(big.astype(np.float64) + small, x)
    assert np.all(np.abs(small) <= np.abs(x) * 2.0 ** -11)
    # what the mma reads of small differs from it by less than a TF32 ulp
    # of small, 2^-21 of x
    assert np.all(np.abs(tf32_read(small) - small) <=
                  np.abs(x) * 2.0 ** -21)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_tensor_core_products_meet_the_bar(case, dtype):
    L, d, h, nkv, causal, window = case
    q, k, v, do = inputs(L, d, h, nkv, dtype, seed=L + d)
    lse, delta = forward_stats(q, k, v, do, causal, window)
    f32 = dtype == "float32"
    want = backward(q, k, v, do, lse, delta, causal, window, False, f32)
    got = backward(q, k, v, do, lse, delta, causal, window, True, f32)
    for name, err in zip(("dq", "dk", "dv"), errors(got, want, dtype)):
        assert err <= BAR[dtype], (name, err)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_one_tf32_product_misses_the_fp32_bar(case):
    L, d, h, nkv, causal, window = case
    q, k, v, do = inputs(L, d, h, nkv, "float32", seed=L + d)
    lse, delta = forward_stats(q, k, v, do, causal, window)
    want = backward(q, k, v, do, lse, delta, causal, window, False, True)
    one = backward(q, k, v, do, lse, delta, causal, window, True, True,
                   products=1)
    three = backward(q, k, v, do, lse, delta, causal, window, True, True)
    err_one = errors(one, want, "float32")
    err_three = errors(three, want, "float32")
    assert min(err_one) > BAR["float32"], err_one
    assert max(err_three) <= BAR["float32"], err_three


def test_reference_is_the_ports_plain_backward():
    # the float64 reference above against flash_bwd_ref, which the card
    # tests hold the kernels to, at the forward statistics flash_fwd_ref
    # gives
    L, d, h, nkv, causal, window = CASES[1]
    q, k, v, do = inputs(L, d, h, nkv, "float32", seed=1)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = flash_attn.flash_fwd_ref(tq, tk, tv, causal, None, window)
    delta = flash_attn.bwd_delta(out, tdo)
    want = backward(q, k, v, do, lse.numpy(), delta.numpy(), causal, window,
                    False, True)
    got = flash_attn.flash_bwd_ref(tq, tk, tv, out, lse, tdo, causal, None,
                                   window)
    for g, w in zip(got, want):
        assert float(np.abs(g.double().numpy() - w).max()) <= \
            1e-5 * float(np.abs(w).max())


def q_tiles_for_kv(ks, q_off, sq, bq, bk, window):
    """q tiles [begin, end) of bq rows the causal key tile at global
    position ks feeds (flash_common.cuh's q_tiles_for_kv)."""
    begin = max((ks - q_off) // bq, 0)
    end = -(-sq // bq)
    if window > 0:
        end = min((ks - q_off + bk - 2 + window) // bq + 1, end)
    return begin, end


def kv_tiles_for_q(qs, kv_off, skv, bq, bk, window):
    """kv tiles [begin, end) of bk keys the causal q tile at global
    position qs needs (flash_common.cuh's kv_tiles_for_q)."""
    end = min((qs + bq - 1 - kv_off) // bk + 1, -(-skv // bk))
    begin = 0
    if window > 0:
        lo = qs - window - bk + 2 - kv_off
        begin = 0 if lo <= 0 else -(-lo // bk)
    return begin, end


def ring_bwd_step(q, k, v, do, lse, delta, dq, dk, dv, offs, window):
    """One causal ring step of the backward bodies on fp32 inputs: q, dO
    (b, h, sq, d), the block k, v (b, nkv, skv, d), the carries dq (b, h,
    sq, d) and dk, dv at query-head resolution (b, h, skv, d). The dQ body
    walks 64-row q tiles over the kv tiles they need, the dK/dV body
    64-key blocks over the q tiles they feed; a block with none leaves its
    carry as it is. Returns the new carries."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    skv = k.shape[2]
    kk, vv = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    scale = np.float32(d ** -0.5)
    zero = np.zeros((b, h, sq, skv), np.float32)
    s = products(zero, q, np.swapaxes(kk, -1, -2), True, True, paired=False)
    dp = products(zero, do, np.swapaxes(vv, -1, -2), True, True,
                  paired=False)
    keep = mask(sq, skv, offs[0], offs[1], True, window)
    p = np.where(keep, np.exp(s * scale - lse[..., None]), 0)
    p = p.astype(np.float32)
    ds = (p * (dp - delta[..., None]) * scale).astype(np.float32)
    dq, dk, dv = (np.array(t, np.float32) for t in (dq, dk, dv))
    bk = 16 if d == 128 else 32  # the dQ body's kv tile
    for q0 in range(0, sq, 64):
        kb, ke = kv_tiles_for_q(offs[0] + q0, offs[1], skv, 64, bk, window)
        if ke > kb:
            rows, keys = slice(q0, q0 + 64), slice(kb * bk, ke * bk)
            dq[:, :, rows] = products(dq[:, :, rows], ds[:, :, rows, keys],
                                      kk[:, :, keys], True, True)
    bq = 64 if d <= 64 else 16 if d == 128 else 32  # the dK/dV body's
    for k0 in range(0, skv, 64):
        qb, qe = q_tiles_for_kv(offs[1] + k0, offs[0], sq, bq, 64, window)
        if qe > qb:
            keys, rows = slice(k0, k0 + 64), slice(qb * bq, qe * bq)
            pt = np.swapaxes(p[:, :, rows, keys], -1, -2)
            dst = np.swapaxes(ds[:, :, rows, keys], -1, -2)
            dv[:, :, keys] = products(dv[:, :, keys], pt, do[:, :, rows],
                                      True, True)
            dk[:, :, keys] = products(dk[:, :, keys], dst, q[:, :, rows],
                                      True, True)
    return dq, dk, dv


@pytest.mark.parametrize("n, L, d, h, nkv, window", [
    (4, 256, 64, 4, 2, 100),
    (2, 128, 256, 2, 1, 0),
])
def test_ring_steps_carry_the_backward(n, L, d, h, nkv, window):
    # n ring steps: device i carries its dq in place over the blocks of
    # devices i, i - 1, ...; block j carries dk, dv at query-head
    # resolution over devices j, j + 1, ..., summed per group after the
    # ring. Together they give the whole sequence's gradients; a step whose
    # block keeps no pair leaves every carry bitwise as it was
    q, k, v, do = inputs(L, d, h, nkv, "float32", seed=n + d)
    lse, delta = forward_stats(q, k, v, do, True, window)
    want = backward(q, k, v, do, lse, delta, True, window, False, True)
    sh = L // n
    b, g = q.shape[0], h // nkv
    rows = [slice(i * sh, (i + 1) * sh) for i in range(n)]
    zero = np.zeros((b, h, sh, d), np.float32)
    dq = [zero] * n
    dkv = [(zero, zero)] * n  # the carries of block j
    for t in range(n):
        for i in range(n):
            j = (i - t) % n  # device i holds block j
            qi, kj = rows[i], rows[j]
            new = ring_bwd_step(q[:, :, qi], k[:, :, kj], v[:, :, kj],
                                do[:, :, qi], lse[:, :, qi],
                                delta[:, :, qi], dq[i], *dkv[j],
                                (i * sh, j * sh), window)
            if not mask(sh, sh, i * sh, j * sh, True, window).any():
                for a, c in zip(new, (dq[i],) + dkv[j]):
                    np.testing.assert_array_equal(a, c)
            dq[i], dkv[j] = new[0], new[1:]
    got = (np.concatenate(dq, axis=2),) + tuple(
        np.concatenate([c[e].reshape(b, nkv, g, sh, d).sum(2) for c in dkv],
                       axis=2) for e in range(2))
    for name, gg, w in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(gg - w).max() / np.abs(w).max())
        assert err <= BAR["float32"], (name, err)


SOURCES = sorted(f for f in os.listdir(_build.CSRC_DIR)
                 if f.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("name", SOURCES)
def test_csrc_includes_name_sources_that_exist(name):
    # every local #include of a kernel source names a file of csrc/, and
    # none names the SIMT attention bodies the tensor-core bodies replaced
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        text = f.read()
    for inc in re.findall(r'^#include "([^"]+)"', text, re.M):
        assert inc in SOURCES, (name, inc)
    for gone in ("flash_bwd_dq.cuh", "flash_bwd_dkv.cuh"):
        assert gone not in text, (name, gone)
