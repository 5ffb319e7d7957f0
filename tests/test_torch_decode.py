"""The port's LM serving engine on the CPU, against the JAX package: sampling
(the exact-k mask, the draw's distribution and its keys), the per-row
uniform draw's plain version, the chunked flash-decode step, the suffix
prefill of a paged admission, ``generate`` under ``decode_chunk``,
``beam_generate`` and ``task = generate``.

The LM is the JAX package's decode-test net (tests/test_decode.py: embed
with learned positions or RoPE, one causal attention layer, a 1x1-conv
head, softmax) trained by the JAX package on the phase sequences
(phase + t) % vocab, its weights carried into the port by
``convert.params_from_jax``, so both packages compute the same function
and its next-token distributions are peaked: greedy tokens are compared
exactly. Attention outputs and logits are compared at 1e-5 (relative,
plus 1e-5 of the largest magnitude compared), float32 on both sides.

The sampling draw is the port's own (Philox, keyed on the request's seed,
the position and the row; the JAX package's ``jax.random.categorical`` bits
cannot be reproduced), so it is held to the distribution it must sample:
a chi-square test over 20,000 draws against the softmax (and the top-k
truncated softmax) at the 0.1 % level.
"""

import os

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from cxxnet_tpu import learn_task as jlt
from cxxnet_tpu.layer import layers as JL
from cxxnet_tpu.layer.base import ApplyContext as JCtx
from cxxnet_tpu.io.data import DataBatch
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu.parallel import ring as jring
from cxxnet_tpu.utils import serializer as jser
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch.layer import layers as TL
from cxxnet_tpu_torch.layer.base import ApplyContext
from cxxnet_tpu_torch.nnet import trainer as ttrainer
from cxxnet_tpu_torch.ops import attention as tatt
from cxxnet_tpu_torch.ops import random as trandom
from cxxnet_tpu_torch.parallel import ring as tring
from cxxnet_tpu_torch.utils import checkpoint as tckpt

VOCAB, SEQ = 12, 24
RTOL, ATOL_REL = 1e-5, 1e-5
CHI2_ALPHA = 1e-3
DRAWS = 20000

LM = """
netconfig = start
layer[0->1] = embed:emb
  vocab_size = %(vocab)d
  nhidden = 16
  %(embed_extra)s
  init_sigma = 0.05
layer[1->2,3] = split
layer[2->4] = attention:att1
  nhead = 4
  causal = 1
  init_sigma = 0.05
%(attn_extra)s
layer[3,4->5] = add
layer[5->6] = conv:head
  kernel_size = 1
  nchannel = %(vocab)d
  random_type = kaiming
layer[6->6] = softmax
  seq = 1
netconfig = end
input_shape = 1,1,%(seq)d
batch_size = 8
label_width = %(seq)d
label_vec[0,%(seq)d) = label
updater = adam
eta = 0.01
dev = cpu
"""
ROPE_GQA_WINDOW = dict(embed_extra="pos_embed = 0",
                       attn_extra="  rope = 1\n  nkvhead = 2\n"
                                  "  attn_window = 8\n")


def _conf(embed_extra="pos_embed = 1", attn_extra=""):
    return LM % {"vocab": VOCAB, "seq": SEQ, "embed_extra": embed_extra,
                 "attn_extra": attn_extra}


def _jax_trained(conf, steps):
    """The JAX package's decode-test trainer: Adam on the phase sequences
    (tests/test_decode.py ``_trained``)."""
    tr = JTrainer()
    for k, v in parse_config_string(conf):
        tr.set_param(k, v)
    tr.init_model()
    rs = np.random.RandomState(0)
    for _ in range(steps):
        phase = rs.randint(0, VOCAB, (8, 1))
        toks = (phase + np.arange(SEQ + 1)[None, :]) % VOCAB
        b = DataBatch()
        b.data = toks[:, :SEQ].reshape(8, 1, 1, SEQ).astype(np.float32)
        b.label = toks[:, 1:].astype(np.float32)
        b.batch_size = 8
        tr.update(b)
    return tr


def _port(conf, jtr):
    """The port's trainer over the same config with the JAX weights."""
    tr = ttrainer.Trainer()
    for k, v in parse_config_string(conf):
        tr.set_param(k, v)
    tr.init_model()
    tr.params = convert.params_from_jax(jtr.canonical_params(), tr.net,
                                        torch.device("cpu"))
    return tr


@pytest.fixture(scope="module")
def lms():
    """lms(variant, attn_extra, steps) -> (JAX trainer, port trainer),
    each made once; the JAX trainer of a variant is trained once and its
    weights reused under extra attention keys (decode_chunk) that do not
    change training."""
    made, trained = {}, {}

    def get(variant="pos", attn_extra="", steps=30):
        key = (variant, attn_extra, steps)
        if key not in made:
            kw = dict(ROPE_GQA_WINDOW) if variant == "rope_gqa_window" \
                else {}
            extra = kw.get("attn_extra", "") + attn_extra
            conf = _conf(kw.get("embed_extra", "pos_embed = 1"), extra)
            if (variant, steps) not in trained:
                trained[(variant, steps)] = _jax_trained(
                    _conf(kw.get("embed_extra", "pos_embed = 1"),
                          kw.get("attn_extra", "")), steps)
            base = trained[(variant, steps)]
            jtr = JTrainer()
            for k, v in parse_config_string(conf):
                jtr.set_param(k, v)
            jtr.init_model()
            jtr.params = [dict(p) for p in base.canonical_params()]
            made[key] = (jtr, _port(conf, base))
        return made[key]
    return get


def _close(got, want, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL_REL * float(np.abs(want).max()),
        err_msg=what)


def _prompts(seed, b, plen):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, plen))


# -- sampling -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 5, 11])
def test_topk_mask_is_jax_exact_k_with_ties(k):
    """The exact-k mask equals the JAX package's (``jax.lax.top_k`` one-hot
    sum) on log-probabilities full of ties: exactly k survive per row."""
    rs = np.random.RandomState(k)
    lg = rs.randint(0, 4, (64, VOCAB)).astype(np.float32) - 2.5
    lg[:8] = 0.25                                 # rows of one value
    _, idx = jax.lax.top_k(jnp.asarray(lg), k)
    want = np.asarray(jnp.sum(jax.nn.one_hot(idx, VOCAB), axis=1) > 0)
    got = ttrainer.topk_mask(torch.from_numpy(lg), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == k).all()


def _chi2(counts, p):
    """The p-value of ``counts`` under the distribution ``p``, cells with
    probability under 1e-12 held to be empty."""
    live = p > 1e-12
    assert counts[~live].sum() == 0, "a draw landed outside the support"
    exp = p[live] * counts.sum()
    return stats.chisquare(counts[live], exp).pvalue


@pytest.mark.parametrize("temperature, top_k", [(1.0, 0), (0.7, 0),
                                                (1.3, 5)])
def test_sampling_draws_follow_the_softmax(temperature, top_k):
    """20,000 draws (one row each, rows keyed 0 .. 19,999 under one seed
    and position) against softmax(log(p) / temperature), truncated to the
    top k: chi-square p-value above 0.1 %."""
    rs = np.random.RandomState(3)
    p = rs.dirichlet(np.ones(VOCAB) * 0.7).astype(np.float32)
    probs = torch.from_numpy(np.repeat(p[None], DRAWS, 0))
    pick = ttrainer.sample_pick(temperature, top_k)
    seeds = torch.full((DRAWS,), 7, dtype=torch.int64)
    got = pick(probs, seeds, 11, torch.arange(DRAWS)).numpy()
    lg = np.log(np.maximum(p.astype(np.float64), 1e-30)) / temperature
    if top_k:
        lg[np.argsort(-lg, kind="stable")[top_k:]] = -np.inf
    want = np.exp(lg - lg.max())
    want /= want.sum()
    counts = np.bincount(got, minlength=VOCAB)
    assert _chi2(counts, want) > CHI2_ALPHA


def test_sampling_is_keyed_on_seed_position_and_row_alone():
    """The draw of a row is a function of (seed, position, row): the same
    keys give the same tokens whatever else is in the batch, and another
    seed, position or row gives other draws; temperature 0 is the argmax."""
    rs = np.random.RandomState(4)
    probs = torch.from_numpy(rs.dirichlet(np.ones(VOCAB), 6)
                             .astype(np.float32))
    pick = ttrainer.sample_pick(1.0, 0)
    seeds = torch.tensor([5, 5, 5, 9, 9, 5])
    pos = torch.tensor([3, 3, 4, 3, 3, 3])
    rowid = torch.tensor([0, 1, 0, 0, 0, 0])
    got = pick(probs, seeds, pos, rowid)
    for r in range(6):
        alone = pick(probs[r:r + 1], seeds[r:r + 1], pos[r:r + 1],
                     rowid[r:r + 1])
        assert int(alone[0]) == int(got[r])
    u = trandom.uniform_rows(seeds, pos, rowid, VOCAB)
    assert torch.equal(u[0], u[5]) and not torch.equal(u[0], u[1])
    assert not torch.equal(u[0], u[2]) and not torch.equal(u[0], u[3])
    assert torch.equal(ttrainer.sample_pick(0.0, 3)(probs, seeds, 0, rowid),
                       probs.argmax(1))


def test_uniform_rows_plain_version():
    """Element j of row r is word j % 4 of the Philox block of the counter
    (j // 4, pos[r], rowid[r], 0) under the row's seed: row 0 at position 0
    and row id 0 is the flat draw of the same seed; the values lie on the
    2^-24 ladder in [0, 1); the rows of a batch are the rows drawn alone;
    a seed above 2^63 keeps its 64 bits."""
    n = 4 * 37 + 3
    flat = trandom.uniform_ref(99, (n,))
    zero = torch.zeros(1, dtype=torch.int64)
    one = trandom.uniform_rows_ref(torch.tensor([99]), zero, zero, n)
    assert torch.equal(one[0], flat)
    seeds = torch.tensor([trandom.seed_word(s) for s in (1, 2**63 + 5, 7)])
    pos = torch.tensor([0, 17, 2**31])
    rowid = torch.tensor([3, 0, 1])
    u = trandom.uniform_rows(seeds, pos, rowid, n)
    assert u.shape == (3, n) and u.dtype == torch.float32
    assert float(u.min()) >= 0 and float(u.max()) < 1
    scaled = u.double() * 2 ** 24
    assert torch.equal(scaled, scaled.round())
    for r in range(3):
        assert torch.equal(trandom.uniform_rows(
            seeds[r:r + 1], pos[r:r + 1], rowid[r:r + 1], n)[0], u[r])
    bits = trandom.philox4x32(torch.tensor([[5, 17, 0, 0]]),
                              trandom.seed_key(2**63 + 5))[0]
    want = (bits[1] >> 8).float() * 2.0 ** -24
    assert float(u[1, 21]) == float(want)
    with pytest.raises(ValueError, match="int64 tensor"):
        trandom.uniform_rows(seeds.int(), pos, rowid, n)
    with pytest.raises(ValueError, match="seed must be"):
        trandom.seed_word(-1)


# -- the chunked flash-decode step ---------------------------------------

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("nkv", [4, 2, 1])
def test_decode_attention_chunked_matches_jax(window, nkv):
    """decode_attention_chunked against the JAX function at every class of
    position (first chunk, a chunk boundary, interior, the last row), with
    grouped heads and a window, one position at a time and as a batch of
    rows at their own positions (each row bitwise its own call)."""
    rs = np.random.RandomState(3 + nkv)
    b, nh, L, d, chunk = 2, 4, 32, 8, 8
    k = rs.randn(b, nkv, L, d).astype(np.float32)
    v = rs.randn(b, nkv, L, d).astype(np.float32)
    positions = (0, 3, 7, 8, 15, 31)
    qs = {}
    for pos in positions:
        q = rs.randn(b, nh, 1, d).astype(np.float32)
        qs[pos] = q
        want = jring.decode_attention_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos=pos,
            window=window, chunk=chunk)
        got = tring.decode_attention_chunked(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            pos=pos, window=window, chunk=chunk)
        _close(got, want, "pos %d" % pos)
        dense = tatt.attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, window=window, q_offset=pos)
        _close(got, dense.numpy(), "pos %d vs dense" % pos)
    # a batch of rows at their own positions
    rows = [(r % b, pos) for r, pos in enumerate(positions)]
    q = torch.from_numpy(np.concatenate([qs[p][r:r + 1] for r, p in rows]))
    kk = torch.from_numpy(np.concatenate([k[r:r + 1] for r, _ in rows]))
    vv = torch.from_numpy(np.concatenate([v[r:r + 1] for r, _ in rows]))
    pos_t = torch.tensor([p for _, p in rows])
    got = tring.decode_attention_chunked(q, kk, vv, pos=pos_t, span=(0, 31),
                                         window=window, chunk=chunk)
    for i, (_, p) in enumerate(rows):
        alone = tring.decode_attention_chunked(
            q[i:i + 1], kk[i:i + 1], vv[i:i + 1], pos=p, window=window,
            chunk=chunk)
        assert torch.equal(got[i:i + 1], alone), (i, p)
    with pytest.raises(ValueError, match="span"):
        tring.decode_attention_chunked(q, kk, vv, pos=pos_t, chunk=chunk)


# -- the attention layer: per-row positions and the suffix prefill -------

def _attention_pair(keys, d=32):
    jl, tl = JL.AttentionLayer(), TL.AttentionLayer()
    for k, v in dict({"nhead": 4, "causal": 1}, **keys).items():
        jl.set_param(k, str(v))
        tl.set_param(k, str(v))
    shape = [(1, d, 1, SEQ)]
    assert jl.infer_shape(shape) == tl.infer_shape(shape)
    rs = np.random.RandomState(8)
    params = {k: (rs.randn(*s) * 0.3).astype(np.float32)
              for k, s in tl.param_shapes().items()}
    return jl, tl, params, rs


@pytest.mark.parametrize("keys", [{}, {"rope": 1, "nkvhead": 2,
                                       "attn_window": 6}],
                         ids=["plain", "rope_gqa_window"])
@pytest.mark.parametrize("p0", [5, 12])
def test_suffix_prefill_matches_jax(keys, p0):
    """A paged admission's suffix prefill: positions [p0, plen) against the
    cache holding [0, p0) (written by a prefill of the prefix) give the
    JAX layer's output and caches at 1e-5, and the rows of the whole
    prompt's prefill, bitwise."""
    d, plen = 32, 17
    jl, tl, params, rs = _attention_pair(keys, d)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = rs.randn(1, d, 1, plen).astype(np.float32)
    nkv = tl.nkvhead or tl.nhead
    shape = (1, nkv, SEQ, d // 4)

    def run_jax(pos, xs, cache):
        ctx = JCtx(train=False, decode_pos=pos, kv_cache=cache,
                   conn_index=0)
        out = jl.apply(jp, [jnp.asarray(xs)], ctx)[0]
        return out, dict(ctx.cache_updates)

    def run_port(pos, xs, cache):
        ctx = ApplyContext(decode_pos=pos, kv_cache=cache, conn_index=0)
        return tl.forward(tp, [torch.from_numpy(xs)], ctx)[0]

    jc = {(0, n): jnp.zeros(shape, jnp.float32) for n in "kv"}
    _, jc = run_jax(0, x[..., :p0], jc)
    want, jc = run_jax(p0, x[..., p0:], jc)
    tc = {(0, n): torch.zeros(shape) for n in "kv"}
    run_port(0, x[..., :p0], tc)
    got = run_port(p0, x[..., p0:], tc)
    _close(got, want, "suffix output")
    for key in jc:
        _close(tc[key], jc[key], "cache %s" % (key,))
    whole_c = {(0, n): torch.zeros(shape) for n in "kv"}
    whole = run_port(0, x, whole_c)
    assert torch.equal(got, whole[..., p0:])
    for key in tc:
        assert torch.equal(tc[key], whole_c[key])


@pytest.mark.parametrize("p0", [64, 192])
def test_suffix_prefill_through_flash_is_the_whole_prefills_rows(p0):
    """A prompt of 300 positions takes the flash kernel's plain version in
    its prefill; the suffix prefill then runs it over the live cache with
    the prefix's query rows zero, and its rows and caches are the whole
    prefill's, bitwise, and the JAX layer's at 1e-5."""
    d, plen, l_max = 64, 300, 512
    jl, tl = JL.AttentionLayer(), TL.AttentionLayer()
    for k, v in (("nhead", 4), ("causal", 1)):
        jl.set_param(k, str(v))
        tl.set_param(k, str(v))
    jl.infer_shape([(1, d, 1, l_max)])
    tl.infer_shape([(1, d, 1, l_max)])
    rs = np.random.RandomState(p0)
    params = {k: (rs.randn(*sh) * 0.2).astype(np.float32)
              for k, sh in tl.param_shapes().items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = rs.randn(1, d, 1, plen).astype(np.float32)
    shape = (1, 4, l_max, d // 4)

    def run(pos, xs, cache):
        ctx = ApplyContext(decode_pos=pos, kv_cache=cache, conn_index=0)
        return tl.forward(tp, [torch.from_numpy(xs)], ctx)[0]

    tc = {(0, n): torch.zeros(shape) for n in "kv"}
    run(0, x[..., :p0], tc)
    got = run(p0, x[..., p0:], tc)
    wc = {(0, n): torch.zeros(shape) for n in "kv"}
    whole = run(0, x, wc)
    assert torch.equal(got, whole[..., p0:])
    for key in tc:
        assert torch.equal(tc[key], wc[key])
    jc = {(0, n): jnp.zeros(shape, jnp.float32) for n in "kv"}
    for pos, xs in ((0, x[..., :p0]), (p0, x[..., p0:])):
        ctx = JCtx(train=False, decode_pos=pos, kv_cache=jc, conn_index=0)
        want = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                        [jnp.asarray(xs)], ctx)[0]
        jc = dict(ctx.cache_updates)
    _close(got, want, "suffix output against JAX")


def test_per_row_positions_are_the_rows_alone():
    """A step of rows at their own positions (a session step) gives each
    row what the same row gives alone at its position: embed's position
    rows (bitwise), RoPE's angles, the cache write and the mask (at
    1e-5: the projections' matrix products take 3 rows against 1)."""
    d = 32
    _, tl, params, rs = _attention_pair({"rope": 1, "nkvhead": 2}, d)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    el = TL.EmbedLayer()
    for k, v in (("vocab_size", VOCAB), ("nhidden", d), ("pos_embed", 1)):
        el.set_param(k, str(v))
    el.infer_shape([(3, 1, 1, SEQ)])
    ep = {"wmat": torch.from_numpy(rs.randn(VOCAB, d).astype(np.float32)),
          "pos": torch.from_numpy(rs.randn(SEQ, d).astype(np.float32))}
    shape = (3, 2, SEQ, d // 4)
    caches = {(0, n): torch.from_numpy(rs.randn(*shape).astype(np.float32))
              for n in "kv"}
    ids = torch.tensor([[3], [7], [1]]).reshape(3, 1, 1, 1)
    pos = torch.tensor([4, 0, 23])
    batch = {k: c.clone() for k, c in caches.items()}
    ctx = ApplyContext(decode_pos=pos, decode_span=(0, 23), kv_cache=batch,
                       conn_index=0)
    emb = el.forward(ep, [ids], ctx)[0]
    out = tl.forward(tp, [emb], ctx)[0]
    for r in range(3):
        one = {k: c[r:r + 1].clone() for k, c in caches.items()}
        c1 = ApplyContext(decode_pos=int(pos[r]), kv_cache=one, conn_index=0)
        e1 = el.forward(ep, [ids[r:r + 1]], c1)[0]
        assert torch.equal(e1, emb[r:r + 1])
        o1 = tl.forward(tp, [e1], c1)[0]
        _close(out[r:r + 1], o1.numpy(), "row %d" % r)
        for k in one:
            # the write lands at the row's position, nowhere else (the
            # projection's matrix product of 3 rows may round apart from
            # that of 1)
            _close(batch[k][r:r + 1], one[k].numpy(), "cache row %d" % r)
            keep = torch.ones(SEQ, dtype=torch.bool)
            keep[int(pos[r])] = False
            assert torch.equal(batch[k][r:r + 1, :, keep],
                               caches[k][r:r + 1, :, keep])


# -- generate, beam search and the CLI ------------------------------------

@pytest.mark.parametrize("variant", ["pos", "rope_gqa_window"])
def test_generate_with_decode_chunk_matches_jax(lms, variant):
    """Greedy generate with decode_chunk = 8 (the flash-decode step) equals
    the JAX package's, token for token, uniform and ragged; and equals the
    port's own dense decode."""
    jtr, ttr = lms(variant, "  decode_chunk = 8\n")
    _, dense = lms(variant)
    prompts = _prompts(9, 4, 7)
    lens = np.array([7, 3, 5, 4])
    for kw in ({}, {"prompt_lens": lens}):
        want = np.asarray(jtr.generate(prompts, 12, **kw))
        got = ttr.generate(prompts, 12, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(dense.generate(prompts, 12, **kw), got)
    assert ttr.net_cfg.layers and any(
        getattr(lay, "decode_chunk", 0) == 8
        for lay in ttr._net_for(4, 1).layers)


@pytest.mark.parametrize("variant", ["pos", "rope_gqa_window"])
def test_beam_generate_matches_jax(lms, variant):
    """beam_generate at widths 1, 3 and 4 equals the JAX package's, token
    for token, on a partly trained LM (where beams disagree with greedy);
    width 1 is greedy."""
    jtr, ttr = lms(variant, steps=12)
    prompts = _prompts(21, 8, 6)
    for beam in (1, 3, 4):
        want = np.asarray(jtr.beam_generate(prompts, 8, beam=beam))
        got = ttr.beam_generate(prompts, 8, beam=beam)
        assert got.dtype == np.int32 and got.shape == (8, 8)
        np.testing.assert_array_equal(got, want, err_msg="beam %d" % beam)
    np.testing.assert_array_equal(ttr.beam_generate(prompts, 8, beam=1),
                                  ttr.generate(prompts, 8))


def test_decode_nets_kept_are_the_most_recently_used(lms, monkeypatch):
    """The trainer keeps the decode nets of its SEQ_NETS_KEPT most
    recently used (batch, length) shapes, and a net made again after its
    shape was dropped gives the same tokens."""
    _, ttr = lms()
    monkeypatch.setattr(ttrainer, "SEQ_NETS_KEPT", 3)
    ttr._seq_nets.clear()
    prompts = _prompts(11, 2, 9)
    first = ttr.generate(prompts[:, :5], 4)
    ttr.generate(prompts[:, :7], 4)
    assert list(ttr._seq_nets) == [(2, 5), (2, 1), (2, 7)]
    ttr.generate(prompts, 4)
    assert list(ttr._seq_nets) == [(2, 7), (2, 1), (2, 9)]
    np.testing.assert_array_equal(ttr.generate(prompts[:, :5], 4), first)
    assert list(ttr._seq_nets) == [(2, 9), (2, 1), (2, 5)]


def test_generate_sampling_reproduces_and_stays_in_vocab(lms):
    """Sampled generate: the same seed gives the same tokens, another seed
    others; a tiny temperature is greedy; top_k = 1 is greedy; ragged rows
    continue their own prompts."""
    _, ttr = lms()
    prompts = _prompts(7, 8, 9)
    lens = np.array([4, 9, 6, 4, 9, 6, 5, 7])
    s1 = ttr.generate(prompts, 8, temperature=1.0, top_k=4, seed=1,
                      prompt_lens=lens)
    s2 = ttr.generate(prompts, 8, temperature=1.0, top_k=4, seed=1,
                      prompt_lens=lens)
    s3 = ttr.generate(prompts, 8, temperature=1.0, top_k=4, seed=2,
                      prompt_lens=lens)
    np.testing.assert_array_equal(s1, s2)
    assert (s1 != s3).any()
    assert s1.min() >= 0 and s1.max() < VOCAB
    greedy = ttr.generate(prompts, 8)
    np.testing.assert_array_equal(
        ttr.generate(prompts, 8, temperature=1e-4, seed=3), greedy)
    np.testing.assert_array_equal(
        ttr.generate(prompts, 8, temperature=0.9, top_k=1, seed=3), greedy)


def _write_jax_model(jtr, path):
    """The JAX trainer's model file, CRC-framed as both packages read."""
    w = jser.Writer()
    w.write_int32(0)
    jtr.save_model(w)
    tckpt.write_framed(path, w.getvalue())


def test_cli_generate_files_equal_the_jax_clis(lms, tmp_path):
    """task = generate through both command lines on one JAX-written model
    and one ragged prompt file: the gen_out files are byte for byte equal,
    greedy; sampled, the port's file equals Net.generate's tokens."""
    jtr, _ = lms()
    model = str(tmp_path / "lm.model")
    _write_jax_model(jtr, model)
    rs = np.random.RandomState(5)
    lines = [rs.randint(0, VOCAB, n).tolist() for n in (4, 7, 5, 7)]
    pf = tmp_path / "prompts.txt"
    pf.write_text("".join(" ".join(map(str, r)) + "\n" for r in lines))
    outs = {}
    for name, main in (("jax", jlt.main), ("port", tlt.main)):
        cf = tmp_path / ("%s.conf" % name)
        gout = tmp_path / ("%s.txt" % name)
        cf.write_text(_conf() + "task = generate\nmodel_in = %s\n"
                      "prompt_in = %s\ngen_out = %s\ngen_new = 5\n"
                      % (model, pf, gout))
        assert main([str(cf)]) == 0
        outs[name] = gout.read_bytes()
    assert outs["port"] == outs["jax"]
    assert len(outs["port"].splitlines()) == 4
    # sampling: the file holds Trainer.generate's tokens for the same keys
    cf = tmp_path / "sample.conf"
    gout = tmp_path / "sample.txt"
    cf.write_text(_conf() + "task = generate\nmodel_in = %s\nprompt_in = %s\n"
                  "gen_out = %s\ngen_new = 5\ngen_temperature = 0.8\n"
                  "gen_topk = 3\ngen_seed = 11\n" % (model, pf, gout))
    assert tlt.main([str(cf)]) == 0
    lt = tlt.LearnTask()
    for k, v in parse_config_string(_conf()):
        lt.set_param(k, v)
    lt.set_param("model_in", model)
    lt.task = "generate"
    lt._load_model()
    prompts = np.zeros((4, 7), np.int64)
    for i, r in enumerate(lines):
        prompts[i, :len(r)] = r
    want = lt.net_trainer.generate(prompts, 5, temperature=0.8, top_k=3,
                                   seed=11,
                                   prompt_lens=[len(r) for r in lines])
    got = [list(map(int, ln.split())) for ln in gout.read_text().splitlines()]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_cli_generate_refuses_out_of_vocab_ids(lms, tmp_path):
    jtr, _ = lms()
    model = str(tmp_path / "lm.model")
    _write_jax_model(jtr, model)
    pf = tmp_path / "prompts.txt"
    pf.write_text("1 2 3\n4 %d\n" % VOCAB)
    cf = tmp_path / "gen.conf"
    cf.write_text(_conf() + "task = generate\nmodel_in = %s\nprompt_in = %s\n"
                  "gen_out = %s\n" % (model, pf, tmp_path / "g.txt"))
    with pytest.raises(AssertionError, match="outside the net's vocab_size"):
        tlt.main([str(cf)])
    assert not os.path.exists(tmp_path / "g.txt")
