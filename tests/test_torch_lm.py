"""The port's LM serving slice on the CPU, against the JAX package: the
layers of a transformer LM (embed, split, add, softmax seq = 1, attention
with RoPE, grouped-query heads and a sliding window) against the JAX
layers' ``apply``, the whole net's forward, and KV-cached ``generate``
against JAX ``Trainer.generate`` from one JAX-written model file.

Inputs come from seeded numpy and pass between the packages as numpy
arrays. Tolerance: relative 1e-5 (the reference's PairTest bar) plus an
absolute 1e-5 of the largest magnitude of what is compared: the two
packages sum matrix products and the softmax in other orders (XLA's CPU
kernels against PyTorch's), which moves a value by a few float32 ulps of
its largest summands. Log-probabilities are compared to relative and
absolute 1e-5. Generated tokens must be equal, and each step's top-2
log-probability margin (from the JAX package's full forward) is asserted
to exceed twice that tolerance first, so that a flip is a finding and
not a flake.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu import api as japi
from cxxnet_tpu import models as jmodels
from cxxnet_tpu.layer import layers as JL
from cxxnet_tpu.layer.base import ApplyContext as JCtx
from cxxnet_tpu.layer.base import LabelInfo as JLabels
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import convert, models
from cxxnet_tpu_torch.layer import layers as TL
from cxxnet_tpu_torch.layer.base import ApplyContext, LabelInfo
from cxxnet_tpu_torch.ops import flash_attn

RTOL, ATOL_REL = 1e-5, 1e-5
LOGP_TOL = 1e-5
VOCAB, DIM, NHEAD, BATCH = 24, 64, 4, 4
GQA_WINDOW = "nkvhead = 2\nattn_window = 48\nrope = 1\n"


def _close(got, want, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL_REL * float(np.abs(want).max()),
        err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _layer_pair(jcls, tcls, keys, in_shapes):
    jl, tl = jcls(), tcls()
    for k, v in keys.items():
        jl.set_param(k, str(v))
        tl.set_param(k, str(v))
    assert jl.infer_shape(in_shapes) == tl.infer_shape(in_shapes)
    return jl, tl


# -- layers -------------------------------------------------------------

@pytest.mark.parametrize("pos_embed", [0, 1])
@pytest.mark.parametrize("decode_pos", [None, 5])
def test_embed_matches_jax(pos_embed, decode_pos):
    rng = np.random.RandomState(0)
    L = 12 if decode_pos is None else 3
    jl, tl = _layer_pair(JL.EmbedLayer, TL.EmbedLayer,
                         {"vocab_size": VOCAB, "nhidden": 16,
                          "pos_embed": pos_embed}, [(2, 1, 1, 12)])
    params = {"wmat": rng.randn(VOCAB, 16).astype(np.float32)}
    if pos_embed:
        params["pos"] = rng.randn(12, 16).astype(np.float32)
    assert {k: v.shape for k, v in params.items()} == tl.param_shapes()
    ids = rng.randint(0, VOCAB, (2, 1, 1, L)).astype(np.float32)
    want = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                    [jnp.asarray(ids)], JCtx(train=False,
                                             decode_pos=decode_pos))[0]
    got = tl.forward({k: _t(v) for k, v in params.items()}, [_t(ids)],
                     ApplyContext(decode_pos=decode_pos))[0]
    assert tuple(got.shape) == (2, 16, 1, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tl.visit_order() == jl.visit_order()


def test_split_and_add_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 1, 5).astype(np.float32)
    jl, tl = JL.SplitLayer(3), TL.SplitLayer(3)
    assert tl.infer_shape([x.shape]) == jl.infer_shape([x.shape])
    outs = tl.forward({}, [_t(x)], ApplyContext())
    assert len(outs) == 3 and all(np.array_equal(o.numpy(), x)
                                  for o in outs)
    ys = [rng.randn(2, 8, 1, 5).astype(np.float32) for _ in range(3)]
    ja, ta = JL.AddLayer(), TL.AddLayer()
    assert ta.infer_shape([y.shape for y in ys]) == \
        ja.infer_shape([y.shape for y in ys])
    want = ja.apply({}, [jnp.asarray(y) for y in ys], JCtx(train=False))[0]
    _close(ta.forward({}, [_t(y) for y in ys], ApplyContext())[0], want)
    with pytest.raises(ValueError, match="2-4 inputs"):
        ta.infer_shape([ys[0].shape])
    with pytest.raises(ValueError, match="shapes must all match"):
        ta.infer_shape([(2, 8, 1, 5), (2, 8, 1, 6)])


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
def test_softmax_seq_matches_jax(label_smooth):
    rng = np.random.RandomState(2)
    b, v, L = 3, VOCAB, 9
    keys = {"seq": 1, "batch_size": b}
    if label_smooth:
        keys["label_smooth"] = label_smooth
    jl, tl = _layer_pair(JL.SoftmaxLayer, TL.SoftmaxLayer, keys,
                         [(b, v, 1, L)])
    x = (rng.randn(b, v, 1, L) * 3).astype(np.float32)
    label = rng.randint(0, v, (b, L)).astype(np.float32)
    jctx = JCtx(train=True, labels=JLabels({"label": jnp.asarray(label)}))
    want = jl.apply({}, [jnp.asarray(x)], jctx)[0]
    tctx = ApplyContext(train=True, labels=LabelInfo({"label": _t(label)}))
    got = tl.forward({}, [_t(x)], tctx)[0]
    _close(got, want)
    _close(tctx.losses[0], jctx.losses[0])
    assert float(got.sum(1).sub(1).abs().max()) < 1e-5


def _attention_case(L, keys, seed, b=2, d=DIM):
    rng = np.random.RandomState(seed)
    keys = dict({"nhead": NHEAD}, **keys)
    jl, tl = _layer_pair(JL.AttentionLayer, TL.AttentionLayer, keys,
                         [(b, d, 1, L)])
    shapes = tl.param_shapes()
    params = {k: (rng.randn(*s) * 0.2).astype(np.float32)
              for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    return jl, tl, jparams, tparams, rng


ATTN_KEYS = {
    "causal": {"causal": 1},
    "noncausal": {"causal": 0},
    "rope_gqa_window": {"causal": 1, "rope": 1, "nkvhead": 2,
                        "attn_window": 48},
    "gqa1_rope_base": {"causal": 1, "nkvhead": 1, "rope": 1,
                       "rope_base": 500},
}


@pytest.mark.parametrize("L", [64, 192])
@pytest.mark.parametrize("case", sorted(ATTN_KEYS))
def test_attention_matches_jax(L, case):
    # L 64 takes the dense branch, L 192 the flash branch (plain version
    # on the CPU); the JAX package on the CPU takes the dense one for both
    assert flash_attn.supports(L, DIM // NHEAD) == (L >= 128)
    jl, tl, jp, tp, rng = _attention_case(L, ATTN_KEYS[case], 3)
    x = rng.randn(2, DIM, 1, L).astype(np.float32)
    want = jl.apply(jp, [jnp.asarray(x)], JCtx(train=False))[0]
    got = tl.forward(tp, [_t(x)], ApplyContext())[0]
    _close(got, want, case)
    assert tl.visit_order() == jl.visit_order()


@pytest.mark.parametrize("case", ["causal", "rope_gqa_window"])
def test_attention_decode_path_matches_jax(case):
    # a prefill of 150 positions (the flash branch in the port) and two
    # one-token steps against the cache, caches compared after each call
    L_max, plen = 200, 150
    jl, tl, jp, tp, rng = _attention_case(plen, ATTN_KEYS[case], 4)
    nkv = tl.nkvhead or tl.nhead
    shape = (2, nkv, L_max, DIM // NHEAD)
    jcache = {(7, n): jnp.zeros(shape, jnp.float32) for n in "kv"}
    tcache = {(7, n): torch.zeros(shape) for n in "kv"}
    for pos, L in ((0, plen), (plen, 1), (plen + 1, 1)):
        x = rng.randn(2, DIM, 1, L).astype(np.float32)
        jctx = JCtx(train=False, decode_pos=pos, kv_cache=jcache,
                    conn_index=7)
        want = jl.apply(jp, [jnp.asarray(x)], jctx)[0]
        tctx = ApplyContext(decode_pos=pos, kv_cache=tcache, conn_index=7)
        got = tl.forward(tp, [_t(x)], tctx)[0]
        _close(got, want, "%s at %d" % (case, pos))
        jcache = dict(jctx.cache_updates)
        tcache = dict(tctx.cache_updates)
        for key in jcache:
            _close(tcache[key], jcache[key], "cache %s at %d" % (key, pos))


def test_attention_refuses_what_is_not_ported():
    # the chunked flash-decode step and the suffix prefill are ported: the
    # keys are taken, bad values refused, and a suffix computes
    lay = TL.AttentionLayer()
    lay.set_param("decode_chunk", "256")
    assert lay.decode_chunk == 256
    with pytest.raises(ValueError, match="decode_chunk must be >= 0"):
        lay.set_param("decode_chunk", "-1")
    lay.set_param("decode_chunk", "0")
    # sequence parallelism is ported: both modes are taken, others named
    lay.set_param("sp_mode", "ring")
    assert lay.sp_mode == "ring"
    lay.set_param("sp_mode", "ulysses")
    assert lay.sp_mode == "ulysses"
    with pytest.raises(ValueError, match="ring or ulysses"):
        lay.set_param("sp_mode", "bogus")
    _, tl, _, tp, rng = _attention_case(8, {"causal": 1}, 5)
    cache = {(0, n): torch.zeros(2, NHEAD, 16, DIM // NHEAD) for n in "kv"}
    x = _t(rng.randn(2, DIM, 1, 12))
    tl.forward(tp, [x[..., :4]],
               ApplyContext(decode_pos=0, kv_cache=cache, conn_index=0))
    got = tl.forward(tp, [x[..., 4:]],
                     ApplyContext(decode_pos=4, kv_cache=cache, conn_index=0))
    whole = tl.forward(tp, [x], ApplyContext(
        decode_pos=0, conn_index=0,
        kv_cache={(0, n): torch.zeros(2, NHEAD, 16, DIM // NHEAD)
                  for n in "kv"}))
    _close(got[0], whole[0][..., 4:].numpy(), "suffix prefill")


# -- the whole net ----------------------------------------------------------

def _lm_cfg(seq, attn_extra="", nlayer=2):
    return models.transformer_lm_config(
        vocab=VOCAB, seq=seq, batch_size=BATCH, dim=DIM, nhead=NHEAD,
        nlayer=nlayer, dev="cpu", attn_extra=attn_extra)


@pytest.mark.parametrize("kw", [
    dict(vocab=50, dim=64, nhead=4, nlayer=2),
    dict(vocab=8192, dim=512, nhead=8, nlayer=4, attn_extra=GQA_WINDOW)])
def test_lm_netconfig_is_the_jax_packages(kw):
    assert models.transformer_lm_netconfig(**kw) == \
        jmodels.transformer_lm_netconfig(**kw)


def _train_rows(rs, rows, seq):
    """(ids, labels): rows of the sequence (phase + t) % VOCAB, which the
    LM learns within a few Adam steps."""
    phase = rs.randint(0, VOCAB, (rows, 1))
    toks = (phase + np.arange(seq + 1)[None, :]) % VOCAB
    return (toks[:, :seq].reshape(rows, 1, 1, seq).astype(np.float32),
            toks[:, 1:].astype(np.float32))


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """lm_files(seq, attn_extra, steps): a model file the JAX package
    initialised, trained ``steps`` Adam steps and wrote, made once."""
    made = {}

    def get(seq, attn_extra="", steps=0):
        key = (seq, attn_extra, steps)
        if key not in made:
            net = japi.Net(dev="cpu", cfg=_lm_cfg(seq, attn_extra))
            net.init_model()
            rs = np.random.RandomState(0)
            for _ in range(steps):
                net.update(*_train_rows(rs, BATCH, seq))
            made[key] = str(tmp_path_factory.mktemp("lm") / "jax.model")
            net.save_model(made[key])
        return made[key]
    return get


def _pair(fname, cfg):
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.load_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    return jnet, tnet


@pytest.mark.parametrize("seq", [64, 192])
@pytest.mark.parametrize("attn_extra", ["", GQA_WINDOW])
def test_lm_forward_matches_jax(lm_files, seq, attn_extra):
    jnet, tnet = _pair(lm_files(seq, attn_extra), _lm_cfg(seq, attn_extra))
    ids = np.random.RandomState(6).randint(
        0, VOCAB, (BATCH, 1, 1, seq)).astype(np.float32)
    before = flash_attn.launches
    for node in ("top[-1]", "blk0att", "blk1out"):
        _close(tnet.extract(ids, node), jnet.extract(ids, node), node)
    np.testing.assert_array_equal(tnet.predict(ids), jnet.predict(ids))
    assert flash_attn.launches == before


def test_params_from_jax_carries_embed_and_attention(lm_files):
    jnet = japi.Net(dev="cpu", cfg=_lm_cfg(64))
    jnet.load_model(lm_files(64))
    tnet = tapi.Net(dev="cpu", cfg=_lm_cfg(64))
    tnet.init_model()
    canon = jnet.net_.canonical_params()
    got = convert.params_from_jax(canon, tnet.net_.net, torch.device("cpu"))
    kinds = {lay.type_name: sorted(p) for lay, p in
             zip(tnet.net_.net.layers, got) if p}
    assert kinds["embed"] == ["pos", "wmat"]
    assert kinds["attention"] == ["wo", "wqkv"]
    for want, have in zip(canon, got):
        for k in want:
            np.testing.assert_array_equal(have[k].numpy(),
                                          np.asarray(want[k]))


# -- generate -------------------------------------------------------------

def _jax_logp(jnet, toks):
    """The JAX package's full forward on (b, l_max) tokens: log of the
    softmax node, (b, vocab, l_max), in float64."""
    b, L = toks.shape
    probs = jnet.extract(toks.reshape(b, 1, 1, L).astype(np.float32),
                         "top[-1]")
    return np.log(np.asarray(probs, np.float64).reshape(b, VOCAB, L))


def _assert_margins(logp, rows_steps):
    """Each (row, position) the generation picks at: the top-2 margin of
    the log-probabilities exceeds twice the comparison's tolerance."""
    for r, t in rows_steps:
        top2 = np.sort(logp[r, :, t])[-2:]
        tol = LOGP_TOL + LOGP_TOL * float(np.abs(top2).max())
        assert top2[1] - top2[0] > 2 * tol, \
            "row %d position %d: margin %.3g" % (r, t, top2[1] - top2[0])


def _teacher_forced_logp(tnet, toks, plen, total):
    """The port's decode loop over fixed tokens: log-probabilities of the
    prefill and of every step, (b, vocab, total - 1)."""
    b, L = toks.shape
    out = np.zeros((b, VOCAB, total - 1))

    def record(t0, probs):
        out[:, :, t0:t0 + probs.shape[2]] = np.log(
            probs.double().numpy())[:, :, :total - 1 - t0]
    tnet.net_.decode(torch.from_numpy(toks.astype(np.int64)),
                     torch.full((b,), total, dtype=torch.int32), plen,
                     total, on_probs=record)
    return out


@pytest.mark.parametrize("attn_extra", ["", GQA_WINDOW])
def test_generate_matches_jax(lm_files, attn_extra):
    seq, plen, n_new = 192, 140, 12
    cfg = _lm_cfg(seq, attn_extra)
    jnet, tnet = _pair(lm_files(seq, attn_extra, steps=25), cfg)
    rs = np.random.RandomState(9)
    prompts, _ = _train_rows(rs, BATCH, plen)
    prompts = prompts.reshape(BATCH, plen).astype(np.int64)
    prompts[:, -3:] = rs.randint(0, VOCAB, (BATCH, 3))
    want = np.asarray(jnet.net_.generate(prompts, n_new))
    toks = np.zeros((BATCH, seq), np.int64)
    toks[:, :plen] = prompts
    toks[:, plen:plen + n_new] = want
    jlogp = _jax_logp(jnet, toks)
    _assert_margins(jlogp, [(r, t) for r in range(BATCH)
                            for t in range(plen - 1, plen + n_new - 1)])
    got = tnet.generate(prompts, n_new)
    assert got.dtype == np.int32 and got.shape == (BATCH, n_new)
    np.testing.assert_array_equal(got, want)
    # prefill and teacher-forced step log-probabilities
    tlogp = _teacher_forced_logp(tnet, toks, plen, plen + n_new)
    np.testing.assert_allclose(tlogp, jlogp[:, :, :plen + n_new - 1],
                               rtol=LOGP_TOL, atol=LOGP_TOL)


def test_generate_ragged_prompt_lens_matches_jax(lm_files):
    seq, n_new = 192, 8
    cfg = _lm_cfg(seq)
    jnet, tnet = _pair(lm_files(seq, steps=25), cfg)
    rs = np.random.RandomState(10)
    prompts, _ = _train_rows(rs, BATCH, 150)
    prompts = prompts.reshape(BATCH, 150).astype(np.int64)
    lens = np.array([150, 131, 144, 138])
    want = np.asarray(jnet.net_.generate(prompts, n_new, prompt_lens=lens))
    for r in range(BATCH):
        toks = np.zeros((1, seq), np.int64)
        toks[0, :lens[r]] = prompts[r, :lens[r]]
        toks[0, lens[r]:lens[r] + n_new] = want[r]
        _assert_margins(_jax_logp(jnet, np.repeat(toks, BATCH, 0)),
                        [(0, t) for t in range(lens[r] - 1,
                                               lens[r] + n_new - 1)])
    got = tnet.generate(prompts, n_new, prompt_lens=lens)
    np.testing.assert_array_equal(got, want)
    # each row as its own uniform-length request
    for r in range(BATCH):
        row = np.repeat(prompts[r:r + 1, :lens[r]], BATCH, 0)
        np.testing.assert_array_equal(tnet.generate(row, n_new)[0], got[r])


def test_generate_checks(lm_files):
    cfg = _lm_cfg(64)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(lm_files(64))
    prompts = np.zeros((2, 60), np.int64)
    with pytest.raises(ValueError, match="exceeds the net's sequence"):
        tnet.generate(prompts, 5)
    with pytest.raises(ValueError, match="exceeds the net's sequence"):
        tnet.generate(prompts[:, :56], 10, prompt_lens=[50, 56])
    assert tnet.generate(prompts, 0).shape == (2, 0)
    # sampling is ported: it runs, and a negative top_k is refused
    assert tnet.generate(prompts[:, :10], 4, temperature=0.7).shape == (2, 4)
    with pytest.raises(ValueError, match="top_k must be >= 0"):
        tnet.generate(prompts[:, :10], 4, temperature=0.7, top_k=-1)
    with pytest.raises(ValueError, match="prompt_lens"):
        tnet.generate(prompts[:, :10], 4, prompt_lens=[0, 3])
    with pytest.raises(ValueError, match="prompts must be"):
        tnet.generate(np.zeros(10, np.int64), 4)


def test_generate_needs_causal_attention():
    cfg = _lm_cfg(64).replace("causal = 1", "causal = 0")
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.init_model()
    with pytest.raises(ValueError, match="not causal"):
        tnet.generate(np.zeros((BATCH, 8), np.int64), 2)


# -- lm.conf's JAX model file, Adam state included -----------------------

LM_CONF = "example/transformer/lm.conf"


def test_lm_conf_model_file_with_adam_state_loads(tmp_path):
    cfg = open(LM_CONF).read()
    jnet = japi.Net(dev="cpu", cfg=cfg)
    jnet.init_model()
    rs = np.random.RandomState(12)
    batches = []
    for _ in range(3):
        phase = rs.randint(0, 28, (16, 1))
        toks = (phase + np.arange(65)[None, :]) % 28
        batches.append((toks[:, :64].reshape(16, 1, 1, 64)
                        .astype(np.float32), toks[:, 1:].astype(np.float32)))
    for x, y in batches[:2]:
        jnet.update(x, y)
    fname = str(tmp_path / "lm.model")
    jnet.save_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=cfg)
    tnet.load_model(fname)
    jt, tt = jnet.net_, tnet.net_
    assert tt.epoch_counter == jt.epoch_counter == 2
    for jp, tp in zip(jt.canonical_params(), tt.params):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for js, ts in zip(jt.opt_state, tt.opt_state):
        assert sorted(js) == sorted(ts)
        for k in js:
            assert sorted(js[k]) == sorted(ts[k])
            for sk in js[k]:
                np.testing.assert_array_equal(ts[k][sk].numpy(),
                                              np.asarray(js[k][sk]))
    # one more Adam step on both sides from the loaded state
    x, y = batches[2]
    jnet.update(x, y)
    tnet.update(x, y)
    for i, (jp, tp) in enumerate(zip(jt.canonical_params(), tt.params)):
        for k in jp:
            _close(tp[k], jp[k], "layer %d %s after a step" % (i, k))
