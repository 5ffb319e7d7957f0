"""The port's sequence-parallel slice on the CPU, against the JAX package in
the same process: the plain versions of the ring-step kernels step by step
with their carries, the kernel ring and the dense ring over n virtual
ranks, Ulysses, and the attention layer and an Adam update of a narrow LM
under ``seq_parallel = 2``. JAX runs as tests/test_ring_flash.py runs it:
the Pallas ring kernels in interpret mode (``ops.set_use_pallas(True)``,
``CXXNET_RING=flash``, set and restored inside each test that needs them)
on the conftest's virtual CPU mesh.

Tolerances and why:

- one ring step against JAX's kernel: 1e-5 of the largest magnitude of
  each carry (the JAX kernel sums per tile in f32, the plain version
  densely); a wholly masked step leaves the carry bitwise unchanged.
- the rings and Ulysses against JAX and the dense reference: 2e-4, the
  JAX package's own bar for its ring (tests/test_ring_flash.py) and for
  Ulysses with its flash kernel (tests/test_parallel.py).
- the LM under seq_parallel = 2 against JAX's Trainer on a 2-device mesh,
  from one model file: loss relative 1e-5, gradients 1e-5 of each
  tensor's largest magnitude, parameters after the update 1e-2 of eta
  (as tests/test_torch_lm_train.py, whose docstring gives the reasons).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from cxxnet_tpu import api as japi
from cxxnet_tpu import ops as jops
from cxxnet_tpu.ops import ring_flash as jrf
from cxxnet_tpu.parallel import ring as jring
from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import models
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.layer import layers as TL
from cxxnet_tpu_torch.layer.base import ApplyContext
from cxxnet_tpu_torch.ops import flash_attn, ring_flash
from cxxnet_tpu_torch.parallel import ring

NEG_INF = -1e30
STEP_TOL, RING_TOL = 1e-5, 2e-4


@pytest.fixture
def flash_ring_env():
    """JAX's ring on its Pallas step kernels, interpreted on the CPU."""
    os.environ["CXXNET_RING"] = "flash"
    jops.set_use_pallas(True)
    yield
    jops.set_use_pallas(None)
    os.environ.pop("CXXNET_RING", None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, tol, what):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = want > 0.5 * NEG_INF
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want[finite]).max()),
                               err_msg=what)


# (name, bh, group, sq, skv, d, causal, window, offsets of the steps taken
# in turn from the seeded carry): every class of offsets a step meets
STEP_CASES = [
    ("diagonal", 2, 1, 128, 128, 16, True, 0, [(128, 128)]),
    ("visible_after_diagonal", 2, 1, 128, 128, 16, True, 0,
     [(256, 256), (256, 0)]),
    ("masked_after_diagonal", 2, 1, 128, 128, 16, True, 0,
     [(128, 128), (128, 256)]),
    ("window_cut", 2, 1, 128, 256, 16, True, 200, [(256, 256), (256, 0)]),
    ("noncausal_sq_ne_skv", 2, 1, 256, 128, 16, False, 0,
     [(0, 128), (0, 0)]),
    ("gqa_window", 4, 2, 128, 128, 16, True, 100, [(256, 256), (256, 128)]),
    ("d264_gqa", 2, 2, 128, 128, 264, True, 0, [(128, 128), (128, 0)]),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_step_plain_versions_match_jax(case):
    name, bh, g, sq, skv, d, causal, window, steps = case
    rs = np.random.RandomState(len(name))
    bkv = bh // g
    scale = d ** -0.5
    q, do = (rs.randn(bh, sq, d).astype(np.float32) for _ in range(2))
    blocks = [(rs.randn(bkv, skv, d).astype(np.float32),
               rs.randn(bkv, skv, d).astype(np.float32)) for _ in steps]
    kw = dict(causal=causal, scale=scale, window=window)

    def jexpand(x):  # JAX's kernels take k/v at query-head resolution
        return np.repeat(x, g, axis=0)

    # the forward's carry, step by step
    m = np.full((bh, sq, 1), NEG_INF, np.float32)
    l = np.zeros((bh, sq, 1), np.float32)
    acc = np.zeros((bh, sq, d), np.float32)
    tc = [torch.from_numpy(x) for x in (m, l, acc)]
    jc = (m, l, acc)
    for i, ((k, v), offs) in enumerate(zip(blocks, steps)):
        before = [t.clone() for t in tc]
        tc = ring_flash.fwd_step_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), *tc, offs, **kw)
        jc = jrf.fwd_step(q, jexpand(k), jexpand(v), *jc,
                          jnp.asarray(offs, jnp.int32), interpret=True, **kw)
        for nm, a, b in zip(("m", "l", "acc"), tc, jc):
            _close(a, b, STEP_TOL, "%s step %d %s" % (name, i, nm))
        if name.startswith("masked") and i == 1:
            for a, b in zip(tc, before):
                assert torch.equal(a, b)
    # the backward's carries from the forward's lse
    lse = (tc[0] + torch.log(tc[1].clamp_min(1e-30))).numpy()
    delta = rs.randn(bh, sq, 1).astype(np.float32)
    # dK/dV carries at query-head resolution, JAX's own: JAX's kernel reads
    # K/V expanded to the query heads, the port's the grouped block
    jq = np.zeros((bh, sq, d), np.float32)
    jk = jv = np.zeros((bh, skv, d), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(x)) for x in (jq, jk, jv))
    for i, ((k, v), offs) in enumerate(zip(blocks, steps)):
        args = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
        before = [t.clone() for t in (tq, tk, tv)]
        tq = ring_flash.dq_step_ref(*args, tq, offs, **kw)
        tk, tv = ring_flash.dkv_step_ref(*args, tk, tv, offs, **kw)
        jargs = (q, jexpand(k), jexpand(v), do, lse, delta)
        jo = jnp.asarray(offs, jnp.int32)
        jq = jrf.dq_step(*jargs, jq, jo, interpret=True, **kw)
        jk, jv = jrf.dkv_step(*jargs, jk, jv, jo, interpret=True, **kw)
        for nm, a, b in (("dq", tq, jq), ("dk", tk, jk), ("dv", tv, jv)):
            _close(a, b, STEP_TOL, "%s step %d %s" % (name, i, nm))
        if name.startswith("masked") and i == 1:
            for a, b in zip((tq, tk, tv), before):
                assert torch.equal(a, b)


def _qkv(b=1, h=2, nkv=2, s=512, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, s, d).astype(np.float32),
            rs.randn(b, nkv, s, d).astype(np.float32),
            rs.randn(b, nkv, s, d).astype(np.float32))


def _mesh(n=4):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _port_and_grads(fn, q, k, v, w, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    return out, grads


def _jax_and_grads(fn, q, k, v, w, **kw):
    out = fn(q, k, v, **kw)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, **kw) * w),
                     argnums=(0, 1, 2))(q, k, v)
    return out, grads


@pytest.mark.parametrize("causal, nkv, window", [
    (True, 2, 0), (False, 2, 0), (True, 1, 100)])
def test_kernel_ring_matches_jax_ring(flash_ring_env, causal, nkv, window):
    # L 512 over 4 ranks: shards of 128, which ring_flash.supports takes
    q, k, v = _qkv(nkv=nkv, seed=1)
    w = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    assert ring_flash.supports(128, 128, 16)
    mesh = _mesh()
    jout, jgrads = _jax_and_grads(
        lambda *a, **kw: jring.ring_attention(*a, mesh, **kw), q, k, v, w,
        causal=causal, window=window)
    ref = jring.attention_reference(q, k, v, causal=causal, window=window)
    tout, tgrads = _port_and_grads(ring.ring_attention, q, k, v, w, n=4,
                                   causal=causal, window=window)
    _close(tout, jout, RING_TOL, "out vs JAX ring")
    _close(tout, ref, RING_TOL, "out vs attention_reference")
    for nm, a, b in zip("qkv", tgrads, jgrads):
        _close(a, b, RING_TOL, "d%s vs JAX ring" % nm)


@pytest.mark.parametrize("causal, nkv, window, q_chunk", [
    (True, 2, 0, 0), (False, 1, 0, 0), (True, 1, 20, 5)])
def test_dense_ring_matches_jax_ring(causal, nkv, window, q_chunk):
    # L 64 over 4 ranks: shards of 16, which ring_flash.supports refuses,
    # so both packages run the dense ring (JAX without CXXNET_RING)
    q, k, v = _qkv(nkv=nkv, s=64, seed=2)
    w = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    assert not ring_flash.supports(16, 16, 16)
    mesh = _mesh()
    jout, jgrads = _jax_and_grads(
        lambda *a, **kw: jring.ring_attention(*a, mesh, **kw), q, k, v, w,
        causal=causal, window=window, q_chunk=q_chunk)
    tout, tgrads = _port_and_grads(ring.ring_attention, q, k, v, w, n=4,
                                   causal=causal, window=window,
                                   q_chunk=q_chunk)
    _close(tout, jout, RING_TOL, "out vs JAX dense ring")
    for nm, a, b in zip("qkv", tgrads, jgrads):
        _close(a, b, RING_TOL, "d%s vs JAX dense ring" % nm)


@pytest.mark.parametrize("s, causal, flash", [(64, False, False),
                                              (128, True, True)])
def test_ulysses_matches_jax(s, causal, flash):
    # at L 128 the local attention is the flash path in both packages (the
    # JAX one with Pallas forced on, interpreted)
    q, k, v = _qkv(h=8, nkv=4, s=s, seed=5)
    w = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    mesh = _mesh()
    if flash:
        jops.set_use_pallas(True)
    try:
        jout, jgrads = _jax_and_grads(
            lambda *a, **kw: jring.ulysses_attention(*a, mesh, **kw), q, k,
            v, w, causal=causal)
    finally:
        jops.set_use_pallas(None)
    assert flash_attn.supports(s, 16) == flash
    tout, tgrads = _port_and_grads(ring.ulysses_attention, q, k, v, w, n=4,
                                   causal=causal)
    _close(tout, jout, RING_TOL, "out vs JAX ulysses")
    for nm, a, b in zip("qkv", tgrads, jgrads):
        _close(a, b, RING_TOL, "d%s vs JAX ulysses" % nm)


def test_ring_and_ulysses_refuse_what_they_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(h=4, nkv=2, s=64))
    with pytest.raises(ValueError, match="one of the two"):
        ring.ring_attention(q, k, v)
    with pytest.raises(ValueError, match="does not split into 3"):
        ring.ring_attention(q, k, v, n=3)
    with pytest.raises(ValueError, match="kv heads \\(2\\) divisible"):
        ring.ulysses_attention(q, k, v, n=4)
    with pytest.raises(ValueError, match="heads \\(4\\) divisible"):
        ring.ulysses_attention(q, k, v, n=8)
    with pytest.raises(ValueError, match="requires causal"):
        ring.ring_attention(q, k, v, n=2, window=8)


# the narrow LM of the seq_parallel cases: vocab 64, d_model 64, 4 heads
VOCAB, DIM, NHEAD, SEQ, BATCH, ETA = 64, 64, 4, 256, 2, 0.003
SP_EXTRA = {"mha": "", "gqa_window_rope": "nkvhead = 1\nattn_window = 64\n"
                                          "rope = 1\n"}


@pytest.mark.parametrize("extra", sorted(SP_EXTRA))
@pytest.mark.parametrize("sp_mode", ["ring", "ulysses"])
def test_attention_layer_seq_parallel_matches_jax(flash_ring_env, sp_mode,
                                                  extra):
    # the layer alone, forward and input gradient, on one set of weights
    from cxxnet_tpu.layer import layers as JL
    from cxxnet_tpu.layer.base import ApplyContext as JCtx
    cfg = [("nhead", str(NHEAD)), ("causal", "1"), ("sp_mode", sp_mode)] + \
        [tuple(kv.split(" = ")) for kv in SP_EXTRA[extra].splitlines()]
    jl, tl = JL.AttentionLayer(), TL.AttentionLayer()
    for name, val in cfg:
        jl.set_param(name, val)
        tl.set_param(name, val)
    shape = (BATCH, DIM, 1, SEQ)
    jl.infer_shape([shape])
    tl.infer_shape([shape])
    jp = jl.init_params(np.random.RandomState(0))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    w = np.random.RandomState(4).randn(*shape).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "sp"))

    def jfwd(x_):
        return jl.apply(jp, [x_], JCtx(train=False, mesh=mesh))[0]
    jout = jfwd(x)
    jdx = jax.grad(lambda x_: jnp.sum(jfwd(x_) * w))(x)
    xt = torch.from_numpy(x).requires_grad_()
    tout = tl.forward(tp, [xt], ApplyContext(seq_parallel=2))[0]
    tdx, = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), [xt])
    _close(tout, jout, STEP_TOL, "%s %s out" % (sp_mode, extra))
    _close(tdx, jdx, STEP_TOL, "%s %s dx" % (sp_mode, extra))


def _cfg(extra, sp_mode, dev, sp):
    return models.transformer_lm_config(
        vocab=VOCAB, seq=SEQ, batch_size=BATCH, dim=DIM, nhead=NHEAD,
        nlayer=2, dev=dev,
        attn_extra=SP_EXTRA[extra] + "sp_mode = %s\n" % sp_mode) + \
        "seq_parallel = %d\n" % sp


@pytest.mark.parametrize("extra", sorted(SP_EXTRA))
@pytest.mark.parametrize("sp_mode", ["ring", "ulysses"])
def test_lm_update_under_seq_parallel_matches_jax(flash_ring_env, tmp_path,
                                                  sp_mode, extra):
    jnet = japi.Net(dev="cpu:0-1", cfg=_cfg(extra, sp_mode, "cpu:0-1", 2))
    jnet.init_model()
    fname = str(tmp_path / "jax.model")
    jnet.save_model(fname)
    tnet = tapi.Net(dev="cpu", cfg=_cfg(extra, sp_mode, "cpu", 2))
    tnet.load_model(fname)
    jt, tt = jnet.net_, tnet.net_
    assert tt.net.seq_parallel == 2
    rs = np.random.RandomState(0)
    x = rs.randint(0, VOCAB, (BATCH, 1, 1, SEQ)).astype(np.float32)
    y = rs.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed),
                             jt._rng_counter + 1)
    (jloss, _), jgrads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jt.params, jnp.asarray(x), jnp.asarray(y), rng,
        jnp.asarray(jt.epoch_counter, jnp.int32))
    batch = DataBatch()
    batch.data, batch.label, batch.batch_size = x, y, BATCH
    tloss, tgrads = tt.loss_and_grads(batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for i, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        assert sorted(jg) == sorted(tg)
        for k in jg:
            _close(tg[k], jg[k], STEP_TOL, "gradient of layer %d %s" % (i, k))
    jnet.update(x, y)
    tnet.update(x, y)
    for i, (jp, tp) in enumerate(zip(jt.canonical_params(), tt.params)):
        for k in jp:
            np.testing.assert_allclose(
                tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                atol=1e-2 * ETA, err_msg="layer %d %s after the update"
                % (i, k))


def test_seq_parallel_key_reaches_the_layers():
    tnet = tapi.Net(dev="cpu", cfg=_cfg("mha", "ring", "cpu", 4))
    tnet.init_model()
    assert tnet.net_.seq_parallel == 4 and tnet.net_.net.seq_parallel == 4
    with pytest.raises(ValueError, match="seq_parallel must be >= 1"):
        tapi.Net(dev="cpu", cfg=_cfg("mha", "ring", "cpu", 0)).init_model()
    # the modes over ranks, the pipeline among them, are ported: one rank
    # refuses them with the JAX trainer's device-count message (where
    # seq_parallel alone stays virtual ranks)
    for key, msg in (("model_parallel", "device count 1 must be divisible"),
                     ("pipeline_parallel", "device count 1 must be "
                      "divisible by model_parallel \\* seq_parallel \\* "
                      "pipeline_parallel \\* expert_parallel = 2"),
                     ("expert_parallel", "device count 1 must be divisible")):
        with pytest.raises(ValueError, match=msg):
            tapi.Net(dev="cpu", cfg=_cfg("mha", "ring", "cpu", 1) +
                     "%s = 2\n" % key).init_model()
    # 100 positions do not split over 3 ranks, with JAX's message
    bad = tapi.Net(dev="cpu", cfg=models.transformer_lm_config(
        vocab=VOCAB, seq=100, batch_size=1, dim=DIM, nhead=NHEAD, nlayer=1,
        dev="cpu") + "seq_parallel = 3\n")
    bad.init_model()
    x = np.zeros((1, 1, 1, 100), np.float32)
    with pytest.raises(ValueError, match="seq length 100 must be divisible "
                       "by seq_parallel 3"):
        bad.predict(x)
