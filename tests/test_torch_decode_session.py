"""Continuous batching in the port (``Trainer.decode_session``, dense and
paged over ``decode_kv_pool``) on the CPU, mirroring the JAX package's
session tests (tests/test_decode.py:661-1041): a session's tokens are each
request's solo ``generate`` tokens, greedy and sampled, with staggered
admissions so that later requests join while earlier ones decode; the paged
session's tokens are the dense session's, with shared prefixes reused and
an identical twin taking the copy-on-write path; pool exhaustion defers an
admission before any device work and a retired slot's blocks come back
mid-decode; a session raises once the trainer's params change; the KV
accounts equal the tensors' bytes.

The LM is the JAX package's decode-test net trained by the JAX package on
the phase sequences (tests/test_decode.py ``_trained``), its weights
carried into the port by ``convert.params_from_jax``: its next-token
distributions are peaked, so token streams are compared exactly, as the
JAX package compares them; greedy streams also against the JAX package's
own ``generate``.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.nnet import trainer as ttrainer
from cxxnet_tpu_torch.utils.kvblocks import KVPoolExhausted

VOCAB, SEQ = 12, 24

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
VARIANTS = {
    "pos": dict(embed_extra="pos_embed = 1", attn_extra=""),
    "rope_gqa_window": dict(embed_extra="pos_embed = 0",
                            attn_extra="  rope = 1\n  nkvhead = 2\n"
                                       "  attn_window = 8\n"),
    "pos_chunked": dict(embed_extra="pos_embed = 1",
                        attn_extra="  decode_chunk = 8\n"),
}


def _conf(variant):
    return LM % dict(VARIANTS[variant], vocab=VOCAB, seq=SEQ)


@pytest.fixture(scope="module")
def lm():
    """lm(variant, steps) -> (JAX trainer, port trainer with its weights),
    made once each."""
    made = {}

    def get(variant="pos", steps=30):
        if (variant, steps) not in made:
            conf = _conf(variant)
            jtr = JTrainer()
            ttr = ttrainer.Trainer()
            for k, v in parse_config_string(conf):
                jtr.set_param(k, v)
                ttr.set_param(k, v)
            jtr.init_model()
            rs = np.random.RandomState(0)
            for _ in range(steps):
                phase = rs.randint(0, VOCAB, (8, 1))
                toks = (phase + np.arange(SEQ + 1)[None, :]) % VOCAB
                b = DataBatch()
                b.data = toks[:, :SEQ].reshape(8, 1, 1, SEQ) \
                    .astype(np.float32)
                b.label = toks[:, 1:].astype(np.float32)
                b.batch_size = 8
                jtr.update(b)
            ttr.init_model()
            ttr.params = convert.params_from_jax(
                jtr.canonical_params(), ttr.net, torch.device("cpu"))
            made[(variant, steps)] = (jtr, ttr)
        return made[(variant, steps)]
    return get


def _solo(tr, prompts, n_new, temp, top_k, seed0):
    return [list(tr.generate(np.asarray([p]), n_new, temperature=temp,
                             top_k=top_k, seed=seed0 + i)[0])
            for i, p in enumerate(prompts)]


def _drive(sess, prompts, seed0, stagger=True):
    """Schedule ``prompts`` through the session as a serving loop would:
    admit into free slots (one a step when ``stagger``, so later requests
    join mid-decode), step, retire on done."""
    got, live, nxt = {}, {}, 0
    while nxt < len(prompts) or live:
        free = sess.free_slots()
        admit_n = min(len(free), len(prompts) - nxt)
        if stagger:
            admit_n = min(admit_n, 1)
        for s in free[:admit_n]:
            i, nxt = nxt, nxt + 1
            tok, done = sess.prefill(s, prompts[i], seed0 + i)
            live[s] = (i, [tok])
            if done:
                got[i] = live.pop(s)[1]
                sess.retire(s)
        for s, tok, done in sess.step():
            live[s][1].append(tok)
            if done:
                i, toks = live.pop(s)
                got[i] = toks
                sess.retire(s)
    return [got[i] for i in range(len(prompts))]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_session_equals_solo_generate(lm, variant):
    """Session == solo, token for token, greedy and sampled (top-k), with
    staggered admissions over ragged prompts; greedy also == the JAX
    package's generate of each request."""
    jtr, tr = lm(variant)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, rs.randint(3, 9)).tolist()
               for _ in range(7)]
    n_new = 6
    for temp, top_k in ((0.0, 0), (1.0, 0), (0.8, 3)):
        solo = _solo(tr, prompts, n_new, temp, top_k, 50)
        sess = tr.decode_session(3, n_new, temperature=temp, top_k=top_k)
        got = _drive(sess, prompts, 50)
        assert got == solo, "session != solo at temp=%s top_k=%s" \
            % (temp, top_k)
        # a request joining the same session again decodes the same
        assert _drive(sess, prompts[:1], 50) == solo[:1]
        sess.close()
        if temp == 0.0:
            want = [list(np.asarray(jtr.generate(np.asarray([p]), n_new))[0])
                    for p in prompts]
            assert got == want


def test_n_new_one_finishes_at_admission(lm):
    _, tr = lm()
    sess = tr.decode_session(2, 1)
    tok, done = sess.prefill(0, [1, 2, 3], 0)
    assert done and tok == int(tr.generate(np.asarray([[1, 2, 3]]), 1)[0, 0])
    assert sess.step() == []    # a finished slot owes nothing
    sess.retire(0)
    assert sess.free_slots() == [0, 1]


@pytest.mark.parametrize("variant", ["pos", "rope_gqa_window"])
def test_paged_session_equals_dense_with_prefix_reuse(lm, variant):
    """Paged == dense == solo, token for token, greedy and sampled, over
    prompts that share full-block prefixes (prefill-once reuse: the
    suffix prefill) and an identical twin (copy on write); the pool's
    books reconcile with every block back, and the reuse happened."""
    _, tr = lm(variant)
    base = [1, 2, 3, 4]                       # one full block (bs 4)
    prompts = [base + [5, 6], base + [5, 6],  # an identical twin: CoW
               base + [7], [2, 3, 4, 5, 6, 7], base, base + [5, 6, 7, 8, 9]]
    n_new = 5
    pool = tr.decode_kv_pool(4, pool_tokens=3 * SEQ)
    for temp, top_k in ((0.0, 0), (0.8, 3)):
        dense = tr.decode_session(3, n_new, temperature=temp, top_k=top_k)
        want = _drive(dense, prompts, 50)
        dense.close()
        assert want == _solo(tr, prompts, n_new, temp, top_k, 50)
        sess = tr.decode_session(3, n_new, temperature=temp, top_k=top_k,
                                 kv_pool=pool)
        got = _drive(sess, prompts, 50)
        assert got == want, "paged != dense at temp=%s top_k=%s" \
            % (temp, top_k)
        assert pool.alloc.live_blocks == 0
        assert pool.alloc.available_blocks == pool.alloc.usable
        pool.alloc.check()
        sess.close()
    assert pool.alloc.prefix_hits > 0 and pool.alloc.cow_copies > 0
    assert pool.alloc.retained_hits > 0
    tr.release_kv_pool()


def test_paged_exhaustion_defers_and_retire_reclaims(lm):
    """Exhaustion at admission raises KVPoolExhausted before any device
    work, the session open; a retired slot's blocks return mid-decode and
    the deferred request then decodes as it does alone."""
    _, tr = lm()
    pool = tr.decode_kv_pool(4, pool_tokens=SEQ, prefix_reuse=False)
    assert pool.alloc.usable == SEQ // 4
    sess = tr.decode_session(4, 3, kv_pool=pool)
    # plen 6 + n_new 3 -> 8 rows -> 2 blocks per sequence
    for s in range(3):
        sess.prefill(s, [s + 1, s + 2, s + 3, s + 4, s + 5, s + 6], 7)
    assert pool.alloc.free_blocks == 0
    assert not pool.reservable(6, 3)
    toks_before = sess._toks.clone()
    with pytest.raises(KVPoolExhausted):
        sess.prefill(3, [9, 10, 11, 0, 1, 2], 7)
    assert not sess.closed and torch.equal(sess._toks, toks_before)
    sess.step()
    acct = sess.kv_account()
    assert acct["paged"] == 1 and acct["blocks_held"] == 6
    assert acct["kv_bytes"] == 6 * pool.block_bytes
    sess.retire(0)
    assert pool.alloc.free_blocks == 2
    first, _ = sess.prefill(3, [9, 10, 11, 0, 1, 2], 7)
    stream = [first] + [t for s, t, _ in sess.step() if s == 3] \
        + [t for s, t, _ in sess.step() if s == 3]
    want = tr.generate(np.asarray([[9, 10, 11, 0, 1, 2]]), 3, seed=7)[0]
    assert stream == list(want)
    sess.close()
    assert pool.alloc.free_blocks == pool.alloc.usable
    pool.alloc.check()
    tr.release_kv_pool()
    assert pool.closed and pool.nbytes == 0 and pool.account() is None


@pytest.mark.parametrize("change", ["reassign", "update", "set_weight"])
def test_session_raises_after_params_change(lm, change):
    """A session serves the weights it was made under: after the params
    list is reassigned (a model load), an update step or set_weight, every
    call raises and the session is closed; the pool is rebuilt."""
    jtr, _ = lm(steps=2)
    tr = ttrainer.Trainer()
    for k, v in parse_config_string(_conf("pos")):
        tr.set_param(k, v)
    tr.init_model()
    pool = tr.decode_kv_pool(4)
    sessions = [tr.decode_session(2, 3), tr.decode_session(2, 3,
                                                           kv_pool=pool)]
    for sess in sessions:
        sess.prefill(0, [1, 2, 3], 7)
    if change == "reassign":
        tr.params = list(tr.params)
    elif change == "update":
        b = DataBatch()
        b.data = np.zeros((8, 1, 1, SEQ), np.float32)
        b.label = np.zeros((8, SEQ), np.float32)
        b.batch_size = 8
        tr.update(b)
    else:
        tr.set_weight(np.asarray(tr.get_weight("head", "wmat")[0]), "head",
                      "wmat")
    for sess in sessions:
        with pytest.raises(ValueError, match="stale session"):
            sess.step()
        assert sess.closed
        with pytest.raises(ValueError, match="closed"):
            sess.prefill(1, [1, 2], 7)
        sess.retire(0)                         # never raises
    assert tr.decode_kv_pool(4) is not pool and pool.closed
    with pytest.raises(ValueError, match="another trainer or params"):
        tr.decode_session(2, 3, kv_pool=pool)


def test_kv_accounts_equal_tensor_bytes(lm):
    """Dense: kv_bytes is the slot-major caches' nbytes and the live share
    follows prefill, step and retire; paged: the pool's pool_bytes is its
    tensors' nbytes, free blocks included, and the session's kv_bytes its
    held blocks; closed sessions account 0."""
    _, tr = lm(steps=2)
    sess = tr.decode_session(2, 3)
    nbytes = sum(int(t.numel() * t.element_size())
                 for t in sess._caches.values())
    acct = sess.kv_account()
    assert nbytes > 0 and acct["kv_bytes"] == nbytes
    assert acct["bucket"] == 2 and acct["l_max"] == SEQ
    assert acct["active"] == 0 and acct["kv_live_bytes"] == 0
    sess.prefill(0, [1, 2, 3], 7)
    assert sess.kv_account()["live_tokens"] == 3
    sess.step()
    acct = sess.kv_account()
    assert acct["live_tokens"] == 4
    assert acct["kv_live_bytes"] == int(round(nbytes * 4.0
                                              / acct["alloc_tokens"]))
    sess.retire(0)
    assert sess.kv_account()["live_tokens"] == 0
    sess.close()
    assert sess.kv_account()["kv_bytes"] == 0
    pool = tr.decode_kv_pool(4, pool_tokens=2 * SEQ)
    real = sum(int(t.numel() * t.element_size())
               for t in pool.pools.values())
    nkv_dh = 4 * 4                                 # 4 kv heads x dh 4
    assert pool.nbytes == real == (2 * SEQ // 4 + 1) * pool.block_bytes
    assert pool.block_bytes == 2 * 4 * nkv_dh * 4  # k and v, bs 4, f32
    psess = tr.decode_session(2, 3, kv_pool=pool)
    psess.prefill(1, [1, 2, 3, 4, 5], 0)
    a = pool.account()
    assert a["pool_bytes"] == real and a["blocks_live"] == 2
    assert a["live_tokens"] == 5
    assert psess.kv_account()["kv_bytes"] == 2 * pool.block_bytes
    psess.close()
    assert psess.kv_account()["kv_bytes"] == 0
    tr.release_kv_pool()


def test_session_checks(lm):
    _, tr = lm(steps=2)
    with pytest.raises(ValueError, match="nslots"):
        tr.decode_session(0, 3)
    with pytest.raises(ValueError, match="n_new"):
        tr.decode_session(2, 0)
    sess = tr.decode_session(2, 3)
    with pytest.raises(ValueError, match="exceeds"):
        sess.prefill(0, list(range(SEQ - 2)), 0)
    with pytest.raises(ValueError, match="empty prompt"):
        sess.prefill(0, [], 0)
    sess.prefill(0, [1], 0)
    with pytest.raises(ValueError, match="not free"):
        sess.prefill(0, [1], 0)
    with pytest.raises(ValueError, match="must divide"):
        tr.decode_kv_pool(5)
