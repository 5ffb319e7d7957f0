"""The port's exported serving programs (``Trainer.export_forward`` /
``export_decode``, ``api.Net.export``, ``save_decode``, ``load_decode``,
``load_exported``, ``task = export``, utils/artifact.py and the
``cxxnet::`` kernel ops of ops/library.py) on the CPU, against the JAX
package's: the cases of tests/test_export.py, tests/test_artifact.py and
the three export cases of tests/test_decode.py on the port; the port's
artifact against the JAX package's artifact on the same weights
(``convert.params_from_jax``) and inputs from a numpy seed, at a fixed and a
symbolic batch; ``load_decode``'s greedy tokens against the JAX
``load_decode``'s on one JAX-trained LM; a program without kernels run in a
fresh interpreter that has loaded nothing named ``cxxnet``; and each
``cxxnet::`` op's CPU implementation against its plain version, its fake
against its shapes and dtypes.

The JAX cases of tests/test_artifact.py run against the port by swapping
the test module's ``artifact`` for the port's (and ``cxxnet_tpu.api`` for
the port's api, which its last case imports); the cases of
tests/test_export.py are restated here on the port's trainer, whose
``extract_feature`` takes the batch's data where the JAX one takes the
batch. Tolerances: the JAX cases' own (1e-6 relative, 1e-7 absolute,
against the same package's forward; 1e-5 / 1e-6 at a symbolic batch);
the port against JAX 1e-5 relative in f32; tokens exactly.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cxxnet_tpu
from cxxnet_tpu import api as japi
from cxxnet_tpu.io.data import DataBatch as JDataBatch
from cxxnet_tpu.nnet.trainer import Trainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch import api, convert, learn_task
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.ops import flash_attn, lrn
from cxxnet_tpu_torch.utils import artifact, serializer
from cxxnet_tpu_torch.utils.config import parse_config_string

from . import test_artifact as jartifact_tests
from . import test_decode as jdecode_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_export.py's net, and the same net with an LRN layer (the
# forward kernel of row 1 as a cxxnet:: op in the exported program)
CONV_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 6
  random_type = xavier
layer[1->2] = relu
layer[2->feat] = max_pooling
  kernel_size = 2
  stride = 2
layer[feat->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 4
  init_sigma = 0.1
layer[5->5] = softmax
netconfig = end
input_shape = 1,10,10
batch_size = 8
eta = 0.1
dev = cpu
"""
LRN_NET = CONV_NET.replace("""layer[1->2] = relu
""", """layer[1->r] = relu
layer[r->2] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
""")


def _batch(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 1, 10, 10).astype(np.float32),
            rs.randint(0, 4, (n, 1)).astype(np.float32))


def _trained(net=CONV_NET, extra=""):
    """tests/test_export.py's ``_trained`` on the port: 3 updates."""
    tr = Trainer()
    for k, v in parse_config_string(net + extra):
        tr.set_param(k, v)
    tr.init_model()
    data, label = _batch()
    b = api._as_batch(data, label)
    for _ in range(3):
        tr.update(b)
    return tr, data


def _write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


# ----------------------------------------------------------------------
# tests/test_export.py on the port
def test_export_matches_forward(tmp_path):
    tr, x = _trained()
    fn = api.load_exported(_write(tmp_path / "m.pt2", tr.export_forward()))
    got = fn(x).reshape(8, -1)
    want = tr.extract_feature(x, "top[-1]").reshape(8, -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_export_named_node_and_batch_override(tmp_path):
    tr, x = _trained()
    fn = api.load_exported(_write(
        tmp_path / "feat.pt2",
        tr.export_forward(node_name="feat", batch_size=4)))
    got = fn(x[:4])
    want = tr.extract_feature(x[:4], "feat")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(Exception):
        fn(x)                    # a fixed batch of 4 takes no batch of 8


def test_export_symbolic_batch_serves_any_n(tmp_path):
    """batch_size=-1 exports ONE artifact with a symbolic batch dim: it
    serves batch 1, 3, and 8 and matches the forward."""
    tr, x = _trained()
    blob = tr.export_forward(batch_size=-1)
    meta, _ = artifact.unframe(blob, "forward")
    assert meta["batch"] == -1 and meta["input_shape"] == [1, 10, 10]
    fn = api.load_exported(_write(tmp_path / "sym.pt2", blob))
    want = tr.extract_feature(x, "top[-1]").reshape(8, -1)
    for n in (1, 3, 8):
        got = fn(x[:n]).reshape(n, -1)
        np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-6)


def test_export_channels_last_artifact_is_nchw(tmp_path):
    """The artifact's contract is reference-NCHW whatever layout key the
    model was exported under (the port accepts and ignores
    channels_last)."""
    tr, x = _trained(extra="channels_last = 1\n")
    ref, _ = _trained(extra="channels_last = 0\n")
    fn = api.load_exported(_write(tmp_path / "cl.pt2", tr.export_forward()))
    got = fn(x).reshape(8, -1)
    want = ref.extract_feature(x, "top[-1]").reshape(8, -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_export_runs_without_framework(tmp_path):
    """A program without kernels needs torch only: a fresh interpreter
    that never imports anything named cxxnet runs the artifact, the
    12-byte-header CXTF frame unwrapped with two struct reads."""
    tr, x = _trained()
    path = _write(tmp_path / "standalone.pt2", tr.export_forward())
    np.save(str(tmp_path / "x.npy"), x)
    code = (
        "import io, struct, sys\n"
        "import numpy as np, torch\n"
        "data = open(%r, 'rb').read()\n"
        "assert data[:4] == b'CXTF', 'versioned artifact frame'\n"
        "ver, hlen = struct.unpack('<II', data[4:12])\n"
        "assert ver == 1\n"
        "prog = torch.export.load(io.BytesIO(data[12 + hlen:]))\n"
        "out = prog.module()(torch.from_numpy(np.load(%r)))\n"
        "assert not any(m.startswith('cxxnet') for m in sys.modules)\n"
        "np.save(%r, out.numpy())\n"
        % (path, str(tmp_path / "x.npy"), str(tmp_path / "y.npy")))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=str(tmp_path))
    got = np.load(str(tmp_path / "y.npy")).reshape(8, -1)
    want = tr.extract_feature(x, "top[-1]").reshape(8, -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_export_cli_task(tmp_path):
    """task = export through the CLI: train -> save -> export -> load."""
    tr, x = _trained()
    model_path = str(tmp_path / "m.model")
    w = serializer.Writer()
    w.write_int32(0)   # leading net_type int (learn_task._save_model)
    tr.save_model(w)
    _write(model_path, w.getvalue())
    conf_path = str(tmp_path / "export.conf")
    out_path = str(tmp_path / "cli.pt2")
    with open(conf_path, "w") as f:
        f.write(CONV_NET + "task = export\nmodel_in = %s\n"
                "export_out = %s\n" % (model_path, out_path))
    assert learn_task.main([conf_path]) == 0
    fn = api.load_exported(out_path)
    got = fn(x).reshape(8, -1)
    want = tr.extract_feature(x, "top[-1]").reshape(8, -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_export_cli_task_symbolic_batch_and_node(tmp_path):
    """export_batch = -1 and extract_node_name through the CLI."""
    tr, x = _trained(LRN_NET)
    model_path = str(tmp_path / "m.model")
    w = serializer.Writer()
    w.write_int32(0)
    tr.save_model(w)
    _write(model_path, w.getvalue())
    out_path = str(tmp_path / "feat.pt2")
    conf_path = str(tmp_path / "export.conf")
    with open(conf_path, "w") as f:
        f.write(LRN_NET + "task = export\nmodel_in = %s\nexport_out = %s\n"
                "export_batch = -1\nextract_node_name = feat\n"
                % (model_path, out_path))
    assert learn_task.main([conf_path]) == 0
    fn = api.load_exported(out_path)
    assert fn.meta["batch"] == -1
    for n in (1, 5):
        np.testing.assert_allclose(fn(x[:n]), tr.extract_feature(x[:n],
                                                                  "feat"),
                                   rtol=1e-5, atol=1e-6)


def test_net_export_writes_a_loadable_artifact(tmp_path):
    net = api.Net(dev="cpu", cfg=LRN_NET)
    net.init_model()
    x, _ = _batch(8, seed=3)
    path = str(tmp_path / "net.pt2")
    net.export(path, batch_size=-1)
    fn = api.load_exported(path)
    np.testing.assert_allclose(fn(x[:3]).reshape(3, -1),
                               net.extract(x[:3], "top[-1]").reshape(3, -1),
                               rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# the port's artifact against the JAX package's on the same weights
def _jax_and_port(net_text, seed=0):
    jtr = JTrainer()
    for k, v in jparse(net_text):
        jtr.set_param(k, v)
    jtr.init_model()
    rs = np.random.RandomState(seed)
    b = JDataBatch()
    b.data = rs.rand(8, 1, 10, 10).astype(np.float32)
    b.label = rs.randint(0, 4, (8, 1)).astype(np.float32)
    b.batch_size = 8
    for _ in range(3):
        jtr.update(b)
    tr = Trainer()
    for k, v in parse_config_string(net_text):
        tr.set_param(k, v)
    tr.init_model()
    tr.params = convert.params_from_jax(jtr.canonical_params(), tr.net,
                                        torch.device("cpu"))
    return jtr, tr


@pytest.mark.parametrize("batch", [0, -1], ids=["fixed", "symbolic"])
def test_port_artifact_matches_the_jax_artifact(tmp_path, batch):
    """A conv + LRN net: the JAX package's StableHLO artifact and the
    port's torch.export program, each from the same weights, agree within
    1e-5 relative in f32 on inputs from a numpy seed (a fixed batch of 8;
    a symbolic batch at n = 1, 3 and 8). The port's program holds the LRN
    forward as a cxxnet::lrn_fwd node."""
    jtr, tr = _jax_and_port(LRN_NET)
    jpath = _write(tmp_path / "jax.stablehlo",
                   jtr.export_forward(batch_size=batch))
    ppath = _write(tmp_path / "port.pt2", tr.export_forward(batch_size=batch))
    jfn, pfn = japi.load_exported(jpath), api.load_exported(ppath)
    targets = [str(n.target) for n in pfn.module.graph.nodes]
    assert targets.count("cxxnet.lrn_fwd.default") == 1, targets
    x = np.random.RandomState(11).rand(8, 1, 10, 10).astype(np.float32)
    for n in ((1, 3, 8) if batch < 0 else (8,)):
        want = np.asarray(jfn(x[:n])).reshape(n, -1)
        got = pfn(x[:n]).reshape(n, -1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ----------------------------------------------------------------------
# tests/test_artifact.py on the port's artifact module
ARTIFACT_CASES = sorted(n for n, f in vars(jartifact_tests).items()
                        if n.startswith("test_") and callable(f))


def test_every_artifact_case_is_run():
    assert len(ARTIFACT_CASES) == 7


@pytest.mark.parametrize("name", ARTIFACT_CASES)
def test_jax_artifact_case_on_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jartifact_tests, "artifact", artifact)
    # the last case imports ``from cxxnet_tpu import api``
    monkeypatch.setattr(cxxnet_tpu, "api", api)
    fn = getattr(jartifact_tests, name)
    given = {"tmp_path": tmp_path}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_artifact_frames_equal_the_jax_frames():
    """One frame layout: the same kind, meta and payload give the same
    bytes in both packages, and each package unframes the other's."""
    from cxxnet_tpu.utils import artifact as jartifact
    meta = {"cache_fingerprint": "f", "batch": 2, "prompt_len": 3,
            "l_max": 16}
    assert artifact.frame("decode_step", meta, b"P") == \
        jartifact.frame("decode_step", meta, b"P")
    assert jartifact.unframe(artifact.frame("forward", meta, b"Q"),
                             "forward")[1] == b"Q"
    # the dtype's spelling is one whatever names it
    assert artifact.cache_fingerprint([(1, "k")], [(2, 3)],
                                      torch.bfloat16) == \
        artifact.cache_fingerprint([(1, "k")], [(2, 3)], "bfloat16")
    with pytest.raises(ValueError, match="cxxnet_tpu_torch"):
        artifact.unframe(b"junk" * 4, "forward")


# ----------------------------------------------------------------------
# the three export cases of tests/test_decode.py on the port, from the
# JAX-trained LM of that file
@pytest.fixture(scope="module")
def decode_lms():
    made = {}

    def get(attn_extra=""):
        if attn_extra not in made:
            jtr = jdecode_tests._trained(attn_extra=attn_extra)
            conf = jdecode_tests.LM % {
                "vocab": jdecode_tests.VOCAB, "seq": jdecode_tests.SEQ,
                "embed_extra": "pos_embed = 1", "attn_extra": attn_extra}
            tr = Trainer()
            for k, v in parse_config_string(conf):
                tr.set_param(k, v)
            tr.init_model()
            tr.params = convert.params_from_jax(
                jtr.canonical_params(), tr.net, torch.device("cpu"))
            made[attn_extra] = (jtr, tr)
        return made[attn_extra]
    return get


def _pair(tmp_path, tr, b, plen, tag=""):
    pre_b, step_b = tr.export_decode(batch_size=b, prompt_len=plen)
    return (_write(tmp_path / ("pre%s.pt2" % tag), pre_b),
            _write(tmp_path / ("step%s.pt2" % tag), step_b))


@pytest.mark.parametrize("attn_extra", ["", "  decode_chunk = 8\n"],
                         ids=["dense", "chunked"])
def test_export_decode_artifacts_match(tmp_path, decode_lms, attn_extra):
    """tests/test_decode.py's test_export_decode_artifacts_match and
    test_decode_chunked_export_artifacts_match on the port: the exported
    prefill/step pair, driven by load_decode's greedy loop, reproduces
    Trainer.generate token for token; and its tokens equal the JAX
    artifact pair's through the JAX load_decode."""
    jtr, tr = decode_lms(attn_extra)
    prompts = np.random.RandomState(9).randint(0, jdecode_tests.VOCAB,
                                               (4, 6))
    gen = api.load_decode(*_pair(tmp_path, tr, 4, 6))
    got = gen(prompts, 8)
    np.testing.assert_array_equal(got, tr.generate(prompts, 8))
    jpre, jstep = jtr.export_decode(batch_size=4, prompt_len=6)
    jgen = japi.load_decode(_write(tmp_path / "jpre.hlo", jpre),
                            _write(tmp_path / "jstep.hlo", jstep))
    np.testing.assert_array_equal(got, jgen(prompts, 8))


def test_export_decode_artifact_bounds(tmp_path, decode_lms):
    jtr, tr = decode_lms()
    gen = api.load_decode(*_pair(tmp_path, tr, 2, 4))
    with pytest.raises(ValueError, match="exceeds"):
        gen(np.zeros((2, 4), np.int64), jdecode_tests.SEQ)
    assert gen(np.zeros((2, 4), np.int64), 0).shape == (2, 0)


def test_export_decode_refuses_a_non_causal_net_and_a_long_prompt():
    conf = (jdecode_tests.LM % {
        "vocab": jdecode_tests.VOCAB, "seq": jdecode_tests.SEQ,
        "embed_extra": "pos_embed = 1", "attn_extra": ""}
    ).replace("causal = 1", "causal = 0")
    tr = Trainer()
    for k, v in parse_config_string(conf):
        tr.set_param(k, v)
    tr.init_model()
    with pytest.raises(Exception, match="not causal"):
        tr.export_decode(batch_size=2, prompt_len=4)
    conf = conf.replace("causal = 0", "causal = 1")
    tr = Trainer()
    for k, v in parse_config_string(conf):
        tr.set_param(k, v)
    tr.init_model()
    with pytest.raises(Exception, match="prompt_len"):
        tr.export_decode(batch_size=2, prompt_len=jdecode_tests.SEQ + 1)


def test_export_decode_step_returns_new_caches(tmp_path, decode_lms):
    """The step's contract is the JAX one: the caches it was given stay
    as they were, and the updated ones come back; prefill and step carry
    one cache fingerprint in their frames."""
    _, tr = decode_lms()
    pre_p, step_p = _pair(tmp_path, tr, 2, 4)
    gen = api.load_decode(pre_p, step_p)
    probs, caches = gen.prefill(torch.zeros((2, 4), dtype=torch.int32))
    before = [c.clone() for c in caches]
    probs2, caches2 = gen.step(torch.ones(2, dtype=torch.int32),
                               torch.tensor(4, dtype=torch.int32), caches)
    assert probs.shape == probs2.shape == (2, jdecode_tests.VOCAB)
    for c, b, c2 in zip(caches, before, caches2):
        assert torch.equal(c, b)
        assert not torch.equal(c2[:, :, 4], b[:, :, 4])
        assert torch.equal(c2[:, :, :4], b[:, :, :4])
    metas = [artifact.unframe(open(p, "rb").read(), k)[0]
             for p, k in ((pre_p, "decode_prefill"),
                          (step_p, "decode_step"))]
    assert metas[0]["cache_fingerprint"] == metas[1]["cache_fingerprint"]
    assert (metas[0]["batch"], metas[0]["prompt_len"],
            metas[0]["l_max"]) == (2, 4, jdecode_tests.SEQ)


def test_export_decode_bf16_caches_and_flash_prefill(tmp_path):
    """Under compute_dtype = bfloat16 the caches are bf16 and the
    fingerprint names the dtype as ``bfloat16``; a prefill of 128 or more
    tokens holds the flash forward as cxxnet::flash_fwd nodes (one an
    attention layer) and the pair reproduces generate."""
    from cxxnet_tpu_torch import models
    conf = models.transformer_lm_config(
        vocab=40, seq=160, batch_size=2, dim=32, nhead=2, nlayer=2,
        dev="cpu", extra_cfg="compute_dtype = bfloat16\n")
    tr = Trainer()
    for k, v in parse_config_string(conf):
        tr.set_param(k, v)
    tr.init_model()
    pre_p, step_p = _pair(tmp_path, tr, 2, 130)
    gen = api.load_decode(pre_p, step_p)
    targets = [str(n.target) for n in gen.prefill.graph.nodes]
    assert targets.count("cxxnet.flash_fwd.default") == 2, targets
    net2 = tr._seq_net(2, 1)
    _, keys, shapes = tr._decode_cache_specs(net2, 2, 160)
    meta = artifact.unframe(open(pre_p, "rb").read(), "decode_prefill")[0]
    assert meta["cache_fingerprint"] == artifact.cache_fingerprint(
        keys, shapes, "bfloat16")
    _, caches = gen.prefill(torch.zeros((2, 130), dtype=torch.int32))
    assert all(c.dtype == torch.bfloat16 for c in caches)
    prompts = np.random.RandomState(4).randint(0, 40, (2, 130))
    np.testing.assert_array_equal(gen(prompts, 6), tr.generate(prompts, 6))


def test_load_decode_refuses_a_swapped_pair(tmp_path, decode_lms):
    _, tr = decode_lms()
    pre_p, step_p = _pair(tmp_path, tr, 2, 4)
    with pytest.raises(ValueError, match="kind mismatch"):
        api.load_decode(step_p, pre_p)
    with pytest.raises(ValueError, match="kind mismatch"):
        api.load_exported(pre_p)


# ----------------------------------------------------------------------
# the cxxnet:: ops
LRN_ARGS = (5, 0.001, 0.75, 1.0)


def _lrn_input(dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(2).randn(
        2, 7, 5, 3).astype(np.float32)).to(dtype)


def _qkv(dtype=torch.float32, h=4, nkv=2, L=130, d=16):
    rs = np.random.RandomState(3)
    return tuple(torch.from_numpy(rs.randn(2, n, L, d).astype(np.float32))
                 .to(dtype) for n in (h, nkv, nkv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_ops_equal_the_plain_versions(dtype):
    x = _lrn_input(dtype)
    assert torch.equal(torch.ops.cxxnet.lrn_fwd(x, *LRN_ARGS),
                       lrn.lrn_ref(x, *LRN_ARGS))
    out, norm = torch.ops.cxxnet.lrn_fwd_norm(x, *LRN_ARGS)
    ref_out, ref_norm = lrn.lrn_ref_with_norm(x, *LRN_ARGS)
    assert torch.equal(out, ref_out) and torch.equal(norm, ref_norm)
    q, k, v = _qkv(dtype)
    out, lse = torch.ops.cxxnet.flash_fwd(q, k, v, True, 0.25, 8)
    ref_out, ref_lse = flash_attn.flash_fwd_ref(q, k, v, True, 0.25, 8)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_op_fakes_give_the_shapes_and_dtypes(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = _lrn_input(dtype)
    q, k, v = _qkv(dtype)
    real = (torch.ops.cxxnet.lrn_fwd(x, *LRN_ARGS),
            *torch.ops.cxxnet.lrn_fwd_norm(x, *LRN_ARGS),
            *torch.ops.cxxnet.flash_fwd(q, k, v, True, 0.25, 0))
    with FakeTensorMode() as mode:
        fx, fq, fk, fv = (mode.from_tensor(t) for t in (x, q, k, v))
        fake = (torch.ops.cxxnet.lrn_fwd(fx, *LRN_ARGS),
                *torch.ops.cxxnet.lrn_fwd_norm(fx, *LRN_ARGS),
                *torch.ops.cxxnet.flash_fwd(fq, fk, fv, True, 0.25, 0))
    for f, r in zip(fake, real):
        assert (tuple(f.shape), f.dtype, f.stride()) == \
            (tuple(r.shape), r.dtype, r.stride())
    assert [r.dtype for r in real] == [dtype, dtype, torch.float32,
                                       dtype, torch.float32]


@pytest.mark.parametrize("op,args", [
    ("lrn_fwd", lambda: (_lrn_input(),) + LRN_ARGS),
    ("lrn_fwd_norm", lambda: (_lrn_input(),) + LRN_ARGS),
    ("flash_fwd", lambda: _qkv() + (True, 0.25, 0)),
])
def test_opcheck(op, args):
    torch.library.opcheck(getattr(torch.ops.cxxnet, op).default, args(),
                          test_utils=("test_schema", "test_faketensor"))


def test_autograd_paths_go_through_the_ops(monkeypatch):
    """lrn.forward with a gradient, LRNFunction and FlashAttention reach
    the kernels through the cxxnet:: ops: a counting stand-in for each
    op's CPU implementation sees every forward."""
    seen = []
    real_norm, real_flash = lrn.lrn_ref_with_norm, flash_attn.flash_fwd_ref

    def norm(*a):
        seen.append("lrn_fwd_norm")
        return real_norm(*a)

    def flash(*a):
        seen.append("flash_fwd")
        return real_flash(*a)
    monkeypatch.setattr(lrn, "lrn_ref_with_norm", norm)
    monkeypatch.setattr(flash_attn, "flash_fwd_ref", flash)
    x = _lrn_input().requires_grad_()
    lrn.forward(x, *LRN_ARGS).sum().backward()
    q, k, v = (t.requires_grad_() for t in _qkv())
    flash_attn.flash_attention(q, k, v, causal=True).sum().backward()
    assert seen == ["lrn_fwd_norm", "flash_fwd"]
    assert x.grad is not None and q.grad is not None
