"""The port's compile flight recorder and warm-grid readiness on the CPU,
against the JAX package's: ``Trainer.expected_decode_grid`` equal to the
JAX trainer's for dense and paged grids over several buckets, prompt
lengths and sampling settings; a real session warm-up over the enumerated
grid taking ``ready_pct`` from 0 to 100 (dense and paged), its programs
carded; the scenarios of tests/test_compile_obs.py that need no router run
against the port's ``perf``, ``servd``, ``statusd`` and ``telemetry`` (the
readiness math, compile-stall attribution, the ``/compilez`` page and its
schema, the 404 naming the wiring, the ``warming`` health gate);
``rebuild_after_clear`` after a model reload; ``task = serve`` with
``status_port``, ``serve_plen_buckets`` and ``serve_warm_ready_pct = 100``
(503 ``warming`` before the first request, 200 and 100% after, every
expected key compiled once, ready cards, every flight record carrying the
ledger's decode bound); and ``serve_kv_pool_frac`` capping the paged pool.

A JAX scenario runs against the port by swapping the globals of the JAX
test module that name those modules, and its fault injector, for the
port's, for the length of the case; the router scenarios
(``test_fleet_federates_warm_fraction``,
``test_router_marks_warming_replica_and_keeps_refreshing``) run on the
port's fleet router. Left out: ``test_bench_compare_cold_start_directions``
(a tool that reads the JAX package).
"""

import inspect
import json
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest

from cxxnet_tpu import models as jmodels
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch import models
from cxxnet_tpu_torch.nnet.trainer import Trainer
from cxxnet_tpu_torch.utils import perf, routerd, servd, serializer, statusd
from cxxnet_tpu_torch.utils import telemetry
from cxxnet_tpu_torch.utils.config import parse_config_string

from . import test_compile_obs as jtests
from .test_perf import TINY_CONF
from .test_torch_serve import GEN_NEW, _serve, model  # noqa: F401
from .test_torch_decode import VOCAB
from .test_torch_decode import _conf as _lm_conf
from .test_torch_servd import faultinject as port_faultinject

TINY_LM = dict(vocab=64, seq=16, batch_size=2, dim=16, nhead=2, nlayer=1)


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


@pytest.fixture(autouse=True)
def _telemetry():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


@pytest.fixture()
def ledger():
    lg = perf.Ledger().enable()
    yield lg
    lg.disable()


def _port_lm(**extra):
    tr = Trainer()
    for k, v in parse_config_string(models.transformer_lm_config(
            dev="cpu", **dict(TINY_LM, **extra))):
        tr.set_param(k, v)
    tr.init_model()
    return tr


# ----------------------------------------------------------------------
# the expected grid against the JAX trainer's
GRIDS = [((1,), (4,), 0.0, 0, 0), ((1, 2, 4, 8), (8, 4, 12), 0.0, 0, 0),
         ((3, 3, 0), (1, 15), 0.7, 5, 0), ((1, 2), (4, 6), 0.0, 0, 4),
         ((8, 2), (8, 4, 12), 1.0, 3, 8), ((4,), (2,), 0.5, 0, 16)]


@pytest.fixture(scope="module")
def lm_pair():
    jtr = jmodels.transformer_lm_trainer(dev="cpu", **TINY_LM)
    return jtr, _port_lm()


@pytest.mark.parametrize("buckets,plens,temp,top_k,kv_block", GRIDS,
                         ids=str)
def test_expected_grid_equals_jax(lm_pair, buckets, plens, temp, top_k,
                                  kv_block):
    jtr, tr = lm_pair
    kw = dict(temperature=temp, top_k=top_k, kv_block=kv_block)
    got = tr.expected_decode_grid(buckets, plens, **kw)
    assert got == jtr.expected_decode_grid(buckets, plens, **kw)
    assert [str(k) for k, _ in got] == \
        [str(k) for k, _ in jtr.expected_decode_grid(buckets, plens, **kw)]


def test_expected_grid_refuses_like_jax(lm_pair):
    jtr, tr = lm_pair
    for t in (jtr, tr):
        with pytest.raises(Exception, match="must divide"):
            t.expected_decode_grid([1], [4], kv_block=5)
        with pytest.raises(Exception, match="plen must be >= 1"):
            t.expected_decode_grid([1], [0])


# ----------------------------------------------------------------------
# a real session warm-up, 0 -> 100
@pytest.mark.parametrize("kv_block", (0, 4))
def test_ready_programs_pct_real_session_warmup(ledger, kv_block):
    tr = _port_lm()
    plen, bucket, n_new = 4, 1, 3
    ledger.set_expected_grid(tr.expected_decode_grid(
        [bucket], [plen], kv_block=kv_block))
    rd = ledger.readiness()
    assert rd["expected"] == 3 and rd["ready_pct"] == 0.0
    pool = tr.decode_kv_pool(kv_block) if kv_block else None
    sess = tr.decode_session(bucket, n_new, kv_pool=pool)
    try:
        sess.prefill(0, [1, 2, 3, 4], 7)
        while not all(done for _, _, done in sess.step()):
            pass
        sess.retire(0)
        # a second request compiles nothing more
        n = len(ledger.recent_compiles())
        sess.prefill(0, [5, 6, 7, 8], 8)
        while not all(done for _, _, done in sess.step()):
            pass
        assert len(ledger.recent_compiles()) == n
    finally:
        sess.close()
    rd = ledger.readiness()
    assert rd["ready_pct"] == 100.0, rd
    assert rd["cold_keys"] == []
    recs = ledger.recent_compiles(10)
    assert {r["name"] for r in recs} == {
        "jit.decode_prefill", "jit.decode_admit", "jit.decode_step"}
    assert all(r["cause"] == "new_signature" for r in recs)
    cards = {c["name"]: c for c in ledger.cards()}
    for name in ("jit.decode_prefill", "jit.decode_step"):
        c = cards[name]
        assert c["status"] == "ready" and c["flops"] > 0, c
        assert c["predicted_s"] > 0 and c["arg_bytes"] > 0
    assert cards["jit.decode_admit"]["flops"] == 0
    snap = ledger.snapshot()
    step = [c for c in snap["cards"] if c["name"] == "jit.decode_step"][0]
    assert step["measured_series"] == "decode.step"
    assert step["measured_n"] >= 2 and step["roofline_eff_pct"] is not None


def test_solo_generate_cards_its_loop(ledger):
    """generate's programs under the JAX key: the prefill, and the whole
    loop of n_new - 1 steps on one card whose count is the loop's."""
    from cxxnet_tpu_torch.nnet import cost
    tr = _port_lm()
    prompts = np.array([[1, 2, 3, 4], [4, 3, 2, 1]])
    tr.generate(prompts, 5)
    key = str(("decode", 2, 4, 9, 0.0, 0))
    cards = {c["name"]: c for c in ledger.cards()}
    assert cards["jit.decode_prefill"]["key"] == key
    assert cards["jit.decode_step"]["key"] == key
    params = tr._decode_params_current()
    want = cost.decode_loop_cost(tr._net_for(2, 1), params, 2, range(4, 8))
    assert cards["jit.decode_step"]["flops"] == want["flops"]
    one = cost.forward_cost(tr._net_for(2, 1), params, 2, q_offs=[4, 4])
    assert want["flops"] > 3 * one["flops"]
    # the decode bound follows the loop's card: (ntok - 1) / predicted
    lg = perf.ledger()
    old = (lg._cards, lg._order, lg.enabled)
    lg._cards, lg._order, lg.enabled = ledger._cards, ledger._order, True
    try:
        assert perf.decode_bound_tokens_per_s(5) == round(
            4 / cards["jit.decode_step"]["predicted_s"], 3)
    finally:
        lg._cards, lg._order, lg.enabled = old
    # another batch drops the programs: decode_cache_drop
    tr.generate(prompts[:1], 5)
    causes = [r["cause"] for r in ledger.recent_compiles(2)]
    assert causes == ["decode_cache_drop", "decode_cache_drop"]


def test_rebuild_after_clear_after_a_reload(ledger):
    """A model load clears the trainer's programs: the next predict
    recompiles as rebuild_after_clear, under the same key."""
    tr = Trainer()
    for k, v in parse_config_string(TINY_CONF):
        tr.set_param(k, v)
    tr.init_model()
    x = np.random.RandomState(0).rand(8, 1, 1, 16).astype(np.float32)
    tr.predict(x)
    tr.predict(x)
    w = serializer.Writer()
    tr.save_model(w)
    tr.load_model(serializer.Reader(w.getvalue()))
    tr.predict(x)
    recs = [r for r in ledger.recent_compiles()
            if r["name"] == "jit.predict"]
    assert [r["cause"] for r in recs] == ["rebuild_after_clear",
                                          "new_signature"]
    assert recs[0]["key"] == recs[1]["key"] == str(("pred", 3))
    card = ledger.card("jit.predict")
    assert card["compiles"] == 2 and card["status"] == "ready"
    assert telemetry.summary()["counters"]["jit.cache_clear"] >= 1


# ----------------------------------------------------------------------
# the JAX scenarios against the port
SCENARIOS = (
    "test_warm_grid_readiness_math",
    "test_compile_stall_attribution_cold_vs_warm",
    "test_step_cliff_fans_out_to_every_slot_aboard",
    "test_compilez_endpoint_and_ring_schema",
    "test_compilez_404_names_the_wiring",
    "test_warming_health_state_gates_until_ready",
    "test_fleet_federates_warm_fraction",
    "test_router_marks_warming_replica_and_keeps_refreshing",
)


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_compile_obs_scenario_on_the_port(name, ledger, monkeypatch):
    for attr, mod in (("perf", perf), ("routerd", routerd),
                      ("servd", servd), ("statusd", statusd),
                      ("telemetry", telemetry),
                      ("faultinject", port_faultinject)):
        monkeypatch.setattr(jtests, attr, mod)
    fn = getattr(jtests, name)
    given = {"ledger": ledger}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# ----------------------------------------------------------------------
# task = serve: the warm grid end to end
def _get(port, path):
    try:
        r = urlopen("http://127.0.0.1:%d%s" % (port, path), timeout=10)
        return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def test_cli_serve_warms_its_grid_and_cards_its_programs(
        model, tmp_path, capsys, monkeypatch):  # noqa: F811
    _, path = model
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (4, 6, 4)]
    lines = [" ".join(map(str, p)) for p in prompts] + ["ADMIN stats"]
    seen = {}

    def cold():
        port = statusd.active().port
        seen["health0"] = _get(port, "/healthz")
        seen["metrics0"] = _get(port, "/metrics")[1]

    def warm():
        port = statusd.active().port
        seen["health1"] = _get(port, "/healthz")
        seen["metrics1"] = _get(port, "/metrics")[1]
        seen["compilez"] = json.loads(_get(port, "/compilez?json=1")[1])
        seen["programz"] = json.loads(_get(port, "/programz?json=1")[1])
        seen["requestz"] = json.loads(_get(port, "/requestz?json=1")[1])
    cf = tmp_path / "serve.conf"
    cf.write_text(_lm_conf() + "task = serve\nmodel_in = %s\n"
                  "model_dir = %s\ngen_new = %d\nsilent = 1\n"
                  "serve_buckets = 1\nserve_plen_buckets = 4,6\n"
                  "serve_warm_ready_pct = 100\nstatus_port = 0\n"
                  % (path, tmp_path / "models", GEN_NEW))
    got = _serve(tlt.main, str(cf), lines, capsys, monkeypatch,
                 hooks={0: cold, 3: warm})
    assert len(got) == 4 and got[-1].startswith("OK ")
    assert not any(ln.startswith("ERR") for ln in got), got
    code, body = seen["health0"]
    assert code == 503 and "warming: 0/4" in body, body
    assert "cxxnet_ready_programs_pct{process=\"0\"} 0.0" in \
        seen["metrics0"]
    code, body = seen["health1"]
    assert code == 200, (body, seen["compilez"])
    assert "cxxnet_ready_programs_pct{process=\"0\"} 100.0" in \
        seen["metrics1"]
    cz = seen["compilez"]
    assert cz["readiness"]["ready_pct"] == 100.0
    keys = [r["key"] for r in cz["compiles"]]
    want = {"('sess_prefill', 4, 0.0, 0)", "('sess_prefill', 6, 0.0, 0)",
            "('sess_admit', 1)", "('sess_step', 1, 0.0, 0)"}
    assert want <= set(keys)
    assert all(keys.count(k) == 1 for k in want)
    assert all(r["cause"] == "new_signature" for r in cz["compiles"]
               if r["key"] in want)
    cards = {c["name"]: c for c in seen["programz"]["cards"]}
    for name in ("jit.decode_prefill", "jit.decode_step"):
        c = cards[name]
        assert c["status"] == "ready" and c["flops"] > 0, c
        assert c["predicted_s"] > 0 and c["measured_p50_ms"] is not None
    served = [r for r in seen["requestz"]["requests"]
              if r.get("outcome") == "served"]
    assert len(served) == 3
    for r in served:
        assert r["roofline_bound_tokens_per_s"] is not None, r
    assert not perf.enabled()          # the run's end unhooks the ledger


def test_serve_kv_pool_frac_caps_the_pool(monkeypatch):
    """With the ledger on, the adapter's pool is capped at
    ``serve_kv_pool_frac`` of the headroom (floored at one sequence);
    with it off, the pool holds the largest bucket's dense-equivalent
    rows."""
    tr = _port_lm()
    l_max, bs = TINY_LM["seq"], 4
    adapter = tlt._SlotBackendAdapter(lambda: tr, [1, 4], 2, kv_block=bs,
                                      kv_pool_frac=0.5)
    assert not perf.enabled()
    assert adapter._pool().alloc.usable == 4 * l_max // bs
    tr.release_kv_pool()
    # a capacity that leaves room for about two sequences' blocks at 0.5
    block_bytes = adapter._pool().block_bytes
    tr.release_kv_pool()
    monkeypatch.setenv("CXXNET_HBM_CAPACITY_GIB",
                       repr(4 * 2 * l_max // bs * block_bytes / 2.0**30))
    lg = perf.ledger()
    lg.reset()
    perf.enable()
    try:
        cap = lg.decode_pool_cap_bytes(0.5)
        pool = adapter._pool()
        assert pool.nbytes <= max(cap, (l_max // bs + 1) * block_bytes)
        assert l_max // bs <= pool.alloc.usable < 4 * l_max // bs
        tr.release_kv_pool()
        # a cap below one sequence floors at one sequence
        tiny = tlt._SlotBackendAdapter(lambda: tr, [1, 4], 2, kv_block=bs,
                                       kv_pool_frac=0.01)
        assert tiny._pool().alloc.usable == l_max // bs
    finally:
        perf.disable()
        lg.reset()
        tr.release_kv_pool()
