"""``task = serve`` and ``api.Net.serve`` of the port on the CPU, against the
JAX package's, on one JAX-written model file of the JAX package's decode-test
LM (tests/test_torch_decode.py: trained by the JAX package on the phase
sequences, so its greedy next tokens have clear margins and are compared
exactly).

* Both command lines serve one stdin (prompts of several lengths, a
  ``DEADLINE`` line, an out-of-vocab token, an empty line, ``ADMIN stats``)
  and print the same stdout lines: solo dispatch, continuous batching over
  dense sessions, and over paged sessions (``serve_kv_block = 4``).
* ``api.Net.serve`` answers over TCP with ``Net.generate``'s tokens, solo
  and batched, dense and paged.
* Sampled serving is held to the port's own solo ``generate`` at
  ``gen_seed + seq`` (its draws are the port's Philox bits, not
  ``jax.random``'s).
* ``ADMIN reload`` swaps in a newer checkpoint between requests.

The stdin is an iterator that waits a moment before its ``ADMIN`` lines, so
that the dispatcher has published its books after the last answer (the
pump sends the next line as soon as the answer is out).
"""

import time

import numpy as np
import pytest

from cxxnet_tpu import learn_task as jlt
from cxxnet_tpu_torch import api
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch.utils import servd

from .test_torch_decode import (VOCAB, _conf, _jax_trained, _prompts,
                                _write_jax_model)

GEN_NEW = 5


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX trainer, path of its model file as <dir>/0001.model)."""
    jtr = _jax_trained(_conf(), 30)
    d = tmp_path_factory.mktemp("serve_model")
    path = str(d / "0001.model")
    _write_jax_model(jtr, path)
    return jtr, path


class _Stdin:
    """Lines for the serve pump; waits ``pause`` before each ADMIN line and
    the line after it, and calls ``hooks[i]`` (if any) before it yields
    line i."""

    def __init__(self, lines, pause=0.3, hooks=None):
        self.lines = lines
        self.pause = pause
        self.hooks = hooks or {}

    def __iter__(self):
        for i, line in enumerate(self.lines):
            if line.startswith("ADMIN") or (
                    i and self.lines[i - 1].startswith("ADMIN")):
                time.sleep(self.pause)
            if i in self.hooks:
                self.hooks[i]()
            yield line + "\n"


def _stdin_lines():
    rs = np.random.RandomState(21)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (4, 7, 4, 6, 7)]
    lines = [" ".join(map(str, p)) for p in prompts]
    lines.insert(2, "DEADLINE 5000 " + lines[1])
    lines += ["3 %d 5" % VOCAB, "", "ADMIN stats"]
    return prompts, lines


def _serve(main, conf_path, lines, capsys, monkeypatch, hooks=None):
    monkeypatch.setattr("sys.stdin", _Stdin(lines, hooks=hooks))
    capsys.readouterr()
    assert main([conf_path]) == 0
    out = capsys.readouterr().out
    return out.splitlines()


SERVE_MODES = {
    "solo": "",
    "batched": "serve_buckets = 1,2,4\n",
    "paged": "serve_buckets = 1,2,4\nserve_kv_block = 4\n",
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_cli_serve_lines_equal_the_jax_clis(model, mode, tmp_path, capsys,
                                            monkeypatch):
    jtr, path = model
    prompts, lines = _stdin_lines()
    outs = {}
    for name, main in (("jax", jlt.main), ("port", tlt.main)):
        cf = tmp_path / ("%s.conf" % name)
        cf.write_text(_conf() + "task = serve\nmodel_in = %s\n"
                      "model_dir = %s\ngen_new = %d\nsilent = 1\n%s"
                      % (path, tmp_path / "models", GEN_NEW,
                         SERVE_MODES[mode]))
        outs[name] = _serve(main, str(cf), lines, capsys, monkeypatch)
    assert outs["port"] == outs["jax"]
    got = outs["port"]
    assert len(got) == len(lines)
    assert got[-3].startswith("ERR parse token id outside vocab_size")
    assert got[-2].startswith("ERR empty")
    assert got[-1].startswith("OK accepted=8 ")
    assert "served=6" in got[-1] and "errors=2" in got[-1]
    want = jtr.generate(np.asarray([prompts[0]]), GEN_NEW)[0]
    assert got[0] == " ".join(map(str, want))
    assert got[2] == got[1]          # the DEADLINE line's prompt


def test_api_serve_over_tcp_equals_generate(model):
    """Net.serve answers each TCP request with Net.generate's tokens, and
    with the JAX trainer's greedy tokens: solo, batched, paged."""
    jtr, path = model
    net = api.Net(dev="cpu", cfg=_conf())
    net.load_model(path)
    prompts = [p.tolist() for p in _prompts(4, 3, 5)] + [[1, 2, 3, 4, 5,
                                                          6, 7]]
    for kw in ({}, {"buckets": (1, 2, 4)},
               {"buckets": (1, 2, 4), "kv_block": 4}):
        fe = net.serve(port=0, n_new=GEN_NEW, **kw)
        try:
            got = servd._ask(fe.port, "ADMIN stats", timeout=10)
            assert got.startswith("OK accepted=0")
            for p in prompts:
                line = servd._ask(fe.port, " ".join(map(str, p)),
                                  timeout=30)
                want = net.generate(np.asarray([p]), GEN_NEW)[0]
                assert line == " ".join(map(str, want)), (kw, p)
                jwant = jtr.generate(np.asarray([p]), GEN_NEW)[0]
                np.testing.assert_array_equal(want, jwant)
        finally:
            stats = fe.drain()
        assert stats["served"] == len(prompts) and stats["errors"] == 0
        rec = fe.flight.list()[0]
        assert rec["outcome"] == "served" and rec["ttft_s"] is not None
        assert rec["phases"]["decode"] > 0          # the first_token mark
        assert rec["roofline_bound_tokens_per_s"] is None


def test_cli_serve_sampled_equals_solo_generate_at_seed_plus_seq(
        model, tmp_path, capsys, monkeypatch):
    """Sampled serving, batched: request seq (its dispatch ordinal, here
    its line number) answers the port's solo generate at gen_seed + seq."""
    _, path = model
    prompts, _ = _stdin_lines()
    lines = [" ".join(map(str, p)) for p in prompts]
    cf = tmp_path / "sample.conf"
    cf.write_text(_conf() + "task = serve\nmodel_in = %s\ngen_new = %d\n"
                  "gen_temperature = 0.8\ngen_topk = 3\ngen_seed = 11\n"
                  "serve_buckets = 1,2,4\nsilent = 1\n" % (path, GEN_NEW))
    got = _serve(tlt.main, str(cf), lines, capsys, monkeypatch)
    net = api.Net(dev="cpu", cfg=_conf())
    net.load_model(path)
    assert len(got) == len(prompts)
    for seq, (p, line) in enumerate(zip(prompts, got)):
        want = net.generate(np.asarray([p]), GEN_NEW, temperature=0.8,
                            top_k=3, seed=11 + seq)[0]
        assert line == " ".join(map(str, want)), seq
    # and it did sample: some line is not the greedy continuation
    greedy = [" ".join(map(str, net.generate(np.asarray([p]), GEN_NEW)[0]))
              for p in prompts]
    assert got != greedy


def test_cli_admin_reload_picks_up_a_newer_checkpoint(model, tmp_path,
                                                      capsys, monkeypatch):
    """ADMIN reload between requests loads the newest numbered checkpoint
    of model_dir: the requests after it answer with the new model's
    tokens, and the old trainer (its paged KV pool with it) is gone from
    memory once the reload is done; a second reload with nothing newer is
    skipped."""
    import weakref
    jtr, path = model
    d = tmp_path / "models"
    d.mkdir()
    first = str(d / "0001.model")
    with open(path, "rb") as f, open(first, "wb") as g:
        g.write(f.read())
    newer = _jax_trained(_conf(), 3)          # barely trained: other tokens
    p = [1, 2, 3, 4]
    lines = [" ".join(map(str, p)), "ADMIN reload", " ".join(map(str, p)),
             "ADMIN reload", " ".join(map(str, p)), "ADMIN stats"]
    lt = tlt.LearnTask()
    old = {}

    def before_reload():
        _write_jax_model(newer, str(d / "0003.model"))
        old["trainer"] = weakref.ref(lt.net_trainer)
        old["pool"] = weakref.ref(lt.net_trainer._kv_pool)

    def after_reload():
        old["gone"] = old["trainer"]() is None and old["pool"]() is None
    hooks = {1: before_reload, 2: after_reload}
    cf = tmp_path / "reload.conf"
    cf.write_text(_conf() + "task = serve\nmodel_in = %s\nmodel_dir = %s\n"
                  "gen_new = %d\nserve_buckets = 1,2\nserve_kv_block = 4\n"
                  "silent = 1\n" % (first, d, GEN_NEW))
    got = _serve(lt.run, str(cf), lines, capsys, monkeypatch, hooks=hooks)
    assert old["gone"]
    old = " ".join(map(str, jtr.generate(np.asarray([p]), GEN_NEW)[0]))
    new = " ".join(map(str, newer.generate(np.asarray([p]), GEN_NEW)[0]))
    assert old != new
    assert got[0] == old
    assert got[1] == "OK reload scheduled" and got[3] == got[1]
    assert got[2] == new and got[4] == new
    assert "reloads=1 " in got[5] and "reload_seen=2 " in got[5]


def test_serve_keys_left_out_are_refused():
    lt = tlt.LearnTask()
    # the world's keys are ported since the multi-process slice
    # (tests/test_torch_multihost.py runs them)
    lt.set_param("coordinator", "localhost:1234")
    assert lt.coordinator == "localhost:1234"
    # the warm grid's keys are ported since the performance ledger
    # (tests/test_torch_compile_obs.py runs them), the router's since
    # the fleet router (tests/test_torch_routerd.py), the watchdog's since
    # the health slice (tests/test_torch_health_faults.py): each is read as
    # the JAX command line reads it
    jtask = jlt.LearnTask()
    for key, val in (("watchdog_timeout", "5"),
                     ("watchdog_action", "abort"),
                     ("serve_plen_buckets", "8,16"),
                     ("serve_warm_ready_pct", "50"),
                     ("serve_kv_pool_frac", "0.25"), ("route_port", "0"),
                     ("route_tenants", "free:1,paid:4"),
                     ("telemetry_log", "t.jsonl"), ("serve_port", "0"),
                     ("status_port", "0"), ("route_replicas", "a:1:2"),
                     ("route_hedge_ms", "5"), ("fleet_federate_ms", "10"),
                     ("route_probe_ms", "100"), ("route_replay", "0"),
                     ("route_standby_replicas", "b:3:4"),
                     ("route_scale_up_burn", "2.5"),
                     ("fleet_outlier_min_n", "7")):
        lt.set_param(key, val)
        jtask.set_param(key, val)
        assert getattr(lt, key) == getattr(jtask, key), key
    lt.set_param("task", "route")
    assert lt.task == "route"
    lt.set_param("task", "serve")
    assert lt.task == "serve" and lt.route_tenants == "free:1,paid:4"
    assert lt.status_port == 0
    assert (lt.serve_plen_buckets, lt.serve_warm_ready_pct,
            lt.serve_kv_pool_frac) == ("8,16", 50.0, 0.25)
    assert (lt.route_replicas, lt.route_hedge_ms, lt.fleet_federate_ms,
            lt.route_replay) == ("a:1:2", 5.0, 10.0, 0)


def test_route_keys_default_as_the_jax_command_line():
    lt, jtask = tlt.LearnTask(), jlt.LearnTask()
    for key, cast, default in tlt._ROUTE_KEYS:
        assert getattr(lt, key) == getattr(jtask, key) == default, key
        assert type(getattr(jtask, key)) is cast, key


def test_cli_serve_telemetry_log_records_the_requests(model, tmp_path,
                                                      capsys, monkeypatch):
    """telemetry_log = <path>: the run log holds a serve_request_done
    event per request, with the JAX package's fields."""
    import json
    _, path = model
    log = tmp_path / "run.jsonl"
    cf = tmp_path / "tl.conf"
    cf.write_text(_conf() + "task = serve\nmodel_in = %s\ngen_new = %d\n"
                  "telemetry_log = %s\nsilent = 1\n" % (path, GEN_NEW, log))
    got = _serve(tlt.main, str(cf), ["1 2 3", "4 5"], capsys, monkeypatch)
    assert len(got) == 2
    evs = [json.loads(l) for l in log.read_text().splitlines()]
    done = [e for e in evs if e["ev"] == "serve_request_done"]
    assert [e["outcome"] for e in done] == ["served", "served"]
    assert all(e["ttft_s"] is not None and "autopsy" in e for e in done)
    assert any(e["ev"] == "serve_done" for e in evs)
