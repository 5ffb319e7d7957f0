"""The port's status HTTP server (cxxnet_tpu_torch/utils/statusd.py) and the
telemetry pieces its pages read, on the CPU, against the JAX package's: the
scenarios of tests/test_statusd.py run against the port's ``statusd``,
``telemetry``, ``health`` and ``autopsy``; a differential rendering of one
registry content by both packages' ``prometheus_metrics``, ``requestz_html``,
``batchz_html``, ``why_html`` and ``eventz_html``; the pages the port does
not serve; and ``status_port`` through the command line.

A JAX scenario runs against the port by swapping the globals of the JAX test
module that name those modules for the port's, for the length of the case
(the fixtures ``registry`` and ``server`` are rebuilt here on the port's
registry and server), and the report tools they drive for their twins in
the port (``cxxnet_tpu_torch.tools.telemetry_report`` and
``summarize_trace``). Left out, each for its reason:

* ``test_bench_compare_gates_subfields`` tests tools/bench_compare.py
  alone, a shared tool that reads no package.

The heartbeat channels, the watchdog, the health monitor and the recovery
policy under test (``test_healthz_flips_on_overdue_heartbeat``,
``test_healthz_flips_on_injected_anomaly``) are the port's
``utils/health.py``. Every socket has its own timeout.
"""

import inspect
import json
import os
import subprocess
import sys
from urllib.request import urlopen

import pytest

import cxxnet_tpu.utils as jutils
from cxxnet_tpu.utils import autopsy as jautopsy
from cxxnet_tpu.utils import statusd as jstatusd
from cxxnet_tpu.utils import telemetry as jtelemetry
from cxxnet_tpu_torch.tools import summarize_trace, telemetry_report
from cxxnet_tpu_torch.utils import autopsy, health, statusd, telemetry

from . import test_statusd as jtests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


@pytest.fixture()
def registry():
    reg = telemetry._Registry()
    reg.enable()
    yield reg
    reg.disable()


@pytest.fixture()
def server(registry):
    srv = statusd.StatusServer(0, host="127.0.0.1",
                               registry=registry).start()
    yield srv
    srv.stop()


# the JAX scenarios that run against the port (the module docstring says
# why the others are left out)
SCENARIOS = (
    "test_endpoints_smoke",
    "test_port_zero_binds_real_port",
    "test_out_of_range_port_raises_overflow",
    "test_healthz_flips_on_overdue_heartbeat",
    "test_healthz_flips_on_injected_anomaly",
    "test_broken_probe_is_a_failure_not_a_crash",
    "test_prometheus_format_validity",
    "test_histogram_merge_exactness",
    "test_histogram_dict_roundtrip_and_overflow",
    "test_span_feeds_histogram",
    "test_rank_placeholder_expansion",
    "test_events_tagged_with_process_index",
    "test_merge_keeps_unresolved_anomalies_per_process",
    "test_empty_histogram_sentinel_and_na",
    "test_slo_tracker_rolling_window_and_reasons",
    "test_slo_burn_transition_events_only",
    "test_batchz_html_and_decode_metrics_render",
    "test_hbm_decode_kv_row_renders",
    "test_404_lists_every_endpoint",
    "test_why_endpoint_replica_autopsy",
    "test_eventz_timeline",
    "test_books_broken_gauge_latches_in_scrape",
    "test_statusd_selftest",
    # through the port's twins of the report tools
    "test_report_merge_shards",
    "test_report_merge_rejects_duplicate_shards",
    "test_report_merge_rejects_malformed_shards",
    "test_report_single_log_still_works",
    "test_summarize_trace_request_format",
)


def _swap(monkeypatch):
    for attr, mod in (("statusd", statusd), ("telemetry", telemetry),
                      ("health", health), ("autopsy", autopsy),
                      ("HIST_BUCKETS", telemetry.HIST_BUCKETS),
                      ("Histogram", telemetry.Histogram),
                      ("telemetry_report", telemetry_report),
                      ("summarize_trace", summarize_trace)):
        monkeypatch.setattr(jtests, attr, mod)
    # test_slo_burn_transition_events_only reaches the registry through
    # ``import cxxnet_tpu.utils.telemetry``, which reads this attribute
    monkeypatch.setattr(jutils, "telemetry", telemetry)


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_statusd_scenario_on_the_port(name, registry, server, tmp_path,
                                          capsys, monkeypatch):
    _swap(monkeypatch)
    # one scrape first: a process's first HTTP request pays for lazy
    # imports, which would eat the 50 ms heartbeat budget of
    # test_healthz_flips_on_overdue_heartbeat
    jtests._get(server, "/livez")
    fn = getattr(jtests, name)
    given = {"registry": registry, "server": server, "tmp_path": tmp_path,
             "capsys": capsys}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


@pytest.mark.parametrize("path,has_json,has_n", statusd.ENDPOINTS)
def test_jax_endpoint_query_contract_on_the_port(server, path, has_json,
                                                 has_n, monkeypatch):
    _swap(monkeypatch)
    jtests.test_endpoint_query_contract(server, path, has_json, has_n)


def test_unported_pages_answer_404_and_say_so(server):
    """Every page of the JAX package is served since the fleet router:
    the endpoint tables are equal, and /fleetz on a process that is not
    a router answers 404 naming the wiring, then reads a registered
    fleet."""
    assert statusd.ENDPOINTS == jstatusd.ENDPOINTS
    code, body = jtests._get(server, "/fleetz?json=1")
    assert code == 404 and "not a router" in body and "task = route" in body

    class _Fleet:
        def fleet_snapshot(self):
            return json.loads(json.dumps(FLEET))

    server.fleet = _Fleet()
    try:
        code, body = jtests._get(server, "/fleetz?json=1&n=1")
        assert code == 200
        snap = json.loads(body)
        assert snap["eligible"] == 1 and len(snap["replicas"]) == 1
        code, page = jtests._get(server, "/fleetz")
        assert code == 200 and page == statusd.fleetz_html(FLEET)
        code, page = jtests._get(server, "/statusz")
        assert code == 200 and "eligible" in page
    finally:
        server.fleet = None


# ----------------------------------------------------------------------
# one registry content rendered by both packages
def _fill(reg):
    for d in (0.0005, 0.003, 0.02, 0.02, 1.5):
        reg.hist("train.step", d)
    reg.count("train.images", 512)
    reg.count("weird/name.with-chars", 1)
    reg.count("serve.accepted", 10)
    reg.gauge("g", -2.5)
    reg.gauge("overflowed", float("inf"))
    reg.gauge("nan_gauge", float("nan"))
    reg.gauge("device.bytes_in_use", 12345)
    reg.declare_hist("serve.ttft")
    reg.hist("serve.request", 0.05)
    reg.record_compile("kernel:lrn_fwd", "first_use", 1.25)


BATCH = {
    "buckets": {"2": {"warm": 1, "active": 1, "kv_bytes": 4096,
                      "kv_live_bytes": 1024, "live_tokens": 16,
                      "alloc_tokens": 128, "blocks_held": 3},
                "4": {"warm": 0, "active": 0, "kv_bytes": 0,
                      "kv_live_bytes": 0, "live_tokens": 0,
                      "alloc_tokens": 0, "blocks_held": 0}},
    "capacity": 4, "free_slots": 1, "queue_depth": 3,
    "kv_bytes": 4096, "kv_live_bytes": 1024, "kv_live_pct": 25.0,
    "slot_waste_pct": 50.0, "convoy": 1, "convoys": 2,
    "convoy_iters": 64, "iterations": 10, "slot_iterations": 17,
    "mean_occupancy": 1.7, "flight_cap": 256,
    "pool": {"blocks_total": 64, "blocks_free": 10, "blocks_used": 54,
             "block_tokens": 16, "pool_bytes": 8192,
             "prefix_queries": 9, "prefix_hits": 4,
             "prefix_hit_tokens": 40, "cow_copies": 1,
             "alloc_failures": 2, "prefix_hit_rate": 12.5,
             "blocks_retained": 3, "retained_cap": 32,
             "retained_hits": 1, "retained_hit_tokens": 16,
             "retained_evictions": 5, "retained_hit_rate": 3.25,
             "pressure": True},
    "flight": [{"iter": 10, "t_wall": 1.0, "bucket": 2,
                "occupancy": 1, "step_ms": 2.5,
                "slots": [[0, "7", 9]], "admitted": [["7", 0]],
                "retired": [["6", 1]], "queue_depth": 3,
                "queue_age_s": 0.5, "kv_live_pct": 25.0,
                "age_skew": None, "convoy": 1, "blocks_free": 10,
                "blocks_total": 64}]}

# a routerd.Router.fleet_snapshot() of three replicas
FLEET = {
    "replicas": [
        {"name": "127.0.0.1:7001", "state": "up", "hold": False,
         "queue_depth": 2, "in_flight": 1, "outstanding": 1,
         "ejections": 0, "probe_fails": 0, "last_probe_age_s": 0.1,
         "warm_pct": 100.0, "free_slots": 2,
         "buckets": {"4": {"warm": 1, "active": 2}},
         "detail": "ready"},
        {"name": "127.0.0.1:7002", "state": "dead", "hold": False,
         "queue_depth": 0, "in_flight": 0, "outstanding": 0,
         "ejections": 3, "probe_fails": 3, "last_probe_age_s": None,
         "detail": "statusd unreachable"},
        {"name": "127.0.0.1:7003", "state": "warming", "standby": True,
         "hold": False, "queue_depth": 0, "in_flight": 0,
         "outstanding": 0, "ejections": 0, "probe_fails": 0,
         "last_probe_age_s": 0.1, "warm_pct": 25.0,
         "detail": "warming: 1/4 programs"}],
    "eligible": 1, "draining": False, "reloading": False,
    "windows": [{"replica": "127.0.0.1:7001", "out_s": 1.0,
                 "back_s": 1.5}],
    "stats": {"accepted": 5, "served": 4, "shed": 1, "errors": 0,
              "deadline": 0, "retries": 1, "admin": 0, "client_gone": 0,
              "lost_contact": 1, "replays": 1, "replay_denied": 0,
              "hedges": 0, "hedge_wins": 0, "discarded_late": 1}}

RECORDS = [
    {"id": "42", "outcome": "served", "t_wall": 5.0, "total_s": 2.0,
     "ttft_s": 1.6, "tokens_out": 8,
     "phases": {"queue_wait": 0.1, "dispatch": 0.0, "prefill": 1.5,
                "decode": 0.4}, "compile_stall_s": 1.4},
    {"id": "43", "outcome": "shed", "shed_at": "queue", "total_s": 0.0,
     "phases": {}, "recompiles": []},
    {"id": "44", "outcome": "served", "t_wall": 6.0, "total_s": 0.5,
     "ttft_s": 0.1, "tokens_out": 4,
     "phases": {"queue_wait": 0.3, "dispatch": 0.0, "prefill": 0.1,
                "decode": 0.1}, "convoy_overlap_s": 0.2, "kv_defers": 1},
]


def test_prometheus_metrics_renders_as_the_jax_package_does():
    """The same registry content, progress, health, SLO, tenant SLO,
    batch and books accounts through both packages' renderers: the same
    Prometheus text."""
    preg, jreg = telemetry._Registry(), jtelemetry._Registry()
    for reg in (preg, jreg):
        reg.enable()
        _fill(reg)
    snaps = [reg.metrics_snapshot() for reg in (preg, jreg)]
    for s in snaps:
        s["uptime_s"] = 12.5       # the two registries started apart
    # (as JSON text: the NaN gauge equals itself there)
    assert json.dumps(snaps[0], sort_keys=True) == \
        json.dumps(snaps[1], sort_keys=True)
    clock = [0.0]
    slo = {}
    for name, mod in (("port", statusd), ("jax", jstatusd)):
        tr = mod.SLOTracker(ttft_ms=10.0, min_requests=2,
                            clock=lambda: clock[0])
        for ok, ttft in ((True, 0.5), (True, 0.001), (False, None)):
            tr.observe(ok=ok, ttft_s=ttft)
        slo[name] = tr.snapshot()
    assert slo["port"] == slo["jax"]
    kw = dict(progress={"round": 3, "num_round": 10, "batch": 17,
                        "served": 2, "errors": 1},
              health_failures=[("serving", "draining")],
              channels=[("train.step", 0.25, 1.0, False)],
              live_failures=[], slo=slo["port"],
              slo_tenants={"paid": slo["port"], "free": slo["port"]},
              batch=BATCH,
              books={"laws": ["servd.books"], "broken": ["old.law"],
                     "sweeps": 7},
              fleet=FLEET)
    got = statusd.prometheus_metrics(snaps[0], **kw)
    want = jstatusd.prometheus_metrics(snaps[1], **kw)
    assert got == want
    for line in got.splitlines():
        if line and not line.startswith("#"):
            assert statusd.PROM_LINE_RE.match(line), line
    assert 'cxxnet_progress_round{process="0"} 3' in got
    assert "cxxnet_compiles_total" in got and "cxxnet_decode_kv_pressure" \
        in got
    assert 'cxxnet_fleet_state{process="0",state="dead"} 1' in got


def test_pages_render_as_the_jax_package_does():
    fr, jfr = telemetry.FlightRecorder(cap=8), jtelemetry.FlightRecorder(cap=8)
    for rec in RECORDS:
        fr.record(dict(rec))
        jfr.record(dict(rec))
    assert statusd.requestz_html(fr.list(), 3, 8, 0) == \
        jstatusd.requestz_html(jfr.list(), 3, 8, 0)
    assert statusd.batchz_html(BATCH) == jstatusd.batchz_html(BATCH)
    assert statusd.fleetz_html(FLEET) == jstatusd.fleetz_html(FLEET)
    for rec in RECORDS:
        aut = autopsy.classify_record(rec)
        assert aut == jautopsy.classify_record(rec)
        payload = {"id": rec["id"], "outcome": rec["outcome"],
                   "autopsy": aut, "hops": {}}
        assert statusd.why_html(payload) == jstatusd.why_html(payload)
    evs = [{"ev": "kv_pressure", "pressure": 1, "ts": 1.0},
           {"ev": "decode_convoy", "convoy": 1, "ts": 1.1},
           {"ev": "serve_drain", "ts": 1.5},
           {"ev": "slo_burn", "state": 1, "ts": 1.6},
           {"ev": "kv_pressure", "pressure": 0, "ts": 2.0},
           {"ev": "books_broken", "law": "x", "broken": 1, "ts": 2.5},
           {"ev": "round", "ts": 3.0}]
    recs = [dict(r, autopsy=autopsy.classify_record(r)) for r in RECORDS]
    rows = autopsy.incidents(evs, t0_wall=1000.0, records=recs)
    assert rows == jautopsy.incidents(evs, t0_wall=1000.0, records=recs)
    assert [r["kind"] for r in rows][:3] == ["kv_pressure",
                                             "decode_convoy", "serve_drain"]
    assert statusd.eventz_html(rows, 0) == jstatusd.eventz_html(rows, 0)
    assert autopsy.incidents(evs, n=2) == jautopsy.incidents(evs, n=2)


def test_telemetry_summary_and_chrome_trace_as_the_jax_package():
    """summary(), brief_summary() and the Chrome trace of one recorded
    run agree with the JAX registry's on the same events."""
    preg, jreg = telemetry._Registry(), jtelemetry._Registry()
    for reg in (preg, jreg):
        reg.enable()
        t0 = reg.t0_perf
        for i, d in enumerate((0.01, 0.02, 0.005, 0.04)):
            reg.span_event("train.step", t0 + i, d)
            reg.span_event("io.wait", t0 + i + 0.5, d / 2)
        reg.count("train.images", 64)
        reg.gauge("device.bytes_in_use", 7)
        reg.record_compile("kernel:lrn_bwd", "first_use", 0.75)
    ps, js = preg.summary(), jreg.summary()
    assert ps == js
    assert preg.brief_summary(summary=ps) == jreg.brief_summary(summary=js)
    evs = preg.events()
    assert telemetry.events_to_chrome(evs) == \
        jtelemetry.events_to_chrome(evs)
    assert preg.last_event("compile")["name"] == "kernel:lrn_bwd"


def test_finish_writes_summary_and_trace(tmp_path):
    reg = telemetry._Registry()
    log = str(tmp_path / "run.jsonl")
    reg.enable(log)
    with reg.span("round", round=0):
        reg.count("train.images", 8)
    s = reg.finish(close=True)
    assert not reg.enabled and s["spans"]["round"]["count"] == 1
    evs = [json.loads(ln) for ln in open(log) if ln.strip()]
    assert evs[-1]["ev"] == "summary"
    trace = json.load(open(log + ".trace.json"))
    assert any(t.get("ph") == "X" and t["name"] == "round"
               for t in trace["traceEvents"])


def test_sample_device_memory_is_none_on_the_cpu():
    old = telemetry._REG
    telemetry._REG = telemetry._Registry()
    try:
        assert telemetry.sample_device_memory() is None
        telemetry._REG.enable()
        assert telemetry.sample_device_memory() is None
        assert "device.bytes_in_use" not in telemetry._REG.gauges
    finally:
        telemetry._REG = old


# ----------------------------------------------------------------------
# status_port through the command line
CONF = """
data = train
iter = mnist
    path_img = "{train_img}"
    path_label = "{train_lab}"
iter = end
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
layer[+0] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 100
dev = cpu
model_dir = {model_dir}
num_round = 1
max_round = 1
eta = 0.1
metric = error
ckpt_fsync = 0
"""


def _scrape_in_round(port_box, seen):
    """Trainer.update stand-in hook: scrape the live server once, from
    inside the second training step (the round in progress, one batch
    done)."""
    calls = [0]

    def scrape():
        calls[0] += 1
        if calls[0] != 2 or port_box[0] is None:
            return
        base = "http://127.0.0.1:%d" % port_box[0]
        seen["metrics"] = urlopen(base + "/metrics",
                                  timeout=5).read().decode()
        seen["healthz"] = urlopen(base + "/healthz", timeout=5).status
        seen["statusz"] = urlopen(base + "/statusz",
                                  timeout=5).read().decode()
    return scrape


def test_cli_status_port_reports_the_round_in_progress(tmp_path,
                                                       monkeypatch,
                                                       capsys):
    from cxxnet_tpu_torch import learn_task
    from cxxnet_tpu_torch.nnet.trainer import Trainer

    from . import synth_mnist
    data = synth_mnist.make_dataset(str(tmp_path / "data"), n_train=200,
                                    n_test=100)
    conf = tmp_path / "t.conf"
    conf.write_text(CONF.format(model_dir=tmp_path / "models", **data))
    port_box, seen = [None], {}
    real_start = statusd.start

    def start(*a, **kw):
        srv = real_start(*a, **kw)
        port_box[0] = srv.port
        return srv
    monkeypatch.setattr(statusd, "start", start)
    scrape = _scrape_in_round(port_box, seen)
    orig = Trainer.update

    def update(self, batch):
        orig(self, batch)
        scrape()
    monkeypatch.setattr(Trainer, "update", update)
    assert learn_task.main([str(conf), "status_port=0"]) == 0
    err = capsys.readouterr().err
    assert "statusd: live introspection on port %d" % port_box[0] in err
    assert seen["healthz"] == 200
    assert 'cxxnet_progress_round{process="0"} 0' in seen["metrics"]
    assert 'cxxnet_progress_batch{process="0"} 1' in seen["metrics"]
    assert "task" in seen["statusz"] and "train" in seen["statusz"]
    # the server is gone with the run, and the in-memory telemetry with it
    assert statusd.active() is None and not telemetry.enabled()
    with pytest.raises(OSError):
        urlopen("http://127.0.0.1:%d/healthz" % port_box[0], timeout=2)


def test_cli_status_port_taken_warns_and_trains(tmp_path, capsys):
    import socket

    from cxxnet_tpu_torch import learn_task

    from . import synth_mnist
    data = synth_mnist.make_dataset(str(tmp_path / "data"), n_train=200,
                                    n_test=100)
    conf = tmp_path / "t.conf"
    conf.write_text(CONF.format(model_dir=tmp_path / "models", **data))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        assert learn_task.main([str(conf), "status_port=%d" % taken]) == 0
    err = capsys.readouterr().err
    assert "WARNING: statusd: cannot bind port %d" % taken in err
    assert os.path.exists(tmp_path / "models" / "0001.model")
    assert not telemetry.enabled()


def test_cli_telemetry_log_prints_the_summary(tmp_path, capsys):
    from cxxnet_tpu_torch import learn_task

    from . import synth_mnist
    data = synth_mnist.make_dataset(str(tmp_path / "data"), n_train=200,
                                    n_test=100)
    conf = tmp_path / "t.conf"
    conf.write_text(CONF.format(model_dir=tmp_path / "models", **data))
    log = str(tmp_path / "run.jsonl")
    assert learn_task.main([str(conf), "telemetry_log=" + log]) == 0
    out = capsys.readouterr().out
    assert "---- telemetry summary ----" in out
    assert "round" in out and "checkpoint" in out
    evs = [json.loads(ln) for ln in open(log) if ln.strip()]
    kinds = {e["ev"] for e in evs}
    assert {"ckpt_save", "round", "summary"} <= kinds
    assert os.path.exists(log + ".trace.json")


def test_statusd_selftest_under_lockrank_in_a_process():
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.utils.statusd",
         "--selftest"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CXXNET_LOCKRANK="1"))
    assert out.returncode == 0, out.stderr
    assert "statusd selftest" in out.stdout and "404" in out.stdout
