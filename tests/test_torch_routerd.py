"""The port's fleet router (cxxnet_tpu_torch/utils/routerd.py) on the CPU,
against the JAX package's: every scenario of tests/test_routerd.py and
tests/test_failover.py and tests/test_autopsy.py, each run against the
port's ``routerd``, ``servd``, ``statusd``, ``telemetry`` and ``autopsy``
(and the report tool's twin, ``cxxnet_tpu_torch.tools.telemetry_report``);
the router and autopsy
selftests in subprocesses; a differential run of one scripted, timing-free
traffic through the JAX router over two JAX frontends and the port's router
over two port frontends, whose response lines, final stats, flight
outcomes and ``/fleetz`` snapshots must be equal; and the port-only
contracts (``task = route`` of ``bin/cxxnet_torch`` builds no net and
initializes no CUDA, ``watchdog_timeout`` stays refused there, and every
replica the chaos scenarios spawn is a port process).

A JAX scenario runs against the port by swapping the globals of the JAX
test modules that name those modules, its fault injector and its
``subprocess`` for the port's, for the length of the case. The fault
injector's fleet helpers are rewritten here: tests/faultinject.py spawns
``-m cxxnet_tpu.utils.servd`` replicas through a ``subprocess`` of its
own, which no swap reaches. Each spawn reads the replica's
``/proc/<pid>/cmdline`` and fails unless it runs the port's servd.
Everything runs with ``CXXNET_LOCKRANK=1``, and every socket has its own
timeout.
"""

import inspect
import json
import os
import random
import subprocess
import sys
import threading
import types
from urllib.request import urlopen

import pytest

from cxxnet_tpu.utils import routerd as jrouterd
from cxxnet_tpu.utils import servd as jservd
from cxxnet_tpu.utils import statusd as jstatusd
from cxxnet_tpu.utils import telemetry as jtelemetry
from cxxnet_tpu_torch.tools import telemetry_report
from cxxnet_tpu_torch.utils import autopsy, routerd, servd, statusd
from cxxnet_tpu_torch.utils import telemetry

from . import faultinject as jfaultinject
from . import test_autopsy as jautopsy_tests
from . import test_failover as jfailover_tests
from . import test_routerd as jtests
from .test_torch_servd import faultinject as port_servd_faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SERVD = "cxxnet_tpu_torch.utils.servd"


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


# ----------------------------------------------------------------------
# the fault injector of the port: tests/faultinject.py's fleet helpers
# spawning the port's stub replica, and test_torch_servd's backends and
# clients over the port's servd
def _cmdline(pid: int):
    with open("/proc/%d/cmdline" % pid, "rb") as f:
        return f.read().decode().split("\0")


def assert_port_replica(proc) -> None:
    """Fail unless ``proc`` runs the port's stub replica."""
    args = _cmdline(proc.pid)
    assert PORT_SERVD in args and "cxxnet_tpu.utils.servd" not in args, \
        args


def _start_stub(port=0, status_port=0, delay_ms=0.0, queue=64,
                drain_ms=5000.0, stall_s=120.0, breaker_fails=5,
                explode_every=0, reload_ms=0.0, tenants="",
                tenant_default="default", batch_max=0, n_new=8,
                per_token_ms=0.0):
    """tests/faultinject.py's ``_start_stub`` on the port's servd."""
    args = [sys.executable, "-m", PORT_SERVD, "--stub",
            "--port", str(port), "--status-port", str(status_port),
            "--delay-ms", str(delay_ms), "--queue", str(queue),
            "--drain-ms", str(drain_ms), "--stall-s", str(stall_s),
            "--breaker-fails", str(breaker_fails),
            "--explode-every", str(explode_every),
            "--reload-ms", str(reload_ms)]
    if batch_max:
        args += ["--batch-max", str(batch_max), "--n-new", str(n_new),
                 "--per-token-ms", str(per_token_ms)]
    if tenants:
        args += ["--tenants", str(tenants),
                 "--tenant-default", str(tenant_default)]
    return subprocess.Popen(args, stdout=subprocess.PIPE, text=True,
                            cwd=REPO), args


def _await_ports(proc, timeout=20.0):
    """tests/faultinject.py's ``_await_ports``, then the cmdline check."""
    ports = jfaultinject._await_ports(proc, timeout=timeout)
    assert_port_replica(proc)
    return ports


def _replica(proc, args, timeout):
    port, status_port = _await_ports(proc, timeout=timeout)
    r = jfaultinject.FleetReplica(proc, port, status_port, args)
    # pin the ports so a restart lands on the same addresses
    r.args[r.args.index("--port") + 1] = str(r.port)
    r.args[r.args.index("--status-port") + 1] = str(r.status_port)
    return r


def spawn_replica(timeout=20.0, **kw):
    return _replica(*_start_stub(**kw), timeout)


def spawn_fleet(n, timeout=20.0, **kw):
    procs = [_start_stub(**kw) for _ in range(n)]
    return [_replica(proc, args, timeout) for proc, args in procs]


def restart_replica(r, timeout=20.0):
    jfaultinject.restart_replica(r, timeout=timeout)
    assert_port_replica(r.proc)
    return r


_PORT_FLEET = dict(
    FleetReplica=jfaultinject.FleetReplica,
    _start_stub=_start_stub, _await_ports=_await_ports,
    spawn_replica=spawn_replica, spawn_fleet=spawn_fleet,
    spawn_standby=spawn_replica, restart_replica=restart_replica)
for _name in ("stop_fleet", "kill_replica", "partition_replica",
              "heal_replica", "wedge_replica", "unwedge_replica", "kill9",
              "wedge_mid_decode", "partition", "tenant_flood",
              "retire_standby"):
    _PORT_FLEET[_name] = getattr(jfaultinject, _name)
faultinject = types.SimpleNamespace(
    **vars(port_servd_faultinject), **_PORT_FLEET)


class _PortSubprocess:
    """``subprocess`` as the JAX scenarios see it, with the JAX package's
    modules and command line swapped for the port's."""
    PIPE = subprocess.PIPE
    DEVNULL = subprocess.DEVNULL
    _SWAP = {"cxxnet_tpu.utils.servd": PORT_SERVD,
             "cxxnet_tpu.utils.routerd": "cxxnet_tpu_torch.utils.routerd",
             "cxxnet_tpu.utils.autopsy": "cxxnet_tpu_torch.utils.autopsy",
             "bin/cxxnet": "bin/cxxnet_torch"}

    @classmethod
    def Popen(cls, args, **kw):
        return subprocess.Popen([cls._SWAP.get(a, a) for a in args], **kw)


@pytest.fixture()
def make_router():
    """tests/test_routerd.py's ``make_router`` on the port's Router."""
    made = []

    def make(replicas, **kw):
        specs = [r.spec if isinstance(r, jfaultinject.FleetReplica)
                 else r for r in replicas]
        kw.setdefault("drain_ms", 2000.0)
        kw.setdefault("probe_timeout", 0.5)
        router = routerd.Router(specs, **kw)
        router.start()
        router.listen(0)
        made.append(router)
        return router

    yield make
    for router in made:
        router.drain(timeout_ms=2000)


def _swap(monkeypatch):
    for mod in (jtests, jfailover_tests):
        for attr, port in (("routerd", routerd), ("servd", servd),
                           ("statusd", statusd), ("telemetry", telemetry),
                           ("autopsy", autopsy),
                           ("faultinject", faultinject),
                           ("subprocess", _PortSubprocess)):
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, port)


def _run(mod, name, make_router):
    fn = getattr(mod, name)
    given = {"make_router": make_router}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# ----------------------------------------------------------------------
# tests/test_routerd.py and tests/test_failover.py against the port
ROUTERD_SCENARIOS = (
    "test_retryability_contract",
    "test_free_slots_load_signal_prefers_batching_replica",
    "test_parse_replicas",
    "test_routes_spreads_and_fleet_stats_reconcile",
    "test_queue_shed_retried_on_other_replica",
    "test_breaker_shed_ejects_replica",
    "test_replay_when_replica_dies_after_accepting",
    "test_replay_off_restores_never_replay",
    "test_deadline_budget_forwarded_and_enforced",
    "test_kill_and_partition_mid_flood_zero_loss",
    "test_rolling_reload_zero_downtime",
    "test_wedged_replica_routed_around",
    "test_fleetz_and_metrics_surfaces",
    "test_cli_route_task_sigterm_drain",
    "test_retryability_tenant_verdict_not_retried",
    "test_router_tenant_gate_sheds_over_share_on_saturated_fleet",
    "test_tenant_budget_burns_on_fleet_wide_outage",
    "test_autoscaler_standby_admit_and_retire",
    "test_tenant_flood_chaos_headline",
    "test_routerd_selftest",
)
FAILOVER_SCENARIOS = (
    "test_kill_mid_decode_zero_loss_token_exact",
    "test_wedge_mid_decode_rescued_and_replayed",
    "test_late_answer_reaped_and_counted",
    "test_replay_denied_across_generation",
    "test_tenant_over_share_gates_replay",
    "test_hedge_first_answer_wins",
    "test_hedge_cap_and_tenant_denial",
    "test_hedge_auto_delay_tracks_federated_p99",
    "test_batch_rescue_in_process",
)


@pytest.mark.parametrize("name", ROUTERD_SCENARIOS)
def test_jax_routerd_scenario_on_the_port(name, make_router, monkeypatch):
    _swap(monkeypatch)
    _run(jtests, name, make_router)


@pytest.mark.parametrize("name", FAILOVER_SCENARIOS)
def test_jax_failover_scenario_on_the_port(name, make_router, monkeypatch):
    _swap(monkeypatch)
    _run(jfailover_tests, name, make_router)


def test_every_scenario_of_the_jax_files_is_listed():
    for mod, listed in ((jtests, ROUTERD_SCENARIOS),
                        (jfailover_tests, FAILOVER_SCENARIOS),
                        (jautopsy_tests,
                         AUTOPSY_SCENARIOS + AUTOPSY_LEFT_OUT)):
        names = {n for n, f in vars(mod).items()
                 if n.startswith("test_") and callable(f)
                 and f.__module__ == mod.__name__}
        assert names == set(listed), names ^ set(listed)


# ----------------------------------------------------------------------
# tests/test_autopsy.py against the port's autopsy
AUTOPSY_SCENARIOS = (
    "test_cause_decode_baseline",
    "test_cause_queue_wait",
    "test_cause_compile_stall",
    "test_cause_convoy_victim",
    "test_cause_kv_defer",
    "test_cause_eviction_storm",
    "test_cause_hedge_replay",
    "test_cause_slow_replica",
    "test_mixed_record_single_primary_and_tiling",
    "test_named_cause_beats_baseline_on_tie",
    "test_wall_residual_lands_in_baseline",
    "test_bare_and_shed_records_still_classify",
    "test_stitch_scales_skewed_hop_books",
    "test_incidents_rows_sorted_and_classified",
    "test_incidents_links_overlapping_requests",
    "test_incidents_n_keeps_newest",
    "test_inconclusive_and_raising_laws_never_latch",
    "test_autopsy_module_selftest",
    # through the port's twin of tools/telemetry_report.py
    "test_books_latch_event_and_report_exit2",
    "test_report_incidents_and_autopsy_sections",
)
AUTOPSY_LEFT_OUT = ()


@pytest.mark.parametrize("name", AUTOPSY_SCENARIOS)
def test_jax_autopsy_scenario_on_the_port(name, tmp_path, capsys,
                                          monkeypatch):
    for attr, port in (("autopsy", autopsy), ("telemetry", telemetry),
                       ("telemetry_report", telemetry_report),
                       ("CAUSES", autopsy.CAUSES),
                       ("classify_record", autopsy.classify_record),
                       ("classify_route", autopsy.classify_route),
                       ("stitch_route", autopsy.stitch_route),
                       ("incidents", autopsy.incidents)):
        monkeypatch.setattr(jautopsy_tests, attr, port)
    fn = getattr(jautopsy_tests, name)
    given = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_autopsy_exports_as_the_jax_package():
    from cxxnet_tpu.utils import autopsy as jautopsy

    assert autopsy.__all__ == jautopsy.__all__
    assert autopsy.CAUSES == jautopsy.CAUSES
    assert routerd.__all__ == jrouterd.__all__
    assert statusd.ENDPOINTS == jstatusd.ENDPOINTS


@pytest.mark.parametrize("module", ["routerd", "autopsy"])
def test_selftest_in_a_process(module):
    env = dict(os.environ, CXXNET_LOCKRANK="1")
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.utils.%s" % module,
         "--selftest"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "%s selftest:" % module in p.stdout
    assert "lockrank" not in p.stderr.lower(), p.stderr


# ----------------------------------------------------------------------
# the saturation the tenant gate and the autoscaler read: the JAX router
# reads the probed queue depth alone, up to one probe interval old, and
# under a flood of fast requests sees an empty queue at most probes (the
# tenant flood scenario then misses its shed or its scale-up); the port
# also counts a solo replica's live backlog of the router's own requests
def _solo_fleet(mod, outstanding, **kw):
    router = mod.Router([("127.0.0.1", 1, 1), ("127.0.0.1", 2, 2)],
                        probe_ms=3600e3, tenants="noisy:1,victim:4",
                        tenant_default="victim", **kw)
    for r in router._replicas:
        r.state, r.queue_depth, r.in_flight = mod.UP, 0, 1
        r.outstanding = 0 if r.standby else outstanding
    router._tenant_active.update(noisy=6, victim=1)
    return router


@pytest.mark.parametrize("outstanding,shed", [(1, False), (3, True)])
def test_tenant_gate_reads_the_live_backlog(outstanding, shed):
    router = _solo_fleet(routerd, outstanding)
    gate = router._tenant_gate("noisy")
    assert (gate is not None) == shed, gate
    if shed:
        assert gate.startswith("ERR busy tenant noisy over fair share")
        assert routerd.retryable(gate) is False
    assert router._tenant_gate("victim") is None
    # the JAX router, on the same stale probe, admits the flood
    assert _solo_fleet(jrouterd, outstanding)._tenant_gate("noisy") is None


@pytest.mark.parametrize("outstanding,action", [(1, None), (3, "up")])
def test_autoscaler_reads_the_live_backlog(outstanding, action):
    router = _solo_fleet(routerd, outstanding,
                         standby_replicas=[("127.0.0.1", 3, 3)],
                         scale_cooldown_s=0.0)
    assert router.autoscale_now() == action
    if action:
        assert "queued work (4)" in router.scale_snapshot()[
            "recent"][0]["reason"]


# ----------------------------------------------------------------------
# the port's fleet helpers spawn port replicas
def test_chaos_replicas_are_port_processes(monkeypatch):
    _swap(monkeypatch)
    fleet = faultinject.spawn_fleet(2)
    try:
        two = jtests.spawn_two({"delay_ms": 5})
        fleet += two
        for r in fleet:
            assert_port_replica(r.proc)
            assert r.args[r.args.index("-m") + 1] == PORT_SERVD
        faultinject.kill_replica(fleet[0])
        faultinject.restart_replica(fleet[0])
        assert_port_replica(fleet[0].proc)
        assert faultinject.serve_request(fleet[0].port, "4") == "5"
    finally:
        faultinject.stop_fleet(fleet)


# ----------------------------------------------------------------------
# one scripted traffic through both routers
def _backend(toks, seq):
    if toks[0] == 66:
        raise RuntimeError("injected backend failure on %d" % toks[0])
    return [t + 1 + seq % 3 for t in toks]


# sequential (each line answered before the next is sent), so the pick,
# every replica's dispatch order and every counter are timing-free. Under
# zero load the pick's tie goes to replica 0; its breaker (2 failures, a
# cooldown longer than the run) opens at the second 66, so the next
# request is shed there ("ERR busy breaker") and retried on replica 1.
TRAFFIC = (
    "1 2 3", "", "1 x 2", "DEADLINE nope 1", "DEADLINE 5000 7",
    "DEADLINE -3 1", "TRACE req-a 4 5", "TRACE bad/id 1", "TRACE",
    "TENANT t1 3 4", "ADMIN stats", "ADMIN bogus", "66 1", "66 2",
    "5 6 7 8", "21 22", "9", "ADMIN stats",
    "TRACE req-b DEADLINE 5000 11 12", "ADMIN stats",
)
# the /fleetz fields read off a clock
_WALL_KEYS = {"last_probe_age_s", "out_s", "back_s", "t", "ts",
              "age_s", "backoff_s", "next_probe_s"}


def _strip_wall(obj):
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items()
                if k not in _WALL_KEYS and k != "name"}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


def _drive_fleet(rmod, smod, stmod, tmod, lines):
    tmod.enable()
    fes, sss = [], []
    router = None
    try:
        for _ in range(2):
            fe = smod.ServeFrontend(_backend, drain_ms=5000.0, vocab=100,
                                    breaker_fails=2,
                                    breaker_cooldown_ms=3600e3)
            fe.start()
            fe.listen(0)
            ss = stmod.StatusServer(0, host="127.0.0.1").start()
            ss.register_probe("serving", fe.health_probe)
            ss.flight = fe.flight
            fes.append(fe)
            sss.append(ss)
        random.seed(1234)
        router = rmod.Router(
            [("127.0.0.1", fe.port, ss.port) for fe, ss in zip(fes, sss)],
            probe_ms=3600e3, federate_ms=3600e3, retries=2, stall_s=10.0,
            drain_ms=5000.0)
        router.start()
        router.listen(0)
        router.probe_now()
        out = [smod._ask(router.port, line, timeout=10.0)
               for line in lines]
        fleetz = router.fleet_snapshot()
        flights = [(r["outcome"], len(r.get("attempts") or []))
                   for r in router.flight.list()]
        replica_served = [fe.stats()["served"] for fe in fes]
    finally:
        stats = router.drain() if router is not None else None
        for fe, ss in zip(fes, sss):
            fe.drain(timeout_ms=2000)
            ss.stop()
        tmod.disable()
    return out, stats, flights, _strip_wall(fleetz), replica_served


def test_scripted_traffic_equal_through_both_routers():
    jax_run = _drive_fleet(jrouterd, jservd, jstatusd, jtelemetry, TRAFFIC)
    port_run = _drive_fleet(routerd, servd, statusd, telemetry, TRAFFIC)
    for what, j, p in zip(("lines", "stats", "flight outcomes",
                           "fleetz", "replica served"), jax_run, port_run):
        assert j == p, (what, j, p)
    lines, stats, flights, fleetz, served = port_run
    # the scripted faults happened: a relayed backend error, a breaker
    # shed retried on replica 1, and both replicas served
    assert sum(ln.startswith("ERR backend") for ln in lines) == 2, lines
    assert stats["retries"] >= 1 and stats["errors"] >= 2, stats
    assert all(n > 0 for n in served), served
    assert [r["state"] for r in fleetz["replicas"]] == [
        routerd.BREAKER_OPEN, routerd.UP], fleetz
    assert stats["accepted"] == (stats["served"] + stats["errors"]
                                 + stats["shed"] + stats["deadline"])


# ----------------------------------------------------------------------
# task = route from bin/cxxnet_torch
def test_cli_route_builds_no_net_and_initializes_no_cuda(monkeypatch,
                                                         capsys):
    """task = route in process: the router answers through the port's
    stub replicas, /fleetz reads them, the drain prints its books, and
    no net, iterator or CUDA context was made."""
    import signal

    import torch

    from cxxnet_tpu_torch import learn_task as tlt

    _swap(monkeypatch)
    fleet = faultinject.spawn_fleet(2)
    made = []
    monkeypatch.setattr(tlt.LearnTask, "init",
                        lambda self: made.append("init"))
    monkeypatch.setattr(tlt.LearnTask, "_create_net",
                        lambda self: made.append("net"))
    try:
        conf = ["task=route", "status_port=0", "route_probe_ms=100",
                "route_replicas=" + ",".join(
                    "127.0.0.1:%d:%d" % (r.port, r.status_port)
                    for r in fleet)]
        task = tlt.LearnTask()
        box = {}
        default_term = signal.getsignal(signal.SIGTERM)

        def drive():
            # wait for the router and its drain guard, route 4 requests,
            # read /fleetz, then ask for the drain
            import time
            t_end = time.monotonic() + 60
            while statusd.active() is None or \
                    statusd.active().fleet is None or \
                    signal.getsignal(signal.SIGTERM) is default_term:
                if time.monotonic() > t_end:
                    return
                time.sleep(0.05)
            srv = statusd.active()
            router = srv.fleet
            box["answers"] = [faultinject.serve_request(
                router.port, "%d" % i, timeout=15) for i in range(4)]
            box["fleetz"] = json.loads(urlopen(
                "http://127.0.0.1:%d/fleetz?json=1" % srv.port,
                timeout=5).read())
            os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        assert task.run([os.devnull] + conf) == 0
        t.join(30)
    finally:
        faultinject.stop_fleet(fleet)
    assert box["answers"] == ["1", "2", "3", "4"], box
    assert [r["state"] for r in box["fleetz"]["replicas"]] == ["up", "up"]
    assert box["fleetz"]["stats"]["served"] == 4
    assert made == [] and task.net_trainer is None
    assert not torch.cuda.is_initialized()
    err = capsys.readouterr().err
    assert "routerd: routing on port" in err
    assert "routed 4 requests (4 served" in err


@pytest.mark.parametrize("key,val", [("watchdog_timeout", "5"),
                                     ("health_monitor", "1")])
def test_cli_route_accepts_the_health_keys(key, val):
    """task = route reads watchdog_timeout and health_monitor as the JAX
    command line does: with a watchdog the router's route.accept and
    route.probe channels are armed and fresh; health_monitor, a training
    key, changes nothing here. The replica of the conf is unreachable,
    which the router survives; SIGTERM drains it."""
    import signal
    import time

    from cxxnet_tpu_torch import learn_task as tlt
    from cxxnet_tpu_torch.utils import health

    task = tlt.LearnTask()
    box = {}
    default_term = signal.getsignal(signal.SIGTERM)

    def drive():
        t_end = time.monotonic() + 60
        while signal.getsignal(signal.SIGTERM) is default_term \
                and time.monotonic() < t_end:
            time.sleep(0.05)
        want = {"route.accept", "route.probe"} if key == "watchdog_timeout" \
            else set()
        while time.monotonic() < t_end:
            box["chans"] = {c[0]: c[3] for c in health.channel_status()}
            if want <= set(box["chans"]):
                break
            time.sleep(0.05)
        box["watchdog"] = health._active_watchdog
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    assert task.run([os.devnull, "task=route", "route_probe_ms=100",
                     "route_replicas=127.0.0.1:1:2",
                     "%s=%s" % (key, val)]) == 0
    t.join(30)
    assert getattr(task, key) == (5.0 if key == "watchdog_timeout" else 1)
    if key == "watchdog_timeout":
        assert {c: box["chans"][c] for c in ("route.accept",
                                             "route.probe")} == \
            {"route.accept": False, "route.probe": False}
        assert box["watchdog"].timeout == 5.0
    else:
        assert box["chans"] == {} and box["watchdog"] is None
    assert health._active_watchdog is None      # stopped with the router
