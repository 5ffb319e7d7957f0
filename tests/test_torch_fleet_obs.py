"""The fleet observability plane of the port on the CPU, against the JAX
package's: the scenarios of tests/test_fleet_obs.py (trace propagation
through the router, the stitched Chrome trace, the pre-TRACE and
pre-TENANT downgrade ladders, exact histogram federation, the fleet SLO
burn, outlier replicas, the per-tenant and decode-account federation, the
/fleetz columns, the /requestz contract and the fleet report), each run
against the port's ``routerd``, ``servd``, ``statusd`` and ``telemetry``.

A JAX scenario runs against the port by swapping the globals of the JAX
test module that name those modules, and its fault injector, for the
port's, for the length of the case; the fleet report runs the port's twin
of tools/telemetry_report.py (``python -m
cxxnet_tpu_torch.tools.telemetry_report``) where the case runs the JAX
tool. Left out: ``test_bench_compare_*`` (4), which test
tools/bench_compare.py alone, a shared tool that reads no package.
Everything runs with ``CXXNET_LOCKRANK=1``, and every socket has its own
timeout.
"""

import inspect
import subprocess
import sys

import pytest

from cxxnet_tpu_torch.utils import routerd, servd, statusd, telemetry

from . import test_fleet_obs as jtests
from .test_torch_routerd import faultinject

LEFT_OUT = (
    "test_bench_compare_tenant_subfield_directions",
    "test_bench_compare_failover_subfield_directions",
    "test_bench_compare_decode_subfield_directions",
    "test_bench_compare_multiturn_subfield_directions",
)
SCENARIOS = (
    "test_trace_prefix_adopted_and_validated",
    "test_admission_shed_leaves_flight_record_under_trace_id",
    "test_retry_under_one_id_and_stitched_trace",
    "test_pre_trace_replica_downgrade_and_latch",
    "test_genuine_parse_error_does_not_latch_new_replica",
    "test_trace_ok_latch_skips_downgrade_resend",
    "test_router_proto_err_and_client_id_adoption",
    "test_fleet_federation_exact_histogram_merge",
    "test_fleet_slo_burn_fires_when_no_single_replica_does",
    "test_outlier_replica_detected_and_flagged",
    "test_outlier_detected_in_two_replica_fleet",
    "test_federation_keeps_last_known_snapshot_on_missed_sweep",
    "test_pre_tenant_replica_downgrade_ladder",
    "test_tenant_downgrade_skipped_for_proven_replica",
    "test_per_tenant_federation_series_and_slo",
    "test_fleet_decode_account_federates_exactly",
    "test_fleetz_shows_per_bucket_batch_load",
    "test_fleet_federates_retained_pool_and_pressure",
    "test_fleetz_retained_column_and_garbage_guard",
    "test_batchz_and_metrics_render_retained_cache",
    "test_requestz_limit_json_and_single_record",
    "test_stitched_chrome_trace_pure_function",
    "test_fleet_report_joins_router_and_replica_shards",
)


@pytest.fixture(autouse=True)
def _lockrank_on(monkeypatch):
    monkeypatch.setenv("CXXNET_LOCKRANK", "1")


_run = subprocess.run


def _run_port_report(args, **kw):
    """``subprocess.run`` with the JAX report tool's command swapped for
    its twin in the port."""
    if list(args[1:2]) == ["tools/telemetry_report.py"]:
        args = [sys.executable, "-m", "cxxnet_tpu_torch.tools."
                "telemetry_report"] + list(args[2:])
    return _run(args, **kw)


@pytest.mark.parametrize("name", SCENARIOS)
def test_jax_fleet_obs_scenario_on_the_port(name, tmp_path, capsys,
                                            monkeypatch):
    for attr, mod in (("routerd", routerd), ("servd", servd),
                      ("statusd", statusd), ("telemetry", telemetry),
                      ("faultinject", faultinject)):
        monkeypatch.setattr(jtests, attr, mod)
    monkeypatch.setattr(subprocess, "run", _run_port_report)
    fn = getattr(jtests, name)
    given = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
             "capsys": capsys}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_every_scenario_is_run_or_left_out():
    names = {n for n, f in vars(jtests).items()
             if n.startswith("test_") and callable(f)}
    assert names == set(SCENARIOS) | set(LEFT_OUT), \
        names ^ (set(SCENARIOS) | set(LEFT_OUT))
    assert len(SCENARIOS) == 23
