"""Summarize the port's telemetry JSONL run logs (utils/telemetry.py): the
port's twin of tools/telemetry_report.py, on the port's utils/telemetry.py,
utils/autopsy.py and ``perf.MEASURED_SERIES``. It renders what the JAX
tool renders from the same log.

Usage:
    python -m cxxnet_tpu_torch.tools.telemetry_report run.jsonl [--top N]
        [--trace out.json] [--json] [--incidents]
    python -m cxxnet_tpu_torch.tools.telemetry_report --merge shard0.jsonl
        shard1.jsonl ... [--top N] [--json]
    python -m cxxnet_tpu_torch.tools.telemetry_report --fleet router.jsonl
        replica0.jsonl ... [--top N] [--json]

Prints top spans by total time, recompile count/causes/seconds, per-round
breakdowns, counters/gauges, fixed-bucket latency histograms (bucket table
+ p50/p90/p99), step-time percentiles, a training-health section
(anomalies/rollbacks/watchdog stalls/corrupt records, utils/health.py),
a serving section (shed rate, deadline-miss rate, circuit-breaker
transitions, per-request p50/p99 from the ``serve.request`` histogram,
utils/servd.py), a program-ledger section (the ``program_card`` events
utils/perf.py emits — per-compiled-program FLOPs / peak bytes /
compile time / roofline-predicted vs measured time, top programs by
compile cost and by roofline gap), and a request-breakdown section
(phase-attributed
p50/p99 over the ``serve_request_done`` events — queue_wait / dispatch /
prefill / decode / TTFT — plus the top-5 slowest requests with their
phase split and the requests that paid recompiles), and a
batch-scheduler section (per-bucket occupancy/waste reconstructed from
the transition-only ``batch_iteration`` events, admission-latency
percentiles, the ``serve.queue_age`` distribution, and the
``decode_convoy`` episode account — a log that ends with the convoy
latched is flagged unresolved).
An autopsy-breakdown section summarizes the slowdown verdicts the
serving processes stamp on ``serve_request_done`` /
``route_request_done`` events (utils/autopsy.py): per-cause attributed
seconds (p50/p99 across requests), the primary-verdict histogram, and
the top-5 primary verdicts; a conservation-laws section reports the
``books_broken`` transitions of the metrics auditor
(telemetry.BooksAuditor). ``--incidents`` additionally renders the
fleet incident timeline — every transition-only event stream (convoy,
KV pressure, SLO burn, outliers, breaker, scale/reload/drain, broken
books) merged into one wall-clock-ordered list, the offline twin of the
live ``/eventz`` endpoint.
``--trace`` additionally exports a chrome://tracing / Perfetto JSON built
from the span tree. ``--json`` emits the aggregate as one JSON object
instead of the table (for scripting).

``--merge`` reads one shard per process of a multihost run (the
``telemetry_log = run.%d.jsonl`` rank-placeholder layout): each shard's
timestamps are re-aligned onto the shared wall-clock epoch (the earliest
shard's ``t0_wall``), events keep their ``p`` process tag, histograms
merge EXACTLY (shared fixed buckets: bucket-count addition), counters sum
across processes, and the report adds a per-process breakdown — one
coherent cross-host view instead of N clobbering logs.

``--fleet`` merges a serving FLEET's logs — the router's
(``task = route``) plus its replicas' (``task = serve``) — which are
separate single-process runs that may all claim process index 0, so the
shards are relabeled by argument position (shard i -> process i) before
the same wall-clock re-basing. The report then JOINS the router's
``route_request_done`` events against the replicas'
``serve_request_done`` events on the shared trace id (the ``TRACE``
propagation of utils/routerd.py) and prints a per-hop breakdown: each
routed request's attempts/retries next to the phase split of every
replica that touched it, the router-overhead percentiles (router total
minus the slowest hop), and any ``fleet_outlier`` transitions.

Exit codes: 0 ok; 1 usage / unreadable file; 2 malformed log (a line
that is not valid JSON, or no telemetry events at all) OR a log with
``health_anomaly`` events that no resolution event (``health_rollback``
/ ``health_skip`` / ``health_abort`` referencing the anomaly id, or an
inline ``resolution`` field) ever answered, OR a log whose LAST
``serve_breaker`` event (per process) left the circuit breaker open,
OR a log whose LAST ``slo_burn`` event (per process) left the SLO
error budget burning (state 1), OR a log whose LAST ``books_broken``
event (per process and law) left a conservation law latched broken —
CI gates on this so neither a broken emitter, an unrecovered training
anomaly, a serving run that ended with its backend shedding, one that
ended blowing its SLOs, nor one whose metrics books stopped reconciling
can silently pass.
"""

import json
import os
import sys

from ..utils import autopsy
from ..utils.perf import MEASURED_SERIES
from ..utils.telemetry import (HIST_BUCKETS, Histogram, count_by,
                               events_to_chrome, fmt_ms, percentile)


def load_events(path):
    """Parse one-event-per-line JSONL; malformed lines are fatal (exit 2:
    the log writer is append-only, so a bad line means a broken emitter
    or a truncated copy — summarizing around it would lie)."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                print("%s:%d: malformed JSONL line: %s"
                      % (path, lineno, e), file=sys.stderr)
                sys.exit(2)
            if not isinstance(ev, dict):
                print("%s:%d: event is not a JSON object" % (path, lineno),
                      file=sys.stderr)
                sys.exit(2)
            events.append(ev)
    if not events:
        print("%s: no telemetry events" % path, file=sys.stderr)
        sys.exit(2)
    return events


def shard_identity(events, default_p):
    """(t0_wall, process_index) of one shard: the meta event carries the
    wall-clock epoch; the process tag rides on every event ("p").
    t0_wall is None when no meta event exists (truncated copy)."""
    t0 = None
    p = None
    for ev in events:
        if t0 is None and ev.get("ev") == "meta":
            t0 = float(ev.get("t0_wall", 0.0))
        if p is None and "p" in ev:
            p = int(ev["p"])
        if t0 is not None and p is not None:
            break
    return t0, (p if p is not None else default_p)


def merge_shards(shard_events):
    """Merge per-process shards into ONE event stream on a shared clock.

    Each shard's ``ts`` values are seconds since ITS OWN start; shards of
    one run started at (slightly) different wall times. Re-base every
    shard onto the earliest ``t0_wall`` so "the same moment" has the same
    ts across processes, tag untagged events with the shard's process
    index, and sort. Duplicate process indices (merging the same shard
    twice) are rejected — the aggregate would double-count."""
    metas = []
    for i, events in enumerate(shard_events):
        t0, p = shard_identity(events, i)
        if t0 is None:
            # no meta event = no epoch: re-basing the OTHER shards
            # against a 0.0 epoch would shift them by ~50 years —
            # refuse rather than emit a silently garbage timeline
            print("--merge: shard %d has no 'meta' event (truncated "
                  "copy?); cannot align it on the shared wall-clock "
                  "epoch" % i, file=sys.stderr)
            sys.exit(2)
        metas.append((t0, p, events))
    seen = {}
    for i, (_, p, _) in enumerate(metas):
        if p in seen:
            print("--merge: shards %d and %d both claim process index %d "
                  "— merging the same shard twice?" % (seen[p], i, p),
                  file=sys.stderr)
            sys.exit(1)
        seen[p] = i
    epoch = min(t0 for t0, _, _ in metas)
    merged = []
    for t0, p, events in metas:
        off = t0 - epoch
        for ev in events:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + off, 6)
            ev.setdefault("p", p)
            merged.append(ev)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return merged


def merge_fleet_shards(shard_events):
    """--fleet: the router log + N replica logs are DIFFERENT processes
    that may each carry process index 0 (every one is its own
    single-process run), so --merge's duplicate-index guard would
    reject them. Relabel shard i as process i — argument order is the
    identity (put the router first by convention) — then re-base on
    the shared wall-clock epoch exactly like --merge."""
    relabeled = []
    for i, events in enumerate(shard_events):
        relabeled.append([dict(ev, p=i) for ev in events])
    return merge_shards(relabeled)


def aggregate(events):
    spans = {}
    compiles = []
    program_compiles = []
    counters_by_p = {}
    hists_by_p = {}
    gauges = {}
    gauges_by_p = {}
    rounds = []
    procs = set()
    by_proc = {}
    health = {"anomalies": [], "resolutions": [], "stalls": [],
              "data_corrupt": 0, "skipped_batches": 0}
    breaker_events = []
    requests = []
    route_requests = []
    outlier_events = []
    slo_events = []
    program_cards = {}
    batch_events = []
    convoy_events = []
    books_events = []

    def proc(ev):
        p = int(ev.get("p", 0))
        procs.add(p)
        return p

    for ev in events:
        kind = ev.get("ev")
        if kind == "span":
            a = spans.setdefault(ev["name"], [])
            a.append(float(ev.get("dur", 0.0)))
            pb = by_proc.setdefault(proc(ev), {"spans": {}, "images": 0,
                                               "rounds": 0})
            sp = pb["spans"].setdefault(ev["name"], [0, 0.0])
            sp[0] += 1
            sp[1] += float(ev.get("dur", 0.0))
        elif kind == "compile":
            compiles.append(ev)
            proc(ev)
        elif kind == "program_compile":
            # the perf ledger's compile flight record (one per program
            # the warm grid learns about): carries the readiness climb
            program_compiles.append(ev)
            proc(ev)
        elif kind == "gauge":
            gauges[ev["name"]] = ev.get("value")
            gauges_by_p.setdefault(proc(ev), {})[ev["name"]] = \
                ev.get("value")
        elif kind == "round":
            rounds.append(ev)
            pb = by_proc.setdefault(proc(ev), {"spans": {}, "images": 0,
                                               "rounds": 0})
            pb["images"] += int(ev.get("images", 0))
            pb["rounds"] += 1
        elif kind == "counters":
            # periodic snapshot (per-round flush): monotonic, last wins
            # PER PROCESS — a crashed shard keeps its counters to the
            # last flush; cross-process totals are summed below
            counters_by_p[proc(ev)] = ev.get("counters", {})
        elif kind == "hists":
            # cumulative like counters: last snapshot per process wins
            hists_by_p[proc(ev)] = ev.get("hists", {})
        elif kind == "summary":
            p = proc(ev)
            s = ev.get("summary", {})
            counters_by_p[p] = s.get("counters", counters_by_p.get(p, {}))
        elif kind == "health_anomaly":
            health["anomalies"].append(ev)
        elif kind in ("health_rollback", "health_skip", "health_abort",
                      "health_anomaly_at_preempt"):
            health["resolutions"].append(ev)
        elif kind == "watchdog_stall":
            health["stalls"].append(ev)
        elif kind == "data_corrupt":
            health["data_corrupt"] += 1
        elif kind == "health_skip_batch":
            health["skipped_batches"] += 1
        elif kind == "serve_breaker":
            breaker_events.append(ev)
            proc(ev)
        elif kind == "serve_request_done":
            requests.append(ev)
            proc(ev)
        elif kind == "route_request_done":
            route_requests.append(ev)
            proc(ev)
        elif kind == "fleet_outlier":
            outlier_events.append(ev)
            proc(ev)
        elif kind == "slo_burn":
            slo_events.append(ev)
            proc(ev)
        elif kind == "batch_iteration":
            batch_events.append(ev)
            proc(ev)
        elif kind == "decode_convoy":
            convoy_events.append(ev)
            proc(ev)
        elif kind == "books_broken":
            books_events.append(ev)
            proc(ev)
        elif kind == "program_card":
            # the performance ledger's per-compiled-program card
            # (utils/perf.py): last event per (process, name, shapes
            # signature) wins — re-completions carry cumulative
            # compile counts
            program_cards[(proc(ev), ev.get("name"),
                           ev.get("sig"))] = ev
    # an anomaly is resolved by an inline resolution field (warn-only
    # metric events) or by any recovery event referencing its id —
    # matched PER PROCESS: anomaly ids are per-process counters, so in a
    # merged multihost report shard A's rollback of id=1 must not
    # resolve shard B's unrelated (and possibly unrecovered) id=1
    resolved = {(int(r.get("p", 0)), r.get("anomaly"))
                for r in health["resolutions"]}
    health["unresolved"] = [
        a for a in health["anomalies"]
        if a.get("resolution") is None
        and (int(a.get("p", 0)), a.get("id")) not in resolved]
    counters = {}
    for snap in counters_by_p.values():
        for name, v in snap.items():
            counters[name] = counters.get(name, 0) + v
    # exact cross-shard histogram merge: every histogram shares the fixed
    # log-spaced HIST_BUCKETS, so merging is bucket-count addition
    merged_hists = {}
    for p, snap in hists_by_p.items():
        for name, d in snap.items():
            try:
                merged_hists.setdefault(name, Histogram()).merge_dict(d)
            except (ValueError, TypeError) as e:
                print("process %d histogram %r: %s" % (p, name, e),
                      file=sys.stderr)
                sys.exit(2)
    # serving summary: rates off the (summed) counters, breaker
    # transition counts, and the FINAL breaker state per process — a log
    # that ends breaker-open is an unresolved serving outage (exit 2)
    serving = None
    if breaker_events or any(k.startswith("serve.") for k in counters):
        acc = counters.get("serve.accepted", 0)
        serving = {
            "accepted": acc,
            "served": counters.get("serve.requests", 0),
            "errors": counters.get("serve.errors", 0),
            "shed": counters.get("serve.shed", 0),
            "deadline": counters.get("serve.deadline", 0),
            "shed_rate": round(counters.get("serve.shed", 0)
                               / float(acc), 4) if acc else 0.0,
            "deadline_miss_rate": round(counters.get("serve.deadline", 0)
                                        / float(acc), 4) if acc else 0.0,
            "reloads": counters.get("serve.reloads", 0),
            "breaker_transitions": count_by(breaker_events, "state"),
            "breaker_final": {},
        }
        for ev in breaker_events:       # events arrive time-sorted
            serving["breaker_final"][str(int(ev.get("p", 0)))] = \
                ev.get("state")
        serving["breaker_open_unresolved"] = sorted(
            p for p, st in serving["breaker_final"].items()
            if st == "open")
    # request breakdown: phase-attributed percentiles over the
    # serve_request_done events, the slowest requests with their phase
    # split, and recompile attribution (from the events' recompile count
    # plus any compile events tagged with a request id)
    req_agg = None
    if requests:
        phases = {}
        for ph in ("queue_wait", "dispatch", "prefill", "decode",
                   "ttft", "total"):
            vals = sorted(float(r[ph + "_s"]) for r in requests
                          if r.get(ph + "_s") is not None)
            if vals:
                phases[ph] = {
                    "count": len(vals),
                    "p50_ms": round(1e3 * percentile(vals, 50), 4),
                    "p99_ms": round(1e3 * percentile(vals, 99), 4),
                    "max_ms": round(1e3 * vals[-1], 4)}
        slowest = sorted(requests,
                         key=lambda r: -float(r.get("total_s", 0.0)))[:5]
        recomp = {}
        for r in requests:
            if r.get("recompiles"):
                recomp[str(r.get("req"))] = int(r["recompiles"])
        for c in compiles:
            if "req" in c:
                recomp.setdefault(str(c["req"]), 0)
                recomp[str(c["req"])] = max(recomp[str(c["req"])], 1)
        req_agg = {
            "count": len(requests),
            "outcomes": count_by(requests, "outcome"),
            "phases": phases,
            "slowest": [{
                "req": r.get("req"), "outcome": r.get("outcome"),
                "total_s": r.get("total_s"),
                "tokens": r.get("tokens", 0),
                "phases": {ph: r.get(ph + "_s")
                           for ph in ("queue_wait", "dispatch",
                                      "prefill", "decode")}}
                for r in slowest],
            "recompile_requests": dict(sorted(recomp.items())),
        }
    # fleet view: the router's route_request_done events joined against
    # the replicas' serve_request_done events on the shared trace id —
    # one id names a request on every process that touched it (--fleet)
    fleet = None
    if route_requests:
        by_req = {}
        for r in requests:
            by_req.setdefault(str(r.get("req")), []).append(r)
        joined = []
        overheads = []
        for ev in route_requests:
            rid = str(ev.get("req"))
            hops = [{"p": int(h.get("p", 0)),
                     "outcome": h.get("outcome"),
                     "total_s": h.get("total_s"),
                     "ttft_s": h.get("ttft_s"),
                     "queue_wait_s": h.get("queue_wait_s"),
                     "prefill_s": h.get("prefill_s"),
                     "decode_s": h.get("decode_s")}
                    for h in by_req.get(rid, [])]
            row = {"req": rid, "outcome": ev.get("outcome"),
                   "total_s": ev.get("total_s"),
                   "attempts": int(ev.get("attempts", 0)),
                   "retries": int(ev.get("retries", 0)),
                   "replicas": ev.get("replicas") or [],
                   "hops": hops}
            if ev.get("total_s") is not None and hops:
                hop_tot = max(float(h.get("total_s") or 0.0)
                              for h in hops)
                # router total minus the slowest hop's total = queueing
                # + connect + rewrite + relay overhead the router added
                overheads.append(max(0.0, float(ev["total_s"])
                                     - hop_tot))
            joined.append(row)
        overheads.sort()
        fleet = {
            "requests": len(route_requests),
            "outcomes": count_by(route_requests, "outcome"),
            "retried": sum(1 for ev in route_requests
                           if int(ev.get("retries", 0)) > 0),
            "matched": sum(1 for j in joined if j["hops"]),
            "unmatched": sum(1 for j in joined if not j["hops"]),
            "router_overhead_p50_ms":
                round(1e3 * percentile(overheads, 50), 4)
                if overheads else None,
            "router_overhead_p99_ms":
                round(1e3 * percentile(overheads, 99), 4)
                if overheads else None,
            "slowest": sorted(joined,
                              key=lambda j: -float(j.get("total_s")
                                                   or 0.0))[:5],
            "outlier_transitions": [
                {"replica": ev.get("replica"),
                 "outlier": int(ev.get("outlier", 0)),
                 "p99_ms": ev.get("p99_ms"),
                 "fleet_p99_ms": ev.get("fleet_p99_ms")}
                for ev in outlier_events],
        }
    # SLO burn account: transition events only — the LAST state per
    # process is the gate (a log that ends burning exits 2)
    slo = None
    if slo_events:
        final = {}
        for ev in slo_events:           # events arrive time-sorted
            final[str(int(ev.get("p", 0)))] = ev
        slo = {"transitions": len(slo_events),
               "final": {p: {"state": int(ev.get("state", 0)),
                             "burn_rate": ev.get("burn_rate")}
                         for p, ev in final.items()},
               "burning": sorted(p for p, ev in final.items()
                                 if int(ev.get("state", 0)))}
    # autopsy breakdown: the slowdown verdicts the serving processes
    # stamp on their done events (utils/autopsy.py) — per-cause
    # attributed seconds and the primary-verdict histogram
    auts = [ev["autopsy"] for ev in requests + route_requests
            if isinstance(ev.get("autopsy"), dict)]
    autopsy_agg = None
    if auts:
        cause_vals = {}
        for a in auts:
            for c, s in (a.get("causes") or {}).items():
                cause_vals.setdefault(c, []).append(float(s))
        cause_stats = {}
        for c, vals in sorted(cause_vals.items()):
            vals.sort()
            cause_stats[c] = {
                "requests": sum(1 for v in vals if v > 0),
                "total_s": round(sum(vals), 6),
                "p50_ms": round(1e3 * percentile(vals, 50), 4),
                "p99_ms": round(1e3 * percentile(vals, 99), 4)}
        prim = count_by(auts, "primary")
        autopsy_agg = {
            "count": len(auts),
            "causes": cause_stats,
            "primary": prim,
            "top_primary": sorted(prim.items(),
                                  key=lambda kv: (-kv[1], kv[0]))[:5]}
    # conservation laws: books_broken transitions (telemetry
    # BooksAuditor) — the LAST state per (process, law) is the gate; a
    # log that ends with any law latched broken exits 2, because every
    # other number in this report is then suspect
    books = None
    if books_events:
        final_bk = {}
        for ev in books_events:         # events arrive time-sorted
            final_bk[(int(ev.get("p", 0)), str(ev.get("law")))] = ev
        books = {
            "transitions": len(books_events),
            "final": {"p%d:%s" % k: int(ev.get("broken", 0))
                      for k, ev in sorted(final_bk.items())},
            "details": {"p%d:%s" % k: ev.get("detail")
                        for k, ev in sorted(final_bk.items())
                        if ev.get("detail")},
            "latched": sorted("p%d:%s" % k
                              for k, ev in final_bk.items()
                              if int(ev.get("broken", 0)))}
    # batch scheduler: per-bucket occupancy/waste from the
    # batch_iteration events (transition-only — one event per
    # composition CHANGE). Reconstruction is exact: the event at
    # iteration N stepped at ``occupancy`` and left ``occupancy_after``
    # aboard (its own turn's retirements excluded), and NOTHING changes
    # until the next event — so N itself weighs ``occupancy`` and
    # N+1..next-event-1 weigh ``occupancy_after``. Non-stepped flush
    # events (a turn whose admissions all finished at prefill) carry
    # admissions/retirements but no decode pass, so they stay out of
    # the occupancy weighting. Plus admission-latency percentiles from
    # the requests' queue_wait, the queue-age distribution, and the
    # decode_convoy episode account (a log that ENDS with the convoy
    # latched is reported as unresolved, the breaker-open discipline)
    batch = None
    if batch_events or convoy_events:
        by_bucket = {}
        by_pe = {}
        for ev in batch_events:
            by_pe.setdefault(int(ev.get("p", 0)), []).append(ev)

        def bucket_of(ev):
            return by_bucket.setdefault(int(ev.get("bucket") or 0), {
                "iterations": 0, "slot_iterations": 0,
                "admitted": 0, "retired": 0, "errors": 0})

        for p, evs in by_pe.items():
            evs.sort(key=lambda e: int(e.get("iter", 0)))
            for ev in evs:
                d = bucket_of(ev)
                d["admitted"] += len(ev.get("admitted") or [])
                d["retired"] += len(ev.get("retired") or [])
                if ev.get("error"):
                    d["errors"] += 1
            stepped = [e for e in evs if e.get("stepped", 1)]
            for k, ev in enumerate(stepped):
                gap = 1
                if k + 1 < len(stepped) \
                        and stepped[k + 1].get("bucket") \
                        == ev.get("bucket"):
                    gap = max(1, int(stepped[k + 1].get("iter", 0))
                              - int(ev.get("iter", 0)))
                d = bucket_of(ev)
                occ = int(ev.get("occupancy", 0))
                after = ev.get("occupancy_after")
                after = occ if after is None else int(after)
                d["iterations"] += gap
                d["slot_iterations"] += occ + after * (gap - 1)
        for b, d in by_bucket.items():
            occ = (d["slot_iterations"] / float(d["iterations"])
                   if d["iterations"] else None)
            d["mean_occupancy"] = round(occ, 3) if occ is not None \
                else None
            d["waste_pct"] = round(100.0 * (1.0 - occ / b), 2) \
                if occ is not None and b else None
        qwaits = sorted(float(r["queue_wait_s"]) for r in requests
                        if r.get("queue_wait_s") is not None)
        convoy_final = {}
        for ev in convoy_events:        # events arrive time-sorted
            convoy_final[str(int(ev.get("p", 0)))] = \
                int(ev.get("convoy", 0))
        batch = {
            "events": len(batch_events),
            "buckets": {str(b): d for b, d
                        in sorted(by_bucket.items())},
            "admission_p50_ms":
                round(1e3 * percentile(qwaits, 50), 4)
                if qwaits else None,
            "admission_p99_ms":
                round(1e3 * percentile(qwaits, 99), 4)
                if qwaits else None,
            "convoy_episodes": sum(1 for ev in convoy_events
                                   if int(ev.get("convoy", 0))),
            "convoys": [
                {"p": int(ev.get("p", 0)),
                 "pinned": ev.get("pinned"),
                 "bucket": ev.get("bucket"),
                 "age_iters": ev.get("age_iters"),
                 "queue_depth": ev.get("queue_depth")}
                for ev in convoy_events
                if int(ev.get("convoy", 0))],
            "convoy_unresolved": sorted(
                p for p, st in convoy_final.items() if st),
        }
    # program ledger: one row per carded program (utils/perf.py),
    # joined against the measured latency histograms like the live
    # /programz table — MFU% and roofline efficiency from the log alone
    programs = None
    if program_cards:
        rows = []
        for (p, name, sig), ev in sorted(
                program_cards.items(), key=lambda kv: str(kv[0])):
            series = MEASURED_SERIES.get(name)
            h = merged_hists.get(series) if series else None
            st = h.stats() if h is not None and h.n else None
            row = {"p": p, "name": name, "shapes": ev.get("shapes"),
                   "spec": ev.get("spec"), "cause": ev.get("cause"),
                   "compiles": int(ev.get("compiles") or 0),
                   "compile_s": float(ev.get("compile_s") or 0.0),
                   "flops": ev.get("flops"),
                   "peak_bytes": ev.get("peak_bytes"),
                   "predicted_s": ev.get("predicted_s"),
                   "status": ev.get("status"), "error": ev.get("error"),
                   "measured_p50_ms": st["p50_ms"] if st else None,
                   "measured_p99_ms": st["p99_ms"] if st else None,
                   "mfu_pct": None, "roofline_eff_pct": None}
            if st and st["p50_ms"]:
                p50_s = st["p50_ms"] / 1e3
                peak = ev.get("spec_peak_flops")
                if row["flops"] is not None and peak:
                    row["mfu_pct"] = round(
                        100.0 * row["flops"] / (p50_s * peak), 2)
                if row["predicted_s"] is not None:
                    row["roofline_eff_pct"] = round(
                        100.0 * row["predicted_s"] / p50_s, 2)
            rows.append(row)
        gapped = [r for r in rows
                  if r["roofline_eff_pct"] is not None]
        programs = {
            "count": len(rows),
            "cards": rows,
            "compile_s": round(sum(r["compile_s"] for r in rows), 6),
            "hbm_peak_bytes": max(
                (r["peak_bytes"] for r in rows
                 if r["peak_bytes"] is not None), default=None),
            "top_by_compile": [r["name"] for r in sorted(
                rows, key=lambda r: -r["compile_s"])[:5]],
            # the roofline GAP ranking: lowest efficiency = furthest
            # from what the hardware allows
            "top_by_gap": [r["name"] for r in sorted(
                gapped, key=lambda r: r["roofline_eff_pct"])[:5]],
        }
    out = {"spans": {}, "compiles": {}, "counters": counters,
           "gauges": gauges, "rounds": rounds, "health": health,
           "serving": serving, "requests": req_agg, "fleet": fleet,
           "slo": slo, "programs": programs, "batch": batch,
           "autopsy": autopsy_agg, "books": books,
           "hists": {}}
    for name, h in sorted(merged_hists.items()):
        st = h.stats()
        st["buckets"] = h.to_dict()["buckets"]
        out["hists"][name] = st
    for name, durs in spans.items():
        durs.sort()
        out["spans"][name] = {
            "count": len(durs),
            "total_s": round(sum(durs), 6),
            "p50_ms": round(1e3 * percentile(durs, 50), 4),
            "p90_ms": round(1e3 * percentile(durs, 90), 4),
            "p99_ms": round(1e3 * percentile(durs, 99), 4),
            "max_ms": round(1e3 * (durs[-1] if durs else 0.0), 4),
        }
    out["compiles"] = {
        "count": len(compiles),
        "total_s": round(sum(float(c.get("dur", 0.0)) for c in compiles), 6),
        "by_cause": count_by(compiles, "cause"),
    }
    if program_compiles:
        # the compile-cliff section (doc/performance.md "Compile
        # cliff"): the warm-grid readiness climb across the run plus
        # the requests that paid a cliff in-band — events arrive in
        # emission order, so first/last bracket the climb
        pc = program_compiles
        out["compile_cliff"] = {
            "count": len(pc),
            "total_s": round(sum(float(c.get("seconds") or 0.0)
                                 for c in pc), 6),
            "ready_pct_first": pc[0].get("ready_pct"),
            "ready_pct_last": pc[-1].get("ready_pct"),
            "by_name": count_by(pc, "name"),
            "stalled_requests": sorted(
                {str(c["req"]) for c in pc if c.get("req")}),
        }
    if len(procs) > 1:
        out["processes"] = {}
        for p in sorted(procs):
            pb = by_proc.get(p, {"spans": {}, "images": 0, "rounds": 0})
            out["processes"][str(p)] = {
                "images": pb["images"],
                "rounds": pb["rounds"],
                "spans": {name: {"count": n, "total_s": round(t, 6)}
                          for name, (n, t) in sorted(pb["spans"].items())},
                "counters": counters_by_p.get(p, {}),
                # per-process gauge values: the merged top-level dict is
                # last-event-wins across shards, which would hide e.g.
                # the one near-OOM host's device.bytes_in_use
                "gauges": gauges_by_p.get(p, {}),
            }
    return out


# empty-histogram stats carry None percentiles (a series that never
# fired); the shared renderer turns them into "n/a", never garbage zeros
_fmt_ms = fmt_ms


def _bucket_rows(buckets):
    """(le, cumulative_count) rows of a sparse bucket dict — CUMULATIVE,
    matching Prometheus ``le`` semantics (and /metrics output): the row
    for bound B counts every sample <= B. One row per occupied bound."""
    rows = []
    cum = 0
    for i, c in sorted(((int(i), c) for i, c in buckets.items())):
        cum += c
        le = "+Inf" if i >= len(HIST_BUCKETS) else "%g" % HIST_BUCKETS[i]
        rows.append((le, cum))
    return rows


def print_report(agg, top=15):
    spans = agg["spans"]
    print("== top spans by total time ==")
    print("%-20s %8s %10s %9s %9s %9s %9s" %
          ("span", "count", "total_s", "p50_ms", "p90_ms", "p99_ms",
           "max_ms"))
    for name, a in sorted(spans.items(),
                          key=lambda kv: -kv[1]["total_s"])[:top]:
        print("%-20s %8d %10.3f %9.2f %9.2f %9.2f %9.2f" %
              (name, a["count"], a["total_s"], a["p50_ms"], a["p90_ms"],
               a["p99_ms"], a["max_ms"]))
    comp = agg["compiles"]
    print("\n== recompiles ==")
    print("count: %d   total: %.2fs" % (comp["count"], comp["total_s"]))
    for cause, n in sorted(comp["by_cause"].items()):
        print("  %-24s %d" % (cause, n))
    cliff = agg.get("compile_cliff")
    if cliff:
        print("\n== compile cliff (warm-grid readiness climb) ==")
        print("programs: %d   total: %.2fs   ready: %s%% -> %s%%"
              % (cliff["count"], cliff["total_s"],
                 "?" if cliff["ready_pct_first"] is None
                 else cliff["ready_pct_first"],
                 "?" if cliff["ready_pct_last"] is None
                 else cliff["ready_pct_last"]))
        for name, n in sorted(cliff["by_name"].items()):
            print("  %-24s %d" % (name, n))
        if cliff["stalled_requests"]:
            print("  stalled requests: %s"
                  % ", ".join(cliff["stalled_requests"][:16]))
    step = spans.get("train.step")
    if step:
        print("\n== step-time percentiles (train.step dispatch) ==")
        print("n=%d  p50=%.2fms  p90=%.2fms  p99=%.2fms  max=%.2fms" %
              (step["count"], step["p50_ms"], step["p90_ms"],
               step["p99_ms"], step["max_ms"]))
    if agg.get("hists"):
        print("\n== latency histograms (fixed log-spaced buckets, "
              "merge-exact) ==")
        for name, h in sorted(agg["hists"].items(),
                              key=lambda kv: -kv[1]["sum_s"]):
            print("%-24s n=%-8d sum=%.3fs  p50=%s  p90=%s  p99=%s"
                  % (name, h["count"], h["sum_s"], _fmt_ms(h["p50_ms"]),
                     _fmt_ms(h["p90_ms"]), _fmt_ms(h["p99_ms"])))
            for le, c in _bucket_rows(h.get("buckets", {})):
                print("    le=%-12s %d" % (le, c))
    if agg["rounds"]:
        print("\n== rounds ==")
        multi = "processes" in agg
        pre_hdr = "%6s " % "proc" if multi else ""
        print(pre_hdr + "%6s %9s %12s %9s %9s %9s" %
              ("round", "images", "input_wait_s", "step_s", "eval_s",
               "ckpt_s"))
        for r in agg["rounds"]:
            pre = "%6d " % r.get("p", 0) if multi else ""
            print(pre + "%6d %9d %12.3f %9.3f %9.3f %9.3f" %
                  (r.get("round", -1), r.get("images", 0),
                   r.get("input_wait_s", 0.0), r.get("step_s", 0.0),
                   r.get("eval_s", 0.0), r.get("checkpoint_s", 0.0)))
    if agg["counters"]:
        print("\n== counters%s ==" %
              (" (summed across processes)" if "processes" in agg else ""))
        for name, v in sorted(agg["counters"].items()):
            print("  %-28s %s" % (name, v))
    if agg["gauges"]:
        print("\n== gauges (last value) ==")
        for name, v in sorted(agg["gauges"].items()):
            print("  %-28s %s" % (name, v))
    if "processes" in agg:
        print("\n== per-process breakdown ==")
        for p, pb in sorted(agg["processes"].items(), key=lambda kv:
                            int(kv[0])):
            print("process %s: %d rounds, %d images" %
                  (p, pb["rounds"], pb["images"]))
            ranked = sorted(pb["spans"].items(),
                            key=lambda kv: -kv[1]["total_s"])[:5]
            for name, a in ranked:
                print("    %-20s %8d calls %10.3fs" %
                      (name, a["count"], a["total_s"]))
            for name, v in sorted(pb.get("counters", {}).items()):
                print("    counter %-20s %s" % (name, v))
            for name, v in sorted(pb.get("gauges", {}).items()):
                print("    gauge   %-20s %s" % (name, v))
    sv = agg.get("serving")
    if sv:
        print("\n== serving ==")
        print("accepted: %d  served: %d  errors: %d  shed: %d "
              "(rate %.2f%%)  deadline-missed: %d (rate %.2f%%)"
              % (sv["accepted"], sv["served"], sv["errors"], sv["shed"],
                 100 * sv["shed_rate"], sv["deadline"],
                 100 * sv["deadline_miss_rate"]))
        req = agg.get("hists", {}).get("serve.request")
        if req:
            print("request latency: n=%d  p50=%s  p90=%s  p99=%s"
                  % (req["count"], _fmt_ms(req["p50_ms"]),
                     _fmt_ms(req["p90_ms"]), _fmt_ms(req["p99_ms"])))
        if sv["reloads"]:
            print("model reloads: %d" % sv["reloads"])
        if sv["breaker_transitions"]:
            print("breaker transitions: %s" %
                  " ".join("%s=%d" % kv for kv in
                           sorted(sv["breaker_transitions"].items())))
            for p, st in sorted(sv["breaker_final"].items()):
                print("  process %s final breaker state: %s%s"
                      % (p, st, "  UNRESOLVED" if st == "open" else ""))
    rq = agg.get("requests")
    if rq:
        print("\n== request breakdown (phase-attributed) ==")
        print("requests: %d  %s"
              % (rq["count"],
                 " ".join("%s=%d" % kv
                          for kv in sorted(rq["outcomes"].items()))))
        print("%-12s %8s %10s %10s %10s" %
              ("phase", "count", "p50_ms", "p99_ms", "max_ms"))
        for ph in ("queue_wait", "dispatch", "prefill", "decode",
                   "ttft", "total"):
            a = rq["phases"].get(ph)
            if a:
                print("%-12s %8d %10.2f %10.2f %10.2f" %
                      (ph, a["count"], a["p50_ms"], a["p99_ms"],
                       a["max_ms"]))
        print("top-5 slowest requests:")
        for r in rq["slowest"]:
            ph = r["phases"]
            print("  req=%-8s %-14s total=%8.2fms  queue=%.2f "
                  "dispatch=%.2f prefill=%.2f decode=%.2f  tokens=%d"
                  % (r["req"], r["outcome"],
                     1e3 * float(r.get("total_s") or 0.0),
                     *(1e3 * float(ph.get(k) or 0.0)
                       for k in ("queue_wait", "dispatch", "prefill",
                                 "decode")), r.get("tokens", 0)))
        if rq["recompile_requests"]:
            print("recompile-attributed requests: %s"
                  % " ".join("req=%s(%d)" % kv for kv in
                             rq["recompile_requests"].items()))
    au = agg.get("autopsy")
    if au:
        print("\n== autopsy breakdown (slowdown verdicts) ==")
        print("requests with verdicts: %d" % au["count"])
        print("%-16s %9s %10s %10s %10s" %
              ("cause", "requests", "total_s", "p50_ms", "p99_ms"))
        for c in autopsy.CAUSES:
            st = au["causes"].get(c)
            if st:
                print("%-16s %9d %10.3f %10.2f %10.2f" %
                      (c, st["requests"], st["total_s"],
                       st["p50_ms"], st["p99_ms"]))
        print("top primary verdicts: %s"
              % "  ".join("%s(%d)" % (c, n)
                          for c, n in au["top_primary"]))
    bt = agg.get("batch")
    if bt:
        print("\n== batch scheduler (iteration-level decode "
              "datapath) ==")
        if bt["buckets"]:
            print("%-8s %12s %10s %9s %9s %7s" %
                  ("bucket", "iterations", "mean_occ", "waste%",
                   "admitted", "errors"))
            for b, d in sorted(bt["buckets"].items(),
                               key=lambda kv: int(kv[0])):
                print("%-8s %12d %10s %9s %9d %7d" %
                      (b, d["iterations"],
                       "n/a" if d["mean_occupancy"] is None
                       else "%.2f" % d["mean_occupancy"],
                       "n/a" if d["waste_pct"] is None
                       else "%.1f" % d["waste_pct"],
                       d["admitted"], d["errors"]))
        if bt["admission_p99_ms"] is not None:
            print("admission latency (queue_wait): p50=%s  p99=%s"
                  % (_fmt_ms(bt["admission_p50_ms"]),
                     _fmt_ms(bt["admission_p99_ms"])))
        qa = agg.get("hists", {}).get("serve.queue_age")
        if qa and qa.get("count"):
            print("queue age at iteration: n=%d  p50=%s  p99=%s"
                  % (qa["count"], _fmt_ms(qa["p50_ms"]),
                     _fmt_ms(qa["p99_ms"])))
        print("convoy episodes: %d%s"
              % (bt["convoy_episodes"],
                 "  UNRESOLVED on process(es) %s (log ends with a "
                 "straggler pinning a full bucket)"
                 % ",".join(bt["convoy_unresolved"])
                 if bt["convoy_unresolved"] else ""))
        for c in bt["convoys"]:
            print("  p=%-3d pinned=%-10s bucket=%s age=%s iters  "
                  "queue_depth=%s"
                  % (c["p"], c.get("pinned"), c.get("bucket"),
                     c.get("age_iters"), c.get("queue_depth")))
    fl = agg.get("fleet")
    if fl:
        print("\n== fleet requests (router <-> replica join on "
              "trace id) ==")
        print("routed: %d  %s  retried: %d  hop-matched: %d"
              "  unmatched: %d"
              % (fl["requests"],
                 " ".join("%s=%d" % kv
                          for kv in sorted(fl["outcomes"].items())),
                 fl["retried"], fl["matched"], fl["unmatched"]))
        if fl["router_overhead_p50_ms"] is not None:
            print("router overhead (total - slowest hop): p50=%s  "
                  "p99=%s"
                  % (_fmt_ms(fl["router_overhead_p50_ms"]),
                     _fmt_ms(fl["router_overhead_p99_ms"])))
        print("top-5 slowest routed requests (per-hop breakdown):")
        for j in fl["slowest"]:
            print("  req=%-18s %-10s total=%8.2fms  attempts=%d"
                  "%s  via %s"
                  % (j["req"], j["outcome"],
                     1e3 * float(j.get("total_s") or 0.0),
                     j["attempts"],
                     " retries=%d" % j["retries"] if j["retries"]
                     else "",
                     ",".join(j["replicas"]) or "-"))
            for h in j["hops"]:
                print("    hop p=%-3d %-12s total=%s ttft=%s "
                      "queue=%s prefill=%s decode=%s"
                      % (h["p"], h.get("outcome"),
                         *(_fmt_ms(None if h.get(k) is None
                                   else 1e3 * float(h[k]))
                           for k in ("total_s", "ttft_s",
                                     "queue_wait_s", "prefill_s",
                                     "decode_s"))))
        if fl["outlier_transitions"]:
            print("outlier transitions:")
            for t in fl["outlier_transitions"]:
                print("  %-21s -> %s (p99 %s vs fleet %s)"
                      % (t["replica"],
                         "OUTLIER" if t["outlier"] else "ok",
                         _fmt_ms(t.get("p99_ms")),
                         _fmt_ms(t.get("fleet_p99_ms"))))
    slo = agg.get("slo")
    if slo:
        print("\n== slo ==")
        print("burn transitions: %d" % slo["transitions"])
        for p, st in sorted(slo["final"].items()):
            print("  process %s final: %s (burn rate %sx)"
                  % (p, "BURNING" if st["state"] else "within budget",
                     st.get("burn_rate")))
    bk = agg.get("books")
    if bk:
        print("\n== conservation laws (metrics books) ==")
        print("books_broken transitions: %d%s"
              % (bk["transitions"],
                 "   LATCHED at end of log: %s"
                 % ", ".join(bk["latched"]) if bk["latched"]
                 else "   all laws clear at end of log"))
        for k, d in sorted(bk.get("details", {}).items()):
            print("  %-28s %s" % (k, d))
    pg = agg.get("programs")
    if pg:
        print("\n== program ledger (per-compiled-program perf cards) ==")
        hbm = pg.get("hbm_peak_bytes")
        print("programs: %d   compile total: %.2fs   hbm peak: %s"
              % (pg["count"], pg["compile_s"],
                 "%.1f MiB" % (hbm / float(1 << 20))
                 if hbm is not None else "n/a"))
        print("%-18s %-26s %3s %9s %10s %9s %9s %9s %7s %7s" %
              ("program", "shapes", "n", "compile_s", "GFLOPs",
               "peak_MiB", "pred_ms", "p50_ms", "MFU%", "eff%"))

        def _n(v, scale=1.0, form="%.2f"):
            return "n/a" if v is None else form % (v * scale)

        for r in pg["cards"]:
            print("%-18s %-26s %3d %9.2f %10s %9s %9s %9s %7s %7s" %
                  (r["name"], str(r.get("shapes"))[:26], r["compiles"],
                   r["compile_s"], _n(r["flops"], 1e-9),
                   _n(r["peak_bytes"], 1.0 / (1 << 20), "%.1f"),
                   _n(r["predicted_s"], 1e3),
                   _n(r["measured_p50_ms"]),
                   _n(r["mfu_pct"], form="%.1f"),
                   _n(r["roofline_eff_pct"], form="%.1f")))
            if r.get("status") == "error":
                print("    analysis error: %s" % r.get("error"))
        if pg["top_by_compile"]:
            print("top by compile time: %s"
                  % "  ".join(pg["top_by_compile"]))
        if pg["top_by_gap"]:
            print("largest roofline gap (lowest eff%%): %s"
                  % "  ".join(pg["top_by_gap"]))
    h = agg.get("health", {})
    if h and (h["anomalies"] or h["stalls"] or h["data_corrupt"]
              or h["skipped_batches"]):
        print("\n== health ==")
        print("anomalies: %d  %s" %
              (len(h["anomalies"]),
               " ".join("%s=%d" % kv for kv in
                        sorted(count_by(h["anomalies"], "kind").items()))))
        if h["resolutions"]:
            print("resolutions: %d  %s" %
                  (len(h["resolutions"]),
                   " ".join("%s=%d" % kv for kv in sorted(
                       count_by(h["resolutions"], "ev").items()))))
        if h["stalls"]:
            print("watchdog stalls: %d  %s" %
                  (len(h["stalls"]),
                   " ".join("%s=%d" % kv for kv in sorted(
                       count_by(h["stalls"], "channel").items()))))
        if h["data_corrupt"]:
            print("corrupt data records: %d" % h["data_corrupt"])
        if h["skipped_batches"]:
            print("quarantined batches skipped: %d" % h["skipped_batches"])
        for a in h["unresolved"]:
            print("UNRESOLVED anomaly id=%s kind=%s round=%s batch=%s" %
                  (a.get("id"), a.get("kind"), a.get("round"),
                   a.get("batch")))


def main(argv):
    top = 15
    trace_out = None
    as_json = False
    merge = False
    fleet = False
    want_incidents = False
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--top" and i + 1 < len(argv):
            top = int(argv[i + 1])
            i += 2
        elif a == "--trace" and i + 1 < len(argv):
            trace_out = argv[i + 1]
            i += 2
        elif a == "--json":
            as_json = True
            i += 1
        elif a == "--merge":
            merge = True
            i += 1
        elif a == "--fleet":
            fleet = True
            i += 1
        elif a == "--incidents":
            want_incidents = True
            i += 1
        elif a.startswith("--"):
            print("unknown option %s" % a, file=sys.stderr)
            return 1
        else:
            paths.append(a)
            i += 1
    many = merge or fleet
    if (len(paths) != 1 and not many) or (many and len(paths) < 1):
        print(__doc__, file=sys.stderr)
        return 1
    for path in paths:
        if not os.path.exists(path):
            print("no such log: %s" % path, file=sys.stderr)
            return 1
    if fleet:
        # router + replica logs: separate processes, relabeled by
        # argument position, joined on the shared trace ids
        events = merge_fleet_shards([load_events(p) for p in paths])
        label = "+".join(paths)
    elif merge:
        events = merge_shards([load_events(p) for p in paths])
        label = "+".join(paths)
    else:
        events = load_events(paths[0])
        label = paths[0]
    agg = aggregate(events)
    if want_incidents:
        # the offline twin of the live /eventz endpoint: t_wall aligns
        # on the earliest shard's wall epoch (single log: its own)
        t0s = [float(ev.get("t0_wall", 0.0)) for ev in events
               if ev.get("ev") == "meta"]
        agg["incidents"] = autopsy.incidents(
            events, t0_wall=min(t0s) if t0s else 0.0)
    if as_json:
        print(json.dumps(agg, indent=1))
    else:
        if fleet:
            print("fleet-merged %d log(s) (shard i = process i): %s\n"
                  % (len(paths), label))
        elif merge:
            print("merged %d shard(s): %s\n" % (len(paths), label))
        print_report(agg, top=top)
        if want_incidents:
            print("\n== incident timeline ==")
            rows = agg["incidents"]
            if not rows:
                print("(no transition or point incidents in this log)")
            for r in rows:
                ev = r["event"]
                detail = " ".join(
                    "%s=%s" % (k, ev[k]) for k in sorted(ev)
                    if k not in ("ev", "ts", "p")
                    and not isinstance(ev[k], (dict, list)))
                print("%10.3fs p=%-3s %-20s %-6s %s"
                      % (r["ts"], ev.get("p", 0), r["kind"],
                         r["state"], detail))
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(events_to_chrome(events), f)
        print("\nchrome trace written to %s "
              "(open in chrome://tracing or ui.perfetto.dev)" % trace_out)
    unresolved = agg.get("health", {}).get("unresolved", [])
    if unresolved:
        print("%s: %d health_anomaly event(s) with no matching "
              "health_rollback/resolution — the run detected trouble and "
              "never recovered" % (label, len(unresolved)), file=sys.stderr)
        return 2
    open_breakers = (agg.get("serving") or {}).get(
        "breaker_open_unresolved", [])
    if open_breakers:
        print("%s: serving circuit breaker still OPEN at end of log "
              "(process %s) — the run ended shedding every request"
              % (label, ", ".join(open_breakers)), file=sys.stderr)
        return 2
    burning = (agg.get("slo") or {}).get("burning", [])
    if burning:
        print("%s: SLO error-budget burn rate still exceeded at end of "
              "log (process %s) — the run ended blowing its objectives"
              % (label, ", ".join(burning)), file=sys.stderr)
        return 2
    latched = (agg.get("books") or {}).get("latched", [])
    if latched:
        print("%s: conservation law(s) still latched BROKEN at end of "
              "log (%s) — every other number in this report is suspect"
              % (label, ", ".join(latched)), file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
