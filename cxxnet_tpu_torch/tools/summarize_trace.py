"""Summarize a Chrome-format trace: a torch.profiler capture of the port
(``profile_dir``'s ``trace.json``, a ``/profilez`` capture) OR a
per-request serving trace (statusd ``/trace?request=<id>``, the servd
flight recorder). The port's twin of tools/summarize_trace.py.

Usage: python -m cxxnet_tpu_torch.tools.summarize_trace
           <trace-dir-or-trace.json[.gz]> [top_n]

Profiler traces (``*.json`` or ``*.json.gz``; a directory gives its newest
by name): aggregates the device's complete events by name and prints the
top-N ops by total device time, with calls and percent — enough to rank
the hot kernels without Perfetto. The device events are the ones torch
writes on the card's lanes: ``cat`` ``kernel``, ``gpu_memcpy`` and
``gpu_memset``. The host lanes (``cpu_op``, ``cuda_runtime``,
``python_function``, ...) and the annotation lanes
(``gpu_user_annotation``, ``user_annotation``) are left out: they would
count wall time twice. No card needed.

Per-request traces (detected by their phase lanes — queue_wait /
dispatch / prefill / decode): prints the phase split with percentages of
the request's wall-clock, the recompiles the request paid, and the phase
coverage — the one-slow-request triage view without opening Perfetto.
"""

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

# the serving request-phase lanes (telemetry.REQUEST_PHASES — literal
# here so the tool reads a trace without the rest of the port)
REQUEST_PHASES = ("queue_wait", "dispatch", "prefill", "decode")

# the event categories of the device's timeline in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True)
                  + glob.glob(os.path.join(path, "**", "*.json.gz"),
                              recursive=True))
    if not hits:
        raise SystemExit("no *.json or *.json.gz trace under %r" % path)
    return hits[-1]


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize_request(events) -> None:
    """Per-request trace: phase table + recompiles + coverage."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    phases = [e for e in xs if e["name"] in REQUEST_PHASES]
    rid = outcome = "?"
    for e in phases:
        args = e.get("args") or {}
        rid = args.get("request", rid)
        outcome = args.get("outcome", outcome)
    # the phases TILE the request's wall-clock (utils/servd) — the
    # phase lane, not the recompile annotations, defines the total
    t0 = min(e["ts"] for e in phases or xs)
    t1 = max(e["ts"] + e["dur"] for e in phases or xs)
    total = max(t1 - t0, 1e-9)
    covered = sum(e["dur"] for e in phases)
    print("request %s (%s): total %.2fms" % (rid, outcome, total / 1e3))
    print("%-12s %10s %6s" % ("phase", "ms", "pct"))
    by_name = {e["name"]: e for e in phases}
    for name in REQUEST_PHASES:
        e = by_name.get(name)
        if e is not None:
            print("%-12s %10.2f %5.1f%%"
                  % (name, e["dur"] / 1e3, 100.0 * e["dur"] / total))
    comps = [e for e in xs if e["name"].startswith("compile:")]
    for e in comps:
        print("%-12s %10.2f        %s (%s)"
              % ("recompile", e["dur"] / 1e3, e["name"][len("compile:"):],
                 (e.get("args") or {}).get("cause", "?")))
    print("phase coverage: %.1f%% of request wall-clock"
          % (100.0 * covered / total))


def device_ops(events):
    """({name: total device us}, {name: calls}) over the device events."""
    dur_by_name = defaultdict(float)
    cnt_by_name = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e \
                or e.get("cat") not in DEVICE_CATS:
            continue
        dur_by_name[e["name"]] += float(e["dur"])
        cnt_by_name[e["name"]] += 1
    return dur_by_name, cnt_by_name


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = find_trace(argv[0] if argv else "profile_out")
    top_n = int(argv[1]) if len(argv) > 1 else 25
    trace = load_trace(path)
    events = trace.get("traceEvents", [])
    if any(e.get("ph") == "X" and e.get("name") in REQUEST_PHASES
           for e in events):
        print("trace: %s" % path)
        summarize_request(events)
        return
    dur_by_name, cnt_by_name = device_ops(events)
    total = sum(dur_by_name.values())
    rows = sorted(dur_by_name.items(), key=lambda kv: -kv[1])[:top_n]
    print("trace: %s" % path)
    print("device-lane total: %.1f ms over %d distinct ops"
          % (total / 1e3, len(dur_by_name)))
    print("%-72s %10s %8s %6s" % ("op", "total_ms", "calls", "pct"))
    for name, d in rows:
        print("%-72s %10.2f %8d %5.1f%%"
              % (name[:72], d / 1e3, cnt_by_name[name],
                 100.0 * d / max(total, 1e-9)))


if __name__ == "__main__":
    main()
