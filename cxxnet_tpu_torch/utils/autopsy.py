"""Request slowdown autopsy of the port: ``classify_record``, the piece of
cxxnet_tpu/utils/autopsy.py that the serving frontend stamps on every
flight record, with the same causes, waterfall and verdicts.

``classify_record(rec)`` takes one flight record (the shape
``servd.ServeFrontend._observe_request`` builds) and returns its autopsy:
the request's wall time decomposed into named causes, seconds attributed
to each, and exactly one *primary* verdict. The decomposition is a
waterfall that tiles ``wall_s`` by construction:

- the queue pool (``queue_wait`` + ``dispatch`` phases) is claimed first
  by ``convoy_victim`` (overlap with a decode-convoy episode,
  ``convoy_overlap_s``), then by ``kv_defer`` (the request was bounced by
  KV exhaustion at least once, ``kv_defers`` > 0), and the remainder is
  honest ``queue_wait``;
- the work pool (``prefill`` + ``decode`` phases) is claimed first by
  ``compile_stall`` (``compile_stall_s``: in the port, kernel builds the
  request sat through), then by ``eviction_storm`` (overlap with a
  latched KV-pressure episode, ``kv_pressure_overlap_s``), and the
  remainder, plus the wall-vs-phase residual, is ``decode_baseline``.

``incidents(events, ...)`` turns the transition-only event streams
(decode convoy, KV pressure, SLO burn, breaker, broken books) and the
point events (drain, reload, batch rescue) into one wall-clock-ordered
incident timeline, each begin row naming the requests whose autopsies
cite its episode: the status server's ``/eventz``.

``classify_route(rec)`` takes one flight record of the fleet router
(``routerd.Router._record_request``: its attempt list) and returns the
router-side autopsy: the time before the winning attempt launched is
``hedge_replay`` when the failover machinery caused it (a retry, replay or
hedge lane won) and router ``queue_wait`` otherwise; the winning attempt's
latency is ``decode_baseline`` until a replica's record refines it.

``stitch_route(rec, hops)`` is the cross-process join behind the router's
``/why``: the winning attempt's latency lane is replaced by the replica's
own autopsy plus ``slow_replica``, the part of the latency the router saw
that the replica's books cannot account for (network, or a replica slower
than it admits). Skewed hop books that claim more than the lane are scaled
down to fit it, so the stitched causes still tile the router's total.

Pure functions of dicts; standard library only. ``python -m
cxxnet_tpu_torch.utils.autopsy --selftest`` is the embedded check.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["CAUSES", "classify_record", "classify_route",
           "stitch_route", "TRANSITION_EVENTS", "POINT_EVENTS",
           "INCIDENT_CAUSES", "incidents", "selftest"]

# The cause taxonomy. Order is the primary-verdict tie-break: a named cause
# beats decode_baseline at equal seconds, and earlier names win ties —
# deterministic, so the same record always gets the same verdict.
CAUSES = ("queue_wait", "compile_stall", "convoy_victim", "kv_defer",
          "eviction_storm", "hedge_replay", "slow_replica",
          "decode_baseline")


def _f(v) -> float:
    try:
        return max(0.0, float(v))
    except (TypeError, ValueError):
        return 0.0


def _finish(causes: Dict[str, float], wall: float) -> dict:
    primary = CAUSES[0]
    best = causes.get(primary, 0.0)
    for c in CAUSES:
        if causes.get(c, 0.0) > best:
            primary, best = c, causes[c]
    return {"primary": primary,
            "causes": {c: round(causes.get(c, 0.0), 6) for c in CAUSES},
            "wall_s": round(wall, 6)}


def classify_record(rec: dict) -> dict:
    """One replica flight record -> its autopsy. Deterministic, total:
    a record missing every optional input (a pre-autopsy record, a shed
    with zero phases) still classifies — everything unexplained lands
    in ``queue_wait``/``decode_baseline``, never in a named cause."""
    phases = rec.get("phases") or {}
    queue_pool = _f(phases.get("queue_wait")) + _f(phases.get("dispatch"))
    work_pool = _f(phases.get("prefill")) + _f(phases.get("decode"))
    wall = rec.get("wall_s")
    if wall is None:
        wall = rec.get("total_s")
    wall = _f(wall)
    causes = {c: 0.0 for c in CAUSES}
    # queue pool waterfall: convoy overlap first (the request waited
    # behind a pinned slot), then KV-defer (it was bounced back to the
    # queue head by pool exhaustion), remainder is plain queue_wait
    convoy = min(queue_pool, _f(rec.get("convoy_overlap_s")))
    causes["convoy_victim"] = convoy
    queue_pool -= convoy
    if int(rec.get("kv_defers") or 0) > 0:
        causes["kv_defer"] = queue_pool
    else:
        causes["queue_wait"] = queue_pool
    # work pool waterfall: compile stall (the per-request attribution —
    # exactly 0.0 once every kernel is built), then eviction-storm
    # overlap, remainder plus the wall-vs-phases residual is baseline
    stall = min(work_pool, _f(rec.get("compile_stall_s")))
    causes["compile_stall"] = stall
    work_pool -= stall
    storm = min(work_pool, _f(rec.get("kv_pressure_overlap_s")))
    causes["eviction_storm"] = storm
    phase_sum = (_f(phases.get("queue_wait")) + _f(phases.get("dispatch"))
                 + _f(phases.get("prefill")) + _f(phases.get("decode")))
    causes["decode_baseline"] = (work_pool - storm
                                 + max(0.0, wall - phase_sum))
    return _finish(causes, max(wall, phase_sum))


def classify_route(rec: dict) -> dict:
    """One ROUTER flight record (``routerd._record_request`` shape) ->
    the router-side autopsy over ``total_s``. The winning attempt is
    the last one (the response the client got); everything before its
    launch is ``hedge_replay`` when the failover machinery caused the
    delay (more than one attempt, or the winner is a replay/hedge
    lane) and router ``queue_wait`` otherwise; the winner's latency is
    ``decode_baseline`` until ``stitch_route`` refines it with the
    replica's own books."""
    total = _f(rec.get("total_s"))
    atts = rec.get("attempts") or []
    causes = {c: 0.0 for c in CAUSES}
    if not atts:
        # door shed / proto error / router-side deadline: the router
        # alone produced the answer
        causes["queue_wait"] = total
        return _finish(causes, total)
    win = atts[-1]
    t_off = min(total, _f(win.get("t_off_s")))
    lat = min(total - t_off, _f(win.get("latency_s")))
    failover = len(atts) > 1 or win.get("cls") in ("replay", "hedge")
    causes["hedge_replay" if failover else "queue_wait"] += t_off
    causes["decode_baseline"] = lat
    causes["queue_wait"] += total - t_off - lat
    return _finish(causes, total)


def stitch_route(rec: dict, hops) -> dict:
    """The cross-process autopsy (the ``/why`` router path): ``hops``
    is ``[(replica_name, replica_flight_record), ...]`` exactly like
    the ``/trace`` stitch. The winning attempt's latency lane is
    replaced by the replica's own cause decomposition plus
    ``slow_replica`` — the slice of router-observed latency the
    replica's books cannot account for (network, connect, or a replica
    slower than it admits). The result still tiles the router's
    ``total_s``. Returns the full ``/why`` payload: merged autopsy
    plus the router-lane and per-hop breakdowns."""
    base = rec.get("autopsy") or classify_route(rec)
    causes = {c: 0.0 for c in CAUSES}
    causes.update(base.get("causes") or {})
    hop_auts: Dict[str, dict] = {}
    atts = rec.get("attempts") or []
    win_name = atts[-1].get("replica") if atts else None
    for name, rrec in hops or []:
        if isinstance(rrec, dict):
            hop_auts[str(name)] = rrec.get("autopsy") \
                or classify_record(rrec)
    win_aut = hop_auts.get(win_name) if win_name else None
    if win_aut is not None:
        lane = causes.get("decode_baseline", 0.0)
        hop_causes = win_aut.get("causes") or {}
        hop_sum = sum(_f(v) for v in hop_causes.values())
        # clock-skew guard: the replica's books may claim (slightly)
        # more than the router observed — scale them down to fit the
        # lane so the stitched causes still tile total_s exactly
        scale = 1.0 if hop_sum <= lane or hop_sum <= 0.0 \
            else lane / hop_sum
        causes["decode_baseline"] = 0.0
        claimed = 0.0
        for c in CAUSES:
            add = _f(hop_causes.get(c)) * scale
            causes[c] += add
            claimed += add
        causes["slow_replica"] += max(0.0, lane - claimed)
    merged = _finish(causes, base.get("wall_s", 0.0))
    return {"id": rec.get("id"), "outcome": rec.get("outcome"),
            "autopsy": merged, "router": base, "hops": hop_auts}




# ----------------------------------------------------------------------
# the incident timeline (/eventz)

# transition-only event kinds -> the latch field whose truthiness says
# begin (latched) vs end (cleared). "state" fields accept both the
# numeric (slo_burn: 0/1) and the named (serve_breaker: open/closed)
# convention.
TRANSITION_EVENTS = {
    "decode_convoy": "convoy",
    "kv_pressure": "pressure",
    "fleet_outlier": "outlier",
    "slo_burn": "state",
    "serve_breaker": "state",
    "books_broken": "broken",
}
# point kinds: one row each, no begin/end pairing
POINT_EVENTS = ("fleet_scale", "serve_batch_rescue", "serve_drain",
                "serve_reload", "route_reload", "route_drain",
                "route_replica", "route_discarded_late",
                "route_hedge_mismatch")
# incident kind -> the autopsy causes that cite it (the causal links:
# a begin row carries the requests whose autopsies blame its episode)
INCIDENT_CAUSES = {
    "decode_convoy": ("convoy_victim",),
    "kv_pressure": ("kv_defer", "eviction_storm"),
    "slo_burn": ("queue_wait", "compile_stall", "convoy_victim",
                 "kv_defer", "eviction_storm", "hedge_replay",
                 "slow_replica"),
}


def _latched(kind: str, ev: dict) -> bool:
    field = TRANSITION_EVENTS[kind]
    v = ev.get(field)
    if isinstance(v, str):
        return v.lower() in ("open", "burning", "1", "true")
    return bool(v)


def _incident_key(ev: dict) -> tuple:
    return (ev.get("ev"), ev.get("replica"), ev.get("law"),
            ev.get("slot"), ev.get("process"))


def incidents(events, t0_wall: float = 0.0, records=None,
              n: Optional[int] = None, process=None) -> List[dict]:
    """Transition/point events -> the incident timeline, oldest first.
    ``events`` carry registry-relative ``ts`` seconds; ``t0_wall`` is
    the registry's wall epoch, so rows align across processes on
    ``t_wall``. ``records`` (flight records WITH autopsies, any order)
    feeds the causal links: a begin row lists up to 8 request ids whose
    autopsy cites one of the incident's causes and whose flight window
    overlaps the episode. ``n`` bounds the output to the NEWEST rows.
    Rows: ``{"kind", "state" (begin|end|point), "ts", "t_wall",
    "requests"?, "process"?, "event"}``."""
    rows: List[dict] = []
    for ev in events or []:
        kind = ev.get("ev")
        if kind in TRANSITION_EVENTS:
            state = "begin" if _latched(kind, ev) else "end"
        elif kind in POINT_EVENTS:
            state = "point"
        else:
            continue
        ts = _f(ev.get("ts"))
        row = {"kind": kind, "state": state, "ts": round(ts, 6),
               "t_wall": round(t0_wall + ts, 6), "event": dict(ev)}
        if process is not None:
            row["process"] = process
        rows.append(row)
    rows.sort(key=lambda r: r["t_wall"])
    # pair begins with ends (same kind+subject) to bound each episode's
    # window, then attach the requests whose autopsies cite it
    if records:
        open_at: Dict[tuple, dict] = {}
        windows: List[Tuple[dict, float, float]] = []
        for row in rows:
            if row["state"] == "begin":
                open_at[_incident_key(row["event"])] = row
            elif row["state"] == "end":
                beg = open_at.pop(_incident_key(row["event"]), None)
                if beg is not None:
                    windows.append((beg, beg["t_wall"], row["t_wall"]))
        for beg in open_at.values():           # still-latched episodes
            windows.append((beg, beg["t_wall"], float("inf")))
        for beg, w0, w1 in windows:
            wanted = INCIDENT_CAUSES.get(beg["kind"])
            if not wanted:
                continue
            hits = []
            for rec in records:
                aut = rec.get("autopsy")
                if not aut:
                    continue
                c = aut.get("causes") or {}
                if not any(_f(c.get(w)) > 0 for w in wanted):
                    continue
                r0 = rec.get("t_wall")
                if r0 is None:
                    continue
                r1 = float(r0) + _f(rec.get("wall_s")
                                    if rec.get("wall_s") is not None
                                    else rec.get("total_s"))
                if r1 >= w0 and float(r0) <= w1:
                    hits.append(rec.get("id"))
            if hits:
                beg["requests"] = hits[:8]
    if n is not None and n >= 0:
        rows = rows[-n:] if n else []
    return rows


# ----------------------------------------------------------------------
def selftest(verbose: bool = False) -> int:
    # a plain served record: everything is decode_baseline
    rec = {"id": "a", "outcome": "served", "wall_s": 1.0,
           "total_s": 1.0,
           "phases": {"queue_wait": 0.1, "dispatch": 0.0,
                      "prefill": 0.2, "decode": 0.7}}
    a = classify_record(rec)
    assert a["primary"] == "decode_baseline", a
    assert abs(sum(a["causes"].values()) - 1.0) < 1e-6, a
    # compile stall claims the work pool
    a = classify_record(dict(rec, compile_stall_s=0.8))
    assert a["primary"] == "compile_stall", a
    assert abs(sum(a["causes"].values()) - 1.0) < 1e-6
    # kv defer claims the queue pool
    a = classify_record(dict(rec, kv_defers=2,
                             phases={"queue_wait": 0.8, "dispatch": 0.0,
                                     "prefill": 0.1, "decode": 0.1}))
    assert a["primary"] == "kv_defer", a
    # a record with NO optional inputs still classifies
    a = classify_record({"id": "bare"})
    assert a["primary"] == "queue_wait" and a["wall_s"] == 0.0
    # router record: single clean attempt
    rr = {"id": "r", "outcome": "served", "total_s": 0.5,
          "attempts": [{"replica": "x", "t_off_s": 0.01,
                        "latency_s": 0.48, "status": "ok"}]}
    ra = classify_route(rr)
    assert ra["primary"] == "decode_baseline"
    assert abs(sum(ra["causes"].values()) - 0.5) < 1e-6
    # failover: two attempts -> the pre-winner time is hedge_replay
    rr2 = {"id": "r2", "outcome": "served", "total_s": 1.0,
           "attempts": [{"replica": "x", "t_off_s": 0.0,
                         "latency_s": 0.4, "status": "lost"},
                        {"replica": "y", "t_off_s": 0.45,
                         "latency_s": 0.5, "status": "ok",
                         "cls": "replay"}]}
    ra2 = classify_route(rr2)
    assert ra2["causes"]["hedge_replay"] > 0.4, ra2
    # the stitch: replica books replace the latency lane; slow_replica
    # absorbs what the replica cannot account for
    hop = {"id": "r", "outcome": "served", "wall_s": 0.4,
           "total_s": 0.4,
           "phases": {"queue_wait": 0.0, "dispatch": 0.0,
                      "prefill": 0.1, "decode": 0.3}}
    sw = stitch_route(rr, [("x", hop)])
    m = sw["autopsy"]
    assert abs(sum(m["causes"].values()) - 0.5) < 1e-6, m
    assert abs(m["causes"]["slow_replica"] - 0.08) < 1e-6, m
    # incident timeline: begin/end pairing + causal request link
    evs = [{"ev": "decode_convoy", "convoy": 1, "ts": 1.0, "slot": 0},
           {"ev": "decode_convoy", "convoy": 0, "ts": 3.0, "slot": 0},
           {"ev": "fleet_scale", "action": "up", "ts": 2.0}]
    recs = [{"id": "v", "t_wall": 101.5, "wall_s": 1.0,
             "autopsy": {"primary": "convoy_victim",
                         "causes": {"convoy_victim": 0.9},
                         "wall_s": 1.0}}]
    rows = incidents(evs, t0_wall=100.0, records=recs)
    assert [r["kind"] for r in rows] == ["decode_convoy", "fleet_scale",
                                         "decode_convoy"]
    assert rows[0]["requests"] == ["v"], rows[0]
    if verbose:
        print("autopsy selftest: record/route/stitch/incident "
              "classification ok (%d causes)" % len(CAUSES))
    return 0


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        sys.exit(selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
