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

The fleet router's autopsy comes with the router. Pure functions of
dicts; standard library only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["CAUSES", "classify_record", "incidents"]

# timeline"). Order is the primary-verdict tie-break: a named cause
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
