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

The fleet router's autopsy and the incident timeline come with the router.
A pure function of dicts; standard library only.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["CAUSES", "classify_record"]

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
