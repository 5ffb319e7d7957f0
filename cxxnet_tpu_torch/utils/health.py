"""The watchdog channel registry of the port: ``beat`` and ``pause``, as in
cxxnet_tpu/utils/health.py, and the ranked lock ``health.ids`` that
numbers anomalies.

The serving frontend's accept and worker threads beat the
``serve.accept`` / ``serve.worker`` channels and pause them across idle
periods and device calls. A channel is watched only while a watchdog runs;
the port has no watchdog yet (``watchdog_timeout`` is refused off 0), so
both calls only keep the registry: ``beat`` is a no-op and ``pause``
forgets the channel. The health monitor, recovery and the watchdog itself
come with the training-health slice. Standard library only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import lockrank

__all__ = ["beat", "pause", "channel_status", "new_anomaly_id"]

# ranked (utils/lockrank.py): anomaly ids are allocated from telemetry and
# watchdog callbacks, so the ordering discipline covers it
_id_lock = lockrank.lock("health.ids")
_next_anomaly_id = [0]

# channel -> monotonic time of its last beat, kept while a watchdog runs
_beats: Dict[str, float] = {}
# the running watchdog: its timeout in seconds, or None (the port starts
# none yet)
_watchdog_timeout: Optional[float] = None


def new_anomaly_id() -> int:
    """The next anomaly id of this process (1, 2, ...)."""
    with _id_lock:
        _next_anomaly_id[0] += 1
        return _next_anomaly_id[0]


def beat(channel: str = "train.step") -> None:
    """Heartbeat a liveness channel. No-op unless a watchdog is running;
    one dict store under the GIL, safe from any thread."""
    if _watchdog_timeout is not None:
        _beats[channel] = time.monotonic()


def pause(channel: str = "train.step") -> None:
    """Disarm a liveness channel for a legitimately silent phase (an idle
    queue, a device call that builds a kernel at first use); the next
    ``beat`` re-arms it. Cheap and safe from any thread."""
    _beats.pop(channel, None)


def channel_status() -> List[Tuple[str, float, float, bool]]:
    """``[(channel, age_s, timeout_s, overdue), ...]`` over every ARMED
    channel; empty while no watchdog runs."""
    timeout = _watchdog_timeout
    if timeout is None:
        return []
    now = time.monotonic()
    return [(ch, now - t, timeout, (now - t) > timeout)
            for ch, t in list(_beats.items())]
