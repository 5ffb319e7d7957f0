"""Runtime lock-rank enforcement: the port's own copy of
cxxnet_tpu/utils/lockrank.py, with the same rank table and checks.

Callback-driven and cross-thread lock acquisitions (a reply closure taking a
connection condition, a probe run from another thread) can deadlock in
orders no reading of one function shows. Every named lock carries a
**rank**, and with ``CXXNET_LOCKRANK=1`` each acquisition asserts that
ranks are taken strictly in increasing order per thread. An inversion then
surfaces as an immediate, named diagnostic in the serving tests and the
servd selftest instead of as a rare deadlock in production.

Usage: construct locks through the factories instead of ``threading``::

    self._lock = lockrank.lock("servd.stats")
    self._cond = lockrank.condition("servd.queue")

The factories always return ranked wrappers; whether an acquisition is
CHECKED is decided per acquire by ``enabled()``, not at construction, so
module-level locks (the telemetry registry is built at import time) are
checked in any process that sets ``CXXNET_LOCKRANK`` after importing them.
With the variable unset (the default) an acquisition costs one env lookup
and otherwise behaves like the plain primitive. With it set, acquisitions
keep a thread-local stack of (rank, name, site) and raise
``LockOrderError`` naming BOTH locks and BOTH acquisition sites on any
out-of-order take. ``Condition.wait`` releases and re-takes its lock; the
ranked condition keeps the stack honest across the gap (its inner lock is
a RankedLock, so every method ``threading.Condition.__init__`` binds from
it is ranked). ``enforced()`` is a context manager that sets and restores
the variable around a block, so in-process callers of the selftests do not
inherit enforcement.

``RANKS`` is the project lock ordering, the JAX package's table entry for
entry (the fleet router's and the perf ledger's locks included, so the two
packages order every shared name alike). Gaps leave room to slot new locks
without renumbering. A name not in RANKS gets ``DEFAULT_RANK`` (outermost
bucket) and still takes part in ordering checks against ranked locks.

Standard library only; ``python -m cxxnet_tpu_torch.utils.lockrank
--selftest`` exercises the ordered, inverted and condition-wait paths in
process.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from typing import List, Optional, Tuple

__all__ = ["RANKS", "DEFAULT_RANK", "LockOrderError", "RankedLock",
           "RankedCondition", "lock", "condition", "enabled",
           "enforced", "held", "selftest"]

# The project lock ordering (LOWER = acquired FIRST / outermost): the JAX
# package's table (cxxnet_tpu/utils/lockrank.py), entry for entry.
RANKS = {
    "routerd.scale": 1,     # Router._scale_lock — autoscaler decisions
    #                         and idle timers (outermost of the router
    #                         locks: a decision may mark replicas under
    #                         the fleet lock; IO — standby probes —
    #                         stays outside it)
    "routerd.fleet": 2,     # Router._lock — replica states/load/windows
    #                         (outermost: held while recording telemetry,
    #                         never under any servd/statusd lock)
    "routerd.stats": 5,     # Router._slock — router counter snapshot
    "routerd.fed": 7,       # Router._fed_lock — federated replica
    #                         metric snapshots + outlier verdicts
    #                         (never nested with fleet/stats; IO stays
    #                         outside it)
    "servd.queue": 10,      # ServeFrontend._cond — admission/worker/drain
    "kvblocks.evict": 15,   # BlockAllocator._lock — KV block
    #                         reservation + retained-pool eviction
    #                         (atomic evict-before-defer). Nests INSIDE
    #                         the admission lock (servd.queue), never
    #                         the reverse: the dispatcher sheds/admits
    #                         while coalescing, the allocator never
    #                         calls back into servd — so exhaustion
    #                         cannot deadlock a reserve-up-front
    #                         admission (the paged-KV floods of
    #                         tests/test_torch_servd.py run under
    #                         CXXNET_LOCKRANK=1)
    "servd.conns": 20,      # ServeFrontend._conn_lock — live writer set
    "servd.conn": 30,       # _ConnState.cond — per-connection reply slots
    "servd.request": 40,    # _Request._alock — exactly-once answer claim
    "servd.stats": 50,      # ServeFrontend._slock — stats snapshot
    "servd.breaker": 60,    # CircuitBreaker._lock
    "statusd.slo": 70,      # SLOTracker._lock — emits telemetry under it
    "health.ids": 80,       # health anomaly-id allocation
    "perf.profilez": 85,    # ProfilerCapture._lock — capture guard
    "servd.batchflight": 88,  # BatchFlightRecorder._ring — the
    #                           per-iteration batch scheduler ring
    #                           (appended outside every servd lock,
    #                           read by statusd /batchz)
    "telemetry.flight": 90,   # FlightRecorder._ring
    "perf.compiles": 92,    # Ledger._clock — the compile flight ring +
    #                         warm-grid account (ring append / warm mark
    #                         under it; the program_compile event — IO —
    #                         is emitted OUTSIDE it)
    "perf.ledger": 95,      # Ledger._cond — emits program_card events
    #                         and reads registry hists under it
    "telemetry.audit": 97,  # BooksAuditor._lock — latch bookkeeping
    #                         only: laws are evaluated OUTSIDE it, the
    #                         books_broken event is emitted outside it;
    #                         below everything but the registry
    "telemetry.registry": 100,  # _Registry._lock — innermost by design:
    #                             every subsystem records telemetry, so
    #                             nothing may be acquired under it
}

# unranked names sort OUTERMOST: they may wrap ranked locks but a ranked
# lock holder acquiring an unranked one is an ordering violation —
# conservative, so forgetting to rank a new lock fails loudly in the
# chaos tests instead of silently escaping the ordering discipline
DEFAULT_RANK = 0


class LockOrderError(AssertionError):
    """A lock acquisition out of rank order: names both locks and both
    acquisition sites (the would-be deadlock's two halves)."""


_tls = threading.local()


def enabled() -> bool:
    return os.environ.get("CXXNET_LOCKRANK", "") not in ("", "0")


class enforced:
    """``with lockrank.enforced():`` — enforcement on inside the block,
    prior state restored on exit (selftests and in-process tooling must
    not leak enforcement into their caller's process)."""

    def __enter__(self) -> "enforced":
        self._prev = os.environ.get("CXXNET_LOCKRANK")
        os.environ["CXXNET_LOCKRANK"] = "1"
        return self

    def __exit__(self, *exc) -> bool:
        if self._prev is None:
            os.environ.pop("CXXNET_LOCKRANK", None)
        else:
            os.environ["CXXNET_LOCKRANK"] = self._prev
        return False


def _stack() -> List[Tuple[int, str, str]]:
    s = getattr(_tls, "held", None)
    if s is None:
        s = _tls.held = []
    return s


def held() -> List[Tuple[int, str, str]]:
    """This thread's (rank, name, site) stack, outermost first —
    diagnostics and tests."""
    return list(_stack())


def _site() -> str:
    """path:line of the acquiring frame — first frame outside this
    module AND outside threading (a RankedCondition acquisition passes
    through Condition.__enter__/wait internals; reporting threading.py
    as the site would hide the one thing the operator needs)."""
    f = sys._getframe(2)
    while f is not None and f.f_globals.get("__name__") in (__name__,
                                                            "threading"):
        f = f.f_back
    if f is None:
        return "?"
    return "%s:%d" % (f.f_code.co_filename, f.f_lineno)


def _push(name: str, rank: int, site: str) -> None:
    s = _stack()
    if s:
        top_rank, top_name, top_site = max(s)
        if rank <= top_rank:
            raise LockOrderError(
                "lock order inversion: acquiring %r (rank %d) at %s "
                "while holding %r (rank %d) acquired at %s — the order "
                "of lockrank.RANKS requires %r before %r"
                % (name, rank, site, top_name, top_rank, top_site,
                   name, top_name))
    s.append((rank, name, site))


def _pop(name: str) -> None:
    s = _stack()
    for i in range(len(s) - 1, -1, -1):
        if s[i][1] == name:
            del s[i]
            return


class RankedLock:
    """``threading.Lock`` plus per-thread rank-order assertion.

    ``enabled()`` is consulted per ACQUISITION: a lock built at import
    time starts asserting the moment the env var flips on. ``release``
    always pops (a no-op when nothing was pushed) so toggling
    enforcement mid-hold cannot leak a stack entry."""

    def __init__(self, name: str, rank: Optional[int] = None):
        self.name = name
        self.rank = RANKS.get(name, DEFAULT_RANK) if rank is None \
            else int(rank)
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if enabled():
            _push(self.name, self.rank, _site())   # check BEFORE
            #             blocking: the inversion must raise, not
            #             deadlock first
        got = self._lock.acquire(blocking, timeout)
        if not got:
            _pop(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        _pop(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "RankedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # Condition protocol: Condition.__init__ binds acquire/release AND
    # (when the lock defines them) _release_save/_acquire_restore/
    # _is_owned as INSTANCE attributes from its inner lock — defining
    # them here keeps every binding ranked, so wait()'s release/re-take
    # gap pops and re-pushes the stack entry symmetrically
    def _release_save(self):
        self.release()

    def _acquire_restore(self, saved) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __repr__(self) -> str:
        return "<RankedLock %s rank=%d>" % (self.name, self.rank)


class RankedCondition(threading.Condition):
    """``threading.Condition`` over a ``RankedLock``.

    ``threading.Condition.__init__`` binds ``acquire``/``release`` (and
    ``_release_save``/``_acquire_restore``/``_is_owned`` when the lock
    defines them) as instance attributes taken from the inner lock —
    overriding them on the Condition subclass is a trap: the instance
    bindings shadow the overrides, acquisitions go unranked, and the
    class-level restore hook leaks a phantom stack entry on every
    ``wait()``. Passing a RankedLock as the inner lock routes every one
    of those bindings through the rank accounting instead: ``wait()``
    releases the lock (entry popped with it) and re-takes it on wake
    (entry re-pushed) — a waiter that was legitimately innermost cannot
    trip the check on re-acquire, and a thread that waits while holding
    a HIGHER-ranked lock still fails at the original acquisition like
    any other inversion."""

    def __init__(self, name: str, rank: Optional[int] = None):
        self.name = name
        self.rank = RANKS.get(name, DEFAULT_RANK) if rank is None \
            else int(rank)
        threading.Condition.__init__(self, RankedLock(name, self.rank))

    def __repr__(self) -> str:
        return "<RankedCondition %s rank=%d>" % (self.name, self.rank)


def lock(name: str) -> RankedLock:
    """A mutex for the named role. Always a RankedLock — whether an
    acquisition is rank-checked is decided per-acquire by ``enabled()``,
    so locks constructed before the env var flips (module-level
    registries, import-time singletons) still enforce. Keep the name
    unique and stable: it is the lock's key in RANKS."""
    return RankedLock(name)


def condition(name: str) -> RankedCondition:
    """Condition-variable counterpart of ``lock()``."""
    return RankedCondition(name)


# ----------------------------------------------------------------------
def selftest(verbose: bool = False) -> int:
    # locks constructed BEFORE enforcement flips on — the per-acquire
    # gate must cover import-time singletons (telemetry's registry)
    a = lock("servd.queue")          # rank 10
    b = lock("telemetry.registry")   # rank 100
    c = condition("servd.conn")      # rank 30

    prev = os.environ.get("CXXNET_LOCKRANK")
    # enforcement off (whatever the caller's environment says): inverted
    # order is (dangerously) silent and cheap
    os.environ["CXXNET_LOCKRANK"] = "0"
    try:
        with b:
            with a:
                pass
    finally:
        if prev is None:
            os.environ.pop("CXXNET_LOCKRANK", None)
        else:
            os.environ["CXXNET_LOCKRANK"] = prev
    assert not held(), "disabled acquisitions touched the stack"

    ctx = enforced()
    ctx.__enter__()
    try:
        _selftest_enforced(a, b, c)
    finally:
        ctx.__exit__()
    assert os.environ.get("CXXNET_LOCKRANK") == prev, \
        "selftest leaked CXXNET_LOCKRANK into the env"
    if verbose:
        print("lockrank selftest: ordered/inverted/condition-wait/"
              "unranked paths ok (%d ranked locks)" % len(RANKS))
    return 0


def _selftest_enforced(a, b, c) -> None:
    # in-order nesting is silent
    with a:
        with c:
            with b:
                pass
    assert not held(), "rank stack leaked: %r" % held()

    # inversion raises and names both sides
    try:
        with b:
            with a:
                raise AssertionError("inversion not detected")
    except LockOrderError as e:
        msg = str(e)
        assert "servd.queue" in msg and "telemetry.registry" in msg, msg
        # both acquisition sites present (path:line, or <string>:line
        # when driven through python -c)
        assert len(re.findall(r"at \S+:\d+", msg)) >= 2, \
            "diagnostic lacks both sites: " + msg
    assert not held(), "rank stack leaked after inversion: %r" % held()

    # a condition-entered inversion reports the CALLER's site, not the
    # threading.py internals the acquisition tunnels through
    try:
        with b:
            with c:
                raise AssertionError("condition inversion not detected")
    except LockOrderError as e:
        assert "threading.py" not in str(e), \
            "condition site hidden behind stdlib frames: " + str(e)
    assert not held(), "rank stack leaked: %r" % held()

    # condition wait/notify keeps the stack honest across the gap
    ping = []

    def waiter():
        with c:
            while not ping:
                c.wait(1.0)
            with b:                  # re-acquired c (30) -> b (100): ok
                ping.append("seen")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    import time
    time.sleep(0.05)
    with c:
        ping.append("go")
        c.notify()
    t.join(2.0)
    assert "seen" in ping, "condition waiter never resumed"
    # regression: a timed-out wait must leave NO phantom stack entry
    # (Condition.__init__ binds acquire/release from the inner lock as
    # instance attrs — a subclass override leaks one per wait())
    with c:
        c.wait(0.01)
    assert not held(), "condition wait leaked a stack entry: %r" % held()

    # a try-lock that fails must not leave a stack entry
    got = b.acquire()
    assert got
    b.release()
    assert not held()

    # unranked locks sit outermost: taking one UNDER a ranked lock fails
    u = lock("not.in.ranks")
    with u:
        with a:
            pass
    try:
        with a:
            with u:
                raise AssertionError("unranked-under-ranked not detected")
    except LockOrderError:
        pass


if __name__ == "__main__":
    if "--selftest" in sys.argv[1:]:
        # run the package's copy of this module: under ``python -m`` this
        # file is ``__main__``, and ``_site`` would then skip the
        # selftest's own frames as this module's and report runpy's
        from cxxnet_tpu_torch.utils import lockrank as _pkg
        sys.exit(_pkg.selftest(verbose=True))
    print(__doc__)
    sys.exit(1)
