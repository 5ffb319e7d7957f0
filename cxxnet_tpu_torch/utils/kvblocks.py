"""Free-list KV-block allocator for the paged decode cache: the port's
own copy of cxxnet_tpu/utils/kvblocks.py, the same calls giving the same
block ids, tickets and accounts.

The HOST half of the paged KV cache: the device side (per-layer block pools
and the gather and writeback of a step) lives in ``nnet/trainer.py``
(``KVBlockPool`` and the paged ``DecodeSession``); this module owns every
allocation decision and is plain Python.

Model
-----
The pool is ``blocks`` fixed-size blocks of ``block_size`` cache rows
(tokens) each. Block id 0 is RESERVED as the scratch block: the padding
entry of every block table, and the landing pad for a retired slot's
device writes. It is never allocated and never meaningfully read
(attention masks every position past a slot's live extent, and a gathered
scratch block only ever covers masked positions).

* ``admit(toks, n_new)`` reserves every block a sequence can ever write,
  ``ceil((plen + n_new - 1) / block_size)``, up front, so a mid-decode
  allocation failure cannot exist: admission either holds all its blocks
  or defers. The prompt's full blocks are first matched against the
  prefix trie; matched blocks are SHARED (refcount incremented, prefilled
  by whoever loaded them: the prefill-once contract) and only the
  remainder comes off the free list.
* Shared-prefix matching is content-keyed at block granularity: the trie
  maps ``(previous block id, the block's token tuple)`` to a resident
  block, so two prompts share exactly their common full-block prefix. A
  partial tail block is never shared.
* Copy-on-write: a sequence never writes into a block with refcount > 1.
  The only write into the shared region is the block-aligned
  full-coverage case (the whole prompt matched): the last prompt position
  must be recomputed for its first-token logits, so the last matched
  block is demoted to a GATHER source and a fresh block becomes the write
  target; the device writeback copies the old content through the
  gathered view (``cow_copies`` counts these). Every other write lands
  past the shared prefix in exclusively-owned blocks by construction.
* ``free(ids)`` decrements refcounts; a REGISTERED block reaching zero
  moves to the **retained pool** instead of the free list, keeping its
  trie key: the cross-request conversation cache. Turn N+1 of a
  conversation revives the blocks turn N computed (refcount 0 -> 1, a
  *retained* hit) instead of re-prefilling them. Unregistered blocks (a
  faulted prefill's, or any block with ``prefix_reuse`` off) still free
  instantly. Accounting stays exact at every instant: ``live + retained +
  free == pool``, always (``check()`` asserts it).
* Eviction is **cost-to-recompute LRU, deepest-suffix first**: the free
  list is served first; when it runs dry the allocator evicts the
  least-recently-retired retained LEAF, a block with no trie-resident
  descendant. Leaf-only eviction is a correctness rule, not a policy: a
  trie child's key names its parent's block id, so evicting a parent
  whose descendant is still resident would let a recycled id serve stale
  KV under new content. (A retained block can never have a LIVE
  descendant, because ``admit`` refcounts the whole shared chain from the
  root, so a nonempty retained pool always has an evictable leaf:
  eviction can always make progress, and exhaustion can never deadlock a
  reserve-up-front admission.)
* Evict-before-defer: ``admit`` reserves against free PLUS evictable
  retained blocks; it returns None only when live + reserved blocks alone
  exceed the pool. Eviction and reservation happen atomically under the
  allocator's lock.

Thread model: single mutating owner (the thread that drives the
sessions). The mutating entry points (``admit``/``free``/``register``/
``evict_retained``) additionally serialize under one ranked lock,
``lockrank.lock("kvblocks.evict")`` (rank 15: it nests inside the serving
frontend's queue lock, never the reverse), as in the JAX package.
Read-only queries (``match_prefix``/``fresh_need``/``reservable``/
``account``) stay lockless under the single-owner model.
"""

from typing import Dict, List, Optional, Sequence, Tuple

from . import lockrank

__all__ = ["BlockAllocator", "AdmitTicket", "KVPoolExhausted"]


class KVPoolExhausted(RuntimeError):
    """Transient block-pool exhaustion at admission: the request fits
    the pool but not RIGHT NOW. Raised by a paged
    ``DecodeSession.prefill`` before any device work (the session
    stays open); the caller defers the request: a deterministic wait,
    never an error, never a device OOM."""


class AdmitTicket:
    """One admission's block reservation.

    ``ids``         every block the sequence holds (refcounted), in
                    position order: ``ids[j]`` backs cache rows
                    ``[j*bs, (j+1)*bs)``.
    ``gather_ids``  the ids to GATHER content from, same order —
                    identical to ``ids`` except at a copy-on-write
                    index, where it names the shared source block
                    whose content the device writeback copies.
    ``p0``          first position the suffix prefill must compute
                    (0 = no reuse; the positions [0, p0) are already
                    resident in the shared blocks).
    """

    __slots__ = ("ids", "gather_ids", "p0")

    def __init__(self, ids: List[int], gather_ids: List[int], p0: int):
        self.ids = ids
        self.gather_ids = gather_ids
        self.p0 = p0


class BlockAllocator:
    """Free-list allocator with refcounted shared-prefix blocks."""

    def __init__(self, blocks: int, block_size: int,
                 prefix_reuse: bool = True,
                 retained_frac: float = 1.0):
        if blocks < 2:
            raise ValueError("kvblocks: need >= 2 blocks "
                             "(one is the reserved scratch block)")
        if block_size < 1:
            raise ValueError("kvblocks: block_size must be >= 1")
        self.blocks = int(blocks)
        self.bs = int(block_size)
        self.prefix_reuse = bool(prefix_reuse)
        # retained-pool cap as a fraction of the usable pool
        # (serve_retained_frac). 0 frees every block instantly; the
        # default retains everything reclaimable —
        # retained blocks are evictable headroom, not a commitment
        self.retained_frac = max(0.0, min(1.0, float(retained_frac)))
        self.retained_cap = int(self.retained_frac * (self.blocks - 1))
        # ascending allocation order (pop() from the tail): determinism
        # the tests and the flight ring rely on
        self._free: List[int] = list(range(self.blocks - 1, 0, -1))
        self._ref = [0] * self.blocks
        # (prev block id | 0 at the root, block token tuple) -> block id
        self._trie: Dict[Tuple[int, tuple], int] = {}
        self._key_of: Dict[int, Tuple[int, tuple]] = {}
        # refcount-0 blocks still resident in the trie: block id ->
        # retire stamp (monotonic clock; min stamp = LRU). A chain
        # retires parent-before-child, so the LRU leaf is the oldest
        # conversation's deepest suffix — the eviction order
        self._retained: Dict[int, int] = {}
        self._rclock = 0
        # trie-resident children per parent block id (leaf test for
        # eviction); root (0) is not tracked
        self._children: Dict[int, int] = {}
        # serializes reservation+eviction+release (see module doc)
        self._lock = lockrank.lock("kvblocks.evict")
        # lifetime tallies (the cxxnet_decode_kv_block_* series) —
        # counted at admission SUCCESS only: a deferred ask retries
        # and must tally once, not once per attempt (alloc_failures
        # counts the defers), and the hit-rate denominator
        # (prompt_tokens) must hold only tokens that actually admitted
        self.prefix_queries = 0      # admissions completed
        self.prefix_hits = 0         # admissions that reused >= 1 token
        self.prefix_hit_tokens = 0   # prompt tokens NOT re-prefilled
        self.prompt_tokens = 0       # prompt tokens admitted
        self.cow_copies = 0          # copy-on-write block demotions
        self.alloc_failures = 0      # admissions deferred on exhaustion
        self.retained_hits = 0       # admissions served from retained
        self.retained_hit_tokens = 0  # hit tokens beyond the live chain
        self.retained_evictions = 0  # retained blocks recycled

    # -- geometry ------------------------------------------------------
    @property
    def usable(self) -> int:
        """Allocatable blocks (the scratch block excluded)."""
        return self.blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks not on the free list (live + retained)."""
        return self.usable - len(self._free)

    @property
    def retained_blocks(self) -> int:
        return len(self._retained)

    @property
    def live_blocks(self) -> int:
        """Blocks held by a live (refcount > 0) sequence."""
        return self.used_blocks - len(self._retained)

    @property
    def available_blocks(self) -> int:
        """Admissible headroom: free plus cascade-evictable retained
        blocks. The per-request form (``reservable``) subtracts the
        request's OWN pinned chain — the shared blocks it is about to
        revive and its CoW gather source fund nothing."""
        return len(self._free) + len(self._retained)

    def blocks_for(self, plen: int, n_new: int) -> int:
        """Blocks a (prompt, budget) sequence can ever write: cache
        rows [0, plen + n_new - 1) — the final generated token is
        returned but its K/V row is never written (no later step reads
        it)."""
        rows = max(1, int(plen) + max(1, int(n_new)) - 1)
        return -(-rows // self.bs)

    def fits(self, plen: int, n_new: int) -> bool:
        """Whether the sequence can EVER be admitted (vs the whole
        pool) — False is a deterministic request defect, not a wait."""
        return self.blocks_for(plen, n_new) <= self.usable

    # -- prefix trie ---------------------------------------------------
    def match_prefix(self, toks: Sequence[int]) -> List[int]:
        """Resident blocks covering the prompt's full-block prefix —
        the chain of content-matched FULL blocks from the root. No
        refcounts move (``admit`` does that)."""
        if not self.prefix_reuse:
            return []
        out: List[int] = []
        prev = 0
        bs = self.bs
        for j in range(len(toks) // bs):
            key = (prev, tuple(int(t) for t in toks[j * bs:(j + 1) * bs]))
            b = self._trie.get(key)
            if b is None:
                break
            out.append(b)
            prev = b
        return out

    def fresh_need(self, plen: int, n_new: int,
                   toks: Optional[Sequence[int]] = None) -> int:
        """Blocks ``admit`` would pull OFF THE FREE LIST right now —
        total need minus the resident shared prefix (with ``toks``),
        CoW demotion included. A scheduler budgets queue pops against
        this (single mutating owner, so check-then-admit is
        race-free)."""
        shared = len(self.match_prefix(toks)) if toks is not None else 0
        need = self.blocks_for(plen, n_new)
        if shared * self.bs >= plen:
            shared -= 1       # the CoW demotion needs a fresh target
        return need - max(0, shared)

    def _pinned(self, shared: List[int], cow_src: Optional[int]) -> int:
        """Retained blocks this admission itself pins: the chain it is
        about to revive plus a retained CoW gather source — they cannot
        be evicted to fund the same admission's fresh need."""
        n = sum(1 for b in shared if b in self._retained)
        if cow_src is not None and cow_src in self._retained:
            n += 1
        return n

    def reservable(self, plen: int, n_new: int,
                   toks: Optional[Sequence[int]] = None) -> bool:
        """Whether ``admit`` would succeed RIGHT NOW — the admission
        gate. With ``toks`` the shared prefix is credited. Retained
        blocks count as headroom (evict-before-defer): False means
        live + reserved blocks alone exceed the pool."""
        shared = self.match_prefix(toks) if toks is not None else []
        cow_src = None
        if shared and len(shared) * self.bs >= plen:
            cow_src = shared.pop()
        need = self.blocks_for(plen, n_new) - len(shared)
        return need <= (len(self._free) + len(self._retained)
                        - self._pinned(shared, cow_src))

    # -- reserve / release ---------------------------------------------
    def admit(self, toks: Sequence[int],
              n_new: int) -> Optional[AdmitTicket]:
        """Reserve every block for (prompt, generation budget): shared
        full-prefix blocks are refcounted (a retained match is REVIVED:
        refcount 0 -> 1, a retained hit), the rest come off the free
        list — evicting retained LRU leaves when it runs dry, atomically
        under the admission lock. Returns None only when live + reserved
        blocks alone exceed the pool (nothing moves — the caller defers:
        a deterministic queue-wait, never a device OOM)."""
        with self._lock:
            return self._admit(toks, n_new)

    def _admit(self, toks: Sequence[int],
               n_new: int) -> Optional[AdmitTicket]:
        plen = len(toks)
        if plen < 1:
            raise ValueError("kvblocks: empty prompt")
        need = self.blocks_for(plen, n_new)
        if need > self.usable:
            raise ValueError(
                "kvblocks: sequence needs %d blocks, pool holds %d — "
                "gate this at admits() (it can never fit)"
                % (need, self.usable))
        shared = self.match_prefix(toks)
        cow_src = None
        if shared and len(shared) * self.bs >= plen:
            # block-aligned full coverage: the last prompt position
            # must be recomputed (its first-token logits are not
            # stored), and that write may not land in a shared block —
            # demote the last match to a gather source (CoW)
            cow_src = shared.pop()
        fresh_need = need - len(shared)
        if fresh_need > (len(self._free) + len(self._retained)
                         - self._pinned(shared, cow_src)):
            self.alloc_failures += 1
            return None
        self.prefix_queries += 1
        p0 = (plen - 1) if cow_src is not None else len(shared) * self.bs
        if p0 > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += p0
        # retained sub-source of the hit: tokens of [0, p0) beyond the
        # LIVE-held chain came from retained content (revived blocks
        # and/or a retained CoW source). Live blocks form a chain
        # PREFIX — a live block's ancestors are all live — so the
        # boundary is the first retained block in the chain.
        chain = shared + ([cow_src] if cow_src is not None else [])
        n_live = 0
        for b in chain:
            if b in self._retained:
                break
            n_live += 1
        rtoks = max(0, p0 - n_live * self.bs)
        if rtoks > 0:
            self.retained_hits += 1
            self.retained_hit_tokens += rtoks
        if cow_src is not None:
            self.cow_copies += 1
        self.prompt_tokens += plen
        for b in shared:
            if b in self._retained:
                del self._retained[b]     # revival: refcount 0 -> 1
            self._ref[b] += 1
        fresh: List[int] = []
        for _ in range(fresh_need):
            if not self._free:
                # evict-before-defer: recycle the LRU retained leaf.
                # The revived chain already left the retained pool;
                # only the CoW gather source still needs pinning (its
                # content is gathered by THIS admission's prefill).
                self._evict_one(exclude=cow_src)
            fresh.append(self._free.pop())
        for b in fresh:
            self._ref[b] = 1
        ids = shared + fresh
        gather_ids = list(ids)
        if cow_src is not None:
            # gather the shared content, write back to the fresh copy
            gather_ids[len(shared)] = cow_src
        return AdmitTicket(ids, gather_ids, p0)

    def register(self, ticket: AdmitTicket,
                 toks: Sequence[int]) -> None:
        """Publish the admission's FULL prompt blocks into the trie
        (call after its prefill succeeded — a faulted prefill's blocks
        hold garbage and must stay unfindable). An existing entry wins:
        a copy-on-write twin is not re-registered under the same
        content (its source already serves lookups)."""
        if not self.prefix_reuse:
            return
        with self._lock:
            prev = 0
            bs = self.bs
            for j in range(len(toks) // bs):
                b = ticket.ids[j]
                key = (prev,
                       tuple(int(t) for t in toks[j * bs:(j + 1) * bs]))
                cur = self._trie.get(key)
                if cur is None:
                    self._trie[key] = b
                    self._key_of[b] = key
                    if prev:
                        self._children[prev] = \
                            self._children.get(prev, 0) + 1
                    cur = b
                prev = cur

    def free(self, ids: Sequence[int]) -> None:
        """Release one holder's blocks (retire / deadline-evict /
        close): refcounts drop; a REGISTERED block reaching zero moves
        to the retained pool (trie key kept — the conversation cache),
        an unregistered one returns to the free list. The account is
        exact at every instant: live + retained + free == pool."""
        with self._lock:
            for b in ids:
                if not 1 <= b < self.blocks:
                    raise ValueError("kvblocks: bad block id %r" % (b,))
                self._ref[b] -= 1
                if self._ref[b] < 0:
                    raise ValueError(
                        "kvblocks: double free of block %d" % b)
                if self._ref[b] != 0:
                    continue
                if self.retained_cap > 0 and b in self._key_of:
                    # retain: keep the trie entry, stamp the LRU clock
                    # (ids arrive in position order, so a chain stamps
                    # parent-before-child and the LRU leaf is the
                    # oldest conversation's deepest suffix)
                    self._rclock += 1
                    self._retained[b] = self._rclock
                else:
                    self._drop_key(b)
                    self._free.append(b)
            # cap AFTER the whole release landed: a parent is never
            # dropped from the trie before its child is accounted, so
            # the leaf rule sees the finished chain
            while len(self._retained) > self.retained_cap:
                self._evict_one()

    # -- retained pool --------------------------------------------------
    def _drop_key(self, b: int) -> None:
        """Remove ``b``'s trie entry (if any) and its parent's child
        count — the bookkeeping shared by instant-free and eviction."""
        key = self._key_of.pop(b, None)
        if key is None:
            return
        if self._trie.get(key) == b:
            del self._trie[key]
        prev = key[0]
        if prev:
            c = self._children.get(prev, 0) - 1
            if c > 0:
                self._children[prev] = c
            else:
                self._children.pop(prev, None)

    def _evict_one(self, exclude: Optional[int] = None) -> int:
        """Recycle the LRU retained LEAF (no trie-resident descendant)
        onto the free list. Always succeeds on a nonempty retained pool
        (minus ``exclude``): retained blocks never have live
        descendants, so every retained chain bottoms out in a retained
        leaf — eviction cannot wedge against reservation."""
        best = None
        best_stamp = 0
        for b, stamp in self._retained.items():
            if b == exclude or self._children.get(b, 0):
                continue
            if best is None or stamp < best_stamp:
                best, best_stamp = b, stamp
        if best is None:
            raise AssertionError(
                "kvblocks: no evictable retained leaf (%d retained) — "
                "the leaf invariant is broken" % len(self._retained))
        del self._retained[best]
        self._drop_key(best)
        self._free.append(best)
        self.retained_evictions += 1
        return best

    def evict_retained(self, n: Optional[int] = None,
                       target_free: Optional[int] = None) -> int:
        """Proactively shed retained mass (a scheduler's low-
        headroom pressure latch): evict LRU leaves until ``n`` blocks are
        recycled and/or the free list reaches ``target_free`` (with
        neither bound, drain the whole retained pool). Returns the
        number of blocks evicted."""
        with self._lock:
            done = 0
            while self._retained:
                if n is not None and done >= n:
                    break
                if target_free is not None \
                        and len(self._free) >= target_free:
                    break
                self._evict_one()
                done += 1
            return done

    # -- account / invariants ------------------------------------------
    def account(self) -> dict:
        return {"blocks_total": self.usable,
                "blocks_free": len(self._free),
                "blocks_used": self.used_blocks,
                "blocks_live": self.live_blocks,
                "blocks_retained": len(self._retained),
                "retained_cap": self.retained_cap,
                "block_tokens": self.bs,
                "prefix_queries": self.prefix_queries,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prompt_tokens": self.prompt_tokens,
                "cow_copies": self.cow_copies,
                "alloc_failures": self.alloc_failures,
                "retained_hits": self.retained_hits,
                "retained_hit_tokens": self.retained_hit_tokens,
                "retained_evictions": self.retained_evictions}

    def books_law(self) -> Optional[str]:
        """The pool's conservation law,
        ``live + retained + free == pool``, evaluated atomically under
        the allocator lock. Returns None when the books reconcile, a
        detail string when they do not; never raises."""
        with self._lock:
            free = len(self._free)
            retained = len(self._retained)
            live = sum(1 for b in range(1, self.blocks)
                       if self._ref[b] > 0)
            if live + retained + free == self.usable:
                return None
            return ("kv blocks leak: live %d + retained %d + free %d "
                    "!= pool %d" % (live, retained, free, self.usable))

    def check(self) -> None:
        """Assert every structural invariant (the test suite's oracle
        after chaos-ordered admit/free interleavings)."""
        assert self._ref[0] == 0, "scratch block acquired a refcount"
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicates"
        assert 0 not in free, "scratch block on the free list"
        retained = set(self._retained)
        assert not (free & retained), \
            "blocks both free and retained: %r" % sorted(free & retained)
        live = 0
        for b in range(1, self.blocks):
            if b in free:
                assert self._ref[b] == 0, \
                    "block %d free with refcount %d" % (b, self._ref[b])
            elif b in retained:
                assert self._ref[b] == 0, \
                    "retained block %d holds refcount %d" \
                    % (b, self._ref[b])
                assert b in self._key_of, \
                    "retained block %d has no trie key" % b
            else:
                assert self._ref[b] > 0, \
                    "block %d leaked (neither free, retained nor held)" \
                    % b
                live += 1
        # the books reconcile, always: live + retained + free == pool
        assert live + len(retained) + len(free) == self.usable, \
            "books broken: live %d + retained %d + free %d != pool %d" \
            % (live, len(retained), len(free), self.usable)
        assert len(retained) <= self.retained_cap, \
            "retained pool over cap: %d > %d" \
            % (len(retained), self.retained_cap)
        children: Dict[int, int] = {}
        for key, b in self._trie.items():
            assert self._ref[b] > 0 or b in retained, \
                "trie points at dead block %d" % b
            assert self._key_of.get(b) == key, \
                "trie/_key_of disagree on block %d" % b
            prev = key[0]
            if prev:
                # chain integrity: a resident child's parent must be
                # resident too (the leaf-only eviction rule's contract)
                assert prev in self._key_of, \
                    "block %d's trie parent %d left the trie" % (b, prev)
                children[prev] = children.get(prev, 0) + 1
                # and a live child can never hang off a retained
                # parent (admit refcounts the whole chain)
                if self._ref[b] > 0:
                    assert prev not in retained, \
                        "live block %d under retained parent %d" \
                        % (b, prev)
        assert children == self._children, \
            "child counts drifted: %r != %r" % (children, self._children)
        for b, key in self._key_of.items():
            assert self._trie.get(key) == b
