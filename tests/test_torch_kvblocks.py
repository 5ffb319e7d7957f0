"""The port's block allocator (cxxnet_tpu_torch/utils/kvblocks.py), the host
half of the paged decode cache, against the JAX package's
(cxxnet_tpu/utils/kvblocks.py): the same seeded sequences of calls go to
both, and every ticket (block ids, gather ids, reuse offset), every
``admit`` that defers, every query (``match_prefix``, ``fresh_need``,
``reservable``, ``fits``), ``account()``, ``books_law()`` and the free list
must be equal after every call, with ``check()`` passing on both. The
allocator is plain Python on both sides, so the bar is equality.

The sequences draw prompts from a few shared system prefixes and a small
alphabet, so that full-block prefix hits, block-aligned copy-on-write
twins, retained revivals, evictions and deferrals all occur; the last test
asserts that they did.
"""

import numpy as np
import pytest

from cxxnet_tpu.utils import kvblocks as jkv
from cxxnet_tpu_torch.utils import kvblocks as tkv


def _prompt(rs, bs):
    """A prompt that often starts with one of three shared prefixes (some
    block-aligned, so whole prompts can match), from a 5-token alphabet."""
    prefixes = ([1] * bs, [2, 3] * bs, [4] * (2 * bs + 1))
    kind = rs.randint(0, 5)
    head = list(prefixes[kind]) if kind < 3 else []
    tail = rs.randint(0, 5, rs.randint(0 if head else 1, 2 * bs + 2))
    return head + [int(t) for t in tail]


def _same_state(a, b):
    assert a.account() == b.account()
    assert a.books_law() == b.books_law() is None
    assert a._free == b._free
    assert a._retained == b._retained
    a.check()
    b.check()


def _drive(seed, blocks, bs, prefix_reuse, retained_frac, steps=300):
    """Run one seeded call sequence through both allocators in lockstep;
    returns the port's allocator at the end."""
    rs = np.random.RandomState(seed)
    ja = jkv.BlockAllocator(blocks, bs, prefix_reuse=prefix_reuse,
                            retained_frac=retained_frac)
    ta = tkv.BlockAllocator(blocks, bs, prefix_reuse=prefix_reuse,
                            retained_frac=retained_frac)
    live = []
    for _ in range(steps):
        op = rs.randint(0, 10)
        if op < 5 or not live:
            toks = _prompt(rs, bs)
            n_new = int(rs.randint(1, 2 * bs))
            assert ta.fits(len(toks), n_new) == ja.fits(len(toks), n_new)
            if not ta.fits(len(toks), n_new):
                continue
            assert ta.match_prefix(toks) == ja.match_prefix(toks)
            assert ta.fresh_need(len(toks), n_new, toks) == \
                ja.fresh_need(len(toks), n_new, toks)
            assert ta.reservable(len(toks), n_new, toks) == \
                ja.reservable(len(toks), n_new, toks)
            tt, jt = ta.admit(toks, n_new), ja.admit(toks, n_new)
            assert (tt is None) == (jt is None)
            if tt is not None:
                assert (tt.ids, tt.gather_ids, tt.p0) == \
                    (jt.ids, jt.gather_ids, jt.p0)
                if rs.rand() < 0.9:        # a faulted prefill never registers
                    ta.register(tt, toks)
                    ja.register(jt, toks)
                live.append(tt.ids)
        elif op < 9:
            ids = live.pop(rs.randint(0, len(live)))
            ta.free(ids)
            ja.free(ids)
        else:
            n = int(rs.randint(0, 3))
            assert ta.evict_retained(n=n) == ja.evict_retained(n=n)
        _same_state(ta, ja)
    for ids in live:
        ta.free(ids)
        ja.free(ids)
    _same_state(ta, ja)
    assert ta.live_blocks == 0
    return ta


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("blocks, bs, prefix_reuse, retained_frac", [
    (17, 4, True, 1.0), (9, 2, True, 0.5), (33, 3, True, 0.0),
    (12, 4, False, 1.0)])
def test_same_calls_give_the_same_blocks_and_books(seed, blocks, bs,
                                                   prefix_reuse,
                                                   retained_frac):
    _drive(seed, blocks, bs, prefix_reuse, retained_frac)


def test_sequences_reach_every_path():
    """Across the seeds, the sequences above hit prefixes, copy on write,
    revive retained blocks, evict them and defer admissions: the equality
    covers each of those paths."""
    tallies = {}
    for seed in range(4):
        acct = _drive(seed, 17, 4, True, 1.0).account()
        for k in ("prefix_hits", "cow_copies", "retained_hits",
                  "retained_evictions", "alloc_failures"):
            tallies[k] = tallies.get(k, 0) + acct[k]
    assert all(v > 0 for v in tallies.values()), tallies


def test_errors_match():
    for mod in (jkv, tkv):
        with pytest.raises(ValueError):
            mod.BlockAllocator(1, 4)
        with pytest.raises(ValueError):
            mod.BlockAllocator(4, 0)
        a = mod.BlockAllocator(5, 2)
        with pytest.raises(ValueError, match="empty prompt"):
            a.admit([], 1)
        with pytest.raises(ValueError, match="can never fit"):
            a.admit(list(range(9)), 1)
        t = a.admit([1, 2, 3], 2)
        a.free(t.ids)
        with pytest.raises(ValueError, match="double free"):
            a.free(t.ids)
        with pytest.raises(ValueError, match="bad block id"):
            a.free([0])
    assert issubclass(tkv.KVPoolExhausted, RuntimeError)
