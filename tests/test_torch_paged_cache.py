"""paddle_tpu_torch PagedKVCache against paddle_tpu's: the same sequence
of operations (add, extend, commit, match, COW, free, park, evict,
truncate) must leave EXACTLY equal block tables, refcounts, prefix
matches, LRU order and copied page contents."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.inference import PagedKVCache as JaxCache
from paddle_tpu_torch.inference import BlockAllocator, PagedKVCache

BS, NB, L, KVH, D = 4, 12, 2, 1, 8


def _pair(caching=True):
    j = JaxCache(L, NB, KVH, BS, D, dtype=jnp.float32, layout="token",
                 enable_prefix_caching=caching)
    t = PagedKVCache(L, NB, KVH, BS, D, dtype=torch.float32, layout="token",
                     enable_prefix_caching=caching, device="cpu")
    return j, t


def _snap(c, seqs):
    return {
        "pages": {s: c.pages(s) for s in seqs},
        "lengths": {s: c.length(s) for s in seqs},
        "committed": {s: c.cached_prefix_len(s) for s in seqs},
        "refcounts": [c.allocator.refcount(b) for b in range(NB)],
        "num_free": c.allocator.num_free,
        "lru": list(c._lru),
        "index": sorted(c._page_hash.items()),
        "available": c.available_blocks,
    }


def _pools(c):
    return [np.asarray(a) for a in c.key_caches + c.value_caches]


def _fill(j, t, rng):
    """Give every pool row distinct content in both caches."""
    for li in range(L):
        for caches_j, caches_t in ((j.key_caches, t.key_caches),
                                   (j.value_caches, t.value_caches)):
            val = rng.standard_normal((NB * BS, KVH, D)).astype(np.float32)
            caches_j[li] = jnp.asarray(val)
            caches_t[li].copy_(torch.from_numpy(val))


@pytest.mark.parametrize("caching", [True, False])
def test_same_operations_same_state(caching):
    j, t = _pair(caching)
    rng = np.random.default_rng(0)
    tok_a = rng.integers(0, 100, (14,)).astype(np.int32)
    tok_b = np.concatenate([tok_a[:9], rng.integers(0, 100, (4,))]).astype(
        np.int32)
    live = []

    def both(fn):
        rj, rt = fn(j), fn(t)
        assert rj == rt
        assert _snap(j, live) == _snap(t, live)
        return rj

    live.append("a")
    assert both(lambda c: c.add_sequence("a", len(tok_a), tokens=tok_a)) == 0
    both(lambda c: c.commit_prefix("a", tok_a))
    both(lambda c: c.match_prefix(tok_b))
    both(lambda c: c.prefix_plan(tok_b, len(tok_b)))
    live.append("b")
    hit = both(lambda c: c.add_sequence("b", len(tok_b), tokens=tok_b))
    assert hit == (8 if caching else 0)
    both(lambda c: c.extend("b", 6))
    # copy-on-write of the shared pages from token 4 on
    _fill(j, t, rng)
    both(lambda c: c.ensure_writable("b", 4))
    for pj, ptt in zip(_pools(j), _pools(t)):
        np.testing.assert_array_equal(pj, ptt)
    both(lambda c: c.commit_prefix("b", np.concatenate(
        [tok_b, np.arange(6, dtype=np.int32)]), upto=16))
    live.remove("a")
    both(lambda c: c.free_sequence("a"))          # parks indexed pages
    both(lambda c: c.match_prefix(tok_a))
    # a big lease evicts parked pages, oldest first
    live.append("c")
    both(lambda c: c.add_sequence("c", 6 * BS))
    both(lambda c: c.truncate("c", 2 * BS + 1))
    both(lambda c: c.block_table(["b", "c"]).tolist())
    with pytest.raises(MemoryError):
        j.add_sequence("d", NB * BS)
    with pytest.raises(MemoryError):
        t.add_sequence("d", NB * BS)
    assert _snap(j, live) == _snap(t, live)
    for s in ("b", "c"):
        live.remove(s)
        both(lambda c, s=s: c.free_sequence(s))
    assert t.available_blocks == NB


def test_allocator_rejects_bad_frees_all_or_nothing():
    a = BlockAllocator(4)
    blks = a.alloc(2)
    a.ref([blks[0]])
    with pytest.raises(ValueError, match="invalid free"):
        a.free([blks[1], blks[1]])
    assert a.refcount(blks[1]) == 1 and a.num_free == 2
    with pytest.raises(MemoryError):
        a.alloc(3)
    assert a.num_free == 2
