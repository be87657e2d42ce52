"""Paged KV-cache manager (counterpart of paddle_tpu/inference/paged_cache.py).

The device holds ONE fixed pool of physical cache blocks per layer,
token-major ([num_blocks*block_size, kv_heads, head_dim] torch tensors;
block b's slot s lives at row b*block_size+s). Sequences lease pages
from the native C++ refcounting free-list allocator
(_block_allocator.cpp, the same source and C ABI as paddle_tpu's,
loaded through ctypes), and the manager renders int32 block tables.
Pool tensors never move; only the page accounting changes.

Automatic prefix caching (enable_prefix_caching=True): full token
blocks are content-addressed with a chained hash, so a sequence whose
prompt shares a page-aligned prefix with earlier traffic leases the
existing pages at +1 refcount. Pages of finished sequences park in an
LRU and are evicted only when an allocation would otherwise fail.
Shared pages are never written: `ensure_writable` copies any page other
sequences still reference before the engine writes into it.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import to_dtype

__all__ = ["BlockAllocator", "PagedKVCache"]

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from ..utils.build import GXX_FLAGS, build_shared
        here = os.path.dirname(os.path.abspath(__file__))
        lib = ctypes.CDLL(build_shared(
            "paged_block_allocator", [os.path.join(here,
                                                   "_block_allocator.cpp")],
            "g++", GXX_FLAGS))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pba_create.restype = ctypes.c_void_p
        lib.pba_create.argtypes = [ctypes.c_int32]
        lib.pba_destroy.restype = None
        lib.pba_destroy.argtypes = [ctypes.c_void_p]
        lib.pba_alloc.restype = ctypes.c_int32
        lib.pba_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32p]
        lib.pba_free.restype = ctypes.c_int32
        lib.pba_free.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
        lib.pba_ref.restype = ctypes.c_int32
        lib.pba_ref.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
        lib.pba_refcount.restype = ctypes.c_int32
        lib.pba_refcount.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.pba_num_free.restype = ctypes.c_int32
        lib.pba_num_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class BlockAllocator:
    """ctypes facade over the native refcounting free-list allocator.

    `alloc` leases blocks at refcount 1; `ref` adds sharers; `free` is
    unref (a block returns to the free list at count zero). Invalid
    mutations raise ValueError and leave the native free list untouched
    (the native side validates all-or-nothing)."""

    def __init__(self, num_blocks: int):
        self._lib = _load_lib()
        self._h = self._lib.pba_create(num_blocks)
        if not self._h:
            raise ValueError(f"invalid pool size {num_blocks}")
        self.num_blocks = num_blocks

    def alloc(self, n: int) -> List[int]:
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.pba_alloc(self._h, n, out) != 0:
            raise MemoryError(
                f"paged KV cache out of blocks (wanted {n}, free "
                f"{self.num_free})")
        return list(out[:n])

    def free(self, blocks: List[int]) -> int:
        """Unref `blocks`; returns how many were unref'd. Raises
        ValueError on double free / unknown id, with nothing applied."""
        if not blocks:
            return 0
        arr = (ctypes.c_int32 * len(blocks))(*blocks)
        rc = self._lib.pba_free(self._h, arr, len(blocks))
        if rc < 0:
            bad = blocks[-rc - 1]
            raise ValueError(
                f"invalid free of block {bad}: not allocated, out of "
                f"range, or freed more times than its refcount "
                f"({self.refcount(bad)}) allows — nothing was freed")
        return len(blocks)

    def ref(self, blocks: List[int]) -> None:
        """Add one reference to each (already allocated) block."""
        if not blocks:
            return
        arr = (ctypes.c_int32 * len(blocks))(*blocks)
        rc = self._lib.pba_ref(self._h, arr, len(blocks))
        if rc < 0:
            raise ValueError(
                f"invalid ref of block {blocks[-rc - 1]}: not "
                "allocated or out of range — nothing was ref'd")

    def refcount(self, block: int) -> int:
        """Current reference count (0 = free; -1 = out of range)."""
        return self._lib.pba_refcount(self._h, block)

    @property
    def num_free(self) -> int:
        return self._lib.pba_num_free(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pba_destroy(h)
            self._h = None


class PagedKVCache:
    """Per-layer token-major K/V pools + per-sequence page tables.

    Only paddle_tpu's layout="token" exists here (the layout its
    LLMEngine uses); "block" raises. device: None = the CUDA card."""

    def __init__(self, num_layers: int, num_blocks: int, kv_heads: int,
                 block_size: int, head_dim: int, dtype=torch.bfloat16,
                 layout: str = "token",
                 enable_prefix_caching: bool = False, device=None):
        if layout != "token":
            raise NotImplementedError(
                f"layout {layout!r}: the port keeps token-major pools only")
        self.num_layers = num_layers
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.layout = layout
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)
        self.enable_prefix_caching = bool(enable_prefix_caching)
        shape = (num_blocks * block_size, kv_heads, head_dim)
        dt = to_dtype(dtype)
        self.key_caches = [torch.zeros(shape, dtype=dt, device=self.device)
                           for _ in range(num_layers)]
        self.value_caches = [torch.zeros(shape, dtype=dt,
                                         device=self.device)
                             for _ in range(num_layers)]
        self._pages: Dict[object, List[int]] = {}
        self._lengths: Dict[object, int] = {}
        # prefix index: chained block hash -> physical page (and back),
        # plus the LRU of parked pages (refcount held BY the LRU; a
        # matched page leaves the LRU and its reference transfers to the
        # leasing sequence)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._lru: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        # per-live-sequence committed chain (incremental hashing)
        self._seq_hashes: Dict[object, List[bytes]] = {}

    # -- prefix index ------------------------------------------------------
    @staticmethod
    def _block_hash(parent: bytes, block_tokens) -> bytes:
        """Chained content hash of one FULL token block (parent chain
        digest + this block's int32 tokens)."""
        raw = np.ascontiguousarray(block_tokens, np.int32).tobytes()
        return hashlib.sha256(parent + raw).digest()

    def block_hashes(self, tokens) -> List[bytes]:
        """The chained-hash sequence of `tokens`' matchable blocks
        ((len-1)//block_size of them)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        out: List[bytes] = []
        h = b""
        for i in range(max(0, len(tokens) - 1) // bs):
            h = self._block_hash(h, tokens[i * bs:(i + 1) * bs])
            out.append(h)
        return out

    def match_prefix(self, tokens,
                     hashes: Optional[List[bytes]] = None
                     ) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of `tokens` (peek — no
        refcounts change), capped at len(tokens)-1. Returns
        (ncached_tokens, pages)."""
        if not self.enable_prefix_caching:
            return 0, []
        if hashes is None:
            hashes = self.block_hashes(tokens)
        pages: List[int] = []
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None:
                break
            pages.append(page)
        return len(pages) * self.block_size, pages

    def prefix_plan(self, tokens, total_tokens: int,
                    hashes: Optional[List[bytes]] = None
                    ) -> Tuple[int, bool, List[int]]:
        """Admission feasibility under prefix caching: (ncached_tokens,
        feasible, matched_pages). Matched pages that are parked do not
        count as evictable headroom (leasing them takes them out of the
        LRU)."""
        need = -(-total_tokens // self.block_size)
        if not self.enable_prefix_caching or tokens is None:
            return 0, need <= self.allocator.num_free, []
        ncached, pages = self.match_prefix(tokens, hashes)
        parked_matched = sum(1 for p in pages if p in self._lru)
        avail = (self.allocator.num_free + len(self._lru)
                 - parked_matched)
        return ncached, need - len(pages) <= avail, pages

    def _lease_prefix(self, tokens, match=None):
        """match_prefix + take the references: parked pages leave the
        LRU (their reference transfers), active pages gain one."""
        ncached, pages = (self.match_prefix(tokens) if match is None
                          else match)
        hashes: List[bytes] = [self._page_hash[p] for p in pages]
        for p in pages:
            if p in self._lru:
                del self._lru[p]
            else:
                self.allocator.ref([p])
        return ncached, pages, hashes

    def _release_pages(self, pages: List[int]) -> None:
        """Drop one reference per page; a hash-indexed page whose last
        holder this was parks in the LRU instead of freeing."""
        if not self.enable_prefix_caching:
            self.allocator.free(pages)
            return
        unref = []
        for p in pages:
            h = self._page_hash.get(p)
            if h is not None and self.allocator.refcount(p) == 1:
                self._lru[p] = h
            else:
                unref.append(p)
        self.allocator.free(unref)

    def _alloc(self, n: int) -> List[int]:
        """Allocate n blocks, evicting least-recently-parked pages only
        when the free list alone cannot satisfy the request."""
        free = self.allocator.num_free
        while free < n and self._lru:
            page, h = self._lru.popitem(last=False)
            del self._hash_to_page[h]
            del self._page_hash[page]
            self.allocator.free([page])
            free += 1
        return self.allocator.alloc(n)

    def commit_prefix(self, seq_id, tokens, upto: Optional[int] = None
                      ) -> None:
        """Register this sequence's FULL, fully-written blocks in the
        prefix index (idempotent, incremental; first writer of a hash
        wins)."""
        if not self.enable_prefix_caching:
            return
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = len(tokens) if upto is None else min(int(upto), len(tokens))
        n = min(n, self._lengths[seq_id])
        pages = self._pages[seq_id]
        hashes = self._seq_hashes.setdefault(seq_id, [])
        bs = self.block_size
        n_full = min(n // bs, len(pages))
        for i in range(len(hashes), n_full):
            parent = hashes[i - 1] if i else b""
            h = self._block_hash(parent, tokens[i * bs:(i + 1) * bs])
            hashes.append(h)
            page = pages[i]
            if h in self._hash_to_page or page in self._page_hash:
                continue
            self._hash_to_page[h] = page
            self._page_hash[page] = h

    def ensure_writable(self, seq_id, from_token: int) -> None:
        """Copy-on-write guard: every page backing positions >=
        from_token must be exclusively owned and unindexed before the
        engine writes into it. A page other sequences still reference is
        copied into a fresh block in every layer and swapped into this
        sequence's table; an exclusively owned indexed page is
        unindexed."""
        if not self.enable_prefix_caching:
            return
        pages = self._pages[seq_id]
        start = max(0, int(from_token)) // self.block_size
        hashes = self._seq_hashes.get(seq_id)
        if hashes is not None:
            del hashes[start:]
        for i in range(start, len(pages)):
            p = pages[i]
            if self.allocator.refcount(p) > 1:
                (fresh,) = self._alloc(1)
                self._copy_block(p, fresh)
                self._release_pages([p])
                pages[i] = fresh
            elif p in self._page_hash:
                h = self._page_hash.pop(p)
                self._hash_to_page.pop(h, None)
                self._lru.pop(p, None)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one page's rows in every layer, in place."""
        bs = self.block_size
        for caches in (self.key_caches, self.value_caches):
            for arr in caches:
                arr[dst * bs:(dst + 1) * bs] = arr[src * bs:(src + 1) * bs]

    # -- capacity views ----------------------------------------------------
    @property
    def available_blocks(self) -> int:
        """Blocks an alloc could obtain: free + evictable parked pages."""
        return self.allocator.num_free + len(self._lru)

    # -- sequence lifecycle --
    def add_sequence(self, seq_id, num_tokens: int = 0,
                     tokens=None, match=None) -> int:
        """Register a sequence and lease pages for `num_tokens`, taking
        the longest cached prefix first when prefix caching is on and
        `tokens` is given. Returns the prefix tokens leased from cache."""
        if seq_id in self._pages:
            raise ValueError(f"sequence {seq_id!r} already exists")
        ncached, leased, hashes = 0, [], []
        if self.enable_prefix_caching and tokens is not None \
                and num_tokens:
            ncached, leased, hashes = self._lease_prefix(tokens, match)
        self._pages[seq_id] = list(leased)
        self._lengths[seq_id] = ncached
        self._seq_hashes[seq_id] = list(hashes)
        if num_tokens > ncached:
            try:
                self.extend(seq_id, num_tokens - ncached)
            except MemoryError:
                # roll back so the scheduler can retry the same seq_id
                pages = self._pages.pop(seq_id)
                del self._lengths[seq_id]
                del self._seq_hashes[seq_id]
                self._release_pages(pages)
                raise
        return ncached

    def extend(self, seq_id, num_tokens: int) -> None:
        """Lease enough pages for `num_tokens` more tokens."""
        pages = self._pages[seq_id]
        new_len = self._lengths[seq_id] + num_tokens
        need = -(-new_len // self.block_size) - len(pages)
        if need > 0:
            pages.extend(self._alloc(need))
        self._lengths[seq_id] = new_len

    def truncate(self, seq_id, num_tokens: int) -> int:
        """Shrink the leased length to `num_tokens`, unref'ing every
        page past it (never below the committed prefix). Returns the
        number of pages released."""
        new_len = int(num_tokens)
        cur_len = self._lengths[seq_id]
        if new_len > cur_len:
            raise ValueError(
                f"truncate({seq_id!r}, {new_len}): sequence only "
                f"holds {cur_len} tokens (use extend to grow)")
        if new_len < self.cached_prefix_len(seq_id):
            raise ValueError(
                f"truncate({seq_id!r}, {new_len}): cannot roll back "
                f"below the committed prefix "
                f"({self.cached_prefix_len(seq_id)} tokens) — "
                "committed blocks are shared prefix-cache state")
        pages = self._pages[seq_id]
        keep = -(-new_len // self.block_size) if new_len else 0
        dropped = pages[keep:]
        del pages[keep:]
        self._lengths[seq_id] = new_len
        self._release_pages(dropped)
        return len(dropped)

    def free_sequence(self, seq_id) -> None:
        pages = self._pages.pop(seq_id)
        del self._lengths[seq_id]
        self._seq_hashes.pop(seq_id, None)
        self._release_pages(pages)

    def length(self, seq_id) -> int:
        return self._lengths[seq_id]

    def cached_prefix_len(self, seq_id) -> int:
        """Committed-chain length in tokens (full blocks only)."""
        return len(self._seq_hashes.get(seq_id, ())) * self.block_size

    def pages(self, seq_id) -> List[int]:
        """The physical block ids this sequence currently leases."""
        return list(self._pages[seq_id])

    def block_table(self, seq_ids, max_pages: Optional[int] = None):
        """[len(seq_ids), max_pages] int32 tensor on the pool's device,
        -1-padded."""
        rows = [self._pages[s] for s in seq_ids]
        width = max(max_pages or max((len(r) for r in rows), default=1), 1)
        for s, r in zip(seq_ids, rows):
            if len(r) > width:
                raise ValueError(
                    f"sequence {s!r} holds {len(r)} pages but "
                    f"max_pages={width}")
        tbl = np.full((len(rows), width), -1, np.int32)
        for i, r in enumerate(rows):
            tbl[i, :len(r)] = r
        return torch.from_numpy(tbl).to(self.device)

    def export_pages(self, *args, **kwargs):
        raise NotImplementedError(
            "KV-page export/import (disaggregated serving) is not ported "
            "yet")

    import_pages = export_pages
