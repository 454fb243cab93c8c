"""Paged KV allocator: one page pool under the cross-request prefix cache.

Port of ``lir_tpu/models/paged.py`` (the allocator, the slot gather and
the page scatter). KV for a token prefix is stored in fixed-size PAGES
of ``page_size`` positions in one device-resident pool tensor pair, so a
prefix computed once backs any later dispatch that shares it. The radix
index over which token sequence owns which pages is
``engine/prefix_tree.py``; this module is the allocator:

- **Pool layout.** The decode cache is a (ck, cv) pair of (L, K, T, B,
  hd) tensors, or on an int8 KV cache a (payload (L, K, T, B, hd), scales
  (L, K, T, B)) pair each side (``models/decoder.init_cache``). The pool
  stores the same leaves with the (T, B) plane replaced by (n_pages,
  page_size): page p
  holds ``page_size`` consecutive token POSITIONS of one cached prefix,
  position 0 being the prefix's first token, so reuse does not depend on
  which dispatch produced the KV. The pool is allocated once, at its
  full size, on the engine's device.
- **Gather/scatter.** :func:`gather_slots` assembles a dense dispatch
  cache from a per-(row, slot) source table, slot by slot, so cached
  pages land at exactly the slots the right-padded prefill writes them
  to. :func:`scatter_pages` copies full pages out of a dispatch's final
  cache into the pool in place (the JAX package donates the pool to its
  jitted scatter; here the one resident pair is written by indexed
  assignment and never reallocated).
- **Refcounts.** Host-side per-page refcounts, never negative: the
  radix tree holds one reference per cached page, every in-flight
  dispatch one more per page it gathered, and eviction (LRU, driven by
  the tree) frees only pages whose sole reference is the tree's.

Page 0 is reserved as the trash page: slot-table entries that carry no
cached KV point at it (their slots are masked, and a masked key adds an
exact zero to the softmax), and the scatter's padding writes land there.

- **Migration legs.** :func:`extract_pages` gathers whole pages out of
  the pool (the export leg of serve/migrate.py) and :func:`insert_pages`
  writes blocks that arrived from another pool (the import leg), both
  in the pool's leaf order and layout (L, K, N, ps[, hd]).

Left out: ``CacheHandoff`` (XLA buffer donation, which eager PyTorch has
no use for).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .decoder import cache_leaves, cache_map

log = logging.getLogger(__name__)

# Cache axis convention (models/decoder.init_cache): (L, K, T, B, hd)
# payloads, (L, K, T, B) int8 scales — time axis 2, batch axis 3 in both.
TIME_AXIS = 2
DEFAULT_PAGE_SIZE = 16


def kv_page_bytes(cfg, page_size: int = DEFAULT_PAGE_SIZE,
                  dtype_bytes: int = 2) -> int:
    """Device bytes of ONE pool page, both sides: the unit a pool's size
    multiplies by ``n_pages`` (``decoder.kv_cache_bytes`` at one row and
    ``page_size`` slots; an int8 page holds payloads and float32
    scales)."""
    per_side = cfg.n_layers * cfg.n_kv_heads * page_size
    if getattr(cfg, "kv_cache_int8", False):
        return 2 * (per_side * cfg.head_dim + per_side * 4)
    return 2 * per_side * cfg.head_dim * dtype_bytes


def window_edges(bucket: int, page_size: int = DEFAULT_PAGE_SIZE
                 ) -> Tuple[int, ...]:
    """Remainder-window widths a paged dispatch at ``bucket`` may run:
    powers of two from one page up to (exclusive) the bucket itself.
    Every warm dispatch recomputes a ``window``-wide slice of its rows'
    prefixes, anchored at the dispatch's longest real row, and gathers
    everything before the window from the pool; a needed window >=
    bucket means nothing useful is cached and the dispatch runs the
    plain unpaged prefill instead."""
    out = []
    w = max(int(page_size), 8)
    while w < bucket:
        out.append(w)
        w *= 2
    return tuple(out)


def pick_window(needed: int, bucket: int,
                page_size: int = DEFAULT_PAGE_SIZE) -> Optional[int]:
    """Smallest window edge covering ``needed`` recompute tokens, or None
    when only the full-bucket (unpaged) prefill covers it."""
    for w in window_edges(bucket, page_size):
        if w >= needed:
            return w
    return None


def _pool_leaf_shape(leaf_shape: Tuple[int, ...], n_pages: int,
                     page_size: int) -> Tuple[int, ...]:
    """Cache leaf (L, K, T, B[, hd]) -> pool leaf (L, K, P, ps[, hd])."""
    return leaf_shape[:2] + (n_pages, page_size) + leaf_shape[4:]


def gather_slots(pool, slot_src: torch.Tensor, total_len: Optional[int] = None):
    """Assemble a dense decode cache from the pool, slot by slot:
    ``slot_src`` (B, S) indexes the pool's flattened (n_pages *
    page_size) position axis — entry (r, s) says which pool position
    fills cache slot ``s`` of row ``r``; unfilled slots point at the
    trash page 0. Returns the cache (the pool's leaves, each (L, K, T, B
    [, hd])) with T = ``total_len`` (default S): slots [0, S) gathered,
    the rest zeros, as the JAX gather followed by its zero pad of the
    time axis. Each layer is gathered on its own, so the only temporary
    is one layer's slots."""
    B, S = slot_src.shape
    T = S if total_len is None else int(total_len)
    idx = slot_src.t().reshape(-1).long()            # (S * B,), slot-major

    def leaf(p):
        L, K, P, ps = p.shape[:4]
        flat = p.reshape(L, K, P * ps, *p.shape[4:])
        c = torch.zeros((L, K, T, B) + tuple(p.shape[4:]), dtype=p.dtype,
                        device=p.device)
        for i in range(L):
            c[i, :, :S] = flat[i].index_select(1, idx).view(
                K, S, B, *p.shape[4:])
        return c

    return cache_map(leaf, pool)


def scatter_pages(pool, cache, page_ids: torch.Tensor, rows: torch.Tensor,
                  slot_idx: torch.Tensor) -> None:
    """Write full pages of a dispatch's final cache into the pool, in
    place: page ``page_ids[j]`` receives cache slots ``slot_idx[j]``
    (ps,) of batch row ``rows[j]``, in every leaf (both tensors of a float
    pair, payloads and scales of an int8 cache). Padding entries all
    target the trash page 0 (with identical blocks, so the order of their
    writes does not matter)."""
    for p, c in zip(cache_leaves(pool), cache_leaves(cache)):
        blocks = c[:, :, slot_idx.long(), rows.long()[:, None]]
        p[:, :, page_ids.long()] = blocks.to(p.dtype)   # (L, K, N, ps[, hd])


def extract_pages(pool, page_ids: torch.Tensor):
    """Whole pages out of the pool for migration: (L, K, N, ps[, hd])
    blocks a leaf (a copy, in the pool's nesting), ``page_ids`` (N,).
    Padding entries (callers pad to a stable chunk shape) target the
    trash page 0: dead bytes the import drops. Read-only on the pool."""
    idx = page_ids.long()
    return cache_map(lambda p: p.index_select(2, idx), pool)


def insert_pages(pool, blocks, page_ids: torch.Tensor) -> None:
    """Write migrated page blocks into the pool in place: page
    ``page_ids[j]`` receives ``blocks[:, :, j]`` in every leaf (the
    import's sibling of :func:`scatter_pages`). Padding entries target
    the trash page 0, which every gather masks (their writes may land
    in any order)."""
    idx = page_ids.long()
    for p, b in zip(cache_leaves(pool), cache_leaves(blocks)):
        p.index_copy_(2, idx, b.to(device=p.device, dtype=p.dtype,
                                   non_blocking=True))


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class KVPagePool:
    """Device-resident page pool + host-side free list and refcounts.

    The device leaves (``leaves``, the cache's nesting) are allocated by
    :meth:`ensure` from the first cache it sees (the engine passes a
    one-slot cache of its own layout, dtype and device when the prefix
    cache is built), so the pool can never disagree with the engine's
    cache."""

    def __init__(self, n_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if n_pages < 2:
            raise ValueError("KVPagePool needs >= 2 pages (page 0 is the "
                             "reserved trash page)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.leaves: Optional[Tuple] = None
        self.refcount = np.zeros(self.n_pages, np.int64)
        self.refcount[0] = 1            # trash page: never allocated/freed
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    # -- device side ---------------------------------------------------------

    def ensure(self, cache_like) -> None:
        """Allocate the pool's leaves to match ``cache_like`` on its
        device: a float (ck, cv) pair of (L, K, T, B, hd) tensors, or the
        int8 cache's ((kq, ks), (vq, vs)) with (L, K, T, B) scales.
        Idempotent. Any other structure is refused."""
        if self.leaves is not None:
            return

        def is_float(a):
            return (isinstance(a, torch.Tensor) and a.dim() == 5
                    and a.dtype.is_floating_point)

        def is_int8_side(side):
            return (isinstance(side, (tuple, list)) and len(side) == 2
                    and isinstance(side[0], torch.Tensor)
                    and side[0].dtype == torch.int8 and side[0].dim() == 5
                    and isinstance(side[1], torch.Tensor)
                    and side[1].dtype == torch.float32
                    and tuple(side[1].shape) == tuple(side[0].shape[:4]))

        pair = isinstance(cache_like, (tuple, list)) and len(cache_like) == 2
        if not pair or not (all(map(is_float, cache_like))
                            or all(map(is_int8_side, cache_like))):
            raise TypeError("KVPagePool takes a float (ck, cv) cache pair "
                            "of (L, K, T, B, hd) tensors or the int8 "
                            "((kq, ks), (vq, vs)) cache")
        self.leaves = cache_map(
            lambda a: torch.zeros(_pool_leaf_shape(tuple(a.shape),
                                                   self.n_pages,
                                                   self.page_size),
                                  dtype=a.dtype, device=a.device),
            cache_like)
        log.info("KV page pool allocated: %d pages x %d tokens (%.3f GB)",
                 self.n_pages, self.page_size, self.nbytes / 1e9)

    def scatter(self, cache, writes: Sequence[Tuple[int, int, int]]) -> None:
        """Apply ``writes`` = [(page_id, batch_row, start_slot), ...]:
        page_id <- cache[:, :, start_slot : start_slot + page_size, row].
        The list is padded to a power of two with trash-page writes, as
        the JAX pool pads it for its jitted scatter."""
        if not writes:
            return
        self.ensure(cache)
        n = _pow2(len(writes))
        pages = np.zeros((n,), np.int64)
        rows = np.zeros((n,), np.int64)
        starts = np.zeros((n,), np.int64)
        for j, (pg, row, start) in enumerate(writes):
            pages[j], rows[j], starts[j] = pg, row, start
        slot_idx = starts[:, None] + np.arange(self.page_size)[None, :]
        dev = cache_leaves(self.leaves)[0].device
        scatter_pages(self.leaves, cache, torch.from_numpy(pages).to(dev),
                      torch.from_numpy(rows).to(dev),
                      torch.from_numpy(slot_idx).to(dev))

    def extract(self, page_ids: Sequence[int], pad_to: int = 0):
        """Device blocks of ``page_ids`` (the migration export leg), the
        id list padded to ``pad_to`` (or the next power of two) with
        trash-page entries, so every chunk of an export has one shape.
        Enqueued on the current stream: the caller overlaps the copy to
        the host."""
        assert self.leaves is not None, "extract before ensure()"
        n = max(int(pad_to), _pow2(len(page_ids)))
        ids = np.zeros((n,), np.int64)
        ids[:len(page_ids)] = np.asarray(page_ids, np.int64)
        dev = cache_leaves(self.leaves)[0].device
        return extract_pages(self.leaves, torch.from_numpy(ids).to(dev))

    def insert(self, blocks, page_ids: Sequence[int]) -> None:
        """Land migrated blocks at ``page_ids`` (the import leg), on the
        current stream. ``blocks`` may be wider than the id list (the
        export's stable chunk width): the extra entries go to the trash
        page."""
        assert self.leaves is not None, "insert before ensure()"
        n = int(cache_leaves(blocks)[0].shape[2])
        assert n >= len(page_ids), "blocks narrower than the id list"
        ids = np.zeros((n,), np.int64)
        ids[:len(page_ids)] = np.asarray(page_ids, np.int64)
        dev = cache_leaves(self.leaves)[0].device
        insert_pages(self.leaves, blocks, torch.from_numpy(ids).to(dev))

    def page_nbytes(self) -> int:
        """Device bytes of ONE page across every leaf (0 before
        :meth:`ensure`)."""
        if self.leaves is None:
            return 0
        return self.nbytes // self.n_pages

    # -- host-side allocator -------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Device bytes of the allocated pool (0 before :meth:`ensure`)."""
        if self.leaves is None:
            return 0
        return sum(a.numel() * a.element_size()
                   for a in cache_leaves(self.leaves))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def alloc(self) -> Optional[int]:
        """One free page id, or None when exhausted (the caller evicts
        through the radix tree and retries: the pool has no idea which
        pages are coldest)."""
        if not self._free:
            return None
        page = self._free.pop()
        assert self.refcount[page] == 0, "allocated a referenced page"
        return page

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page reaching zero returns to
        the free list. A count below zero is a double free: it raises."""
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] < 0:
                raise AssertionError(f"page {p} refcount went negative")
            if self.refcount[p] == 0:
                self._free.append(int(p))
