"""Radix tree over tokenized prefixes -> KV page runs (cross-request
prefix cache).

Port of ``lir_tpu/engine/prefix_tree.py``'s ``RadixPrefixCache``. The
workload (many rephrasings of a few legal prompts) re-asks prompts whose
tokenized prefixes agree for hundreds of tokens, so the KV of a prefix
computed once backs every later dispatch that shares it, across batches
and across sweeps on one engine. The page pool (``models/paged.
KVPagePool``) owns the device memory; this module owns the INDEX: which
token sequence's KV lives in which pages, in LRU order, with hit, miss
and eviction counters (``utils/profiling.PrefixCacheStats``).

- **Page-granular edges.** Every edge covers exactly ``page_size``
  token ids (one pool page), so no node ever splits: two sequences that
  diverge mid-page share the full pages before it and recompute the
  partial page in the dispatch's remainder window.
- **Per-bucket namespaces.** The tree is partitioned by the producing
  dispatch's prefix-bucket edge: a page's KV comes from attention
  reduced at that extent, so pages of bucket 128 never back a bucket-64
  dispatch.
- **Reference discipline.** The tree holds ONE pool reference per
  cached page for as long as its node exists; :meth:`lookup` takes one
  more per matched page (the in-flight dispatch's pin), dropped by
  :meth:`release`. Eviction frees only leaves whose page holds exactly
  the tree's reference.
- **LRU by lookup clock.** Every lookup and insert stamps the touched
  path with a monotonic clock; eviction removes the stalest evictable
  leaves first, cascading into parents as they become leaves. One clock
  across all namespaces.
- **Single-threaded by contract.** Lookups, inserts, evictions and tail
  records run on the thread that dispatches (the perturbation sweep's
  main thread). :meth:`match_len` and :meth:`continuation` are
  read-only probes that take no references.

The JAX module's router-side ``ClusterPrefixIndex``, its page listeners
and the migration / tier hooks (``forget_tail``, ``evict_tail``,
``coldest_leaves``) belong to the fleet server and migration, not
ported yet (ROADMAP A8b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.profiling import PrefixCacheStats


class _Node:
    """One cached page: ``key`` is the page's token-id chunk (within the
    parent's context), ``page`` its pool page id. ``tails`` is the
    node's token history for speculative drafting: observed
    continuations of sequences ending at this node, keyed by the
    sub-page remainder between the node's depth and the recording
    sequence's end ({remainder tuple -> continuation tuple},
    insertion-ordered for LRU capping). Host memory only."""

    __slots__ = ("key", "page", "children", "parent", "clock", "tails",
                 "bucket")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.clock = 0
        self.tails: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        self.bucket: Optional[int] = None   # set on namespace roots only


@dataclasses.dataclass
class PrefixMatch:
    """Result of one pinned lookup: ``pages`` cover the first ``tokens``
    ids of the probed sequence (tokens == len(pages) * page_size). Hand
    back to :meth:`RadixPrefixCache.release` once the dispatch that
    gathered these pages has returned."""

    pages: Tuple[int, ...]
    tokens: int


class RadixPrefixCache:
    """The radix index over one :class:`~lir_tpu_torch.models.paged.
    KVPagePool`, partitioned into per-bucket namespaces."""

    def __init__(self, pool, stats: Optional[PrefixCacheStats] = None):
        self.pool = pool
        self.stats = stats if stats is not None else PrefixCacheStats()
        self.page_size = pool.page_size
        self._roots: Dict[int, _Node] = {}
        self._clock = 0
        self._nodes = 0
        self.stats.gauge_pages(pool.pages_in_use, pool.n_pages - 1)

    def __len__(self) -> int:
        return self._nodes

    def _root(self, bucket: int) -> _Node:
        root = self._roots.get(int(bucket))
        if root is None:
            root = self._roots[int(bucket)] = _Node((), 0, None)
            root.bucket = int(bucket)
        return root

    # -- walking -------------------------------------------------------------

    def _chunks(self, ids: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        n_full = len(ids) // ps
        return [tuple(int(t) for t in ids[k * ps:(k + 1) * ps])
                for k in range(n_full)]

    def _walk(self, bucket: int, ids: Sequence[int],
              touch: bool) -> List[_Node]:
        path: List[_Node] = []
        node = self._root(bucket)
        for key in self._chunks(ids):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        if touch and path:
            self._clock += 1
            for n in path:
                n.clock = self._clock
        return path

    # -- read side -----------------------------------------------------------

    def match_len(self, bucket: int, ids: Sequence[int]) -> int:
        """Cached leading tokens of ``ids`` in the ``bucket`` namespace
        right now: the planner's pricing probe
        (``scheduler.bucket_cost``'s ``cached_tokens``). Takes no
        references; the answer is advisory (the dispatch looks up again
        with a pin)."""
        return len(self._walk(bucket, ids, touch=False)) * self.page_size

    def lookup(self, bucket: int, ids: Sequence[int],
               record: bool = True) -> PrefixMatch:
        """Deepest cached prefix of ``ids``, PINNED: every matched page
        gains one pool reference, so eviction cannot free it while the
        dispatch that gathers it is in flight. Callers MUST
        :meth:`release` the match after the dispatch returns.
        ``record=False`` skips the hit/miss counters (batch-padding rows
        duplicate a real row: their pins are needed, their stats are
        noise)."""
        path = self._walk(bucket, ids, touch=True)
        pages = tuple(n.page for n in path)
        self.pool.incref(pages)
        if record:
            self.stats.count("lookups")
            if pages:
                self.stats.count("hits")
        return PrefixMatch(pages=pages, tokens=len(pages) * self.page_size)

    def release(self, match: PrefixMatch) -> None:
        """Drop a lookup's dispatch pin. The tree's own reference keeps
        the pages cached; they become evictable again."""
        self.pool.decref(match.pages)

    # -- token history (speculative drafting) --------------------------------

    def continuation(self, bucket: int, ids: Sequence[int],
                     k: int) -> Tuple[int, ...]:
        """Read-only probe: up to ``k`` tokens the tree's own token
        history predicts will follow ``ids`` in the ``bucket`` namespace
        (the drafting source of ``engine/spec.py``). Page-key descent
        first — another cached sequence with ``ids`` as a proper prefix
        contributes its next chunks, the most recently touched child
        winning — then the recorded tail (:meth:`record_tail`) of a
        completed dispatch of this exact prompt. Takes no references and
        touches no clock; a wrong continuation is only a draft the
        verifier rejects."""
        ids = [int(t) for t in ids]
        path = self._walk(bucket, ids, touch=False)
        depth = len(path)
        node = path[-1] if path else self._roots.get(int(bucket))
        if node is None:
            return ()
        rem = tuple(ids[depth * self.page_size:])
        out: List[int] = []
        while len(out) < k:
            cands = [c for key, c in node.children.items()
                     if key[:len(rem)] == rem]
            if not cands:
                break
            child = max(cands, key=lambda n: n.clock)
            out.extend(child.key[len(rem):])
            node, rem = child, ()
        if len(out) < k:
            tail = node.tails.get(rem)
            if tail:
                out.extend(tail)
        return tuple(out[:k])

    def record_tail(self, bucket: int, ids: Sequence[int],
                    tail: Sequence[int], max_tails: int = 32,
                    max_tokens: int = 512) -> bool:
        """Record that ``ids`` was observed continuing with ``tail``: the
        record lands on the deepest node whose pages cover ``ids`` (or
        the namespace root), keyed by the sub-page remainder; a node
        keeps at most ``max_tails`` records (least recent dropped), and
        a remainder + tail longer than ``max_tokens`` is refused."""
        ids = [int(t) for t in ids]
        tail = tuple(int(t) for t in tail)
        if not tail:
            return False
        path = self._walk(bucket, ids, touch=False)
        depth = len(path)
        node = path[-1] if path else self._root(bucket)
        rem = tuple(ids[depth * self.page_size:])
        if len(rem) + len(tail) > max_tokens:
            return False
        node.tails.pop(rem, None)           # re-insert = most recent
        node.tails[rem] = tail
        while len(node.tails) > max_tails:
            node.tails.pop(next(iter(node.tails)))
        return True

    # -- write side ----------------------------------------------------------

    def plan_insert(self, bucket: int,
                    ids: Sequence[int]) -> Tuple[int, List[int]]:
        """Allocate tree nodes + pool pages for every full-page chunk of
        ``ids`` not yet cached under ``bucket``. Returns (first uncached
        token index, page ids in chunk order): the caller scatters the
        dispatch's KV into those pages (``KVPagePool.scatter``). An
        allocation failure (pool exhausted, everything else pinned)
        stops the insert early: the tree caches a shorter prefix, never
        a torn one, since nodes are added parent first."""
        chunks = self._chunks(ids)
        path = self._walk(bucket, ids, touch=True)
        node = path[-1] if path else self._root(bucket)
        start = len(path)
        new_pages: List[int] = []
        self._clock += 1
        for key in chunks[start:]:
            page = self._alloc_with_evict()
            if page is None:
                break
            child = _Node(key, page, node)
            child.clock = self._clock
            node.children[key] = child
            self.pool.incref((page,))          # the tree's own reference
            self._nodes += 1
            new_pages.append(page)
            node = child
        if new_pages:
            self.stats.count("inserted_pages", len(new_pages))
        self.stats.gauge_pages(self.pool.pages_in_use,
                               self.pool.n_pages - 1)
        return start * self.page_size, new_pages

    def _alloc_with_evict(self) -> Optional[int]:
        page = self.pool.alloc()
        if page is None and self.evict(1):
            page = self.pool.alloc()
        return page

    # -- eviction ------------------------------------------------------------

    def _evictable_leaves(self) -> List[_Node]:
        """Leaf nodes (across every namespace) whose page holds exactly
        ONE reference, the tree's: no child depends on them and no
        dispatch has them pinned."""
        out: List[_Node] = []
        stack = [n for root in self._roots.values()
                 for n in root.children.values()]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.pool.refcount[n.page] == 1:
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Free >= ``n_pages`` pool pages by removing the least recently
        used evictable leaves, cascading into parents as they become
        leaves. Returns how many pages were freed (fewer than asked when
        everything else is pinned or interior)."""
        freed = 0
        candidates = sorted(self._evictable_leaves(), key=lambda n: n.clock)
        while freed < n_pages and candidates:
            node = candidates.pop(0)
            parent = node.parent
            del parent.children[node.key]
            self._nodes -= 1
            self.pool.decref((node.page,))
            freed += 1
            # The parent may have just become an evictable leaf staler
            # than the remaining candidates: keep the LRU order exact
            # (namespace roots carry key == () and are never evicted).
            if (parent is not None and parent.key != ()
                    and not parent.children
                    and self.pool.refcount[parent.page] == 1):
                candidates.append(parent)
                candidates.sort(key=lambda n: n.clock)
        if freed:
            self.stats.count("evicted_pages", freed)
            self.stats.gauge_pages(self.pool.pages_in_use,
                                   self.pool.n_pages - 1)
        return freed
