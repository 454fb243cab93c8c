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

- **Page listeners.** :meth:`RadixPrefixCache.add_listener` subscribes
  to page insert and evict events (fired on the dispatching thread);
  the router's :class:`ClusterPrefixIndex` rides them to know which
  replica holds which prefix pages.

- **Rollback.** :meth:`RadixPrefixCache.forget_tail` removes the
  childless tail nodes a failed page import created (serve/migrate.py),
  firing ``"evict"`` so the cluster index unlearns them.

The tier hooks of the JAX module (``evict_tail``, ``coldest_leaves``)
wait for the memory tiers (ROADMAP A8d).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.logging import get_logger
from ..utils.profiling import PrefixCacheStats

log = get_logger(__name__)

# A page listener: fn(event, bucket, ids), event "insert" (ids: the
# whole page-aligned prefix now cached) or "evict" (ids: the removed
# node's full token path; that page and everything under it are gone).
PageListener = Callable[[str, int, Tuple[int, ...]], None]


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
        self._listeners: List[PageListener] = []
        self.stats.gauge_pages(pool.pages_in_use, pool.n_pages - 1)

    def __len__(self) -> int:
        return self._nodes

    def add_listener(self, fn: PageListener) -> None:
        """Subscribe to page insert and evict events, fired on the
        tree's dispatching thread: listeners do cheap bookkeeping only
        (the cluster index takes its own lock)."""
        self._listeners.append(fn)

    def _notify(self, event: str, bucket: int,
                ids: Tuple[int, ...]) -> None:
        for fn in list(self._listeners):
            try:
                fn(event, int(bucket), ids)
            except Exception:  # noqa: BLE001 — an index listener must
                # never take the serving tree down with it.
                log.exception("prefix-tree listener failed (%s)", event)

    def _node_ids(self, node: _Node) -> Tuple[int, ...]:
        """The node's full token path (namespace root excluded)."""
        keys: List[Tuple[int, ...]] = []
        n: Optional[_Node] = node
        while n is not None and n.key != ():
            keys.append(n.key)
            n = n.parent
        return tuple(t for k in reversed(keys) for t in k)

    def _node_bucket(self, node: _Node) -> int:
        n = node
        while n.parent is not None:
            n = n.parent
        return int(n.bucket if n.bucket is not None else 0)

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
            covered = (start + len(new_pages)) * self.page_size
            self._notify("insert", bucket,
                         tuple(int(t) for t in ids[:covered]))
        self.stats.gauge_pages(self.pool.pages_in_use,
                               self.pool.n_pages - 1)
        return start * self.page_size, new_pages

    def forget_tail(self, bucket: int, ids: Sequence[int],
                    n_pages: int) -> int:
        """Remove the deepest ``n_pages`` nodes along ``ids``' cached path
        and drop the tree's page references: the ROLLBACK of a cancelled
        or corrupt page import (serve/migrate.py), so that no dispatch
        gathers pages that were never filled. Only childless tail nodes
        go (what a fresh plan_insert created); each fires ``"evict"``.
        Returns how many were removed."""
        path = self._walk(bucket, ids, touch=False)
        removed = 0
        for node in reversed(path[-n_pages:] if n_pages else []):
            if node.children:
                break           # the path was extended past us: keep it
            self._notify("evict", int(bucket), self._node_ids(node))
            del node.parent.children[node.key]
            self._nodes -= 1
            self.pool.decref((node.page,))
            removed += 1
        if removed:
            self.stats.gauge_pages(self.pool.pages_in_use,
                                   self.pool.n_pages - 1)
        return removed

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
            self._notify("evict", self._node_bucket(node),
                         self._node_ids(node))
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


# ---------------------------------------------------------------------------
# The cluster-wide prefix index (router side)
# ---------------------------------------------------------------------------


class ClusterPrefixIndex:
    """Which REPLICA holds which prefix pages: a router-side index fed by
    every replica tree's :meth:`RadixPrefixCache.add_listener` events
    (and, with the memory tiers of ROADMAP A8d, by each replica's tier
    store under a tier dimension). Placement reads :meth:`match_pages`.

    It stores token chunks only (a dict node a page, no pool references,
    no device memory) and is advisory: a stale entry costs a shorter
    match, never a wrong answer. Thread-safe: events arrive on each
    replica's supervisor thread while the router matches.
    """

    def __init__(self, page_size: int = 16):
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # (replica id, bucket, tier) -> nested {chunk tuple: child dict}.
        self._tries: Dict[Tuple[str, int, str], Dict] = {}

    def _chunks(self, ids: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in ids[k * ps:(k + 1) * ps])
                for k in range(len(ids) // ps)]

    def on_event(self, replica_id: str, event: str, bucket: int,
                 ids: Sequence[int], tier: str = "hbm") -> None:
        """One replica tree's page event (wire with ``tree.add_listener(
        functools.partial(index.on_event, rid))``)."""
        chunks = self._chunks(ids)
        if not chunks:
            return
        with self._lock:
            trie = self._tries.setdefault(
                (str(replica_id), int(bucket), str(tier)), {})
            if event == "insert":
                node = trie
                for ck in chunks:
                    node = node.setdefault(ck, {})
            elif event == "evict":
                node, hops = trie, []
                for ck in chunks:
                    child = node.get(ck)
                    if child is None:
                        return          # already pruned (advisory index)
                    hops.append((node, ck))
                    node = child
                parent, key = hops[-1]
                del parent[key]         # the page and its whole subtree

    def on_tier_event(self, replica_id: str, event: str, tier: str,
                      bucket: int, ids: Sequence[int]) -> None:
        """A tier store's movement event (its producer comes with the
        memory tiers, ROADMAP A8d): a tier entry covers a whole prefix,
        so an evict prunes the full path."""
        self.on_event(replica_id, event, bucket, ids, tier=tier)

    def drop_replica(self, replica_id: str) -> None:
        """Forget a replica's device pages (its pool died with it); its
        host and disk tier entries survive."""
        with self._lock:
            for key in [k for k in self._tries
                        if k[0] == replica_id and k[2] == "hbm"]:
                del self._tries[key]

    def match_pages(self, bucket: int, ids: Sequence[int],
                    tier: str = "hbm") -> Dict[str, int]:
        """Pages of ``ids``' leading prefix each replica holds in the
        ``bucket`` namespace at ``tier`` now (tokens = pages x
        page_size)."""
        chunks = self._chunks(ids)
        out: Dict[str, int] = {}
        with self._lock:
            for (rid, b, t), trie in self._tries.items():
                if b != int(bucket) or t != str(tier):
                    continue
                node, n = trie, 0
                for ck in chunks:
                    node = node.get(ck)
                    if node is None:
                        break
                    n += 1
                if n:
                    out[rid] = max(out.get(rid, 0), n)
        return out

    def match_tiers(self, bucket: int, ids: Sequence[int]
                    ) -> Dict[str, Dict[str, int]]:
        """Every tier's match depth per replica: {replica id: {tier:
        pages}}."""
        with self._lock:
            tiers = sorted({k[2] for k in self._tries})
        out: Dict[str, Dict[str, int]] = {}
        for t in tiers:
            for rid, pages in self.match_pages(bucket, ids, tier=t).items():
                out.setdefault(rid, {})[t] = pages
        return out

    def best_holder(self, bucket: int, ids: Sequence[int],
                    exclude: Optional[Sequence[str]] = None
                    ) -> Tuple[Optional[str], int]:
        """(the replica with the deepest match, its pages), or (None, 0)
        when nothing matches."""
        matches = self.match_pages(bucket, ids)
        for rid in (exclude or ()):
            matches.pop(rid, None)
        if not matches:
            return None, 0
        rid = max(matches, key=lambda r: matches[r])
        return rid, matches[rid]
