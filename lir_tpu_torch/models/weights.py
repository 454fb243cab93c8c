"""Async weight streaming + the device-budgeted LRU weight cache.

Port of ``lir_tpu/models/weights.py``. The inter-model agreement axis
scores many models over one grid; a model switch pays a full host to
device weight load. This module makes the load overlappable and, where
the card's memory allows, makes it disappear:

- **Pinned host staging** (:func:`host_stage`): the converted param tree
  (``models/loader.py`` layout) held as PINNED CPU tensors, QuantTensor
  payload and scales included. Staging runs once a model; a reload then
  costs one host to device copy, not a re-conversion.
- **Chunked streaming on a copy stream** (:func:`stream_params`): each
  leaf's destination is allocated on the device once, and the leaf is
  copied into its row slices in chunks of at most ``chunk_bytes``, with
  at most ``INFLIGHT_CHUNKS`` copies queued, on a dedicated copy stream
  (``non_blocking`` copies from pinned memory, so they overlap the
  compute stream's kernels). The JAX package concatenates device chunks
  instead; the bytes are the same. The streamed tree is bitwise the
  staged one.
- **LRU weight cache** (:class:`WeightCache`): a budgeted pool of
  co-resident param trees with the KV page pool's refcount discipline:
  an in-flight dispatch holds a reference, eviction (LRU) drops only
  models nobody dispatches, pinned models are unevictable, a refcount
  never goes negative.
- **Async prefetch** (:class:`AsyncWeightStreamer`): one background
  worker loads the NEXT model while the current one scores.

**The copy stream and the caching allocator.** A tensor allocated while
the copy stream is current belongs to that stream's pool: once it is
freed (a model evicted), the allocator may hand its block to the next
load on the copy stream while kernels queued on the compute stream
still read it. :func:`stream_params` therefore calls
``record_stream(compute)`` on every streamed tensor before returning it
(and :func:`record_streams` does the same for a tree loaded by a
factory on the worker), so a freed block is reused only after the
compute stream's work queued at the time of the free has finished.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils.logging import get_logger
from .quant import QuantTensor

log = get_logger(__name__)

# Streaming chunk size: large enough that a chunk's launch cost is noise
# against the copy, small enough that the in-flight window stays well
# under one leaf of a 7B tree.
DEFAULT_CHUNK_BYTES = 64 << 20
# Double buffering: chunk k+2 is issued only after chunk k has landed.
INFLIGHT_CHUNKS = 2


class WeightCacheOOM(RuntimeError):
    """The weight cache cannot fit a model inside its budget: every
    resident candidate for eviction is pinned or referenced by an
    in-flight dispatch."""


def leaf_bytes(leaf) -> int:
    """Payload bytes of one tree leaf (QuantTensor-aware)."""
    if isinstance(leaf, QuantTensor):
        return leaf_bytes(leaf.q) + leaf_bytes(leaf.scale)
    return int(leaf.numel()) * int(leaf.element_size())


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the tree's tensor and QuantTensor leaves, keeping the
    nesting of dicts, lists and tuples; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, QuantTensor)):
        return fn(tree)
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """The tree's tensor and QuantTensor leaves, in ``tree_map`` order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor of the tree (a QuantTensor gives its q and scale)."""
    out: List[torch.Tensor] = []
    for leaf in tree_leaves(tree):
        out.extend([leaf.q, leaf.scale] if isinstance(leaf, QuantTensor)
                   else [leaf])
    return out


def tree_bytes(params: Any) -> int:
    """Total payload bytes of a param tree (the cache's accounting unit;
    equals ``models/quant.param_bytes``)."""
    return sum(leaf_bytes(leaf) for leaf in tree_leaves(params))


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                      pin_memory=torch.cuda.is_available())
    out.copy_(x)
    return out


def host_stage(params: Any) -> Any:
    """Host staging copy of a converted param tree: every tensor becomes a
    contiguous CPU copy, PINNED where CUDA is available (a copy from
    pageable memory would be synchronous and overlap nothing); the
    QuantTensor structure is kept. The staged tree never changes, so a
    reload after eviction is bitwise by construction."""
    def leaf(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(q=_pinned_copy(x.q),
                               scale=_pinned_copy(x.scale),
                               dynamic=x.dynamic)
        return _pinned_copy(x)

    return tree_map(leaf, params)


class _InflightWindow:
    """Bounded copy pipeline: after each chunk is issued, wait for the
    one ``depth`` chunks back to land. ``drain`` waits for all."""

    def __init__(self, cuda: bool, depth: int = INFLIGHT_CHUNKS):
        self.cuda = cuda
        self.depth = depth
        self._pending: List[torch.cuda.Event] = []

    def admit(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append(ev)
        if len(self._pending) > self.depth:
            self._pending.pop(0).synchronize()

    def drain(self) -> None:
        for ev in self._pending:
            ev.synchronize()
        self._pending.clear()


def _chunk_starts(n_rows: int, rows_per_chunk: int) -> List[int]:
    return list(range(0, n_rows, max(rows_per_chunk, 1)))


def _stream_tensor(x: torch.Tensor, device: torch.device, chunk_bytes: int,
                   window: _InflightWindow) -> torch.Tensor:
    """One tensor host -> device into a destination allocated once,
    split along axis 0 (the layer-stack or vocab axis) into pieces of at
    most ``chunk_bytes``, each copied straight into its row slice."""
    dst = torch.empty(x.shape, dtype=x.dtype, device=device)
    nbytes = leaf_bytes(x)
    if x.dim() == 0 or nbytes <= chunk_bytes or x.shape[0] <= 1:
        dst.copy_(x, non_blocking=True)
        window.admit()
        return dst
    rows = max(int(x.shape[0] * chunk_bytes / nbytes), 1)
    for s in _chunk_starts(x.shape[0], rows):
        dst[s:s + rows].copy_(x[s:s + rows], non_blocking=True)
        window.admit()
    return dst


def record_streams(params: Any, stream) -> None:
    """``record_stream(stream)`` on every tensor of a device tree: the
    allocator then reuses a freed block only after ``stream``'s work
    queued at the time of the free has finished. No-op off the card."""
    if stream is None:
        return
    for t in tensors(params):
        if t.is_cuda:
            t.record_stream(stream)


def stream_params(staged: Any, device="cuda",
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES, stats=None,
                  mesh=None, copy_stream=None, compute_stream=None) -> Any:
    """Ship a host-staged tree to ``device`` in chunks, at most
    ``INFLIGHT_CHUNKS`` in flight, on ``copy_stream`` (a new one when
    None); returns the fully landed device tree, every tensor recorded on
    ``compute_stream`` (the current stream when None) for the caching
    allocator (module docstring). Off the card the chunks are plain
    copies. ``stats`` (profiling.FleetStats) counts
    ``weight_bytes_streamed``. A mesh is multi-device sharding (ROADMAP
    A9): refused."""
    if mesh is not None:
        raise NotImplementedError(
            "stream_params: sharded streaming over a mesh is multi-device "
            "work the port does not have yet")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    window = _InflightWindow(cuda)

    def leaf(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(
                q=_stream_tensor(x.q, dev, chunk_bytes, window),
                scale=_stream_tensor(x.scale, dev, chunk_bytes, window),
                dynamic=x.dynamic)
        return _stream_tensor(x, dev, chunk_bytes, window)

    if cuda:
        consumer = (compute_stream if compute_stream is not None
                    else torch.cuda.current_stream(dev))
        stream = (copy_stream if copy_stream is not None
                  else torch.cuda.Stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = tree_map(leaf, staged)
            window.drain()
        record_streams(out, consumer)
    else:
        out = tree_map(leaf, staged)
    if stats is not None:
        stats.count("weight_bytes_streamed", tree_bytes(staged))
    return out


# ---------------------------------------------------------------------------
# LRU weight cache
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("params", "nbytes", "refcount", "pinned")

    def __init__(self, params: Any, nbytes: int):
        self.params = params
        self.nbytes = int(nbytes)
        self.refcount = 0
        self.pinned = False


class WeightCache:
    """Budgeted LRU pool of co-resident model param trees.

    Bookkeeping only: loading is the fleet's job (the cache never holds
    its lock across a copy). The KV page pool's discipline:

    - ``acquire`` marks a model in use by one dispatch stream
      (refcount += 1, MRU touch); ``release`` drops it. A refcount never
      goes negative.
    - ``insert`` evicts LRU models until the new tree fits the budget;
      only models with refcount 0 and not pinned are evictable; if that
      frees too little, :class:`WeightCacheOOM`.
    - ``pin``/``unpin``: a pinned model is unevictable whatever its
      refcount.

    ``budget_bytes=None`` means unbounded.
    """

    def __init__(self, budget_bytes: Optional[int] = None, stats=None,
                 on_evict: Optional[Callable[[str], None]] = None):
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self.stats = stats
        # Eviction hook: the fleet clears the evicted engine's params
        # reference so the memory is actually returned.
        self.on_evict = on_evict
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()  # guarded-by: _lock
        # Residency-change listeners, called with ("insert" | "evict",
        # model_id), possibly under the cache lock: they must be cheap
        # and must not touch the cache.
        self._listeners: list = []  # guarded-by: _lock

    def add_listener(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, event: str, model_id: str) -> None:
        for fn in list(self._listeners):
            try:
                fn(event, model_id)
            except Exception:  # noqa: BLE001 — telemetry must never
                # break residency bookkeeping
                log.exception("weight cache listener failed")

    # -- gauges --------------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    @property
    def resident_models(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._entries

    def refcount(self, model_id: str) -> int:
        with self._lock:
            e = self._entries.get(model_id)
            return 0 if e is None else e.refcount

    def _gauge(self) -> None:
        if self.stats is not None:
            self.stats.gauge("resident_models", len(self._entries))
            self.stats.gauge("resident_bytes",
                             sum(e.nbytes for e in self._entries.values()))

    # -- resident set --------------------------------------------------------

    def insert(self, model_id: str, params: Any,
               nbytes: Optional[int] = None) -> None:
        """Make ``model_id`` resident (re-inserting a resident model only
        touches MRU order). Evicts LRU models as needed; raises
        :class:`WeightCacheOOM` when evicting unreferenced, unpinned
        models cannot meet the budget."""
        with self._lock:
            if model_id in self._entries:
                self._entries.move_to_end(model_id)
                return
            nbytes = tree_bytes(params) if nbytes is None else int(nbytes)
            if self.budget_bytes is not None:
                self._evict_until(self.budget_bytes - nbytes, model_id)
            self._entries[model_id] = _Entry(params, nbytes)
            self._gauge()
            self._notify("insert", model_id)

    def _evict_until(self, budget_left: int, incoming: str) -> None:  # guarded-by: _lock
        used = sum(e.nbytes for e in self._entries.values())
        if used <= budget_left:
            return
        for mid in list(self._entries):       # OrderedDict = LRU first
            e = self._entries[mid]
            if e.refcount > 0 or e.pinned:
                continue
            del self._entries[mid]
            used -= e.nbytes
            if self.stats is not None:
                self.stats.count("evictions")
            if self.on_evict is not None:
                self.on_evict(mid)
            self._notify("evict", mid)
            log.info("weight cache: evicted %s (%.2f GB) for %s",
                     mid, e.nbytes / 2**30, incoming)
            if used <= budget_left:
                self._gauge()
                return
        raise WeightCacheOOM(
            f"cannot fit {incoming} in the weight cache: "
            f"{used / 2**30:.2f} GB resident is pinned or in use, "
            f"budget leaves {max(budget_left, 0) / 2**30:.2f} GB")

    def evict_idle(self) -> Optional[str]:
        """Evict the LRU model that is idle (refcount 0, not pinned): the
        governor's ``evict_weights`` rung (engine/hbm.py). Returns the
        evicted id, or None when every resident model is pinned or in
        flight."""
        with self._lock:
            for mid in list(self._entries):   # OrderedDict = LRU first
                e = self._entries[mid]
                if e.refcount > 0 or e.pinned:
                    continue
                del self._entries[mid]
                if self.stats is not None:
                    self.stats.count("evictions")
                if self.on_evict is not None:
                    self.on_evict(mid)
                self._notify("evict", mid)
                self._gauge()
                log.info("weight cache: governor evicted idle %s "
                         "(%.2f GB)", mid, e.nbytes / 2**30)
                return mid
        return None

    def drop(self, model_id: str) -> None:
        """Explicitly evict one model (must be unreferenced and
        unpinned)."""
        with self._lock:
            e = self._entries.get(model_id)
            if e is None:
                return
            if e.refcount > 0 or e.pinned:
                raise WeightCacheOOM(
                    f"cannot drop {model_id}: refcount {e.refcount}, "
                    f"pinned {e.pinned}")
            del self._entries[model_id]
            if self.stats is not None:
                self.stats.count("evictions")
            if self.on_evict is not None:
                self.on_evict(model_id)
            self._notify("evict", model_id)
            self._gauge()

    # -- reference discipline ------------------------------------------------

    def acquire(self, model_id: str) -> Any:
        """Params of a RESIDENT model, refcounted for one dispatch
        stream. KeyError when not resident (the fleet loads first)."""
        with self._lock:
            e = self._entries[model_id]
            e.refcount += 1
            self._entries.move_to_end(model_id)
            return e.params

    def release(self, model_id: str) -> None:
        with self._lock:
            e = self._entries[model_id]
            e.refcount -= 1
            assert e.refcount >= 0, (
                f"weight cache refcount for {model_id} went negative — "
                "double release")

    def pin(self, model_id: str) -> None:
        with self._lock:
            self._entries[model_id].pinned = True

    def unpin(self, model_id: str) -> None:
        with self._lock:
            self._entries[model_id].pinned = False

    def peek(self, model_id: str) -> Optional[Any]:
        """Params without touching refcount or MRU order (tests)."""
        with self._lock:
            e = self._entries.get(model_id)
            return None if e is None else e.params


# ---------------------------------------------------------------------------
# Async prefetch
# ---------------------------------------------------------------------------


class AsyncWeightStreamer:
    """One background worker loading trees ahead of need. ``prefetch``
    enqueues a load; ``take`` blocks until it lands and reports (params,
    load_seconds, waited_seconds): the fleet books ``waited`` as exposed
    swap time and ``load - waited`` as hidden. One worker on purpose:
    host to device bandwidth is one resource."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="weight-stream")
        self._lock = threading.Lock()
        self._futures: Dict[str, Any] = {}  # guarded-by: _lock

    def prefetch(self, model_id: str,
                 load_fn: Callable[[], Any]) -> None:
        """Start loading ``model_id`` in the background (a no-op while a
        load is already queued or running)."""
        with self._lock:
            if model_id in self._futures:
                return

            def timed():
                t0 = time.perf_counter()
                params = load_fn()
                return params, time.perf_counter() - t0

            self._futures[model_id] = self._pool.submit(timed)

    def pending(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._futures

    def take(self, model_id: str) -> Optional[Tuple[Any, float, float]]:
        """Claim a prefetched load: blocks until it lands, returns
        (params, load_s, waited_s), or None when nothing was prefetched
        for ``model_id``. A load that raised re-raises HERE, on the
        consumer's thread."""
        with self._lock:
            fut = self._futures.pop(model_id, None)
        if fut is None:
            return None
        t0 = time.perf_counter()
        params, load_s = fut.result()
        return params, load_s, time.perf_counter() - t0

    def cancel_all(self) -> None:
        with self._lock:
            futures = dict(self._futures)
            self._futures.clear()
        for fut in futures.values():
            fut.cancel()

    def shutdown(self) -> None:
        self.cancel_all()
        self._pool.shutdown(wait=True)
