"""KV-page migration between replica pools (disaggregated serving).
Port of ``lir_tpu/serve/migrate.py``.

The page is the unit of KV ownership (models/paged.KVPagePool and
engine/prefix_tree.RadixPrefixCache); this module makes it the unit of
placement: the pages of a prefix prefilled on one replica stream to
another replica's pool, land in its radix tree, and back that replica's
decode dispatches as pages it computed itself would. A long prompt
prefills on a PREFILL-role replica and its decode runs on a DECODE-role
replica:

- **Export** (:func:`export_prefix`): the source tree pins the deepest
  cached match (a lookup's pin: eviction cannot free a page mid-copy),
  then the pages go to the host in chunks of ``chunk_pages`` with at
  most ``inflight_chunks`` copies in flight. On a card each chunk is
  gathered on the current stream (the stream whose scatter wrote the
  pages) and copied with ``non_blocking`` into pinned host buffers of
  its own, an event a chunk; a chunk is owned and writable (the
  ``migration_corrupt`` fault flips its bytes in place), never a slot of
  a reused staging ring. Each chunk carries a CRC32 over every leaf's
  raw bytes in leaf order: the bytes the JAX package hashes, so equal
  pages give equal checksums in both packages.
- **Import** (:func:`import_prefix`): every checksum is verified before
  anything lands; the destination tree allocates nodes and pages through
  ``plan_insert`` (the cluster index hears of them as of local pages),
  the fresh pages are pinned, and the chunks land on the current
  stream (the stream the destination's next dispatch reads) with the
  same in-flight bound. Any failure ROLLS BACK: the fresh nodes leave
  the tree (:meth:`RadixPrefixCache.forget_tail`) and their pages return
  to the free list, so no dispatch gathers a half-filled page.
- **Page ops** (:class:`PageOp` / :class:`OpFuture`): every tree and
  pool touch runs on the OWNING replica's supervisor thread, queued by
  ``ScoringServer.submit_page_op`` under the engine's
  ``DispatchWatchdog.dispatch_lock``; the router chains the ops by
  completion callbacks, which fire on the supervisor thread that
  resolved the op.
- **Fault seam** (:meth:`PageMigrator.transfer`): the host hop between
  export and import, where ``faults.wrap_migrator`` injects
  ``migration_stall`` and ``migration_corrupt``. Both end in the
  router's fallback: the decode replica re-prefills locally.

Every transfer buffer is on the engine's governor ledger
(``migrate_buf:<model>``) for the length of its leg. A migration that
cannot complete costs a local re-prefill
(``MigrationStats.refetch_fallbacks``), never a wrong or dropped
request. ``PageExport.crc_s`` / ``ImportResult.crc_s`` (the checksum
seconds of each leg) are the port's own fields.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import MigrationConfig
from ..models.decoder import cache_leaves, cache_map
from ..utils.logging import get_logger
from ..utils.profiling import MigrationStats

log = get_logger(__name__)


class MigrationError(RuntimeError):
    """A page transfer that must not land (checksum mismatch, layout
    disagreement, vanished source pages). The router's answer is always
    the same: abandon the chain, re-prefill locally."""


# ---------------------------------------------------------------------------
# Page ops: engine work queued onto the owning supervisor thread
# ---------------------------------------------------------------------------


class OpFuture:
    """Completion handle of one page op: resolves exactly once with a
    value OR an exception; callbacks run on the resolving (supervisor)
    thread. The migration chain's links are these callbacks."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self._callbacks: List[Callable[["OpFuture"], None]] = []

    def _resolve(self, value: Any, error: Optional[BaseException]) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self.value, self.error = value, error
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)

    def set_result(self, value: Any) -> None:
        self._resolve(value, None)

    def set_exception(self, error: BaseException) -> None:
        self._resolve(None, error)

    def done(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, fn: Callable[["OpFuture"], None]) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("page op not resolved in time")
        if self.error is not None:
            raise self.error
        return self.value


class PageOp:
    """One unit of tree and pool work bound for a replica's supervisor
    thread (``ScoringServer.submit_page_op``)."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn
        self.future = OpFuture()

    def run(self, engine) -> None:
        try:
            self.future.set_result(self.fn(engine))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as err:  # noqa: BLE001 — the chain's fallback
            # decides what a failed op means; the supervisor must live.
            self.future.set_exception(err)


# ---------------------------------------------------------------------------
# The transfer payload
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PageExport:
    """One prefix's pages, staged on the host for the wire hop.

    ``ids`` is the page-aligned token prefix the pages cover (the import
    re-plans against it); ``start_tokens`` is where the export begins
    (the destination held ``[0, start_tokens)`` at probe time).
    ``chunks`` holds ``(host block tree, real pages)`` pairs of
    ``chunk_pages`` width (trailing pad entries are trash-page blocks),
    each leaf a CPU tensor (pinned from a card); ``checksums`` one CRC32
    a chunk."""

    bucket: int
    ids: Tuple[int, ...]
    start_tokens: int
    page_size: int
    n_pages: int
    chunk_pages: int
    chunks: List[Tuple[Any, int]]
    checksums: List[int]
    nbytes: int
    wall_s: float = 0.0
    serial_s: float = 0.0
    crc_s: float = 0.0


@dataclasses.dataclass
class ImportResult:
    """What one import landed: pages written, device bytes, the wall and
    serial split the overlap accounting reads, and the verify's
    seconds."""

    pages: int
    nbytes: int
    wall_s: float = 0.0
    serial_s: float = 0.0
    crc_s: float = 0.0


def _leaf_bytes(leaf) -> np.ndarray:
    """A leaf's raw bytes, C order, as a uint8 array (a view where the
    leaf is contiguous: bf16 has no numpy dtype, so a tensor is read
    through a uint8 view of itself)."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def chunk_checksum(block_tree: Any) -> int:
    """CRC32 over every leaf's raw bytes, in leaf order (``zlib.crc32``
    over the bytes the JAX package hashes)."""
    crc = 0
    for leaf in cache_leaves(block_tree):
        crc = zlib.crc32(_leaf_bytes(leaf), crc)
    return crc


# ---------------------------------------------------------------------------
# Export / import legs
# ---------------------------------------------------------------------------


def export_prefix(engine, bucket: int, ids, from_token: int = 0,
                  config: Optional[MigrationConfig] = None,
                  clock: Callable[[], float] = time.monotonic
                  ) -> Optional[PageExport]:
    """Stage the cached pages of ``ids``' deepest match (from
    ``from_token`` on) to host chunks. Runs on the SOURCE replica's
    supervisor thread (a page op); the match is pinned throughout.
    Returns None when nothing beyond ``from_token`` is cached (the chain
    falls back to a local prefill)."""
    cfg = config or MigrationConfig()
    tree = getattr(engine, "prefix_cache", None)
    if tree is None:
        return None
    match = tree.lookup(bucket, ids, record=False)
    gov_key = None
    try:
        ps = tree.page_size
        from_page = max(int(from_token), 0) // ps
        pages = list(match.pages[from_page:])
        if not pages:
            return None
        gov = getattr(engine, "governor", None)
        if gov is not None:
            gov_key = f"migrate_buf:{getattr(engine.cfg, 'name', 'model')}"
            gov.register(gov_key, tree.pool.page_nbytes() * len(pages))
        chunk_n = max(int(cfg.chunk_pages), 1)
        window = max(int(cfg.inflight_chunks), 1)
        card = cache_leaves(tree.pool.leaves)[0].device.type == "cuda"
        t0 = clock()
        serial = crc_s = 0.0
        chunks: List[Tuple[Any, int]] = []
        sums: List[int] = []
        pending: deque = deque()

        def start(pc) -> None:
            blocks = tree.pool.extract(pc, pad_to=chunk_n)
            if card:
                # Owned pinned buffers, one set a chunk; the copy follows
                # the gather (and the scatter that wrote the pages) on
                # the current stream.
                host = cache_map(lambda a: torch.empty(
                    a.shape, dtype=a.dtype, pin_memory=True).copy_(
                        a, non_blocking=True), blocks)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = blocks, None      # extract made a copy
            pending.append((host, blocks, done, len(pc), clock()))

        def consume() -> None:
            nonlocal serial, crc_s
            host, _blocks, done, n, t_disp = pending.popleft()
            if done is not None:
                done.synchronize()
            serial += clock() - t_disp
            chunks.append((host, n))
            t1 = time.perf_counter()
            sums.append(chunk_checksum(host))
            crc_s += time.perf_counter() - t1

        for k in range(0, len(pages), chunk_n):
            # The next chunk's gather and copy start before the previous
            # one is consumed: the bounded in-flight window.
            start(pages[k:k + chunk_n])
            while len(pending) >= window + 1:
                consume()
        while pending:
            consume()
        return PageExport(
            bucket=int(bucket),
            ids=tuple(int(t) for t in ids[:match.tokens]),
            start_tokens=from_page * ps, page_size=ps, n_pages=len(pages),
            chunk_pages=chunk_n, chunks=chunks, checksums=sums,
            nbytes=tree.pool.page_nbytes() * len(pages),
            wall_s=clock() - t0, serial_s=serial, crc_s=crc_s)
    finally:
        if gov_key is not None:
            engine.governor.unregister(gov_key)
        tree.release(match)


def import_prefix(engine, export: PageExport,
                  config: Optional[MigrationConfig] = None,
                  clock: Callable[[], float] = time.monotonic
                  ) -> ImportResult:
    """Land an export in the DESTINATION replica's pool and tree. Runs on
    the destination's supervisor thread (a page op), atomically for any
    dispatch: the nodes appear and their pages fill inside one op, or on
    any failure everything rolls back (refcounts restored, nodes removed,
    pages freed). Raises :class:`MigrationError` on a checksum mismatch
    or a layout disagreement; the router then re-prefills locally."""
    cfg = config or MigrationConfig()
    tree = getattr(engine, "prefix_cache", None)
    if tree is None:
        raise MigrationError("destination replica has no page pool")
    if tree.page_size != export.page_size:
        raise MigrationError(
            f"page-size mismatch: export {export.page_size} vs "
            f"destination {tree.page_size}")
    crc_s = 0.0
    if cfg.verify:
        t1 = time.perf_counter()
        for ci, (host, _) in enumerate(export.chunks):
            if chunk_checksum(host) != export.checksums[ci]:
                raise MigrationError(
                    f"transfer chunk {ci} checksum mismatch — pages "
                    f"corrupted in flight, refusing to land them")
        crc_s = time.perf_counter() - t1
    ps = export.page_size
    t0 = clock()
    start_tok, new_pages = tree.plan_insert(export.bucket, export.ids)
    if not new_pages:
        return ImportResult(pages=0, nbytes=0, wall_s=clock() - t0,
                            crc_s=crc_s)
    if start_tok < export.start_tokens:
        # The destination lost pages since the probe; the export cannot
        # fill the gap, and a torn prefix must never enter the tree.
        tree.forget_tail(export.bucket, export.ids, len(new_pages))
        raise MigrationError(
            f"export starts at token {export.start_tokens} but the "
            f"destination needs from {start_tok} (pages evicted since "
            f"the probe)")
    # The transfer pin: fresh pages are unevictable until their data
    # lands.
    tree.pool.incref(new_pages)
    skip = (start_tok - export.start_tokens) // ps
    window = max(int(cfg.inflight_chunks), 1)
    serial = 0.0
    gov = getattr(engine, "governor", None)
    gov_key = None
    if gov is not None:
        gov_key = f"migrate_buf:{getattr(engine.cfg, 'name', 'model')}"
        gov.register(gov_key, tree.pool.page_nbytes() * len(new_pages))
    try:
        dev = cache_leaves(tree.pool.leaves)[0].device
        pending: deque = deque()

        def land() -> None:
            nonlocal serial
            blocks, dst_ids, t_disp = pending.popleft()
            tree.pool.insert(blocks, dst_ids)
            serial += clock() - t_disp

        idx = 0
        for host, n in export.chunks:
            lo = max(idx, skip)
            hi = min(idx + n, skip + len(new_pages))
            if hi > lo:
                s0, s1 = lo - idx, hi - idx
                # The whole chunk crosses (one contiguous copy from its
                # pinned buffers); the slice is taken on the device.
                block = cache_map(
                    lambda a: a.to(dev, non_blocking=True)[:, :, s0:s1],
                    host)
                pending.append((block, new_pages[lo - skip:hi - skip],
                                clock()))
                while len(pending) >= window + 1:
                    land()
            idx += n
        while pending:
            land()
    except BaseException:
        tree.pool.decref(new_pages)           # the transfer pin
        tree.forget_tail(export.bucket, export.ids, len(new_pages))
        raise
    finally:
        if gov_key is not None:
            gov.unregister(gov_key)
    tree.pool.decref(new_pages)
    return ImportResult(
        pages=len(new_pages),
        nbytes=tree.pool.page_nbytes() * len(new_pages),
        wall_s=clock() - t0, serial_s=serial, crc_s=crc_s)


# ---------------------------------------------------------------------------
# The migrator (router-held; the fault seam)
# ---------------------------------------------------------------------------


class PageMigrator:
    """The router's migration policy object: config, stats and the
    ``transfer`` wire hop between export and import.

    ``transfer`` is the identity on one process: it is the one seam the
    transport (a network hop between processes) and the fault kinds
    (``faults.wrap_migrator``) wrap."""

    def __init__(self, config: Optional[MigrationConfig] = None,
                 stats: Optional[MigrationStats] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or MigrationConfig()
        self.stats = stats if stats is not None else MigrationStats()
        self.clock = clock

    def transfer(self, export: PageExport) -> PageExport:
        """The wire hop; in process, a no-op."""
        return export

    def account(self, export: PageExport, imp: ImportResult) -> None:
        """Fold one completed chain into the stats: exposed = the legs'
        wall seconds, hidden = in-flight seconds the window overlapped
        away (serial sum less wall, a leg)."""
        self.stats.add_transfer(
            pages=imp.pages, nbytes=imp.nbytes,
            chunks=len(export.chunks),
            exposed_s=export.wall_s + imp.wall_s,
            hidden_s=(max(export.serial_s - export.wall_s, 0.0)
                      + max(imp.serial_s - imp.wall_s, 0.0)))
