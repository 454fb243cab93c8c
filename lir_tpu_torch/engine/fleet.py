"""Fleet scheduler: model-id-aware engine orchestration for the
inter-model agreement axis.

Port of ``lir_tpu/engine/fleet.py``:

- a :class:`ModelFleet` owns one :class:`~lir_tpu_torch.engine.runner.
  ScoringEngine` per model plus the budgeted LRU
  :class:`~lir_tpu_torch.models.weights.WeightCache` and the
  single-worker :class:`~lir_tpu_torch.models.weights.AsyncWeightStreamer`;
- ``acquire(model_id)`` makes a model's weights device-resident (cache
  hit: free; prefetched: only the wait not overlapped; cold: an inline
  load, all exposed) and refcounts them for the caller's dispatch
  stream, so LRU eviction never pulls weights from under a dispatch;
- ``prefetch(model_id)`` starts the next model's load on the worker
  while the current one scores (``engine/multi.py``'s sweep loop is the
  pipeline); a prefetched load that ran out of device memory beside the
  scoring model is loaded again inline at ``acquire``, after the idle
  models have left (the JAX fleet has no such retry).

The fleet server (``serve/server.FleetScoringServer``) and the router's
residency map (``serve/router.py``) ride this fleet. The JAX fleet's
``sweep`` helper, whose one caller is the JAX benchmark, comes with the
port's benchmark; the memory tiers' ``attach_tiers`` /
``reseed_weights`` wait for ROADMAP A8d.

Engines are built once (tokenizer, buckets and counters persist); only
the param tree moves. A re-streamed tree is bitwise its staged
original, so results never depend on eviction history.

Loads run on the worker thread (a prefetch) or inline, in both cases on
the fleet's copy stream; every loaded tensor is recorded on the
consumer's compute stream before the fleet hands it out
(``weights.record_streams``), so an evicted model's blocks are reused by
a later load only after the kernels queued on the compute stream have
read them.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..models import weights
from ..utils.logging import get_logger
from ..utils.profiling import FleetStats, is_oom_error
from . import hbm

log = get_logger(__name__)

# An engine factory maps model id -> ready ScoringEngine (models/
# factory.engine_factory is the checkpoint-backed one; tests inject
# closures over tiny params).
EngineFactory = Callable[[str], Any]


class _Slot:
    """One model's fleet state. ``engine`` is built lazily (on the
    prefetch worker when possible); ``staged`` is the pinned host copy
    reloads stream from."""

    __slots__ = ("model_id", "make_engine", "engine", "staged", "nbytes")

    def __init__(self, model_id: str,
                 make_engine: Optional[EngineFactory] = None,
                 engine: Any = None):
        self.model_id = model_id
        self.make_engine = make_engine
        self.engine = engine
        self.staged: Any = None
        self.nbytes: int = 0


class ModelFleet:
    """Co-resident model pool + async weight streaming + swap
    accounting. ``acquire``/``release``/``prefetch`` run on ONE consumer
    thread; the streamer's worker is the only other thread that touches
    slots, and each slot it writes is handed over through a future
    (happens-before at ``take``)."""

    def __init__(self, cache_budget_bytes: Optional[int] = None,
                 prefetch: bool = True, mesh=None,
                 stage_reloads: bool = True,
                 stats: Optional[FleetStats] = None,
                 governor: Optional[hbm.HbmGovernor] = None):
        if mesh is not None:
            raise NotImplementedError(
                "ModelFleet: a mesh is multi-device work the port does not "
                "have yet")
        self.stats = stats if stats is not None else FleetStats()
        self.prefetch_enabled = bool(prefetch)
        # Keep a pinned host copy at first load, so an evicted model
        # reloads by one host to device copy instead of a checkpoint
        # conversion. Costs host memory = the fleet's weight bytes; a
        # sweep that visits each model once turns it off.
        self.stage_reloads = bool(stage_reloads)
        self.cache = weights.WeightCache(cache_budget_bytes,
                                         stats=self.stats,
                                         on_evict=self._on_evict)
        self.streamer = weights.AsyncWeightStreamer()
        self._slots: Dict[str, _Slot] = {}
        self._order: List[str] = []
        self._active: Optional[str] = None
        self._lock = threading.RLock()
        self._copy_stream = None
        # The device-memory governor (engine/hbm.py): the cache's
        # residency rides its ledger under "weights", and its
        # evict_weights rung drops one idle LRU model through the
        # cache's own refcount discipline.
        self.governor = governor
        if governor is not None:
            governor.register("weights", 0)
            governor.set_action("evict_weights", engage=self.evict_idle)
            self.cache.add_listener(self._on_residency_event)

    # -- construction --------------------------------------------------------

    def attach_governor(self, governor: hbm.HbmGovernor) -> None:
        """Adopt a governor after construction (so weights, pages, pins
        and the parked carry land in ONE ledger). Re-validates every
        sized slot against the budget and seeds the weights entry."""
        if self.governor is governor:
            return
        self.governor = governor
        governor.set_action("evict_weights", engage=self.evict_idle)
        self.cache.add_listener(self._on_residency_event)
        governor.update("weights", self.cache.resident_bytes)
        with self._lock:
            for slot in self._slots.values():
                if slot.nbytes:
                    hbm.validate_fleet_budget(
                        slot.model_id, slot.nbytes,
                        self.cache.budget_bytes, governor=governor)

    def add_model(self, model_id: str, engine: Any = None,
                  make_engine: Optional[EngineFactory] = None) -> None:
        """Register a model. With ``engine`` (already loaded) its params
        move under cache ownership at once: the engine keeps everything
        BUT the weights. With ``make_engine`` the first acquire or
        prefetch builds the engine (the checkpoint load runs on the
        worker)."""
        assert (engine is None) != (make_engine is None), (
            "pass exactly one of engine / make_engine")
        with self._lock:
            assert model_id not in self._slots, f"duplicate model {model_id}"
            slot = _Slot(model_id, make_engine=make_engine, engine=engine)
            if engine is not None:
                params = engine.params
                slot.nbytes = weights.tree_bytes(params)
                # A budget smaller than this model can never hold it:
                # fail now, with the arithmetic.
                hbm.validate_fleet_budget(model_id, slot.nbytes,
                                          self.cache.budget_bytes,
                                          governor=self.governor)
                if self.stage_reloads:
                    slot.staged = weights.host_stage(params)
                self.cache.insert(model_id, params, slot.nbytes)
                # The cache owns these bytes now: a shared governor
                # counts them once, under "weights".
                release = getattr(engine, "release_params_ledger", None)
                if release is not None:
                    release()
            self._slots[model_id] = slot
            self._order.append(model_id)

    @classmethod
    def from_factory(cls, factory: EngineFactory,
                     model_ids: Sequence[str], **kwargs) -> "ModelFleet":
        fleet = cls(**kwargs)
        for mid in model_ids:
            fleet.add_model(mid, make_engine=factory)
        return fleet

    @classmethod
    def from_engines(cls, engines: Sequence[tuple], **kwargs
                     ) -> "ModelFleet":
        """[(model_id, ScoringEngine), ...]: engines already built."""
        fleet = cls(**kwargs)
        for mid, engine in engines:
            fleet.add_model(mid, engine=engine)
        return fleet

    @property
    def model_ids(self) -> List[str]:
        return list(self._order)

    def engine(self, model_id: str) -> Any:
        """The model's engine WITHOUT making its weights resident (None
        until the first load of a factory slot)."""
        return self._slots[model_id].engine

    def resident(self, model_id: str) -> bool:
        return model_id in self.cache

    def staged(self, model_id: str) -> Any:
        """The model's pinned host copy (None without staging)."""
        return self._slots[model_id].staged

    # -- load path -----------------------------------------------------------

    def _on_residency_event(self, event: str, model_id: str) -> None:
        """WeightCache listener: mirror resident bytes into the
        governor's ledger (cheap; never touches the cache)."""
        if self.governor is not None:
            self.governor.update("weights", self.cache.resident_bytes)

    def evict_idle(self) -> bool:
        """The governor's evict_weights rung: drop ONE idle LRU model
        (its staged host copy survives, so a re-acquire streams it back
        bitwise). True when a model was evicted."""
        return self.cache.evict_idle() is not None

    def _on_evict(self, model_id: str) -> None:
        slot = self._slots.get(model_id)
        if slot is None or slot.engine is None:
            return
        # The cache's entry was the canonical reference; the engine's
        # params pointer is the straggler that would keep the memory.
        slot.engine.params = None
        slot.engine.fresh_handoff()

    def _streams(self):
        """(copy stream, the consumer's compute stream), or (None, None)
        without a card. Read on the consumer's thread."""
        if not torch.cuda.is_available():
            return None, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream()
        return self._copy_stream, torch.cuda.current_stream()

    def _load(self, slot: _Slot, copy_stream, compute_stream) -> Any:
        """Runs on the streamer's worker (a prefetch) or inline (a cold
        acquire): the model's device param tree, fully landed and
        recorded on ``compute_stream``."""
        if slot.staged is not None:
            dev = slot.engine.device
            return weights.stream_params(
                slot.staged, device=dev, stats=self.stats,
                copy_stream=copy_stream if dev.type == "cuda" else None,
                compute_stream=compute_stream)
        if copy_stream is not None:
            with torch.cuda.stream(copy_stream):
                engine = slot.make_engine(slot.model_id)
            copy_stream.synchronize()
        else:
            engine = slot.make_engine(slot.model_id)
        params = engine.params
        weights.record_streams(params, compute_stream)
        slot.engine = engine
        slot.nbytes = weights.tree_bytes(params)
        # A factory slot learns its size at its first load: the same
        # budget arithmetic add_model runs for built engines.
        hbm.validate_fleet_budget(slot.model_id, slot.nbytes,
                                  self.cache.budget_bytes,
                                  governor=self.governor)
        release = getattr(engine, "release_params_ledger", None)
        if release is not None:
            release()    # the cache owns the bytes from here
        if self.stage_reloads:
            slot.staged = weights.host_stage(params)
        return params

    def prefetch(self, model_id: str) -> None:
        """Start loading ``model_id``'s weights in the background (a
        no-op when resident, prefetch is off, or a load is in flight)."""
        if not self.prefetch_enabled:
            return
        slot = self._slots[model_id]
        if model_id in self.cache:
            return
        copy_stream, compute_stream = self._streams()
        self.streamer.prefetch(
            model_id, lambda: self._load(slot, copy_stream, compute_stream))

    def acquire(self, model_id: str):
        """The engine with its weights device-resident and refcounted.
        Swap accounting: a cache hit costs nothing; a prefetched load
        books only the wait not overlapped as exposed; a cold inline
        load, or one retried after its prefetch ran out of memory, is all
        exposed."""
        slot = self._slots[model_id]
        if model_id in self.cache:
            params = self.cache.acquire(model_id)
            self.stats.count("cache_hits")
        else:
            oom = False
            try:
                taken = self.streamer.take(model_id)
            except Exception as exc:
                if not is_oom_error(exc):
                    raise
                log.warning("fleet: the prefetched load of %s ran out of "
                            "device memory (%s); loading it inline",
                            model_id, exc)
                taken, oom = None, True
            if oom:
                # Out of the except block: the failed load's tensors,
                # held by its traceback until here, can be freed.
                self._make_room()
            if taken is not None:
                params, load_s, waited = taken
                self.stats.count("prefetch_hits")
                self.stats.count("loads")
                self.stats.count("load_s", load_s)
                self.stats.count("swap_s_exposed", waited)
                self.stats.count("swap_s_hidden", max(load_s - waited, 0.0))
            else:
                t0 = time.perf_counter()
                params = self._load(slot, *self._streams())
                load_s = time.perf_counter() - t0
                self.stats.count("prefetch_misses")
                self.stats.count("loads")
                self.stats.count("load_s", load_s)
                self.stats.count("swap_s_exposed", load_s)
            self.cache.insert(model_id, params, slot.nbytes or None)
            params = self.cache.acquire(model_id)
        if self._active != model_id:
            self.stats.count("model_swaps")
            self._active = model_id
        slot.engine.params = params
        return slot.engine

    def release(self, model_id: str) -> None:
        self.cache.release(model_id)

    def _make_room(self) -> None:
        """Before an inline load retried after a prefetch's OOM: evict
        every idle model and return the failed load's blocks."""
        while self.cache.evict_idle() is not None:
            pass
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- speculative drafting (engine/spec.py) -------------------------------

    def acquire_spec_draft(self, engine, model_id: str) -> Optional[str]:
        """When ``engine.rt.spec_draft_model`` names ANOTHER fleet model,
        make its weights resident and REFCOUNTED (unevictable for the
        dispatch stream: drafting never evicts the verifier, nor the
        verifier the drafter) and arm the verifier's fleet drafting
        (``ScoringEngine.set_spec_draft``). Returns the draft id for
        :meth:`release_spec_draft`, or None when fleet drafting does not
        apply (self-drafting, an unknown id, drafting for itself, no
        speculation)."""
        draft_id = getattr(engine.rt, "spec_draft_model", "")
        if (not draft_id or draft_id == model_id
                or draft_id not in self._slots
                or not getattr(engine, "spec_supported", lambda: False)()):
            return None
        dengine = self.acquire(draft_id)
        try:
            engine.set_spec_draft(dengine.params, dengine.cfg, draft_id)
        except BaseException:
            self.release(draft_id)
            raise
        return draft_id

    def release_spec_draft(self, engine, draft_id: Optional[str]) -> None:
        """Disarm fleet drafting and drop the draft weights' dispatch
        reference (the LRU cache decides residency from here)."""
        if draft_id is None:
            return
        engine.clear_spec_draft()
        self.release(draft_id)

    def pin(self, model_id: str) -> None:
        self.cache.pin(model_id)

    def unpin(self, model_id: str) -> None:
        self.cache.unpin(model_id)

    def shutdown(self) -> None:
        self.streamer.shutdown()

    def drop_all(self) -> None:
        """Evict every resident model (none may be in flight or pinned):
        a fleet built for one sweep gives its memory back at the end."""
        for mid in self.cache.resident_models:
            self.cache.drop(mid)
