"""Batched scoring engine on PyTorch: the cold, unpaged main path.

Port of ``lir_tpu/engine/runner.py``'s ``ScoringEngine`` (the part the
word-meaning sweep and the shared-prefix dispatch run): prompts are
packed into fixed-shape padded batches bucketed by token length, one
greedy decode with the readouts fused into the loop runs per batch, and
the C13 readout applies vectorised over the batch.

Routing is the JAX engine's default: a shared dispatch whose rows share
a trunk takes the cascade prefill and the trunk-aware decode kernel; any
other shared dispatch of the ragged sweep takes the dense shared prefill
and then the speculative verify loop (engine/spec.py, the multi-query
decode kernels, trunk-aware where its rows share a trunk), or with
``spec_decode`` off the sequential loop on the single-query kernels. A
grouped dispatch of the ragged sweep (``decode_fused_grouped``) prefills
one row per prefix group, gathers it out to the member rows and runs the
sequential loop on the single-query kernel.

With ``RuntimeConfig.prefix_cache`` the engine keeps a paged KV pool and
a radix tree over it (models/paged.py, engine/prefix_tree.py): every
ragged-sweep dispatch pins its rows' cached prefix pages; where a
remainder window covers the uncached tails, its prefill front becomes a
slot gather from the pool plus one window extension (the ``*_paged``
variants in engine/generate.py; the cascade's trunk in its own
trunk-extent namespace), and afterwards the dispatch's new full prefix
pages are copied into the pool from its final cache. The
speculative drafts then also come from the tree's token history.
:meth:`ScoringEngine.prefill_insert` is the prefill-only dispatch of
disaggregated serving (serve/migrate.py): it fills pool pages and
decodes nothing. The
kernels run on CUDA tensors and their plain PyTorch versions on CPU
tensors, so the engine routes the same way on both; the JAX engine
routes to its kernels only on a TPU (or under its interpreter hooks).

The 8-bit path is the same engine with int8 params
(``models.quant.quantize_decoder_params`` or ``init_quantized_params``),
``ModelConfig.use_flash_attention`` (prefill flash kernel),
``RuntimeConfig.cascade_fused_suffix=False`` and
``CascadeConfig(int8_qk=True)`` (the two-leg cascade, int8 QK^T in its
trunk leg).

Piggyback chains (``RuntimeConfig.piggyback_prefill``, on by default as
in the JAX engine): the ragged sweep submits runs of consecutive
same-shape shared dispatches without a cascade trunk through
:meth:`ScoringEngine.decode_fused_shared_piggy`, each call running the
parked dispatch's decode loops and then its own prefill
(``generate.shared_piggyback_*``); ``kernel_stats`` counts the chains.
With ``ModelConfig.kv_cache_int8`` the cache is int8 and its cached
attention runs ``ops.kv_int8_attention``; the cascade routes are off
there, as in the JAX engine.

Temperature sampling (``sample_completions*``, ``score_prompts_sampled``:
the rephraser and the sweep's reasoning mode) runs
``generate.sample_decode`` on decoder engines, with JAX's threefry keys
(``engine/prng.py``).

Device memory (engine/hbm.py): every engine holds a governor (its own,
or one shared through ``governor=``) and registers its params
(``params:<model>``), its page pool (``kv_pages:<model>``), a fleet
draft model's pin (``spec_draft:<model>``) and a parked piggyback carry
(``handoff:<model>``) in its ledger; each dispatch ticks it once
(``decode_fused_shared``, ``decode_fused_grouped``, each piggyback
call and drain, each word-meaning batch). Its ``no_piggyback`` rung
refuses new chains and its ``no_spec`` rung sends speculative
dispatches down the sequential loop, bitwise the same, each counted
under ``spec_stats["fallbacks"]``. Fleet drafting
(:meth:`ScoringEngine.set_spec_draft`, armed by ``engine/fleet.py``)
drafts with another model's weights on the unpaged speculative route;
a paged-warm dispatch falls back to the sequential paged route.

Guard and faults (guard/, faults/): every engine owns a dispatch
watchdog (``watchdog``, deadlines from ``RuntimeConfig.watchdog_*``,
counters in ``guard_stats``) that the sweep's dispatch recovery and the
serve supervisor run their dispatches under, a ``fault_stats`` the
sweep's recovery counts into, and a ``spec_fault_plan`` hook
(faults.wrap_engine) through which a fault plan corrupts speculative
drafts. :meth:`ScoringEngine.reset_dispatch_state` is the recovery's
first step after a failed dispatch.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CascadeConfig, GovernorConfig, RuntimeConfig, SpecConfig
from ..device import resolve_device
from ..guard.watchdog import DispatchWatchdog
from ..models import decoder, paged, quant
from ..utils.profiling import (FaultStats, GuardStats, KernelStats,
                               PrefixCacheStats)
from . import (generate, hbm, prefix_tree, prng, scheduler as sched_mod,
               score, spec as spec_mod, tokens as tok)

log = logging.getLogger(__name__)

# Suffix buckets of the shared path (the JAX engine's).
SFX_BUCKETS = (8, 16, 32, 64, 128, 256)


class PiggybackIneligible(RuntimeError):
    """A dispatch cannot ride the piggyback chain (layout fallback,
    learned-position ceiling, no memory headroom for two caches): the
    caller dispatches it through the plain path instead. Control flow,
    not an error."""


def _tail_batch(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at the configured batch size."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class _PrefixPlan:
    """One dispatch's radix-cache resume decision (engine-internal).

    ``window`` is the remainder-window edge the paged front runs (each
    row recomputes the window's slice of its prefix and gathers
    everything earlier from the page pool), or None when nothing useful
    is cached: the dispatch then runs the plain unpaged prefill and only
    INSERTS pages afterwards. ``matches`` hold the dispatch's page pins;
    every plan MUST pass through ScoringEngine._finish_prefix_resume
    (which inserts the new pages and releases the pins) or
    _abort_prefix_resume."""

    bucket: int
    prefix_ids: List[Sequence[int]]
    matches: List[Any]
    n_real: int
    window: Optional[int] = None
    w0: int = 0
    slot_src: Optional[np.ndarray] = None
    rem: Optional[np.ndarray] = None
    rem_mask: Optional[np.ndarray] = None


@dataclasses.dataclass
class PromptScore:
    """One prompt's raw measurement. Sweep drivers wrap this into
    data/schemas.py records."""

    prompt: str
    completion: str
    yes_prob: float
    no_prob: float
    yes_logprob: float
    no_logprob: float
    odds_ratio: float
    relative_prob: float
    position_found: int
    yes_no_found: bool


@dataclasses.dataclass
class SampledScore:
    """n-run count-averaged measurement (reasoning-model mode,
    perturb_prompts.py:412-446): probabilities are answer-count fractions,
    not logit softmaxes."""

    prompt: str
    response: str               # most common run text
    all_responses: List[str]
    token_1_prob: float
    token_2_prob: float
    odds_ratio: float


class ScoringEngine:
    """Holds (params, cfg, tokenizer) on one device and runs the scoring
    path. ``device`` defaults to CUDA and raises without a card; the CPU
    must be asked for.

    ``encoder_decoder=True`` takes a T5 tree and ``T5Config``
    (models/encdec.py) and scores through the capture path
    (:meth:`decode_prompts`, ``generate.t5_greedy_decode``); the shared,
    grouped and fused dispatches, the prefix cache, the cascade and
    speculative decode are decoder-only, as in the JAX engine.

    ``governor`` shares a device-memory governor (engine/hbm.py) between
    engines; else the engine builds its own from ``governor_config``
    (its budget from the card's memory; unbounded on the CPU)."""

    def __init__(self, params: Any, cfg: Any, tokenizer: Any,
                 runtime: Optional[RuntimeConfig] = None,
                 cascade_config: Optional[CascadeConfig] = None,
                 spec_config: Optional[SpecConfig] = None,
                 device="cuda", encoder_decoder: bool = False,
                 governor: Optional[hbm.HbmGovernor] = None,
                 governor_config: Optional[GovernorConfig] = None):
        self.device = resolve_device(device)
        self.encoder_decoder = bool(encoder_decoder)
        first = params["shared_embed" if encoder_decoder else "tok_embed"]
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.tokenizer = tokenizer
        self.rt = runtime or RuntimeConfig()
        self.cascade_cfg = cascade_config or CascadeConfig()
        self.spec_cfg = spec_config or SpecConfig()
        # Kernel choices are runtime flags mirrored into the model config,
        # as in the JAX engine (a T5 config has none).
        self.cfg = cfg if encoder_decoder else dataclasses.replace(
            cfg, fused_decode=self.rt.fused_decode,
            cascade_decode=self.rt.cascade_decode,
            cascade_fused_suffix=self.rt.cascade_fused_suffix)
        # Routing counters: cascade_dispatches, dense_shared_dispatches
        # (dense shared prefill + the sequential loop), dense_fallbacks,
        # cascade_decode_dispatches.
        self.cascade_stats = collections.Counter()
        # Speculative-decode counters, the JAX SpecStats field names:
        # spec_dispatches, spec_rows (counted at dispatch); drafted_tokens,
        # accepted_tokens, draft_tree, accepted_tree, draft_ngram,
        # accepted_ngram, decode_forwards, seq_forwards (folded from the
        # pending SpecOuts by spec_flush).
        self.spec_stats = collections.Counter()
        self._spec_pending: List[Tuple[Any, Any]] = []
        # A fleet draft model armed by set_spec_draft: (params, cfg, name).
        self._spec_draft: Optional[Tuple[Any, Any, str]] = None
        # The cross-request radix prefix cache (models/paged.py +
        # engine/prefix_tree.py), built by enable_prefix_cache() when
        # RuntimeConfig.prefix_cache is set; its counters, and the
        # paged routes taken (shared_paged, shared_paged_spec,
        # cascade_paged, grouped_paged).
        self.prefix_cache: Optional[prefix_tree.RadixPrefixCache] = None
        self.prefix_stats = PrefixCacheStats()
        self.paged_dispatches = collections.Counter()
        # The perturbation sweep's writer thread decodes completion text
        # while the main thread tokenizes: tokenizer calls take this lock.
        self._tok_lock = threading.Lock()
        # The last ragged sweep's scheduler counters
        # (utils.profiling.OccupancyStats; None outside a ragged sweep).
        self.occupancy = None
        # The numerics guard's counters (the perturbation sweep checks
        # every row's readouts when RuntimeConfig.numerics_guard is on),
        # and the last perturbation sweep's streaming-statistics sink
        # (engine/stream_stats.StreamSink; None with the sink off).
        self.guard_stats = GuardStats()
        self.stream_sink = None
        # Dispatch recovery counters (the sweep's _dispatch_with_recovery)
        # and the fault plan whose "draft" site corrupts speculative
        # drafts (faults.wrap_engine sets it; spec.build_plan reads it).
        self.fault_stats = FaultStats()
        self.spec_fault_plan = None
        # The piggyback chain's counters (chains_opened,
        # piggybacked_steps, chains_drained, chain_fallbacks) and its
        # parked dispatch (None between chains).
        self.kernel_stats = KernelStats()
        self._piggy: Optional[dict] = None
        self.yes_id, self.no_id = tok.yes_no_ids(
            tokenizer, encoder_decoder=self.encoder_decoder)
        self.eos_id = getattr(tokenizer, "eos_token_id", None)
        if self.rt.ragged_scheduler:
            self.buckets = list(tok.bucket_ladder(self.rt.max_seq_len))
        else:
            self.buckets = [b for b in (64, 128, 256, 512, 1024)
                            if b <= self.rt.max_seq_len] or [self.rt.max_seq_len]
        if getattr(cfg, "pos_embedding", None) == "learned":
            # A bucket + generation budget past the learned-position table
            # would read beyond pos_embed: trim such buckets.
            limit = cfg.max_seq_len - self.rt.max_new_tokens
            fitting = [b for b in self.buckets if b <= limit]
            if not fitting:
                raise ValueError(
                    f"{cfg.name}: no length bucket fits the learned-"
                    f"position table ({cfg.max_seq_len} rows) minus the "
                    f"generation budget ({self.rt.max_new_tokens})")
            self.buckets = fitting
        self._digit_table: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._digit_stop_mask: Any = False  # False = not resolved yet
        self._eos_stop_mask: Optional[torch.Tensor] = None
        # The device-memory governor, built BEFORE the prefix cache so
        # the pool's reservation lands in its ledger. Ledger keys carry
        # the model's name, so engines sharing a governor never collide.
        self.governor: hbm.HbmGovernor = (
            governor if governor is not None
            else hbm.HbmGovernor(governor_config, device=self.device))
        name = getattr(cfg, "name", "model")
        self._ledger_key = f"params:{name}"
        self._handoff_key = f"handoff:{name}"
        self.governor.register(self._ledger_key, quant.param_bytes(params))
        # The no_piggyback rung has no action here: the JAX engine gives
        # back its donation chain's scratch cache there, and the port
        # keeps none (its one cache between engine calls is a parked
        # chain's carry, whose decode is still owed); the rung's effect
        # is that no new chain opens. The evict_pages action holds the
        # engine weakly: no cycle through the governor, so a dropped
        # engine frees its tensors at once, not at the next gc pass.
        engine_ref = weakref.ref(self)

        def evict_pages() -> bool:
            engine = engine_ref()
            return engine is not None and engine._evict_cold_pages()

        self.governor.set_action("evict_pages", engage=evict_pages)
        if self.rt.prefix_cache:
            self.enable_prefix_cache()
        # The dispatch watchdog (guard/watchdog.py). A speculating engine
        # prices dispatches at the speculative decode floor and a cascade
        # engine on trunk-discounted prefills, so their first calibration
        # sample takes the wider headroom (a zero-accept dispatch or a
        # dense fallback must never trip a deadline calibrated on them).
        self.watchdog = DispatchWatchdog(
            multiple=self.rt.watchdog_multiple,
            floor_s=self.rt.watchdog_floor_s, stats=self.guard_stats,
            seed_headroom=sched_mod.watchdog_seed_headroom(
                self.rt.spec_decode and self.rt.spec_k >= 2,
                cascade=self.cascade_supported()))

    # -- device-memory governor (engine/hbm.py) ------------------------------

    def _tick(self) -> None:
        """One dispatch boundary: the governor's ladder tick."""
        self.governor.tick()

    def fresh_handoff(self) -> None:
        """Drop the ledger's parked-carry entry (the fleet calls this when
        it evicts the engine's weights; no chain is parked then)."""
        self.governor.unregister(self._handoff_key)

    def reset_dispatch_state(self) -> None:
        """The dispatch recovery's first step after a failed dispatch
        (the JAX engine's ``degrade_to_lazy``, which drops its AOT
        executable registry and resets its cache-donation chain). Eager
        PyTorch has no executable registry and the port no donation
        chain: what a failed dispatch can leave behind is a parked
        piggyback carry and its ledger entry, dropped here (the chain's
        owner re-runs the parked dispatch plainly). A prefix-cache plan
        releases its pins on the failure itself."""
        if self._piggy is not None:
            self.kernel_stats.count("chain_fallbacks")
        self._piggy = None
        self.fresh_handoff()

    def release_params_ledger(self) -> None:
        """The fleet's weight cache now owns this engine's param bytes:
        drop the engine's ``params:`` entry, so a shared governor never
        counts them twice (engine/fleet.py calls this)."""
        self.governor.unregister(self._ledger_key)

    def _evict_cold_pages(self) -> bool:
        """The evict_pages rung: drop the coldest radix pages (the pool's
        refcounts keep in-flight pages). True when a page was freed."""
        if self.prefix_cache is None:
            return False
        return self.prefix_cache.evict(
            self.governor.cfg.evict_pages_per_step) > 0

    def _note_handoff(self, carry) -> None:
        """Ledger a parked chain's carry (its cache's bytes, from the
        tensors' sizes: no device sync)."""
        self.governor.register(self._handoff_key, sum(
            t.numel() * t.element_size()
            for t in decoder.cache_leaves(carry.cache)))

    # -- kernel gates -------------------------------------------------------

    def cascade_supported(self) -> bool:
        """Engine-level gate of the cascade prefill. The kernels always
        run on the engine's device (the CUDA kernels on a card, their
        plain versions on the CPU), so the gate is the flag on a decoder
        engine with a float KV cache (the cascade writes float k/v into
        the broadcast trunk cache); the JAX engine also asks for a TPU
        there. Per-dispatch eligibility is :meth:`cascade_trunk_for`'s."""
        return (self.rt.cascade_prefill and not self.encoder_decoder
                and not getattr(self.cfg, "kv_cache_int8", False))

    def cascade_trunk_for(self, prefix_ids: Sequence[Sequence[int]],
                          n_real: Optional[int] = None,
                          bucket: Optional[int] = None) -> int:
        """The dispatch's shared-trunk extent, or 0 for the dense path:
        the all-rows longest common prefix snapped down to the trunk
        quantum, strictly inside the bucket, floored at min_trunk."""
        if not self.cascade_supported() or not prefix_ids:
            return 0
        return self._lcp_trunk(prefix_ids, n_real, bucket)

    def _lcp_trunk(self, prefix_ids: Sequence[Sequence[int]],
                   n_real: Optional[int], bucket: Optional[int]) -> int:
        cc = self.cascade_cfg
        rows_real = len(prefix_ids) if n_real is None else n_real
        if rows_real < max(cc.min_rows, 2):
            return 0
        q = max(int(cc.trunk_quantum), 1)
        trunk = (tok.common_prefix_len(prefix_ids) // q) * q
        if bucket is not None and trunk >= bucket:
            trunk = ((bucket - 1) // q) * q
        if trunk < max(int(cc.min_trunk), q):
            return 0
        return trunk

    def cascade_decode_supported(self) -> bool:
        """Gate of the trunk-aware decode kernel: on by config, with the
        flash-decode route on, on a decoder engine with a float KV cache
        (an int8 cache's steps run ``ops.kv_int8_attention``)."""
        return (self.rt.cascade_decode and not self.encoder_decoder
                and self.cfg.fused_decode and not self.cfg.kv_cache_int8)

    def decode_trunk_for(self, prefix_ids: Sequence[Sequence[int]],
                         n_real: Optional[int] = None,
                         bucket: Optional[int] = None) -> int:
        """The dispatch's shared-trunk extent for the decode-phase dedup,
        or 0 for the flat kernel (same LCP rule as the prefill's)."""
        if not self.cascade_decode_supported() or not prefix_ids:
            return 0
        return self._lcp_trunk(prefix_ids, n_real, bucket)

    def spec_supported(self) -> bool:
        """Engine-level gate of speculative decode: on by config with a
        verify window of at least 2, on a decoder engine."""
        return (self.rt.spec_decode and self.rt.spec_k >= 2
                and not self.encoder_decoder)

    def set_spec_draft(self, params: Any, cfg: Any, name: str = "") -> None:
        """Arm fleet-model drafting: another model's (params, cfg) draft
        for this engine's verifier. The caller owns the weights' lifetime
        (engine/fleet.py holds a weight-cache reference for the dispatch
        stream). Draft and verifier must share a tokenizer; the vocab
        sizes are checked here."""
        if cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"spec draft model {name or cfg.name!r} vocab "
                f"{cfg.vocab_size} != verifier vocab "
                f"{self.cfg.vocab_size} — draft and verifier must share "
                f"a tokenizer")
        self._spec_draft = (params, cfg, name)
        self.governor.register(f"spec_draft:{name or cfg.name}",
                               quant.param_bytes(params))

    def clear_spec_draft(self) -> None:
        if self._spec_draft is not None:
            _, dcfg, dname = self._spec_draft
            self.governor.unregister(f"spec_draft:{dname or dcfg.name}")
        self._spec_draft = None

    def spec_flush(self) -> None:
        """Fold the pending device-side SpecOut counters into spec_stats
        (one copy to the host for all of them; spec.flush_pending)."""
        spec_mod.flush_pending(self)

    def spec_record(self, bucket: int,
                    prompt_ids: Sequence[Sequence[int]], gen_rows: Any,
                    n_real: Optional[int] = None) -> int:
        """Record observed completions into the radix tree's token
        history (the drafts of a repeat visit; spec.record_tails). Runs
        on the thread that owns the tree, the dispatching one."""
        return spec_mod.record_tails(
            self, bucket, prompt_ids, gen_rows,
            len(prompt_ids) if n_real is None else n_real,
            max_tails=self.spec_cfg.tree_tails_per_node)

    # -- cross-request prefix cache (engine/prefix_tree over models/paged) --

    def enable_prefix_cache(self) -> None:
        """Build the paged KV pool + radix index (idempotent). The pool is
        allocated at once at its full configured size
        (rt.prefix_cache_pages x rt.prefix_page_size token positions,
        paged.kv_page_bytes each), on the engine's device, in the cache's
        dtype; sizing prefix_cache_pages < 2 leaves the cache off. A T5
        engine keeps no KV cache: it does nothing there."""
        if (self.prefix_cache is not None or self.encoder_decoder
                or self.rt.prefix_cache_pages < 2):
            return
        pool = paged.KVPagePool(self.rt.prefix_cache_pages,
                                self.rt.prefix_page_size)
        pool.ensure(decoder.init_cache(
            self.cfg, 1, 1, dtype=self.params["tok_embed"].dtype,
            device=self.device))
        self.prefix_cache = prefix_tree.RadixPrefixCache(
            pool, stats=self.prefix_stats)
        # The pool is allocated at full size up front: the ledger carries
        # the whole reservation, not its occupancy.
        self.governor.register(
            f"kv_pages:{getattr(self.cfg, 'name', 'model')}", pool.nbytes)

    def _plan_prefix_resume(self, bucket: int,
                            prefix_ids: List[Sequence[int]],
                            n_real: int) -> _PrefixPlan:
        """Pin the deepest cached prefix of every row and decide the
        dispatch's remainder window: the smallest window edge covering
        every row's uncached tail, anchored at the dispatch's longest
        real row; rows recompute the window's slice of their prefix and
        gather the rest from the pool at the very slots the right-padded
        prefill uses. No coverable window means nothing useful is cached:
        the plan falls back to the unpaged prefill (and still inserts
        pages afterwards, which is how the cache warms up)."""
        tree = self.prefix_cache
        ps = tree.page_size
        matches = [tree.lookup(bucket, ids, record=(r < n_real))
                   for r, ids in enumerate(prefix_ids)]
        plan = _PrefixPlan(bucket=bucket, prefix_ids=list(prefix_ids),
                           matches=matches, n_real=n_real)
        for r in range(n_real):
            self.prefix_stats.count("prefill_tokens_total",
                                    len(prefix_ids[r]))
        # Right-padded layout (slot = token position): the window is
        # slots [w0, w0 + window) with w0 = max_n - window. Every row's
        # uncached tail must start at or after w0 (the window covers the
        # worst row; a fully paged row needs none), and anchoring at the
        # longest row instead of the bucket edge means rows shorter than
        # the bucket never recompute pad slots.
        max_n = max(len(ids) for ids in prefix_ids)
        needed = max(max((max_n - m.tokens
                          for ids, m in zip(prefix_ids, matches)
                          if m.tokens < len(ids)), default=1), 1)
        window = paged.pick_window(needed, bucket, ps)
        if window is None:
            return plan                      # cold: unpaged prefill
        w0 = max(max_n - window, 0)
        B = len(prefix_ids)
        slot_src = np.zeros((B, bucket), np.int32)
        rem_ids = []
        for r, (ids, m) in enumerate(zip(prefix_ids, matches)):
            n = len(ids)
            keep = min(m.tokens, w0, n)      # tokens resumed from pages
            for t in range(keep):
                page = m.pages[t // ps]
                slot_src[r, t] = page * ps + t % ps
            rem_ids.append(list(ids[w0:]))   # recompute [w0, n)
            if r < n_real:
                self.prefix_stats.count("hit_tokens", keep)
        rem, rem_mask = tok.right_pad_ids(rem_ids, window,
                                          tok.pad_token_id(self.tokenizer))
        plan.window = window
        plan.w0 = w0
        plan.slot_src = slot_src
        plan.rem = rem
        plan.rem_mask = rem_mask
        return plan

    def _finish_prefix_resume(self, plan: _PrefixPlan, cache,
                              row_map: Optional[Sequence[int]] = None
                              ) -> None:
        """Insert every full, not yet cached prefix page of the dispatch
        into the pool from its FINAL cache (the prefix slots survive both
        suffix branches untouched), then drop the dispatch's pins.
        ``row_map`` maps plan rows to cache rows (the grouped final cache
        holds member rows; any member of a group carries the group's
        prefix slots). New pages stay pinned until their copy is issued,
        so a tight pool cannot evict and reallocate a page between its
        tree insert and its data write."""
        tree = self.prefix_cache
        ps = tree.page_size
        writes = []
        fresh: List[int] = []
        for r, ids in enumerate(plan.prefix_ids):
            start, new_pages = tree.plan_insert(plan.bucket, ids)
            if not new_pages:
                continue
            tree.pool.incref(new_pages)
            fresh.extend(new_pages)
            crow = r if row_map is None else row_map[r]
            # slot == token position: page k's data sits at cache slots
            # [start + k * ps, ...).
            for j, pg in enumerate(new_pages):
                writes.append((pg, crow, start + j * ps))
        tree.pool.scatter(cache, writes)
        tree.pool.decref(fresh)
        for m in plan.matches:
            tree.release(m)

    def _abort_prefix_resume(self, plan: _PrefixPlan) -> None:
        """The dispatch failed: drop the plan's page pins without
        inserting (there is no final cache to read pages from)."""
        for m in plan.matches:
            self.prefix_cache.release(m)

    def prefill_insert(self, bucket: int,
                       prefix_ids: List[Sequence[int]]) -> int:
        """PREFILL-ONLY dispatch (disaggregated serving, serve/migrate.py):
        compute the rows' prefix KV at the ``bucket`` extent on the
        canonical right-padded layout (slot == token position) and copy
        every full page into the pool and the radix tree, decoding
        nothing. The prefill is ``decoder.prefill`` over the rows as the
        shared dispatch runs it, so at the same bucket and row count the
        pages are bitwise those a scoring dispatch inserts.

        Rows whose full pages are already cached are skipped (a repeat
        costs nothing); callers pad the rows as the scoring dispatch pads
        (``ContinuousBatcher.prefill``). Fresh pages stay pinned until
        their copy is issued. Returns the page-aligned tokens cached for
        the FIRST row (the migration chain's request row)."""
        self._decoder_only("prefill_insert")
        tree = self.prefix_cache
        assert tree is not None, \
            "prefill_insert needs the prefix cache enabled"
        ps = tree.page_size
        rows = [list(ids)[:bucket] for ids in prefix_ids]
        aligned0 = (len(rows[0]) // ps) * ps
        todo = [ids for ids in rows
                if tree.match_len(bucket, ids) < (len(ids) // ps) * ps]
        if todo:
            toks, mask = tok.right_pad_ids(todo, bucket,
                                           tok.pad_token_id(self.tokenizer))
            with torch.inference_mode():
                _, cache, _ = decoder.prefill(self.params, self.cfg,
                                              self._t(toks), self._t(mask),
                                              bucket)
            writes: List[Tuple[int, int, int]] = []
            fresh: List[int] = []
            for r, ids in enumerate(todo):
                start, new_pages = tree.plan_insert(bucket, ids)
                if not new_pages:
                    continue
                tree.pool.incref(new_pages)
                fresh.extend(new_pages)
                for j, pg in enumerate(new_pages):
                    writes.append((pg, r, start + j * ps))
            tree.pool.scatter(cache, writes)
            tree.pool.decref(fresh)
        return min(tree.match_len(bucket, rows[0]), aligned0)

    def _prefix_plan_or_none(self, bucket: int,
                             prefix_ids: List[Sequence[int]],
                             n_real: Optional[int], total: int,
                             use_prefix_cache: Optional[bool]
                             ) -> Optional[_PrefixPlan]:
        """Gate + build the prefix plan of one dispatch. None when the
        cache is absent or the caller opted out (``use_prefix_cache``
        False; None means 'use it iff enabled on this engine')."""
        on = (use_prefix_cache if use_prefix_cache is not None
              else self.prefix_cache is not None)
        if not on or self.prefix_cache is None:
            return None
        return self._plan_prefix_resume(
            bucket, prefix_ids, total if n_real is None else n_real)

    def _paged_args(self, plan: _PrefixPlan) -> Tuple[Any, ...]:
        """(pool, slot_src, w0) of a warm plan's paged front."""
        return (self.prefix_cache.pool.leaves, self._t(plan.slot_src),
                plan.w0)

    # -- token tables -------------------------------------------------------

    @property
    def digit_stop_mask(self) -> Optional[torch.Tensor]:
        """(V,) int32 surface-class table for the confidence early stop,
        or None when the tokenizer has no per-token strings or no EOS."""
        if self._digit_stop_mask is False:
            mask = None
            if self.eos_id is not None:
                with self._tok_lock:
                    m = tok.digit_stop_classes(self.tokenizer,
                                               self.cfg.vocab_size)
                if m is not None:
                    mask = torch.as_tensor(m, device=self.device)
            self._digit_stop_mask = mask
        return self._digit_stop_mask

    @property
    def eos_stop_mask(self) -> Optional[torch.Tensor]:
        """(V,) all-transparent class table: a pure all-rows-emitted-EOS
        stop for the binary branch, armed with :attr:`digit_stop_mask`."""
        if self.digit_stop_mask is None:
            return None
        if self._eos_stop_mask is None:
            self._eos_stop_mask = torch.as_tensor(
                tok.eos_only_stop_classes(self.cfg.vocab_size),
                device=self.device)
        return self._eos_stop_mask

    @property
    def digit_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """(token ids, values) of single-token integers 0..100."""
        if self._digit_table is None:
            with self._tok_lock:
                self._digit_table = tok.integer_token_table(self.tokenizer)
        return self._digit_table

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _decoder_only(self, what: str) -> None:
        """The JAX engine's ``assert not self.encoder_decoder`` of the
        fused, shared and grouped dispatches."""
        if self.encoder_decoder:
            raise ValueError(
                f"{what} runs decoder-only engines; an encoder-decoder "
                "engine scores through score_prompts (decode_prompts)")

    # -- decode paths -------------------------------------------------------

    def decode_prompts(self, prompts: Sequence[str]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The capture path: tokenize, left-pad into the smallest fitting
        bucket, one greedy decode keeping every step's logits
        (``generate.t5_greedy_decode`` on a T5 engine, else
        ``generate.greedy_decode``). Returns (generated (B, T_new) int32,
        step_logits (B, T_new, V) float32) on the device."""
        toks, mask = self._pad_batch(prompts)
        if self.encoder_decoder:
            return generate.t5_greedy_decode(
                self.params, self.cfg, toks, mask,
                max_new_tokens=self.rt.max_new_tokens)
        return generate.greedy_decode(self.params, self.cfg, toks, mask,
                                      max_new_tokens=self.rt.max_new_tokens)

    def decode_fused(self, prompts: Sequence[str], yes_ids: np.ndarray,
                     no_ids: np.ndarray, with_digits: bool = False,
                     max_new_tokens: Optional[int] = None,
                     pretokenized: Optional[Sequence[Sequence[int]]] = None,
                     early_stop: bool = False, eos_stop: bool = False):
        """The plain scoring path: left-padded prompts, one prefill, the
        fused greedy loop. Returns a FusedDecodeOut on the device."""
        self._decoder_only("decode_fused")
        assert not (early_stop and eos_stop), "pick one stop rule"
        toks, mask = self._pad_batch(prompts, pretokenized)
        if with_digits:
            digit_ids, digit_vals = self.digit_table
        else:
            digit_ids = np.zeros((0,), np.int32)
            digit_vals = np.zeros((0,), np.float32)
        stop_mask = (self.digit_stop_mask if early_stop
                     else self.eos_stop_mask if eos_stop else None)
        return generate.greedy_decode_fused(
            self.params, self.cfg, toks, mask, self._t(yes_ids),
            self._t(no_ids), self._t(digit_ids),
            self._t(digit_vals, torch.float32),
            max_new_tokens=(self.rt.max_new_tokens if max_new_tokens is None
                            else max_new_tokens),
            stop_mask=stop_mask,
            eos_id=None if stop_mask is None else int(self.eos_id))

    def decode_fused_shared(self, *args, **kwargs):
        """Score BOTH sweep formats with ONE shared-prefix prefill
        (:meth:`_decode_fused_shared`), then tick the governor once."""
        out = self._decode_fused_shared(*args, **kwargs)
        self._tick()
        return out

    def _decode_fused_shared(self, binary_prompts: Sequence[str],
                             confidence_prompts: Sequence[str],
                             yes_ids: np.ndarray, no_ids: np.ndarray,
                             new_tokens: int, conf_tokens: int,
                             early_stop: bool = False,
                             pretokenized_a: Optional[Sequence[Sequence[int]]] = None,
                             pretokenized_b: Optional[Sequence[Sequence[int]]] = None,
                             bucket: Optional[int] = None,
                             sfx_buckets_ab: Optional[Tuple[int, int]] = None,
                             reuse_cache: bool = False,
                             n_real: Optional[int] = None,
                             use_prefix_cache: Optional[bool] = None):
        """Score BOTH sweep formats with ONE shared-prefix prefill.

        Each row's binary and confidence prompts split at their longest
        common TOKEN prefix; prefixes right-pad into the length bucket and
        each format's suffix into a small suffix bucket. ``reuse_cache``
        marks a dispatch of the ragged sweep (the JAX engine threads its
        cache buffer through the dispatch chain there): it is where the
        cascade and speculative routing applies — a dispatch whose rows
        share a trunk takes the cascade prefill and the trunk-aware
        decode; any other the dense shared prefill, then the speculative
        verify loop (the sequential loop with ``spec_decode`` off), both
        with the decode trunk of its rows' LCP. On such a dispatch the
        prefix cache, when built (``use_prefix_cache`` None) or asked for
        (True), resumes the rows' cached prefix pages and inserts their
        new ones; False keeps it out of this dispatch. Returns (binary
        FusedDecodeOut, confidence FusedDecodeOut)."""
        self._decoder_only("decode_fused_shared")
        if pretokenized_a is not None:
            bin_ids = [list(i) for i in pretokenized_a]
            conf_ids = [list(i) for i in pretokenized_b]
        else:
            with self._tok_lock:
                bin_ids = [self.tokenizer(p).input_ids
                           for p in binary_prompts]
                conf_ids = [self.tokenizer(p).input_ids
                            for p in confidence_prompts]
        lcp = [tok.shared_prefix_len(a, b) for a, b in zip(bin_ids, conf_ids)]
        pad_id = tok.pad_token_id(self.tokenizer)
        sfx_a_ids = [a[n:] for a, n in zip(bin_ids, lcp)]
        sfx_b_ids = [b[n:] for b, n in zip(conf_ids, lcp)]
        max_sfx = max(len(s) for s in sfx_a_ids + sfx_b_ids)
        max_total = max(len(r) for r in bin_ids + conf_ids)
        if bucket is None or bucket < max(max(n, 1) for n in lcp):
            bucket = tok.pick_bucket([max(n, 1) for n in lcp], self.buckets)
        ba = tok.pick_bucket([len(s) for s in sfx_a_ids], SFX_BUCKETS)
        bb = tok.pick_bucket([len(s) for s in sfx_b_ids], SFX_BUCKETS)
        if sfx_buckets_ab is not None:
            ba, bb = max(sfx_buckets_ab[0], ba), max(sfx_buckets_ab[1], bb)
        fallback_reason = None
        if max_sfx > max(SFX_BUCKETS):
            fallback_reason = (
                f"a prompt pair diverges {max_sfx} tokens before its end "
                f"(> {max(SFX_BUCKETS)} suffix bucket)")
        elif max_total > max(self.buckets):
            fallback_reason = (
                f"a prompt ({max_total} tokens) exceeds the largest "
                f"bucket ({max(self.buckets)})")
        elif (getattr(self.cfg, "pos_embedding", None) == "learned"
              and bucket + max(ba + new_tokens, bb + conf_tokens)
              > self.cfg.max_seq_len):
            fallback_reason = (
                f"prefix bucket {bucket} + suffix/new-token budget "
                f"{max(ba + new_tokens, bb + conf_tokens)} would overrun "
                f"the {self.cfg.max_seq_len}-row learned-position table")
        if fallback_reason is not None:
            log.info("shared-prefix fallback: %s — scoring this batch with "
                     "two full prefills", fallback_reason)
            fused = self.decode_fused(binary_prompts, yes_ids, no_ids,
                                      max_new_tokens=new_tokens,
                                      pretokenized=bin_ids,
                                      eos_stop=early_stop)
            cfused = self.decode_fused(confidence_prompts, yes_ids, no_ids,
                                       with_digits=True,
                                       max_new_tokens=conf_tokens,
                                       pretokenized=conf_ids,
                                       early_stop=early_stop)
            return fused, cfused
        prefix_rows = [a[:n] for a, n in zip(bin_ids, lcp)]
        prefix, prefix_mask = tok.right_pad_ids(prefix_rows, bucket, pad_id)
        sfx_a, sfx_a_mask = tok.right_pad_ids(sfx_a_ids, ba, pad_id)
        sfx_b, sfx_b_mask = tok.right_pad_ids(sfx_b_ids, bb, pad_id)
        digit_ids, digit_vals = self.digit_table
        stop_mask = self.digit_stop_mask if early_stop else None
        stops = dict(
            stop_mask_b=stop_mask,
            stop_mask_a=None if stop_mask is None else self.eos_stop_mask,
            eos_id=None if stop_mask is None else int(self.eos_id))
        args = (self.params, self.cfg, self._t(prefix), self._t(prefix_mask),
                self._t(sfx_a), self._t(sfx_a_mask), self._t(sfx_b),
                self._t(sfx_b_mask), self._t(yes_ids), self._t(no_ids),
                self._t(digit_ids), self._t(digit_vals, torch.float32))
        if not reuse_cache:
            self.cascade_stats["dense_shared_dispatches"] += 1
            return generate.greedy_decode_fused_shared(
                *args, max_new_a=new_tokens, max_new_b=conf_tokens, **stops)
        trunk = self.cascade_trunk_for(prefix_rows, n_real, bucket)
        if trunk:
            return self._dispatch_shared_cascade(
                trunk, prefix_rows[0][:trunk], args, new_tokens, conf_tokens,
                stops, use_prefix_cache)
        if self.cascade_supported():
            self.cascade_stats["dense_fallbacks"] += 1
        dtrunk = self.decode_trunk_for(prefix_rows, n_real, bucket)
        if dtrunk:
            self.cascade_stats["cascade_decode_dispatches"] += 1
        # The prefix plan pins and touches the rows' pages BEFORE the
        # speculative plan probes the tree for drafts, as in the JAX
        # engine (the probe prefers the most recently touched child).
        plan = self._prefix_plan_or_none(bucket, prefix_rows, n_real,
                                         len(bin_ids), use_prefix_cache)
        splan = spec_mod.build_plan(self, bin_ids, conf_ids, bucket, ba, bb,
                                    new_tokens, conf_tokens)
        if splan is not None and not self.governor.allows("spec"):
            # The no_spec rung: the sequential loop is bitwise the same,
            # so dropping speculation only gives memory back (the spec
            # cache runs spec_k slots a window). Re-arms as pressure
            # clears.
            splan = None
            self.spec_stats["fallbacks"] += 1
        warm = plan is not None and plan.window is not None
        if splan is not None and warm and splan.fleet:
            # A fleet draft model has no prefix to prefill from on the
            # paged front (it gathers the verifier's pages): the
            # sequential paged route instead.
            splan = None
            self.spec_stats["fallbacks"] += 1
        try:
            if splan is not None:
                fused, cfused, cache = self._dispatch_shared_spec(
                    splan, plan, args, new_tokens, conf_tokens, stops,
                    dtrunk, len(bin_ids) if n_real is None else n_real)
            elif warm:
                self.cascade_stats["dense_shared_dispatches"] += 1
                self.paged_dispatches["shared_paged"] += 1
                fused, cfused, cache = (
                    generate.greedy_decode_fused_shared_paged(
                        self.params, self.cfg, *self._paged_args(plan),
                        args[3], self._t(plan.rem), self._t(plan.rem_mask),
                        *args[4:], max_new_a=new_tokens,
                        max_new_b=conf_tokens, decode_trunk=dtrunk, **stops))
            else:
                self.cascade_stats["dense_shared_dispatches"] += 1
                fused, cfused, *rest = generate.greedy_decode_fused_shared(
                    *args, max_new_a=new_tokens, max_new_b=conf_tokens,
                    decode_trunk=dtrunk, return_cache=plan is not None,
                    **stops)
                cache = rest[0] if rest else None
        except BaseException:
            if plan is not None:
                self._abort_prefix_resume(plan)
            raise
        if plan is not None:
            self._finish_prefix_resume(plan, cache)
        return fused, cfused

    def _dispatch_shared_spec(self, splan, plan, args, new_tokens: int,
                              conf_tokens: int, stops: dict, dtrunk: int,
                              rows: int):
        """One SPECULATIVE shared dispatch: the dense shared prefill, or
        with a warm prefix plan the paged front
        (generate.greedy_decode_fused_shared_paged_spec), then both
        branches' draft-and-verify loops, every verify window on the
        multi-query kernel — trunk-aware when ``dtrunk`` > 0. The
        dispatch's SpecOuts stay on the device until spec_flush().
        Returns (fused, cfused, final cache or None)."""
        spec_args = tuple(self._t(a) for a in splan.dyn_args())
        kw = dict(max_new_a=new_tokens, max_new_b=conf_tokens,
                  spec_k=splan.k, ngram=splan.ngram, decode_trunk=dtrunk,
                  **stops)
        if plan is not None and plan.window is not None:
            self.paged_dispatches["shared_paged_spec"] += 1
            out = generate.greedy_decode_fused_shared_paged_spec(
                self.params, self.cfg, *self._paged_args(plan), args[3],
                self._t(plan.rem), self._t(plan.rem_mask), *args[4:],
                *spec_args, **kw)
        else:
            draft_params = draft_cfg = None
            if splan.fleet:
                draft_params, draft_cfg, _ = self._spec_draft
            out = generate.greedy_decode_fused_shared_spec(
                *args, *spec_args, return_cache=plan is not None,
                draft_params=draft_params, draft_cfg=draft_cfg, **kw)
        fused, cfused, spec_a, spec_b = out[:4]
        self._spec_pending.append((spec_a, spec_b))
        self.spec_stats["spec_dispatches"] += 1
        self.spec_stats["spec_rows"] += rows
        return fused, cfused, (out[4] if len(out) > 4 else None)

    def _dispatch_shared_cascade(self, trunk: int, trunk_ids: Sequence[int],
                                 args, new_tokens: int, conf_tokens: int,
                                 stops: dict, use_prefix_cache):
        """One CASCADE shared dispatch: the batch-1 trunk prefill — cold,
        or resumed from the page pool — then the per-row cascade
        remainder extension (its trunk leg in int8 QK^T with
        ``cascade_cfg.int8_qk``) and both branches' fused loops on the
        trunk-aware decode kernel
        (generate.greedy_decode_fused_shared_cascade[_paged]).

        The trunk lives in the TRUNK-extent radix namespace (the cascade
        prefills its trunk at extent ``trunk``, not the bucket): a
        one-row plan over the trunk ids, whose pages the cold dispatch
        inserts from cache row 0's broadcast trunk slots, so the next
        dispatch sharing the trunk gathers it."""
        plan = self._prefix_plan_or_none(trunk, [list(trunk_ids)], 1, 1,
                                         use_prefix_cache)
        kw = dict(max_new_a=new_tokens, max_new_b=conf_tokens,
                  trunk_len=trunk, int8_qk=bool(self.cascade_cfg.int8_qk),
                  **stops)
        try:
            if plan is not None and plan.window is not None:
                self.paged_dispatches["cascade_paged"] += 1
                trunk_mask = torch.ones((1, trunk), dtype=torch.int32,
                                        device=self.device)
                fused, cfused, cache = (
                    generate.greedy_decode_fused_shared_cascade_paged(
                        self.params, self.cfg, *self._paged_args(plan),
                        trunk_mask, self._t(plan.rem),
                        self._t(plan.rem_mask), *args[2:], **kw))
            else:
                fused, cfused, *rest = (
                    generate.greedy_decode_fused_shared_cascade(
                        *args, return_cache=plan is not None, **kw))
                cache = rest[0] if rest else None
        except BaseException:
            if plan is not None:
                self._abort_prefix_resume(plan)
            raise
        if plan is not None:
            # Cache row 0's trunk slots hold the broadcast trunk KV, so
            # the standard insert pages them into the trunk namespace.
            self._finish_prefix_resume(plan, cache)
        self.cascade_stats["cascade_dispatches"] += 1
        if self.cascade_decode_supported():
            self.cascade_stats["cascade_decode_dispatches"] += 1
        return fused, cfused

    # -- piggyback chains ---------------------------------------------------

    def piggyback_supported(self) -> bool:
        """Engine-level gate of the piggyback chain: on by config, decoder
        engines only, unpaged dispatches only (with the prefix cache
        built its resume path owns the dispatches), and never where an
        instance attribute shadows ``decode_fused_shared`` (a wrapped
        engine: the chain must not bypass the wrapper)."""
        return (self.rt.piggyback_prefill
                and not self.encoder_decoder
                and self.prefix_cache is None
                and "decode_fused_shared" not in self.__dict__)

    def _piggyback_fits(self, bsz: int, total_len: int) -> bool:
        """Memory gate of a chain, the JAX engine's rule: a chain keeps
        the parked carry live beside the riding dispatch's cache. With a
        governed budget it is an admission against the governor's
        LEDGER (params, pool, pins and the parked carry, under
        ``handoff:``, are already counted): the riding dispatch's cache,
        with 20 % slack, must fit the headroom; the no_piggyback rung
        refuses. Without a budget (the CPU, or the governor off) the
        card's memory decides: params + 2.2 caches within 92 % of
        ``torch.cuda.mem_get_info``'s total (the JAX ``bytes_limit``
        rule); the CPU, bounded by host memory, always passes. (The
        port's step refills the parked carry's buffers, so it holds one
        chain cache where the JAX chain holds two; the rule is the JAX
        one kept.)"""
        itemsize = self.params["tok_embed"].element_size()
        cache_bytes = decoder.kv_cache_bytes(self.cfg, bsz, total_len,
                                             dtype_bytes=itemsize)
        if not self.governor.allows("piggyback"):
            return False
        headroom = self.governor.headroom()
        if headroom is not None:
            return 1.2 * cache_bytes < headroom
        if self.device.type != "cuda":
            return True
        _, limit = torch.cuda.mem_get_info(self.device)
        return quant.param_bytes(self.params) + 2.2 * cache_bytes \
            < 0.92 * limit

    def decode_fused_shared_piggy(
            self, pretokenized_a: Sequence[Sequence[int]],
            pretokenized_b: Sequence[Sequence[int]], new_tokens: int,
            conf_tokens: int, early_stop: bool, bucket: int,
            sfx_buckets_ab: Tuple[int, int],
            prev_yes: Optional[np.ndarray] = None,
            prev_no: Optional[np.ndarray] = None):
        """Submit one shared dispatch into the piggyback chain.

        The first call of a chain runs the dispatch's prefill and suffix
        extensions and PARKS its decode loops (returns None); every later
        call runs the parked dispatch's loops and then its own prefill
        (one engine call) and returns the parked dispatch's (binary,
        confidence) outputs, scored against ``prev_yes``/``prev_no``, the
        parked batch's target ids. Shapes and budgets must match the
        parked dispatch's (the sweep chains same-shape dispatches only;
        asserted). Raises :class:`PiggybackIneligible` where the
        dispatch needs the plain path: a layout fallback, the
        learned-position ceiling at the chain's longer cache, or no
        memory for two caches."""
        self._decoder_only("decode_fused_shared_piggy")
        bin_ids = [list(i) for i in pretokenized_a]
        conf_ids = [list(i) for i in pretokenized_b]
        lcp = [tok.shared_prefix_len(a, b) for a, b in zip(bin_ids, conf_ids)]
        pad_id = tok.pad_token_id(self.tokenizer)
        sfx_a_ids = [a[n:] for a, n in zip(bin_ids, lcp)]
        sfx_b_ids = [b[n:] for b, n in zip(conf_ids, lcp)]
        max_sfx = max(len(s) for s in sfx_a_ids + sfx_b_ids)
        max_total = max(len(r) for r in bin_ids + conf_ids)
        ba, bb = sfx_buckets_ab
        ba = max(ba, tok.pick_bucket([len(s) for s in sfx_a_ids],
                                     SFX_BUCKETS))
        bb = max(bb, tok.pick_bucket([len(s) for s in sfx_b_ids],
                                     SFX_BUCKETS))
        total_len = generate.piggyback_total_len(bucket, ba, bb, new_tokens,
                                                 conf_tokens)
        if (max_sfx > max(SFX_BUCKETS) or max_total > max(self.buckets)
                or bucket < max(max(n, 1) for n in lcp)):
            raise PiggybackIneligible("shared-prefix layout fallback")
        if (getattr(self.cfg, "pos_embedding", None) == "learned"
                and total_len > self.cfg.max_seq_len):
            # The chain's cache is LONGER than the plain dispatch's (two
            # disjoint branch regions): its learned-position ceiling
            # binds earlier.
            raise PiggybackIneligible("learned-position table overrun")
        if not self.governor.allows("piggyback"):
            # The no_piggyback rung: the chain's second live cache is the
            # cheapest memory to give back; chaining resumes when the
            # rung re-arms.
            raise PiggybackIneligible(
                "memory governor: piggyback disabled under pressure")
        if not self._piggyback_fits(len(bin_ids), total_len):
            raise PiggybackIneligible("no device memory for two caches")

        prefix, prefix_mask = tok.right_pad_ids(
            [a[:n] for a, n in zip(bin_ids, lcp)], bucket, pad_id)
        sfx_a, sfx_a_mask = tok.right_pad_ids(sfx_a_ids, ba, pad_id)
        sfx_b, sfx_b_mask = tok.right_pad_ids(sfx_b_ids, bb, pad_id)
        armed = early_stop and self.digit_stop_mask is not None
        key = (bucket, len(bin_ids), ba, bb, new_tokens, conf_tokens, armed)
        args = tuple(self._t(a) for a in (prefix, prefix_mask, sfx_a,
                                          sfx_a_mask, sfx_b, sfx_b_mask))
        if self._piggy is None:
            carry = generate.shared_piggyback_prefill(
                self.params, self.cfg, *args, max_new_a=new_tokens,
                max_new_b=conf_tokens)
            self._piggy = dict(key=key, carry=carry, slot0_a=bucket + ba,
                               slot0_b=bucket + ba + new_tokens + bb,
                               new_tokens=new_tokens,
                               conf_tokens=conf_tokens, armed=armed)
            self.kernel_stats.count("chains_opened")
            self._note_handoff(carry)
            self._tick()
            return None
        assert self._piggy["key"] == key, (
            "piggyback chain shape mismatch: drain before switching shapes "
            f"({self._piggy['key']} vs {key})")
        digit_ids, digit_vals = self.digit_table
        out_a, out_b, new_carry = generate.shared_piggyback_step(
            self.params, self.cfg, self._piggy["carry"], *args,
            self._t(prev_yes), self._t(prev_no), self._t(digit_ids),
            self._t(digit_vals, torch.float32), max_new_a=new_tokens,
            max_new_b=conf_tokens, **self._piggy_stop_kwargs())
        self._piggy["carry"] = new_carry
        self.kernel_stats.count("piggybacked_steps")
        self._note_handoff(new_carry)
        self._tick()
        return out_a, out_b

    def _piggy_stop_kwargs(self) -> dict:
        if not self._piggy["armed"]:
            return dict(stop_mask_a=None, stop_mask_b=None, eos_id=None)
        return dict(stop_mask_a=self.eos_stop_mask,
                    stop_mask_b=self.digit_stop_mask,
                    eos_id=int(self.eos_id))

    def piggy_pending(self) -> bool:
        return self._piggy is not None

    def piggy_drain(self, prev_yes: np.ndarray, prev_no: np.ndarray):
        """Close the chain: run the parked dispatch's decode loops alone
        and return its (binary, confidence) outputs."""
        st = self._piggy
        assert st is not None, "no piggyback chain to drain"
        digit_ids, digit_vals = self.digit_table
        stop_kwargs = self._piggy_stop_kwargs()
        self._piggy = None
        self.kernel_stats.count("chains_drained")
        out = generate.shared_piggyback_drain(
            self.params, self.cfg, st["carry"], self._t(prev_yes),
            self._t(prev_no), self._t(digit_ids),
            self._t(digit_vals, torch.float32), slot0_a=st["slot0_a"],
            slot0_b=st["slot0_b"], max_new_a=st["new_tokens"],
            max_new_b=st["conf_tokens"], **stop_kwargs)
        self.fresh_handoff()
        self._tick()
        return out

    def piggy_abort(self) -> None:
        """Drop the chain after a failed call: the caller re-runs the
        parked dispatch and the failed one through the plain path, which
        recomputes both from scratch."""
        if self._piggy is not None:
            self.kernel_stats.count("chain_fallbacks")
        self._piggy = None
        self.fresh_handoff()

    def decode_fused_grouped(self, *args, **kwargs):
        """Cross-cell prefix reuse (:meth:`_decode_fused_grouped`), then
        one governor tick."""
        out = self._decode_fused_grouped(*args, **kwargs)
        self._tick()
        return out

    def _decode_fused_grouped(self, groups, yes_ids: np.ndarray,
                              no_ids: np.ndarray, new_tokens: int,
                              conf_tokens: int, early_stop: bool,
                              bucket: int, sfx_bucket: int,
                              reuse_cache: bool = False,
                              use_prefix_cache: Optional[bool] = None):
        """Cross-cell prefix reuse: score every member prompt of
        ``groups`` (scheduler.PrefixGroup: ``.items`` with
        ``.bin_ids``/``.conf_ids``, shared ``.plen``) with ONE prefill per
        group. Member rows are laid out [bin, conf] per cell, cells in
        group order; ``yes_ids``/``no_ids`` are per CELL in that order.

        Returns (FusedDecodeOut over the padded member batch, real member
        row count): callers slice even rows for the binary readout and
        odd rows for the confidence readout. Both formats run one shared
        decode budget max(new_tokens, conf_tokens); with ``early_stop``
        the binary rows take the EOS-only stop table and the confidence
        rows the digit stop (per-row selection, generate._fused_tail).
        ``reuse_cache`` marks a dispatch of the ragged sweep: there the
        prefix cache (``use_prefix_cache`` as in
        :meth:`decode_fused_shared`) resumes the group prefixes from the
        page pool and inserts their new pages."""
        self._decoder_only("decode_fused_grouped")
        pad_id = tok.pad_token_id(self.tokenizer)
        prefix_ids, sfx_ids, group_idx = [], [], []
        for g in groups:
            gi = len(prefix_ids)
            prefix_ids.append(list(g.items[0].bin_ids[:g.plen]))
            for it in g.items:
                sfx_ids.append(list(it.bin_ids[g.plen:]))
                sfx_ids.append(list(it.conf_ids[g.plen:]))
                group_idx += [gi, gi]
        m = len(sfx_ids)
        g_pad = _tail_batch(len(prefix_ids), self.rt.batch_size)
        m_pad = _tail_batch(m, 2 * self.rt.batch_size)
        prefix_ids += [prefix_ids[-1]] * (g_pad - len(prefix_ids))
        sfx_ids += [sfx_ids[-1]] * (m_pad - m)
        group_idx += [group_idx[-1]] * (m_pad - m)
        if max(len(p) for p in prefix_ids) > bucket:
            raise ValueError("scheduler planned a group prefix longer than "
                             "its bucket")  # planning bug, never truncate
        if (getattr(self.cfg, "pos_embedding", None) == "learned"
                and bucket + sfx_bucket + max(new_tokens, conf_tokens)
                > self.cfg.max_seq_len):
            raise ValueError("scheduler planned a grouped dispatch past the "
                             "learned-position table")
        # RIGHT-padded group prefixes: the slot == position layout of the
        # shared paths.
        prefix, prefix_mask = tok.right_pad_ids(prefix_ids, bucket, pad_id)
        sfx, sfx_mask = tok.right_pad_ids(sfx_ids, sfx_bucket, pad_id)
        yes2 = np.repeat(np.asarray(yes_ids, np.int32), 2)
        no2 = np.repeat(np.asarray(no_ids, np.int32), 2)
        yes2 = np.concatenate([yes2, np.repeat(yes2[-1:], m_pad - m)])
        no2 = np.concatenate([no2, np.repeat(no2[-1:], m_pad - m)])
        digit_ids, digit_vals = self.digit_table
        stop_mask = self.digit_stop_mask if early_stop else None
        members = (self._t(sfx), self._t(sfx_mask), self._t(group_idx),
                   self._t(yes2), self._t(no2), self._t(digit_ids),
                   self._t(digit_vals, torch.float32))
        kw = dict(
            max_new=max(new_tokens, conf_tokens),
            stop_mask=None if stop_mask is None else self.eos_stop_mask,
            stop_mask2=stop_mask,
            stop_sel=(None if stop_mask is None
                      else self._t(np.arange(m_pad) % 2 == 1, torch.bool)),
            eos_id=None if stop_mask is None else int(self.eos_id))
        plan = None
        if reuse_cache:
            plan = self._prefix_plan_or_none(
                bucket, prefix_ids, len(groups), g_pad, use_prefix_cache)
        try:
            if plan is not None and plan.window is not None:
                self.paged_dispatches["grouped_paged"] += 1
                out, cache = generate.greedy_decode_fused_grouped_paged(
                    self.params, self.cfg, *self._paged_args(plan),
                    self._t(prefix_mask), self._t(plan.rem),
                    self._t(plan.rem_mask), *members, **kw)
            else:
                res = generate.greedy_decode_fused_grouped(
                    self.params, self.cfg, self._t(prefix),
                    self._t(prefix_mask), *members,
                    return_cache=plan is not None, **kw)
                out, cache = res if plan is not None else (res, None)
        except BaseException:
            if plan is not None:
                self._abort_prefix_resume(plan)
            raise
        if plan is not None:
            # Plan rows are the padded prefix rows; the final cache holds
            # member rows, and any member of a group carries the group's
            # prefix slots: each prefix row reads its group's first member.
            first_member, acc = [], 0
            for g in groups:
                first_member.append(acc)
                acc += 2 * len(g.items)
            first_member += [first_member[-1]] * (g_pad - len(groups))
            self._finish_prefix_resume(plan, cache, row_map=first_member)
        return out, m

    # -- prompts -> rows ----------------------------------------------------

    def decode_completion(self, generated_ids) -> str:
        """Token ids -> text, stopping at the first EOS (HF generate
        parity: tokens after EOS must not leak into the response text)."""
        trimmed = tok.trim_at_eos(np.asarray(generated_ids).tolist(),
                                  self.eos_id)
        with self._tok_lock:
            return self.tokenizer.decode(
                trimmed, skip_special_tokens=True).strip()

    def _pad_batch(self, prompts: Sequence[str],
                   pretokenized: Optional[Sequence[Sequence[int]]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tokenize + left-pad into the smallest fitting bucket."""
        if pretokenized is not None:
            ids_list = list(pretokenized)
        else:
            with self._tok_lock:
                ids_list = [self.tokenizer(p).input_ids for p in prompts]
        bucket = tok.pick_bucket([len(i) for i in ids_list], self.buckets)
        toks_arr, mask = tok.left_pad_ids(ids_list, bucket,
                                          tok.pad_token_id(self.tokenizer))
        return self._t(toks_arr), self._t(mask)

    # -- temperature sampling (rephraser, reasoning mode) -------------------

    def _sample_from_ids_raw(self, toks: torch.Tensor, mask: torch.Tensor,
                             key, temperature: float,
                             max_new_tokens: Optional[int]
                             ) -> Tuple[List[str], np.ndarray]:
        """(decoded texts, raw generated ids): callers that must know
        whether a reply finished inside the budget (EOS emitted) need the
        ids. The EOS stop is armed from the tokenizer's EOS, as in the JAX
        engine: a finished row emits EOS fill, unfinished rows are
        bitwise the unstopped sampler's."""
        self._decoder_only("sample_decode")
        gen = generate.sample_decode(
            self.params, self.cfg, toks, mask, key, temperature=temperature,
            max_new_tokens=(self.rt.max_new_tokens if max_new_tokens is None
                            else max_new_tokens),
            eos_id=None if self.eos_id is None else int(self.eos_id))
        gen = gen.cpu().numpy()
        return [self.decode_completion(row) for row in gen], gen

    def sample_completions(self, prompts: Sequence[str], key,
                           temperature: float = 1.0,
                           max_new_tokens: Optional[int] = None) -> List[str]:
        """One temperature-sampled completion per prompt (one decode; the
        same bucketing as the greedy paths). ``key`` is a threefry key
        (``engine.prng``), one (2,) or one a prompt (B, 2)."""
        toks, mask = self._pad_batch(prompts)
        return self._sample_from_ids_raw(toks, mask, key, temperature,
                                         max_new_tokens)[0]

    def sample_completions_with_ids(
            self, prompts: Sequence[str], key, temperature: float = 1.0,
            max_new_tokens: Optional[int] = None
    ) -> Tuple[List[str], np.ndarray]:
        toks, mask = self._pad_batch(prompts)
        return self._sample_from_ids_raw(toks, mask, key, temperature,
                                         max_new_tokens)

    def score_prompts_sampled(
        self, prompts: Sequence[str],
        target_texts: Sequence[Tuple[str, str]],
        n_runs: int = 10, key=None, temperature: float = 1.0,
        max_new_tokens: Optional[int] = None,
    ) -> List[SampledScore]:
        """Reasoning-model scoring: n sampled runs per prompt, answer-count
        averaging (perturb_prompts.py:412-446). Run ``run`` takes the key
        ``fold_in(key, run)`` (per row for per-prompt keys (B, 2), so a
        prompt's result does not depend on its batch); the default key is
        ``prng_key(0)``. Prompts are tokenized once; the runs loop outside
        the decode, one sampled decode each (the JAX engine's reason: a
        batch of all runs would multiply the KV cache by ``n_runs``).
        Token_i_Prob is the share of runs whose text holds target i
        (``score.count_averaged_responses``), the response the most
        common run text."""
        self._decoder_only("score_prompts_sampled")
        if key is None:
            key = prng.prng_key(0)
        key = prng.as_key(key)
        all_runs: List[List[str]] = [[] for _ in prompts]
        toks, mask = self._pad_batch(prompts)
        for run in range(n_runs):
            texts, _ = self._sample_from_ids_raw(
                toks, mask, prng.fold_in(key, run), temperature,
                max_new_tokens)
            for j, t in enumerate(texts):
                all_runs[j].append(t.strip())
        out: List[SampledScore] = []
        for j, prompt in enumerate(prompts):
            t1, t2 = target_texts[j]
            p1, p2, most_common = score.count_averaged_responses(
                all_runs[j], t1, t2)
            out.append(SampledScore(
                prompt=prompt, response=most_common,
                all_responses=list(all_runs[j]), token_1_prob=p1,
                token_2_prob=p2,
                odds_ratio=(p1 / p2) if p2 > 0 else float("inf")))
        return out

    def score_prompts(self, prompts: Sequence[str],
                      dispatch=None) -> List[PromptScore]:
        """Score every prompt; one decode per full batch. ``dispatch``
        runs each batch's zero-argument call (the word-meaning sweep
        passes its dispatch recovery, engine/sweep.py); None calls it."""
        order = np.argsort([len(p) for p in prompts], kind="stable")
        rows: List[Optional[PromptScore]] = [None] * len(prompts)
        B = self.rt.batch_size
        for start in range(0, len(order), B):
            idx = order[start:start + B]
            batch = [prompts[i] for i in idx]
            rows_out = (self._score_batch(batch) if dispatch is None
                        else dispatch(lambda: self._score_batch(batch)))
            for i, r in zip(idx, rows_out):
                rows[i] = r
        return rows  # type: ignore[return-value]

    def _score_batch(self, batch_prompts: List[str]) -> List[PromptScore]:
        n = len(batch_prompts)
        B = self.rt.batch_size
        # Tail batch: pad to the next power of two, not the full B.
        bsz = B if n == B else _tail_batch(n, B)
        padded = batch_prompts + [batch_prompts[-1]] * (bsz - n)
        if self.encoder_decoder:
            gen, step_logits = self.decode_prompts(padded)
            res = score.readout_from_step_logits(
                step_logits, gen, self.yes_id, self.no_id,
                scan_positions=self.rt.scan_positions).cpu()
        else:
            yes_ids = np.full((bsz,), self.yes_id, np.int32)
            no_ids = np.full((bsz,), self.no_id, np.int32)
            fused = self.decode_fused(padded, yes_ids, no_ids)
            res = score.readout_from_fused(
                fused, self._t(yes_ids), self._t(no_ids),
                scan_positions=self.rt.scan_positions).cpu()
        out = []
        for j in range(n):
            out.append(PromptScore(
                prompt=batch_prompts[j],
                completion=self.decode_completion(res.generated[j]),
                yes_prob=float(res.yes_prob[j]),
                no_prob=float(res.no_prob[j]),
                yes_logprob=float(res.yes_logprob[j]),
                no_logprob=float(res.no_logprob[j]),
                odds_ratio=float(res.odds_ratio[j]),
                relative_prob=float(res.relative_prob[j]),
                position_found=int(res.position_found[j]),
                yes_no_found=bool(res.yes_no_found[j]),
            ))
        self._tick()
        return out
