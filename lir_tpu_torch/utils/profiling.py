"""Sweep counters and meters.

Copies from the JAX package's ``utils/profiling.py``:

- ``BucketCounters`` and ``OccupancyStats``: the scheduler fills them at
  plan time, the sweep adds the decode-step occupancy from the early
  stop's retire positions;
- ``ThroughputMeter`` (prompts/sec/card, implied TFLOPS and MFU against
  the card's published peak) with ``scoring_step_flops``;
- ``GuardStats``: the guard layer's per-site counters (the dispatch
  watchdog's and the numerics guard's);
- ``ServeStats`` and ``FaultStats``: the serving layer's and the fault
  machinery's counters (retry, ladder, breaker);
- ``StreamStats``: the streaming-statistics sink's counters;
- ``PrefixCacheStats``: the cross-request prefix cache's counters;
- ``KernelStats``: the piggyback chain's counters (its ``phases``, which
  only the JAX package's benchmark fills, are left out);
- ``FleetStats``: the model fleet's swap and weight-cache counters;
- ``RouterStats``: the replica router's placement and failover counters;
- ``MemStats``: the device-memory governor's ledger gauges and ladder
  counters;
- ``device_memory_stats``: per-device memory from
  ``torch.cuda.memory_stats``;
- ``is_oom_error``: the JAX package's out-of-memory test, plus
  ``torch.cuda.OutOfMemoryError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from .logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class BucketCounters:
    """Per-bucket dispatch accounting for the ragged sweep scheduler."""

    dispatches: int = 0
    cells: int = 0            # real grid cells dispatched in this bucket
    slots: int = 0            # batch rows paid for (incl. padding rows)
    used_slots: int = 0       # batch rows carrying real work
    prompt_tokens: int = 0    # real (unpadded) prefix tokens prefilled
    slot_tokens: int = 0      # prefill rows * bucket_len — token slots paid
    refilled: int = 0         # cells promoted here from a smaller bucket's
                              # ragged tail (slot refill)


@dataclasses.dataclass
class OccupancyStats:
    """Ragged-sweep scheduler counters: per-bucket batch occupancy and
    prompt-padding waste, plus decode-step occupancy from the early-stop
    retire positions.

    - batch occupancy % = real cells / batch slots paid for — slots lost
      to ragged-tail padding rows (slot refill keeps it high).
    - padding waste %  = padded prefix-token slots / total prefix-token
      slots — the prefill's share spent on padding (the bucket ladder
      keeps it low).
    - decode occupancy % = decode steps that produced a live (pre-retire)
      token / decode steps paid for. Rows retired by the early stop idle
      until the batch's slowest row.
    """

    buckets: Dict[int, BucketCounters] = dataclasses.field(
        default_factory=dict)
    grouped_cells: int = 0          # cells scored via a cross-cell prefix group
    grouped_prefill_rows: int = 0   # prefix rows actually prefilled for them
    decode_steps_live: int = 0
    decode_steps_paid: int = 0

    def bucket(self, edge: int) -> BucketCounters:
        return self.buckets.setdefault(int(edge), BucketCounters())

    def add_dispatch(self, edge: int, cells: int, slots: int,
                     prompt_tokens: int, refilled: int = 0,
                     used_slots: Optional[int] = None,
                     prefill_slots: Optional[int] = None) -> None:
        """``slots``/``used_slots`` count batch rows (occupancy);
        ``prefill_slots`` counts rows actually prefilled at this bucket's
        width (padding waste) — they differ in grouped dispatches, where
        member rows outnumber the shared prefix rows."""
        b = self.bucket(edge)
        b.dispatches += 1
        b.cells += cells
        b.slots += slots
        b.used_slots += cells if used_slots is None else used_slots
        b.prompt_tokens += prompt_tokens
        b.slot_tokens += (slots if prefill_slots is None
                          else prefill_slots) * int(edge)
        b.refilled += refilled

    def add_decode(self, steps_live: int, steps_paid: int) -> None:
        self.decode_steps_live += steps_live
        self.decode_steps_paid += steps_paid

    @property
    def occupancy_pct(self) -> float:
        slots = sum(b.slots for b in self.buckets.values())
        used = sum(b.used_slots for b in self.buckets.values())
        return 100.0 * used / slots if slots else 0.0

    @property
    def padding_waste_pct(self) -> float:
        tok = sum(b.prompt_tokens for b in self.buckets.values())
        slot_tok = sum(b.slot_tokens for b in self.buckets.values())
        return 100.0 * (slot_tok - tok) / slot_tok if slot_tok else 0.0

    @property
    def decode_occupancy_pct(self) -> float:
        if not self.decode_steps_paid:
            return 0.0
        return 100.0 * self.decode_steps_live / self.decode_steps_paid

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "occupancy_pct": round(self.occupancy_pct, 2),
            "padding_waste_pct": round(self.padding_waste_pct, 2),
            "per_bucket": {
                str(edge): {
                    "dispatches": b.dispatches, "cells": b.cells,
                    "slots": b.slots, "refilled": b.refilled,
                    "padding_waste_pct": round(
                        100.0 * (b.slot_tokens - b.prompt_tokens)
                        / b.slot_tokens, 2) if b.slot_tokens else 0.0,
                }
                for edge, b in sorted(self.buckets.items())
            },
        }
        if self.decode_steps_paid:
            out["decode_occupancy_pct"] = round(self.decode_occupancy_pct, 2)
        if self.grouped_cells:
            out["grouped_cells"] = self.grouped_cells
            out["grouped_prefill_rows"] = self.grouped_prefill_rows
        return out


# Published dense peaks (tensor cores, no sparsity) by the name
# torch.cuda.get_device_name reports; int8 is twice bf16 on Hopper.
CHIP_PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,     # H100 SXM
}
_INT8_MULTIPLIER = 2.0


def chip_peak_flops(int8: bool = False) -> Optional[float]:
    """Peak matmul FLOP/s of the first card, or None when there is no
    card or its kind is not in the table (callers then skip MFU)."""
    if not torch.cuda.is_available():
        return None
    peak = CHIP_PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0))
    if peak is not None and int8:
        peak *= _INT8_MULTIPLIER
    return peak


def decoder_matmul_params(cfg) -> int:
    """Matmul-visible parameter count of one decoder: the per-layer linear
    weights plus the lm_head. Embedding lookups do no matmul FLOPs."""
    D, hd = cfg.hidden_size, cfg.head_dim
    H, K, F = cfg.n_heads, cfg.n_kv_heads, cfg.intermediate_size
    per_layer = (D * H * hd          # wq
                 + 2 * D * K * hd    # wk, wv
                 + H * hd * D        # wo
                 + 2 * D * F         # w_up, w_down
                 + (D * F if cfg.gated_mlp else 0))
    return cfg.n_layers * per_layer + D * cfg.vocab_size  # + lm_head


def scoring_step_flops(cfg, batch: int, seq: int, new_tokens: int) -> float:
    """Matmul FLOPs (2 per MAC) of one fused scoring step: the prefill of
    (batch, seq), ``new_tokens`` cached greedy decode steps, and the head
    once after the prefill and once a step; attention products included."""
    D, hd = cfg.hidden_size, cfg.head_dim
    H, L, V = cfg.n_heads, cfg.n_layers, cfg.vocab_size
    p_layers = decoder_matmul_params(cfg) - D * V
    prefill = 2 * p_layers * batch * seq
    prefill += 4 * batch * H * seq * seq * hd * L      # scores + weighted sum
    decode = 0.0
    for t in range(new_tokens):
        decode += 2 * p_layers * batch
        decode += 4 * batch * H * (seq + t + 1) * hd * L
    readout = 2 * D * V * batch * (1 + new_tokens)
    return float(prefill + decode + readout)


@dataclasses.dataclass
class ThroughputMeter:
    """Counts scored prompts and wall time; reports prompts/sec/card.

    Pass per-batch matmul FLOPs to ``add(..., flops=...)`` (via
    ``scoring_step_flops``) to get implied TFLOPS and MFU against the
    card's published peak in the summary. Set ``int8_dots=True`` for
    dynamic-int8 sweeps so the MFU denominator is the s8 peak.
    ``n_devices`` defaults to ``torch.cuda.device_count()`` (1 without a
    card).
    """

    n_devices: int = 0
    prompts: int = 0
    tokens_in: int = 0
    tokens_out: int = 0
    elapsed: float = 0.0
    flops: float = 0.0
    int8_dots: bool = False

    def __post_init__(self) -> None:
        if self.n_devices <= 0:
            self.n_devices = max(torch.cuda.device_count(), 1)

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed += time.perf_counter() - start

    def add(self, prompts: int, tokens_in: int = 0, tokens_out: int = 0,
            flops: float = 0.0) -> None:
        self.prompts += prompts
        self.tokens_in += tokens_in
        self.tokens_out += tokens_out
        self.flops += flops

    @property
    def prompts_per_sec(self) -> float:
        return self.prompts / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def prompts_per_sec_per_chip(self) -> float:
        return self.prompts_per_sec / max(self.n_devices, 1)

    def summary(self) -> Dict[str, float]:
        out = {
            "prompts": self.prompts,
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "elapsed_s": round(self.elapsed, 3),
            "n_devices": self.n_devices,
            "prompts_per_sec": round(self.prompts_per_sec, 4),
            "prompts_per_sec_per_chip": round(self.prompts_per_sec_per_chip, 4),
        }
        if self.flops > 0 and self.elapsed > 0:
            implied = self.flops / self.elapsed / max(self.n_devices, 1)
            out["implied_tflops_per_chip"] = round(implied / 1e12, 2)
            peak = chip_peak_flops(int8=self.int8_dots)
            if peak is not None:
                out["mfu"] = round(implied / peak, 4)
                if implied > peak:
                    log.warning(
                        "implied %.1f TFLOPS exceeds the card's peak (%.0f): "
                        "timing is not syncing with the device",
                        implied / 1e12, peak / 1e12)
        return out


@dataclasses.dataclass
class GuardStats:
    """Guard-layer counters per SITE ("sweep", "serve", "multi"),
    thread-safe: the sweep's writer thread, the serve supervisor and the
    watched dispatch threads all touch them.

    - ``watched``: dispatches run under an enforced watchdog deadline
      (uncalibrated observe-only runs are not counted: they cannot fire);
    - ``stalls``: watchdog expiries per site, each a dispatch that would
      have hung the run and instead cost one deadline; ``stall_dumps``
      counts the all-thread stack dumps;
    - ``checked`` / ``quarantined``: numerics-guard rows validated and
      rows withheld as ``error:numerics``; ``reasons`` histograms the
      causes (NaN probs, a model that failed to load, ...);
    - ``inflight_cancelled``: serve rows resolved partial because their
      deadline passed while their dispatch was still running (the
      watched call's tick callback);
    - ``poisoned``: recoveries refused because an abandoned dispatch
      still held the engine past the watchdog's grace
      (``guard.watchdog.EnginePoisoned``).

    The JAX package's multihost counters (``barrier_timeouts``,
    ``heartbeats``) wait for the port's multi-device item (ROADMAP A9).
    """

    watched: Dict[str, int] = dataclasses.field(default_factory=dict)
    stalls: Dict[str, int] = dataclasses.field(default_factory=dict)
    checked: Dict[str, int] = dataclasses.field(default_factory=dict)
    quarantined: Dict[str, int] = dataclasses.field(default_factory=dict)
    reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    stall_dumps: int = 0
    inflight_cancelled: int = 0
    poisoned: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def site(self, field: str, site: str, n: int = 1) -> None:
        with self._lock:
            d = getattr(self, field)
            d[site] = d.get(site, 0) + n

    def quarantine(self, site: str, reason: str) -> None:
        with self._lock:
            self.quarantined[site] = self.quarantined.get(site, 0) + 1
            self.reasons[reason] = self.reasons.get(reason, 0) + 1

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "watched": dict(self.watched),
                "stalls": dict(self.stalls),
                "stalls_total": sum(self.stalls.values()),
                "stall_dumps": self.stall_dumps,
                "checked": dict(self.checked),
                "quarantined": dict(self.quarantined),
                "quarantined_total": sum(self.quarantined.values()),
                "quarantine_reasons": dict(self.reasons),
                "inflight_cancelled": self.inflight_cancelled,
                "poisoned": self.poisoned,
            }


@dataclasses.dataclass
class ServeStats:
    """Online serving counters (serve/), thread-safe: the supervisor loop
    and every submitting thread touch them. A copy of the JAX package's.

    - ``submitted`` / ``admitted`` / ``shed``: admission accounting
      (``shed`` counts refused newcomers and deadline-aware evictions);
    - dedup hit rate = result-cache hits / lookups;
    - ``expired``: rows whose deadline passed before their result (a
      partial, confidence-free result); ``late``: rows completed past
      their deadline;
    - slot occupancy % = real rows / padded batch slots over every
      dispatch; ``promoted`` counts rows the batcher moved into a bigger
      bucket's queue;
    - latency percentiles (p50/p95/p99) over submit -> result seconds.
    """

    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    expired: int = 0
    errors: int = 0
    late: int = 0
    dedup_hits: int = 0
    dedup_misses: int = 0
    dispatches: int = 0
    slots_used: int = 0
    slots_paid: int = 0
    promoted: int = 0
    queue_depth_peak: int = 0
    _latencies: list = dataclasses.field(default_factory=list)
    _max_latencies: int = 100_000

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def add_dispatch(self, used: int, paid: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.slots_used += used
            self.slots_paid += paid

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            if len(self._latencies) < self._max_latencies:
                self._latencies.append(float(seconds))

    @property
    def dedup_hit_rate(self) -> float:
        n = self.dedup_hits + self.dedup_misses
        return self.dedup_hits / n if n else 0.0

    @property
    def slot_occupancy_pct(self) -> float:
        return (100.0 * self.slots_used / self.slots_paid
                if self.slots_paid else 0.0)

    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return {"p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0}

        def pct(p: float) -> float:
            i = min(len(lat) - 1, max(0, int(round(p * (len(lat) - 1)))))
            return lat[i]

        return {"p50_s": round(pct(0.50), 4), "p95_s": round(pct(0.95), 4),
                "p99_s": round(pct(0.99), 4)}

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "shed": self.shed,
            "completed": self.completed,
            "expired": self.expired,
            "errors": self.errors,
            "late": self.late,
            "dedup_hits": self.dedup_hits,
            "dedup_misses": self.dedup_misses,
            "dedup_hit_rate": round(self.dedup_hit_rate, 4),
            "dispatches": self.dispatches,
            "slot_occupancy_pct": round(self.slot_occupancy_pct, 2),
            "promoted": self.promoted,
            "queue_depth_peak": self.queue_depth_peak,
        }
        out.update(self.latency_percentiles())
        return out


@dataclasses.dataclass
class FaultStats:
    """Fault-injection and recovery counters (faults/, the sweep's
    dispatch recovery, the serve supervisor), thread-safe. A copy of the
    JAX package's.

    - ``injected``: per-site injected-fault counts (the plan's ground
      truth, so "recovered" reads against "thrown at");
    - ``recovered_dispatches``: dispatches that failed at least once and
      still resolved rows (retry, reset, ladder);
    - ``degraded_dispatches`` / ``degraded_rows``: dispatches that
      entered the degradation ladder, and the poison rows it resolved
      as errors;
    - breaker counters and ``transitions``: every circuit-breaker state
      change in order.
    """

    injected: Dict[str, int] = dataclasses.field(default_factory=dict)
    recovered_dispatches: int = 0
    degraded_dispatches: int = 0
    degraded_rows: int = 0
    preemptions: int = 0
    breaker_opens: int = 0
    breaker_probes: int = 0
    breaker_closes: int = 0
    transitions: list = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def inject(self, site: str, preemption: bool = False) -> None:
        with self._lock:
            self.injected[site] = self.injected.get(site, 0) + 1
            if preemption:
                self.preemptions += 1

    def transition(self, frm: str, to: str) -> None:
        with self._lock:
            self.transitions.append((frm, to))
            if to == "open":
                self.breaker_opens += 1
            elif to == "half_open":
                self.breaker_probes += 1
            elif to == "closed":
                self.breaker_closes += 1

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "injected": dict(self.injected),
                "injected_total": sum(self.injected.values()),
                "recovered_dispatches": self.recovered_dispatches,
                "degraded_dispatches": self.degraded_dispatches,
                "degraded_rows": self.degraded_rows,
                "preemptions": self.preemptions,
                "breaker_opens": self.breaker_opens,
                "breaker_probes": self.breaker_probes,
                "breaker_closes": self.breaker_closes,
                "breaker_transitions": [f"{a}->{b}"
                                        for a, b in self.transitions],
            }


@dataclasses.dataclass
class StreamStats:
    """Streaming-statistics sink counters (engine/stream_stats.py),
    thread-safe: the sweep's main thread folds while its writer thread
    checkpoints.

    - ``rows_folded`` / ``dispatch_folds``: grid rows folded into the
      device lattice and the fold launches that carried them (one a
      dispatch);
    - ``host_bytes_avoided``: bytes of per-row dispatch payloads never
      copied to the host because the row artifact was skipped;
      ``accum_bytes`` gauges the lattice itself (what a checkpoint or
      finalize does copy);
    - ``checkpoints`` / ``merges``: lattice snapshots written at flush
      boundaries, and lattice merges;
    - ``finalize_s``: seconds spent in grid -> CIs finalizes;
    - ``live_queries``: the serve ``stats`` endpoint's reads of the
      serve ring (``ServeStreamSink.summary``).
    """

    rows_folded: int = 0
    dispatch_folds: int = 0
    host_bytes_avoided: int = 0
    accum_bytes: int = 0
    checkpoints: int = 0
    merges: int = 0
    finalize_s: float = 0.0
    live_queries: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n=1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def gauge(self, field: str, value) -> None:
        with self._lock:
            setattr(self, field, value)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "rows_folded": self.rows_folded,
                "dispatch_folds": self.dispatch_folds,
                "host_bytes_avoided": self.host_bytes_avoided,
                "accum_bytes": self.accum_bytes,
                "checkpoints": self.checkpoints,
                "merges": self.merges,
                "finalize_s": round(self.finalize_s, 4),
                "live_queries": self.live_queries,
            }


@dataclasses.dataclass
class PrefixCacheStats:
    """Cross-request prefix cache counters (engine/prefix_tree.py over
    the models/paged.py page pool): how much prefill the radix tree
    saves and how hard the pool churns. Thread-safe, as the JAX class.

    - ``lookups`` / ``hits``: dispatch-time radix probes and probes that
      matched >= 1 cached page; radix hit rate = hits / lookups.
    - ``hit_tokens``: prefix tokens resumed from the pool instead of
      prefilled (prefill_tokens_avoided). ``prefill_tokens_total``
      counts every prefix token a dispatch needed (cached + computed),
      so avoided_frac = hit / total.
    - ``inserted_pages`` / ``evicted_pages``: pool churn. Sustained
      eviction at low hit rates means the pool is undersized for the
      working set.
    - ``pages_in_use`` / ``pages_total``: pool occupancy gauge, updated
      at every insert and eviction.
    """

    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    prefill_tokens_total: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0
    pages_in_use: int = 0
    pages_total: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def gauge_pages(self, in_use: int, total: int) -> None:
        with self._lock:
            self.pages_in_use = in_use
            self.pages_total = total

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "lookups": self.lookups,
                "hits": self.hits,
                "radix_hit_rate": round(self.hits / self.lookups, 4)
                                  if self.lookups else 0.0,
                "prefill_tokens_avoided": self.hit_tokens,
                "prefill_tokens_total": self.prefill_tokens_total,
                "avoided_frac": round(self.hit_tokens
                                      / self.prefill_tokens_total, 4)
                                if self.prefill_tokens_total else 0.0,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
                "pages_in_use": self.pages_in_use,
                "pages_total": self.pages_total,
            }

@dataclasses.dataclass
class KernelStats:
    """The piggyback chain's counters (engine-side chunked prefill/decode
    piggybacking): ``chains_opened``, ``piggybacked_steps`` (dispatches
    whose decode loops rode the next prefill call), ``chains_drained``
    and ``chain_fallbacks`` (chains dropped for the plain path)."""

    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        if self.counters:
            out["piggyback"] = dict(sorted(self.counters.items()))
        return out


@dataclasses.dataclass
class FleetStats:
    """Multi-model fleet counters (engine/fleet.py over
    models/weights.py): how much model-swap latency the async weight
    streamer hid behind compute, and how hard the LRU weight cache
    works. Thread-safe: the prefetch worker and the consumer both count.

    - ``swap_s_hidden`` / ``swap_s_exposed``: per-load wall seconds
      overlapped with the previous model's compute vs waited on by the
      scoring loop (a load without prefetch is all exposed).
    - ``loads`` / ``load_s`` / ``weight_bytes_streamed``: loads made,
      their wall time, bytes shipped through the chunked streamer.
    - ``prefetch_hits`` / ``prefetch_misses`` / ``cache_hits``: acquires
      met by a background load, by an inline load, by a resident model.
    - ``evictions``, ``resident_models`` / ``resident_bytes``: the LRU
      cache's evictions and occupancy gauges.
    - ``model_swaps``: acquires that changed the active model;
      ``fleet_requests`` / ``fleet_rows``: serving's ``fleet_score``
      fan-outs and the per-model rows they made.
    """

    swap_s_hidden: float = 0.0
    swap_s_exposed: float = 0.0
    loads: int = 0
    load_s: float = 0.0
    weight_bytes_streamed: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    cache_hits: int = 0
    evictions: int = 0
    resident_models: int = 0
    resident_bytes: int = 0
    model_swaps: int = 0
    fleet_requests: int = 0
    fleet_rows: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n=1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def gauge(self, field: str, value) -> None:
        with self._lock:
            setattr(self, field, value)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            total = self.swap_s_hidden + self.swap_s_exposed
            return {
                "swap_s_hidden": round(self.swap_s_hidden, 4),
                "swap_s_exposed": round(self.swap_s_exposed, 4),
                "swap_hidden_frac": round(self.swap_s_hidden / total, 4)
                                    if total > 0 else 0.0,
                "loads": self.loads,
                "load_s": round(self.load_s, 4),
                "weight_bytes_streamed": self.weight_bytes_streamed,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "cache_hits": self.cache_hits,
                "evictions": self.evictions,
                "resident_models": self.resident_models,
                "resident_bytes": self.resident_bytes,
                "model_swaps": self.model_swaps,
                "fleet_requests": self.fleet_requests,
                "fleet_rows": self.fleet_rows,
            }


@dataclasses.dataclass
class MemStats:
    """Device-memory governor counters and gauges (engine/hbm.py).
    Thread-safe.

    - ``ledger_bytes`` / ``budget_bytes`` / ``pressure``: the ledger
      total, the governed budget (0 = unbounded) and their ratio.
    - ``rung``: the ladder's engaged depth (0 = fully armed);
      ``rung_downs`` / ``rung_ups``: engage and release transitions by
      rung.
    - ``admits`` / ``denials``: admission checks passed and refused.
    - ``oom_events`` (by site), ``oom_reclaims``, ``oom_exhausted``:
      device OOMs routed through the governor, those where the ladder
      freed something, those where nothing could be freed.
    - ``squeezes``: budget squeezes; ``sheds``: submits refused by the
      last rung.
    """

    ledger_bytes: int = 0
    budget_bytes: int = 0
    pressure: float = 0.0
    rung: int = 0
    rung_downs: Dict[str, int] = dataclasses.field(default_factory=dict)
    rung_ups: Dict[str, int] = dataclasses.field(default_factory=dict)
    admits: int = 0
    denials: int = 0
    oom_events: Dict[str, int] = dataclasses.field(default_factory=dict)
    oom_reclaims: int = 0
    oom_exhausted: int = 0
    squeezes: int = 0
    sheds: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def gauge(self, field: str, value) -> None:
        with self._lock:
            setattr(self, field, value)

    def site(self, field: str, site: str, n: int = 1) -> None:
        with self._lock:
            d = getattr(self, field)
            d[site] = d.get(site, 0) + n

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "ledger_bytes": self.ledger_bytes,
                "budget_bytes": self.budget_bytes,
                "pressure": round(float(self.pressure), 4),
                "rung": self.rung,
                "rung_downs": dict(self.rung_downs),
                "rung_ups": dict(self.rung_ups),
                "admits": self.admits,
                "denials": self.denials,
                "oom_events": dict(self.oom_events),
                "oom_reclaims": self.oom_reclaims,
                "oom_exhausted": self.oom_exhausted,
                "squeezes": self.squeezes,
                "sheds": self.sheds,
            }


@dataclasses.dataclass
class RouterStats:
    """The replica router's counters (serve/router.py). Thread-safe:
    submitting threads, the replicas' supervisor threads (future
    callbacks) and the router's tick all count.

    - ``routed``: requests placed (dedup hits excluded);
      ``routed_resident``: placements that followed weight residency;
      ``per_replica``: placements (every attempt) by replica.
    - ``dedup_hits``: requests answered from the router's own cache.
    - ``failovers``: attempts moved to another replica after an error or
      shed result; ``re_admitted``: in-flight requests moved because
      their replica was killed.
    - ``hedged`` / ``hedge_wins`` / ``hedge_losses``: requests duplicated
      inside the deadline whisker, and which copy won.
    - ``zombie_payloads``: payloads from a dead replica after the request
      resolved elsewhere, dropped.
    - ``replica_errors`` / ``replica_sheds``: attempt outcomes that
      started a failover; ``no_replica_sheds``: requests no live replica
      would take.
    - ``kills`` / ``revives``: replica deaths and rejoins.
    """

    routed: int = 0
    routed_resident: int = 0
    dedup_hits: int = 0
    completed: int = 0
    errors: int = 0
    failovers: int = 0
    re_admitted: int = 0
    hedged: int = 0
    hedge_wins: int = 0
    hedge_losses: int = 0
    zombie_payloads: int = 0
    replica_errors: int = 0
    replica_sheds: int = 0
    no_replica_sheds: int = 0
    kills: int = 0
    revives: int = 0
    per_replica: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def placed(self, replica_id: str) -> None:
        with self._lock:
            self.per_replica[replica_id] = (
                self.per_replica.get(replica_id, 0) + 1)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            out = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
            out["per_replica"] = dict(self.per_replica)
            return out



@dataclasses.dataclass
class MigrationStats:
    """Disaggregated-serving counters (serve/migrate.py and the router's
    migration chain), the JAX package's fields. Thread-safe: replica
    supervisor threads (page ops and chain callbacks), the router's tick
    (timeouts) and submitting threads all count.

    - ``migrations``: completed chains (pages exported from one replica's
      pool and imported, checksum-verified, into another's);
      ``prefill_ops``: prefill-only dispatches asked of prefill-role
      replicas.
    - ``pages_migrated`` / ``bytes_streamed`` / ``chunks_streamed``: the
      transfer volume (device bytes of the pages landed).
    - ``migration_s_exposed``: the legs' wall seconds before the decode
      dispatch could be admitted; ``migration_s_hidden``: in-flight
      seconds the chunk window overlapped away (serial sum less wall, a
      leg).
    - ``refetch_fallbacks``: chains abandoned (stall, corrupt chunk, a
      replica died) whose request re-prefilled locally; ``stalls`` /
      ``corrupt_chunks`` say why.
    - ``cluster_tree_hits``: requests whose prefix the cluster index
      found already on the chosen decode replica.
    """

    migrations: int = 0
    prefill_ops: int = 0
    pages_migrated: int = 0
    bytes_streamed: int = 0
    chunks_streamed: int = 0
    migration_s_exposed: float = 0.0
    migration_s_hidden: float = 0.0
    refetch_fallbacks: int = 0
    stalls: int = 0
    corrupt_chunks: int = 0
    cluster_tree_hits: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def add_transfer(self, pages: int, nbytes: int, chunks: int,
                     exposed_s: float, hidden_s: float) -> None:
        with self._lock:
            self.migrations += 1
            self.pages_migrated += pages
            self.bytes_streamed += nbytes
            self.chunks_streamed += chunks
            self.migration_s_exposed += exposed_s
            self.migration_s_hidden += hidden_s

    def summary(self) -> Dict[str, object]:
        with self._lock:
            out = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}
            for name in ("migration_s_exposed", "migration_s_hidden"):
                out[name] = round(out[name], 4)
            return out

def is_oom_error(err) -> bool:
    """True when an exception (or its text) is a device out-of-memory:
    ``torch.cuda.OutOfMemoryError``, or the JAX package's text rules
    (RESOURCE_EXHAUSTED, or "out of memory" in any case)."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return ("RESOURCE_EXHAUSTED" in msg
            or "out of memory" in msg.lower())


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory stats in GiB (the ``bytes`` entries of
    ``torch.cuda.memory_stats``); empty without a card."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            k: round(v / 2**30, 3) for k, v in stats.items()
            if isinstance(v, (int, float)) and "bytes" in k}
    return out
