"""Continuous batcher: online dispatch formation over the bucket ladder.
Port of ``lir_tpu/serve/batcher.py``'s ``ContinuousBatcher``.

The offline ragged scheduler (engine/scheduler.py) plans a known grid;
serving has an arrival process instead, so this module runs the same
bucket and price machinery incrementally, between dispatches:

- **Bucket snapping**: each request was tokenized at submit and snapped
  to an edge of the engine's bucket ladder (tokens.assign_bucket).
- **Slot refill**: a dispatch takes up to ``batch_size`` rows of one
  bucket queue; rows whose deadline passed while queued resolve as
  partial results and their slots refill from the same queue. An
  underfull ripe bucket is promoted into the next bucket's queue when
  that one has waiting work and scheduler.bucket_cost says riding a
  fuller dispatch beats a padded tail.
- **Price-model selection**: among ripe buckets (a full batch, or the
  oldest row outwaited the linger window), the one with the lowest
  cost per real row under scheduler.bucket_cost dispatches.

A served row is the sweep's row for the same cell: the dispatch is the
sweep's shared ``decode_fused_shared`` call with the same pretokenized
ids, bucket, suffix buckets and budgets. The engine ticks its
device-memory governor once a dispatch; the batcher adds no tick, and
halves its dispatch rows while the governor's ``batch_down`` rung is
engaged.

:class:`FleetBatcher` keeps one ContinuousBatcher per model of a
``ModelFleet`` (the fleet server's batcher).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..engine import scheduler as sched_mod
from ..engine import score as score_mod
from ..engine import tokens as tok
from ..engine.runner import _tail_batch
from ..engine.sweep import _decode_complete, _parse_confidence
from ..utils.profiling import ServeStats
from .queue import STATUS_EXPIRED, Pending, ServeResult


class ContinuousBatcher:
    """Per-bucket queues, dispatch formation and the engine call."""

    def __init__(self, engine, stats: ServeStats, linger_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 pad_full: bool = True, prefix_cache: bool = True):
        self.engine = engine
        self.stats = stats
        self.linger_s = float(linger_s)
        self.clock = clock
        self.pad_full = pad_full
        # The cross-request radix prefix cache (ServeConfig.prefix_cache):
        # dispatches resume shared prefixes from the engine's page pool.
        self.prefix_cache = bool(prefix_cache
                                 and engine.prefix_cache is not None)
        self.batch = engine.rt.batch_size
        rt = engine.rt
        # Decode budgets: the sweep's derivation, so a served score is
        # the swept score.
        self.new_tokens = (rt.max_new_tokens if rt.sweep_full_completions
                           else min(rt.sweep_decode_tokens,
                                    rt.max_new_tokens))
        self.conf_tokens = (rt.max_new_tokens if rt.sweep_full_completions
                            else min(rt.sweep_confidence_tokens,
                                     rt.max_new_tokens))
        self.early_stop = (rt.sweep_early_stop
                           and not rt.sweep_full_completions)
        self.decode_cost = self.new_tokens + self.conf_tokens
        self.fused_decode = bool(rt.fused_decode)
        self.spec_decode = bool(engine.spec_supported())
        self._queues: Dict[int, Deque[Pending]] = {
            int(b): deque() for b in engine.buckets}

    # -- queue side ---------------------------------------------------------

    def admit(self, pending: Pending) -> None:
        self._queues[pending.bucket].append(pending)

    @property
    def pending_rows(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def oldest_wait(self, now: float) -> float:
        """Seconds the oldest bucketed row has waited (0 when none): the
        router's SLO signal."""
        oldest = min((q[0].t_submit for q in self._queues.values() if q),
                     default=None)
        return 0.0 if oldest is None else max(now - oldest, 0.0)

    def snapshot(self) -> List[Pending]:
        """A copy of every bucketed entry, bucket order (the shutdown
        checkpoint reads it once the supervisor has stopped)."""
        return [p for _, q in sorted(self._queues.items()) for p in q]

    def _expire(self, p: Pending, now: float) -> None:
        """Deadline passed while queued: a PARTIAL result (status only,
        every measurement field None)."""
        self.stats.count("expired")
        p.future.resolve(ServeResult(
            request_id=p.request.request_id, status=STATUS_EXPIRED,
            note=f"deadline passed before dispatch "
                 f"(waited {now - p.t_submit:.3f}s)",
            latency_s=now - p.t_submit))

    def _batch_cap(self) -> int:
        """Dispatch-row cap: the batch, halved while the governor's
        batch_down rung is engaged (a row's readout does not depend on
        its neighbours, only on the dispatch's row count: ROADMAP R1).
        The full batch for an engine without a governor."""
        gov = getattr(self.engine, "governor", None)
        return self.batch if gov is None else gov.batch_cap(self.batch)

    def _dispatch_rows(self, n: int) -> int:
        """Padded rows a dispatch of ``n`` real rows pays for: the row
        cap under ``pad_full``, else the sweep's power-of-two tail."""
        cap = self._batch_cap()
        return cap if self.pad_full else _tail_batch(n, cap)

    def _trunk(self, fn, rows: List[Pending], bucket: int) -> int:
        """Shared-trunk tokens the engine's cascade prefill
        (``cascade_trunk_for``) or cascade decode (``decode_trunk_for``)
        would dedupe for these rows; advisory pricing only."""
        if len(rows) < 2:
            return 0
        return fn([list(p.bin_ids[:p.lcp]) for p in rows], len(rows),
                  bucket)

    def next_dispatch(self, now: float, flush: bool = False
                      ) -> Optional[Tuple[int, List[Pending]]]:
        """The next dispatch as (bucket, rows), or None when no bucket is
        ripe. A bucket is ripe with a full batch, once its oldest request
        waited out the linger window, or always under ``flush``
        (shutdown drain). An underfull ripe bucket promotes into a
        NONEMPTY next bucket when the price model favours it."""
        while True:
            ripe = [edge for edge, q in self._queues.items() if q
                    and (flush or len(q) >= self.batch
                         or now - q[0].t_submit >= self.linger_s)]
            if not ripe:
                return None

            def price(edge: int) -> Tuple[float, float]:
                q = self._queues[edge]
                n = min(len(q), self.batch)
                cached = (sum(q[i].cached_hint for i in range(n))
                          if self.prefix_cache else 0)
                picked = [q[i] for i in range(n)]
                trunk = self._trunk(self.engine.cascade_trunk_for, picked,
                                    edge)
                dtrunk = self._trunk(self.engine.decode_trunk_for, picked,
                                     edge)
                per_row = sched_mod.bucket_cost(
                    self._dispatch_rows(n), edge, self.batch,
                    self.decode_cost, cached_tokens=cached,
                    fused_decode=self.fused_decode,
                    spec_decode=self.spec_decode,
                    cascade=trunk > 0, trunk_tokens=trunk,
                    decode_trunk_frac=(dtrunk / edge if edge else 0.0)
                    ) / n
                return per_row, q[0].t_submit

            edge = min(ripe, key=price)
            q = self._queues[edge]
            n = len(q)
            if n < self.batch:
                bigger = [b for b in sorted(self._queues) if b > edge]
                nxt = bigger[0] if bigger else None
                if (nxt is not None and self._queues[nxt]
                        and n * nxt < sched_mod.bucket_cost(
                            self._dispatch_rows(n), edge, self.batch,
                            self.decode_cost,
                            fused_decode=self.fused_decode,
                            spec_decode=self.spec_decode)):
                    promoted = [q.popleft() for _ in range(n)]
                    for p in reversed(promoted):
                        self._queues[nxt].appendleft(p)
                    self.stats.count("promoted", n)
                    continue    # re-select (promotion may cascade)
            rows: List[Pending] = []
            cap = self._batch_cap()
            while q and len(rows) < cap:
                p = q.popleft()
                if now >= p.t_deadline:
                    self._expire(p, now)  # the slot refills from the queue
                    continue
                rows.append(p)
            if rows:
                return edge, rows
            # every candidate row expired: re-scan the other buckets

    def prefill(self, bucket: int,
                prefix_rows: List[Tuple[int, ...]]) -> int:
        """PREFILL-ONLY dispatch (disaggregated serving, serve/migrate.py):
        the rows' prefix KV at ``bucket`` into this engine's pool and
        radix tree, decoding nothing (``ScoringEngine.prefill_insert``).
        The rows are padded as :meth:`score` pads its batch (the row cap
        under ``pad_full`` or the power-of-two tail, the last row
        repeated), so the pages are those a scoring dispatch of as many
        rows would insert. Returns the page-aligned tokens cached for the
        first row."""
        n = len(prefix_rows)
        bsz = max(self._dispatch_rows(n), _tail_batch(n, self.batch))
        full = [list(r) for r in prefix_rows]
        full += [list(prefix_rows[-1])] * (bsz - n)
        return self.engine.prefill_insert(bucket, full)

    def flush_all(self, status: str, note: str) -> int:
        """Resolve every bucketed request with ``status`` (the breaker's
        drain); returns how many were flushed."""
        n = 0
        now = self.clock()
        for q in self._queues.values():
            while q:
                p = q.popleft()
                self.stats.count("errors")
                p.future.resolve(ServeResult(
                    request_id=p.request.request_id, status=status,
                    note=note, latency_s=now - p.t_submit))
                n += 1
        return n

    # -- engine side --------------------------------------------------------

    def score(self, bucket: int, rows: List[Pending]) -> List[Dict]:
        """One engine dispatch over ``rows`` (all of ``bucket``), the
        sweep's shared dispatch: the padded batch repeats the last row,
        per-dispatch suffix buckets, pretokenized ids, the position-0
        readout. Ends in the host copy of the payload (so a watched
        dispatch's time covers its device work). Returns one payload a
        REAL row."""
        engine = self.engine
        n = len(rows)
        bsz = max(self._dispatch_rows(n), _tail_batch(n, self.batch))
        full = list(rows) + [rows[-1]] * (bsz - n)
        t1 = np.asarray([p.t1 for p in full], np.int32)
        t2 = np.asarray([p.t2 for p in full], np.int32)
        la = max(max(len(p.bin_ids) - p.lcp for p in full), 1)
        lb = max(max(len(p.conf_ids) - p.lcp for p in full), 1)
        ba = tok.pick_bucket([la], sched_mod.SUFFIX_BUCKETS)
        bb = tok.pick_bucket([lb], sched_mod.SUFFIX_BUCKETS)
        fused, cfused = engine.decode_fused_shared(
            [p.request.binary_prompt for p in full],
            [p.request.confidence_prompt for p in full],
            t1, t2, new_tokens=self.new_tokens,
            conf_tokens=self.conf_tokens, early_stop=self.early_stop,
            pretokenized_a=[list(p.bin_ids) for p in full],
            pretokenized_b=[list(p.conf_ids) for p in full],
            bucket=bucket, sfx_buckets_ab=(ba, bb), reuse_cache=True,
            use_prefix_cache=self.prefix_cache, n_real=n)
        res = score_mod.readout_from_fused(
            fused, engine._t(t1), engine._t(t2), scan_positions=1)
        yes_p, no_p, lp_vals, lp_ids, gen_host, wconf, cgen_host = (
            t.cpu().numpy() for t in (
                res.yes_prob, res.no_prob, fused.topk_logprobs,
                fused.topk_ids, fused.generated, cfused.weighted_confidence,
                cfused.generated))
        if self.spec_decode:
            # The drafts warm themselves: record the observed
            # continuations into the radix tree, fold the dispatch's
            # speculative counters (the payload copy synchronized).
            engine.spec_record(bucket, [list(p.bin_ids) for p in full],
                               gen_host, n)
            engine.spec_record(bucket, [list(p.conf_ids) for p in full],
                               cgen_host, n)
            engine.spec_flush()
        payloads: List[Dict] = []
        for j in range(n):
            conf_text = engine.decode_completion(cgen_host[j])
            conf_complete = (engine.rt.sweep_full_completions
                             or _decode_complete(cgen_host[j],
                                                 engine.eos_id))
            payloads.append(dict(
                model_response=engine.decode_completion(gen_host[j]),
                model_confidence_response=conf_text,
                token_1_prob=float(yes_p[j]),
                token_2_prob=float(no_p[j]),
                log_probabilities=json.dumps({
                    int(i): round(float(v), 6)
                    for i, v in zip(lp_ids[j], lp_vals[j])}),
                confidence_value=_parse_confidence(conf_text,
                                                   conf_complete),
                weighted_confidence=float(wconf[j]),
            ))
        self.stats.add_dispatch(n, bsz)
        return payloads


class FleetBatcher:
    """Per-model dispatch queues over a ``ModelFleet``: one
    ContinuousBatcher a model (prefix cache off, as in the JAX fleet
    server), plus

    - **resident-first selection**: among models with a ripe bucket, one
      whose weights are resident dispatches before one that would pay a
      swap; the resident scan rotates each call, so equally loaded
      resident models take turns;
    - **swap overlap**: once a dispatch is chosen, the next non-resident
      model with waiting rows starts streaming its weights
      (``fleet.prefetch``) behind this dispatch;
    - ``score`` under fleet ``acquire`` / ``release`` (the refcount
      keeps the model's weights, and a fleet draft model's, resident for
      the dispatch).
    """

    def __init__(self, fleet, stats: ServeStats, linger_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 pad_full: bool = True):
        self.fleet = fleet
        self.stats = stats
        self.clock = clock
        self.batchers: Dict[str, ContinuousBatcher] = {
            mid: ContinuousBatcher(fleet.engine(mid), stats, linger_s,
                                   clock, pad_full=pad_full,
                                   prefix_cache=False)
            for mid in fleet.model_ids}
        self._rr = 0

    def admit(self, pending: Pending) -> None:
        self.batchers[pending.model_id].admit(pending)

    @property
    def pending_rows(self) -> int:
        return sum(b.pending_rows for b in self.batchers.values())

    def oldest_wait(self, now: float) -> float:
        return max((b.oldest_wait(now) for b in self.batchers.values()),
                   default=0.0)

    def snapshot(self) -> List[Pending]:
        return [p for mid in sorted(self.batchers)
                for p in self.batchers[mid].snapshot()]

    def next_dispatch(self, now: float, flush: bool = False
                      ) -> Optional[Tuple[str, int, List[Pending]]]:
        """(model id, bucket, rows) of the next dispatch, or None when no
        model has a ripe bucket."""
        mids = list(self.batchers)
        resident = [m for m in mids if self.fleet.resident(m)]
        if resident:
            self._rr = (self._rr + 1) % len(resident)
            resident = resident[self._rr:] + resident[:self._rr]
        rest = [m for m in mids if not self.fleet.resident(m)]
        for mid in resident + rest:
            d = self.batchers[mid].next_dispatch(now, flush=flush)
            if d is None:
                continue
            bucket, rows = d
            for nxt in mids:
                if (nxt != mid and not self.fleet.resident(nxt)
                        and self.batchers[nxt].pending_rows):
                    self.fleet.prefetch(nxt)
                    break
            return mid, bucket, rows
        return None

    def flush_all(self, status: str, note: str) -> int:
        return sum(b.flush_all(status, note)
                   for b in self.batchers.values())

    def score(self, model_id: str, bucket: int,
              rows: List[Pending]) -> List[Dict]:
        """One dispatch on ``model_id``'s engine with its weights held
        resident for the call, and a co-resident draft model's too when
        ``RuntimeConfig.spec_draft_model`` names one (fleet drafting)."""
        engine = self.fleet.acquire(model_id)
        draft_id = self.fleet.acquire_spec_draft(engine, model_id)
        try:
            return self.batchers[model_id].score(bucket, rows)
        finally:
            self.fleet.release_spec_draft(engine, draft_id)
            self.fleet.release(model_id)
