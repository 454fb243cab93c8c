"""Scoring servers: the supervisor loop tying queue, cache and batcher
into a long-running service. Port of ``lir_tpu/serve/server.py``:
``ScoringServer`` over one engine and ``FleetScoringServer`` over a
``ModelFleet`` (the ``fleet_score`` request class: one question across
every model, with kappa and disagreement). ``ScoringServer`` also runs
page operations for the migration chain (``submit_page_op``,
``submit_prefill``; serve/migrate.py) on its supervisor thread. The
memory tiers wait for ROADMAP A8d; the metrics registry, the sentinel
observatory and tracing spans for "Also open".

The graceful-degradation contract:

- Every admitted request resolves with SOME status. Rows whose deadline
  passes resolve as partial (confidence-free) results, also while their
  dispatch runs (the watchdog's tick); shed rows resolve at submit.
- Dispatches run under the engine's dispatch watchdog
  (guard/watchdog.py; a hang costs one deadline) and the serve retry
  policy (config.ServeConfig.retry: short, full jitter, capped).
- A device out-of-memory error skips the retries: the governor reclaims
  (``HbmGovernor.handle_oom``) and the dispatch is retried ONCE; a
  second one errors only that dispatch's rows, and the breaker is not
  told (capacity is not device death).
- A dispatch that spends its retries enters the DEGRADATION LADDER
  (faults/ladder.py): the engine's dispatch state is reset
  (``ScoringEngine.reset_dispatch_state``) and the batch bisected, so
  only poison rows resolve as errors.
- After ``max_consecutive_failures`` failed dispatches the CIRCUIT
  BREAKER opens (faults/breaker.py): queued work drains with errors and
  submits shed, until a half-open probe after ``breaker_cooldown_s``
  succeeds.
- A stalled dispatch's abandoned call must leave the engine before the
  recovery touches it (``DispatchWatchdog.settle``, one grace); one that
  has not POISONS the engine (``EnginePoisoned``): the dispatch's rows
  error and the breaker opens at once, so nothing dispatches beside it.
- On SIGTERM :meth:`shutdown_checkpoint` stops the supervisor without
  working off the backlog and writes every unresolved request to an
  atomic JSON checkpoint; :meth:`resume_from_checkpoint` re-submits them.
- The governor's last rung, ``shed``, refuses submits while engaged
  (memory is not coming back this tick); ``batch_down`` halves the
  batcher's dispatch rows.

The result cache answers a repeated probe without a dispatch; with
``ServeConfig.prefix_cache`` (on by default) the engine's radix prefix
cache over its paged pool serves shared prefixes across requests.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
import time
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..config import ServeConfig
from ..engine import scheduler as sched_mod
from ..engine import stream_stats
from ..engine import tokens as tok
from ..faults import CLOSED, HALF_OPEN, CircuitBreaker, degrade_dispatch
from ..guard import numerics
from ..guard.watchdog import EnginePoisoned
from ..stats import streaming
from ..utils.logging import get_logger
from ..utils.manifest import atomic_write_json
from ..utils.profiling import FaultStats, ServeStats, is_oom_error
from ..utils.retry import retry_with_exponential_backoff
from . import migrate as migrate_mod
from .batcher import ContinuousBatcher, FleetBatcher
from .cache import ResultCache, content_key, engine_key
from .queue import (STATUS_ERROR, STATUS_EXPIRED, STATUS_OK, STATUS_SHED,
                    Pending, RequestQueue, ServeFuture, ServeRequest,
                    ServeResult)

log = get_logger(__name__)

CHECKPOINT_VERSION = 1


class _OomSignal(BaseException):
    """Lifts a device OOM out of the generic retry loop (which retries
    Exceptions only) to the governor's reclaim-and-retry."""

    def __init__(self, err: BaseException):
        super().__init__(repr(err))
        self.err = err


def _refuse_tiers(tiers) -> None:
    """The JAX servers' ``tiers=`` (a TierConfig): an enabled one waits
    for the memory tiers (ROADMAP A8d) and is refused, never ignored."""
    if tiers is not None and getattr(tiers, "enabled", False):
        raise NotImplementedError(
            "tiered KV and weight memory (tiers= with enabled) is not "
            "ported yet (ROADMAP A8d)")


class ScoringServer:
    """Continuous-batching scoring service over one ScoringEngine.
    ``tiers=`` is accepted for the JAX signature; an enabled one raises
    (ROADMAP A8d).

    Page ops (serve/migrate.py): :meth:`submit_page_op` queues
    ``fn(engine)`` for the supervisor thread, which drains the queue each
    loop turn ahead of dispatch formation and runs each op under the
    engine's ``DispatchWatchdog.dispatch_lock`` (``exclusive``: an
    abandoned call still inside after its grace fails the op with
    ``EnginePoisoned`` instead of blocking it); :meth:`submit_prefill`
    queues a prefill-only dispatch, run watched like a scoring
    dispatch. Their futures' callbacks fire on the supervisor
    thread."""

    def __init__(self, engine, model_name: str,
                 config: Optional[ServeConfig] = None,
                 stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tiers=None):
        _refuse_tiers(tiers)
        self.engine = engine
        self.model_name = model_name
        self.config = config or ServeConfig()
        self.stats = stats if stats is not None else ServeStats()
        self.clock = clock
        self.queue = RequestQueue(self.config.queue_depth, self.stats,
                                  clock)
        self.cache = ResultCache(self.config.cache_entries, self.stats)
        # The radix prefix cache (on by default): the engine's page pool
        # and tree are built before the batcher reads them.
        if self.config.prefix_cache and engine.prefix_cache is None:
            engine.enable_prefix_cache()
        self.batcher = ContinuousBatcher(
            engine, self.stats, self.config.linger_s, clock,
            pad_full=self.config.pad_full,
            prefix_cache=self.config.prefix_cache)
        self.faults = FaultStats()
        # Live streaming statistics over the served rows (the `stats`
        # endpoint), gated on RuntimeConfig.streaming_stats.
        self.stream = None
        if engine.rt.streaming_stats and self.config.stream_window > 0:
            self.stream = stream_stats.ServeStreamSink(
                window=self.config.stream_window)
        self.breaker = CircuitBreaker(
            failure_threshold=self.config.max_consecutive_failures,
            cooldown_s=self.config.breaker_cooldown_s,
            clock=clock, stats=self.faults)
        self._engine_key = engine_key(engine)
        # Target-token memo, written from every submitting thread.
        self._memo_lock = threading.Lock()
        self._target_memo: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._abort = False          # stop WITHOUT draining (checkpoint)
        self._inflight: List[Pending] = []
        # Appended by any thread, popped by the supervisor (both atomic).
        self._page_ops: Deque[migrate_mod.PageOp] = collections.deque()
        engine.reset_dispatch_state()

    @property
    def healthy(self) -> bool:
        """True while the breaker is CLOSED (half-open reads unhealthy
        but already admits traffic)."""
        return self.breaker.state == CLOSED

    @property
    def queue_depth(self) -> int:
        """Admitted, undispatched rows (queue + buckets): the router's
        load signal. Best effort while the supervisor runs."""
        return len(self.queue) + self.batcher.pending_rows

    def oldest_wait(self, now: Optional[float] = None) -> float:
        """The oldest bucketed row's wait in seconds (the router's SLO
        signal)."""
        return self.batcher.oldest_wait(self.clock() if now is None
                                        else now)

    @property
    def hbm_pressure(self) -> float:
        """The governor's ledger pressure (a router placement signal; 0
        without a budget)."""
        return float(self.engine.governor.pressure())

    # -- client side ---------------------------------------------------------

    def _target_ids(self, targets: Tuple[str, str]) -> Tuple[int, int]:
        with self._memo_lock:
            ids = self._target_memo.get(targets)
        if ids is None:
            with self.engine._tok_lock:
                t1, t2 = tok.target_token_ids(
                    self.engine.tokenizer, targets,
                    encoder_decoder=self.engine.encoder_decoder)
            ids = (int(t1), int(t2))
            with self._memo_lock:
                self._target_memo[targets] = ids
        return ids

    def submit(self, request: ServeRequest) -> ServeFuture:
        """Admit one request; the future resolves with a ServeResult
        (possibly at once: a cache hit, a shed, an open breaker).
        Tokenization runs here on the caller's thread."""
        self.stats.count("submitted")
        fut = ServeFuture()
        now = self.clock()
        key = content_key(self._engine_key, request)
        if self.cache.max_entries > 0:
            hit = self.cache.get(key)
            if hit is not None:
                self.stats.count("completed")
                self.stats.record_latency(self.clock() - now)
                fut.resolve(ServeResult(
                    request_id=request.request_id, status=STATUS_OK,
                    cached=True, latency_s=self.clock() - now, **hit))
                return fut
        if not self.breaker.allow():
            self.stats.count("shed")
            fut.resolve(ServeResult(
                request_id=request.request_id, status=STATUS_SHED,
                note="server unhealthy — circuit breaker open "
                     f"(cooldown {self.config.breaker_cooldown_s:.1f}s)"))
            return fut
        gov = self.engine.governor
        if gov.should_shed():
            # The ladder's last rung: memory is not coming back this
            # tick, so refuse at once instead of queueing behind it.
            self.stats.count("shed")
            fut.resolve(ServeResult(
                request_id=request.request_id, status=STATUS_SHED,
                note=f"memory pressure — HBM governor shedding "
                     f"(pressure {gov.pressure():.2f}, engaged rungs: "
                     f"{','.join(gov.engaged_rungs())})"))
            return fut
        with self.engine._tok_lock:
            bin_ids = tuple(int(i) for i in self.engine.tokenizer(
                request.binary_prompt).input_ids)
            conf_ids = tuple(int(i) for i in self.engine.tokenizer(
                request.confidence_prompt).input_ids)
        lcp = tok.shared_prefix_len(bin_ids, conf_ids)
        t1, t2 = self._target_ids(tuple(request.targets))
        deadline = (request.deadline_s if request.deadline_s is not None
                    else self.config.deadline_for(request.klass))
        bucket = tok.assign_bucket(max(lcp, 1), self.engine.buckets)
        # Admission-time radix probe (read-only, no pins): how much of
        # the shared prefix is resident, for the batcher's pricing.
        cached_hint = 0
        if self.batcher.prefix_cache:
            cached_hint = self.engine.prefix_cache.match_len(
                bucket, bin_ids[:lcp])
        pending = Pending(
            request=request, future=fut, t_submit=now,
            t_deadline=now + deadline, bin_ids=bin_ids, conf_ids=conf_ids,
            lcp=lcp, bucket=bucket, t1=t1, t2=t2, cache_key=key,
            cached_hint=cached_hint)
        self.queue.offer(pending)
        return fut

    # -- supervisor side -----------------------------------------------------

    def start(self) -> "ScoringServer":
        assert self._thread is None, "server already started"
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain: finish everything queued (flushing partial buckets),
        then stop the supervisor."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while True:
            stopping = self._stop.is_set()
            if stopping and self._abort:
                return           # checkpoint path: leave the backlog be
            self._drain_page_ops()
            for p in self.queue.drain():
                self.batcher.admit(p)
            d = self.batcher.next_dispatch(self.clock(), flush=stopping)
            if d is None:
                if (stopping and len(self.queue) == 0
                        and self.batcher.pending_rows == 0):
                    return
                # Lingering rows need sub-window wakeups; an idle server
                # sleeps longer (bounded, so stop() is prompt).
                self.queue.wait_nonempty(
                    0.005 if self.batcher.pending_rows else 0.05)
                continue
            self._dispatch(*d)

    def stream_summary(self) -> Dict:
        """Live streaming-statistics estimates (the `stats` endpoint);
        an empty dict with the ring off."""
        if self.stream is None:
            return {}
        return self.stream.summary()

    # -- page ops (disaggregated serving, serve/migrate.py) -----------------

    def _queue_op(self, fn) -> migrate_mod.OpFuture:
        op = migrate_mod.PageOp(fn)
        self._page_ops.append(op)
        self.queue.kick()            # wake an idle supervisor now
        return op.future

    def submit_page_op(self, fn) -> migrate_mod.OpFuture:
        """Queue ``fn(engine)`` for the supervisor thread, run under the
        engine's dispatch lock: the seam the router's migration chain
        runs its exports and imports through, so every tree and pool
        change happens on this server's dispatch thread. Returns the op's
        future (callbacks fire on the supervisor thread)."""

        def exclusive(engine):
            with engine.watchdog.exclusive():
                return fn(engine)

        return self._queue_op(exclusive)

    def submit_prefill(self, bucket: int,
                       prefix_ids) -> migrate_mod.OpFuture:
        """Queue a PREFILL-ONLY dispatch over one token prefix (the
        prefill-role replica's unit of work, ``batcher.prefill``): its
        full pages land in this replica's pool and tree. It runs under
        the dispatch watchdog like a scoring dispatch (a stall fails the
        op). The future resolves with the page-aligned tokens cached."""
        ids = tuple(int(t) for t in prefix_ids)
        return self._queue_op(
            lambda engine: self._watched_prefill(int(bucket), [ids]))

    def _watched_prefill(self, bucket: int, rows) -> int:
        wd = self.engine.watchdog

        def call():
            return self.batcher.prefill(bucket, rows)

        if not wd.enabled:
            with wd.exclusive():
                return call()
        cost = sched_mod.bucket_cost(
            self.batcher._dispatch_rows(len(rows)), bucket,
            self.engine.rt.batch_size, 0,
            fused_decode=self.batcher.fused_decode)
        # Prefill-only seconds do not calibrate the scoring deadlines.
        return wd.watch(call, cost=cost, site="prefill", calibrate=False)

    def _drain_page_ops(self) -> None:
        while True:
            try:
                op = self._page_ops.popleft()
            except IndexError:
                return
            op.run(self.engine)

    def _resolve_ok(self, p: Pending, payload: Dict, now: float) -> None:
        self.cache.put(p.cache_key, payload)
        if self.stream is not None:
            # Fold after the row passed the numerics guard, before the
            # future resolves, keyed by content address (never twice).
            self.stream.fold_payload(p.cache_key,
                                     tuple(p.request.targets), payload)
        latency = now - p.t_submit
        self.stats.count("completed")
        if now > p.t_deadline:
            self.stats.count("late")
        self.stats.record_latency(latency)
        p.future.resolve(ServeResult(
            request_id=p.request.request_id, status=STATUS_OK,
            latency_s=latency, **payload))

    def _resolve_payload(self, p: Pending, payload: Dict,
                         now: float) -> None:
        """One scored row crosses the guard: a numerics-invalid payload
        is QUARANTINED as error:numerics; a row whose future already
        resolved (its deadline passed mid-dispatch) drops its payload;
        every other row resolves ok."""
        reason = None
        if self.engine.rt.numerics_guard:
            self.engine.guard_stats.site("checked", "serve")
            reason = numerics.check_payload(payload)
        if reason is not None:
            self.engine.guard_stats.quarantine("serve", reason)
            self.stats.count("errors")
            log.warning("numerics guard: quarantined request %s (%s)",
                        p.request.request_id, reason)
            p.future.resolve(ServeResult(
                request_id=p.request.request_id, status=STATUS_ERROR,
                note=f"{numerics.NUMERICS_ERROR} — {reason} "
                     f"(row quarantined by the numerics guard)",
                latency_s=now - p.t_submit))
            return
        if p.future.done():
            return          # expired mid-dispatch; partial already sent
        self._resolve_ok(p, payload, now)

    def _cancel_expired_inflight(self) -> None:
        """The watched dispatch's tick (supervisor thread): a request
        whose deadline passes mid-dispatch resolves its partial result
        at once instead of waiting out the dispatch."""
        now = self.clock()
        for p in self._inflight:
            if not p.future.done() and now >= p.t_deadline:
                self.stats.count("expired")
                self.engine.guard_stats.count("inflight_cancelled")
                p.future.resolve(ServeResult(
                    request_id=p.request.request_id,
                    status=STATUS_EXPIRED,
                    note=f"deadline passed mid-dispatch (waited "
                         f"{now - p.t_submit:.3f}s; dispatch watched, "
                         f"partial resolved without waiting it out)",
                    latency_s=now - p.t_submit))

    def _dispatch(self, bucket: int, rows) -> None:
        probing = self.breaker.state == HALF_OPEN
        attempts = {"n": 0}

        def call():
            attempts["n"] += 1
            try:
                return self.batcher.score(bucket, rows)
            except Exception as err:  # noqa: BLE001 — classified below
                if is_oom_error(err):
                    raise _OomSignal(err) from err
                raise

        # The watched call, priced by the model the batcher formed the
        # dispatch with; its tick resolves rows whose deadline passes.
        wd = self.engine.watchdog
        if wd.enabled:
            cost = sched_mod.bucket_cost(
                len(rows), bucket, self.engine.rt.batch_size,
                self.batcher.decode_cost,
                fused_decode=self.batcher.fused_decode)

            def dispatch_call():
                return wd.watch(call, cost=cost, site="serve",
                                on_tick=self._cancel_expired_inflight)
        else:
            dispatch_call = call

        self._inflight = list(rows)
        try:
            try:
                payloads = retry_with_exponential_backoff(
                    dispatch_call, retry_on=(Exception,),
                    config=self.config.retry,
                    log=lambda m: log.warning("serve dispatch retry: %s",
                                              m),
                    clock=self.clock, give_up_on=(EnginePoisoned,))
            except (KeyboardInterrupt, SystemExit, EnginePoisoned):
                raise
            except _OomSignal as sig:
                payloads = self._dispatch_oom(bucket, rows, sig.err)
                if payloads is None:
                    return
            except Exception as err:  # noqa: BLE001 — degrade, never crash
                self._dispatch_failed(bucket, rows, err, probing)
                return
            if attempts["n"] > 1:
                self.faults.count("recovered_dispatches")
            self.breaker.record_success()
            now = self.clock()
            for p, payload in zip(rows, payloads):
                self._resolve_payload(p, payload, now)
        except EnginePoisoned as err:
            self._dispatch_poisoned(rows, err)
        finally:
            self._inflight = []

    def _dispatch_poisoned(self, rows, err: EnginePoisoned) -> None:
        """An abandoned dispatch still holds the engine after the
        watchdog's grace: the dispatch's unresolved rows error and the
        breaker opens at once. Its half-open probe settles again, and
        dispatches only once the abandoned call has left the engine."""
        note = f"engine poisoned by an abandoned dispatch: {err}"
        log.error("serve: %s", note)
        opened = self.breaker.trip()    # before any row reports the error
        now = self.clock()
        for p in rows:
            if not p.future.done():
                self.stats.count("errors")
                p.future.resolve(ServeResult(
                    request_id=p.request.request_id, status=STATUS_ERROR,
                    note=note, latency_s=now - p.t_submit))
        if opened:
            self._drain_open(note)

    def _dispatch_oom(self, bucket: int, rows,
                      err: BaseException) -> Optional[List[Dict]]:
        """A dispatch ran out of device memory: the governor's reclaim,
        then ONE retry. Success returns the payloads; failure errors
        only this dispatch's rows, with the ledger's arithmetic, and the
        breaker's count does not move."""
        gov = self.engine.governor
        log.warning("serve: dispatch OOMed (%r); routing through the "
                    "device-memory governor", err)
        self.engine.watchdog.settle()
        if gov.handle_oom("serve"):
            try:
                with self.engine.watchdog.exclusive():
                    payloads = self.batcher.score(bucket, rows)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as err2:  # noqa: BLE001 — errored below
                err = err2
                gov.stats.count("oom_exhausted")
            else:
                self.faults.count("recovered_dispatches")
                self.breaker.record_success()
                return payloads
        note = gov.oom_message("serve", err)
        now = self.clock()
        self.stats.count("errors", len(rows))
        log.error("serve: %s", note)
        for p in rows:
            p.future.resolve(ServeResult(
                request_id=p.request.request_id, status=STATUS_ERROR,
                note=note, latency_s=now - p.t_submit))
        return None

    def _dispatch_failed(self, bucket: int, rows, err: BaseException,
                         probing: bool) -> None:
        """Retries spent on the full batch: the degradation ladder
        (not on a half-open probe, which tests the device cheaply), and
        only on TOTAL failure the breaker."""
        if self.config.degrade_ladder and not probing:
            self.faults.count("degraded_dispatches")
            log.warning("serve: dispatch failed after retries (%r); "
                        "bisecting %d rows", err, len(rows))
            with self.engine.watchdog.exclusive():
                self.engine.reset_dispatch_state()
                results = degrade_dispatch(
                    lambda rs: self.batcher.score(bucket, rs), rows,
                    log=lambda m: log.warning("serve degrade: %s", m))
            if any(r is not None for r in results):
                # The device works; the failure was transient or row-
                # local. Culprits resolve as errors, the rest scored.
                self.faults.count("recovered_dispatches")
                self.breaker.record_success()
                now = self.clock()
                n_poison = 0
                for p, payload in zip(rows, results):
                    if payload is None:
                        n_poison += 1
                        self.stats.count("errors")
                        p.future.resolve(ServeResult(
                            request_id=p.request.request_id,
                            status=STATUS_ERROR,
                            note=f"poison row isolated by the degradation "
                                 f"ladder: {err!r}",
                            latency_s=now - p.t_submit))
                    else:
                        self._resolve_payload(p, payload, now)
                if n_poison:
                    self.faults.count("degraded_rows", n_poison)
                    log.warning("serve: degradation ladder isolated %d "
                                "poison row(s) out of %d; dispatch "
                                "recovered", n_poison, len(rows))
                return
        # Total failure: every row errors, the breaker counts it.
        now = self.clock()
        self.stats.count("errors", len(rows))
        for p in rows:
            p.future.resolve(ServeResult(
                request_id=p.request.request_id, status=STATUS_ERROR,
                note=f"device error after retries: {err!r}",
                latency_s=now - p.t_submit))
        opened = self.breaker.record_failure()
        log.warning("serve: dispatch failed (%d consecutive, breaker %s)"
                    ": %r", self.breaker.consecutive_failures,
                    self.breaker.state, err)
        if opened:
            self._drain_open(
                f"server unhealthy — circuit breaker open after "
                f"{self.breaker.consecutive_failures} consecutive "
                f"dispatch failures: {err!r}")

    def _drain_open(self, note: str) -> None:
        """The breaker just opened: every waiting request resolves with
        an error (``note``); submits shed until the half-open probe
        succeeds."""
        n = self.queue.flush(STATUS_ERROR, note)
        n += self.batcher.flush_all(STATUS_ERROR, note)
        log.error("serve: circuit breaker OPEN; drained %d queued "
                  "requests; half-open probe in %.1fs (%s)", n,
                  self.config.breaker_cooldown_s, note)

    # -- crash-consistent shutdown/resume ------------------------------------

    def pending_requests(self) -> List[ServeRequest]:
        """Every admitted, unresolved request: queued, bucketed and in
        flight. Exact once the supervisor has stopped."""
        pendings = (self.queue.snapshot() + self.batcher.snapshot()
                    + list(self._inflight))
        return [p.request for p in pendings if not p.future.done()]

    def save_checkpoint(self, path) -> int:
        """Atomically write the unresolved requests and the live ring
        (tmp + fsync + rename). Returns the requests checkpointed."""
        reqs = [r.to_record() for r in self.pending_requests()]
        atomic_write_json(Path(path), {
            "version": CHECKPOINT_VERSION,
            "model": self.model_name,
            "requests": reqs,
            "stream": (self.stream.state()
                       if self.stream is not None else None),
        })
        return len(reqs)

    def shutdown_checkpoint(self, path, timeout: float = 10.0) -> int:
        """SIGTERM path: stop the supervisor WITHOUT working off the
        backlog, then checkpoint every unresolved request. An in-flight
        row is included iff its future has not resolved, so no request
        is both served and checkpointed."""
        self._abort = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        n = self.save_checkpoint(path)
        log.info("serve: shutdown checkpoint wrote %d pending requests "
                 "-> %s", n, path)
        return n

    def resume_from_checkpoint(self, path) -> List[ServeFuture]:
        """Re-submit every request of a shutdown checkpoint (a request
        already served may ride the result cache). Returns the futures
        in checkpoint order."""
        data = json.loads(Path(path).read_text())
        if self.stream is not None:
            self.stream.restore(data.get("stream"))
        reqs = [ServeRequest.from_record(r)
                for r in data.get("requests", ())]
        log.info("serve: resuming %d checkpointed requests from %s",
                 len(reqs), path)
        return [self.submit(r) for r in reqs]


# ---------------------------------------------------------------------------
# Fleet serving: one question across every model (the agreement axis as
# a request class)
# ---------------------------------------------------------------------------


def fleet_decision(token_1_prob, token_2_prob) -> Optional[int]:
    """The binary decision the agreement statistic counts: the streaming
    fold's rule exactly (yes / (yes + no) > 0.5), or None for a row
    without both probabilities, with a non-finite sum or a zero total."""
    if token_1_prob is None or token_2_prob is None:
        return None
    t1, t2 = float(token_1_prob), float(token_2_prob)
    total = t1 + t2
    if not math.isfinite(total) or total <= 0:
        return None
    return 1 if t1 / total > 0.5 else 0


def aggregate_fleet(request_id: str, results: Dict[str, ServeResult],
                    latency_s: float) -> Dict:
    """One ``fleet_score`` fan-out's per-model results folded into the
    agreement payload: each model's P(yes), P(no) and decision, the
    within-question kappa over the valid decisions (through
    ``stats/streaming.group_counts`` and ``kappa_from_counts``, the
    contingency path of the streaming sink and the CSV pipeline), and the
    pairwise disagreement (1 - observed agreement; NaN under two valid
    decisions). Status: ok when every model answered ok, "partial" when
    some did, error when none did."""
    per_model: Dict[str, Dict] = {}
    decisions = []
    for mid in sorted(results):
        r = results[mid]
        dec = (fleet_decision(r.token_1_prob, r.token_2_prob)
               if r.status == STATUS_OK else None)
        per_model[mid] = {
            "status": r.status,
            "token_1_prob": r.token_1_prob,
            "token_2_prob": r.token_2_prob,
            "weighted_confidence": r.weighted_confidence,
            "confidence_value": r.confidence_value,
            "decision": dec,
            "cached": r.cached,
        }
        if r.note:
            per_model[mid]["note"] = r.note
        if dec is not None:
            decisions.append(dec)
    n_ok = sum(1 for m in per_model.values() if m["status"] == STATUS_OK)
    if decisions:
        n_g, s_g = streaming.group_counts(
            np.zeros(len(decisions), dtype=np.int64),
            np.asarray(decisions, dtype=np.int64))
        kap = streaming.kappa_from_counts(n_g, s_g)
    else:
        kap = {"kappa": float("nan"), "observed_agreement": float("nan"),
               "expected_agreement": float("nan")}
    n = len(decisions)
    disagreement = (1.0 - float(kap["observed_agreement"])
                    if n * (n - 1) // 2 > 0 else float("nan"))
    status = (STATUS_OK if n_ok == len(per_model) and per_model
              else "partial" if n_ok else STATUS_ERROR)
    return {
        "request_id": request_id,
        "status": status,
        "n_models": len(per_model),
        "n_valid": n,
        "per_model": per_model,
        "kappa": {k: float(v) for k, v in kap.items()},
        "disagreement": disagreement,
        "latency_s": latency_s,
    }


class FleetScoreFuture:
    """Completion handle of one fan-out: resolves once every per-model
    future has (each with SOME status), then aggregates."""

    def __init__(self, request_id: str, futures: Dict[str, ServeFuture],
                 t_submit: float,
                 clock: Callable[[], float] = time.monotonic):
        self.request_id = request_id
        self._futures = futures
        self._t_submit = t_submit
        self._clock = clock

    def done(self) -> bool:
        return all(f.done() for f in self._futures.values())

    def result(self, timeout: Optional[float] = None) -> Dict:
        deadline = None if timeout is None else self._clock() + timeout
        results: Dict[str, ServeResult] = {}
        for mid, fut in self._futures.items():
            left = (None if deadline is None
                    else max(deadline - self._clock(), 0.0))
            results[mid] = fut.result(left)
        return aggregate_fleet(self.request_id, results,
                               self._clock() - self._t_submit)


class FleetScoringServer:
    """Multiplexed scoring service over a ``ModelFleet``: per-model
    dispatch queues (serve/batcher.FleetBatcher), resident-first
    selection with a background prefetch of the next model, and the
    ``fleet_score`` request class (:meth:`submit_fleet`).

    Leaner than :class:`ScoringServer`, as in the JAX package: it keeps
    the retry policy, deadline expiry (the batcher's) and the numerics
    guard's quarantine, and has no breaker, ladder or checkpoint. A
    per-model result is bitwise what the same request on a single-model
    ScoringServer over the same engine returns with its prefix cache off
    (the fleet batchers run without one): the dispatch is the same
    ``ContinuousBatcher.score`` on the same engine.

    The fleet adopts the first member engine's governor and every member
    engine reports into it: one ledger. Left out: ``tiers=`` with
    ``enabled`` (ROADMAP A8d) and :meth:`attach_observatory` (the
    sentinel observatory and metrics registry, "Also open") raise; the
    JAX server's ``fresh_handoff`` per engine is XLA buffer donation and
    has no counterpart here (``reset_dispatch_state`` drops a parked
    chain instead).
    """

    def __init__(self, fleet, config: Optional[ServeConfig] = None,
                 fleet_deadline_s: float = 60.0,
                 stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tiers=None):
        _refuse_tiers(tiers)
        self.fleet = fleet
        self.config = config or ServeConfig()
        self.fleet_deadline_s = float(fleet_deadline_s)
        self.stats = stats if stats is not None else ServeStats()
        self.clock = clock
        self.queue = RequestQueue(self.config.queue_depth, self.stats,
                                  clock)
        self.batcher = FleetBatcher(fleet, self.stats,
                                    self.config.linger_s, clock,
                                    pad_full=self.config.pad_full)
        engines = [e for e in (fleet.engine(m) for m in fleet.model_ids)
                   if e is not None]
        for eng in engines:
            eng.reset_dispatch_state()
        if fleet.governor is None and engines:
            fleet.attach_governor(engines[0].governor)
        if fleet.governor is not None:
            for eng in engines:
                eng.governor = fleet.governor
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def model_ids(self) -> List[str]:
        return self.fleet.model_ids

    @property
    def queue_depth(self) -> int:
        """The router's load signal (see ScoringServer.queue_depth)."""
        return len(self.queue) + self.batcher.pending_rows

    def oldest_wait(self, now: Optional[float] = None) -> float:
        return self.batcher.oldest_wait(self.clock() if now is None
                                        else now)

    @property
    def hbm_pressure(self) -> float:
        """The shared ledger's pressure (0 ungoverned or unbounded)."""
        gov = self.fleet.governor
        return 0.0 if gov is None else float(gov.pressure())

    def resident_models(self) -> List[str]:
        """Models whose weights are in the fleet's WeightCache now (the
        router's residency seed)."""
        return [m for m in self.fleet.model_ids if self.fleet.resident(m)]

    # -- client side ---------------------------------------------------------

    def submit(self, request: ServeRequest, model_id: str) -> ServeFuture:
        """Admit one request for ONE fleet model, tokenized here with that
        model's tokenizer."""
        self.stats.count("submitted")
        engine = self.fleet.engine(model_id)
        assert engine is not None, f"unknown fleet model {model_id}"
        fut = ServeFuture()
        now = self.clock()
        with engine._tok_lock:
            bin_ids = tuple(int(i) for i in engine.tokenizer(
                request.binary_prompt).input_ids)
            conf_ids = tuple(int(i) for i in engine.tokenizer(
                request.confidence_prompt).input_ids)
            t1, t2 = tok.target_token_ids(
                engine.tokenizer, tuple(request.targets),
                encoder_decoder=engine.encoder_decoder)
        lcp = tok.shared_prefix_len(bin_ids, conf_ids)
        deadline = (request.deadline_s if request.deadline_s is not None
                    else self.fleet_deadline_s)
        bucket = tok.assign_bucket(max(lcp, 1), engine.buckets)
        self.queue.offer(Pending(
            request=request, future=fut, t_submit=now,
            t_deadline=now + deadline, bin_ids=bin_ids, conf_ids=conf_ids,
            lcp=lcp, bucket=bucket, t1=int(t1), t2=int(t2),
            model_id=model_id))
        return fut

    def submit_fleet(self, request: ServeRequest,
                     models: Optional[List[str]] = None
                     ) -> FleetScoreFuture:
        """The fleet request class: ``request`` across every fleet model
        (or ``models``), aggregated into agreement."""
        mids = list(models) if models is not None else self.fleet.model_ids
        self.fleet.stats.count("fleet_requests")
        self.fleet.stats.count("fleet_rows", len(mids))
        t0 = self.clock()
        futures = {mid: self.submit(dataclasses_replace_id(request, mid),
                                    mid)
                   for mid in mids}
        return FleetScoreFuture(request.request_id, futures, t0,
                                self.clock)

    # -- supervisor side -----------------------------------------------------

    def start(self) -> "FleetScoringServer":
        assert self._thread is None, "server already started"
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while True:
            stopping = self._stop.is_set()
            for p in self.queue.drain():
                self.batcher.admit(p)
            d = self.batcher.next_dispatch(self.clock(), flush=stopping)
            if d is None:
                if (stopping and len(self.queue) == 0
                        and self.batcher.pending_rows == 0):
                    return
                self.queue.wait_nonempty(
                    0.005 if self.batcher.pending_rows else 0.05)
                continue
            self._dispatch(*d)

    def attach_observatory(self, scheduler) -> None:
        raise NotImplementedError(
            "the sentinel observatory and the metrics registry are not "
            "ported yet (ROADMAP \"Also open\")")

    def stats_summary(self) -> Dict:
        """The ``stats`` endpoint: serve counters and the fleet's swap
        accounting."""
        return {"serve": self.stats.summary(),
                "fleet": self.fleet.stats.summary()}

    def fleet_summary(self) -> Dict:
        return self.fleet.stats.summary()

    def _dispatch(self, model_id: str, bucket: int, rows) -> None:
        engine = self.fleet.engine(model_id)
        try:
            payloads = retry_with_exponential_backoff(
                lambda: self.batcher.score(model_id, bucket, rows),
                retry_on=(Exception,), config=self.config.retry,
                log=lambda m: log.warning("fleet dispatch retry (%s): %s",
                                          model_id, m),
                clock=self.clock)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as err:  # noqa: BLE001 — resolve, never crash
            now = self.clock()
            self.stats.count("errors", len(rows))
            for p in rows:
                p.future.resolve(ServeResult(
                    request_id=p.request.request_id, status=STATUS_ERROR,
                    note=f"device error after retries on {model_id}: "
                         f"{err!r}",
                    latency_s=now - p.t_submit))
            return
        now = self.clock()
        for p, payload in zip(rows, payloads):
            reason = None
            if engine.rt.numerics_guard:
                engine.guard_stats.site("checked", "fleet")
                reason = numerics.check_payload(payload)
            if reason is not None:
                engine.guard_stats.quarantine("fleet", reason)
                self.stats.count("errors")
                p.future.resolve(ServeResult(
                    request_id=p.request.request_id, status=STATUS_ERROR,
                    note=f"{numerics.NUMERICS_ERROR} — {reason} "
                         f"(row quarantined by the numerics guard)",
                    latency_s=now - p.t_submit))
                continue
            self.stats.count("completed")
            self.stats.record_latency(now - p.t_submit)
            p.future.resolve(ServeResult(
                request_id=p.request.request_id, status=STATUS_OK,
                latency_s=now - p.t_submit, **payload))


def dataclasses_replace_id(request: ServeRequest,
                           model_id: str) -> ServeRequest:
    """A fan-out's per-model sub-request: the same prompts and targets,
    the request id suffixed with the model."""
    return dataclasses.replace(
        request, request_id=f"{request.request_id}#{model_id}")
