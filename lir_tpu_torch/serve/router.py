"""Multi-replica serving: the failover router and the disaggregated
migration chain. Port of ``lir_tpu/serve/router.py``.

A :class:`ReplicaRouter` spreads one request stream over N replica
servers (``ScoringServer`` or ``FleetScoringServer``), each behind its
own router-side :class:`~lir_tpu_torch.faults.breaker.CircuitBreaker`.
Placement (:meth:`ReplicaRouter._pick`) reads per replica:

- **queue depth** (queue + bucketed rows), the load signal;
- **breaker state**: a replica that keeps erroring (or was killed)
  takes no traffic until its cooldown probe;
- **weight residency**: a fleet replica's ``WeightCache.add_listener``
  insert and evict events feed a residency map, so a model's requests
  land where its weights are;
- **page residency**: every replica engine's radix tree feeds its page
  events into one :class:`~lir_tpu_torch.engine.prefix_tree.
  ClusterPrefixIndex`, so a prompt lands where its prefix pages are;
- **the SLO term**: the replica's oldest queued row against the
  request's remaining deadline;
- **memory pressure**: the replica's governor pressure.

Equal replicas take turns (round-robin ties).

Failover:

- a replica that answers ``error`` (or sheds) sends the request to the
  next-best replica while the deadline allows (``failovers``);
- a replica KILLED mid-dispatch (:meth:`ReplicaRouter.kill_replica`, or
  a ``replica_kill`` fault schedule through ``faults.wrap_replica``) has
  its in-flight requests re-admitted to survivors at once
  (``re_admitted``) and its breaker forced open, so a rejoin
  (:meth:`ReplicaRouter.revive_replica`) recovers through the ordinary
  half-open probe;
- every request resolves EXACTLY ONCE through one ``ServeFuture`` (first
  resolution wins), and payloads are content-addressed with the result
  cache's key, so a zombie's late payload is counted
  (``zombie_payloads``) and dropped;
- a request inside the deadline whisker (``RouterConfig.hedge_s``) is
  HEDGED onto a second replica, first payload wins.

The replicas share one engine configuration, so the winning payload is
the payload any replica would give where they dispatch at the same row
count (prefix cache off, ``pad_full``: bitwise; ROADMAP R1 otherwise).

Disaggregated prefill and decode (serve/migrate.py): with ``roles``
splitting the replicas into PREFILL-role and DECODE-role ones and
``MigrationConfig.enabled``, a request whose prefix is not already on
its decode replica PULLS the pages from the replica that holds them
(export, transfer, import), or, with a prefix of at least
``min_prefix_tokens``, prefills on a prefill replica first; the decode
replica then scores it over the imported pages. Each hop is a page op
on the owning replica's supervisor thread, chained by callbacks; a
stall past ``timeout_s`` (policed by the tick), a corrupt chunk, a dead
replica or any failed hop falls back to a local re-prefill on a decode
replica (``refetch_fallbacks``), never a wrong or dropped answer.
Imported pages hold the bits of the prefill replica's dispatch shape
(ROADMAP R1). ``stats_summary`` carries the ``"migrate"`` block
(``MigrationStats``).

Left out: the memory tiers (ROADMAP A8d: a replica's ``"tiers"`` entry
is None and :meth:`ReplicaRouter._tier_priced` returns the device
match), the metrics registry and tracing spans ("Also open").
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..config import MigrationConfig, RouterConfig
from ..engine import prefix_tree
from ..engine import tokens as tok
from ..faults import CircuitBreaker
from ..utils.logging import get_logger
from ..utils.profiling import MigrationStats, RouterStats, ServeStats
from . import migrate as migrate_mod
from .cache import ResultCache, content_key
from .queue import (STATUS_ERROR, STATUS_OK, STATUS_SHED, ServeFuture,
                    ServeRequest, ServeResult)

log = get_logger(__name__)

# The measurement fields of a payload: what the router's dedup cache
# stores and ServeResult(**payload) expands.
PAYLOAD_FIELDS = ("model_response", "model_confidence_response",
                  "token_1_prob", "token_2_prob", "log_probabilities",
                  "confidence_value", "weighted_confidence")


def _payload_of(res: ServeResult) -> Dict:
    return {f: getattr(res, f) for f in PAYLOAD_FIELDS}


class _Replica:
    """Router-side state of one replica server."""

    def __init__(self, replica_id: str, server, breaker: CircuitBreaker,
                 role: str = "both"):
        assert role in ("prefill", "decode", "both"), role
        self.replica_id = replica_id
        self.server = server
        self.breaker = breaker
        self.alive = True
        # "prefill" replicas take prefill-only dispatches, and scoring
        # only when no decode-capable replica survives.
        self.role = role
        self.is_fleet = hasattr(server, "fleet")
        self._lock = threading.Lock()
        # Requests attempted on this replica now, by pending id: what a
        # kill re-admits.
        self.inflight: Dict[int, "_Pending"] = {}
        # The residency map, fed by WeightCache listener events (which
        # may fire under the cache's lock: set operations only).
        self.resident: Set[str] = set()

    def seed_resident(self, models) -> None:
        with self._lock:
            self.resident = set(models)

    def on_weight_event(self, event: str, model_id: str) -> None:
        with self._lock:
            if event == "insert":
                self.resident.add(model_id)
            elif event == "evict":
                self.resident.discard(model_id)

    def resident_view(self) -> Set[str]:
        with self._lock:
            return set(self.resident)

    def track(self, pending: "_Pending") -> None:
        with self._lock:
            self.inflight[id(pending)] = pending

    def untrack(self, pending: "_Pending") -> None:
        with self._lock:
            self.inflight.pop(id(pending), None)

    def take_inflight(self) -> List["_Pending"]:
        with self._lock:
            victims = list(self.inflight.values())
            self.inflight.clear()
        return victims

    @property
    def depth(self) -> int:
        try:
            return int(self.server.queue_depth)
        except Exception:  # noqa: BLE001 — a dying replica reads as deep
            return 1 << 20

    def oldest_wait(self, now: float) -> float:
        fn = getattr(self.server, "oldest_wait", None)
        if fn is None:
            return 0.0
        try:
            return float(fn(now))
        except Exception:  # noqa: BLE001
            return 0.0

    @property
    def pressure(self) -> float:
        """The replica's governor pressure (0 ungoverned or unbounded):
        a squeezed replica is a worse home for new work even when its
        queue looks shallow."""
        try:
            return float(getattr(self.server, "hbm_pressure", 0.0))
        except Exception:  # noqa: BLE001
            return 0.0


class _Pending:
    """One routed request's life across its attempts."""

    __slots__ = ("request", "model_id", "future", "key", "t_submit",
                 "t_deadline", "tried", "hedged", "resolved", "lock")

    def __init__(self, request: ServeRequest, model_id: str, key: str,
                 t_submit: float, t_deadline: float):
        self.request = request
        self.model_id = model_id
        self.future = ServeFuture()
        self.key = key
        self.t_submit = t_submit
        self.t_deadline = t_deadline
        self.tried: Set[str] = set()
        self.hedged = False
        self.resolved = False
        self.lock = threading.Lock()

    def claim_resolution(self) -> bool:
        """True exactly once: the winning attempt's right to resolve."""
        with self.lock:
            if self.resolved:
                return False
            self.resolved = True
            return True


class _Migration:
    """One disaggregated chain's life (prefill -> export -> transfer ->
    import -> score), claimable exactly once: whichever of chain
    completion, failure fallback, tick timeout or replica kill claims
    first decides where the request scores; the others become no-ops (a
    late import merely warms the pool with verified pages)."""

    __slots__ = ("pending", "dst", "src", "bucket", "prefix_ids",
                 "dst_tokens", "t_deadline", "_claimed", "_lock")

    def __init__(self, pending: _Pending, dst: _Replica, src: _Replica,
                 bucket: int, prefix_ids: Tuple[int, ...], dst_tokens: int,
                 t_deadline: float):
        self.pending = pending
        self.dst = dst
        self.src = src
        self.bucket = int(bucket)
        self.prefix_ids = prefix_ids
        self.dst_tokens = int(dst_tokens)
        self.t_deadline = t_deadline
        self._claimed = False
        self._lock = threading.Lock()

    @property
    def claimed(self) -> bool:
        with self._lock:
            return self._claimed

    def claim(self) -> bool:
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True


class ReplicaRouter:
    """Failover router over N replica servers (module docstring).

    ``replicas`` is ``[(replica_id, server), ...]``: the caller starts
    and stops the servers; :meth:`start` / :meth:`stop` own only the
    router's tick thread (hedging, breaker promotion, migration
    deadlines). ``roles`` maps replica ids to "prefill" / "decode" /
    "both" (default "both": the role-less router). With a live
    prefill-role and a live decode-capable replica, a page index and
    ``migrate.enabled``, the router serves disaggregated (module
    docstring); ``migrator`` (``serve/migrate.PageMigrator``) holds the
    chain's config, its ``MigrationStats`` and the wire hop the fault
    plans wrap.
    """

    def __init__(self, replicas: Sequence[Tuple[str, object]],
                 config: Optional[RouterConfig] = None,
                 stats: Optional[RouterStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 roles: Optional[Dict[str, str]] = None,
                 migrate: Optional[MigrationConfig] = None,
                 migrate_stats: Optional[MigrationStats] = None):
        assert replicas, "a router needs at least one replica"
        roles = dict(roles or {})
        self.config = config or RouterConfig()
        self.stats = stats if stats is not None else RouterStats()
        self.migrate_config = migrate or MigrationConfig()
        self.migrate_stats = (migrate_stats if migrate_stats is not None
                              else MigrationStats())
        self.migrator = migrate_mod.PageMigrator(
            self.migrate_config, self.migrate_stats, clock=clock)
        self.clock = clock
        self._lock = threading.Lock()
        self._handles: Dict[str, _Replica] = {}
        self._pending: Dict[int, _Pending] = {}
        self._migrations: Dict[int, _Migration] = {}
        self._rr = 0
        for rid, server in replicas:
            assert rid not in self._handles, f"duplicate replica {rid}"
            breaker = CircuitBreaker(
                failure_threshold=self.config.replica_failure_threshold,
                cooldown_s=self.config.replica_cooldown_s, clock=clock)
            handle = _Replica(str(rid), server, breaker,
                              role=roles.get(str(rid), "both"))
            # The residency map: seeded from the resident set, then kept
            # by the WeightCache's insert and evict events.
            cache = getattr(getattr(server, "fleet", None), "cache", None)
            if cache is not None and hasattr(cache, "add_listener"):
                resident = getattr(server, "resident_models", None)
                if callable(resident):
                    handle.seed_resident(resident())
                cache.add_listener(handle.on_weight_event)
            self._handles[handle.replica_id] = handle
        # The cluster prefix index, fed by every replica tree's page
        # events as the residency map is by the WeightCache's.
        trees = {rid: getattr(getattr(h.server, "engine", None),
                              "prefix_cache", None)
                 for rid, h in self._handles.items()}
        page_size = next((t.page_size for t in trees.values()
                          if t is not None), 16)
        self.cluster_tree = prefix_tree.ClusterPrefixIndex(page_size)
        self._have_page_index = False
        for rid, tree in trees.items():
            if tree is not None:
                self._have_page_index = True
                tree.add_listener(
                    functools.partial(self.cluster_tree.on_event, rid))
        # Host and disk tier pages' placement discounts; no tier store
        # feeds the index until the memory tiers (ROADMAP A8d).
        self._tier_bonus: Dict[str, float] = {"host": 0.5, "disk": 0.25}
        # The router's content-addressed dedup: the exactly-once backstop.
        self.cache = ResultCache(self.config.cache_entries, ServeStats())
        self._engine_key = self._derive_engine_key()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _derive_engine_key(self) -> str:
        for handle in self._handles.values():
            key = getattr(handle.server, "_engine_key", None)
            if key is None and handle.is_fleet:
                key = "fleet:" + ",".join(handle.server.model_ids)
            if key:
                return str(key)
        return "router"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaRouter":
        assert self._thread is None, "router already started"
        self._thread = threading.Thread(target=self._loop,
                                        name="replica-router", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the tick is advisory; it
                # must never take routing down.
                log.exception("router tick failed; continuing")

    # -- introspection -------------------------------------------------------

    @property
    def replica_ids(self) -> List[str]:
        return list(self._handles)

    def handle(self, replica_id: str) -> _Replica:
        return self._handles[replica_id]

    def breaker_of(self, replica_id: str) -> CircuitBreaker:
        return self._handles[replica_id].breaker

    def alive_replicas(self) -> List[str]:
        return [rid for rid, h in self._handles.items() if h.alive]

    def stats_summary(self) -> Dict:
        """The router's counters, the migration counters and each
        replica's health view (the JAX summary; no tier store, so every
        ``"tiers"`` is None)."""
        now = self.clock()
        return {
            "router": self.stats.summary(),
            "migrate": self.migrate_stats.summary(),
            "replicas": {
                rid: {
                    "alive": h.alive,
                    "role": h.role,
                    "breaker": h.breaker.state,
                    "queue_depth": h.depth,
                    "oldest_wait_s": round(h.oldest_wait(now), 4),
                    "hbm_pressure": round(h.pressure, 4),
                    "resident": sorted(h.resident_view()),
                    "tiers": None,
                }
                for rid, h in self._handles.items()
            },
        }

    # -- placement -----------------------------------------------------------

    def _tier_priced(self, bucket: int, prefix: Tuple[int, ...],
                     hbm_match: Dict[str, int]) -> Dict[str, float]:
        """Page equivalents per replica: device pages at full price plus
        host and disk tier pages at the tier bonuses. No tier store feeds
        the index yet, so this is the device match unchanged."""
        priced: Dict[str, float] = dict(hbm_match)
        for rid, by_tier in self.cluster_tree.match_tiers(
                bucket, prefix).items():
            for tier, pages in by_tier.items():
                bonus = self._tier_bonus.get(tier, 0.0)
                if bonus:
                    priced[rid] = priced.get(rid, 0) + bonus * pages
        return priced

    def _pick(self, model_id: str, exclude: Set[str],
              remaining_s: Optional[float] = None,
              page_match: Optional[Dict[str, float]] = None
              ) -> Optional[_Replica]:
        """The placement: among live replicas whose breaker admits and
        that are not in ``exclude``, the lowest score: queue depth, less
        the residency bonus where the model's weights are, less the page
        bonus per prefix page the replica holds, plus the SLO term and
        the pressure penalty. A prefill-role replica takes scoring only
        when no decode-capable one is a candidate (never a dropped
        request over role purity). Round-robin rotation breaks ties."""
        now = self.clock()
        with self._lock:
            self._rr += 1
            order = list(self._handles.values())
            order = order[self._rr % len(order):] \
                + order[:self._rr % len(order)]
        cands = [h for h in order
                 if h.alive and h.replica_id not in exclude
                 and h.breaker.allow()]
        cands = [h for h in cands if h.role != "prefill"] or cands
        if not cands:
            return None

        def score(h: _Replica) -> float:
            s = float(h.depth)
            if model_id and model_id in h.resident_view():
                s -= self.config.residency_bonus
            if page_match:
                s -= (self.migrate_config.page_bonus
                      * page_match.get(h.replica_id, 0))
            if self.config.slo_wait_weight > 0 and remaining_s:
                s += (self.config.slo_wait_weight * h.oldest_wait(now)
                      / max(remaining_s, 0.1))
            if self.config.pressure_weight > 0:
                s += self.config.pressure_weight * h.pressure
            return s

        return min(cands, key=score)

    def _pick_prefill(self, exclude: Set[str]) -> Optional[_Replica]:
        """The least-loaded live prefill-role replica with a page pool to
        export from, or None: the chain's prefill leg."""
        cands = [h for h in self._handles.values()
                 if h.alive and h.role == "prefill"
                 and h.replica_id not in exclude and h.breaker.allow()
                 and getattr(getattr(h.server, "engine", None),
                             "prefix_cache", None) is not None]
        if not cands:
            return None
        return min(cands, key=lambda h: h.depth)

    def _disagg_active(self) -> bool:
        """Disaggregated placement is live: migration enabled, a page
        index, and both a live prefill-role and a live decode-capable
        replica."""
        if not (self.migrate_config.enabled and self._have_page_index):
            return False
        have_prefill = any(h.alive and h.role == "prefill"
                           for h in self._handles.values())
        have_decode = any(h.alive and h.role != "prefill"
                          for h in self._handles.values())
        return have_prefill and have_decode

    def _tokenize_prefix(self, request: ServeRequest
                         ) -> Optional[Tuple[Tuple[int, ...], int]]:
        """(shared token prefix, ladder bucket) of ``request``, computed
        as a replica's admission computes them (the shared prefix of the
        two prompts, snapped to the engine's ladder), with the first
        replica engine that has a page pool; None when there is none."""
        for h in self._handles.values():
            eng = getattr(h.server, "engine", None)
            if eng is None or getattr(eng, "prefix_cache", None) is None:
                continue
            try:
                with eng._tok_lock:
                    bin_ids = [int(i) for i in eng.tokenizer(
                        request.binary_prompt).input_ids]
                    conf_ids = [int(i) for i in eng.tokenizer(
                        request.confidence_prompt).input_ids]
            except Exception:  # noqa: BLE001 — a probe only; the replica
                # tokenizes (and fails loudly) at admission.
                return None
            lcp = tok.shared_prefix_len(bin_ids, conf_ids)
            if lcp <= 0:
                return None
            bucket = tok.assign_bucket(max(lcp, 1), eng.buckets)
            return tuple(bin_ids[:lcp]), int(bucket)
        return None

    def _deadline_for(self, request: ServeRequest) -> float:
        if request.deadline_s is not None:
            return float(request.deadline_s)
        for h in self._handles.values():
            cfg = getattr(h.server, "config", None)
            if cfg is not None and hasattr(cfg, "deadline_for"):
                return float(cfg.deadline_for(request.klass))
        return 300.0

    # -- client side ---------------------------------------------------------

    def submit(self, request: ServeRequest,
               model_id: str = "") -> ServeFuture:
        """Route one request: dedup, place, attempt. The future resolves
        exactly once with the first winning payload (primary, failover,
        hedge or re-admission)."""
        now = self.clock()
        key = content_key(
            self._engine_key if not model_id
            else f"{self._engine_key}|{model_id}", request)
        if self.cache.max_entries > 0:
            hit = self.cache.get(key)
            if hit is not None:
                self.stats.count("dedup_hits")
                self.stats.count("completed")
                fut = ServeFuture()
                fut.resolve(ServeResult(
                    request_id=request.request_id, status=STATUS_OK,
                    cached=True, latency_s=self.clock() - now, **hit))
                return fut
        deadline_s = self._deadline_for(request)
        pending = _Pending(request, model_id, key, now, now + deadline_s)
        # The cluster index's probe: which replicas hold this prompt's
        # prefix pages (single-model traffic; a fleet keeps its own).
        # Placement prices tier pages (none yet); the migration decision
        # keeps the exact device match.
        prefix: Optional[Tuple[int, ...]] = None
        bucket = 0
        page_match: Dict[str, int] = {}
        pick_match: Dict[str, float] = {}
        if self._have_page_index and not model_id:
            info = self._tokenize_prefix(request)
            if info is not None:
                prefix, bucket = info
                page_match = self.cluster_tree.match_pages(bucket, prefix)
                pick_match = self._tier_priced(bucket, prefix, page_match)
        handle = self._pick(model_id, exclude=set(), remaining_s=deadline_s,
                            page_match=pick_match or page_match)
        if handle is None:
            self.stats.count("no_replica_sheds")
            pending.claim_resolution()
            pending.future.resolve(ServeResult(
                request_id=request.request_id, status=STATUS_SHED,
                note="no live replica available (all dead or "
                     "breaker-open)"))
            return pending.future
        self.stats.count("routed")
        if model_id and model_id in handle.resident_view():
            self.stats.count("routed_resident")
        with self._lock:
            self._pending[id(pending)] = pending
        if (prefix is not None and self._disagg_active()
                and handle.role != "prefill"
                and self._route_disaggregated(pending, handle, bucket,
                                              prefix, page_match)):
            return pending.future
        self._attempt(pending, handle, "primary")
        return pending.future

    def _route_disaggregated(self, pending: _Pending, dst: _Replica,
                             bucket: int, prefix: Tuple[int, ...],
                             page_match: Dict[str, int]) -> bool:
        """The disaggregation decision for one request (True: a chain
        owns it now):

        - the prefix's full pages are all on the chosen decode replica:
          score there (``cluster_tree_hits``);
        - another replica holds at least as many pages as the prompt
          needs: PULL them (export, transfer, import), no prefill;
        - the prefix is at least ``min_prefix_tokens`` long and a prefill
          replica lives: prefill THERE, then pull;
        - otherwise score colocated on the decode replica (the handoff
          would cost more than the prefill it saves)."""
        ps = self.cluster_tree.page_size
        want_pages = len(prefix) // ps
        have = page_match.get(dst.replica_id, 0)
        if want_pages <= 0:
            return False
        if have >= want_pages:
            self.migrate_stats.count("cluster_tree_hits")
            return False
        src: Optional[_Replica] = None
        need_prefill = False
        src_rid, src_pages = self.cluster_tree.best_holder(
            bucket, prefix, exclude=(dst.replica_id,))
        if (src_rid is not None and src_pages >= want_pages
                and self._handles[src_rid].alive
                and getattr(getattr(self._handles[src_rid].server,
                                    "engine", None),
                            "prefix_cache", None) is not None):
            src = self._handles[src_rid]      # warm elsewhere: a pure pull
        elif len(prefix) >= self.migrate_config.min_prefix_tokens:
            src = self._pick_prefill(exclude={dst.replica_id})
            need_prefill = src is not None
        if src is None:
            return False
        self._start_migration(pending, dst, src, bucket, prefix,
                              dst_tokens=have * ps,
                              need_prefill=need_prefill)
        return True

    # -- attempt machinery ---------------------------------------------------

    def _attempt(self, pending: _Pending, handle: _Replica,
                 kind: str) -> None:
        with pending.lock:
            pending.tried.add(handle.replica_id)
        handle.track(pending)
        self.stats.placed(handle.replica_id)
        try:
            if handle.is_fleet and pending.model_id:
                inner = handle.server.submit(pending.request,
                                             pending.model_id)
            else:
                inner = handle.server.submit(pending.request)
        except Exception as err:  # noqa: BLE001 — a replica whose submit
            # raises is as dead as one that errors.
            handle.untrack(pending)
            self._on_result(pending, handle, kind, ServeResult(
                request_id=pending.request.request_id, status=STATUS_ERROR,
                note=f"replica {handle.replica_id} submit raised: "
                     f"{err!r}"))
            return
        inner.add_done_callback(
            lambda res, p=pending, h=handle, k=kind:
            self._on_result(p, h, k, res))

    def _forget(self, pending: _Pending) -> None:
        with self._lock:
            self._pending.pop(id(pending), None)

    def _on_result(self, pending: _Pending, handle: _Replica, kind: str,
                   res: ServeResult) -> None:
        """One attempt resolved on ``handle`` (on the replica's resolving
        thread). The winner resolves the router's future and feeds the
        dedup cache; a loser is counted (zombie payload or hedge loss)
        and dropped."""
        handle.untrack(pending)
        if res.status == STATUS_OK:
            if handle.alive:
                # A dead replica's late success must not move its
                # breaker: recovery is the revive and half-open probe's.
                handle.breaker.record_success()
            if not pending.claim_resolution():
                # A payload for a resolved request: the hedge's loser, or
                # a zombie from a killed replica. Dropped; the put is
                # idempotent by content address.
                with pending.lock:
                    was_hedged = pending.hedged
                self.stats.count("hedge_losses"
                                 if handle.alive and was_hedged
                                 else "zombie_payloads")
                self.cache.put(pending.key, _payload_of(res))
                return
            self.cache.put(pending.key, _payload_of(res))
            self.stats.count("completed")
            if kind == "hedge":
                self.stats.count("hedge_wins")
            pending.future.resolve(dataclasses.replace(
                res, latency_s=self.clock() - pending.t_submit))
            self._forget(pending)
            return
        if res.status in (STATUS_ERROR, STATUS_SHED):
            if res.status == STATUS_ERROR:
                self.stats.count("replica_errors")
                opened = (handle.breaker.record_failure()
                          if handle.alive else False)
                if opened:
                    log.warning("router: replica %s breaker OPEN "
                                "(cooldown %.1fs)", handle.replica_id,
                                self.config.replica_cooldown_s)
            else:
                self.stats.count("replica_sheds")
            with pending.lock:
                if pending.resolved:
                    return
            remaining = pending.t_deadline - self.clock()
            if remaining > 0:
                nxt = self._pick(pending.model_id,
                                 exclude=set(pending.tried),
                                 remaining_s=remaining)
                if nxt is not None:
                    self.stats.count("failovers")
                    self._attempt(pending, nxt, "failover")
                    return
            if not pending.claim_resolution():
                return
            self.stats.count("errors")
            pending.future.resolve(res)
            self._forget(pending)
            return
        # Expired or partial: the deadline is gone, and another replica
        # could only answer later still.
        if pending.claim_resolution():
            pending.future.resolve(res)
            self._forget(pending)

    # -- the migration chain (serve/migrate.py) ------------------------------

    def _start_migration(self, pending: _Pending, dst: _Replica,
                         src: _Replica, bucket: int,
                         prefix: Tuple[int, ...], dst_tokens: int,
                         need_prefill: bool) -> None:
        """Start one chain: [prefill on src ->] export(src) -> transfer
        -> import(dst) -> score(dst). Every hop is a page op on the owning
        replica's supervisor thread, linked by completion callbacks; the
        chain's deadline (``timeout_s``, policed by the tick) and every
        failure end in :meth:`_mig_fallback`."""
        mig = _Migration(pending, dst, src, bucket, prefix, dst_tokens,
                         self.clock() + self.migrate_config.timeout_s)
        with self._lock:
            self._migrations[id(mig)] = mig
        if need_prefill:
            self.migrate_stats.count("prefill_ops")
            fut = src.server.submit_prefill(bucket, prefix)
            fut.add_done_callback(
                lambda f, m=mig: self._mig_prefilled(m, f))
        else:
            self._mig_export(mig)

    def _mig_prefilled(self, mig: _Migration,
                       fut: migrate_mod.OpFuture) -> None:
        if mig.claimed:
            return
        if fut.error is not None:
            self._mig_fallback(mig, f"prefill failed: {fut.error!r}")
            return
        self._mig_export(mig)

    def _mig_export(self, mig: _Migration) -> None:
        cfg, clock = self.migrate_config, self.clock
        fut = mig.src.server.submit_page_op(
            lambda eng, m=mig: migrate_mod.export_prefix(
                eng, m.bucket, m.prefix_ids, from_token=m.dst_tokens,
                config=cfg, clock=clock))
        fut.add_done_callback(lambda f, m=mig: self._mig_exported(m, f))

    def _mig_exported(self, mig: _Migration,
                      fut: migrate_mod.OpFuture) -> None:
        if mig.claimed:
            return
        if fut.error is not None:
            self._mig_fallback(mig, f"export failed: {fut.error!r}")
            return
        export = fut.value
        if export is None:
            self._mig_fallback(
                mig, f"nothing cached to export on {mig.src.replica_id}")
            return
        try:
            # The wire hop: the fault seam (migration_stall sleeps here,
            # migration_corrupt flips chunk bytes under the checksums).
            export = self.migrator.transfer(export)
        except Exception as err:  # noqa: BLE001 — any wire failure has
            # the same answer: a local re-prefill.
            self.migrate_stats.count("stalls")
            self._mig_fallback(mig, f"transfer failed: {err!r}")
            return
        cfg, clock = self.migrate_config, self.clock
        fut2 = mig.dst.server.submit_page_op(
            lambda eng, e=export: migrate_mod.import_prefix(
                eng, e, config=cfg, clock=clock))
        fut2.add_done_callback(
            lambda f, m=mig, e=export: self._mig_imported(m, e, f))

    def _mig_imported(self, mig: _Migration,
                      export: migrate_mod.PageExport,
                      fut: migrate_mod.OpFuture) -> None:
        if fut.error is not None:
            if (isinstance(fut.error, migrate_mod.MigrationError)
                    and "checksum" in str(fut.error)):
                self.migrate_stats.count("corrupt_chunks")
            self._mig_fallback(mig, f"import failed: {fut.error!r}")
            return
        if not mig.claim():
            return      # timed out meanwhile; the verified pages landed
        with self._lock:
            self._migrations.pop(id(mig), None)
        imp = fut.value
        if imp.pages > 0:
            self.migrator.account(export, imp)
        else:
            self.migrate_stats.count("cluster_tree_hits")
        self._attempt(mig.pending, mig.dst, "migrated")

    def _mig_fallback(self, mig: _Migration, reason: str) -> None:
        """Abandon a chain: the request scores with a LOCAL re-prefill on
        the decode replica (or any survivor): the failed transfer cost
        latency, never correctness."""
        if not mig.claim():
            return
        with self._lock:
            self._migrations.pop(id(mig), None)
        self.migrate_stats.count("refetch_fallbacks")
        log.warning("router: migration abandoned for request %s (%s); "
                    "falling back to local re-prefill",
                    mig.pending.request.request_id, reason)
        dst: Optional[_Replica] = mig.dst
        if not (dst.alive and dst.breaker.allow()):
            dst = self._pick(
                mig.pending.model_id, exclude={mig.dst.replica_id},
                remaining_s=max(mig.pending.t_deadline - self.clock(),
                                0.0))
        if dst is None:
            if mig.pending.claim_resolution():
                self.stats.count("errors")
                mig.pending.future.resolve(ServeResult(
                    request_id=mig.pending.request.request_id,
                    status=STATUS_ERROR,
                    note=f"migration failed ({reason}) and no replica "
                         f"survives to re-prefill locally"))
                self._forget(mig.pending)
            return
        self._attempt(mig.pending, dst, "refetch")

    # -- failover ------------------------------------------------------------

    def kill_replica(self, replica_id: str) -> int:
        """A replica observed DEAD: force its breaker open, place nothing
        more on it, and re-admit its unresolved in-flight requests to
        survivors, once each (its late payloads are zombies). Returns how
        many were re-admitted."""
        handle = self._handles[replica_id]
        handle.alive = False
        handle.breaker.trip()
        self.stats.count("kills")
        # Chains touching the dead replica fall back NOW: their requests
        # re-prefill locally on a survivor instead of waiting out the
        # chain's deadline.
        with self._lock:
            migs = [m for m in self._migrations.values()
                    if replica_id in (m.src.replica_id, m.dst.replica_id)]
        for m in migs:
            self._mig_fallback(m, f"replica {replica_id} died "
                                  f"mid-migration")
        victims = handle.take_inflight()
        n = 0
        t0 = self.clock()
        for p in victims:
            with p.lock:
                if p.resolved:
                    continue
            nxt = self._pick(p.model_id, exclude={replica_id},
                             remaining_s=max(p.t_deadline - t0, 0.0))
            if nxt is None:
                if p.claim_resolution():
                    self.stats.count("errors")
                    p.future.resolve(ServeResult(
                        request_id=p.request.request_id, status=STATUS_ERROR,
                        note=f"replica {replica_id} died with no survivor "
                             f"to re-admit to"))
                    self._forget(p)
                continue
            n += 1
            self.stats.count("re_admitted")
            self._attempt(p, nxt, "re_admit")
        log.warning("router: replica %s killed; %d in-flight request(s) "
                    "re-admitted to survivors", replica_id, n)
        return n

    def revive_replica(self, replica_id: str) -> None:
        """The replica rejoined: placeable again. Its breaker stays OPEN
        until the cooldown ends, so its first request is the half-open
        probe: a success closes the breaker, a failure re-opens it."""
        handle = self._handles[replica_id]
        handle.alive = True
        self.stats.count("revives")
        log.info("router: replica %s revived (breaker %s; probe after "
                 "cooldown)", replica_id, handle.breaker.state)

    # -- the tick (hedging, migration deadlines) -----------------------------

    def _tick(self) -> None:
        now = self.clock()
        # Reading the state promotes an OPEN breaker past its cooldown.
        for h in self._handles.values():
            h.breaker.state  # noqa: B018 — promotion side effect
        # Chains past their deadline fall back to a local re-prefill (a
        # stalled transfer costs one timeout, not the request).
        with self._lock:
            stale = [m for m in self._migrations.values()
                     if now >= m.t_deadline]
        for m in stale:
            if not m.claimed:
                self.migrate_stats.count("stalls")
                self._mig_fallback(
                    m, f"chain exceeded "
                       f"{self.migrate_config.timeout_s:.1f}s deadline")
        if self.config.hedge_s <= 0:
            return
        with self._lock:
            pendings = list(self._pending.values())
        for p in pendings:
            remaining = p.t_deadline - now
            if remaining > self.config.hedge_s:
                continue
            with p.lock:
                if p.resolved or p.hedged:
                    continue
                tried = set(p.tried)
            nxt = self._pick(p.model_id, exclude=tried,
                             remaining_s=max(remaining, 0.0))
            if nxt is None:
                continue
            with p.lock:
                if p.resolved or p.hedged:
                    continue
                p.hedged = True
            self.stats.count("hedged")
            self._attempt(p, nxt, "hedge")
