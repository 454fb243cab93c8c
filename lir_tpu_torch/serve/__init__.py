"""Online serving (port of ``lir_tpu/serve`` less the memory tiers,
which wait for ROADMAP A8d):

- queue.RequestQueue: bounded admission with per-class deadlines and
  deadline-aware shedding;
- cache.ResultCache: content-addressed dedup of repeated probes;
- batcher.ContinuousBatcher: bucket snapping, slot refill and
  price-model dispatch selection over the engine's ladder (rows halved
  under the governor's batch_down rung); batcher.FleetBatcher: per-model
  queues over a ModelFleet, resident first, the next model prefetched;
- server.ScoringServer: the supervisor loop under the dispatch
  watchdog, retry, degradation ladder and circuit breaker, with
  partial results on deadline expiry, the governor's shed rung and a
  SIGTERM checkpoint;
- server.FleetScoringServer: the ``fleet_score`` request class, one
  question across every fleet model with per-model P(yes)/P(no), kappa
  and disagreement (``aggregate_fleet``, ``fleet_decision``);
- router.ReplicaRouter: N replica servers behind one front with
  queue-depth, breaker, weight-residency, page-residency, SLO and
  pressure placement, exactly-once failover of a dead replica's
  requests and deadline-whisker hedging;
- migrate (with the router's roles): disaggregated prefill and decode,
  KV pages exported from one replica's pool and imported into another's
  (chunked, checksummed, rolled back on failure) on the replicas'
  supervisor threads (``ScoringServer.submit_page_op`` /
  ``submit_prefill``).

Surface: ``python -m lir_tpu_torch serve`` (JSONL over stdin or
``--requests``; ``--replicas N [--migrate-prefill-replicas K]``;
``--fleet-models a,b``).
"""

from .batcher import ContinuousBatcher, FleetBatcher
from .cache import ResultCache, content_key, engine_key
from .migrate import (MigrationError, PageExport, PageMigrator,
                      export_prefix, import_prefix)
from .queue import (STATUS_ERROR, STATUS_EXPIRED, STATUS_OK, STATUS_SHED,
                    RequestQueue, ServeFuture, ServeRequest, ServeResult)
from .router import ReplicaRouter
from .server import (FleetScoreFuture, FleetScoringServer, ScoringServer,
                     aggregate_fleet, fleet_decision)

__all__ = [
    "ContinuousBatcher", "FleetBatcher", "ResultCache", "content_key",
    "engine_key", "RequestQueue", "ServeFuture", "ServeRequest",
    "ServeResult", "ScoringServer", "FleetScoringServer",
    "FleetScoreFuture", "ReplicaRouter", "aggregate_fleet",
    "fleet_decision", "MigrationError", "PageExport", "PageMigrator",
    "export_prefix", "import_prefix",
    "STATUS_OK", "STATUS_EXPIRED", "STATUS_SHED", "STATUS_ERROR",
]
