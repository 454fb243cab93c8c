"""Online serving over one engine (port of ``lir_tpu/serve``'s
single-model part; the fleet server, router, page migration and memory
tiers wait for ROADMAP A8b):

- queue.RequestQueue: bounded admission with per-class deadlines and
  deadline-aware shedding;
- cache.ResultCache: content-addressed dedup of repeated probes;
- batcher.ContinuousBatcher: bucket snapping, slot refill and
  price-model dispatch selection over the engine's ladder;
- server.ScoringServer: the supervisor loop under the dispatch
  watchdog, retry, degradation ladder and circuit breaker, with
  partial results on deadline expiry and a SIGTERM checkpoint.

Surface: ``python -m lir_tpu_torch serve`` (JSONL over stdin or
``--requests``).
"""

from .batcher import ContinuousBatcher
from .cache import ResultCache, content_key, engine_key
from .queue import (STATUS_ERROR, STATUS_EXPIRED, STATUS_OK, STATUS_SHED,
                    RequestQueue, ServeFuture, ServeRequest, ServeResult)
from .server import ScoringServer

__all__ = [
    "ContinuousBatcher", "ResultCache", "content_key", "engine_key",
    "RequestQueue", "ServeFuture", "ServeRequest", "ServeResult",
    "ScoringServer",
    "STATUS_OK", "STATUS_EXPIRED", "STATUS_SHED", "STATUS_ERROR",
]
