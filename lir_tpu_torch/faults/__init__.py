"""Fault injection and the recovery primitives it proves out (port of
``lir_tpu/faults``):

- plan.FaultPlan: seeded per-site schedules wrapping the engine's
  dispatches (``wrap_engine``), the serve batcher (``wrap_server``), a
  router replica's dispatches (``wrap_replica``: replica kill and lag),
  the speculative drafter (``corrupt_draft``), the device-memory
  governor (``wrap_governor``) and the router's page migrator
  (``wrap_migrator``: stall and corrupt transfers);
- breaker.CircuitBreaker: the serve health flag as a closed / open /
  half-open breaker (serve/server.py);
- ladder.degrade_dispatch: bisect a failing batch to isolate poison rows
  (serve/server.py).

The sweep's own recovery (retry, reset, OOM reclaim) is
``engine/sweep._dispatch_with_recovery``; counters land in
``profiling.FaultStats`` and ``profiling.GuardStats``.
"""

from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .ladder import degrade_dispatch
from .plan import (KINDS, SITES, FaultPlan, InjectedFault,
                   InjectedPreemption, InjectedReplicaKill, SiteSchedule,
                   corrupt_export_chunks, corrupt_result_nan,
                   tear_jsonl_tail, wrap_engine, wrap_governor,
                   wrap_migrator, wrap_replica, wrap_server)

__all__ = [
    "FaultPlan", "SiteSchedule", "InjectedFault", "InjectedPreemption",
    "InjectedReplicaKill", "SITES", "KINDS", "wrap_engine", "wrap_server",
    "wrap_replica", "wrap_governor", "wrap_migrator",
    "corrupt_export_chunks", "tear_jsonl_tail", "corrupt_result_nan",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "degrade_dispatch",
]
