"""Deterministic, seeded fault injection at the engine and serve
boundaries. Port of ``lir_tpu/faults/plan.py``.

A :class:`FaultPlan` holds per-SITE failure schedules (explicit call
indices and an optional seeded Bernoulli rate) that raise
:class:`InjectedFault` (a transient device error's stand-in) or
:class:`InjectedPreemption` (a kill) at exactly the same calls on every
run with the same seed. Sites are plain strings; ``SITES`` and
``KINDS`` keep the JAX package's tuples.

Kinds and where the port wires them:

- ``fault`` / ``preempt``: raise before the call (any site;
  :meth:`FaultPlan.check`, :meth:`FaultPlan.wrap`);
- ``hang``: sleep ``hang_s`` BEFORE the real call, then raise on
  release: a stall the dispatch watchdog must abandon. The sleep ends
  early when the watchdog abandons the call (its worker holds the
  engine's dispatch lock, which the retry waits for); the engine is
  never touched either way (a real device-side hang is another matter:
  guard/watchdog.py);
- ``nan``: run the call, then NaN-corrupt its result rows ``nan_rows``
  (:func:`corrupt_result_nan`: the engine's ``FusedDecodeOut`` tensors,
  or serve payload dicts) for the numerics guard to quarantine;
- ``draft_corrupt``: overwrite speculative drafts
  (:meth:`FaultPlan.corrupt_draft`, called by ``engine/spec.build_plan``
  through the engine's ``spec_fault_plan``);
- ``hbm_squeeze``: shrink the device-memory governor's budget
  (:func:`wrap_governor` over ``HbmGovernor.tick``).

- ``replica_kill``: through :func:`wrap_replica`, the router marks
  the replica dead (``kill_replica``: breaker tripped, in-flight
  requests re-admitted), then the dispatch raises
  :class:`InjectedReplicaKill`; elsewhere it raises that error;
- ``replica_lag``: sleep ``lag_s``, then run the call to completion (a
  straggler whose late payload must lose the hedge race).

- ``migration_stall``: through :func:`wrap_migrator` at the router
  migrator's wire hop (site ``migrate``), sleep ``hang_s`` (past the
  chain's ``timeout_s``), then raise: the router falls back to a local
  re-prefill;
- ``migration_corrupt``: through :func:`wrap_migrator`, flip bytes of
  the export's first chunk in place under its checksums
  (:func:`corrupt_export_chunks`): the import's verify refuses it.

The tier kinds and site (``tier_corrupt``, ``disk_stall``; site
``tiers``) wait for the memory tiers (ROADMAP A8d): a plan given one
raises at construction rather than ignore it.

``InjectedPreemption`` subclasses BaseException on purpose: a real kill
does not flow through ``except Exception`` recovery, so neither may its
simulation.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..guard import watchdog
from ..utils.profiling import FaultStats

SITES = ("dispatch", "compile", "tokenize", "manifest_write",
         "checkpoint_write", "preempt", "replica", "hbm", "migrate",
         "tiers")

KINDS = ("fault", "preempt", "hang", "nan", "replica_kill",
         "replica_lag", "hbm_squeeze", "migration_stall",
         "migration_corrupt", "tier_corrupt", "disk_stall")

# What waits for the memory tiers (ROADMAP A8d).
_A8D_KINDS = ("tier_corrupt", "disk_stall")
_A8D_SITES = ("tiers",)
# Kinds that act on a result or a side channel, never before the call.
_PASSIVE_KINDS = ("nan", "draft_corrupt", "hbm_squeeze")
# Kinds only the migrator's hop injects: a no-op at :meth:`FaultPlan.check`.
_MIGRATION_KINDS = ("migration_stall", "migration_corrupt")


class InjectedFault(RuntimeError):
    """A scheduled transient failure (device error stand-in)."""


class InjectedReplicaKill(InjectedFault):
    """A scheduled replica death: the replica's dispatch dies and the
    router marks the replica dead, as an abrupt host loss looks from the
    front. An ordinary Exception: the router is the recovery under test
    and must survive the death."""

    def __init__(self, msg: str, replica_id: str = ""):
        super().__init__(msg)
        self.replica_id = replica_id


class InjectedPreemption(BaseException):
    """A scheduled kill. BaseException so recovery code catching
    Exception cannot 'survive' it."""


@dataclasses.dataclass(frozen=True)
class SiteSchedule:
    """When one site fails.

    - ``fail_calls``: explicit 0-based call indices that fail;
    - ``rate``: also a seeded Bernoulli failure probability per call;
    - ``max_failures``: a bound on injections at this site (a rate then
      models a transient outage);
    - ``kind``: see the module docstring; ``hang_s`` is the hang's
      sleep, ``nan_rows`` the rows a ``nan`` or ``draft_corrupt``
      corrupts, ``squeeze_frac`` / ``squeeze_calls`` the squeeze,
      ``replica_id`` the replica a ``replica_kill`` names and ``lag_s``
      a ``replica_lag``'s sleep.
    """

    fail_calls: Tuple[int, ...] = ()
    rate: float = 0.0
    max_failures: Optional[int] = None
    kind: str = "fault"
    hang_s: float = 30.0
    nan_rows: Tuple[int, ...] = (0,)
    replica_id: str = ""
    lag_s: float = 1.0
    squeeze_frac: float = 0.5
    squeeze_calls: int = 8

    @classmethod
    def outage(cls, start: int, length: int) -> "SiteSchedule":
        """Every call in [start, start+length) fails."""
        return cls(fail_calls=tuple(range(start, start + length)))

    @classmethod
    def kill_at(cls, call: int) -> "SiteSchedule":
        """A simulated preemption at one call index."""
        return cls(fail_calls=(call,), kind="preempt")

    @classmethod
    def hang_at(cls, call: int, seconds: float = 30.0) -> "SiteSchedule":
        """A simulated stall at one call index: sleep ``seconds`` before
        the real call, then raise. Pick ``seconds`` past the deadline
        under test."""
        return cls(fail_calls=(call,), kind="hang", hang_s=seconds)

    @classmethod
    def nan_at(cls, call: int,
               rows: Tuple[int, ...] = (0,)) -> "SiteSchedule":
        """NaN into the named result rows' measurement fields at one
        call index (a silent-data-corruption stand-in)."""
        return cls(fail_calls=(call,), kind="nan", nan_rows=rows)

    @classmethod
    def draft_corrupt_at(cls, call: int,
                         rows: Tuple[int, ...] = (0,)) -> "SiteSchedule":
        """Corrupt the named rows' speculative drafts at one
        ``corrupt_draft`` call index (site "draft" by convention)."""
        return cls(fail_calls=(call,), kind="draft_corrupt", nan_rows=rows)

    @classmethod
    def hbm_squeeze_at(cls, call: int, frac: float = 0.5,
                       calls: int = 8) -> "SiteSchedule":
        """Shrink the governor's budget to ``frac`` of its base at
        governor tick ``call`` for the next ``calls`` ticks (site "hbm";
        :func:`wrap_governor`)."""
        return cls(fail_calls=(call,), kind="hbm_squeeze",
                   squeeze_frac=frac, squeeze_calls=calls)

    @classmethod
    def migration_stall_at(cls, call: int,
                           seconds: float = 30.0) -> "SiteSchedule":
        """Stall one page-migration transfer (site "migrate";
        :func:`wrap_migrator`): the wire hop sleeps ``seconds`` (pick it
        past ``MigrationConfig.timeout_s``), then raises. The router must
        abandon the chain and re-prefill locally."""
        return cls(fail_calls=(call,), kind="migration_stall",
                   hang_s=seconds)

    @classmethod
    def migration_corrupt_at(cls, call: int) -> "SiteSchedule":
        """Corrupt one page-migration transfer in flight (site "migrate";
        :func:`wrap_migrator`): chunk bytes flipped under the export's
        checksums, so the import refuses every page and rolls back."""
        return cls(fail_calls=(call,), kind="migration_corrupt")

    @classmethod
    def replica_kill_at(cls, call: int,
                        replica_id: str = "") -> "SiteSchedule":
        """A replica's death at one call index (through
        :func:`wrap_replica` the router observes it and re-admits the
        in-flight work)."""
        return cls(fail_calls=(call,), kind="replica_kill",
                   replica_id=replica_id)

    @classmethod
    def replica_lag_at(cls, call: int, seconds: float,
                       replica_id: str = "") -> "SiteSchedule":
        """A straggler: the dispatch at ``call`` sleeps ``seconds``, then
        completes (the hedge should win; the late payload is dropped)."""
        return cls(fail_calls=(call,), kind="replica_lag", lag_s=seconds,
                   replica_id=replica_id)


class FaultPlan:
    """Seeded per-site failure schedules and the counters they feed.
    Thread-safe: call counters and per-site generators sit behind one
    lock, so concurrent sites see one deterministic schedule."""

    def __init__(self, seed: int = 0,
                 schedules: Optional[Dict[str, SiteSchedule]] = None,
                 stats: Optional[FaultStats] = None):
        self.seed = int(seed)
        self.schedules: Dict[str, SiteSchedule] = dict(schedules or {})
        for site, sched in self.schedules.items():
            if site in _A8D_SITES or sched.kind in _A8D_KINDS:
                raise ValueError(
                    f"fault schedule {site}:{sched.kind} needs the memory "
                    f"tiers, which the port does not have yet (ROADMAP "
                    f"A8d)")
        self.stats = stats if stats is not None else FaultStats()
        self._calls: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._lock = threading.Lock()

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def injected(self, site: str) -> int:
        with self._lock:
            return self._injected.get(site, 0)

    def _decide(self, site: str) -> Optional[SiteSchedule]:
        """Advance the site's call counter; return its schedule when THIS
        call should fail."""
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            sched = self.schedules.get(site)
            if sched is None:
                return None
            done = self._injected.get(site, 0)
            if sched.max_failures is not None and done >= sched.max_failures:
                return None
            fail = idx in sched.fail_calls
            if not fail and sched.rate > 0.0:
                rng = self._rngs.get(site)
                if rng is None:
                    # Site-keyed stream: adding a site never perturbs
                    # another site's draws.
                    rng = random.Random(f"{self.seed}:{site}")
                    self._rngs[site] = rng
                fail = rng.random() < sched.rate
            if not fail:
                return None
            self._injected[site] = done + 1
        return sched

    def _fire(self, sched: SiteSchedule, site: str) -> None:
        """Raise the scheduled raise-style failure (fault, preempt,
        hang)."""
        idx = self.calls(site) - 1
        if sched.kind == "preempt":
            self.stats.inject(site, preemption=True)
            raise InjectedPreemption(
                f"injected preemption at {site} call {idx}")
        self.stats.inject(site)
        if sched.kind == "hang":
            abandoned = watchdog.abandoned_event()
            if abandoned is None:
                time.sleep(sched.hang_s)
            else:
                abandoned.wait(sched.hang_s)
            raise InjectedFault(
                f"injected hang at {site} call {idx} released (at most "
                f"{sched.hang_s:.2f}s)")
        if sched.kind == "replica_kill":
            raise InjectedReplicaKill(
                f"injected replica kill at {site} call {idx}"
                + (f" (replica {sched.replica_id})"
                   if sched.replica_id else ""),
                replica_id=sched.replica_id)
        raise InjectedFault(f"injected fault at {site} call {idx}")

    def check(self, site: str) -> None:
        """The injection point: raise when the schedule says this call
        fails, else return. A result or side-channel kind (nan,
        draft_corrupt, hbm_squeeze) and a migration kind are no-ops
        here; ``replica_lag`` sleeps in place, then returns."""
        sched = self._decide(site)
        if sched is None or sched.kind in _PASSIVE_KINDS + _MIGRATION_KINDS:
            return
        if sched.kind == "replica_lag":
            self.stats.inject(site)
            time.sleep(sched.lag_s)
            return
        self._fire(sched, site)

    def corrupt_draft(self, drafts, vocab_size: int,
                      site: str = "draft") -> int:
        """The speculative-decode injection point (engine/spec.
        build_plan): when the ``site`` schedule fires with kind
        "draft_corrupt", overwrite the scheduled rows' draft tokens
        (``drafts``: a list of (tokens (B, T), lens (B,)) host arrays,
        changed in place) with seeded IN-VOCAB garbage; a row without a
        draft gains a short forced one, so the injection reaches the
        verifier. Returns the tokens corrupted."""
        sched = self._decide(site)
        if sched is None or sched.kind != "draft_corrupt":
            return 0
        self.stats.inject(site)
        idx = self.calls(site) - 1
        rng = random.Random(f"{self.seed}:{site}:{idx}")
        corrupted = 0
        for toks, lens in drafts:
            budget = toks.shape[1]
            for r in sched.nan_rows:
                if r >= toks.shape[0]:
                    continue
                if lens[r] == 0:
                    lens[r] = min(2, budget)
                for t in range(int(lens[r])):
                    toks[r, t] = (int(toks[r, t]) + 1
                                  + rng.randrange(max(vocab_size - 1, 1))
                                  ) % vocab_size
                    corrupted += 1
        return corrupted

    def wrap(self, site: str, fn: Callable) -> Callable:
        """``fn`` under the site's schedule (indexed by the site's call
        count, not by wrapper): raise-style kinds fire BEFORE the call;
        "nan" runs the call and corrupts its result rows; "replica_lag"
        sleeps, then runs the call to completion."""

        def wrapped(*args, **kwargs):
            sched = self._decide(site)
            if sched is not None:
                if sched.kind == "nan":
                    self.stats.inject(site)
                    return corrupt_result_nan(fn(*args, **kwargs),
                                              sched.nan_rows)
                if sched.kind == "replica_lag":
                    self.stats.inject(site)
                    time.sleep(sched.lag_s)
                    return fn(*args, **kwargs)
                if sched.kind not in _PASSIVE_KINDS:
                    self._fire(sched, site)
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn  # type: ignore[attr-defined]
        return wrapped


def wrap_engine(engine, plan: FaultPlan):
    """The plan's ``dispatch`` site in front of the engine's shared and
    grouped dispatches (the sweep's device boundary), and the plan handed
    to the speculative drafter (site ``draft``). Instance attributes
    only: the class and other engines stay clean. A wrapped
    ``decode_fused_shared`` turns piggyback chains off
    (``ScoringEngine.piggyback_supported``), as in the JAX engine."""
    engine.decode_fused_shared = plan.wrap("dispatch",
                                           engine.decode_fused_shared)
    engine.decode_fused_grouped = plan.wrap("dispatch",
                                            engine.decode_fused_grouped)
    engine.spec_fault_plan = plan
    return engine


def wrap_server(server, plan: FaultPlan):
    """The plan's ``dispatch`` site in front of the batcher's score call
    (the serve device boundary, under the supervisor's retry, watchdog,
    ladder and breaker)."""
    server.batcher.score = plan.wrap("dispatch", server.batcher.score)
    return server


def wrap_replica(router, replica_id: str, plan: FaultPlan,
                 site: str = "replica"):
    """The plan's ``site`` schedule in front of ONE router replica's
    dispatch boundary (its batcher's score call, under the replica
    server's retry and watchdog):

    - ``replica_kill``: the router observes the death first
      (``kill_replica``: breaker tripped, in-flight requests
      re-admitted), then the dispatch raises InjectedReplicaKill, the
      order an abrupt host loss presents;
    - ``replica_lag``: the dispatch sleeps ``lag_s``, then completes;
    - ``nan`` corrupts the result rows; other kinds fire as in
      :meth:`FaultPlan.wrap`."""
    handle = router.handle(replica_id)
    inner = handle.server.batcher.score

    def wrapped(*args, **kwargs):
        sched = plan._decide(site)
        if sched is not None:
            if sched.kind == "replica_kill":
                plan.stats.inject(site)
                router.kill_replica(replica_id)
                raise InjectedReplicaKill(
                    f"injected replica kill on {replica_id}",
                    replica_id=replica_id)
            if sched.kind == "replica_lag":
                plan.stats.inject(site)
                time.sleep(sched.lag_s)
                return inner(*args, **kwargs)
            if sched.kind == "nan":
                plan.stats.inject(site)
                return corrupt_result_nan(inner(*args, **kwargs),
                                          sched.nan_rows)
            if sched.kind not in _PASSIVE_KINDS:
                plan._fire(sched, site)
        return inner(*args, **kwargs)

    wrapped.__wrapped__ = inner  # type: ignore[attr-defined]
    handle.server.batcher.score = wrapped
    return router


def wrap_migrator(migrator, plan: FaultPlan, site: str = "migrate"):
    """The plan's ``site`` schedule at a router migrator's wire hop
    (``serve/migrate.PageMigrator.transfer``, between page export and
    page import), which runs on the source replica's supervisor thread:

    - ``migration_stall``: sleep ``hang_s`` (holding that thread, as in
      the JAX package), then raise: the router's chain deadline or the
      raise ends in a local re-prefill;
    - ``migration_corrupt``: flip the export's chunk bytes in place
      under its checksums (seeded by the plan's seed, the site and the
      call index); the import's verify must refuse them.

    Other raise-style kinds fire before the hop (a transport error)."""
    inner = migrator.transfer

    def wrapped(export):
        sched = plan._decide(site)
        if sched is not None:
            if sched.kind == "migration_stall":
                plan.stats.inject(site)
                idx = plan.calls(site) - 1
                time.sleep(sched.hang_s)
                raise InjectedFault(
                    f"injected migration stall at {site} call {idx} "
                    f"released after {sched.hang_s:.2f}s")
            if sched.kind == "migration_corrupt":
                plan.stats.inject(site)
                idx = plan.calls(site) - 1
                corrupt_export_chunks(export,
                                      seed=f"{plan.seed}:{site}:{idx}")
                return inner(export)
            if sched.kind not in _PASSIVE_KINDS:
                plan._fire(sched, site)
        return inner(export)

    wrapped.__wrapped__ = inner  # type: ignore[attr-defined]
    migrator.transfer = wrapped
    return migrator


def corrupt_export_chunks(export, seed: str = "0") -> int:
    """Flip bytes of a PageExport's FIRST host chunk without touching its
    checksums: the in-flight corruption the import's verify exists to
    catch. Each leaf (leaf order) gets min(8, its bytes) seeded offsets
    XOR 0xFF, in place: the offsets of the JAX package's under the same
    seed. Returns the bytes flipped."""
    from ..models.decoder import cache_leaves

    rng = random.Random(seed)
    flipped = 0
    for host, _n in export.chunks:
        for leaf in cache_leaves(host):
            flat = leaf.reshape(-1).view(torch.uint8).numpy()
            if flat.size == 0:
                continue
            for _ in range(min(8, flat.size)):
                j = rng.randrange(flat.size)
                flat[j] ^= 0xFF
                flipped += 1
        break            # one chunk is enough: any mismatch aborts
    return flipped


def wrap_governor(governor, plan: FaultPlan, site: str = "hbm"):
    """The plan's ``site`` schedule in front of a device-memory
    governor's tick (engine/hbm.HbmGovernor, one tick a dispatch). A
    firing ``hbm_squeeze`` shrinks the budget to ``squeeze_frac`` of its
    base for the next ``squeeze_calls`` ticks, then restores it. Other
    raise-style kinds fire before the tick."""
    inner = governor.tick

    def wrapped(*args, **kwargs):
        sched = plan._decide(site)
        if sched is not None:
            if sched.kind == "hbm_squeeze":
                plan.stats.inject(site)
                governor.squeeze(sched.squeeze_frac,
                                 calls=sched.squeeze_calls)
            elif sched.kind not in _PASSIVE_KINDS:
                plan._fire(sched, site)
        return inner(*args, **kwargs)

    wrapped.__wrapped__ = inner  # type: ignore[attr-defined]
    governor.tick = wrapped
    return governor


def corrupt_result_nan(result, rows: Tuple[int, ...]):
    """NaN-corrupt the measurement fields of ``rows`` in a dispatch
    result. Handles the engine's results (tuples of FusedDecodeOut: NaN
    into p_yes / p_no / topk_logprobs / weighted_confidence at the given
    batch rows, on new tensors: the call's own stay as they were) and
    serve payload lists (NaN into the row's measurement dict). Anything
    else passes through (the grouped dispatch's member count)."""
    if isinstance(result, tuple):
        return tuple(corrupt_result_nan(r, rows) for r in result)
    if isinstance(result, list):
        out = list(result)
        for r in rows:
            if 0 <= r < len(out) and isinstance(out[r], dict):
                p = dict(out[r])
                nan = float("nan")
                p["token_1_prob"] = nan
                p["token_2_prob"] = nan
                p["weighted_confidence"] = nan
                out[r] = p
        return out
    if dataclasses.is_dataclass(result) and hasattr(result, "p_yes"):
        fields = {}
        for name in ("p_yes", "p_no", "topk_logprobs",
                     "weighted_confidence"):
            t = getattr(result, name).clone()
            for r in rows:
                if 0 <= r < int(t.shape[0]):
                    t[r] = torch.nan
            fields[name] = t
        return dataclasses.replace(result, **fields)
    return result


def tear_jsonl_tail(path, fragment: str = '{"model": "m", "orig') -> None:
    """Append a torn (non-JSON, newline-free) fragment to a JSONL file:
    the on-disk state a kill mid-append leaves behind."""
    with open(path, "a") as f:
        f.write(fragment)
        f.flush()
