"""Device-memory governor: one ledger, a pressure-driven degradation
ladder, and reclaim-and-retry OOM routing.

Port of ``lir_tpu/engine/hbm.py``. Three pieces:

- **Ledger.** Every device-memory consumer registers projected bytes
  under a stable name (``register``/``update``/``unregister``): engine
  params (``params:<model>``), the KV page pool (``kv_pages:<model>``),
  the parked piggyback carry (``handoff:<model>``), spec-draft pins
  (``spec_draft:<model>``) and the fleet's weight-cache residency
  (``weights``). ``admit`` checks a projected allocation against the
  budget BEFORE the bytes exist (counters ``admits``/``denials``), and
  ledger / budget is the **pressure** gauge, published into
  :class:`~lir_tpu_torch.utils.profiling.MemStats`.
- **Degradation ladder.** Sustained pressure above
  ``GovernorConfig.engage_pressure`` walks one rung per
  ``sustain_ticks`` ticks (the engine ticks once a dispatch), in
  reclaim order: ``evict_weights`` (drop one idle LRU model from the
  fleet's weight cache), ``evict_pages`` (evict cold radix pages),
  ``no_piggyback`` (open no piggyback chain), ``no_spec`` (no
  speculative drafting: the sequential loop is bitwise the same),
  ``batch_down`` (halve the serving batch) and ``shed`` (refuse
  submits). Pressure sustained below ``engage - hysteresis`` releases
  the most recent rung, so a cleared squeeze restores every route. No
  rung changes a result.
- **OOM routing.** ``handle_oom(site)`` force-engages the reclaim rungs
  (weights, pages, piggyback) at once and returns True when anything
  was freed, telling the caller to retry the dispatch once; a second
  OOM is :class:`HbmExhausted` with the ledger's arithmetic.

**What the ledger counts.** Projected payload bytes, the sum each
consumer registers (a tensor's elements times its element size), never
the CUDA caching allocator's reserve: blocks the allocator keeps cached
after a free, its rounding and fragmentation, and the CUDA context are
not in it. The derived budget is ``torch.cuda.mem_get_info(dev)[1]``
(the card's total memory) times ``1 - hbm_reserve_frac``; the reserve
fraction stands for what the ledger does not count. The card's total is
not the JAX package's ``bytes_limit`` (the TPU runtime's usable limit,
already net of the runtime's own reservation), so the same fraction
leaves a different margin. On the CPU there is no derived budget: the
governor is unbounded and the ladder never engages, as in the JAX
package.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import GovernorConfig
from ..utils.logging import get_logger
from ..utils.profiling import MemStats

log = get_logger(__name__)

# Reclaim order: the ladder walks DOWN this list under pressure and back
# UP it when pressure clears. Indexes are the MemStats.rung gauge.
RUNGS: Tuple[str, ...] = ("evict_weights", "evict_pages", "no_piggyback",
                          "no_spec", "batch_down", "shed")
# Rungs that free bytes NOW: the set handle_oom force-engages.
RECLAIM_RUNGS: Tuple[str, ...] = ("evict_weights", "evict_pages",
                                  "no_piggyback")


class HbmExhausted(RuntimeError):
    """A dispatch OOMed even after the governor reclaimed everything
    reclaimable: the irreducible dispatch. Carries the ledger's
    arithmetic (:meth:`HbmGovernor.oom_message`)."""


def device_budget_bytes(reserve_frac: float = 0.08,
                        device=None) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``) minus the
    reserve, or None off the card (the CPU: host memory governs and the
    ladder never engages)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    _, total = torch.cuda.mem_get_info(dev)
    if not total:
        return None
    return int(total * (1.0 - reserve_frac))


class HbmGovernor:
    """One memory ledger + the pressure-driven degradation ladder.

    Host bookkeeping only: it holds no device buffer and never waits for
    the device. Thread-safe: the dispatch loop, the fleet's weight-cache
    listeners and the prefetch worker all touch it."""

    def __init__(self, config: Optional[GovernorConfig] = None,
                 stats: Optional[MemStats] = None,
                 budget_bytes: Optional[int] = None, device=None):
        self.cfg = config if config is not None else GovernorConfig()
        self.stats = stats if stats is not None else MemStats()
        if budget_bytes is None:
            budget_bytes = self.cfg.budget_bytes
            if budget_bytes is None and self.cfg.enabled:
                budget_bytes = device_budget_bytes(
                    self.cfg.hbm_reserve_frac, device)
        self._lock = threading.RLock()
        self._base_budget = budget_bytes       # guarded-by: _lock
        self._adopted_base = False             # guarded-by: _lock
        self._squeeze_frac = 1.0               # guarded-by: _lock
        self._squeeze_left = 0                 # guarded-by: _lock
        self._entries: Dict[str, int] = {}     # guarded-by: _lock
        self._level = 0                        # guarded-by: _lock
        self._over_ticks = 0                   # guarded-by: _lock
        self._under_ticks = 0                  # guarded-by: _lock
        # rung name -> (engage_fn() -> freed anything, release_fn)
        self._actions: Dict[str, Tuple[Optional[Callable[[], bool]],
                                       Optional[Callable[[], None]]]] \
            = {}                               # guarded-by: _lock
        self._publish_locked()

    # -- the ledger ----------------------------------------------------------

    def register(self, name: str, nbytes: int) -> None:
        """Make one consumer's projected bytes visible to the ledger
        (re-registering replaces)."""
        with self._lock:
            self._entries[str(name)] = max(int(nbytes), 0)
            self._publish_locked()

    update = register

    def unregister(self, name: str) -> None:
        with self._lock:
            self._entries.pop(str(name), None)
            self._publish_locked()

    def ledger(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._entries)

    @property
    def ledger_bytes(self) -> int:
        with self._lock:
            return sum(self._entries.values())

    @property
    def budget_bytes(self) -> Optional[int]:
        """The current governed budget (squeeze applied), or None when
        unbounded."""
        with self._lock:
            return self._budget_locked()

    def _budget_locked(self) -> Optional[int]:  # guarded-by: _lock
        if self._base_budget is None:
            return None
        return int(self._base_budget * self._squeeze_frac)

    def headroom(self) -> Optional[int]:
        """Budget minus ledger (None when unbounded; floor 0)."""
        with self._lock:
            budget = self._budget_locked()
            if budget is None:
                return None
            return max(budget - sum(self._entries.values()), 0)

    def pressure(self) -> float:
        """ledger / budget (0.0 when unbounded)."""
        with self._lock:
            budget = self._budget_locked()
            if not budget:
                return 0.0
            return sum(self._entries.values()) / budget

    def admit(self, name: str, nbytes: int) -> bool:
        """Would ``nbytes`` for ``name`` (replacing its entry) fit the
        budget? Counts ``admits``/``denials``; advisory: the caller
        decides what a denial means."""
        with self._lock:
            budget = self._budget_locked()
            if budget is None:
                self.stats.count("admits")
                return True
            projected = (sum(self._entries.values())
                         - self._entries.get(str(name), 0) + int(nbytes))
            if projected <= budget:
                self.stats.count("admits")
                return True
            self.stats.count("denials")
            return False

    def _publish_locked(self) -> None:  # guarded-by: _lock
        total = sum(self._entries.values())
        budget = self._budget_locked()
        self.stats.gauge("ledger_bytes", int(total))
        self.stats.gauge("budget_bytes", int(budget or 0))
        self.stats.gauge("pressure",
                         float(total / budget) if budget else 0.0)
        self.stats.gauge("rung", int(self._level))

    # -- rung actions --------------------------------------------------------

    def set_action(self, rung: str,
                   engage: Optional[Callable[[], bool]] = None,
                   release: Optional[Callable[[], None]] = None) -> None:
        """Attach reclaim callbacks to a rung (fleet: evict one idle LRU
        model; engine: evict cold radix pages). Flag rungs need none:
        consumers poll :meth:`allows` / :meth:`batch_cap` /
        :meth:`should_shed`. ``engage`` returns True when it freed
        something (handle_oom's retry decision)."""
        assert rung in RUNGS, f"unknown governor rung {rung!r}"
        with self._lock:
            self._actions[rung] = (engage, release)

    def allows(self, feature: str) -> bool:
        """False while the named flag rung is engaged. ``feature`` is
        "piggyback" or "spec"."""
        rung = {"piggyback": "no_piggyback", "spec": "no_spec"}[feature]
        with self._lock:
            return self._level <= RUNGS.index(rung)

    def batch_cap(self, full: int) -> int:
        """The serving batch's row cap: halved while batch_down is
        engaged."""
        with self._lock:
            engaged = self._level > RUNGS.index("batch_down")
        return max(full // 2, 1) if engaged else full

    def should_shed(self) -> bool:
        """True while the last rung (backpressure) is engaged."""
        with self._lock:
            engaged = self._level > RUNGS.index("shed")
        if engaged:
            self.stats.count("sheds")
        return engaged

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def engaged_rungs(self) -> List[str]:
        with self._lock:
            return list(RUNGS[: self._level])

    # -- the ladder ----------------------------------------------------------

    def _engage_locked(self, reason: str) -> bool:  # guarded-by: _lock
        """Walk one rung down; True when the rung's action freed bytes
        (a flag rung engages without freeing anything)."""
        if self._level >= len(RUNGS):
            return False
        rung = RUNGS[self._level]
        self._level += 1
        self.stats.site("rung_downs", rung)
        engage, _ = self._actions.get(rung, (None, None))
        freed = False
        if engage is not None:
            try:
                freed = bool(engage())
            except Exception:  # noqa: BLE001 — a broken reclaim hook
                # must not take the dispatch path down with it
                log.exception("governor rung %s engage action failed",
                              rung)
        log.warning("hbm governor: engaged rung %s (%s; pressure %.2f, "
                    "level %d/%d)", rung, reason, self.pressure(),
                    self._level, len(RUNGS))
        self._publish_locked()
        return freed

    def _release_locked(self) -> None:  # guarded-by: _lock
        if self._level <= 0:
            return
        self._level -= 1
        rung = RUNGS[self._level]
        self.stats.site("rung_ups", rung)
        _, release = self._actions.get(rung, (None, None))
        if release is not None:
            try:
                release()
            except Exception:  # noqa: BLE001
                log.exception("governor rung %s release action failed",
                              rung)
        log.info("hbm governor: released rung %s (pressure %.2f, level "
                 "%d/%d)", rung, self.pressure(), self._level, len(RUNGS))
        self._publish_locked()

    def tick(self) -> None:
        """One dispatch boundary: re-read pressure, walk the ladder.
        ``sustain_ticks`` consecutive ticks at or above
        ``engage_pressure`` engage one rung; as many at or below
        ``engage - hysteresis`` release one; the band between is quiet.
        An active squeeze counts down here and restores the budget when
        it expires."""
        if not self.cfg.enabled:
            return
        with self._lock:
            if self._squeeze_left > 0:
                self._squeeze_left -= 1
                if self._squeeze_left == 0:
                    self._squeeze_frac = 1.0
                    if self._adopted_base:
                        # The base was adopted from the ledger for the
                        # squeeze (an unbounded governor): give the
                        # unboundedness back.
                        self._base_budget = None
                        self._adopted_base = False
                    log.info("hbm governor: squeeze expired — budget "
                             "restored")
            p = (0.0 if not self._budget_locked()
                 else sum(self._entries.values()) / self._budget_locked())
            sustain = max(int(self.cfg.sustain_ticks), 1)
            if p >= self.cfg.engage_pressure:
                self._over_ticks += 1
                self._under_ticks = 0
                if self._over_ticks >= sustain:
                    self._over_ticks = 0
                    self._engage_locked(f"pressure {p:.2f}")
            elif p <= self.cfg.engage_pressure - self.cfg.hysteresis:
                self._under_ticks += 1
                self._over_ticks = 0
                if self._under_ticks >= sustain and self._level > 0:
                    self._under_ticks = 0
                    self._release_locked()
            else:
                self._over_ticks = 0
                self._under_ticks = 0
            self._publish_locked()

    # -- OOM routing ---------------------------------------------------------

    def handle_oom(self, site: str) -> bool:
        """A device OOM reached the dispatch path: force-engage the
        reclaim rungs at once (no sustain wait) and report whether
        anything was freed, i.e. whether one retry is worth it. The
        rungs release through the ordinary hysteresis walk."""
        self.stats.site("oom_events", site)
        if not self.cfg.enabled:
            return False
        freed = False
        with self._lock:
            target = RUNGS.index(RECLAIM_RUNGS[-1]) + 1
            while self._level < target:
                freed = self._engage_locked(f"device OOM at {site}") \
                    or freed
        if freed:
            self.stats.count("oom_reclaims")
        else:
            self.stats.count("oom_exhausted")
        return freed

    def oom_message(self, site: str, err: BaseException) -> str:
        """The HbmExhausted arithmetic: who holds what against which
        budget."""
        with self._lock:
            entries = dict(self._entries)
            budget = self._budget_locked()
        held = ", ".join(f"{k}={v / 2**30:.2f} GiB"
                         for k, v in sorted(entries.items())) or "nothing"
        total = sum(entries.values())
        return (f"device OOM at {site} survived governor reclaim "
                f"(ledger {total / 2**30:.2f} GiB"
                f"{'' if budget is None else f' / budget {budget / 2**30:.2f} GiB'}; "
                f"holders: {held}; engaged rungs: "
                f"{','.join(self.engaged_rungs()) or 'none'}): {err!r}")

    # -- squeeze -------------------------------------------------------------

    def squeeze(self, frac: float, calls: int = 8) -> None:
        """Shrink the governed budget to ``frac`` of its base for the
        next ``calls`` ticks, then restore it, so the walk down and back
        up is one proof. A governor with no base budget adopts the
        current ledger total as one (squeezing 'unbounded' still
        bites)."""
        with self._lock:
            if self._base_budget is None:
                self._base_budget = max(sum(self._entries.values()), 1)
                self._adopted_base = True
            self._squeeze_frac = max(float(frac), 0.01)
            self._squeeze_left = max(int(calls), 1)
            self.stats.count("squeezes")
            self._publish_locked()
        log.warning("hbm governor: budget squeezed to %.0f%% for %d "
                    "ticks (pressure now %.2f)", frac * 100, calls,
                    self.pressure())

    def summary(self) -> Dict[str, object]:
        out = self.stats.summary()
        out["ledger"] = {k: int(v) for k, v in self.ledger().items()}
        out["engaged"] = self.engaged_rungs()
        return out


def validate_fleet_budget(model_id: str, nbytes: int,
                          budget_bytes: Optional[int],
                          governor: Optional[HbmGovernor] = None) -> None:
    """Fleet budget validation: a weight-cache budget smaller than one
    configured model can never hold it. Fail at once with the
    arithmetic (the model's bytes, what else the ledger holds, the
    headroom left)."""
    if budget_bytes is None or nbytes <= budget_bytes:
        if governor is not None:
            governor.admit(f"weights:{model_id}", nbytes)
        return
    held = ""
    headroom = budget_bytes - nbytes
    if governor is not None:
        governor.stats.count("denials")
        entries = {k: v for k, v in governor.ledger().items()
                   if not k.startswith("weights")}
        if entries:
            held = ("; other device-memory holders: "
                    + ", ".join(f"{k}={v / 2**30:.2f} GiB"
                                for k, v in sorted(entries.items())))
            headroom -= sum(entries.values())
    raise ValueError(
        f"weight-cache budget {budget_bytes / 2**30:.2f} GiB cannot hold "
        f"model {model_id!r} ({nbytes / 2**30:.2f} GiB) even empty — "
        f"headroom after the model would be {headroom / 2**30:.2f} GiB"
        f"{held}. Raise --weight-cache-gb above the largest configured "
        f"model or drop the model from the fleet.")
