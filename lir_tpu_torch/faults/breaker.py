"""Circuit breaker: the serve health flag as a state machine with a way
back to healthy. Port of ``lir_tpu/faults/breaker.py``.

- CLOSED: normal operation. Failures increment a consecutive counter;
  reaching ``failure_threshold`` opens the breaker (the server drains
  its queued work with error results).
- OPEN: every submit sheds at once. After ``cooldown_s`` the next state
  read promotes to HALF_OPEN (lazily: no timer thread).
- HALF_OPEN: traffic is admitted again; the first dispatch is the
  probe. Success closes the breaker, failure re-opens it for another
  cooldown.

Every transition is recorded into ``profiling.FaultStats``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils.profiling import FaultStats

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker over a MONOTONIC clock
    (``time.monotonic`` by default; a test injects its own). A wall
    clock would let a clock step stretch or cut the cooldown."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 stats: Optional[FaultStats] = None):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.stats = stats if stats is not None else FaultStats()
        self._state = CLOSED                      # guarded-by: _lock
        self._consecutive = 0                     # guarded-by: _lock
        self._opened_at: Optional[float] = None   # guarded-by: _lock
        self._lock = threading.Lock()

    def _transition(self, to: str) -> None:  # guarded-by: _lock
        frm, self._state = self._state, to
        self.stats.transition(frm, to)

    def _promote_locked(self) -> None:  # guarded-by: _lock
        """OPEN -> HALF_OPEN once the cooldown has elapsed."""
        if (self._state == OPEN and self._opened_at is not None
                and self.clock() - self._opened_at >= self.cooldown_s):
            self._transition(HALF_OPEN)

    @property
    def state(self) -> str:
        with self._lock:
            self._promote_locked()
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def allow(self) -> bool:
        """May traffic flow? True in CLOSED and HALF_OPEN (a half-open
        admission becomes the probe dispatch)."""
        return self.state != OPEN

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._transition(CLOSED)

    def trip(self) -> bool:
        """Open now, whatever the count: the engine may not be
        dispatched on (an abandoned dispatch still holds it). True when
        this opened the breaker; the cooldown starts now."""
        with self._lock:
            self._promote_locked()
            self._opened_at = self.clock()
            if self._state == OPEN:
                return False
            self._transition(OPEN)
            return True

    def record_failure(self) -> bool:
        """One dispatch failure (retries already spent). True when the
        breaker OPENED on this failure: the caller then drains queued
        work with error results."""
        with self._lock:
            self._promote_locked()
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._opened_at = self.clock()
                self._transition(OPEN)
                return True
            if (self._state == CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._opened_at = self.clock()
                self._transition(OPEN)
                return True
        return False
