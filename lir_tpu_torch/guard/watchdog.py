"""Dispatch watchdog: stall detection for calls that never return.

Port of ``lir_tpu/guard/watchdog.py``. A dispatch that never returns
raises nothing, so ``except Exception`` recovery never runs.
:func:`watch_call` runs the call on a disposable worker thread and polls
it against a deadline from the caller's thread; on expiry it dumps every
live thread's stack, ABANDONS the worker and raises
:class:`DispatchStalled`, an ordinary ``RuntimeError``, so the recovery
machinery (the sweep's retry, the serve retry -> degradation ladder ->
breaker) treats a hang like a raised fault: one deadline lost, not the
run.

Deadlines come from :class:`DispatchWatchdog`, which prices each
dispatch through the scheduler's ``bucket_cost`` row-token model: the
first successful dispatches calibrate seconds per cost unit (EWMA
after), and the deadline is ``floor + multiple * predicted seconds``
(``RuntimeConfig.watchdog_floor_s`` / ``watchdog_multiple``). Until
calibrated the watchdog observes without enforcing.

What PyTorch adds to the JAX design:

- **Thread state.** The current CUDA device and stream and the
  inference/grad mode are per thread. The worker runs the call under the
  caller's, so a watched dispatch enqueues on the stream an unwatched
  one would (the fleet's weight streaming orders its copies against the
  caller's current stream).
- **Kernel builds.** The port compiles its CUDA kernels at first use
  (``ops/_build.py``, minutes of ``nvcc``). Build time is taken out of a
  dispatch's elapsed time (``_build.build_seconds``), and a dispatch
  that built anything does not calibrate: a build never trips a
  deadline and never sets one.
- **What is timed.** A deadline covers the device work, not only its
  enqueue. The serve batcher's watched call ends in its payloads' host
  copy. The sweep's watched call enqueues the dispatch and records an
  event on the dispatch's own stream; its writer thread, where the host
  waits for the rows anyway, waits for that event under the same
  deadline counted from the dispatch's start
  (:meth:`DispatchWatchdog.watch_device`), so the main thread plans and
  enqueues the next dispatch while the card runs this one. That wait
  calibrates the deadlines on start-to-finish seconds.

Abandoning is host-side only, and the engine's state is not. JAX's
arrays are immutable, so its abandoned worker may run on beside the
retry; the port's engine updates state in place (the parked piggyback
carry, the radix tree and page pool, the speculative counters) and takes
no lock of its own. So every watched call's worker holds the engine's
``DispatchWatchdog.dispatch_lock`` for the whole call, and a worker that
was abandoned before it got the lock never runs its call. Before the
recovery touches the engine (its state reset, a retry, the serve
ladder), :meth:`DispatchWatchdog.settle` waits for an abandoned call to
leave the engine for one grace (by default the stalled call's own
deadline); a call still inside after that makes the engine POISONED
(:class:`EnginePoisoned`): the sweep re-raises it and the server opens
its breaker, and nothing dispatches beside the abandoned call. The
injected hang (faults.SiteSchedule kind "hang") sleeps BEFORE the real
call and wakes when its call is abandoned (:func:`abandoned_event`), so
it raises at once and the retry runs at once. A kernel that really hangs
on the card keeps its stream: the retry queues behind it and never
finishes, so a device-side hang is not recoverable in process. A sticky
CUDA error (an illegal address) poisons the context: every retry fails,
the serve breaker opens, and nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback
from typing import Callable, Optional, Tuple

import torch

from ..ops import _build
from ..utils.logging import get_logger
from ..utils.profiling import GuardStats

log = get_logger(__name__)

DEFAULT_TICK_S = 0.05

# The watched worker's abandonment event (abandoned_event()).
_local = threading.local()


class DispatchStalled(RuntimeError):
    """A watched call outlived its watchdog deadline. Synthetic on
    purpose: a real hang raises nothing, so this stands in for the
    device error the recovery machinery (retry, ladder, breaker)
    expects."""


class EnginePoisoned(RuntimeError):
    """An abandoned dispatch still holds the engine after the
    watchdog's grace. Dispatching beside it would race the engine's
    in-place state, so the recovery stops here: the sweep re-raises
    this and the server opens its breaker."""


def abandoned_event() -> Optional[threading.Event]:
    """The event set when the current watched call is abandoned, or
    None outside a watched worker (the injected hang waits on it)."""
    return getattr(_local, "abandon", None)


def dump_thread_stacks() -> str:
    """Every live thread's current stack, formatted: the post-mortem a
    hung process otherwise never produces. Safe from any thread."""
    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    parts = []
    for ident, frame in frames.items():
        t = names.get(ident)
        label = (f"{t.name} (daemon={t.daemon})" if t is not None
                 else f"ident={ident}")
        parts.append(f"--- thread {label} ---\n"
                     + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)


def _caller_context() -> Tuple[bool, bool, Optional[torch.cuda.Stream]]:
    """The per-thread state a dispatch reads: inference mode, grad mode
    and (where CUDA is up) the current stream, whose device is the
    current device."""
    stream = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()
    return torch.is_inference_mode_enabled(), torch.is_grad_enabled(), stream


def _enter_context(stack: contextlib.ExitStack, ctx) -> None:
    inference, grad, stream = ctx
    if inference:
        stack.enter_context(torch.inference_mode())
    else:
        stack.enter_context(torch.set_grad_enabled(grad))
    if stream is not None:
        stack.enter_context(torch.cuda.device(stream.device))
        stack.enter_context(torch.cuda.stream(stream))


def watch_call(fn: Callable, deadline_s: Optional[float],
               label: str = "call",
               on_tick: Optional[Callable[[], None]] = None,
               tick_s: float = DEFAULT_TICK_S,
               stalled: Optional[Callable[[float, float], None]] = None,
               lock=None):
    """Run ``fn()`` on a disposable daemon thread under the caller's
    device, stream and inference mode, polling every ``tick_s`` seconds
    from the caller's thread.

    - the worker holds ``lock`` (the engine's dispatch lock) for the
      whole call; if it was abandoned before it got the lock, it raises
      DispatchStalled instead of running ``fn``;
    - the result or exception propagates to the caller (BaseException
      included: an injected preemption unwinds here as it would inline);
    - ``on_tick`` runs on the CALLER's thread at every poll (the serve
      supervisor resolves in-flight rows whose deadline passed);
    - ``deadline_s=None`` waits forever (ticks still fire);
    - the elapsed time leaves out kernel builds (``_build``);
    - on expiry: dump all thread stacks to the log, abandon the worker
      (its eventual result or error is dropped and logged at INFO), call
      ``stalled(deadline, elapsed)`` and raise :class:`DispatchStalled`.
    """
    done = threading.Event()
    abandon = threading.Event()
    box: dict = {}
    ctx = _caller_context()

    def _run():
        _local.abandon = abandon
        try:
            with contextlib.ExitStack() as stack:
                if lock is not None:
                    stack.enter_context(lock)
                    if abandon.is_set():
                        raise DispatchStalled(f"{label} was abandoned "
                                              f"before it reached the engine")
                _enter_context(stack, ctx)
                box["result"] = fn()
        except BaseException as err:  # noqa: BLE001 — re-raised by caller
            box["error"] = err
            if abandon.is_set():
                log.info("abandoned %s eventually raised: %r", label, err)
        finally:
            if abandon.is_set() and "error" not in box:
                log.info("abandoned %s eventually completed; result "
                         "dropped", label)
            done.set()

    worker = threading.Thread(target=_run, name=f"watched:{label}",
                              daemon=True)
    start = time.monotonic()
    built0 = _build.build_seconds()
    worker.start()
    while not done.wait(tick_s):
        if on_tick is not None:
            on_tick()
        if deadline_s is None:
            continue
        elapsed = (time.monotonic() - start
                   - (_build.build_seconds() - built0))
        if elapsed >= deadline_s:
            abandon.set()
            log.error(
                "watchdog: %s exceeded its %.2fs deadline — abandoning "
                "the dispatch and surfacing DispatchStalled into the "
                "recovery path. Thread stacks:\n%s",
                label, deadline_s, dump_thread_stacks())
            if stalled is not None:
                stalled(deadline_s, elapsed)
            raise DispatchStalled(
                f"{label} exceeded its {deadline_s:.2f}s watchdog "
                f"deadline (dispatch abandoned, thread stacks dumped)")
    if "error" in box:
        raise box["error"]
    return box["result"]


class DispatchWatchdog:
    """Deadline policy, calibration and counters of watched dispatches.

    ``multiple <= 0`` disables the watchdog (every watch() is a plain
    call). Deadlines: ``floor_s + multiple * predicted``, where
    ``predicted`` is the calibrated seconds per cost unit times the
    dispatch's ``bucket_cost`` (or, with no cost given, the EWMA of raw
    dispatch seconds). ``last_stall`` holds the (deadline, seconds to
    fire) of the latest expiry.

    ``dispatch_lock`` is the engine's: a watched call holds it while it
    runs. ``grace_s`` is how long :meth:`settle` waits for an abandoned
    call to leave the engine (None: the stalled call's deadline)."""

    def __init__(self, multiple: float = 20.0, floor_s: float = 30.0,
                 stats: Optional[GuardStats] = None,
                 tick_s: float = DEFAULT_TICK_S,
                 seed_headroom: Optional[float] = None,
                 grace_s: Optional[float] = None):
        self.multiple = float(multiple)
        self.floor_s = float(floor_s)
        self.stats = stats if stats is not None else GuardStats()
        self.tick_s = float(tick_s)
        self.grace_s = grace_s
        self.dispatch_lock = threading.RLock()
        # The first calibration sample is inflated by this ratio (the
        # scheduler's fused/unfused decode spread), so a deadline seeded
        # on fast dispatches never fires on a legitimate slow fallback.
        if seed_headroom is None:
            from ..engine import scheduler as _sched

            seed_headroom = _sched.watchdog_seed_headroom()
        self.seed_headroom = max(float(seed_headroom), 1.0)
        self.last_stall: Optional[Tuple[float, float]] = None
        # Calibration EWMAs, observed from every dispatching thread.
        self._rate: Optional[float] = None   # guarded-by: _lock
        self._flat: Optional[float] = None   # guarded-by: _lock
        # Set while an abandoned call may still hold dispatch_lock: the
        # grace settle() waits for it.
        self._grace: Optional[float] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.multiple > 0

    @property
    def calibrated(self) -> bool:
        with self._lock:
            return self._flat is not None

    def deadline_for(self, cost: Optional[float]) -> Optional[float]:
        """Seconds this dispatch may take before it counts as stalled,
        or None while uncalibrated (observe-only)."""
        if not self.enabled:
            return None
        with self._lock:
            rate, flat = self._rate, self._flat
        if cost is not None and rate is not None:
            return self.floor_s + self.multiple * rate * max(float(cost),
                                                             1.0)
        if flat is not None:
            return self.floor_s + self.multiple * flat
        return None

    def observe(self, cost: Optional[float], elapsed: float) -> None:
        """Fold one successful dispatch into the calibration (EWMA, 0.7
        old / 0.3 new)."""
        with self._lock:
            if cost is not None and cost > 0:
                r = elapsed / max(float(cost), 1.0)
                self._rate = (r * self.seed_headroom if self._rate is None
                              else 0.7 * self._rate + 0.3 * r)
            self._flat = (elapsed * self.seed_headroom
                          if self._flat is None
                          else 0.7 * self._flat + 0.3 * elapsed)

    def _stalled(self, deadline: float, elapsed: float) -> None:
        self.last_stall = (float(deadline), float(elapsed))
        with self._lock:
            self._grace = float(self.grace_s if self.grace_s is not None
                                else deadline)

    def settle(self) -> None:
        """Wait, for at most the grace, until an abandoned call has left
        the engine; raise EnginePoisoned if it has not. A no-op when no
        call was abandoned. The recovery calls this before it touches
        the engine, and every watched call before it starts."""
        with self._lock:
            grace = self._grace
        if grace is None:
            return
        if not self.dispatch_lock.acquire(timeout=grace):
            self.stats.count("poisoned")
            raise EnginePoisoned(
                f"an abandoned dispatch still holds the engine {grace:.2f}s "
                f"after it was abandoned; nothing may dispatch beside it")
        self.dispatch_lock.release()
        with self._lock:
            self._grace = None

    @contextlib.contextmanager
    def exclusive(self):
        """Hold the dispatch lock on the caller's thread for an
        unwatched engine call (the serve ladder and out-of-memory
        retry), once :meth:`settle` has passed. No watched call may run
        inside: its worker would wait on this lock."""
        self.settle()
        with self.dispatch_lock:
            yield

    def watch(self, fn: Callable, cost: Optional[float] = None,
              site: str = "dispatch", label: str = "",
              on_tick: Optional[Callable[[], None]] = None,
              calibrate: bool = True):
        """Run one dispatch under the watchdog. A successful call that
        built no kernel feeds the calibration (with its build-free
        seconds) unless ``calibrate`` is False (a call that only
        enqueues: :meth:`watch_device` calibrates it); an expiry counts
        into ``stats.stalls[site]`` and raises DispatchStalled for the
        caller's recovery."""
        if not self.enabled:
            return fn()
        self.settle()
        deadline = self.deadline_for(cost)
        t0 = time.monotonic()
        built0 = _build.build_seconds()
        if deadline is None and on_tick is None:
            # Uncalibrated and nobody needs ticks: run inline, observe,
            # enforce from a later dispatch on.
            with self.dispatch_lock:
                out = fn()
        else:
            self.stats.site("watched", site)
            try:
                out = watch_call(fn, deadline, label=label or site,
                                 on_tick=on_tick, tick_s=self.tick_s,
                                 stalled=self._stalled,
                                 lock=self.dispatch_lock)
            except DispatchStalled:
                self.stats.site("stalls", site)
                self.stats.count("stall_dumps")
                raise
        built = _build.build_seconds() - built0
        if calibrate and built == 0.0:
            self.observe(cost, time.monotonic() - t0)
        return out

    def watch_device(self, event, t0: float, built0: float,
                     cost: Optional[float], site: str = "dispatch") -> None:
        """Wait for a dispatch's device work (``event``, recorded after
        its enqueue) under the dispatch's deadline, counted from its
        start ``t0`` without the kernel builds since ``built0``; an
        expiry counts into ``stats.stalls[site]`` and raises
        DispatchStalled. The card never gives an abandoned wait back:
        the caller does not retry, it fails. Start-to-finish seconds of
        a dispatch that built nothing feed the calibration."""
        if not self.enabled:
            event.synchronize()
            return
        deadline = self.deadline_for(cost)
        if deadline is None or event.query():
            event.synchronize()
        else:
            spent = (time.monotonic() - t0
                     - (_build.build_seconds() - built0))
            try:
                watch_call(event.synchronize, max(deadline - spent, 0.0),
                           label=f"{site} device work",
                           tick_s=self.tick_s, stalled=self._stalled)
            except DispatchStalled:
                self.stats.site("stalls", site)
                self.stats.count("stall_dumps")
                raise
        if _build.build_seconds() == built0:
            self.observe(cost, time.monotonic() - t0)
