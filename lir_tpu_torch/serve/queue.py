"""Request queue with admission control, per-class deadlines and
shed-on-overload. Port of ``lir_tpu/serve/queue.py``.

The queue is the serving layer's backpressure boundary: its depth is
bounded (``config.ServeConfig.queue_depth``), so memory and worst-case
queueing delay are too. A submit into a full queue sheds the newcomer
UNLESS it is more urgent than the least-urgent queued request (latest
absolute deadline), which is shed instead: under overload the queue
keeps the work most likely to meet its deadline.

Host-side only; the continuous batcher (serve/batcher.py) drains
admitted entries into its per-bucket queues.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from ..utils.profiling import ServeStats

# Result statuses, in order of decreasing happiness.
STATUS_OK = "ok"
STATUS_EXPIRED = "deadline_exceeded"
STATUS_SHED = "shed"
STATUS_ERROR = "error"


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One interpretation probe: a grid cell's two sweep-format prompts
    plus serving metadata. ``deadline_s`` overrides the class deadline;
    ``klass`` names a class of config.ServeConfig.classes."""

    binary_prompt: str
    confidence_prompt: str
    targets: Tuple[str, str] = ("Yes", "No")
    klass: str = "batch"
    deadline_s: Optional[float] = None
    request_id: str = ""

    def to_record(self) -> dict:
        """JSON-safe dict for the serve state checkpoint."""
        rec = dataclasses.asdict(self)
        rec["targets"] = list(self.targets)
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "ServeRequest":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in rec.items() if k in known}
        kwargs["targets"] = tuple(kwargs.get("targets", ("Yes", "No")))
        return cls(**kwargs)


@dataclasses.dataclass
class ServeResult:
    """What a request resolves to: "ok", or a graceful degradation.
    "deadline_exceeded" rows return PARTIAL results (every measurement
    field None), "shed" rows were refused, "error" rows hit a fault that
    outlived the recovery. ``cached=True`` marks a result-cache hit."""

    request_id: str
    status: str
    model_response: str = ""
    model_confidence_response: str = ""
    token_1_prob: Optional[float] = None
    token_2_prob: Optional[float] = None
    log_probabilities: str = ""
    confidence_value: Optional[int] = None
    weighted_confidence: Optional[float] = None
    cached: bool = False
    latency_s: float = 0.0
    note: str = ""


class ServeFuture:
    """Completion handle: the submitter blocks in :meth:`result`, the
    supervisor resolves it once (first resolution wins). Every admitted
    request resolves with SOME status.

    ``add_done_callback`` is the router's seam (serve/router.py): the
    router reacts to a replica's resolution (forward the payload, fail
    over, drop a zombie or a hedge's loser) without a waiting thread per
    attempt. A callback added after resolution fires at once, on the
    caller's thread, with the winning result; a late ``resolve`` is
    dropped and fires nothing."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: Optional[ServeResult] = None
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[ServeResult], None]] = []

    def resolve(self, result: ServeResult) -> None:
        with self._lock:
            if self._done.is_set():    # first resolution wins
                return
            self._result = result
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:           # outside the lock: a callback may
            fn(result)                 # resolve OTHER futures

    def add_done_callback(self, fn: Callable[[ServeResult], None]) -> None:
        """Run ``fn(result)`` when this future resolves (at once if it
        has). Callbacks run on the resolving thread: keep them short and
        never wait on another future inside one."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
            result = self._result
        assert result is not None
        fn(result)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._done.wait(timeout):
            raise TimeoutError("serve request not resolved in time")
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class Pending:
    """An admitted request plus what the batcher needs, computed ONCE at
    submit time on the caller's thread: both formats' token ids, their
    shared-prefix split, the ladder bucket, the target ids, the result
    cache's content address, and the radix-cached prefix tokens at
    submit (advisory: the batcher's pricing; the dispatch looks up
    again with a pin). ``model_id`` routes a fleet server's row to its
    model's batcher ("" on a single-model server)."""

    request: ServeRequest
    future: ServeFuture
    t_submit: float
    t_deadline: float
    bin_ids: Tuple[int, ...] = ()
    conf_ids: Tuple[int, ...] = ()
    lcp: int = 0
    bucket: int = 0
    t1: int = 0
    t2: int = 0
    cache_key: str = ""
    cached_hint: int = 0
    model_id: str = ""


class RequestQueue:
    """Bounded FIFO with deadline-aware shedding (module docstring)."""

    def __init__(self, maxlen: int, stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.maxlen = int(maxlen)
        self.stats = stats if stats is not None else ServeStats()
        self.clock = clock
        # _lock and _nonempty share one lock guarding the deque.
        self._dq: Deque[Pending] = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def _shed(self, pending: Pending, note: str) -> None:
        self.stats.count("shed")
        pending.future.resolve(ServeResult(
            request_id=pending.request.request_id, status=STATUS_SHED,
            note=note, latency_s=self.clock() - pending.t_submit))

    def offer(self, pending: Pending) -> bool:
        """Admit or shed. True when ``pending`` joined the queue; False
        when it was shed (its future is already resolved)."""
        with self._nonempty:
            if len(self._dq) < self.maxlen:
                self._dq.append(pending)
                self.stats.count("admitted")
                self.stats.note_queue_depth(len(self._dq))
                self._nonempty.notify()
                return True
            # Full: keep the most urgent set. Evict the queued request
            # with the LATEST deadline when the newcomer beats it.
            victim = max(self._dq, key=lambda p: p.t_deadline)
            if pending.t_deadline < victim.t_deadline:
                self._dq.remove(victim)
                self._dq.append(pending)
                self.stats.count("admitted")
                self._nonempty.notify()
            else:
                victim = pending
        # resolve outside the lock (victim futures may have waiters)
        self._shed(victim, note="queue full "
                   f"(depth {self.maxlen}) — least-urgent request shed")
        return victim is not pending

    def drain(self) -> List[Pending]:
        """Pop every queued request, FIFO."""
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
        return out

    def snapshot(self) -> List[Pending]:
        """A copy of the queued entries (the shutdown checkpoint)."""
        with self._lock:
            return list(self._dq)

    def wait_nonempty(self, timeout: float) -> bool:
        with self._nonempty:
            if self._dq:
                return True
            return self._nonempty.wait(timeout)

    def kick(self) -> None:
        """Wake a supervisor parked in :meth:`wait_nonempty` without
        queueing anything: out-of-band work (a page op, serve/migrate.py)
        arrived that the loop should see now, not a poll later."""
        with self._nonempty:
            self._nonempty.notify()

    def flush(self, status: str, note: str) -> int:
        """Resolve every queued request with ``status`` (the breaker's
        drain); returns how many were flushed."""
        drained = self.drain()
        now = self.clock()
        for p in drained:
            if status == STATUS_SHED:
                self.stats.count("shed")
            else:
                self.stats.count("errors")
            p.future.resolve(ServeResult(
                request_id=p.request.request_id, status=status, note=note,
                latency_s=now - p.t_submit))
        return len(drained)
