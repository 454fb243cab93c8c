"""Degradation ladder: isolate poison rows instead of failing a batch.
Port of ``lir_tpu/faults/ladder.py``.

A dispatch that keeps failing after its retries is either a broken
device (every subset fails: the caller fails the dispatch and the
circuit breaker takes over) or one poison row (a prompt that crashes
the dispatch). :func:`degrade_dispatch` tells them apart by bisection:
it retries the full batch once, then splits and recurses; rows that
fail alone come back None, every other row comes back scored. The cost
is O(poison x log batch) extra dispatches, none when the full retry
succeeds.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence


def degrade_dispatch(score_fn: Callable[[list], List[dict]],
                     rows: Sequence,
                     log: Optional[Callable[[str], None]] = None,
                     ) -> List[Optional[dict]]:
    """Score ``rows`` through ``score_fn`` (a row subset -> one payload
    a row), bisecting on failure. Returns a list aligned with ``rows``:
    a payload, or None for a row that fails even in a batch of one.
    KeyboardInterrupt, SystemExit and InjectedPreemption (BaseExceptions)
    always propagate: the ladder recovers work, it does not resist being
    killed."""
    rows = list(rows)
    out: List[Optional[dict]] = [None] * len(rows)

    def solve(lo: int, hi: int) -> None:
        try:
            payloads = score_fn(rows[lo:hi])
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as err:  # noqa: BLE001 — bisect decides
            if hi - lo == 1:
                if log is not None:
                    log(f"poison row isolated at index {lo}: {err!r}")
                return
            mid = (lo + hi) // 2
            solve(lo, mid)
            solve(mid, hi)
            return
        out[lo:hi] = list(payloads)

    if rows:
        solve(0, len(rows))
    return out
