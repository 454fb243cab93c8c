"""Exponential-backoff retry (reference: perturb_prompts.py:72-106).

Port of ``lir_tpu/utils/retry.py``: one policy over exception types for
the sweep's dispatch recovery and the serve supervisor's dispatches
(config.RetryConfig: retries, initial delay, cap, backoff factor, the
0.8-1.2 jitter band or full jitter, and an elapsed cap on the whole
loop). KeyboardInterrupt and SystemExit are never retried, whatever
``retry_on`` says.

Two departures: the jitter draws from an explicit ``random.Random``
(``rng``; default the module's shared generator, as in the JAX
package), so a test can replay a schedule of waits; and ``give_up_on``
names errors that are never retried even where ``retry_on`` matches
them (an engine an abandoned dispatch still holds,
``guard.watchdog.EnginePoisoned``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..config import RetryConfig

T = TypeVar("T")


def retry_with_exponential_backoff(
    fn: Callable[[], T],
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    config: RetryConfig = RetryConfig(),
    sleep: Callable[[float], None] = time.sleep,
    log: Callable[[str], None] = print,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    give_up_on: Tuple[Type[BaseException], ...] = (),
) -> T:
    draw = rng if rng is not None else random
    delay = config.initial_delay
    start = clock()
    for attempt in range(config.max_retries + 1):
        try:
            return fn()
        except retry_on as exc:
            if isinstance(exc, (KeyboardInterrupt, SystemExit)
                          + tuple(give_up_on)):
                raise  # shutdown signals are not transient failures
            if attempt == config.max_retries:
                raise
            if config.full_jitter:
                wait = draw.uniform(0.0, min(delay, config.max_delay))
            else:
                wait = min(delay * draw.uniform(*config.jitter),
                           config.max_delay)
            if (config.max_elapsed is not None
                    and clock() - start + wait > config.max_elapsed):
                log(
                    f"Attempt {attempt + 1}/{config.max_retries + 1} failed "
                    f"({type(exc).__name__}: {exc}); next retry would exceed "
                    f"the {config.max_elapsed:.1f}s elapsed cap — giving up"
                )
                raise
            log(
                f"Attempt {attempt + 1}/{config.max_retries + 1} failed "
                f"({type(exc).__name__}: {exc}); retrying in {wait:.1f}s"
            )
            sleep(wait)
            delay = min(delay * config.backoff_factor, config.max_delay)
    raise AssertionError("unreachable")
