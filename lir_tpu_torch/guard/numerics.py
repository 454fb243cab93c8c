"""Numerics guard: the validation boundary at score-extraction time.

Port of ``lir_tpu/guard/numerics.py``: :func:`check_values` and its
epsilons (the sweeps' rows), and :func:`check_payload` (a serve
payload). A corrupt kernel or
card does not crash, it emits NaN/Inf logits, and those flow through
the softmax readouts into the CSVs as plausible-looking numbers; every
row crosses this check first. It rejects only what a valid softmax
cannot produce:

- P(yes) / P(no) finite and inside [0, 1];
- P(yes) + P(no) <= 1 (+ float slop);
- weighted confidence finite and inside [0, 100];
- the top-20 log-probability map free of NaN and never positive;
- the parsed confidence integer inside [0, 100].

Offending rows are quarantined as ``error:numerics`` by the caller.
"""

from __future__ import annotations

import json
import math
from typing import Optional, Sequence

import numpy as np

NUMERICS_ERROR = "error:numerics"

# Float32 readouts round-trip through host floats; these are slop for
# rounding, not tolerance for corruption (a real softmax output can miss
# the exact bound by an ulp, never by a percent).
_P_EPS = 1e-4
_SUM_EPS = 1e-3
_CONF_EPS = 1e-3


def check_values(token_1_prob, token_2_prob,
                 weighted_confidence=None,
                 logprob_values: Optional[Sequence[float]] = None,
                 confidence_value: Optional[int] = None) -> Optional[str]:
    """Validate one row's device-derived readouts. Returns None when the
    row is sane, else a short human-readable reason (the quarantine
    note). A clean row can never trip this."""
    for name, v in (("P(yes)", token_1_prob), ("P(no)", token_2_prob)):
        if v is None:
            return f"{name} missing"
        v = float(v)
        if not math.isfinite(v):
            return f"{name} not finite ({v!r})"
        if v < -_P_EPS or v > 1.0 + _P_EPS:
            return f"{name}={v:.6g} outside [0,1]"
    s = float(token_1_prob) + float(token_2_prob)
    if s > 1.0 + _SUM_EPS:
        return f"P(yes)+P(no)={s:.6g} > 1 (renormalization insane)"
    if weighted_confidence is not None:
        w = float(weighted_confidence)
        if not math.isfinite(w):
            return f"weighted confidence not finite ({w!r})"
        if w < -_CONF_EPS or w > 100.0 + _CONF_EPS:
            return f"weighted confidence={w:.6g} outside [0,100]"
    if confidence_value is not None and not 0 <= confidence_value <= 100:
        return f"confidence value {confidence_value} outside [0,100]"
    if logprob_values is not None:
        arr = np.asarray(logprob_values, dtype=np.float64)
        if arr.size:
            if np.isnan(arr).any():
                return "log-probability map contains NaN"
            if (arr > _P_EPS).any():
                return "log-probability map contains positive logprobs"
    return None


def check_payload(payload: dict) -> Optional[str]:
    """:func:`check_values` over a serve measurement payload (the dict
    ``serve.batcher.ContinuousBatcher.score`` returns a row). The
    log-prob map's string is parsed back, so a NaN that reached only
    the map is caught too."""
    lp = None
    s = payload.get("log_probabilities")
    if s:
        try:
            lp = list(json.loads(s).values())
        except ValueError:
            return "log-probability map unparseable"
    return check_values(payload.get("token_1_prob"),
                        payload.get("token_2_prob"),
                        payload.get("weighted_confidence"), lp,
                        payload.get("confidence_value"))
