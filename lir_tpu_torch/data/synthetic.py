"""Deterministic synthetic D6 fixture for differential-parity testing.

A copy of ``lir_tpu/data/synthetic.py`` without pandas: the same records
from the same seeds (``np.random.default_rng(20260730)`` for the scorer
model, ``20260731`` for the edge model) in the same draw order, so the
port's analyses can be held against the JAX package's and against the
executed reference's outputs on this fixture
(``tests/golden/reference_executed.json``, section
``analyze_perturbation_results``).

The rows use the five real legal prompts with per-prompt yes-lean levels
spanning the kappa interpretation bands. A second model,
``synthetic-edge-v1``, hits every edge branch of the analyzer:
zero/one-inflated relative probabilities, non-finite rows, non-compliant
first tokens and full responses, unparseable and Python-literal log
probabilities, and every confidence non-compliance category.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

from .prompts import LEGAL_PROMPTS
from .schemas import (PERTURBATION_COLUMNS, _cell, _write_csv,
                      resolve_results_path)
from .table import Table

SYNTH_SEED = 20260730
N_REPHRASINGS = 200          # per prompt (reference scale ~2000; 200 keeps
                             # the fixture fast while self-kappa stays stable)
SYNTH_MODEL = "synthetic-scorer-v1"

# Edge-case model: a second model whose rows hit every hairy
# branch of the reference analyzer (analyze_perturbation_results.py) —
# zero/one-inflated Relative_Prob (exact 0/1 mass for the truncated-normal
# MC fit's inflation accounting, :150-156), non-finite rows (Token probs
# both 0), non-compliant first tokens and full responses (:1330-1372),
# unparseable / ast-literal Log Probabilities (:1301-1322), and every
# confidence non-compliance category (float / text / out-of-range / other,
# :1564-1600).
SYNTH_EDGE_MODEL = "synthetic-edge-v1"
N_EDGE_ROWS = 60             # per prompt (>= 100/model so the analyzer's
                             # small-data guard does not trip, :1724)

# Per-prompt P(token_1 wins): spans near-coin-flip to near-unanimous.
_YES_LEAN = (0.55, 0.72, 0.38, 0.9, 0.65)

# Canonical full responses per prompt (the reference's expected_tokens
# table, analyze_perturbation_results.py:1206-1246), pre-split into OpenAI
# content-style token pieces so compliant rows re-join exactly.
_FULL_RESPONSE_TOKENS = (
    {"Covered": ("Covered",), "Not": ("Not", " Covered")},
    {"Ultimate": ("Ultimate", " Petition"), "First": ("First", " Petition")},
    {"Existing": ("Existing", " Affiliates"),
     "Future": ("Future", " Affiliates")},
    {"Monthly": ("Monthly", " Installment", " Payments"),
     "Payment": ("Payment", " Upon", " Completion")},
    {"Covered": ("Covered",), "Not": ("Not", " Covered")},
)


def _content_logprobs(tokens, logprob: float) -> str:
    """OpenAI chat-completions style 'Log Probabilities' payload — the ONLY
    format the reference compliance checker parses (:1313-1326)."""
    return json.dumps(
        {"content": [{"token": t, "logprob": logprob} for t in tokens]})


def synthetic_records() -> List[dict]:
    """The deterministic D6 rows, one dict a row in D6 column order: the
    scorer model's 5 x 200 rows, then the edge model's 5 x 60."""
    rng = np.random.default_rng(SYNTH_SEED)
    records: List[dict] = []
    for pi, (prompt, lean) in enumerate(zip(LEGAL_PROMPTS, _YES_LEAN)):
        for i in range(N_REPHRASINGS):
            # Relative prob drawn around the lean with clipping to (0, 1).
            rel = float(np.clip(rng.normal(lean, 0.18), 1e-3, 1 - 1e-3))
            total = float(rng.uniform(0.7, 0.99))
            t1, t2 = rel * total, (1 - rel) * total
            conf = float(np.clip(rng.normal(70, 15), 0, 100))
            target = (prompt.target_tokens[0] if rel > 0.5
                      else prompt.target_tokens[1])
            pieces = _FULL_RESPONSE_TOKENS[pi][target]
            records.append({
                "Model": SYNTH_MODEL,
                "Original Main Part": prompt.main,
                "Response Format": prompt.response_format,
                "Confidence Format": prompt.confidence_format,
                "Rephrased Main Part": f"[rephrasing {i}] {prompt.main}",
                "Full Rephrased Prompt": prompt.rephrased_binary(
                    f"[rephrasing {i}] {prompt.main}"),
                "Full Confidence Prompt": prompt.rephrased_confidence(
                    f"[rephrasing {i}] {prompt.main}"),
                "Model Response": target,
                "Model Confidence Response": str(int(round(conf))),
                "Log Probabilities": _content_logprobs(
                    pieces, float(np.log(max(t1, t2)))),
                "Token_1_Prob": t1,
                "Token_2_Prob": t2,
                "Odds_Ratio": t1 / t2,
                "Confidence Value": float(int(round(conf))),
                "Weighted Confidence": conf,
            })
    records.extend(_edge_model_records())
    return records


def synthetic_perturbation_frame() -> Table:
    """The D6 fixture as the table ``pd.DataFrame(records, columns=D6)``
    makes of it."""
    return Table.from_records(synthetic_records(), PERTURBATION_COLUMNS)


def _edge_model_records() -> List[dict]:
    """synthetic-edge-v1 rows: every analyzer edge branch, deterministic."""
    rng = np.random.default_rng(SYNTH_SEED + 1)
    records: List[dict] = []
    for pi, prompt in enumerate(LEGAL_PROMPTS):
        fulls = _FULL_RESPONSE_TOKENS[pi]
        tok1, tok2 = prompt.target_tokens
        for i in range(N_EDGE_ROWS):
            kind = i % 10
            # Interior draw with HARD clipping to [0, 1]: the clip mass
            # lands exactly on the bounds -> natural zero/one inflation on
            # top of the explicit inflated rows below.
            rel = float(np.clip(rng.normal(0.5, 0.3), 0.0, 1.0))
            total = float(rng.uniform(0.6, 0.95))
            wconf = float(np.clip(rng.normal(55.0, 30.0), 0.0, 100.0))
            target = tok1 if rel > 0.5 else tok2
            compliant_lp = _content_logprobs(fulls[target], -0.3)
            conf: object = str(int(round(wconf)))
            conf_val: float = float(int(round(wconf)))
            lp = compliant_lp
            if kind == 0:          # zero-inflated: P(token_1) exactly 0
                rel, target = 0.0, tok2
                lp = _content_logprobs(fulls[tok2], -0.2)
                conf, conf_val, wconf = "0", 0.0, 0.0
            elif kind == 1:        # one-inflated: P(token_2) exactly 0
                rel, target = 1.0, tok1
                lp = _content_logprobs(fulls[tok1], -0.1)
                conf, conf_val, wconf = "100", 100.0, 100.0
            elif kind == 2:        # non-finite: both token probs zero
                rel, total = float("nan"), 0.0
                conf, conf_val, wconf = None, float("nan"), float("nan")
            elif kind == 3:        # non-compliant FIRST token + float conf
                lp = _content_logprobs(("I", " think", " " + target), -1.0)
                conf, conf_val = "85.5", float("nan")
            elif kind == 4:        # compliant first, non-compliant full +
                lp = _content_logprobs((target, " maybe"), -0.8)
                conf, conf_val = "150", float("nan")   # out-of-range conf
            elif kind == 5:        # unparseable payload (no 'content') +
                lp = json.dumps({tok1: -0.5, tok2: -1.5})
                conf, conf_val = "high", float("nan")  # text conf
            elif kind == 6:        # python-literal payload (ast branch) +
                lp = str({"content": [{"token": t, "logprob": -0.4}
                                      for t in fulls[target]]})
                conf, conf_val = "?", float("nan")     # 'other' conf
            t1 = rel * total if np.isfinite(rel) else 0.0
            t2 = (1.0 - rel) * total if np.isfinite(rel) else 0.0
            odds = (float("inf") if t2 == 0.0 and t1 > 0.0
                    else (t1 / t2 if t2 > 0.0 else float("nan")))
            records.append({
                "Model": SYNTH_EDGE_MODEL,
                "Original Main Part": prompt.main,
                "Response Format": prompt.response_format,
                "Confidence Format": prompt.confidence_format,
                "Rephrased Main Part": f"[edge {i}] {prompt.main}",
                "Full Rephrased Prompt": prompt.rephrased_binary(
                    f"[edge {i}] {prompt.main}"),
                "Full Confidence Prompt": prompt.rephrased_confidence(
                    f"[edge {i}] {prompt.main}"),
                "Model Response": target,
                "Model Confidence Response": conf,
                "Log Probabilities": lp,
                "Token_1_Prob": t1,
                "Token_2_Prob": t2,
                "Odds_Ratio": odds,
                "Confidence Value": conf_val,
                "Weighted Confidence": wconf,
            })
    return records


def write_synthetic_d6(path: Path) -> Path:
    """Write the fixture as CSV with the port's D6 writer (an ``.xlsx``
    path becomes its ``.csv``); returns the path written."""
    path = resolve_results_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_csv(path, [[_cell(r[c]) for c in PERTURBATION_COLUMNS]
                      for r in synthetic_records()])
    return path
