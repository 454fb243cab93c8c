"""Per-family base-vs-instruct difference analysis (C42).

Port of ``lir_tpu/survey/family_differences.py``. Parity target:
survey_analysis/analyze_model_family_differences.py:1-232 — consumes the
D9 bootstrap JSON and, for each model family and each of MAE/MSE/MAPE,
reports the instruct-minus-base difference with:
  method 1: propagated-std 1.96*SE CI (:63-72)
  method 2: combined CI-range CI (:74-82)
  method 3: 10,000-draw normal-approximation Monte Carlo with a two-tailed
            p-value (:169-230) — ``stats.bootstrap.normal_approx_mc_difference``
            on ``device``, family f's metric m drawing from
            ``generator_for(seed, 4, 3, f, m)``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..device import resolve_device
from ..stats.bootstrap import normal_approx_mc_difference
from ..stats.core import generator_for
from .human_llm import SURVEY_WORD

_WORD = 3

DEFAULT_FAMILIES: Dict[str, Dict[str, str]] = {
    "Falcon": {
        "base": "tiiuae/falcon-7b",
        "instruct": "tiiuae/falcon-7b-instruct",
    },
    "StableLM": {
        "base": "stabilityai/stablelm-base-alpha-7b",
        "instruct": "stabilityai/stablelm-tuned-alpha-7b",
    },
    "RedPajama": {
        "base": "togethercomputer/RedPajama-INCITE-7B-Base",
        "instruct": "togethercomputer/RedPajama-INCITE-7B-Instruct",
    },
}

METRICS = ("mae", "mse", "mape")


def analyze_family_differences(
    bootstrap_payload: Dict[str, object],
    seed: int = 42,
    families: Optional[Dict[str, Dict[str, str]]] = None,
    n_mc: int = 10_000,
    device="cuda",
) -> Dict[str, object]:
    """Differences for every (family, metric) with all three CI methods."""
    device = resolve_device(device)
    families = families or DEFAULT_FAMILIES
    by_model = {r["model"]: r for r in bootstrap_payload["model_results"]}

    out: Dict[str, object] = {}
    for f_idx, (family, pair) in enumerate(families.items()):
        base = by_model.get(pair["base"])
        instruct = by_model.get(pair["instruct"])
        if base is None or instruct is None:
            out[family] = {"missing": True}
            continue
        fam: Dict[str, object] = {}
        for m_idx, metric in enumerate(METRICS):
            b_mean = base[f"{metric}_mean"]
            i_mean = instruct[f"{metric}_mean"]
            diff = i_mean - b_mean

            # Method 1: independence-propagated std.
            se = float(np.sqrt(base[f"{metric}_std"] ** 2
                               + instruct[f"{metric}_std"] ** 2))
            m1 = (diff - 1.96 * se, diff + 1.96 * se)

            # Method 2: combined CI ranges.
            b_range = base[f"{metric}_ci_upper"] - base[f"{metric}_ci_lower"]
            i_range = (
                instruct[f"{metric}_ci_upper"] - instruct[f"{metric}_ci_lower"]
            )
            combined = float(np.sqrt(b_range**2 + i_range**2))
            m2 = (diff - combined / 2, diff + combined / 2)

            # Method 3: normal-approximation MC (instruct - base).
            mc = normal_approx_mc_difference(
                i_mean, instruct[f"{metric}_std"],
                b_mean, base[f"{metric}_std"],
                generator_for(seed, SURVEY_WORD, _WORD, f_idx, m_idx),
                n_draws=n_mc, device=device,
            )

            fam[metric] = {
                "base_mean": b_mean,
                "base_ci": [
                    base[f"{metric}_ci_lower"], base[f"{metric}_ci_upper"]
                ],
                "instruct_mean": i_mean,
                "instruct_ci": [
                    instruct[f"{metric}_ci_lower"],
                    instruct[f"{metric}_ci_upper"],
                ],
                "difference": diff,
                "relative_change_pct": (diff / b_mean) * 100 if b_mean else None,
                "ci_propagated_std": list(m1),
                "ci_combined_range": list(m2),
                "significant_combined_range": bool(m2[0] * m2[1] > 0),
                "mc_difference": mc,
            }
        out[family] = fam
    return out


def write_family_differences(results: Dict[str, object], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=2))
