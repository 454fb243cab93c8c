"""Per-item pairwise agreement.

Port of ``lir_tpu/stats/agreement.py``. Parity targets:
calculate_per_item_agreement_humans / calculate_per_item_agreement_llms
(survey_analysis_consolidated.py:234-350). The pairwise |difference|
matrix is one broadcast subtraction and the pair statistics are
reductions over its upper triangle, in float32 on ``device``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .bootstrap import bootstrap_mean_ci
from .core import as_f32


def pairwise_agreement_stats(values: np.ndarray, scale: float,
                             device="cuda") -> Dict[str, float]:
    """Mean/std of pairwise agreement 1 - |a-b|/scale over all unordered
    pairs of `values` (scale=100 for human sliders, 1 for LLM probabilities).
    """
    v = as_f32(values, device)
    n = int(v.shape[0])
    agreement = 1.0 - torch.abs(v[:, None] - v[None, :]) / scale
    iu = torch.triu_indices(n, n, offset=1, device=v.device)
    pair_vals = agreement[iu[0], iu[1]]
    return {
        "mean_agreement": float(pair_vals.mean()),
        "std_agreement": float(pair_vals.std(correction=0)),
        "n_pairs": n * (n - 1) // 2,
        "response_variance": float(torch.var(v, correction=0)),
    }


def per_item_agreement(
    responses_by_item: Dict[str, np.ndarray],
    scale: float,
    generator: torch.Generator,
    n_boot: int = 1000,
    count_key: str = "n_responses",
    device="cuda",
) -> Dict[str, object]:
    """Per-item pairwise agreement + bootstrap CI on the across-item mean.

    `responses_by_item` maps item id -> 1-D array of responses (already
    NaN-filtered). Items with < 2 responses are skipped, as in the reference.
    """
    per_item: Dict[str, Dict[str, float]] = {}
    means = []
    for item, vals in responses_by_item.items():
        vals = np.asarray(vals, dtype=float)
        vals = vals[np.isfinite(vals)]
        if vals.size < 2:
            continue
        stats = pairwise_agreement_stats(vals, scale, device)
        stats[count_key] = int(vals.size)
        per_item[item] = stats
        means.append(stats["mean_agreement"])

    if not means:
        return {
            "per_item": per_item,
            "overall_mean": 0.0,
            "overall_std": 0.0,
            "n_items": 0,
            "overall_mean_ci_lower": 0.0,
            "overall_mean_ci_upper": 0.0,
        }

    ci = bootstrap_mean_ci(np.asarray(means), generator, n_boot=n_boot,
                           device=device)
    return {
        "per_item": per_item,
        "overall_mean": float(np.mean(means)),
        "overall_std": float(np.std(means)),
        "n_items": len(means),
        "overall_mean_ci_lower": ci.ci_lower,
        "overall_mean_ci_upper": ci.ci_upper,
    }
