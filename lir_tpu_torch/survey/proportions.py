"""Model probabilities vs human yes-proportions + output-validity audit.

Port of ``lir_tpu/survey/proportions.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`; host code (numpy and scipy), as
there. Parity target: survey_analysis/analyze_base_vs_instruct_vs_human.py:
70-232 — per-model Pearson/Spearman/MAE against the human
``proportion_yes`` from the D7 detailed JSON, a Yes/No output-validity
scan, and per-model probability distribution statistics (with the same
always-Yes / always-No warnings).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
from scipy import stats as scipy_stats

from ..data.table import Table, series_mean, series_std0
from .human_llm import relative_prob_series


def human_proportions_from_detailed(
    detailed: Dict[str, object], question_mapping: Dict[str, str]
) -> Dict[str, float]:
    by_q = detailed["results"]["by_question"]
    return {
        prompt: by_q[qid]["proportion_yes"]
        for prompt, qid in question_mapping.items()
        if qid in by_q
    }


def model_vs_proportion_correlations(
    llm_df: Table,
    human_proportions: Dict[str, float],
    min_questions: int = 10,
) -> List[Dict[str, object]]:
    """Per-model agreement with human yes-proportions (:84-122), sorted by
    Pearson r descending."""
    rows = []
    df = llm_df.assign("_rel", relative_prob_series(llm_df))
    for model in df.unique("model"):
        mdata = df.where("model", model)
        h, m = [], []
        for prompt, rel in zip(mdata["prompt"], mdata["_rel"]):
            if prompt in human_proportions and not np.isnan(rel):
                h.append(human_proportions[prompt])
                m.append(float(rel))
        if len(h) < min_questions:
            continue
        h_arr, m_arr = np.asarray(h), np.asarray(m)
        pr, pp = scipy_stats.pearsonr(h_arr, m_arr)
        sr, sp = scipy_stats.spearmanr(h_arr, m_arr)
        rows.append(
            {
                "model": model,
                "n_questions": len(h),
                "pearson_r": float(pr),
                "pearson_p": float(pp),
                "spearman_r": float(sr),
                "spearman_p": float(sp),
                "mae": float(np.mean(np.abs(h_arr - m_arr))),
            }
        )
    rows.sort(key=lambda r: -r["pearson_r"])
    return rows


def invalid_responses(llm_df: Table) -> List[Dict[str, str]]:
    """Outputs containing neither 'yes' nor 'no' (:130-141)."""
    out = []
    for model, prompt, output in zip(llm_df["model"], llm_df["prompt"],
                                     llm_df["model_output"]):
        text = str(output).lower()
        if "yes" not in text and "no" not in text:
            out.append({"model": model, "prompt": prompt, "output": output})
    return out


def probability_distribution_stats(llm_df: Table) -> Dict[str, Dict[str, object]]:
    """Per-model relative-probability distribution summary with the
    bias warnings (:150-172)."""
    rel = relative_prob_series(llm_df)
    out: Dict[str, Dict[str, object]] = {}
    for model in llm_df.unique("model"):
        probs = rel[np.array([m == model for m in llm_df["model"]],
                             dtype=bool)]
        probs = probs[~np.isnan(probs)]
        if len(probs) == 0:
            continue
        mean = series_mean(probs)
        warning = None
        if mean < 0.3:
            warning = "Model tends to answer 'No' (low mean probability)"
        elif mean > 0.7:
            warning = "Model tends to answer 'Yes' (high mean probability)"
        out[model] = {
            "mean": mean,
            "std": series_std0(probs),
            "min": float(probs.min()),
            "max": float(probs.max()),
            "warning": warning,
        }
    return out


def run_proportion_analysis(
    llm_df: Table,
    detailed: Dict[str, object],
    question_mapping: Dict[str, str],
) -> Dict[str, object]:
    props = human_proportions_from_detailed(detailed, question_mapping)
    return {
        "model_correlations": model_vs_proportion_correlations(llm_df, props),
        "invalid_responses": invalid_responses(llm_df),
        "probability_distributions": probability_distribution_stats(llm_df),
        "n_questions_with_human_data": len(props),
    }


def write_proportion_analysis(results: Dict[str, object], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=2))
