"""Correlation p-value suite: all-pairs LLM and human-rater correlations
with significance tests and distribution comparisons (C43).

Port of ``lir_tpu/survey/pvalues.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity target:
survey_analysis/calculate_correlation_pvalues.py:38-320 — model-model
Pearson+p over >10 common questions, rater-rater Pearson+p within survey
groups (>=3 common questions), and LLM-vs-human correlation distribution
comparison via Mann-Whitney U / KS / t-test / Cohen's d.

Each group's correlation matrix is one masked-Pearson computation on
``device`` (``stats.correlations.masked_pearson_matrix``, float32 as in
the JAX package); p-values are then computed on the host in closed form
from (r, n) exactly as pearsonr does (t = r*sqrt((n-2)/(1-r^2)),
two-sided t survival), vectorized over the whole matrix.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
from scipy import stats as scipy_stats

from ..data.table import Table, is_missing
from ..device import resolve_device
from ..stats.core import as_f32
from ..stats.correlations import masked_pearson_matrix
from .human_llm import relative_prob_series
from .loader import DURATION, GROUPS, group_question_ids, numeric_matrix


def pearson_pvalues(r: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Two-sided p-values for Pearson r with n joint observations (the
    beta/t distribution used by scipy.stats.pearsonr)."""
    r = np.asarray(r, dtype=float)
    n = np.asarray(n, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = r * np.sqrt((n - 2) / np.maximum(1e-300, 1 - r * r))
        p = 2 * scipy_stats.t.sf(np.abs(t), np.maximum(n - 2, 1))
    p = np.where(np.abs(r) >= 1.0, 0.0, p)
    return np.where(n > 2, p, np.nan)


def _joint_counts(x: np.ndarray) -> np.ndarray:
    m = np.isfinite(x).astype(float)
    return m.T @ m


def llm_correlations_with_pvalues(
    instruct_df: Table,
    base_df: Table,
    min_questions: int = 10,
    device="cuda",
) -> List[Dict[str, object]]:
    """All-pairs model-model correlations over common questions (:38-94).
    The reference requires strictly more than `min_questions` valid pairs.

    Defect fixed, not replicated (as in the JAX package): the reference
    concatenates the D1 and D2 frames FIRST and then reads
    ``row['relative_prob']`` (:42,57-58), which is NaN for every D1 row
    after the concat — silently dropping all base models from an analysis
    that explicitly loads them. Here the readout is computed per-frame
    before concatenation, so base models participate via yes/(yes+no) as
    intended.
    """
    prompts = list(base_df["prompt"]) + list(instruct_df["prompt"])
    models = list(base_df["model"]) + list(instruct_df["model"])
    rel = np.concatenate([relative_prob_series(base_df),
                          relative_prob_series(instruct_df)])
    # Models present in BOTH CSVs (e.g. Qwen-7B-Chat) have duplicate
    # (model, prompt) rows; the reference's dict build keeps the last one
    # (:55-65), so mirror that (``drop_duplicates(keep="last")``) rather
    # than pivot_table's mean-aggregation.
    key = lambda v: ("<nan>",) if is_missing(v) else v
    last = {(key(m), key(p)): i for i, (m, p) in enumerate(zip(models,
                                                               prompts))}
    keep = np.zeros(len(rel), dtype=bool)
    keep[list(last.values())] = True
    combined = Table({
        "prompt": np.array(prompts, dtype=object)[keep],
        "model": np.array(models, dtype=object)[keep], "_rel": rel[keep]})
    pivot = combined.pivot_table("prompt", "model", "_rel")
    names = list(pivot.columns)
    x = pivot.values.astype(float)

    corr = masked_pearson_matrix(as_f32(x, device)).cpu().numpy()
    counts = _joint_counts(x)
    pvals = pearson_pvalues(corr, counts)

    out = []
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            n = int(counts[i, j])
            if n > min_questions:
                # Constant-input pairs keep their row with a NaN
                # correlation, exactly as the reference records them
                # (:83-92 appends pearsonr's NaN); every consumer filters
                # non-finite values (compare_correlation_distributions).
                finite = bool(np.isfinite(corr[i, j]))
                out.append(
                    {
                        "model1": names[i],
                        "model2": names[j],
                        "correlation": float(corr[i, j]),
                        "p_value": float(pvals[i, j]) if finite
                        else float("nan"),
                        "n_questions": n,
                        "significant": bool(finite and pvals[i, j] < 0.05),
                    }
                )
    return out


def apply_pvalue_exclusions(df: Table) -> Table:
    """The C43 script's own (lighter) exclusion pass (:217-227): duration
    < 20% of median, and answered attention checks != 100. No
    identical-slider filter."""
    duration = np.asarray(df[DURATION], dtype=float)
    finite = duration[~np.isnan(duration)]
    median = float(np.median(finite)) if finite.size else float("nan")
    with np.errstate(invalid="ignore"):
        df = df.take(duration >= 0.2 * median)
    for group in GROUPS:
        col = f"Q{group}_8"
        if col in df:
            att = np.asarray(df[col], dtype=float)
            df = df.take(np.isnan(att) | (att == 100))
    return df


def human_correlations_with_pvalues(
    clean_df: Table,
    min_questions: int = 3,
    device="cuda",
) -> List[Dict[str, object]]:
    """All-pairs rater-rater correlations within each group (:96-136)."""
    out = []
    for group in GROUPS:
        gq = group_question_ids(group)
        answered = ~np.isnan(np.asarray(clean_df[f"Q{group}_1"], dtype=float))
        if answered.sum() < 2:
            continue
        x = numeric_matrix(clean_df.take(answered), gq).T  # (questions, raters)
        corr = masked_pearson_matrix(as_f32(x, device)).cpu().numpy()
        counts = _joint_counts(x)
        pvals = pearson_pvalues(corr, counts)
        n_r = x.shape[1]
        for i in range(n_r):
            for j in range(i + 1, n_r):
                n = int(counts[i, j])
                if n >= min_questions and np.isfinite(corr[i, j]):
                    out.append(
                        {
                            "group": group,
                            "rater1_idx": i,
                            "rater2_idx": j,
                            "correlation": float(corr[i, j]),
                            "p_value": float(pvals[i, j]),
                            "n_questions": n,
                            "significant": bool(pvals[i, j] < 0.05),
                        }
                    )
    return out
def compare_correlation_distributions(
    llm_correlations: List[Dict[str, object]],
    human_correlations: List[Dict[str, object]],
) -> Dict[str, object]:
    """LLM-vs-human correlation distribution tests (:138-204)."""
    llm_vals = np.asarray(
        [c["correlation"] for c in llm_correlations], dtype=float
    )
    human_vals = np.asarray(
        [c["correlation"] for c in human_correlations], dtype=float
    )
    llm_vals = llm_vals[np.isfinite(llm_vals)]
    human_vals = human_vals[np.isfinite(human_vals)]

    mw_stat, mw_p = scipy_stats.mannwhitneyu(
        llm_vals, human_vals, alternative="two-sided"
    )
    ks_stat, ks_p = scipy_stats.ks_2samp(llm_vals, human_vals)
    t_stat, t_p = scipy_stats.ttest_ind(llm_vals, human_vals)

    pooled_std = float(np.sqrt((llm_vals.std() ** 2 + human_vals.std() ** 2) / 2))
    cohens_d = float((llm_vals.mean() - human_vals.mean()) / pooled_std)

    def _stats_block(vals, rows):
        # Rates are over VALID (finite-correlation) rows, matching the
        # reference's valid_*_correlations denominators (:162-176).
        sig = sum(1 for c in rows if c["significant"])
        return {
            "mean": float(vals.mean()),
            "std": float(vals.std()),
            "median": float(np.median(vals)),
            "n_pairs": int(vals.size),
            "significant_pairs": sig,
            "proportion_significant": sig / int(vals.size) if vals.size else 0,
        }

    return {
        "llm_stats": _stats_block(llm_vals, llm_correlations),
        "human_stats": _stats_block(human_vals, human_correlations),
        "comparison_tests": {
            "mann_whitney": {
                "statistic": float(mw_stat),
                "p_value": float(mw_p),
                "significant": bool(mw_p < 0.05),
            },
            "kolmogorov_smirnov": {
                "statistic": float(ks_stat),
                "p_value": float(ks_p),
                "significant": bool(ks_p < 0.05),
            },
            "t_test": {
                "statistic": float(t_stat),
                "p_value": float(t_p),
                "significant": bool(t_p < 0.05),
            },
            "effect_size": {
                "cohens_d": cohens_d,
                "interpretation": (
                    "small"
                    if abs(cohens_d) < 0.5
                    else "medium"
                    if abs(cohens_d) < 0.8
                    else "large"
                ),
            },
        },
    }


def run_pvalue_analysis(
    instruct_df: Table,
    base_df: Table,
    survey_df: Table,
    device="cuda",
) -> Dict[str, object]:
    """End-to-end C43 (main, :206-320). `survey_df` is the loaded (not yet
    excluded) survey frame; this analysis applies its own exclusion rules."""
    device = resolve_device(device)
    clean = apply_pvalue_exclusions(survey_df)
    llm_corrs = llm_correlations_with_pvalues(instruct_df, base_df,
                                              device=device)
    human_corrs = human_correlations_with_pvalues(clean, device=device)
    comparison = compare_correlation_distributions(llm_corrs, human_corrs)
    return {
        "llm_correlations": llm_corrs,
        "human_correlations": human_corrs,
        "comparison": comparison,
    }


def write_pvalue_analysis(results: Dict[str, object], path: Path) -> None:
    """``correlation_pvalues_analysis.json`` (:312-319)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=2))
