"""Consolidated human-vs-LLM survey analysis (C31-C37).

Port of ``lir_tpu/survey/consolidated.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`, with its statistics on
``device``. Parity target: survey_analysis/survey_analysis_consolidated.py:
128-990 — per-question stats, human-LLM correlation with bootstrap CI,
per-item pairwise agreement, within-group cross-prompt rank-consistency
correlations with question-resampled bootstrap, the human-LLM difference
CI, the meta-correlation, the ~100-line stdout report, and the
``consolidated_analysis_results.json`` (D8) dump.

The reference rebuilds a pandas correlation matrix inside three nested
Python loops (group x bootstrap x respondent-pair; :352-703). Here each
group's rater matrix is resampled once as a (n_boot, n_questions) index
tensor and every resample's rater-by-rater masked Pearson matrix is one
batched computation on ``device`` (:func:`_boot_pair_sums`), in chunks
of resamples, reduced there to (sum of finite pair correlations, count)
a resample; the host reads the sums once a group.

Random draws (CPU generators, ``stats.core.generator_for``): block b of
:func:`run_consolidated_analysis` draws from ``(seed, 4, 0, b)`` — 0 the
human-LLM correlation, 1 and 2 the human and LLM per-item agreement, 6
the meta-correlation — and the group bootstraps of group g from ``(seed,
4, 0, 3, g)`` (human cross-prompt), ``(seed, 4, 0, 4, g)`` (LLM) and
``(seed, 4, 0, 5, side, g)`` (the difference CI, side 0 human, 1 LLM).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.table import Table, is_missing, series_mean, series_std0
from ..device import resolve_device
from ..stats.agreement import per_item_agreement
from ..stats.bootstrap import bootstrap_correlation
from ..stats.core import as_f32, generator_for, resample_indices
from ..stats.correlations import masked_pearson_matrix
from .human_llm import SURVEY_WORD
from .loader import GROUPS, group_question_ids, numeric_matrix

_WORD = 0
_HUMAN_CORR, _HUMAN_ITEMS, _LLM_ITEMS = 0, 1, 2
_HUMAN_CROSS, _LLM_CROSS, _DIFF_CI, _META = 3, 4, 5, 6
# Elements of the (rows, items, raters, raters) cross products a chunk of
# resamples may hold at once.
_CHUNK_ELEMS = 1 << 26


def _gen(seed: int, *words: int) -> torch.Generator:
    return generator_for(seed, SURVEY_WORD, _WORD, *words)


# ---------------------------------------------------------------------------
# Per-question response statistics (:128-160)
# ---------------------------------------------------------------------------


def human_responses_by_question(
    clean_df: Table, question_cols: List[str]
) -> Dict[str, Dict[str, object]]:
    stats: Dict[str, Dict[str, object]] = {}
    for q in question_cols:
        if q.endswith("_8"):
            continue
        responses = np.asarray(clean_df[q], dtype=float)
        responses = responses[~np.isnan(responses)]
        if len(responses) > 0:
            stats[q] = {
                "mean": series_mean(responses),
                "std": series_std0(responses),
                "n": int(len(responses)),
                "responses": responses.tolist(),
            }
    return stats


def llm_responses_by_question(llm_df: Table) -> Dict[str, Dict[str, object]]:
    stats: Dict[str, Dict[str, object]] = {}
    prompts = llm_df["prompt"]
    rel_all = np.asarray(llm_df["relative_prob"], dtype=float)
    for prompt in llm_df.unique("prompt"):
        rel = rel_all[np.array([not is_missing(p) and p == prompt
                                for p in prompts], dtype=bool)]
        stats[prompt] = {
            "mean": series_mean(rel),
            "std": series_std0(rel),
            "n": int(len(rel)),
            "model_responses": rel.tolist(),
        }
    return stats


def human_llm_correlation(
    human_stats, llm_stats, matches: Dict[str, str],
    generator: torch.Generator, n_bootstrap: int = 1000, device="cuda",
) -> Optional[Dict[str, object]]:
    """Pearson between per-question human means (0-1) and LLM mean relative
    probabilities, with percentile-bootstrap CI (:202-232)."""
    human_means, llm_means, matched = [], [], []
    for llm_prompt, survey_q in matches.items():
        if survey_q in human_stats and llm_prompt in llm_stats:
            h = human_stats[survey_q]["mean"] / 100.0
            m = llm_stats[llm_prompt]["mean"]
            human_means.append(h)
            llm_means.append(m)
            matched.append(
                {
                    "survey_question": survey_q,
                    "llm_prompt": llm_prompt,
                    "human_mean": h,
                    "llm_mean": m,
                }
            )
    if len(human_means) < 2:
        return None
    res = bootstrap_correlation(
        np.asarray(human_means), np.asarray(llm_means), generator,
        n_boot=n_bootstrap, device=device,
    )
    out = res.as_dict()
    out["n_questions"] = len(human_means)
    out["matched_questions"] = matched
    return out


# ---------------------------------------------------------------------------
# Cross-prompt (rank-consistency) correlations (:352-703)
# ---------------------------------------------------------------------------

MIN_ANSWERED = 5  # respondent must answer >= 5 of a group's questions (:382)


def _human_group_matrix(
    clean_df: Table, group: int
) -> Optional[np.ndarray]:
    """(n_respondents, 10) matrix of /100-scaled slider values for everyone
    who answered this group (gate: Q{group}_1 non-null, :363)."""
    gq = group_question_ids(group)
    answered = ~np.isnan(np.asarray(clean_df[f"Q{group}_1"], dtype=float))
    if answered.sum() < 2:
        return None
    return numeric_matrix(clean_df.take(answered), gq) / 100.0


def _llm_group_pivot(
    llm_df: Table, matches: Dict[str, str], group: int
) -> Optional[np.ndarray]:
    """(n_prompts, n_models) pivot of relative_prob for this group's matched
    prompts (:505-510)."""
    prompts = [
        p for p, q in matches.items() if int(q.split("_")[0][1:]) == group
    ]
    if len(prompts) < 2:
        return None
    chosen = set(prompts)
    data = llm_df.take(np.array([isinstance(p, str) and p in chosen
                                 for p in llm_df["prompt"]], dtype=bool))
    pivot = data.pivot_table("prompt", "model", "relative_prob")
    if len(pivot.index) < 2:
        return None
    return pivot.values.astype(float)


def _rater_pair_values(matrix: np.ndarray, min_answered: int = 0,
                       device="cuda") -> np.ndarray:
    """Finite upper-triangle pairwise-complete correlations between raters.

    `matrix` is (items, raters) oriented as rows=raters for humans, so
    callers pass respondents-as-rows and we transpose internally; for the
    LLM pivot rows are already items.
    """
    x = np.asarray(matrix, dtype=float)
    if min_answered:
        valid = np.isfinite(x).sum(axis=1) >= min_answered
        x = np.where(valid[:, None], x, np.nan)
        corr = masked_pearson_matrix(as_f32(x.T, device)).cpu().numpy()
    else:
        corr = masked_pearson_matrix(as_f32(x, device)).cpu().numpy()
    iu = np.triu_indices(corr.shape[0], k=1)
    vals = corr[iu]
    return vals[np.isfinite(vals)]


def _boot_pair_sums(x: torch.Tensor, idx: torch.Tensor, min_answered: int):
    """For each resample row of `idx` (question indices with replacement):
    correlation between raters over the sampled items, reduced to
    (sum of finite pair correlations, count), each (n_boot,). `x` is
    (raters, items) float32; a rater with fewer than ``min_answered``
    answered items in the resample is left out of it."""
    n_raters, n_items = x.shape
    iu = torch.triu_indices(n_raters, n_raters, offset=1, device=x.device)
    rows = max(1, _CHUNK_ELEMS // max(1, n_items * n_raters * n_raters))
    sums, counts = [], []
    for ix in idx.split(rows):
        xs = x[:, ix].permute(1, 2, 0)                 # (rows, items, raters)
        if min_answered:
            valid = torch.isfinite(xs).sum(dim=1) >= min_answered
            xs = torch.where(valid[:, None, :], xs, torch.nan)
        vals = masked_pearson_matrix(xs)[:, iu[0], iu[1]]
        finite = torch.isfinite(vals)
        sums.append(torch.where(finite, vals, 0.0).sum(dim=1))
        counts.append(finite.sum(dim=1))
    return torch.cat(sums), torch.cat(counts)


def _bootstrap_group_means(
    matrices: Sequence[Optional[np.ndarray]],
    seed: int,
    words: Sequence[int],
    n_boot: int,
    min_answered: int,
    device="cuda",
) -> np.ndarray:
    """Per-iteration mean of the pooled (across groups) pair correlations —
    the quantity whose percentiles form the reference's CI (:417-470).
    ``matrices[k]`` (raters, items) or None is group ``GROUPS[k]``, whose
    resamples draw from ``generator_for(seed, 4, 0, *words, group)``."""
    dev = resolve_device(device)
    sums = np.zeros(n_boot)
    counts = np.zeros(n_boot)
    for group, matrix in zip(GROUPS, matrices):
        if matrix is None:
            continue
        idx = resample_indices(_gen(seed, *words, group), n_boot,
                               matrix.shape[1], dev)
        s, c = _boot_pair_sums(as_f32(matrix, dev), idx, min_answered)
        sums += s.cpu().numpy()
        counts += c.cpu().numpy()
    with np.errstate(invalid="ignore"):
        return np.where(counts > 0, sums / counts, np.nan)


def _cross_summary(group_results, all_corrs, boot_means) -> Dict[str, object]:
    finite = boot_means[np.isfinite(boot_means)]
    base_mean = float(np.mean(all_corrs)) if all_corrs else 0.0
    return {
        "group_results": group_results,
        "pairwise_correlations": all_corrs,
        "mean_correlation": base_mean,
        "std_correlation": float(np.std(all_corrs)) if all_corrs else 0.0,
        "n_pairs": len(all_corrs),
        "ci_lower": float(np.percentile(finite, 2.5)) if finite.size else base_mean,
        "ci_upper": float(np.percentile(finite, 97.5)) if finite.size else base_mean,
    }


def human_cross_prompt_correlations(
    clean_df: Table, seed: int = 42, n_bootstrap: int = 100, device="cuda",
) -> Dict[str, object]:
    """Within-group respondent-respondent correlations (:352-480)."""
    group_results: Dict[str, object] = {}
    all_corrs: List[float] = []
    matrices: List[Optional[np.ndarray]] = []
    for group in GROUPS:
        m = _human_group_matrix(clean_df, group)
        if m is None:
            matrices.append(None)
            continue
        vals = _rater_pair_values(m, min_answered=MIN_ANSWERED, device=device)
        n_valid = int((np.isfinite(m).sum(axis=1) >= MIN_ANSWERED).sum())
        if n_valid < 2:
            matrices.append(None)
            continue
        matrices.append(m)
        all_corrs.extend(vals.tolist())
        group_results[f"Group_{group}"] = {
            "n_respondents": n_valid,
            "n_pairs": int(vals.size),
            "mean_correlation": float(vals.mean()) if vals.size else 0.0,
            "correlations": vals.tolist(),
        }

    boot_means = _bootstrap_group_means(matrices, seed, (_HUMAN_CROSS,),
                                        n_bootstrap, MIN_ANSWERED, device)
    return _cross_summary(group_results, all_corrs, boot_means)


def llm_cross_prompt_correlations(
    llm_df: Table,
    matches: Dict[str, str],
    seed: int = 42,
    n_bootstrap: int = 100,
    device="cuda",
) -> Dict[str, object]:
    """Within-group model-model correlations (:482-594). The rater axis is
    models; resampling is over the group's prompts."""
    group_results: Dict[str, object] = {}
    all_corrs: List[float] = []
    matrices: List[Optional[np.ndarray]] = []
    for group in GROUPS:
        pivot = _llm_group_pivot(llm_df, matches, group)
        if pivot is None:
            matrices.append(None)
            continue
        vals = _rater_pair_values(pivot, device=device)
        # Kernel orientation: (raters=models, items=prompts).
        matrices.append(pivot.T)
        all_corrs.extend(vals.tolist())
        group_results[f"Group_{group}"] = {
            "n_prompts": int(pivot.shape[0]),
            "n_models": int(pivot.shape[1]),
            "n_pairs": int(vals.size),
            "mean_correlation": float(vals.mean()) if vals.size else 0.0,
            "correlations": vals.tolist(),
        }

    boot_means = _bootstrap_group_means(matrices, seed, (_LLM_CROSS,),
                                        n_bootstrap, 0, device)
    return _cross_summary(group_results, all_corrs, boot_means)


def cross_prompt_difference_ci(
    clean_df: Table,
    llm_df: Table,
    matches: Dict[str, str],
    seed: int = 42,
    n_bootstrap: int = 1000,
    device="cuda",
) -> Dict[str, object]:
    """Joint bootstrap of (human mean - LLM mean) cross-prompt correlation
    (:596-703) — both sides resampled independently inside each iteration."""
    human_mats = [_human_group_matrix(clean_df, g) for g in GROUPS]
    llm_mats = []
    for g in GROUPS:
        pivot = _llm_group_pivot(llm_df, matches, g)
        llm_mats.append(None if pivot is None else pivot.T)

    h_means = _bootstrap_group_means(human_mats, seed, (_DIFF_CI, 0),
                                     n_bootstrap, MIN_ANSWERED, device)
    l_means = _bootstrap_group_means(llm_mats, seed, (_DIFF_CI, 1),
                                     n_bootstrap, 0, device)
    diffs = h_means - l_means
    diffs = diffs[np.isfinite(diffs)]
    if diffs.size == 0:
        return {
            "mean_difference": None,
            "ci_lower": None,
            "ci_upper": None,
            "n_bootstrap": 0,
        }
    return {
        "mean_difference": float(np.mean(diffs)),
        "ci_lower": float(np.percentile(diffs, 2.5)),
        "ci_upper": float(np.percentile(diffs, 97.5)),
        "n_bootstrap": int(diffs.size),
    }


# ---------------------------------------------------------------------------
# Meta-correlation (:705-748)
# ---------------------------------------------------------------------------


def meta_correlation(
    human_agreements, llm_agreements, matches: Dict[str, str],
    generator: torch.Generator, n_bootstrap: int = 1000, device="cuda",
) -> Dict[str, object]:
    """Correlation between per-item agreement patterns of humans and LLMs."""
    h_vals, l_vals = [], []
    for llm_prompt, survey_q in matches.items():
        if (
            survey_q in human_agreements["per_item"]
            and llm_prompt in llm_agreements["per_item"]
        ):
            h_vals.append(human_agreements["per_item"][survey_q]["mean_agreement"])
            l_vals.append(llm_agreements["per_item"][llm_prompt]["mean_agreement"])

    base = {
        "n_matched_items": len(h_vals),
        "human_mean_agreement": human_agreements["overall_mean"],
        "human_std_agreement": human_agreements["overall_std"],
        "llm_mean_agreement": llm_agreements["overall_mean"],
        "llm_std_agreement": llm_agreements["overall_std"],
    }
    if len(h_vals) < 2:
        return {
            "correlation": None,
            **base,
            "interpretation": "Insufficient matched items for correlation",
        }
    res = bootstrap_correlation(
        np.asarray(h_vals), np.asarray(l_vals), generator,
        n_boot=n_bootstrap, device=device,
    )
    return {
        "correlation": res.estimate,
        "p_value": res.p_value,
        "ci_lower": res.ci_lower,
        "ci_upper": res.ci_upper,
        **base,
        "interpretation": "Correlation between human and LLM per-item agreement patterns",
    }


# ---------------------------------------------------------------------------
# Orchestration + report + JSON (:750-990)
# ---------------------------------------------------------------------------


def _to_native(obj):
    if isinstance(obj, dict):
        return {k: _to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_native(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def _llm_items(llm_df: Table) -> Dict[str, np.ndarray]:
    """prompt -> the finite first relative_prob of each model, in model
    order (the reference's per-prompt, per-model ``.values[0]``)."""
    first: Dict[tuple, float] = {}
    for p, m, r in zip(llm_df["prompt"], llm_df["model"],
                       np.asarray(llm_df["relative_prob"], dtype=float)):
        first.setdefault((p, m), r)
    models = llm_df.unique("model")
    out: Dict[str, np.ndarray] = {}
    for prompt in llm_df.unique("prompt"):
        vals = [first[(prompt, m)] for m in models if (prompt, m) in first]
        out[prompt] = np.asarray([float(v) for v in vals if not np.isnan(v)])
    return out


def run_consolidated_analysis(
    clean_df: Table,
    question_cols: List[str],
    llm_df: Table,
    matches: Dict[str, str],
    exclusion_stats: Dict[str, float],
    seed: int = 42,
    n_bootstrap_standard: int = 1000,
    n_bootstrap_small: int = 100,
    device="cuda",
) -> Dict[str, object]:
    """The full consolidated pipeline (main(), :925-990), returning every
    intermediate block keyed as the reference's local variables."""
    dev = resolve_device(device)

    human_stats = human_responses_by_question(clean_df, question_cols)
    llm_stats = llm_responses_by_question(llm_df)
    human_llm_corr = human_llm_correlation(
        human_stats, llm_stats, matches, _gen(seed, _HUMAN_CORR),
        n_bootstrap_standard, dev,
    )

    human_items = {}
    for q in question_cols:
        if not q.endswith("_8"):
            v = np.asarray(clean_df[q], dtype=float)
            human_items[q] = v[~np.isnan(v)]
    human_item_agreement = per_item_agreement(
        human_items, scale=100.0, generator=_gen(seed, _HUMAN_ITEMS),
        n_boot=n_bootstrap_standard, count_key="n_responses", device=dev,
    )
    llm_item_agreement = per_item_agreement(
        _llm_items(llm_df), scale=1.0, generator=_gen(seed, _LLM_ITEMS),
        n_boot=n_bootstrap_standard, count_key="n_models", device=dev,
    )

    human_cross = human_cross_prompt_correlations(
        clean_df, seed, n_bootstrap_small, dev
    )
    llm_cross = llm_cross_prompt_correlations(
        llm_df, matches, seed, n_bootstrap_small, dev
    )
    diff_ci = cross_prompt_difference_ci(
        clean_df, llm_df, matches, seed, n_bootstrap_standard, dev
    )
    meta = meta_correlation(
        human_item_agreement, llm_item_agreement, matches,
        _gen(seed, _META), n_bootstrap_standard, dev,
    )

    return {
        "exclusion_stats": exclusion_stats,
        "human_stats": human_stats,
        "llm_stats": llm_stats,
        "matches": matches,
        "human_llm_correlation": human_llm_corr,
        "human_item_agreement": human_item_agreement,
        "llm_item_agreement": llm_item_agreement,
        "human_cross_prompt": human_cross,
        "llm_cross_prompt": llm_cross,
        "cross_prompt_difference": diff_ci,
        "meta_correlation": meta,
    }
def consolidated_results_payload(analysis: Dict[str, object]) -> Dict[str, object]:
    """The D8 ``consolidated_analysis_results.json`` schema (save_results,
    :857-918) built from `run_consolidated_analysis` output."""
    hc = analysis["human_llm_correlation"]
    hia = analysis["human_item_agreement"]
    lia = analysis["llm_item_agreement"]
    hcp = analysis["human_cross_prompt"]
    lcp = analysis["llm_cross_prompt"]
    dci = analysis["cross_prompt_difference"]
    meta = analysis["meta_correlation"]
    payload = {
        "exclusion_stats": analysis["exclusion_stats"],
        "matching_stats": {
            "n_human_questions": len(analysis["human_stats"]),
            "n_llm_prompts": len(analysis["llm_stats"]),
            "n_matched": len(analysis["matches"]),
            "matches": analysis["matches"],
        },
        "human_llm_correlation": {
            "correlation": hc["correlation"] if hc else None,
            "ci_lower": hc["ci_lower"] if hc else None,
            "ci_upper": hc["ci_upper"] if hc else None,
            "standard_error": hc["standard_error"] if hc else None,
            "p_value": hc["p_value"] if hc else None,
            "n_questions": hc["n_questions"] if hc else 0,
        },
        "per_item_agreement": {
            "human": {
                "overall_mean": hia["overall_mean"],
                "overall_mean_ci_lower": hia.get("overall_mean_ci_lower", 0),
                "overall_mean_ci_upper": hia.get("overall_mean_ci_upper", 0),
                "overall_std": hia["overall_std"],
                "n_items": hia["n_items"],
                "per_item_details": hia["per_item"],
            },
            "llm": {
                "overall_mean": lia["overall_mean"],
                "overall_mean_ci_lower": lia.get("overall_mean_ci_lower", 0),
                "overall_mean_ci_upper": lia.get("overall_mean_ci_upper", 0),
                "overall_std": lia["overall_std"],
                "n_items": lia["n_items"],
                "per_item_details": lia["per_item"],
            },
        },
        "meta_correlation": meta if meta else {},
        "cross_prompt_correlations": {
            "human": {
                "mean_correlation": hcp["mean_correlation"] if hcp else None,
                "ci_lower": hcp["ci_lower"] if hcp else None,
                "ci_upper": hcp["ci_upper"] if hcp else None,
                "std_correlation": hcp["std_correlation"] if hcp else None,
                "n_pairs": hcp["n_pairs"] if hcp else None,
            },
            "llm": {
                "mean_correlation": lcp["mean_correlation"] if lcp else None,
                "ci_lower": lcp["ci_lower"] if lcp else None,
                "ci_upper": lcp["ci_upper"] if lcp else None,
                "std_correlation": lcp["std_correlation"] if lcp else None,
                "n_pairs": lcp["n_pairs"] if lcp else None,
            },
            "difference": {
                "mean_difference": dci["mean_difference"] if dci else None,
                "ci_lower": dci["ci_lower"] if dci else None,
                "ci_upper": dci["ci_upper"] if dci else None,
                "n_bootstrap": dci["n_bootstrap"] if dci else None,
            },
        },
    }
    return _to_native(payload)


def save_consolidated_results(analysis: Dict[str, object], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(consolidated_results_payload(analysis), indent=2))


def format_report(analysis: Dict[str, object]) -> str:
    """The comprehensive stdout report (generate_comprehensive_report,
    :750-855), returned as a string so callers choose the sink."""
    ex = analysis["exclusion_stats"]
    hc = analysis["human_llm_correlation"]
    hia = analysis["human_item_agreement"]
    lia = analysis["llm_item_agreement"]
    hcp = analysis["human_cross_prompt"]
    lcp = analysis["llm_cross_prompt"]
    dci = analysis["cross_prompt_difference"]
    meta = analysis["meta_correlation"]

    lines = []
    bar = "=" * 80
    sub = "-" * 80
    lines += [
        "",
        bar,
        "CONSOLIDATED SURVEY ANALYSIS - HUMAN vs LLM ORDINARY MEANING AGREEMENT",
        bar,
        "",
        "EXCLUSION STATISTICS:",
        f"  Initial respondents: {ex['final_count'] + ex['total_excluded']}",
        f"  Excluded for short duration: {ex['duration_excluded']}",
        f"  Excluded for identical responses: {ex['identical_excluded']}",
        f"  Excluded for attention check failure: {ex['attention_failed']}",
        f"  Total excluded: {ex['total_excluded']}",
        f"  Final sample size: {ex['final_count']}",
        "",
        sub,
        "QUESTION MATCHING:",
        f"  Total survey questions: {len(analysis['human_stats'])}",
        f"  Total LLM prompts: {len(analysis['llm_stats'])}",
        f"  Successfully matched: {len(analysis['matches'])}",
        "",
        sub,
        "HUMAN-LLM CORRELATION (Question-Level Agreement):",
    ]
    if hc:
        lines += [
            f"  Pearson correlation: {hc['correlation']:.3f}",
            f"  95% CI: [{hc['ci_lower']:.3f}, {hc['ci_upper']:.3f}]",
            f"  Standard error: {hc['standard_error']:.3f}",
            f"  p-value: {hc['p_value']:.4f}",
            f"  Number of questions: {hc['n_questions']}",
        ]
    else:
        lines.append("  Insufficient matched questions for correlation")

    lines += [
        "",
        sub,
        "PER-ITEM AGREEMENT (Average agreement between raters for each item):",
        "",
        "  Human per-item agreement:",
        f"    Mean agreement across items: {hia['overall_mean']:.3f}",
        f"    95% CI: [{hia.get('overall_mean_ci_lower', 0):.3f}, "
        f"{hia.get('overall_mean_ci_upper', 0):.3f}]",
        f"    Std across items: {hia['overall_std']:.3f}",
        f"    Number of items: {hia['n_items']}",
        "",
        "  LLM per-item agreement:",
        f"    Mean agreement across items: {lia['overall_mean']:.3f}",
        f"    95% CI: [{lia.get('overall_mean_ci_lower', 0):.3f}, "
        f"{lia.get('overall_mean_ci_upper', 0):.3f}]",
        f"    Std across items: {lia['overall_std']:.3f}",
        f"    Number of items: {lia['n_items']}",
        "",
        sub,
        "CROSS-PROMPT CORRELATIONS (How similarly raters rank items):",
    ]
    if hcp:
        lines += [
            "",
            "  Human cross-prompt correlations (within groups):",
            f"    Mean correlation between respondent pairs: {hcp['mean_correlation']:.3f}",
            f"    95% CI: [{hcp['ci_lower']:.3f}, {hcp['ci_upper']:.3f}]",
            f"    Std of correlations: {hcp['std_correlation']:.3f}",
            f"    Number of respondent pairs: {hcp['n_pairs']}",
        ]
        for group, gstats in sorted(hcp["group_results"].items()):
            lines.append(
                f"    {group}: {gstats['n_respondents']} respondents, "
                f"mean corr = {gstats['mean_correlation']:.3f}"
            )
    if lcp:
        lines += [
            "",
            "  LLM cross-prompt correlations (within groups):",
            f"    Mean correlation between model pairs: {lcp['mean_correlation']:.3f}",
            f"    95% CI: [{lcp['ci_lower']:.3f}, {lcp['ci_upper']:.3f}]",
            f"    Std of correlations: {lcp['std_correlation']:.3f}",
            f"    Number of model pairs: {lcp['n_pairs']}",
        ]
        for group, gstats in sorted(lcp["group_results"].items()):
            lines.append(
                f"    {group}: {gstats['n_prompts']} prompts, "
                f"{gstats['n_models']} models, mean corr = "
                f"{gstats['mean_correlation']:.3f}"
            )
    if dci and dci["mean_difference"] is not None and hcp and lcp:
        lines += [
            "",
            "  Difference in cross-prompt correlations (Human - LLM):",
            f"    Mean difference: {dci['mean_difference']:.3f}",
            f"    95% CI: [{dci['ci_lower']:.3f}, {dci['ci_upper']:.3f}]",
            f"    Bootstrap iterations: {dci['n_bootstrap']}",
        ]

    lines += ["", sub, "META-CORRELATION (Agreement Pattern Comparison):"]
    if meta:
        if meta["correlation"] is not None:
            lines += [
                f"  Correlation between human and LLM per-item agreement "
                f"patterns: {meta['correlation']:.3f}",
                f"  95% CI: [{meta['ci_lower']:.3f}, {meta['ci_upper']:.3f}]",
                f"  p-value: {meta['p_value']:.4f}",
                f"  Number of matched items: {meta['n_matched_items']}",
            ]
        else:
            lines.append(f"  {meta['interpretation']}")
        lines += [
            "",
            f"  Human mean per-item agreement: {meta['human_mean_agreement']:.3f}",
            f"  LLM mean per-item agreement: {meta['llm_mean_agreement']:.3f}",
        ]

    lines += ["", sub, "INTERPRETATION:"]
    if hc:
        strength = (
            "strong"
            if abs(hc["correlation"]) > 0.7
            else "moderate"
            if abs(hc["correlation"]) > 0.4
            else "weak"
        )
        lines += [
            "",
            f"The correlation between average human and LLM responses is "
            f"{hc['correlation']:.3f},",
            f"indicating {strength} agreement",
            "between humans and LLMs on ordinary meaning judgments.",
        ]
    if meta:
        more = (
            "humans"
            if hia["overall_mean"] > lia["overall_mean"]
            else "LLMs"
        )
        lines += [
            "",
            "The per-item agreement patterns show that humans have",
            f"mean agreement of {hia['overall_mean']:.3f} compared to LLMs' "
            f"{lia['overall_mean']:.3f},",
            f"suggesting {more} are more consistent in their ordinary meaning "
            "judgments.",
        ]
    lines += ["", bar]
    return "\n".join(lines)
