"""Human-LLM agreement metrics: point estimates and question-resampled
bootstrap (C39/C41), plus the D9 ``llm_human_agreement_bootstrap.json`` writer.

Port of ``lir_tpu/survey/human_llm.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity targets:
  - survey_analysis/analyze_llm_human_agreement.py:94-316 (point metrics:
    MAE/RMSE/MAPE/Pearson/Spearman per model, worst-disagreement questions,
    per-question across-model variance, ``llm_human_agreement_analysis.json``)
  - survey_analysis/analyze_llm_agreement_simple_bootstrap.py:90-480
    (question-resampled bootstrap, n=1000; overall base-vs-instruct
    comparison with 10,000-fold bootstrap CI and permutation p-value;
    matched-pairs normal-approximation test; D9 JSON)

Each model is reduced once to aligned (human, model, valid) vectors over
the 50 canonical questions, and all resamples evaluate as one batched
reduction on ``device`` (:func:`_boot_metrics`, float32 as in the JAX
package). A reference quirk preserved deliberately: membership of a
question in a bootstrap sample is tested with ``in sampled_questions``
(analyze_llm_agreement_simple_bootstrap.py:101), so duplicate draws do
NOT up-weight a question — the resample acts as a random subset. The
reduction reproduces exactly that through a boolean membership mask.

Random draws (CPU generators, ``stats.core.generator_for``): model j of
the bootstrap's job list (the D1 models, then the D2 models, as the JAX
package lists them) from ``(seed, 4, 1, j)``; the D9 payload's overall
comparison of metric m (mae, mse, mape) from ``(seed, 4, 2, m, part)``,
part 0 and 1 the two groups' bootstrap means, 2 the permutations.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import stats as scipy_stats

from ..data.table import Table
from ..device import resolve_device
from ..stats.bootstrap import bootstrap_mean_ci, permutation_test_difference
from ..stats.core import as_f32, generator_for, resample_indices

SURVEY_WORD = 4          # the survey's word in generator_for's seeding
_BOOT_WORD, _DIFF_WORD = 1, 2
_METRICS = ("mae", "mse", "mape")


# ---------------------------------------------------------------------------
# Data alignment
# ---------------------------------------------------------------------------


def relative_prob_series(df: Table) -> np.ndarray:
    """The unified readout: ``relative_prob`` when present (D2), else
    yes/(yes+no) with 0.5 fallback where the mass is not positive (a NaN
    mass included, as pandas' ``where(total > 0, 0.5)``) (D1) — the
    column-handling branch at analyze_llm_human_agreement.py:102-106."""
    if "relative_prob" in df:
        return np.asarray(df["relative_prob"], dtype=float)
    yes = np.asarray(df["yes_prob"], dtype=float)
    total = yes + np.asarray(df["no_prob"], dtype=float)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = yes / total
        return np.where(total > 0, rel, 0.5)


def human_averages_from_detailed(
    detailed: Dict[str, object], question_mapping: Dict[str, str]
) -> Dict[str, float]:
    """prompt -> human mean on the 0-1 scale (mean_response / 100)."""
    by_q = detailed["results"]["by_question"]
    return {
        prompt: by_q[qid]["mean_response"] / 100.0
        for prompt, qid in question_mapping.items()
        if qid in by_q
    }


def aligned_vectors(
    model_df: Table, human_averages: Dict[str, float]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """(human, model, valid) aligned over the canonical question order.

    `valid` marks questions the model answered with a finite probability
    (a prompt's last row wins, as ``dict(zip(...))``).
    """
    questions = list(human_averages.keys())
    rel = relative_prob_series(model_df)
    by_prompt = dict(zip(model_df["prompt"], rel))
    h = np.asarray([human_averages[q] for q in questions], dtype=float)
    m = np.asarray(
        [by_prompt.get(q, np.nan) for q in questions], dtype=float
    )
    valid = np.isfinite(m)
    return h, m, valid, questions


# ---------------------------------------------------------------------------
# Point metrics (C39)
# ---------------------------------------------------------------------------


def agreement_metrics(
    model_df: Table,
    model_name: str,
    human_averages: Dict[str, float],
    min_questions: int = 10,
) -> Optional[Dict[str, object]]:
    """MAE/RMSE/MAPE/Pearson/Spearman between one model's relative
    probabilities and human averages (calculate_agreement_metrics,
    analyze_llm_human_agreement.py:94-148)."""
    h, m, valid, questions = aligned_vectors(model_df, human_averages)
    h, m = h[valid], m[valid]
    qs = [q for q, v in zip(questions, valid) if v]
    if h.size < min_questions:
        return None

    diff = np.abs(h - m)
    mae = float(diff.mean())
    rmse = float(np.sqrt(((h - m) ** 2).mean()))
    with np.errstate(divide="ignore", invalid="ignore"):
        mape = float(np.mean(np.abs((h - m) / h)) * 100)
    pearson_r, pearson_p = scipy_stats.pearsonr(h, m)
    spearman_r, spearman_p = scipy_stats.spearmanr(h, m)

    order = np.argsort(-diff)
    worst = [
        {
            "prompt": qs[i],
            "human_avg": float(h[i]),
            "model_prob": float(m[i]),
            "difference": float(diff[i]),
        }
        for i in order[:5]
    ]
    return {
        "model": model_name,
        "n_questions": int(h.size),
        "mae": mae,
        "rmse": rmse,
        "mape": mape,
        "pearson_r": float(pearson_r),
        "pearson_p": float(pearson_p),
        "spearman_r": float(spearman_r),
        "spearman_p": float(spearman_p),
        "worst_questions": worst,
        "matched": {"human_avg": h, "model_prob": m, "prompts": qs},
    }


def analyze_all_models(
    human_averages: Dict[str, float],
    instruct_df: Table,
    base_df: Optional[Table] = None,
) -> List[Dict[str, object]]:
    """Per-model point metrics across both CSVs, sorted by MAE ascending."""
    results = []
    for df, model_type in ((instruct_df, "instruct"), (base_df, "base")):
        if df is None:
            continue
        for model in df.unique("model"):
            r = agreement_metrics(df.where("model", model), model,
                                  human_averages)
            if r:
                r["model_type"] = model_type
                results.append(r)
    results.sort(key=lambda x: x["mae"])
    return results


def question_variance(
    all_results: List[Dict[str, object]], human_averages: Dict[str, float]
) -> Dict[str, Dict[str, float]]:
    """Across-model response variance per question
    (analyze_llm_human_agreement.py:265-288)."""
    out: Dict[str, Dict[str, float]] = {}
    for prompt, h_avg in human_averages.items():
        probs = []
        for r in all_results:
            matched = r["matched"]
            if prompt in matched["prompts"]:
                probs.append(
                    matched["model_prob"][matched["prompts"].index(prompt)])
        if probs:
            out[prompt] = {
                "human_avg": float(h_avg),
                "model_mean": float(np.mean(probs)),
                "model_std": float(np.std(probs)),
                "n_models": len(probs),
            }
    return out


def write_agreement_analysis(
    all_results: List[Dict[str, object]],
    human_averages: Dict[str, float],
    path: Path,
) -> Dict[str, object]:
    """``llm_human_agreement_analysis.json`` (analyze_llm_human_agreement.py:
    291-310)."""
    payload = {
        "analysis_type": "llm_human_agreement",
        "description": "Comparison of LLM outputs to human average ratings per question",
        "model_results": [
            {
                "model": r["model"],
                "model_type": r["model_type"],
                "mae": r["mae"],
                "rmse": r["rmse"],
                "mape": r["mape"],
                "pearson_r": r["pearson_r"],
                "n_questions": r["n_questions"],
            }
            for r in all_results
        ],
        "question_variance": question_variance(all_results, human_averages),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    return payload


# ---------------------------------------------------------------------------
# Question-resampled bootstrap (C41)
# ---------------------------------------------------------------------------


def _boot_metrics(h: torch.Tensor, m: torch.Tensor, valid: torch.Tensor,
                  idx: torch.Tensor):
    """All bootstrap iterations at once: for each row of ``idx`` select the
    UNIQUE sampled questions (membership semantics, see the module
    docstring) intersected with ``valid``, then (mae, mse, mape, pearson,
    n), each (n_boot,). ``h``/``m`` float32 (m zero where invalid)."""
    sel = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    sel.scatter_(1, idx, True)
    sel &= valid
    n = sel.sum(dim=1)
    nf = torch.clamp_min(n, 1).to(h.dtype)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    d = torch.where(sel, h - m, zero)
    mae = d.abs().sum(dim=1) / nf
    mse = (d * d).sum(dim=1) / nf

    ape = torch.abs((h - m) / torch.where(h == 0, torch.nan, h))
    ape_ok = sel & torch.isfinite(ape)
    n_ape = ape_ok.sum(dim=1)
    mape = torch.where(
        n_ape > 0,
        torch.where(ape_ok, ape, zero).sum(dim=1)
        / torch.clamp_min(n_ape, 1).to(h.dtype) * 100.0,
        torch.nan,
    )

    hm = torch.where(sel, h, zero).sum(dim=1, keepdim=True) / nf[:, None]
    mm = torch.where(sel, m, zero).sum(dim=1, keepdim=True) / nf[:, None]
    dh = torch.where(sel, h - hm, zero)
    dm = torch.where(sel, m - mm, zero)
    denom = torch.sqrt((dh * dh).sum(dim=1) * (dm * dm).sum(dim=1))
    pearson = torch.where(denom > 0, (dh * dm).sum(dim=1) / denom, torch.nan)
    return mae, mse, mape, pearson, n


def bootstrap_agreement_metrics(
    model_df: Table,
    human_averages: Dict[str, float],
    generator: torch.Generator,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    min_questions: int = 10,
    min_successful: int = 100,
    device="cuda",
) -> Optional[Dict[str, float]]:
    """Bootstrap-over-questions CIs for one model's agreement metrics
    (analyze_llm_agreement_simple_bootstrap.py:151-212)."""
    dev = resolve_device(device)
    h, m, valid, _ = aligned_vectors(model_df, human_averages)
    n_q = h.shape[0]
    idx = resample_indices(generator, n_bootstrap, n_q, dev)
    mae_s, mse_s, mape_s, r_s, n_s = (
        t.cpu().numpy() for t in _boot_metrics(
            as_f32(h, dev), as_f32(np.where(valid, m, 0.0), dev),
            torch.from_numpy(valid).to(dev), idx))
    ok = n_s >= min_questions
    if ok.sum() < min_successful:
        return None

    alpha = 1 - confidence
    metrics: Dict[str, float] = {"n_bootstrap": int(ok.sum())}
    for name, samples in (
        ("mae", mae_s), ("mse", mse_s), ("mape", mape_s), ("pearson_r", r_s)
    ):
        vals = samples[ok]
        vals = vals[np.isfinite(vals)]
        if vals.size:
            metrics[f"{name}_mean"] = float(np.mean(vals))
            metrics[f"{name}_ci_lower"] = float(
                np.percentile(vals, alpha / 2 * 100))
            metrics[f"{name}_ci_upper"] = float(
                np.percentile(vals, (1 - alpha / 2) * 100)
            )
            metrics[f"{name}_std"] = float(np.std(vals))
        else:
            for suffix in ("mean", "ci_lower", "ci_upper", "std"):
                metrics[f"{name}_{suffix}"] = float("nan")
    return metrics


def bootstrap_all_models(
    human_averages: Dict[str, float],
    instruct_df: Table,
    base_df: Optional[Table],
    seed: int = 42,
    n_bootstrap: int = 1000,
    device="cuda",
) -> List[Dict[str, object]]:
    """All models' bootstrap metrics, base models first (reference order:
    analyze_llm_agreement_simple_bootstrap.py:163-166), sorted by MAE.
    Job j draws from ``generator_for(seed, 4, 1, j)``."""
    dev = resolve_device(device)
    jobs = []
    if base_df is not None:
        jobs += [(m, "base", base_df) for m in base_df.unique("model")]
    jobs += [(m, "instruct", instruct_df)
             for m in instruct_df.unique("model")]

    results = []
    # The reference demands >= 100 successful iterations (:187); scale the
    # gate down proportionally when running with reduced budgets.
    min_successful = min(100, max(1, n_bootstrap // 10))
    for j, (model, model_type, src) in enumerate(jobs):
        metrics = bootstrap_agreement_metrics(
            src.where("model", model), human_averages,
            generator_for(seed, SURVEY_WORD, _BOOT_WORD, j), n_bootstrap,
            min_successful=min_successful, device=dev,
        )
        if metrics is None:
            continue
        results.append({"model": model, "model_type": model_type, **metrics})
    results.sort(key=lambda x: x["mae_mean"])
    return results


# ---------------------------------------------------------------------------
# Group difference statistics (C41 overall comparison)
# ---------------------------------------------------------------------------


def difference_stats(
    group1: Sequence[float],
    group2: Sequence[float],
    generators: Sequence[torch.Generator],
    n_bootstrap: int = 10_000,
    device="cuda",
) -> Tuple[float, float, float, float]:
    """(observed diff, ci_lower, ci_upper, permutation p) for
    mean(group1) - mean(group2) — calculate_difference_stats
    (analyze_llm_agreement_simple_bootstrap.py:312-347). Composed from the
    port's ``stats`` bootstraps; ``generators`` are the three draws' (the
    two groups' bootstrap means, the permutations)."""
    a = np.asarray(group1, dtype=float)
    b = np.asarray(group2, dtype=float)

    g1, g2, g3 = generators
    means_a = bootstrap_mean_ci(a, g1, n_boot=n_bootstrap,
                                device=device).samples
    means_b = bootstrap_mean_ci(b, g2, n_boot=n_bootstrap,
                                device=device).samples
    diffs = means_a - means_b
    ci_lower = float(np.percentile(diffs, 2.5))
    ci_upper = float(np.percentile(diffs, 97.5))

    perm = permutation_test_difference(a, b, g3, n_perm=n_bootstrap,
                                       device=device)
    return perm["observed_difference"], ci_lower, ci_upper, perm["p_value"]


DEFAULT_FAMILIES: Dict[str, Tuple[str, str]] = {
    "Falcon": ("tiiuae/falcon-7b", "tiiuae/falcon-7b-instruct"),
    "StableLM": (
        "stabilityai/stablelm-base-alpha-7b",
        "stabilityai/stablelm-tuned-alpha-7b",
    ),
    "RedPajama": (
        "togethercomputer/RedPajama-INCITE-7B-Base",
        "togethercomputer/RedPajama-INCITE-7B-Instruct",
    ),
}


def matched_pairs_analysis(
    all_results: List[Dict[str, object]],
    families: Optional[Dict[str, Sequence[str]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Paired instruct-base differences per family with a normal-approx
    paired test (analyze_llm_agreement_simple_bootstrap.py:392-444)."""
    pairs = []
    families = families or DEFAULT_FAMILIES
    for family, models in families.items():
        base = instruct = None
        for r in all_results:
            if r["model"] in models:
                name = r["model"].lower()
                if "instruct" in name or "tuned" in name:
                    instruct = r
                else:
                    base = r
        if base and instruct:
            pairs.append({"family": family, "base": base, "instruct": instruct})

    out: Dict[str, Dict[str, float]] = {}
    for metric in _METRICS:
        diffs = [
            p["instruct"][f"{metric}_mean"] - p["base"][f"{metric}_mean"]
            for p in pairs
        ]
        if not diffs:
            continue
        mean_diff = float(np.mean(diffs))
        se = float(np.std(diffs) / np.sqrt(len(diffs)))
        t = mean_diff / se if se > 0 else 0.0
        p = float(2 * (1 - scipy_stats.norm.cdf(abs(t))))
        out[metric] = {
            "per_family": {
                pr["family"]: float(d) for pr, d in zip(pairs, diffs)
            },
            "mean_difference": mean_diff,
            "ci_lower": mean_diff - 1.96 * se,
            "ci_upper": mean_diff + 1.96 * se,
            "p_value": p,
        }
    return out


def bootstrap_results_payload(
    all_results: List[Dict[str, object]],
    seed: int = 42,
    n_bootstrap: int = 1000,
    n_diff_bootstrap: int = 10_000,
    device="cuda",
) -> Dict[str, object]:
    """The D9 ``llm_human_agreement_bootstrap.json`` schema
    (analyze_llm_agreement_simple_bootstrap.py:447-477). Metric m's
    difference statistics draw from ``generator_for(seed, 4, 2, m, part)``."""
    device = resolve_device(device)
    base = [r for r in all_results if r["model_type"] == "base"]
    instruct = [r for r in all_results if r["model_type"] == "instruct"]
    payload: Dict[str, object] = {
        "analysis_type": "llm_human_agreement_bootstrap_questions",
        "description": (
            "Comparison of LLM outputs to human average ratings with "
            "bootstrap confidence intervals (sampling questions)"
        ),
        "bootstrap_parameters": {
            "n_iterations": n_bootstrap,
            "confidence_level": 0.95,
            "bootstrap_method": "questions_with_replacement",
        },
        "model_results": [
            {k: v for k, v in r.items()} for r in all_results
        ],
        "overall_comparison": {
            "base_models_count": len(base),
            "instruct_models_count": len(instruct),
            "metrics": {},
        },
    }
    for m_idx, metric in enumerate(_METRICS):
        b_vals = [
            r[f"{metric}_mean"] for r in base if np.isfinite(r[f"{metric}_mean"])
        ]
        i_vals = [
            r[f"{metric}_mean"]
            for r in instruct
            if np.isfinite(r[f"{metric}_mean"])
        ]
        if not b_vals or not i_vals:
            continue
        gens = [generator_for(seed, SURVEY_WORD, _DIFF_WORD, m_idx, part)
                for part in range(3)]
        diff, lo, hi, p = difference_stats(b_vals, i_vals, gens,
                                           n_diff_bootstrap, device=device)
        payload["overall_comparison"]["metrics"][metric] = {
            "base_mean": float(np.mean(b_vals)),
            "base_ci": [
                float(np.percentile(b_vals, 2.5)),
                float(np.percentile(b_vals, 97.5)),
            ],
            "instruct_mean": float(np.mean(i_vals)),
            "instruct_ci": [
                float(np.percentile(i_vals, 2.5)),
                float(np.percentile(i_vals, 97.5)),
            ],
            "difference": diff,
            "difference_ci": [lo, hi],
            "p_value": p,
        }
    return payload


def write_bootstrap_results(payload: Dict[str, object], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))


def llm_prompt_estimates_from_accum(acc, n_boot: int = 1000,
                                    confidence: float = 0.95,
                                    device="cuda"
                                    ) -> Dict[int, Dict[str, float]]:
    """Axis-3 entry point consuming the streaming accumulator DIRECTLY
    (``engine/stream_stats.StreamSink.snapshot()``, a
    ``stats.streaming.HostAccum``): per-prompt mean relative probability +
    seeded bootstrap CI — the LLM side of the human-vs-LLM comparison,
    available live mid-sweep without a results CSV reload. The resample
    indices come from ``generator_for(acc.seed, prompt)`` (the
    accumulator's recorded manifest seed), so estimates are reproducible
    across resume and match a CSV-reload replay
    (``stats.streaming.accum_from_rows``)."""
    from ..stats import streaming as streaming_mod

    device = resolve_device(device)
    out: Dict[int, Dict[str, float]] = {}
    for p in range(acc.filled.shape[0]):
        values = streaming_mod.prompt_values(acc, "rel", p)
        if values.size == 0:
            continue
        entry: Dict[str, float] = {
            "estimate": float(values.mean()),
            "n": int(values.size),
        }
        entry.update(streaming_mod.bootstrap_mean_ci_seeded(
            values, acc.seed, p, n_boot, confidence, device=device))
        out[p] = entry
    return out
