"""Simulated-individual human-model correlation bootstrap (C38).

Port of ``lir_tpu/survey/simulated.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity target:
survey_analysis/bootstrap_confidence_intervals.py:54-311 — simulate
individual humans from per-question (mean, std) as clip(N(mu, sigma), 0,
1), correlate each simulated human with each model over a random survey
group, and bootstrap (10,000 iterations x 100 samples) the base-vs-instruct
mean correlation difference; plus per-model 1000-fold CIs and six
hard-coded family comparisons.

All (n_iterations x n_samples) simulated humans of one model are one
batch: a uniform group index and ten standard normals a draw, drawn at
once on a CPU generator (so the card and the CPU share them) and moved
to ``device``, where the masked Pearson against the model's group vector
runs in chunks of draws (:func:`_simulated_correlations`) and the
bootstrap's per-iteration sums and counts are reduced; the host reads
them once a model.

Sampling-validity semantics preserved exactly (:82-97): a (model, group)
pair contributes only when >= 8 of the group's questions are matched AND none
of the model's matched probabilities is NaN; otherwise every draw of that
group is rejected for that model, exactly as the reference's
``any(np.isnan(model_vals))`` rejection does.

Random draws: model k (in the D1's order of first appearance) draws its
base correlations from ``generator_for(seed, 4, 4, k, 0)``, its bootstrap
from ``(seed, 4, 4, k, 1)`` and its per-model CI resamples from ``(seed,
4, 4, k, 2)``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.table import Table, is_missing
from ..device import resolve_device
from ..stats.core import as_f32, generator_for, resample_indices
from .human_llm import SURVEY_WORD
from .loader import GROUPS, group_question_ids

_WORD = 4
_BASE, _BOOT, _PER_MODEL = 0, 1, 2
MIN_MATCHED_QUESTIONS = 8  # bootstrap_confidence_intervals.py:91
# Draws a chunk of the masked Pearson: ~10 float32 (draws, 10) temporaries.
_CHUNK_DRAWS = 1 << 18


def model_group_tensors(
    model_df: Table,
    question_mapping: Dict[str, str],
    detailed: Dict[str, object],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-group aligned tensors for one model.

    Returns (means, stds, model_vals, usable):
      means/stds: (5, 10) human per-question moments on the 0-1 scale
      model_vals: (5, 10) model relative probabilities (NaN where unmatched)
      usable:     (5,) bool — group passes the >=8-matched / no-NaN gate
    """
    by_q = detailed["results"]["by_question"]
    qid_to_prompt = {qid: p for p, qid in question_mapping.items()}
    rel_by_prompt: Dict[str, float] = {}
    for row in model_df.records():
        if "relative_prob" in row:
            rel = row["relative_prob"]
        else:
            total = row["yes_prob"] + row["no_prob"]
            rel = row["yes_prob"] / total if total > 0 else float("nan")
        rel_by_prompt[row["prompt"]] = (float("nan") if is_missing(rel)
                                        else float(rel))

    n_g = len(GROUPS)
    means = np.full((n_g, 10), np.nan)
    stds = np.full((n_g, 10), np.nan)
    vals = np.full((n_g, 10), np.nan)
    matched = np.zeros((n_g, 10), dtype=bool)
    has_nan = np.zeros(n_g, dtype=bool)
    for gi, group in enumerate(GROUPS):
        for qi, qid in enumerate(group_question_ids(group)):
            prompt = qid_to_prompt.get(qid)
            if prompt is None or prompt not in rel_by_prompt or qid not in by_q:
                continue
            matched[gi, qi] = True
            means[gi, qi] = by_q[qid]["mean_response"] / 100.0
            stds[gi, qi] = by_q[qid]["std_response"] / 100.0
            v = rel_by_prompt[prompt]
            vals[gi, qi] = v
            if not np.isfinite(v):
                has_nan[gi] = True
    usable = (matched.sum(axis=1) >= MIN_MATCHED_QUESTIONS) & ~has_nan
    return means, stds, vals, usable


def _simulated_draws(generator: torch.Generator, n_draws: int,
                     n_groups: int, n_questions: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group index (n_draws,) int64, standard normals (n_draws,
    n_questions) float32), drawn on the CPU in that order."""
    g = torch.randint(0, n_groups, (n_draws,), generator=generator,
                      dtype=torch.int64)
    z = torch.randn((n_draws, n_questions), generator=generator,
                    dtype=torch.float32)
    return g, z


def _simulated_correlations(g: torch.Tensor, z: torch.Tensor,
                            means: torch.Tensor, stds: torch.Tensor,
                            model_vals: torch.Tensor,
                            usable: torch.Tensor) -> torch.Tensor:
    """(n_draws,) correlations between simulated humans and the model.

    Draw i: group ``g[i]``, the simulated human clip(mean + std * z[i], 0,
    1) on each matched question, masked Pearson against the model's
    values. Draws whose group is unusable come back NaN (the caller drops
    them), mirroring the reference's rejected samples. float32 on the
    tensors' device, in chunks of draws."""
    out = []
    for gs, zs in zip(g.split(_CHUNK_DRAWS), z.split(_CHUNK_DRAWS)):
        mu, sigma, mv = means[gs], stds[gs], model_vals[gs]
        mask = torch.isfinite(mv) & torch.isfinite(mu)
        h = torch.clip(mu + sigma * zs, 0.0, 1.0)
        n = torch.clamp_min(mask.to(h.dtype).sum(dim=1, keepdim=True), 1.0)
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        hm = torch.where(mask, h, zero).sum(dim=1, keepdim=True) / n
        mm = torch.where(mask, mv, zero).sum(dim=1, keepdim=True) / n
        dh = torch.where(mask, h - hm, zero)
        dm = torch.where(mask, mv - mm, zero)
        denom = torch.sqrt((dh * dh).sum(dim=1) * (dm * dm).sum(dim=1))
        corr = torch.where(denom > 0, (dh * dm).sum(dim=1) / denom, torch.nan)
        out.append(torch.where(usable[gs], corr, torch.nan))
    return torch.cat(out)


def _model_correlations(model_tensors, generator: torch.Generator,
                        n_draws: int, dev) -> torch.Tensor:
    means, stds, vals, usable = model_tensors
    g, z = _simulated_draws(generator, n_draws, means.shape[0],
                            means.shape[1])
    return _simulated_correlations(
        g.to(dev), z.to(dev), as_f32(means, dev), as_f32(stds, dev),
        as_f32(vals, dev), torch.from_numpy(np.asarray(usable)).to(dev))


def _model_gen(seed: int, k: int, part: int) -> torch.Generator:
    return generator_for(seed, SURVEY_WORD, _WORD, k, part)


def individual_correlations(
    tensors: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    seed: int,
    n_samples: int,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Per-model arrays of valid simulated-individual correlations
    (calculate_individual_correlations, :54-99); model k draws from
    ``generator_for(seed, 4, 4, k, 0)``."""
    dev = resolve_device(device)
    out: Dict[str, np.ndarray] = {}
    for k, (model, t) in enumerate(tensors.items()):
        arr = _model_correlations(t, _model_gen(seed, k, _BASE), n_samples,
                                  dev).cpu().numpy()
        out[model] = arr[np.isfinite(arr)]
    return out


def run_simulated_bootstrap(
    base_df: Table,
    question_mapping: Dict[str, str],
    detailed: Dict[str, object],
    seed: int = 42,
    n_base_samples: int = 500,
    n_bootstrap: int = 10_000,
    n_boot_samples: int = 100,
    n_per_model_boot: int = 1000,
    families: Optional[Dict[str, Dict[str, str]]] = None,
    device="cuda",
) -> Dict[str, object]:
    """The full C38 analysis. `base_df` is the D1 CSV (both base and
    instruct rows, distinguished by ``base_or_instruct``)."""
    dev = resolve_device(device)
    models = base_df.unique("model")
    by_model = {model: base_df.where("model", model) for model in models}
    model_types = {model: rows["base_or_instruct"][0]
                   for model, rows in by_model.items()}
    tensors = {
        model: model_group_tensors(rows, question_mapping, detailed)
        for model, rows in by_model.items()
    }

    # Base correlations (reference: n_samples=500, seed 42; :103).
    base_corrs = individual_correlations(tensors, seed, n_base_samples, dev)
    model_stats = {
        model: {
            "type": model_types[model],
            "mean_corr": float(np.mean(corrs)) if corrs.size else float("nan"),
            "std_corr": float(np.std(corrs)) if corrs.size else float("nan"),
            "n_correlations": int(corrs.size),
        }
        for model, corrs in base_corrs.items()
        if corrs.size
    }

    # Bootstrap: n_bootstrap iterations of fresh n_boot_samples draws per
    # model, pooled by type within each iteration (:126-148). All draws for
    # one model are one batch of n_bootstrap*n_boot_samples, reduced on
    # the device to each iteration's sum and count of finite values.
    sums = {"base": np.zeros(n_bootstrap), "instruct": np.zeros(n_bootstrap)}
    counts = {"base": np.zeros(n_bootstrap), "instruct": np.zeros(n_bootstrap)}
    for k, (model, t) in enumerate(tensors.items()):
        arr = _model_correlations(t, _model_gen(seed, k, _BOOT),
                                  n_bootstrap * n_boot_samples, dev)
        arr = arr.reshape(n_bootstrap, n_boot_samples)
        finite = torch.isfinite(arr)
        mtype = model_types[model]
        sums[mtype] += torch.where(finite, arr, 0.0).sum(dim=1).cpu().numpy()
        counts[mtype] += finite.sum(dim=1).cpu().numpy()

    def _boot_means(mtype):
        c = counts[mtype]
        with np.errstate(invalid="ignore"):
            m = np.where(c > 0, sums[mtype] / c, np.nan)
        return m[np.isfinite(m)]

    base_means_boot = _boot_means("base")
    instruct_means_boot = _boot_means("instruct")

    def _pooled_mean(mtype):
        pooled = np.concatenate(
            [c for m, c in base_corrs.items() if model_types[m] == mtype]
            or [np.asarray([])]
        )
        return float(np.mean(pooled)) if pooled.size else float("nan")

    def _ci(samples):
        if len(samples) == 0:
            return (float("nan"), float("nan"))
        return (
            float(np.percentile(samples, 2.5)),
            float(np.percentile(samples, 97.5)),
        )

    base_mean = _pooled_mean("base")
    instruct_mean = _pooled_mean("instruct")
    base_ci = _ci(base_means_boot)
    instruct_ci = _ci(instruct_means_boot)

    n_common = min(len(base_means_boot), len(instruct_means_boot))
    diff_samples = base_means_boot[:n_common] - instruct_means_boot[:n_common]
    diff_ci = _ci(diff_samples)
    diff_mean = base_mean - instruct_mean

    # Per-model CIs: 1000 resamples of each model's base correlations (:211-230).
    per_model: Dict[str, Dict[str, object]] = {}
    for k, (model, corrs) in enumerate(base_corrs.items()):
        if corrs.size == 0:
            continue
        idx = resample_indices(_model_gen(seed, k, _PER_MODEL),
                               n_per_model_boot, corrs.size, "cpu").numpy()
        boot_means = corrs[idx].mean(axis=1)
        lo, hi = _ci(boot_means)
        per_model[model] = {
            "type": model_types[model],
            "mean": model_stats[model]["mean_corr"],
            "ci_lower": lo,
            "ci_upper": hi,
        }

    families = families or DEFAULT_SIMULATED_FAMILIES
    family_rows = []
    for family, pair in families.items():
        b, i = pair.get("base"), pair.get("instruct")
        if b in per_model and i in per_model:
            bs, is_ = per_model[b], per_model[i]
            overlap = not (
                bs["ci_upper"] < is_["ci_lower"] or is_["ci_upper"] < bs["ci_lower"]
            )
            family_rows.append(
                {
                    "family": family,
                    "base_mean": bs["mean"],
                    "base_ci": [bs["ci_lower"], bs["ci_upper"]],
                    "instruct_mean": is_["mean"],
                    "instruct_ci": [is_["ci_lower"], is_["ci_upper"]],
                    "difference": bs["mean"] - is_["mean"],
                    "non_overlapping_ci": not overlap,
                }
            )

    return {
        "methodology": (
            "Bootstrap confidence intervals for individual human-model "
            "correlations"
        ),
        "n_bootstrap": n_bootstrap,
        "overall_results": {
            "base": {
                "mean": base_mean,
                "ci_lower": base_ci[0],
                "ci_upper": base_ci[1],
            },
            "instruct": {
                "mean": instruct_mean,
                "ci_lower": instruct_ci[0],
                "ci_upper": instruct_ci[1],
            },
            "difference": {
                "mean": diff_mean,
                "ci_lower": diff_ci[0],
                "ci_upper": diff_ci[1],
                "significant": bool(diff_ci[0] > 0 or diff_ci[1] < 0),
            },
        },
        "per_model_results": per_model,
        "family_comparisons": family_rows,
        "model_stats": model_stats,
    }


DEFAULT_SIMULATED_FAMILIES: Dict[str, Dict[str, str]] = {
    "t5": {"base": "google/t5-v1_1-base", "instruct": "google/flan-t5-base"},
    "falcon": {"base": "tiiuae/falcon-7b", "instruct": "tiiuae/falcon-7b-instruct"},
    "bloom": {"base": "bigscience/bloom-7b1", "instruct": "bigscience/bloomz-7b1"},
    "stablelm": {
        "base": "stabilityai/stablelm-base-alpha-7b",
        "instruct": "stabilityai/stablelm-tuned-alpha-7b",
    },
    "redpajama": {
        "base": "togethercomputer/RedPajama-INCITE-7B-Base",
        "instruct": "togethercomputer/RedPajama-INCITE-7B-Instruct",
    },
    "pythia": {"base": "EleutherAI/pythia-6.9b", "instruct": "databricks/dolly-v2-7b"},
}


def write_simulated_bootstrap(results: Dict[str, object], path: Path) -> None:
    """``bootstrap_confidence_intervals.json`` (:277-310)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=2))
