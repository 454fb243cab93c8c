"""Cohen's kappa — every kappa variant the reference computes.

Port of ``lir_tpu/stats/kappa.py``. The pair loops collapse to closed
forms (a group of n binary decisions with s ones has C(s,2) + C(n-s,2)
agreeing pairs out of C(n,2)), and the bootstrap variants are one batched
computation over (n_boot, n) index tensors: ``_aggregate_kappa_boot`` and
``_self_kappa_boot`` are pure functions of the indices, which the public
functions draw from a CPU ``torch.Generator`` (``core.resample_indices``)
or take as ``indices=``. float32 on ``device``, as the JAX package runs
them; the host parts stay numpy float64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .core import resample_indices, standard_normal

KAPPA_BANDS = (
    (0.0, "Poor agreement (worse than chance)"),
    (0.2, "Slight agreement"),
    (0.4, "Fair agreement"),
    (0.6, "Moderate agreement"),
    (0.8, "Substantial agreement"),
)


def interpret_kappa(kappa: float) -> str:
    """Interpretation bands (analyze_perturbation_results.py:1173-1184,
    calculate_cohens_kappa.py:379-394)."""
    if np.isnan(kappa):
        return "Undefined (kappa is NaN)"
    for upper, label in KAPPA_BANDS:
        if kappa < upper:
            return label
    return "Almost perfect agreement"


def cohen_kappa(a: torch.Tensor, b: torch.Tensor,
                n_classes: int = 2) -> torch.Tensor:
    """Cohen's kappa between two label vectors along the last axis
    (broadcasting over leading axes), sklearn-compatible: NaN when
    pe == 1 (both raters constant and identical)."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    po = (a == b).to(torch.float32).mean(dim=-1)
    ks = torch.arange(n_classes, dtype=torch.int32, device=a.device)
    pa = (a[..., None, :] == ks[:, None]).to(torch.float32).mean(dim=-1)
    pb = (b[..., None, :] == ks[:, None]).to(torch.float32).mean(dim=-1)
    pe = (pa * pb).sum(dim=-1)
    return torch.where(pe < 1.0, (po - pe) / (1.0 - pe), torch.nan)


def within_group_kappa(
    decisions: np.ndarray, group_ids: np.ndarray
) -> Dict[str, float]:
    """Within-prompt kappa, closed form.

    Parity: analyze_perturbation_results.py:1094-1188. Observed agreement is
    the fraction of agreeing same-group pairs (groups of size <= 1 excluded);
    expected agreement is p1^2 + p0^2 over *all* decisions; kappa is the usual
    ratio. `decisions` is 0/1; `group_ids` is any integer labeling.
    """
    decisions = np.asarray(decisions)
    group_ids = np.asarray(group_ids)
    if decisions.size == 0:
        return {
            "kappa": float("nan"),
            "observed_agreement": float("nan"),
            "expected_agreement": float("nan"),
        }

    uniq = np.unique(group_ids)
    agree_pairs = 0.0
    total_pairs = 0.0
    for g in uniq:
        d = decisions[group_ids == g]
        n = d.size
        if n <= 1:
            continue
        s = float(d.sum())
        agree_pairs += s * (s - 1) / 2 + (n - s) * (n - s - 1) / 2
        total_pairs += n * (n - 1) / 2

    observed = agree_pairs / total_pairs if total_pairs > 0 else 0.0
    p1 = float(decisions.mean())
    expected = p1 * p1 + (1 - p1) * (1 - p1)
    kappa = (observed - expected) / (1 - expected) if expected < 1 else 1.0
    return {
        "kappa": float(kappa),
        "observed_agreement": float(observed),
        "expected_agreement": float(expected),
    }


def pairwise_kappa_matrix(binary: np.ndarray, device="cuda") -> np.ndarray:
    """All-pairs kappa between columns of a (n_items, n_raters) binary matrix
    with possible NaN entries (only rows finite for both raters count).

    Parity: the model-pair kappa loop at model_comparison_graph.py:495-547.
    Returns a symmetric (n_raters, n_raters) matrix, 1 on the diagonal.
    """
    dev = resolve_device(device)
    binary = np.asarray(binary, dtype=float)
    n = binary.shape[1]
    out = np.full((n, n), np.nan)
    for i in range(n):
        out[i, i] = 1.0
        for j in range(i + 1, n):
            mask = np.isfinite(binary[:, i]) & np.isfinite(binary[:, j])
            if mask.sum() < 2:
                continue
            k = float(cohen_kappa(
                torch.as_tensor(binary[mask, i], device=dev),
                torch.as_tensor(binary[mask, j], device=dev)))
            out[i, j] = out[j, i] = k
    return out


def _aggregate_kappa_boot(rates: torch.Tensor, flat: torch.Tensor,
                          ri: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """(n_boot,) pooled kappas: per-prompt agreement rates resampled by
    ``ri`` (n_boot, n_prompts), the flattened matrix by ``fi``."""
    obs = rates[ri].mean(dim=-1)
    q1 = flat[fi].mean(dim=-1)
    ch = q1 * q1 + (1 - q1) * (1 - q1)
    return torch.where(ch < 1, (obs - ch) / (1 - ch), torch.nan)


def _self_kappa_boot(d: torch.Tensor, i1: torch.Tensor,
                     i2: torch.Tensor) -> torch.Tensor:
    """(n_boot,) kappas between the resamples ``d[i1]`` and ``d[i2]``."""
    return cohen_kappa(d[i1], d[i2])


def _agreement_rates(binary: torch.Tensor) -> torch.Tensor:
    """Per-row fraction of agreeing rater pairs, closed form.
    binary: (n_items, n_raters) in {0,1}."""
    n = binary.shape[1]
    s = binary.sum(dim=1)
    agree = s * (s - 1) / 2 + (n - s) * (n - s - 1) / 2
    total = n * (n - 1) / 2
    return agree / total


def _checked_indices(arr, n_boot: int, n: int, device) -> torch.Tensor:
    """Validate injected replay indices with hard errors: an out-of-range
    index would be a plausible-but-wrong bootstrap quantity."""
    a = np.asarray(arr, np.int64)
    if a.shape != (n_boot, n):
        raise ValueError(f"indices shape {a.shape} != ({n_boot}, {n})")
    if a.size and (a.min() < 0 or a.max() >= n):
        raise ValueError("indices out of range")
    return torch.from_numpy(a).to(device)


def aggregate_kappa(
    binary: np.ndarray,
    generator: Optional[torch.Generator],
    n_boot: int = 1000,
    indices: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device="cuda",
) -> Dict[str, float]:
    """Pooled kappa across all raters with a bootstrap CI.

    Parity: calculate_aggregate_cohens_kappa (model_comparison_graph.py:
    549-672): observed = mean per-prompt pair-agreement rate; chance =
    p1^2 + p0^2 over the flattened matrix; the bootstrap resamples the
    per-prompt agreement rates and the flattened values independently
    (rate indices drawn first, then flat indices, from ``generator``).
    ``indices`` injects explicit (rate_idx, flat_idx) arrays instead.
    """
    dev = resolve_device(device)
    b = torch.from_numpy(np.asarray(binary, dtype=np.float32)).to(dev)
    rates = _agreement_rates(b)
    flat = b.reshape(-1)

    observed = float(rates.mean())
    p1 = float(flat.mean())
    chance = p1 * p1 + (1 - p1) * (1 - p1)
    kappa = (observed - chance) / (1 - chance) if chance < 1 else 0.0

    if indices is not None:
        rate_idx = _checked_indices(indices[0], n_boot, rates.shape[0], dev)
        flat_idx = _checked_indices(indices[1], n_boot, flat.shape[0], dev)
    else:
        rate_idx = resample_indices(generator, n_boot, rates.shape[0], dev)
        flat_idx = resample_indices(generator, n_boot, flat.shape[0], dev)
    samples = _aggregate_kappa_boot(rates, flat, rate_idx,
                                    flat_idx).cpu().numpy()
    samples = samples[np.isfinite(samples)]
    return {
        "aggregate_kappa": float(kappa),
        "observed_agreement": observed,
        "chance_agreement": float(chance),
        "kappa_ci_lower": float(np.percentile(samples, 2.5)) if samples.size else float("nan"),
        "kappa_ci_upper": float(np.percentile(samples, 97.5)) if samples.size else float("nan"),
        "n_prompts": int(binary.shape[0]),
        "n_models": int(binary.shape[1]),
        "p_class1": p1,
        "p_class0": 1 - p1,
    }


def self_kappa_bootstrap(
    decisions: np.ndarray,
    generator: Optional[torch.Generator],
    n_boot: int = 1000,
    indices: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device="cuda",
) -> Dict[str, float]:
    """Perturbation 'self-kappa': kappa between two independent bootstrap
    resamples of one decision vector, averaged over n_boot draws.

    Parity: calculate_cohens_kappa.py:185-216. NaN draws (constant identical
    resamples) are dropped, mirroring the reference's try/except skip.
    ``indices`` injects explicit (idx1, idx2) arrays instead of draws.
    """
    dev = resolve_device(device)
    d = torch.from_numpy(np.asarray(decisions, dtype=np.int32)).to(dev)
    n = d.shape[0]
    if indices is not None:
        idx1 = _checked_indices(indices[0], n_boot, n, dev)
        idx2 = _checked_indices(indices[1], n_boot, n, dev)
    else:
        idx1 = resample_indices(generator, n_boot, n, dev)
        idx2 = resample_indices(generator, n_boot, n, dev)
    samples = _self_kappa_boot(d, idx1, idx2).cpu().numpy()
    samples = samples[np.isfinite(samples)]
    if samples.size == 0:
        return {"self_kappa": float("nan"), "self_kappa_std": float("nan"),
                "min_kappa": float("nan"), "max_kappa": float("nan")}
    return {
        "self_kappa": float(samples.mean()),
        "self_kappa_std": float(samples.std()),
        "min_kappa": float(samples.min()),
        "max_kappa": float(samples.max()),
    }


def combined_kappa(
    model_kappa: float,
    perturbation_kappa: float,
    generator: torch.Generator,
    model_kappa_std: float = 0.1,
    pert_kappa_std: float = 0.1,
    n_boot: int = 1000,
    device="cuda",
) -> Dict[str, float]:
    """Combine the two kappa sources as min(model_draw, perturbation_draw)
    over normal draws (calculate_cohens_kappa.py:328-371); the model's
    normals are drawn first."""
    z_m = standard_normal(generator, (n_boot,), device)
    z_p = standard_normal(generator, (n_boot,), device)
    m = model_kappa + model_kappa_std * z_m
    p = perturbation_kappa + pert_kappa_std * z_p
    combined = torch.minimum(m, p).cpu().numpy()
    return {
        "mean_kappa": float(combined.mean()),
        "median_kappa": float(np.median(combined)),
        "lower_ci": float(np.percentile(combined, 2.5)),
        "upper_ci": float(np.percentile(combined, 97.5)),
    }


def per_prompt_mean_pairwise_kappa(
    decisions_by_model: np.ndarray,
) -> Dict[str, float]:
    """Mean pairwise kappa for one prompt's decision vector across models.

    Parity note: the reference calls ``cohen_kappa_score([x], [y])`` on
    single-element lists (calculate_cohens_kappa.py:124-127), which is
    degenerate — it yields NaN for every disagreeing pair and NaN/1 for
    agreeing ones. SURVEY.md §7 lists this as a defect to fix, not replicate:
    we report the fraction of agreeing pairs (the quantity the reference's
    degenerate code effectively measures) alongside the agreement percentage.
    """
    d = np.asarray(decisions_by_model, dtype=float)
    d = d[np.isfinite(d)]
    n = d.size
    if n < 2:
        return {"avg_pairwise_agreement": float("nan"), "n_models": int(n),
                "agree_percent": float("nan")}
    s = float(d.sum())
    agree = (s * (s - 1) / 2 + (n - s) * (n - s - 1) / 2) / (n * (n - 1) / 2)
    mean_dec = float(d.mean())
    return {
        "avg_pairwise_agreement": float(agree),
        "n_models": int(n),
        "agree_percent": mean_dec if mean_dec > 0.5 else 1 - mean_dec,
    }
