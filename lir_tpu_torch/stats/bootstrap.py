"""Bootstrap confidence intervals as batched torch computations.

Port of ``lir_tpu/stats/bootstrap.py``. Every resample is a row of one
(n_boot, n) index tensor, so a whole bootstrap is one batched reduction:
``_bootstrap_stat(stat, x, y, idx)``, ``_resampled_means(values, idx)``
and ``_permutation_diffs(pooled, perms, n_a)`` are pure functions of
their draws. The public functions draw them from an explicit CPU
``torch.Generator`` (``core.resample_indices`` / ``core.standard_normal``)
and run the reduction on ``device`` in float32, the dtype the JAX
package runs them in. Point estimates and p-values come from scipy, as
in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
from scipy import stats as scipy_stats

from ..device import resolve_device
from .core import (as_f32, pearson, percentile_ci, permutations,
                   resample_indices, spearman, standard_normal)

# Elements of the (rows, n, n) comparison a rank statistic may hold at
# once: resamples are reduced in chunks of rows under this bound.
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class BootstrapResult:
    """Point estimate + percentile CI, mirroring the dict returned by
    survey_analysis_consolidated.py:192-200 (minus the raw distribution,
    available via `samples`)."""

    estimate: float
    p_value: float
    ci_lower: float
    ci_upper: float
    standard_error: float
    samples: np.ndarray

    def as_dict(self) -> Dict[str, float]:
        return {
            "correlation": self.estimate,
            "p_value": self.p_value,
            "ci_lower": self.ci_lower,
            "ci_upper": self.ci_upper,
            "standard_error": self.standard_error,
        }


def _bootstrap_stat(stat: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    x: torch.Tensor, y: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """(n_boot,) values of ``stat`` over the paired resamples ``x[idx]``,
    ``y[idx]``; ``stat`` reduces the last axis."""
    n = max(int(idx.shape[-1]), 1)
    rows = max(1, _CHUNK_ELEMS // (n * n))
    return torch.cat([stat(x[i], y[i]) for i in idx.split(rows)])


def _resampled_means(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n_boot,) means of the resamples ``values[idx]``."""
    return values[idx].mean(dim=-1)


def _permutation_diffs(pooled: torch.Tensor, perms: torch.Tensor,
                       n_a: int) -> torch.Tensor:
    """(n_perm,) mean(first n_a) - mean(rest) of each relabeling
    ``pooled[perms[k]]``."""
    p = pooled[perms]
    return p[:, :n_a].mean(dim=-1) - p[:, n_a:].mean(dim=-1)


def _finish(estimate: float, p_value: float, samples: torch.Tensor,
            confidence: float) -> BootstrapResult:
    lo, hi = percentile_ci(samples, confidence)
    host = samples.cpu().numpy()
    return BootstrapResult(
        estimate=float(estimate),
        p_value=float(p_value),
        ci_lower=float(lo),
        ci_upper=float(hi),
        standard_error=float(np.nanstd(host)),
        samples=host,
    )


def bootstrap_correlation(
    x,
    y,
    generator: torch.Generator,
    n_boot: int = 1000,
    confidence: float = 0.95,
    method: str = "pearson",
    device="cuda",
) -> BootstrapResult:
    """Correlation + percentile bootstrap CI + SE.

    Parity target: calculate_pearson_with_bootstrap
    (survey_analysis_consolidated.py:162-200). The point estimate and p-value
    use scipy (exact match); the resampling distribution is computed on
    ``device``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if method == "pearson":
        est, p = scipy_stats.pearsonr(x, y)
        stat = pearson
    elif method == "spearman":
        est, p = scipy_stats.spearmanr(x, y)
        stat = spearman
    else:
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    idx = resample_indices(generator, n_boot, x.shape[0], dev)
    samples = _bootstrap_stat(stat, as_f32(x, dev), as_f32(y, dev), idx)
    return _finish(est, p, samples, confidence)


def bootstrap_mean_ci(
    values,
    generator: torch.Generator,
    n_boot: int = 1000,
    confidence: float = 0.95,
    device="cuda",
) -> BootstrapResult:
    """Bootstrap CI for a mean (used for per-item agreement means,
    survey_analysis_consolidated.py:268-286, and metric CIs in
    analyze_llm_agreement_simple_bootstrap.py)."""
    dev = resolve_device(device)
    v = as_f32(values, dev)
    idx = resample_indices(generator, n_boot, v.shape[0], dev)
    return _finish(np.mean(np.asarray(values, dtype=np.float64)),
                   float("nan"), _resampled_means(v, idx), confidence)


def bootstrap_metric_matrix(
    metric_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x,
    y,
    generator: torch.Generator,
    n_boot: int = 1000,
    device="cuda",
) -> np.ndarray:
    """Generic paired-resample bootstrap of a metric that reduces the last
    axis (MAE/RMSE/Pearson...). Returns the raw sample distribution so
    callers can build whatever summary the reference emits."""
    dev = resolve_device(device)
    xt, yt = as_f32(x, dev), as_f32(y, dev)
    idx = resample_indices(generator, n_boot, xt.shape[0], dev)
    return _bootstrap_stat(metric_fn, xt, yt, idx).cpu().numpy()


# Agreement metrics (analyze_llm_human_agreement.py:94-148) for use with
# bootstrap_metric_matrix.
def mae(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.abs(x - y).mean(dim=-1)


def rmse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((x - y) ** 2).mean(dim=-1))


def mape(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Mean absolute percentage error vs x (human) as the denominator."""
    denom = torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)
    return torch.abs((x - y) / denom).mean(dim=-1) * 100.0


def permutation_test_difference(
    a,
    b,
    generator: torch.Generator,
    n_perm: int = 10_000,
    device="cuda",
) -> Dict[str, float]:
    """Two-sided permutation test for mean(a) - mean(b) by random relabeling.

    Parity target: the base-vs-instruct permutation p-value at
    analyze_llm_agreement_simple_bootstrap.py:312-347. One (n_perm,
    n_a + n_b) permutation tensor (``core.permutations``), one batched
    reduction.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    dev = resolve_device(device)
    pooled = as_f32(np.concatenate([a, b]), dev)
    observed = float(a.mean() - b.mean())
    perms = permutations(generator, n_perm, pooled.shape[0], dev)
    diffs = _permutation_diffs(pooled, perms, a.shape[0]).cpu().numpy()
    p = float(np.mean(np.abs(diffs) >= abs(observed)))
    return {
        "observed_difference": observed,
        "p_value": p,
        "n_permutations": n_perm,
    }


def normal_approx_mc_difference(
    mean_a: float,
    std_a: float,
    mean_b: float,
    std_b: float,
    generator: torch.Generator,
    n_draws: int = 10_000,
    device="cuda",
) -> Dict[str, float]:
    """Monte-Carlo difference distribution from two normal approximations.

    Parity target: analyze_model_family_differences.py:169-230 — draw both
    metrics from N(mean, std) (a's normals first), form the difference,
    report percentile CI and a two-tailed p-value for difference != 0.
    """
    draws_a = mean_a + std_a * standard_normal(generator, (n_draws,), device)
    draws_b = mean_b + std_b * standard_normal(generator, (n_draws,), device)
    diff = (draws_a - draws_b).cpu().numpy()
    p_pos = float(np.mean(diff > 0))
    # Two-tailed p from the MC sign proportion, as the reference computes it.
    p_two = float(2 * min(p_pos, 1 - p_pos))
    return {
        "difference_mean": float(np.mean(diff)),
        "ci_lower": float(np.percentile(diff, 2.5)),
        "ci_upper": float(np.percentile(diff, 97.5)),
        "p_value": p_two,
    }


def simulate_individuals(
    means,
    stds,
    generator: torch.Generator,
    n_individuals: int,
    device="cuda",
) -> torch.Tensor:
    """Simulate individual humans from per-question (mean, std):
    clip(N(mu, sigma), 0, 1) — bootstrap_confidence_intervals.py:86-89.

    Returns (n_individuals, n_questions).
    """
    dev = resolve_device(device)
    means = as_f32(means, dev)
    stds = as_f32(stds, dev)
    z = standard_normal(generator, (n_individuals, means.shape[0]), dev)
    return torch.clip(means[None, :] + stds[None, :] * z, 0.0, 1.0)
