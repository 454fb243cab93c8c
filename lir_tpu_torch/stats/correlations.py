"""Correlation matrices with a prompt-resampled bootstrap.

Port of ``lir_tpu/stats/correlations.py``. Parity target:
calculate_model_correlations (model_comparison_graph.py:207-340) — 1000
bootstrap recomputations of the models x models correlation matrix. The
masked pairwise Pearson matrix comes from cross-products of the masked
matrix (pandas' pairwise-complete observations), and the bootstrap axis
is one batched computation over (n_boot, n, m) resampled matrices,
reduced in chunks of resamples. The cross-products are broadcast
multiply-and-sum in float32 (the JAX package runs them at "highest"
precision), never a TF32 matmul.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .core import as_f32, resample_indices

# Elements of the (rows, pairs, n, n) comparison the batched Spearman
# matrix may hold at once: resamples are reduced in chunks under this.
_CHUNK_ELEMS = 1 << 26


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over the items axis (-2): (..., n, m) x (..., n, m) ->
    (..., m, m), as float32 products and sums."""
    return (a.unsqueeze(-1) * b.unsqueeze(-2)).sum(dim=-3)


def masked_pearson_matrix(x: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete Pearson correlation between the columns of `x`
    (..., items, raters), NaN-aware — ``pandas.DataFrame.corr(method=
    'pearson')``. Broadcasts over leading (resample) axes."""
    m = torch.isfinite(x)
    # Pearson is invariant to per-column affine rescaling; standardizing by
    # the column-wise finite mean/std first keeps the cross-product formula
    # well-conditioned.
    mf = m.to(x.dtype)
    cnt = torch.clamp_min(mf.sum(dim=-2), 1.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xz0 = torch.where(m, x, zero)
    mean = xz0.sum(dim=-2) / cnt
    var = torch.where(m, (x - mean.unsqueeze(-2)) ** 2, zero).sum(dim=-2) / cnt
    std = torch.sqrt(torch.clamp_min(var, 1e-30))
    x = (x - mean.unsqueeze(-2)) / std.unsqueeze(-2)
    xz = torch.where(m, x, zero)
    n = _cross(mf, mf)                 # joint-observation counts
    sx = _cross(xz, mf)                # sum of x_i over the joint mask
    sxy = _cross(xz, xz)
    sxx = _cross(xz * xz, mf)
    sy = sx.transpose(-1, -2)
    syy = sxx.transpose(-1, -2)
    cov = n * sxy - sx * sy
    var_x = n * sxx - sx * sx
    var_y = n * syy - sy * sy
    denom = torch.sqrt(var_x * var_y)
    return torch.where((denom > 0) & (n > 1), cov / denom, torch.nan)


def _masked_ranks(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Average ranks of `v` along the last axis restricted to mask `m`
    (invalid positions get an arbitrary value; callers mask them out)."""
    vm = torch.where(m, v, torch.inf)
    lt = ((vm[..., :, None] > vm[..., None, :]) & m[..., None, :]).sum(dim=-1)
    eq = ((vm[..., :, None] == vm[..., None, :]) & m[..., None, :]).sum(dim=-1)
    return (lt + (eq + 1) / 2.0).to(v.dtype)


def _masked_pearson_pair(xi: torch.Tensor, xj: torch.Tensor,
                         m: torch.Tensor) -> torch.Tensor:
    mf = m.to(xi.dtype)
    n = mf.sum(dim=-1)
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    xi = torch.where(m, xi, zero)
    xj = torch.where(m, xj, zero)
    mx = xi.sum(dim=-1, keepdim=True) / n.unsqueeze(-1)
    my = xj.sum(dim=-1, keepdim=True) / n.unsqueeze(-1)
    dx = torch.where(m, xi - mx, zero)
    dy = torch.where(m, xj - my, zero)
    denom = torch.sqrt((dx * dx).sum(dim=-1) * (dy * dy).sum(dim=-1))
    return torch.where((denom > 0) & (n > 1), (dx * dy).sum(dim=-1) / denom,
                       torch.nan)


def _spearman_pairs(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete Spearman of the rows of xi and xj (..., n)."""
    m = torch.isfinite(xi) & torch.isfinite(xj)
    return _masked_pearson_pair(_masked_ranks(xi, m), _masked_ranks(xj, m), m)


def masked_spearman_matrix(x: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete Spearman, pandas-compatible: for every column pair,
    restrict to jointly finite rows, re-rank *within that subset*, then
    Pearson. (Ranking whole columns first diverges whenever columns have
    different NaN patterns — e.g. the D1 base/instruct pivot, an incomplete
    49x18 grid.) All pairs at once; broadcasts over leading axes."""
    ncol = x.shape[-1]
    ii, jj = torch.triu_indices(ncol, ncol, offset=1, device=x.device)
    xt = x.transpose(-1, -2)                       # (..., ncol, n)
    vals = _spearman_pairs(xt[..., ii, :], xt[..., jj, :])
    out = torch.full(x.shape[:-2] + (ncol, ncol), torch.nan, dtype=x.dtype,
                     device=x.device)
    out[..., ii, jj] = vals
    out[..., jj, ii] = vals
    diag_ok = torch.isfinite(x).sum(dim=-2) > 1
    d = torch.arange(ncol, device=x.device)
    out[..., d, d] = torch.where(diag_ok, 1.0, torch.nan).to(x.dtype)
    return out


_CORR = {"pearson": masked_pearson_matrix, "spearman": masked_spearman_matrix}


def _resampled_corr(x: torch.Tensor, idx: torch.Tensor,
                    method: str) -> torch.Tensor:
    """(n_boot, m, m) correlation matrices of the resamples ``x[idx]``,
    in chunks of resamples."""
    n, m = x.shape
    per = n * n * max(m * (m - 1) // 2, 1) if method == "spearman" else n * m * m
    rows = max(1, _CHUNK_ELEMS // per)
    return torch.cat([_CORR[method](x[i]) for i in idx.split(rows)])


def _masked_corr_matrix_f64(x: np.ndarray, method: str) -> np.ndarray:
    """Pairwise-complete correlation matrix in float64 (pandas-compatible
    down to rank-tie handling); host numpy — this is the tiny deterministic
    point estimate, not the bootstrap hot path."""
    from scipy.stats import rankdata

    n = x.shape[1]
    out = np.full((n, n), np.nan)
    for i in range(n):
        for j in range(i, n):
            m = np.isfinite(x[:, i]) & np.isfinite(x[:, j])
            if int(m.sum()) < 2:
                continue
            xi, xj = x[m, i], x[m, j]
            if method == "spearman":
                xi, xj = rankdata(xi), rankdata(xj)
            dx, dy = xi - xi.mean(), xj - xj.mean()
            denom = np.sqrt((dx * dx).sum() * (dy * dy).sum())
            if denom > 0:
                out[i, j] = out[j, i] = float((dx * dy).sum() / denom)
    return out


def _pair_values(matrix: np.ndarray) -> np.ndarray:
    iu = np.triu_indices(matrix.shape[0], k=1)
    vals = matrix[iu]
    return vals[np.isfinite(vals)]


def bootstrap_correlation_matrix(
    pivot: np.ndarray,
    generator: Optional[torch.Generator],
    method: str = "pearson",
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    indices: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, object]:
    """Full parity with calculate_model_correlations: original pairwise
    correlations + bootstrap (prompts resampled with replacement) CIs for the
    mean/median/std of the pairwise-correlation distribution.

    `pivot` is (n_prompts, n_models), NaN allowed. ``indices`` injects
    explicit (n_bootstrap, n_prompts) resample indices instead of draws
    from ``generator``.
    """
    dev = resolve_device(device)
    x64 = np.asarray(pivot, dtype=np.float64)

    # The point matrix is float64 on the host (a float32-collapsed tie can
    # flip Spearman ranks against pandas); the resamples run in float32
    # on the device (CI-level quantities), as in the JAX package.
    original = _masked_corr_matrix_f64(x64, method)
    original_vals = _pair_values(original)

    if indices is not None:
        idx_np = np.asarray(indices, np.int64)
        if idx_np.shape != (n_bootstrap, x64.shape[0]):
            raise ValueError(f"indices shape {idx_np.shape} != "
                             f"({n_bootstrap}, {x64.shape[0]})")
        if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= x64.shape[0]):
            raise ValueError("indices out of range for pivot rows")
        idx = torch.from_numpy(idx_np).to(dev)
    else:
        idx = resample_indices(generator, n_bootstrap, x64.shape[0], dev)
    boot_mats = _resampled_corr(as_f32(x64, dev), idx, method).cpu().numpy()

    iu = np.triu_indices(x64.shape[1], k=1)
    boot_vals = boot_mats[:, iu[0], iu[1]]          # (n_boot, n_pairs)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # Resamples where no pair has joint coverage reduce to all-NaN rows;
        # they contribute NaN (dropped by ci()/agg()) rather than a warning.
        warnings.simplefilter("ignore", RuntimeWarning)
        means = np.nanmean(boot_vals, axis=1)
        medians = np.nanmedian(boot_vals, axis=1)
        stds = np.nanstd(boot_vals, axis=1)

    alpha = 1 - confidence
    lo_p, hi_p = 100 * alpha / 2, 100 * (1 - alpha / 2)

    def ci(samples):
        s = samples[np.isfinite(samples)]
        if s.size == 0:
            return (float("nan"), float("nan"))
        return (float(np.percentile(s, lo_p)), float(np.percentile(s, hi_p)))

    def agg(fn, vals):
        finite = vals[np.isfinite(vals)]
        return float(fn(finite)) if finite.size else float("nan")

    return {
        "mean_correlation": agg(np.mean, original_vals),
        "mean_ci": ci(means),
        "mean_se": agg(np.nanstd, means),
        "median_correlation": agg(np.median, original_vals),
        "median_ci": ci(medians),
        "median_se": agg(np.nanstd, medians),
        "std_correlation": agg(np.std, original_vals),
        "std_ci": ci(stds),
        "std_se": agg(np.nanstd, stds),
        "min_correlation": agg(np.min, original_vals),
        "max_correlation": agg(np.max, original_vals),
        "correlation_matrix": original,
        "correlation_values": original_vals,
        "n_bootstrap": n_bootstrap,
        "confidence_level": confidence,
    }


def cross_rater_mean_correlation(
    matrix: np.ndarray,
    min_items: int = 5,
    device="cuda",
) -> float:
    """Mean off-diagonal pairwise-complete correlation between raters
    (columns), requiring >= min_items joint observations per pair — the inner
    statistic of the cross-prompt rank-consistency analysis
    (survey_analysis_consolidated.py:352-594)."""
    x = np.asarray(matrix, dtype=np.float64)
    m = np.isfinite(x).astype(np.float64)
    counts = m.T @ m
    corr = masked_pearson_matrix(as_f32(x, device)).cpu().numpy()
    iu = np.triu_indices(x.shape[1], k=1)
    vals = corr[iu]
    ok = np.isfinite(vals) & (counts[iu] >= min_items)
    return float(np.mean(vals[ok])) if ok.any() else float("nan")
