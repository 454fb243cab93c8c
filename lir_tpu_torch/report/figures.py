"""Perturbation-analysis figures (C23).

Port of ``lir_tpu/report/figures.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity targets:
analyze_perturbation_results.py —
  create_probability_histogram :622-667   -> prompt_N_distribution.png
  create_confidence_histogram  :670-720   -> prompt_N_confidence_distribution.png
  create_qq_plot               :498-620   -> prompt_N[_confidence]_qq_plot.png
  create_truncated_model_plot  :339-496   -> prompt_N[_confidence]_truncated_model.png
  create_combined_visualization:911-997   -> combined_prompts_visualization.png
  create_combined_confidence_visualization :1000-1092
                                          -> combined_confidence_visualization.png

matplotlib is imported inside each figure function (headless, Agg): the
card's machine has none, and the module imports without it. The QQ
bootstrap bands (1000 resamples of the order statistics, reference
:547-573 as a Python loop) are one batched sort on ``device`` of
resamples drawn by ``stats.core.resample_indices``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from scipy import stats as scipy_stats

from ..data.table import Table
from ..stats.core import as_f32, generator_for, resample_indices


def require_matplotlib() -> None:
    """Raise ImportError, naming the cause, where matplotlib is absent."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "figures need matplotlib, which is not installed; pass "
            "make_figures=False (CLI: --no-figures)") from exc


def pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _sorted_resamples(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n_boot, n) each resample ``values[idx[b]]`` sorted."""
    return torch.sort(values[idx], dim=-1).values


def _ensure_dir(path: Path) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _finite(data: Table, column: str) -> np.ndarray:
    vals = data[column].astype(float)
    return vals[np.isfinite(vals)]


def probability_histogram(
    data: Table,
    prompt_idx: int,
    token_options: Sequence[str],
    output_dir: Path,
) -> Optional[Path]:
    """Histogram of Relative_Prob with the central 95% interval shaded."""
    vals = _finite(data, "Relative_Prob")
    if vals.size == 0:
        return None
    plt = pyplot()
    lo, hi = np.percentile(vals, [2.5, 97.5])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(vals, bins=50, range=(0, 1), edgecolor="black", alpha=0.75)
    ax.axvspan(lo, hi, alpha=0.15, color="green", label="95% interval")
    ax.axvline(vals.mean(), color="red", linestyle="--",
               label=f"Mean = {vals.mean():.3f}")
    ax.set_xlabel(
        f'Relative probability of "{token_options[0]}" vs "{token_options[1]}"'
    )
    ax.set_ylabel("Count")
    ax.set_title(f"Prompt {prompt_idx + 1}: Relative Probability Distribution")
    ax.legend()
    out = _ensure_dir(output_dir) / f"prompt_{prompt_idx + 1}_distribution.png"
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def confidence_histogram(
    data: Table,
    prompt_idx: int,
    token_options: Sequence[str],
    output_dir: Path,
) -> Optional[Path]:
    if "Weighted Confidence" not in data:
        return None
    vals = _finite(data, "Weighted Confidence")
    if vals.size == 0:
        return None
    plt = pyplot()
    lo, hi = np.percentile(vals, [2.5, 97.5])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(vals, bins=50, range=(0, 100), edgecolor="black", alpha=0.75)
    ax.axvspan(lo, hi, alpha=0.15, color="green", label="95% interval")
    ax.axvline(vals.mean(), color="red", linestyle="--",
               label=f"Mean = {vals.mean():.1f}")
    ax.set_xlabel(f'Weighted confidence for "{token_options[0]}"')
    ax.set_ylabel("Count")
    ax.set_title(f"Prompt {prompt_idx + 1}: Weighted Confidence Distribution")
    ax.legend()
    out = _ensure_dir(output_dir) / (
        f"prompt_{prompt_idx + 1}_confidence_distribution.png"
    )
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def qq_plot(
    data: Table,
    column_name: str,
    prompt_idx: int,
    token_options: Sequence[str],
    output_dir: Path,
    generator: Optional[torch.Generator] = None,
    n_bootstrap: int = 1000,
    device="cuda",
) -> Optional[Path]:
    """Normal QQ plot with bootstrap confidence bands on the order
    statistics — the reference's 1000-resample loop (:547-573) as one
    batched sort on ``device``; the resamples are drawn from ``generator``
    (default ``generator_for(42)``)."""
    vals = _finite(data, column_name)
    if vals.size < 3:
        return None
    plt = pyplot()
    generator = generator if generator is not None else generator_for(42)

    sorted_vals = np.sort(vals)
    n = vals.size
    theoretical = scipy_stats.norm.ppf((np.arange(1, n + 1) - 0.5) / n)
    theoretical = vals.mean() + vals.std() * theoretical

    idx = resample_indices(generator, n_bootstrap, n, device)
    boot_sorted = _sorted_resamples(as_f32(vals, device), idx).cpu().numpy()
    band_lo = np.percentile(boot_sorted, 2.5, axis=0)
    band_hi = np.percentile(boot_sorted, 97.5, axis=0)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.fill_between(theoretical, band_lo, band_hi, alpha=0.2, color="gray",
                    label="95% bootstrap band")
    ax.plot(theoretical, sorted_vals, "o", markersize=3, alpha=0.6,
            label="Sample quantiles")
    lims = [min(theoretical.min(), sorted_vals.min()),
            max(theoretical.max(), sorted_vals.max())]
    ax.plot(lims, lims, "r--", label="y = x")
    ax.set_xlabel("Theoretical quantiles (fitted normal)")
    ax.set_ylabel("Sample quantiles")
    ax.set_title(
        f"Prompt {prompt_idx + 1}: QQ Plot ({column_name}, "
        f'"{token_options[0]}")'
    )
    ax.legend()
    suffix = "_confidence" if "Confidence" in column_name else ""
    out = _ensure_dir(output_dir) / (
        f"prompt_{prompt_idx + 1}{suffix}_qq_plot.png"
    )
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def truncated_model_plot(
    data: Table,
    column_name: str,
    prompt_idx: int,
    token_options: Sequence[str],
    simulated: np.ndarray,
    output_dir: Path,
    ks_statistic: float,
) -> Optional[Path]:
    """Observed vs truncated-normal-simulated distribution overlay."""
    vals = _finite(data, column_name)
    simulated = np.asarray(simulated)
    if vals.size == 0 or simulated.size == 0:
        return None
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    rng = (min(vals.min(), simulated.min()), max(vals.max(), simulated.max()))
    ax.hist(vals, bins=50, range=rng, density=True, alpha=0.55,
            label="Observed", edgecolor="black")
    ax.hist(simulated, bins=50, range=rng, density=True,
            alpha=0.45, label="Truncated-normal model")
    ax.set_xlabel(column_name)
    ax.set_ylabel("Density")
    ax.set_title(
        f"Prompt {prompt_idx + 1}: Truncated Normal Fit "
        f"(KS = {ks_statistic:.4f})"
    )
    ax.legend()
    suffix = "_confidence" if "Confidence" in column_name else ""
    out = _ensure_dir(output_dir) / (
        f"prompt_{prompt_idx + 1}{suffix}_truncated_model.png"
    )
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def _combined_violin(
    df: Table,
    column: str,
    prompts,
    output_path: Path,
    ylabel: str,
    ylim,
    rng: np.random.Generator,
) -> Optional[Path]:
    groups, labels = [], []
    for idx, prompt in enumerate(prompts):
        vals = _finite(df.where("Original Main Part", prompt.main), column)
        if vals.size:
            groups.append(vals)
            labels.append(
                f"Prompt {idx + 1}\n"
                f'"{prompt.target_tokens[0]}" vs "{prompt.target_tokens[1]}"'
            )
    if not groups:
        return None
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(14, 7))
    parts = ax.violinplot(groups, showmeans=True, showextrema=False)
    for pc in parts["bodies"]:
        pc.set_alpha(0.5)
    for i, vals in enumerate(groups):
        jitter = rng.normal(0, 0.06, size=vals.size)
        ax.plot(
            np.full(vals.size, i + 1) + jitter, vals, ".", markersize=2,
            alpha=0.25, color="black",
        )
    ax.set_xticks(range(1, len(labels) + 1))
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel(ylabel)
    ax.set_ylim(*ylim)
    ax.set_title("All Prompts: Perturbation Response Distributions")
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def combined_visualization(
    df: Table, prompts, output_dir: Path,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Path]:
    """Violin + jitter across all prompts (Relative_Prob; :911-997)."""
    return _combined_violin(
        df, "Relative_Prob", prompts,
        Path(output_dir) / "combined_prompts_visualization.png",
        "Relative probability of first token", (-0.02, 1.02),
        rng or np.random.default_rng(42),
    )


def combined_confidence_visualization(
    df: Table, prompts, output_dir: Path,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Path]:
    """Violin + jitter across all prompts (Weighted Confidence; :1000-1092)."""
    if "Weighted Confidence" not in df:
        return None
    return _combined_violin(
        df, "Weighted Confidence", prompts,
        Path(output_dir) / "combined_confidence_visualization.png",
        "Weighted confidence", (-2, 102),
        rng or np.random.default_rng(42),
    )
