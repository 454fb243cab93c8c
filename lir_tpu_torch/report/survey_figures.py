"""Survey-analysis figures (C39/C43 visual outputs).

Port of ``lir_tpu/report/survey_figures.py``: the same three files, drawn
with matplotlib imported inside each function (``report.figures.pyplot``,
headless): the card's machine has none, and the module imports without
it. Parity targets:
  - analyze_llm_human_agreement.py:210-259 -> best_worst_model_agreement.png
    (scatter of best/worst model vs human averages) and
    model_mae_comparison.png (horizontal MAE bar chart, instruct vs base)
  - calculate_correlation_pvalues.py:326-371 ->
    correlation_pvalue_distributions.png (2x2 histogram panel of LLM/human
    correlations and their p-values)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .figures import pyplot


def best_worst_agreement_plot(
    all_results: List[Dict[str, object]], path: Path
) -> Optional[Path]:
    """Scatter of the best and worst models (by MAE) against human averages
    (:214-239). `all_results` is analyze_all_models output (sorted by MAE)."""
    if not all_results:
        return None
    best, worst = all_results[0], all_results[-1]
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    for ax, result, label in ((axes[0], best, "Best"), (axes[1], worst, "Worst")):
        matched = result["matched"]
        ax.scatter(matched["human_avg"], matched["model_prob"], alpha=0.6)
        ax.plot([0, 1], [0, 1], "r--", alpha=0.5)
        ax.set_xlabel("Human Average Rating")
        ax.set_ylabel("Model Probability")
        ax.set_title(
            f"{label} Model: {result['model']}\n"
            f"MAE = {result['mae']:.4f}, r = {result['pearson_r']:.4f}"
        )
        ax.set_xlim(-0.05, 1.05)
        ax.set_ylim(-0.05, 1.05)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def mae_comparison_plot(
    all_results: List[Dict[str, object]], path: Path
) -> Optional[Path]:
    """Horizontal MAE bar chart, instruct blue / base green (:241-258)."""
    if not all_results:
        return None
    names = [
        r["model"].split("/")[-1][:20] + "..."
        if len(r["model"]) > 20 else r["model"]
        for r in all_results
    ]
    maes = [r["mae"] for r in all_results]
    colors = [
        "blue" if r["model_type"] == "instruct" else "green"
        for r in all_results
    ]
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 8))
    ax.barh(names, maes, color=colors)
    ax.set_xlabel("Mean Absolute Error (lower is better)")
    ax.set_title("Model Agreement with Human Average Ratings")
    from matplotlib.patches import Patch

    ax.legend(
        handles=[
            Patch(facecolor="blue", label="Instruct Models"),
            Patch(facecolor="green", label="Base Models"),
        ],
        loc="lower right",
    )
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def correlation_pvalue_panel(
    llm_correlations: List[Dict[str, object]],
    human_correlations: List[Dict[str, object]],
    path: Path,
) -> Optional[Path]:
    """2x2 histogram panel: LLM/human correlation and p-value distributions
    (calculate_correlation_pvalues.py:329-368)."""
    if not llm_correlations or not human_correlations:
        return None
    llm_r = np.asarray([c["correlation"] for c in llm_correlations])
    human_r = np.asarray([c["correlation"] for c in human_correlations])
    llm_p = np.asarray([c["p_value"] for c in llm_correlations])
    human_p = np.asarray([c["p_value"] for c in human_correlations])

    plt = pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    panels = (
        (axes[0, 0], llm_r, "LLM Pairwise Correlations", None, "C0"),
        (axes[0, 1], human_r, "Human Pairwise Correlations", None, "green"),
        (axes[1, 0], llm_p, "LLM Correlation P-values", 0.05, "C0"),
        (axes[1, 1], human_p, "Human Correlation P-values", 0.05, "green"),
    )
    for ax, vals, title, vline, color in panels:
        ax.hist(vals[np.isfinite(vals)], bins=30, edgecolor="black",
                alpha=0.7, color=color)
        if vline is None:
            ax.axvline(np.nanmean(vals), color="red", linestyle="--",
                       label=f"Mean: {np.nanmean(vals):.3f}")
        else:
            ax.axvline(vline, color="red", linestyle="--", label=f"p = {vline}")
        ax.set_xlabel("Correlation Coefficient" if vline is None else "P-value")
        ax.set_ylabel("Frequency")
        ax.set_title(title)
        ax.legend()
    fig.suptitle("Correlation Analysis: LLMs vs Humans", fontsize=14,
                 fontweight="bold")
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
