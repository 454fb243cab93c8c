"""Base-vs-instruct delta analysis over the D1 CSV (C28).

Port of ``lir_tpu/analysis/base_vs_instruct.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity target:
analysis/analyze_results_base_versus_instruct.py:1-268 — pair
base/instruct rows per family on prompt, drop rows where any of the four
probabilities is zero, recompute relative probabilities, report
per-family Pearson r and the instruct-minus-base difference distribution
(mean, std, 2.5/97.5 percentiles), and emit the bar/violin/heatmap
figures plus three CSVs. The Mistral family is dropped as in the
reference (:34). The statistics are small and stay on the host (scipy's
``pearsonr``, numpy's percentiles), as in the JAX package; the violin
jitter draws from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy import stats as scipy_stats

from ..data.table import Pivot, Table, read_table
from ..report.figures import pyplot, require_matplotlib
from ..utils.logging import get_logger

log = get_logger(__name__)

DROPPED_FAMILIES = ("mistral",)  # reference :34


def process_model_pair(
    df: Table, base_model: str, instruct_model: str
) -> Table:
    """Merge one family's base/instruct rows on prompt, keep rows where all
    four probabilities are positive, and add rel_prob columns (:38-58)."""
    base = df.where("model", base_model)
    instruct = df.where("model", instruct_model)
    paired = base.merge(instruct, "prompt", ("_base", "_instruct"))
    yb, nb = paired["yes_prob_base"], paired["no_prob_base"]
    yi, ni = paired["yes_prob_instruct"], paired["no_prob_instruct"]
    with np.errstate(invalid="ignore"):
        valid = (yb > 0) & (nb > 0) & (yi > 0) & (ni > 0)
    paired = paired.assign("rel_prob_base", yb / (yb + nb))
    paired = paired.assign("rel_prob_instruct", yi / (yi + ni))
    return paired.take(valid)


def family_differences(df: Table) -> Dict[str, object]:
    """Per-family paired analysis: correlation + difference distribution.

    Returns {"statistics": rows, "prompt_differences": long table}.
    """
    df = df.take(np.array([f not in DROPPED_FAMILIES
                           for f in df["model_family"]], dtype=bool))
    stats_rows: List[Dict[str, object]] = []
    long_rows: List[Dict[str, object]] = []

    for family in df.unique("model_family"):
        fam = df.where("model_family", family)
        kind = fam["base_or_instruct"]
        base_models = fam["model"][kind == "base"]
        instruct_models = fam["model"][kind == "instruct"]
        if len(base_models) == 0 or len(instruct_models) == 0:
            log.info("Family %s lacks a base or instruct model; skipped", family)
            continue
        paired = process_model_pair(df, base_models[0], instruct_models[0])
        if len(paired) == 0:
            log.info("Family %s has no valid pairs after zero filtering", family)
            continue

        corr, p = scipy_stats.pearsonr(
            paired["rel_prob_base"], paired["rel_prob_instruct"]
        )
        diff = paired["rel_prob_instruct"] - paired["rel_prob_base"]
        lo, hi = np.percentile(diff, [2.5, 97.5])
        stats_rows.append(
            {
                "Model_Family": family,
                "Mean": float(diff.mean()),
                "Std_Dev": float(diff.std()),
                "Lower_CI_95": float(lo),
                "Upper_CI_95": float(hi),
                "CI_Width": float(hi - lo),
                "Num_Samples": int(diff.size),
                "Correlation": float(corr),
                "Correlation_p": float(p),
            }
        )
        for prompt, d in zip(paired["prompt"], diff):
            long_rows.append(
                {"Difference": float(d), "Prompt": prompt, "Model Family": family}
            )

    return {
        "statistics": Table.from_records(stats_rows),
        "prompt_differences": Table.from_records(long_rows),
    }


def _bar_plot(stats: Table, path: Path) -> None:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(15, 8))
    ax.bar(stats["Model_Family"], stats["Mean"])
    ax.set_xticks(range(len(stats)))
    ax.set_xticklabels(stats["Model_Family"], rotation=45, ha="right")
    ax.set_title("Average Difference in Relative Probability\n(Instruct - Base)")
    ax.set_ylabel("Difference in Relative Probability")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _violin_plot(long: Table, path: Path, rng: np.random.Generator) -> None:
    plt = pyplot()
    families = long.unique("Model Family")
    colors = plt.cm.tab10(np.linspace(0, 1, len(families)))
    fig, ax = plt.subplots(figsize=(15, 10))
    for idx, family in enumerate(families):
        vals = long.where("Model Family", family)["Difference"].astype(float)
        lo, hi = np.percentile(vals, [2.5, 97.5])
        parts = ax.violinplot([vals], [idx + 1], widths=0.3, showmeans=False,
                              showmedians=False, showextrema=False)
        for pc in parts["bodies"]:
            pc.set_facecolor(colors[idx])
            pc.set_edgecolor("none")
            pc.set_alpha(0.3)
        ax.scatter(rng.normal(idx + 1, 0.08, size=vals.size), vals,
                   alpha=0.4, s=30, color=colors[idx])
        ax.scatter(idx + 1, vals.mean(), color="black", s=80, zorder=5)
        ax.plot([idx + 1, idx + 1], [lo, hi], color="black", linewidth=2, zorder=4)
        for y in (lo, hi):
            ax.plot([idx + 0.9, idx + 1.1], [y, y], color="black", linewidth=2,
                    zorder=4)
    ax.axhline(0, color="gray", linestyle="--", alpha=0.7)
    ax.set_xticks(range(1, len(families) + 1))
    ax.set_xticklabels(families, rotation=45, ha="right")
    ax.set_ylabel("Relative Probability Difference (Instruct - Base)")
    ax.legend(
        handles=[
            plt.Line2D([0], [0], marker="o", color="w",
                       markerfacecolor=colors[i], markersize=10, label=f)
            for i, f in enumerate(families)
        ],
        loc="best",
    )
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def _heatmap(pivot: Pivot, path: Path) -> None:
    """Prompt x family heatmap centred on 0 (the JAX package draws it with
    seaborn, which the port does without)."""
    plt = pyplot()
    fig = plt.figure(figsize=(18, max(4.0, len(pivot.index) * 0.4)))
    ax = fig.gca()
    lim = np.nanmax(np.abs(pivot.values)) if pivot.values.size else 1.0
    image = ax.imshow(np.ma.masked_invalid(pivot.values), cmap="RdBu_r",
                      vmin=-lim, vmax=lim, aspect="auto")
    ax.set_xticks(range(len(pivot.columns)))
    ax.set_xticklabels(pivot.columns, rotation=90)
    ax.set_yticks(range(len(pivot.index)))
    ax.set_yticklabels(pivot.index)
    fig.colorbar(image, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def run_base_vs_instruct_analysis(
    results_csv: Path,
    out_dir: Path,
    make_figures: bool = True,
    seed: int = 42,
) -> Dict[str, object]:
    """Full C28: analysis + figures + the three CSV artifacts."""
    if make_figures:
        require_matplotlib()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = family_differences(read_table(results_csv))
    stats: Table = res["statistics"]
    long: Table = res["prompt_differences"]

    stats.to_csv(out_dir / "model_rel_prob_statistics.csv")
    long.to_csv(out_dir / "prompt_rel_prob_differences.csv")
    pivot = long.pivot_table("Prompt", "Model Family", "Difference")
    pivot.to_csv(out_dir / "prompt_rel_prob_heatmap_data.csv")

    if make_figures and len(stats):
        rng = np.random.default_rng(seed)
        _bar_plot(stats, out_dir / "rel_prob_differences.png")
        _violin_plot(long, out_dir / "prompt_rel_prob_differences.png", rng)
        _heatmap(pivot, out_dir / "prompt_rel_prob_heatmap.png")

    return {**res, "heatmap": pivot}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--results", type=Path, required=True,
                        help="D1 model_comparison_results.csv")
    parser.add_argument("--out", type=Path, default=Path("results/base_vs_instruct"))
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    run_base_vs_instruct_analysis(
        args.results, args.out, make_figures=not args.no_figures
    )


if __name__ == "__main__":
    main()
