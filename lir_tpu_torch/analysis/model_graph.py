"""Inter-model correlation and agreement suite over the D2 CSV (C30).

Port of ``lir_tpu/analysis/model_graph.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`, with its statistics on
``device``. Parity target: analysis/model_comparison_graph.py:33-781 —
reference-model difference plot (Baichuan anchor with fallback),
prompt-resampled bootstrap (1000x) of the model-model Pearson/Spearman
correlation matrices with percentile CIs for mean/median/std,
lower-triangle heatmap with abbreviated names, pairwise model kappas,
and the pooled aggregate kappa with bootstrap CI. Filters opt-iml and
Mistral rows as the reference does (:724-726).

Random draws: the Pearson bootstrap draws from ``generator_for(seed, 2,
0)``, the Spearman one from ``generator_for(seed, 2, 1)`` and the
aggregate kappa's from ``generator_for(seed, 2, 2)`` (the JAX package
splits one ``jax.random`` key in turn); the reference-model fallback and
the figure's jitter draw from ``np.random.default_rng(seed)``, as there,
so the fallback picks the JAX package's model.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.table import Pivot, Table, is_missing, read_table, write_csv
from ..device import resolve_device
from ..report.figures import pyplot, require_matplotlib
from ..stats.core import generator_for
from ..stats.correlations import bootstrap_correlation_matrix
from ..stats.kappa import aggregate_kappa, pairwise_kappa_matrix
from ..utils.logging import get_logger

log = get_logger(__name__)

FILTERED_MODEL_PATTERNS = ("opt-iml-1.3b", "mistral")  # reference :724-726

_WORD = 2
_STAT_WORDS = {"pearson": 0, "spearman": 1, "aggregate_kappa": 2}


def filter_models(df: Table) -> Table:
    """Drop the rows of models whose name contains ``opt-iml-1.3b`` (as a
    regular expression, as ``str.contains`` reads it) or, in any case,
    ``mistral``."""
    opt = re.compile(FILTERED_MODEL_PATTERNS[0])
    mistral = re.compile(FILTERED_MODEL_PATTERNS[1], re.IGNORECASE)
    keep = [is_missing(m) or not (opt.search(m) or mistral.search(m))
            for m in df["model"]]
    return df.take(np.array(keep, dtype=bool))


def abbreviated_model_name(model_name: str) -> str:
    """Short display name (get_abbreviated_model_name, :342-387)."""
    name = model_name.split("/")[-1]
    return name[:18] + ".." if len(name) > 20 else name


def prompt_model_pivot(df: Table) -> Pivot:
    return df.pivot_table("prompt", "model", "relative_prob")


def reference_model_differences(
    df: Table, rng: np.random.Generator
) -> Dict[str, object]:
    """Per-model differences in relative_prob vs the Baichuan anchor
    (random fallback when absent, :59-79)."""
    models = df.unique("model")
    anchors = [m for m in models if "baichuan" in m.lower()]
    if anchors:
        reference_model = anchors[0]
    else:
        n_prompts = len(df.unique("prompt"))
        valid = [
            m
            for m in models
            if (~np.isnan(df.where("model", m)["relative_prob"].astype(float))
                ).sum() >= n_prompts
        ]
        if not valid:
            counts = [(key, int((~np.isnan(group["relative_prob"].astype(
                float))).sum())) for key, group in df.groups("model")]
            valid = [max(counts, key=lambda kc: kc[1])[0]]
        reference_model = valid[int(rng.integers(len(valid)))]

    pivot = prompt_model_pivot(df)
    ref = pivot[reference_model]
    diffs: Dict[str, np.ndarray] = {}
    for model in models:
        if model == reference_model:
            continue
        d = pivot[model] - ref
        d = d[~np.isnan(d)]
        if d.size:
            diffs[model] = d
    return {"reference_model": reference_model, "differences": diffs}


def plot_reference_differences(
    result: Dict[str, object], output_path: Path, rng: np.random.Generator
) -> None:
    """Violin + jitter + CI per model vs the anchor (:83-205)."""
    diffs: Dict[str, np.ndarray] = result["differences"]
    if not diffs:
        return
    plt = pyplot()
    colors = plt.cm.tab10(np.linspace(0, 1, 10))
    fig, ax = plt.subplots(figsize=(14, 10))
    legend_elements = []
    for idx, (model, vals) in enumerate(diffs.items()):
        color = colors[idx % len(colors)]
        parts = ax.violinplot([vals], [idx], widths=0.6, showmeans=False,
                              showmedians=False, showextrema=False)
        for pc in parts["bodies"]:
            pc.set_facecolor(color)
            pc.set_edgecolor("none")
            pc.set_alpha(0.3)
        ax.scatter(rng.normal(idx, 0.08, size=vals.size), vals, alpha=0.7,
                   s=50, color=color)
        if vals.size > 1:
            lo, hi = np.percentile(vals, [2.5, 97.5])
            ax.plot([idx, idx], [lo, hi], color="black", linewidth=2, zorder=4)
            for y in (lo, hi):
                ax.plot([idx - 0.1, idx + 0.1], [y, y], color="black",
                        linewidth=2, zorder=4)
        ax.scatter(idx, vals.mean(), color="black", s=100, zorder=5)
        legend_elements.append(
            plt.Line2D([0], [0], marker="s", color="w", markerfacecolor=color,
                       markersize=10, label=model.split("/")[-1])
        )
    ax.scatter(len(diffs), 0, color="black", s=100, marker="*")
    legend_elements.append(
        plt.Line2D([0], [0], marker="*", color="black", markersize=10,
                   label=f"Reference: {result['reference_model'].split('/')[-1]}")
    )
    ax.axhline(0, color="gray", linestyle="--", alpha=0.7)
    ax.set_xticks(range(len(diffs)))
    ax.set_xticklabels([""] * len(diffs))
    ax.set_xlabel("Model")
    ax.set_ylabel("Difference in Relative Probability\nfrom Reference Model")
    ax.legend(handles=legend_elements, loc="upper center",
              bbox_to_anchor=(0.5, -0.15), ncol=3)
    fig.tight_layout()
    fig.subplots_adjust(bottom=0.3)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_correlation_matrix(
    corr_matrix: np.ndarray, model_names: List[str], output_path: Path
) -> None:
    """Lower-triangle heatmap with abbreviated names and each value
    written in its cell (:389-433; seaborn's heatmap in the JAX
    package)."""
    plt = pyplot()
    n = len(model_names)
    lower = np.ma.masked_where(np.triu(np.ones((n, n), dtype=bool)),
                               corr_matrix)
    labels = [abbreviated_model_name(m) for m in model_names]
    fig = plt.figure(figsize=(12, 10))
    ax = fig.gca()
    image = ax.imshow(lower, cmap="RdBu_r", vmin=-1, vmax=1)
    for i in range(n):
        for j in range(i):
            if np.isfinite(corr_matrix[i, j]):
                ax.text(j, i, f"{corr_matrix[i, j]:.2f}", ha="center",
                        va="center", fontsize=8)
    ax.set_xticks(range(n))
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_yticks(range(n))
    ax.set_yticklabels(labels)
    fig.colorbar(image, ax=ax, label="Correlation")
    fig.tight_layout()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_correlation_distribution(
    values: np.ndarray,
    output_path: Path,
    correlation_type: str,
    mean_ci,
    median_ci,
) -> None:
    """Histogram of pairwise correlations with CI markers (:435-493)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(values, bins=20, edgecolor="black", alpha=0.7)
    ax.axvline(values.mean(), color="red", linestyle="--",
               label=f"Mean: {values.mean():.3f} "
                     f"[{mean_ci[0]:.3f}, {mean_ci[1]:.3f}]")
    ax.axvline(np.median(values), color="green", linestyle="--",
               label=f"Median: {np.median(values):.3f} "
                     f"[{median_ci[0]:.3f}, {median_ci[1]:.3f}]")
    ax.set_xlabel(f"{correlation_type.capitalize()} correlation")
    ax.set_ylabel("Frequency")
    ax.set_title(f"Pairwise model {correlation_type} correlations")
    ax.legend()
    fig.tight_layout()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_kappa_distribution(kappas: np.ndarray, output_path: Path) -> None:
    """Histogram of pairwise model kappas (:674-708)."""
    kappas = kappas[np.isfinite(kappas)]
    if kappas.size == 0:
        return
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(kappas, bins=20, edgecolor="black", alpha=0.7)
    ax.axvline(kappas.mean(), color="red", linestyle="--",
               label=f"Mean: {kappas.mean():.3f}")
    ax.set_xlabel("Cohen's Kappa")
    ax.set_ylabel("Frequency")
    ax.legend()
    fig.tight_layout()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def _write_matrix(matrix: np.ndarray, names: List[str], path: Path) -> None:
    """``pd.DataFrame(matrix, index=names, columns=names).to_csv(path)``."""
    write_csv(path, [""] + list(names),
              [[name] + list(row) for name, row in zip(names, matrix)])


def run_model_graph_analysis(
    instruct_csv: Path,
    out_dir: Path,
    seed: int = 42,
    n_bootstrap: int = 1000,
    make_figures: bool = True,
    device="cuda",
) -> Dict[str, object]:
    """Full C30 pipeline (__main__, :710-781)."""
    dev = resolve_device(device)
    if make_figures:
        require_matplotlib()
    out_dir = Path(out_dir)
    figures_dir = out_dir / "figures"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    df = filter_models(read_table(instruct_csv))
    log.info(
        "Model graph analysis: %d rows, %d models after filtering",
        len(df), len([m for m in df.unique("model") if not is_missing(m)]),
    )
    pivot = prompt_model_pivot(df)
    model_names = list(pivot.columns)

    ref_diffs = reference_model_differences(df, rng)
    if make_figures:
        plot_reference_differences(
            ref_diffs, figures_dir / "model_comparison_plot.png", rng
        )

    correlations: Dict[str, Dict[str, object]] = {}
    for corr_type in ("pearson", "spearman"):
        stats = bootstrap_correlation_matrix(
            pivot.values, generator_for(seed, _WORD, _STAT_WORDS[corr_type]),
            method=corr_type, n_bootstrap=n_bootstrap, device=dev,
        )
        correlations[corr_type] = stats
        _write_matrix(stats["correlation_matrix"], model_names,
                      out_dir / f"model_{corr_type}_correlation_matrix.csv")
        if make_figures:
            plot_correlation_matrix(
                stats["correlation_matrix"], model_names,
                figures_dir / f"model_{corr_type}_correlation_matrix.png",
            )
            plot_correlation_distribution(
                stats["correlation_values"],
                figures_dir / f"model_{corr_type}_correlation_distribution.png",
                corr_type, stats["mean_ci"], stats["median_ci"],
            )

    binary = (pivot.values > 0.5).astype(float)
    binary[~np.isfinite(pivot.values)] = np.nan
    kappa_matrix = pairwise_kappa_matrix(binary, device=dev)
    _write_matrix(kappa_matrix, model_names,
                  out_dir / "model_pairwise_kappa_matrix.csv")
    iu = np.triu_indices(len(model_names), k=1)
    if make_figures:
        plot_kappa_distribution(
            kappa_matrix[iu], figures_dir / "model_kappa_distribution.png"
        )

    # Aggregate kappa over prompts answered by every model; fall back to
    # >= 2 models per prompt, as the reference does (:567-571).
    complete = pivot.dropna()
    if len(complete.index) < 2:
        complete = pivot.dropna(thresh=2)
    agg = aggregate_kappa(
        (complete.values > 0.5).astype(np.float32),
        generator_for(seed, _WORD, _STAT_WORDS["aggregate_kappa"]),
        n_boot=n_bootstrap, device=dev,
    )
    Table.from_records([agg]).to_csv(out_dir / "aggregate_kappa_results.csv")

    summary = {
        "reference_model": ref_diffs["reference_model"],
        "correlations": {
            k: {kk: vv for kk, vv in v.items()
                if kk not in ("correlation_matrix", "correlation_values")}
            for k, v in correlations.items()
        },
        "aggregate_kappa": agg,
    }
    return {
        "pivot": pivot,
        "reference_differences": ref_diffs,
        "correlations": correlations,
        "pairwise_kappa_matrix": kappa_matrix,
        "aggregate_kappa": agg,
        "summary": summary,
    }


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--instruct", type=Path, required=True,
                        help="D2 instruct_model_comparison_results.csv")
    parser.add_argument("--out", type=Path, default=Path("results/model_graph"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-figures", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    run_model_graph_analysis(
        args.instruct, args.out, seed=args.seed,
        make_figures=not args.no_figures, device=args.device,
    )


if __name__ == "__main__":
    main()
