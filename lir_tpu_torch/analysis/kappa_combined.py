"""Two-source Cohen's kappa combiner (C29).

Port of ``lir_tpu/analysis/kappa_combined.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`, with its statistics on
``device``. Parity target: analysis/calculate_cohens_kappa.py:20-675 —
per-prompt inter-model agreement from the D2 CSV, per-prompt perturbation
"self-kappa" from the D6 artifact (1000 bootstrap pairs of binarized
decisions), keyword matching of the 5 legal prompts across the two
datasets, min-of-normal-draws combination with bootstrap CI,
interpretation bands, bar/scatter/distribution figures, LaTeX table, and
the CSV artifacts.

Defect fixed, not replicated (as in the JAX package): the reference
computes per-prompt model agreement with ``cohen_kappa_score([x], [y])``
on single-element lists (:124-127), a degenerate statistic (NaN for every
disagreeing pair). We report the pairwise agreement fraction that loop
actually measures (stats.kappa.per_prompt_mean_pairwise_kappa) and use it
as the model-variation agreement input.

Random draws: prompt g's self-kappa (in sorted prompt order) draws from
``generator_for(seed, 3, 0, g)``; title t's combined kappa (t its place in
``LEGAL_PROMPT_KEYWORDS``) from ``generator_for(seed, 3, 1, t)`` and its
figure's draws from ``generator_for(seed, 3, 2, t)``, where the JAX
package splits ``jax.random`` keys in turn.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.schemas import read_results_frame
from ..data.table import (Table, is_missing, read_table, series_mean,
                          series_std)
from ..device import resolve_device
from ..report.figures import pyplot, require_matplotlib
from ..stats.core import generator_for, standard_normal
from ..stats.kappa import (
    combined_kappa,
    interpret_kappa,
    per_prompt_mean_pairwise_kappa,
    self_kappa_bootstrap,
)
from ..utils.logging import get_logger

log = get_logger(__name__)

# Keyword table matching the 5 legal prompts across datasets (:230-241).
LEGAL_PROMPT_KEYWORDS: Dict[str, List[str]] = {
    "Insurance Policy Water Damage Exclusion": [
        "water damage", "levee", "flood", "insurance policy",
    ],
    "Prenuptial Agreement Petition Filing Date": [
        "prenuptial", "petition", "dissolution", "marriage", "filing",
    ],
    "Contract Term Affiliate Interpretation": [
        "contract", "affiliate", "royalty", "1961", "company",
    ],
    "Construction Payment Terms Interpretation": [
        "contractor", "usual manner", "payment", "foundry", "construction",
    ],
    "Insurance Policy Burglary Coverage": [
        "insurance", "felonious", "burglary", "theft", "visible marks",
    ],
}
_TITLE_INDEX = {title: i for i, title in enumerate(LEGAL_PROMPT_KEYWORDS)}
_WORD = 3
_SELF_KAPPA, _COMBINED, _FIGURE = 0, 1, 2


def prepare_model_data(df: Table) -> Table:
    """Per-prompt inter-model agreement from the D2 CSV (:76-145)."""
    with np.errstate(invalid="ignore"):
        df = df.assign("binary_decision",
                       (df["relative_prob"] > 0.5).astype(int))
    rows = []
    for prompt, group in df.groups("prompt"):
        if len({m for m in group["model"] if not is_missing(m)}) < 2:
            continue
        stats = per_prompt_mean_pairwise_kappa(group["binary_decision"])
        rows.append(
            {
                "prompt": prompt,
                "avg_pairwise_kappa": stats["avg_pairwise_agreement"],
                "n_models": stats["n_models"],
                "agree_percent": stats["agree_percent"],
            }
        )
    return Table.from_records(rows)


def prepare_perturbation_data(
    df: Table, seed: int = 42, n_bootstrap: int = 1000, device="cuda"
) -> Table:
    """Per-prompt perturbation self-kappa from the D6 artifact (:147-218)."""
    if "Total_Prob" not in df:
        df = df.assign("Total_Prob", df["Token_1_Prob"] + df["Token_2_Prob"])
    if "Relative_Prob" not in df:
        with np.errstate(invalid="ignore", divide="ignore"):
            df = df.assign("Relative_Prob",
                           df["Token_1_Prob"] / df["Total_Prob"])
    with np.errstate(invalid="ignore"):
        df = df.assign("binary_decision",
                       (df["Relative_Prob"] > 0.5).astype(int))

    rows = []
    for g, (prompt, group) in enumerate(df.groups("Original Main Part")):
        decisions = group["binary_decision"]
        mean_dec = float(decisions.mean())
        boot = self_kappa_bootstrap(
            decisions, generator_for(seed, _WORD, _SELF_KAPPA, g),
            n_boot=n_bootstrap, device=device)
        rows.append(
            {
                "prompt": prompt,
                "n_variations": int(decisions.size),
                "agree_percent": mean_dec if mean_dec > 0.5 else 1 - mean_dec,
                **boot,
            }
        )
    return Table.from_records(rows)


def _keyword_match(
    df: Table, columns: Sequence[str]
) -> Dict[str, Dict[str, object]]:
    """title -> first row whose prompt text contains any keyword, case
    ignored (:247-311)."""
    out: Dict[str, Dict[str, object]] = {}
    for title, keywords in LEGAL_PROMPT_KEYWORDS.items():
        for col in columns:
            if title in out or col not in df:
                continue
            for keyword in keywords:
                needle = keyword.upper()
                hits = [i for i, text in enumerate(df[col])
                        if isinstance(text, str) and needle in text.upper()]
                if hits:
                    out[title] = {c: df[c][hits[0]] for c in df.columns}
                    break
            if title in out:
                break
    return out


def match_legal_prompts(
    model_kappa: Table, pert_kappa: Table
) -> Tuple[Table, Table]:
    """Keyword-match the 5 legal prompts in both prepared tables
    (:220-326).

    The model-comparison CSV holds the 50 word-meaning questions, so in the
    canonical data it matches few/none of the legal keywords — preserved
    behavior; the combiner then runs on whatever titles match in both.
    """
    model_rows = []
    for title, row in _keyword_match(model_kappa, ["prompt"]).items():
        model_rows.append(
            {
                "title": title,
                "prompt": row["prompt"],
                "avg_pairwise_kappa": row["avg_pairwise_kappa"],
                "n_models": row["n_models"],
                "agree_percent": row["agree_percent"],
                "source": "model_comparison",
            }
        )
    pert_rows = []
    for title, row in _keyword_match(pert_kappa, ["prompt"]).items():
        pert_rows.append(
            {
                "title": title,
                "prompt": row["prompt"],
                "self_kappa": row["self_kappa"],
                "n_variations": row["n_variations"],
                "agree_percent": row["agree_percent"],
                "source": "perturbation",
            }
        )
    return Table.from_records(model_rows), Table.from_records(pert_rows)


def combine_kappas(
    model_legal: Table,
    pert_legal: Table,
    seed: int = 42,
    n_bootstrap: int = 1000,
    device="cuda",
) -> Dict[str, Dict[str, object]]:
    """Min-of-draws combination per matched title (:566-600)."""
    out: Dict[str, Dict[str, object]] = {}
    for title in model_legal.unique("title"):
        mdata = model_legal.where("title", title)
        pdata = pert_legal.where("title", title)
        if len(mdata) == 0 or len(pdata) == 0:
            continue
        m_kappa = series_mean(mdata["avg_pairwise_kappa"])
        m_std = series_std(mdata["avg_pairwise_kappa"]) if len(mdata) > 1 else 0.1
        p_kappa = series_mean(pdata["self_kappa"])
        p_std = series_std(pdata["self_kappa"]) if len(pdata) > 1 else 0.1
        combined = combined_kappa(
            m_kappa, p_kappa,
            generator_for(seed, _WORD, _COMBINED, _TITLE_INDEX[title]),
            m_std, p_std, n_boot=n_bootstrap, device=device,
        )
        out[title] = {
            "model_kappa": m_kappa,
            "model_kappa_std": m_std,
            "model_interpretation": interpret_kappa(m_kappa),
            "perturbation_kappa": p_kappa,
            "perturbation_kappa_std": p_std,
            "perturbation_interpretation": interpret_kappa(p_kappa),
            "combined": combined,
            "combined_interpretation": interpret_kappa(combined["mean_kappa"]),
        }
    return out


def combined_results_frame(combined: Dict[str, Dict[str, object]]) -> Table:
    rows = []
    for title, res in combined.items():
        rows.append(
            {
                "Prompt": title,
                "Model Kappa": res["model_kappa"],
                "Model Kappa Std": res["model_kappa_std"],
                "Model Interpretation": res["model_interpretation"],
                "Perturbation Kappa": res["perturbation_kappa"],
                "Perturbation Kappa Std": res["perturbation_kappa_std"],
                "Perturbation Interpretation": res["perturbation_interpretation"],
                "Combined Mean Kappa": res["combined"]["mean_kappa"],
                "Combined Median Kappa": res["combined"]["median_kappa"],
                "Combined Lower CI": res["combined"]["lower_ci"],
                "Combined Upper CI": res["combined"]["upper_ci"],
                "Combined Interpretation": res["combined_interpretation"],
            }
        )
    return Table.from_records(rows)


def kappa_latex_table(combined: Table) -> str:
    """LaTeX summary (:630-655)."""
    lines = [
        "\\begin{table}[htbp]",
        "\\centering",
        "\\caption{Cohen's Kappa Analysis of Model Variation vs. Prompt "
        "Perturbation}",
        "\\label{tab:kappa_analysis}",
        "\\begin{tabular}{lccccc}",
        "\\hline",
        "Prompt & Model $\\kappa$ & Perturbation $\\kappa$ & Combined "
        "$\\kappa$ & 95\\% CI & Interpretation \\\\ ",
        "\\hline",
    ]
    for row in combined.records():
        short = " ".join(row["Prompt"].split()[-2:])
        ci = f"[{row['Combined Lower CI']:.3f}, {row['Combined Upper CI']:.3f}]"
        lines.append(
            f"{short} & {row['Model Kappa']:.3f} & "
            f"{row['Perturbation Kappa']:.3f} & "
            f"{row['Combined Mean Kappa']:.3f} & {ci} & "
            f"{row['Combined Interpretation']} \\\\ "
        )
    lines += ["\\hline", "\\end{tabular}", "\\end{table}", ""]
    return "\n".join(lines)


def _histogram_with_density(ax, samples: np.ndarray) -> None:
    """A histogram with its Gaussian kernel density (seaborn's
    ``histplot(kde=True)`` in the JAX package)."""
    from scipy.stats import gaussian_kde

    counts, edges, _ = ax.hist(samples, bins="auto", alpha=0.6)
    if np.ptp(samples) > 0:
        grid = np.linspace(edges[0], edges[-1], 200)
        scale = samples.size * (edges[1] - edges[0])
        ax.plot(grid, gaussian_kde(samples)(grid) * scale)


def _plots(
    combined: Dict[str, Dict[str, object]],
    out_dir: Path,
    seed: int,
    n_bootstrap: int = 1000,
) -> None:
    """Bar + scatter + per-title distribution figures (:396-513)."""
    titles = list(combined.keys())
    if not titles:
        return
    plt = pyplot()
    model_k = [combined[t]["model_kappa"] for t in titles]
    pert_k = [combined[t]["perturbation_kappa"] for t in titles]
    comb_k = [combined[t]["combined"]["mean_kappa"] for t in titles]

    x = np.arange(len(titles))
    width = 0.25
    fig, ax = plt.subplots(figsize=(14, 8))
    ax.bar(x - width, model_k, width, label="Model Variation Kappa")
    ax.bar(x, pert_k, width, label="Perturbation Kappa")
    ax.bar(x + width, comb_k, width, label="Combined Kappa")
    ax.set_ylabel("Cohen's Kappa Value")
    ax.set_title("Comparison of Kappa Values by Source of Variation")
    ax.set_xticks(x)
    ax.set_xticklabels(
        [" ".join(t.split()[-2:]) for t in titles], rotation=45, ha="right"
    )
    for level in (0, 0.2, 0.4, 0.6, 0.8):
        ax.axhline(level, color="gray", linestyle="--", alpha=0.5)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "kappa_comparison_bar.png", dpi=150,
                bbox_inches="tight")
    plt.close(fig)

    # Per-title bootstrap distribution (fresh draws for the histogram —
    # combined_kappa returns summary stats, the figure needs the samples).
    for title in titles:
        res = combined[title]
        gen = generator_for(seed, _WORD, _FIGURE, _TITLE_INDEX[title])
        z_m = standard_normal(gen, (n_bootstrap,), "cpu").numpy()
        z_p = standard_normal(gen, (n_bootstrap,), "cpu").numpy()
        m = res["model_kappa"] + res["model_kappa_std"] * z_m
        p = res["perturbation_kappa"] + res["perturbation_kappa_std"] * z_p
        samples = np.minimum(m, p)
        fig, ax = plt.subplots(figsize=(10, 6))
        _histogram_with_density(ax, samples)
        ax.axvline(res["combined"]["mean_kappa"], color="r", linestyle="--",
                   label=f"Mean: {res['combined']['mean_kappa']:.3f}")
        ax.axvline(res["combined"]["lower_ci"], color="g", linestyle=":",
                   label=f"2.5th percentile: {res['combined']['lower_ci']:.3f}")
        ax.axvline(res["combined"]["upper_ci"], color="g", linestyle=":",
                   label=f"97.5th percentile: {res['combined']['upper_ci']:.3f}")
        ax.set_xlabel("Cohen's Kappa Value")
        ax.set_ylabel("Frequency")
        ax.set_title(f"Bootstrap Distribution of Combined Kappa: {title}")
        ax.legend()
        fig.tight_layout()
        short = "_".join(title.split()[-2:]).lower()
        fig.savefig(out_dir / f"kappa_distribution_{short}.png", dpi=150,
                    bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.scatter(model_k, pert_k, s=100, alpha=0.7)
    lo = min(min(model_k), min(pert_k))
    hi = max(max(model_k), max(pert_k))
    ax.plot([lo, hi], [lo, hi], "k--", alpha=0.5)
    for i, t in enumerate(titles):
        ax.annotate(" ".join(t.split()[-2:]), (model_k[i], pert_k[i]),
                    fontsize=12, xytext=(5, 5), textcoords="offset points")
    ax.set_xlabel("Model Variation Kappa")
    ax.set_ylabel("Perturbation Kappa")
    ax.set_title("Model Variation vs. Prompt Perturbation Kappa")
    ax.grid(True, alpha=0.3)
    for val in (0.2, 0.4, 0.6, 0.8):
        ax.axhline(val, color="gray", linestyle="--", alpha=0.2)
        ax.axvline(val, color="gray", linestyle="--", alpha=0.2)
    fig.tight_layout()
    fig.savefig(out_dir / "kappa_scatter.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def run_kappa_analysis(
    instruct_csv: Path,
    perturbation_results: Path,
    out_dir: Path,
    seed: int = 42,
    n_bootstrap: int = 1000,
    make_figures: bool = True,
    device="cuda",
) -> Dict[str, object]:
    """Full C29 pipeline; artifact names match the reference (:560-658)."""
    dev = resolve_device(device)
    if make_figures:
        require_matplotlib()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    model_df = read_table(instruct_csv)
    pert_df = read_results_frame(Path(perturbation_results))

    model_kappa = prepare_model_data(model_df)
    pert_kappa = prepare_perturbation_data(pert_df, seed, n_bootstrap, dev)
    model_kappa.to_csv(out_dir / "model_kappa_metrics.csv")
    pert_kappa.to_csv(out_dir / "perturbation_kappa_metrics.csv")

    model_legal, pert_legal = match_legal_prompts(model_kappa, pert_kappa)
    model_legal.to_csv(out_dir / "model_legal_kappas.csv")
    pert_legal.to_csv(out_dir / "perturbation_legal_kappas.csv")

    combined: Dict[str, Dict[str, object]] = {}
    if len(model_legal) and len(pert_legal):
        combined = combine_kappas(model_legal, pert_legal, seed, n_bootstrap,
                                  dev)
    else:
        log.info(
            "No matched legal prompts across datasets (%d model, %d "
            "perturbation) — combined kappa skipped",
            len(model_legal), len(pert_legal),
        )

    combined_table = combined_results_frame(combined)
    combined_table.to_csv(out_dir / "combined_kappa_results.csv")
    (out_dir / "kappa_analysis_table.tex").write_text(
        kappa_latex_table(combined_table)
    )
    if make_figures and combined:
        _plots(combined, out_dir, seed, n_bootstrap)

    return {
        "model_kappa": model_kappa,
        "perturbation_kappa": pert_kappa,
        "combined": combined,
        "combined_frame": combined_table,
    }


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--instruct", type=Path, required=True,
                        help="D2 instruct_model_comparison_results.csv")
    parser.add_argument("--perturbation", type=Path, required=True,
                        help="D6 perturbation results artifact")
    parser.add_argument("--out", type=Path, default=Path("results/kappa"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-figures", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    run_kappa_analysis(
        args.instruct, args.perturbation, args.out, seed=args.seed,
        make_figures=not args.no_figures, device=args.device,
    )


if __name__ == "__main__":
    main()
