"""End-to-end survey analysis pipeline driver.

Port of ``lir_tpu/survey/run.py``: one pass that loads and cleans the
survey once and writes every artifact, with the same names, in the same
order:

  survey_analysis_detailed.json        (D7 - producer missing upstream)
  consolidated_analysis_results.json   (D8) + consolidated_report.txt
  llm_human_agreement_analysis.json    (C39) + its two figures
  llm_human_agreement_bootstrap.json   (D9, C41)
  family_differences.json              (C42)
  bootstrap_confidence_intervals.json  (C38, with a D1)
  correlation_pvalues_analysis.json    (C43, with a D1) + its figure
  proportion_analysis.json             (analyze_base_vs_instruct_vs_human)

Two arguments the JAX driver does not have: ``device`` (where the
statistics run; default the card) and ``make_figures`` (default True,
the JAX output; False writes every JSON and text file and no PNG, for a
machine without matplotlib). Random draws: one CPU generator a draw,
``stats.core.generator_for(seed, 4, ...)`` (each module's docstring
gives its words), so a model's numbers do not depend on which blocks or
figures ran.

Usage:
  python -m lir_tpu_torch.survey.run --survey data/word_meaning_survey_results.csv \\
      --instruct data/instruct_model_comparison_results.csv \\
      --base data/model_comparison_results.csv --out results/survey
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

from ..data.table import read_table
from ..device import resolve_device
from ..report import survey_figures
from ..report.figures import require_matplotlib
from ..utils.logging import get_logger
from . import consolidated, family_differences, human_llm, loader, proportions
from . import pvalues as pvalues_mod
from . import simulated

log = get_logger(__name__)

QUICK_BUDGETS = dict(n_bootstrap_standard=50, n_bootstrap_small=20,
                     n_bootstrap_large=200)


def run_survey_pipeline(
    survey_csv: Path,
    instruct_csv: Path,
    base_csv: Optional[Path],
    out_dir: Path,
    seed: int = 42,
    n_bootstrap_standard: int = 1000,
    n_bootstrap_small: int = 100,
    n_bootstrap_large: int = 10_000,
    run_simulated_individuals: bool = True,
    make_figures: bool = True,
    device="cuda",
) -> Dict[str, object]:
    """Run every survey analysis and write all artifacts into `out_dir`.

    Returns the in-memory results keyed by artifact name.
    """
    dev = resolve_device(device)
    if make_figures:
        require_matplotlib()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    log.info("Loading survey data from %s", survey_csv)
    survey_df, question_cols = loader.load_survey(survey_csv)
    clean_df, exclusion_stats = loader.apply_exclusions(survey_df, question_cols)
    log.info(
        "Exclusions: %d -> %d respondents",
        exclusion_stats["final_count"] + exclusion_stats["total_excluded"],
        exclusion_stats["final_count"],
    )

    instruct_df = read_table(Path(instruct_csv))
    base_df = read_table(Path(base_csv)) if base_csv else None

    question_mapping_text = loader.extract_question_text(survey_csv)
    matches = loader.match_survey_to_llm_questions(
        instruct_df, question_mapping_text
    )
    canonical = loader.canonical_question_mapping()

    # D7 — the detailed per-question stats the downstream scripts assume.
    detailed = loader.write_survey_detailed(
        clean_df, question_cols, out_dir / "survey_analysis_detailed.json"
    )

    # D8 — consolidated analysis.
    log.info("Running consolidated analysis")
    analysis = consolidated.run_consolidated_analysis(
        clean_df, question_cols, instruct_df, matches, exclusion_stats,
        seed, n_bootstrap_standard, n_bootstrap_small, dev,
    )
    consolidated.save_consolidated_results(
        analysis, out_dir / "consolidated_analysis_results.json"
    )
    (out_dir / "consolidated_report.txt").write_text(
        consolidated.format_report(analysis)
    )

    # C39 — point agreement metrics + figures.
    log.info("Running human-LLM agreement metrics")
    human_avgs = human_llm.human_averages_from_detailed(detailed, canonical)
    point_results = human_llm.analyze_all_models(human_avgs, instruct_df, base_df)
    human_llm.write_agreement_analysis(
        point_results, human_avgs, out_dir / "llm_human_agreement_analysis.json"
    )
    if make_figures:
        survey_figures.best_worst_agreement_plot(
            point_results, out_dir / "best_worst_model_agreement.png"
        )
        survey_figures.mae_comparison_plot(
            point_results, out_dir / "model_mae_comparison.png"
        )

    # C41 / D9 — question-resampled bootstrap.
    log.info("Running question-resampled bootstrap (n=%d)", n_bootstrap_standard)
    boot_results = human_llm.bootstrap_all_models(
        human_avgs, instruct_df, base_df, seed, n_bootstrap_standard, dev
    )
    d9_payload = human_llm.bootstrap_results_payload(
        boot_results, seed, n_bootstrap_standard, n_bootstrap_large, dev
    )
    # Matched-pairs analysis (reference stdout, :392-444) rides along in the
    # D9 JSON under an extra key — consumers read model_results only.
    d9_payload["matched_pairs"] = human_llm.matched_pairs_analysis(boot_results)
    human_llm.write_bootstrap_results(
        d9_payload, out_dir / "llm_human_agreement_bootstrap.json"
    )

    # C42 — family differences from D9.
    fam = family_differences.analyze_family_differences(d9_payload, seed,
                                                        device=dev)
    family_differences.write_family_differences(
        fam, out_dir / "family_differences.json"
    )

    results: Dict[str, object] = {
        "detailed": detailed,
        "consolidated": analysis,
        "agreement_points": point_results,
        "agreement_bootstrap": d9_payload,
        "family_differences": fam,
    }

    # C38 — simulated-individual bootstrap (heavy; needs the D1 CSV).
    if run_simulated_individuals and base_df is not None:
        log.info("Running simulated-individual bootstrap (n=%d)", n_bootstrap_large)
        sim = simulated.run_simulated_bootstrap(
            base_df, canonical, detailed, seed,
            n_bootstrap=n_bootstrap_large, device=dev,
        )
        simulated.write_simulated_bootstrap(
            sim, out_dir / "bootstrap_confidence_intervals.json"
        )
        results["simulated_bootstrap"] = sim

    # C43 — correlation p-values (own exclusion rules, raw survey frame).
    if base_df is not None:
        log.info("Running correlation p-value analysis")
        pv = pvalues_mod.run_pvalue_analysis(instruct_df, base_df, survey_df,
                                             device=dev)
        pvalues_mod.write_pvalue_analysis(
            pv, out_dir / "correlation_pvalues_analysis.json"
        )
        if make_figures:
            survey_figures.correlation_pvalue_panel(
                pv["llm_correlations"], pv["human_correlations"],
                out_dir / "correlation_pvalue_distributions.png",
            )
        results["pvalues"] = pv

    # Proportion-based comparison + validity audit.
    prop = proportions.run_proportion_analysis(instruct_df, detailed, canonical)
    proportions.write_proportion_analysis(
        prop, out_dir / "proportion_analysis.json"
    )
    results["proportions"] = prop

    log.info("Survey pipeline complete; artifacts in %s", out_dir)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--survey", type=Path, required=True)
    parser.add_argument("--instruct", type=Path, required=True)
    parser.add_argument("--base", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=Path("results/survey"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--quick", action="store_true",
                        help="reduced bootstrap budgets for smoke runs")
    parser.add_argument("--no-figures", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    kwargs = dict(QUICK_BUDGETS, run_simulated_individuals=True) \
        if args.quick else {}
    run_survey_pipeline(
        args.survey, args.instruct, args.base, args.out, seed=args.seed,
        make_figures=not args.no_figures, device=args.device, **kwargs,
    )


if __name__ == "__main__":
    main()
