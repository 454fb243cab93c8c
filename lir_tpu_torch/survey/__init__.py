"""Human-survey analysis subsystem (reference: survey_analysis/*, C31-C43).

Port of ``lir_tpu/survey``: one load/clean/match pass (the pandas-free
``data.table``) feeding the port's batched statistics on ``device``;
every reference artifact schema is reproduced by
``lir_tpu_torch.survey.run``.
"""

from .loader import (
    all_question_cols,
    apply_exclusions,
    canonical_question_mapping,
    extract_question_text,
    group_question_ids,
    load_survey,
    load_survey_detailed,
    match_survey_to_llm_questions,
    survey_detailed,
    write_survey_detailed,
)
from .consolidated import (
    consolidated_results_payload,
    cross_prompt_difference_ci,
    format_report,
    human_cross_prompt_correlations,
    human_llm_correlation,
    human_responses_by_question,
    llm_cross_prompt_correlations,
    llm_responses_by_question,
    meta_correlation,
    run_consolidated_analysis,
    save_consolidated_results,
)
from .human_llm import (
    agreement_metrics,
    analyze_all_models,
    bootstrap_agreement_metrics,
    bootstrap_all_models,
    bootstrap_results_payload,
    difference_stats,
    human_averages_from_detailed,
    llm_prompt_estimates_from_accum,
    matched_pairs_analysis,
    relative_prob_series,
    write_agreement_analysis,
    write_bootstrap_results,
)
from .simulated import (
    individual_correlations,
    model_group_tensors,
    run_simulated_bootstrap,
    write_simulated_bootstrap,
)
from .family_differences import (
    analyze_family_differences,
    write_family_differences,
)
from .pvalues import (
    compare_correlation_distributions,
    human_correlations_with_pvalues,
    llm_correlations_with_pvalues,
    pearson_pvalues,
    run_pvalue_analysis,
    write_pvalue_analysis,
)
from .proportions import (
    run_proportion_analysis,
    write_proportion_analysis,
)
from .run import run_survey_pipeline
