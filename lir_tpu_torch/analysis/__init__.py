"""Statistical analysis drivers (reference: analysis/analyze_*.py,
calculate_cohens_kappa.py, model_comparison_graph.py — C20-C30).

Port of ``lir_tpu/analysis``: each driver consumes a data artifact and
writes the reference's CSV/LaTeX/figure outputs, reading and writing
through the pandas-free ``data.table``, with the hot statistics on the
port's ``stats`` on ``device``.
"""

from .perturbation import (
    add_relative_prob,
    analyze_all_models,
    analyze_model,
    assert_compliance,
    check_confidence_compliance,
    check_output_compliance,
    expected_compliance_tokens,
    parse_logprob_content,
    perturbation_kappa,
    prompt_summary_stats,
)
from .base_vs_instruct import (
    family_differences,
    process_model_pair,
    run_base_vs_instruct_analysis,
)
from .kappa_combined import (
    combine_kappas,
    kappa_latex_table,
    match_legal_prompts,
    prepare_model_data,
    prepare_perturbation_data,
    run_kappa_analysis,
)
from .model_graph import (
    abbreviated_model_name,
    filter_models,
    prompt_model_pivot,
    reference_model_differences,
    run_model_graph_analysis,
)
