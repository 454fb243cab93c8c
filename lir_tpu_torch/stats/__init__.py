"""Statistics: bootstrap CIs, kappa variants, pairwise agreement,
correlation matrices, truncated-normal MC fits, normality tests and the
streaming-statistics finalize.

Port of ``lir_tpu/stats``: the same modules and public names, as torch
functions on an explicit ``device`` (default the card) with explicit
CPU ``torch.Generator``s in place of ``jax.random`` keys; scipy stays for
the one-shot host-side tests, as in the reference.
"""

from .agreement import pairwise_agreement_stats, per_item_agreement
from .bootstrap import (
    BootstrapResult,
    bootstrap_correlation,
    bootstrap_mean_ci,
    bootstrap_metric_matrix,
    mae,
    mape,
    normal_approx_mc_difference,
    permutation_test_difference,
    rmse,
    simulate_individuals,
)
from .core import (
    average_ranks,
    generator_for,
    nan_filter,
    pearson,
    percentile_ci,
    resample_indices,
    spearman,
)
from .correlations import (
    bootstrap_correlation_matrix,
    cross_rater_mean_correlation,
    masked_pearson_matrix,
    masked_spearman_matrix,
)
from .fits import truncated_normal_mc_fit
from .kappa import (
    aggregate_kappa,
    cohen_kappa,
    combined_kappa,
    interpret_kappa,
    pairwise_kappa_matrix,
    per_prompt_mean_pairwise_kappa,
    self_kappa_bootstrap,
    within_group_kappa,
)
from .normality import (
    anderson_darling_pvalue,
    compare_distributions,
    normality_tests,
)
from .streaming import (
    HostAccum,
    accum_from_rows,
    assert_parity,
    merge_accums,
    slot_map_from_cells,
    summarize as summarize_accum,
)

__all__ = [
    "BootstrapResult",
    "HostAccum",
    "accum_from_rows",
    "assert_parity",
    "merge_accums",
    "slot_map_from_cells",
    "summarize_accum",
    "aggregate_kappa",
    "anderson_darling_pvalue",
    "average_ranks",
    "bootstrap_correlation",
    "bootstrap_correlation_matrix",
    "bootstrap_mean_ci",
    "bootstrap_metric_matrix",
    "cohen_kappa",
    "combined_kappa",
    "compare_distributions",
    "cross_rater_mean_correlation",
    "generator_for",
    "interpret_kappa",
    "mae",
    "mape",
    "masked_pearson_matrix",
    "masked_spearman_matrix",
    "nan_filter",
    "normal_approx_mc_difference",
    "normality_tests",
    "pairwise_agreement_stats",
    "pairwise_kappa_matrix",
    "pearson",
    "per_item_agreement",
    "per_prompt_mean_pairwise_kappa",
    "percentile_ci",
    "permutation_test_difference",
    "resample_indices",
    "rmse",
    "self_kappa_bootstrap",
    "simulate_individuals",
    "spearman",
    "truncated_normal_mc_fit",
    "within_group_kappa",
]
