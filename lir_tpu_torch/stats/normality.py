"""Normality tests (KS vs fitted normal + Anderson-Darling).

A copy of ``lir_tpu/stats/normality.py`` (numpy and scipy only; the port
imports nothing of the JAX package).

Parity target: conduct_normality_tests (analyze_perturbation_results.py:
21-110). These are one-shot host-side tests per (model, prompt, column) —
not hot — so they wrap scipy directly; the value of this module is the exact
output schema and the reference's banded AD p-value approximation (scipy has
no AD p-value; SURVEY.md §7 notes the approximation is kept and documented).
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
from scipy import stats as scipy_stats


def anderson_darling_pvalue(statistic: float, critical_values: np.ndarray) -> float:
    """Banded p-value approximation from the AD critical values
    (analyze_perturbation_results.py:82-94). `critical_values` is scipy's
    5-vector for significance levels [15%, 10%, 5%, 2.5%, 1%]."""
    if statistic > 10:
        return 0.0001
    if statistic > critical_values[4]:
        return 0.005
    if statistic > critical_values[3]:
        return 0.015
    if statistic > critical_values[2]:
        return 0.035
    if statistic > critical_values[1]:
        return 0.075
    return 0.15


def normality_tests(
    values: np.ndarray, prompt_idx: int = 0
) -> Dict[str, object]:
    """KS test vs a fitted normal + Anderson-Darling, reference schema."""
    values = np.asarray(values, dtype=np.float64)
    values = values[np.isfinite(values)]

    empty = {
        "Prompt": prompt_idx + 1,
        "Distribution Mean": float("nan"),
        "Distribution Std Dev": float("nan"),
        "KS Statistic": float("nan"),
        "KS p-value": float("nan"),
        "KS Normal (p>0.05)": False,
        "AD Statistic": float("nan"),
        "AD p-value": float("nan"),
        "AD Critical Value (5%)": float("nan"),
        "AD Normal (stat<crit)": False,
    }
    if values.size == 0:
        return empty
    if values.size < 3:
        empty["Distribution Mean"] = float(values.mean())
        if values.size > 1:
            empty["Distribution Std Dev"] = float(values.std())
        return empty

    mu, sigma = scipy_stats.norm.fit(values)
    # The fitted normal's CDF as a callable: the same norm.cdf(x, mu,
    # sigma) that kstest(values, "norm", args=(mu, sigma)) evaluates,
    # where scipy 1.18 routes the string to a CDF that takes no loc/scale.
    ks_stat, ks_p = scipy_stats.kstest(
        values, lambda x: scipy_stats.norm.cdf(x, mu, sigma))
    with warnings.catch_warnings():
        # scipy >= 1.17 deprecates the critical-value result shape; we use
        # exactly that shape (statistic + critical values) to reproduce the
        # reference's hand-rolled p approximation, so keep it and silence
        # the migration warning.
        warnings.simplefilter("ignore", FutureWarning)
        ad = scipy_stats.anderson(values, "norm")
    ad_p = anderson_darling_pvalue(float(ad.statistic), np.asarray(ad.critical_values))

    return {
        "Prompt": prompt_idx + 1,
        "Distribution Mean": float(mu),
        "Distribution Std Dev": float(sigma),
        "KS Statistic": float(ks_stat),
        "KS p-value": float(ks_p),
        "KS Normal (p>0.05)": bool(ks_p > 0.05),
        "AD Statistic": float(ad.statistic),
        "AD p-value": float(ad_p),
        "AD Critical Value (5%)": float(ad.critical_values[2]),
        "AD Normal (stat<crit)": bool(ad.statistic < ad.critical_values[2]),
    }


def compare_distributions(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Distribution-comparison battery: Mann-Whitney U, two-sample KS,
    Welch t-test, Cohen's d (calculate_correlation_pvalues.py:138-204)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a, b = a[np.isfinite(a)], b[np.isfinite(b)]
    u_stat, u_p = scipy_stats.mannwhitneyu(a, b, alternative="two-sided")
    ks_stat, ks_p = scipy_stats.ks_2samp(a, b)
    t_stat, t_p = scipy_stats.ttest_ind(a, b, equal_var=False)
    pooled = np.sqrt(
        ((a.size - 1) * a.var(ddof=1) + (b.size - 1) * b.var(ddof=1))
        / (a.size + b.size - 2)
    )
    d = float((a.mean() - b.mean()) / pooled) if pooled > 0 else float("nan")
    return {
        "mannwhitney_u": float(u_stat),
        "mannwhitney_p": float(u_p),
        "ks_statistic": float(ks_stat),
        "ks_p": float(ks_p),
        "t_statistic": float(t_stat),
        "t_p": float(t_p),
        "cohens_d": d,
        "n_a": int(a.size),
        "n_b": int(b.size),
        "mean_a": float(a.mean()),
        "mean_b": float(b.mean()),
    }
