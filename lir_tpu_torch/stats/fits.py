"""Zero/one-inflated truncated-normal Monte-Carlo fitter.

Port of ``lir_tpu/stats/fits.py``. Parity target:
conduct_truncated_normal_test (analyze_perturbation_results.py:113-337):
<= 30 iterations, each drawing 100,000 normals, clipping to [0, 1] and
moment-matching with damping 0.5 / tolerance 1e-4. The JAX package's
``lax.while_loop`` becomes a loop on ``device`` whose iteration ``i``
takes row ``i`` of a (max_iterations, n_simulations) block of standard
normals (``_fit_loop``, a pure function of the draws); the convergence
test reads one scalar an iteration (at most 30 host syncs: finalize code,
not the sweep's hot loop).

The goodness-of-fit readout (two-sample KS + Anderson k-sample) stays on
scipy: those are one-shot host-side tests on the final sample, not hot.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch
from scipy import stats as scipy_stats

from ..device import resolve_device
from .core import standard_normal

EPSILON = 1e-6  # zero/one tolerance, analyze_perturbation_results.py:151


def _simulate(z: torch.Tensor, mu, sigma) -> torch.Tensor:
    return torch.clip(mu + sigma * z, 0.0, 1.0)


def _fit_loop(draws: torch.Tensor, target_mean: torch.Tensor,
              target_std: torch.Tensor, tol: float, damping: float
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Iterative moment matching over the rows of ``draws``
    (max_iterations, n_simulations); returns (mu, sigma, iterations)."""
    mu, sigma = target_mean, target_std
    iters = 0
    for z in draws:
        sim = _simulate(z, mu, sigma)
        sim_mean, sim_std = sim.mean(), sim.std(correction=0)
        converged = ((torch.abs(sim_mean - target_mean) < tol)
                     & (torch.abs(sim_std - target_std) < tol))
        # Multiplicative adjustment with damping, plus a direct additive mean
        # shift when the mean is off by > 1e-3 (reference :216-243).
        mean_adj = 1 + damping * (
            torch.where(sim_mean > 0, target_mean / sim_mean, 1.0) - 1)
        std_adj = 1 + damping * (
            torch.where(sim_std > 0, target_std / sim_std, 1.0) - 1)
        new_mu = mu * mean_adj
        new_sigma = sigma * std_adj
        new_mu = new_mu + torch.where(
            torch.abs(sim_mean - target_mean) > 0.001,
            damping * (target_mean - sim_mean), 0.0)
        mu = torch.where(converged, mu, new_mu)
        sigma = torch.where(converged, sigma, new_sigma)
        iters += 1
        if bool(converged):
            break
    return mu, sigma, iters


def truncated_normal_mc_fit(
    values: np.ndarray,
    generator: torch.Generator,
    n_simulations: int = 100_000,
    max_iterations: int = 30,
    tol: float = 1e-4,
    damping: float = 0.5,
    prompt_idx: int = 0,
    column_name: str = "",
    device="cuda",
) -> Tuple[Dict[str, object], np.ndarray]:
    """Fit clip(N(mu, sigma), 0, 1) to `values` by MC moment matching and test
    the fit. Returns (results dict in the reference's schema, final sample).
    The fit's (max_iterations, n_simulations) normals are drawn from
    ``generator`` first, then the final sample's n_simulations.
    """
    values = np.asarray(values, dtype=np.float64)
    values = values[np.isfinite(values)]

    base = {
        "Prompt": prompt_idx + 1,
        "Column": column_name,
        "Model Type": "Truncated Normal with Zero/One Inflation",
    }
    failure_nans = {
        "KS Statistic": float("nan"),
        "KS p-value": float("nan"),
        "AD Statistic": float("nan"),
        "AD p-value": float("nan"),
        "Interior Mean": float("nan"),
        "Interior Std Dev": float("nan"),
        "Model Adequate (KS p>0.05)": False,
        "Model Adequate (AD p>0.05)": False,
        "Model Adequate (Combined)": False,
    }
    if values.size == 0:
        return {
            **base,
            "Model Fit": "Failed - No finite values",
            "Zero Proportion": float("nan"),
            "One Proportion": float("nan"),
            **failure_nans,
        }, np.array([])

    zero_prop = float(np.mean(values < EPSILON))
    one_prop = float(np.mean(values > 1 - EPSILON))
    interior = values[(values >= EPSILON) & (values <= 1 - EPSILON)]
    if interior.size == 0:
        return {
            **base,
            "Model Fit": "Failed - All values are 0 or 1",
            "Zero Proportion": zero_prop,
            "One Proportion": one_prop,
            **failure_nans,
        }, np.array([])

    target_mean = float(values.mean())
    target_std = float(values.std())

    dev = resolve_device(device)
    draws = standard_normal(generator, (max_iterations, n_simulations), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    mu, sigma, iters = _fit_loop(draws, torch.tensor(target_mean, **f32),
                                 torch.tensor(target_std, **f32), tol,
                                 damping)
    mu, sigma = float(mu), float(sigma)
    z = standard_normal(generator, (n_simulations,), dev)
    sample = _simulate(z, mu, sigma).cpu().numpy().astype(np.float64)
    sim_mean, sim_std = float(sample.mean()), float(sample.std())

    mean_err = abs(sim_mean - target_mean) / target_mean if target_mean else abs(sim_mean)
    std_err = abs(sim_std - target_std) / target_std if target_std else abs(sim_std)

    # Fallback: direct scipy truncnorm sampling when MC accuracy is poor
    # (reference :259-290).
    if mean_err > 0.01 or std_err > 0.01:
        a, b = (0 - mu) / sigma, (1 - mu) / sigma
        alt = scipy_stats.truncnorm.rvs(
            a, b, loc=mu, scale=sigma, size=n_simulations,
            random_state=np.random.default_rng(42),
        )
        alt_mean_err = abs(alt.mean() - target_mean) / target_mean if target_mean else abs(alt.mean())
        alt_std_err = abs(alt.std() - target_std) / target_std if target_std else abs(alt.std())
        if alt_mean_err < mean_err and alt_std_err < std_err:
            sample = alt
            sim_mean, sim_std = float(alt.mean()), float(alt.std())
            mean_err, std_err = alt_mean_err, alt_std_err

    ks_stat, ks_p = scipy_stats.ks_2samp(values, sample)
    try:
        with warnings.catch_warnings():
            # midrank-deprecation and p-value-capped/floored notices are
            # informational; the statistic is what the artifact records.
            warnings.simplefilter("ignore", UserWarning)
            ad = scipy_stats.anderson_ksamp([values, sample])
        ad_stat, ad_p = float(ad.statistic), float(ad.pvalue)
        ad_ok = ad_p > 0.05
    except Exception:
        ad_stat, ad_p, ad_ok = float("nan"), float("nan"), False

    results = {
        **base,
        "Underlying Normal Mean": mu,
        "Underlying Normal Std Dev": sigma,
        "Observed Mean": target_mean,
        "Observed Std Dev": target_std,
        "Simulated Mean": sim_mean,
        "Simulated Std Dev": sim_std,
        "Mean Relative Error": float(mean_err),
        "Std Relative Error": float(std_err),
        "Zero Proportion": zero_prop,
        "One Proportion": one_prop,
        "Interior Mean": float(interior.mean()),
        "Interior Std Dev": float(interior.std()),
        "Iterations": int(iters),
        "KS Statistic": float(ks_stat),
        "KS p-value": float(ks_p),
        "AD Statistic": ad_stat,
        "AD p-value": ad_p,
        "Model Adequate (KS p>0.05)": bool(ks_p > 0.05),
        "Model Adequate (AD p>0.05)": bool(ad_ok),
        "Model Adequate (Combined)": bool(ks_p > 0.05) and bool(ad_ok),
    }
    return results, sample
