"""The port's statistics (``lir_tpu_torch/stats``) against the JAX
package's, function by function, on inputs made with numpy from a seed.

Tolerances:
- float32 on both sides (ranks, correlations, kappas, bootstrap
  reductions, the fit): TOL = 1e-6, relative for values away from 0 (the
  same float32 terms summed in another order by XLA and by torch);
- numpy/scipy float64 on both sides (within-group kappa, moments,
  normality tests, the float64 point correlation matrix): bitwise;
- each bootstrap, permutation and fit reduction is fed JAX's own draws
  (``lir_tpu.stats.core.resample_indices(key, ...)``, ``jax.random.normal``
  at the JAX key schedule, ``jax.random.permutation``), through the
  port's pure reductions and through its public functions with the
  port's draw helper replaced;
- each package on its own generator: the percentile CI endpoints within
  a Monte Carlo tolerance derived beforehand from n_boot (see
  ``_mc_tol``), never fitted to a seed.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as scipy_stats

from lir_tpu.data import schemas as jschemas
from lir_tpu.stats import agreement as jagree
from lir_tpu.stats import bootstrap as jboot
from lir_tpu.stats import core as jcore
from lir_tpu.stats import correlations as jcorr
from lir_tpu.stats import fits as jfits
from lir_tpu.stats import kappa as jkappa
from lir_tpu.stats import normality as jnorm
from lir_tpu.stats import streaming as jstream
from lir_tpu_torch.data import schemas as tschemas
from lir_tpu_torch.stats import agreement as tagree
from lir_tpu_torch.stats import bootstrap as tboot
from lir_tpu_torch.stats import core as tcore
from lir_tpu_torch.stats import correlations as tcorr
from lir_tpu_torch.stats import fits as tfits
from lir_tpu_torch.stats import kappa as tkappa
from lir_tpu_torch.stats import normality as tnorm
from lir_tpu_torch.stats import streaming as tstream

TOL = 1e-6
CPU = "cpu"


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=tol,
                               atol=tol, equal_nan=True)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _mc_tol(se: float, n_boot: int, p: float = 0.025) -> float:
    """Four standard deviations of the difference of two independent
    percentile-bootstrap estimates of the p-quantile of an approximately
    normal statistic with standard error ``se``: each estimate's standard
    deviation is sqrt(p (1 - p) / n_boot) / phi(z_p) * se (the quantile's
    asymptotic variance), the difference's sqrt(2) times that. At
    n_boot = 2,000 and p = 0.025 it is 0.34 se."""
    z = scipy_stats.norm.ppf(p)
    sd = math.sqrt(p * (1 - p) / n_boot) / scipy_stats.norm.pdf(z) * se
    return 4.0 * math.sqrt(2.0) * sd


class _Feed:
    """Stands in for a port draw helper: returns the given arrays, one a
    call, as tensors on the requested device."""

    def __init__(self, *arrays):
        self.arrays = list(arrays)
        self.calls = 0

    def __call__(self, generator, *shape_and_device):
        a = self.arrays[self.calls]
        self.calls += 1
        device = shape_and_device[-1] if shape_and_device else CPU
        return torch.from_numpy(np.asarray(a)).to(device)


def _jidx(key, n_boot, n):
    return np.asarray(jcore.resample_indices(key, n_boot, n)).astype(np.int64)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def _pairs(seed, shape, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    y = 0.6 * x + rng.normal(size=shape)
    if ties:
        x, y = np.round(x, 1), np.round(y, 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(37,), (4, 25)])
def test_pearson_ranks_spearman_match_jax(shape, ties):
    x, y = _pairs(1, shape, ties)
    close(tcore.pearson(t32(x), t32(y)), jcore.pearson(x, y))
    close(tcore.average_ranks(t32(x)), jcore.average_ranks(x))
    close(tcore.spearman(t32(x), t32(y)), jcore.spearman(x, y))
    # Ranks are scipy's average ranks.
    flat = x.reshape(-1, x.shape[-1])[0]
    close(tcore.average_ranks(t32(flat)), scipy_stats.rankdata(flat))


def test_pearson_of_a_constant_is_nan_as_in_jax():
    x = np.ones(8, np.float32)
    y = np.arange(8, dtype=np.float32)
    assert math.isnan(float(tcore.pearson(t32(x), t32(y))))
    assert math.isnan(float(jcore.pearson(x, y)))


@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_percentile_ci_matches_jax(confidence):
    rng = np.random.default_rng(2)
    s = rng.normal(size=(3, 501)).astype(np.float32)
    s[1, ::7] = np.nan
    lo, hi = tcore.percentile_ci(t32(s), confidence)
    jlo, jhi = jcore.percentile_ci(jnp.asarray(s), confidence)
    close(lo, jlo)
    close(hi, jhi)


def test_nan_filter_matches_jax():
    a = np.array([1.0, np.nan, 3.0, np.inf, 5.0])
    b = np.array([0.0, 1.0, np.nan, 2.0, 4.0])
    for args in ((a,), (a, b)):
        got, ref = tcore.nan_filter(*args), jcore.nan_filter(*args)
        for g, r in zip(got if len(args) > 1 else (got,),
                        ref if len(args) > 1 else (ref,)):
            np.testing.assert_array_equal(g, r)


def test_draws_are_cpu_generated_reproducible_and_in_range():
    idx = tcore.resample_indices(gen(5), 50, 13, CPU)
    assert idx.shape == (50, 13) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 13
    assert torch.equal(idx, tcore.resample_indices(gen(5), 50, 13, CPU))
    perms = tcore.permutations(gen(5), 20, 9, CPU)
    assert torch.equal(perms.sort(dim=-1).values,
                       torch.arange(9).expand(20, 9))
    z = tcore.standard_normal(gen(5), (4, 3), CPU)
    assert z.dtype == torch.float32 and z.shape == (4, 3)
    # The keyed rule: the same words give the same stream, any other word
    # another one.
    a = tcore.resample_indices(tcore.generator_for(42, 0, 0), 4, 100, CPU)
    assert torch.equal(a, tcore.resample_indices(
        tcore.generator_for(42, 0, 0), 4, 100, CPU))
    for words in ((42, 1, 0), (42, 0, 10_000), (43, 0, 0)):
        assert not torch.equal(a, tcore.resample_indices(
            tcore.generator_for(*words), 4, 100, CPU))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.resample_indices(gen(), 2, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tboot.bootstrap_mean_ci([1.0, 2.0, 3.0], gen())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstream.summarize(tstream.empty_accum(1, 3, 0), n_boot=10)


# ---------------------------------------------------------------------------
# kappa
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [float("nan"), -0.3, 0.0, 0.1, 0.2, 0.39,
                               0.5, 0.7, 0.8, 0.95])
def test_interpret_kappa_matches_jax(k):
    assert tkappa.interpret_kappa(k) == jkappa.interpret_kappa(k)


@pytest.mark.parametrize("case", ["random", "constant_same", "constant_diff",
                                  "batched"])
def test_cohen_kappa_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "random":
        a, b = rng.integers(0, 2, 40), rng.integers(0, 2, 40)
    elif case == "constant_same":
        a = b = np.ones(10, int)
    elif case == "constant_diff":
        a, b = np.ones(10, int), np.zeros(10, int)
    else:
        a, b = rng.integers(0, 2, (6, 30)), rng.integers(0, 2, (6, 30))
    got = tkappa.cohen_kappa(torch.from_numpy(a), torch.from_numpy(b))
    if case == "batched":
        ref = [float(jkappa.cohen_kappa(jnp.asarray(a[i]), jnp.asarray(b[i])))
               for i in range(a.shape[0])]
    else:
        ref = jkappa.cohen_kappa(jnp.asarray(a), jnp.asarray(b))
    close(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_within_group_kappa_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, 300)
    g = rng.integers(0, 7, 300)
    assert tkappa.within_group_kappa(d, g) == jkappa.within_group_kappa(d, g)
    empty = tkappa.within_group_kappa(np.array([]), np.array([]))
    assert all(math.isnan(v) for v in empty.values())


def test_pairwise_kappa_matrix_matches_jax():
    rng = np.random.default_rng(4)
    m = rng.integers(0, 2, (40, 6)).astype(float)
    m[rng.random(m.shape) < 0.15] = np.nan
    m[:, 5] = np.nan
    m[0, 5] = 1.0
    close(tkappa.pairwise_kappa_matrix(m, device=CPU),
          jkappa.pairwise_kappa_matrix(m))


def _binary(seed=5, n=50, m=18):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.2, 0.8, n)
    return (rng.random((n, m)) < p[:, None]).astype(float)


def test_aggregate_kappa_on_jax_draws():
    """The pure reduction on the JAX key schedule's own indices (split key,
    rate indices from the first half, flat from the second), and the
    public function with the same indices injected."""
    b = _binary()
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    ri, fi = _jidx(k1, 400, b.shape[0]), _jidx(k2, 400, b.size)
    ref = jkappa.aggregate_kappa(b, key, n_boot=400)
    got = tkappa.aggregate_kappa(b, None, n_boot=400, indices=(ri, fi),
                                 device=CPU)
    assert got.keys() == ref.keys()
    for k in ref:
        close(got[k], ref[k])
    rates = tkappa._agreement_rates(t32(b))
    close(rates, jkappa._agreement_rates(jnp.asarray(b, jnp.float32)))
    close(tkappa._aggregate_kappa_boot(rates, t32(b).reshape(-1),
                                       torch.from_numpy(ri),
                                       torch.from_numpy(fi)),
          jkappa._aggregate_kappa_boot_jit(
              jnp.asarray(np.asarray(rates)), jnp.asarray(b, jnp.float32)
              .reshape(-1), jnp.asarray(ri), jnp.asarray(fi)))


def test_aggregate_kappa_checks_injected_indices():
    b = _binary(n=6, m=3)
    with pytest.raises(ValueError, match="shape"):
        tkappa.aggregate_kappa(b, None, n_boot=4, device=CPU,
                               indices=(np.zeros((3, 6)), np.zeros((4, 18))))
    with pytest.raises(ValueError, match="out of range"):
        tkappa.aggregate_kappa(b, None, n_boot=4, device=CPU,
                               indices=(np.full((4, 6), 6),
                                        np.zeros((4, 18))))


def test_self_kappa_bootstrap_on_jax_draws():
    rng = np.random.default_rng(6)
    d = (rng.random(120) < 0.7).astype(int)
    key = jax.random.PRNGKey(8)
    k1, k2 = jax.random.split(key)
    i1, i2 = _jidx(k1, 300, d.size), _jidx(k2, 300, d.size)
    ref = jkappa.self_kappa_bootstrap(d, key, n_boot=300)
    got = tkappa.self_kappa_bootstrap(d, None, n_boot=300, indices=(i1, i2),
                                      device=CPU)
    for k in ref:
        close(got[k], ref[k])
    # All-constant decisions: every draw NaN, dropped.
    nan = tkappa.self_kappa_bootstrap(np.ones(5, int), gen(), n_boot=10,
                                      device=CPU)
    assert all(math.isnan(v) for v in nan.values())


def test_combined_kappa_on_jax_draws(monkeypatch):
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    z = [np.asarray(jax.random.normal(k, (2000,))) for k in (k1, k2)]
    monkeypatch.setattr(tkappa, "standard_normal", _Feed(*z))
    got = tkappa.combined_kappa(0.4, 0.55, gen(), 0.1, 0.05, n_boot=2000,
                                device=CPU)
    ref = jkappa.combined_kappa(0.4, 0.55, key, 0.1, 0.05, n_boot=2000)
    for k in ref:
        close(got[k], ref[k])


@pytest.mark.parametrize("d", [[1, 1, 0, np.nan, 1], [0, 0, 0], [1],
                               [0, 1, 0, 1, 1, 0, 0]])
def test_per_prompt_mean_pairwise_kappa_bitwise_jax(d):
    got = tkappa.per_prompt_mean_pairwise_kappa(np.asarray(d, float))
    ref = jkappa.per_prompt_mean_pairwise_kappa(np.asarray(d, float))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k] or (math.isnan(got[k]) and math.isnan(ref[k]))


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------

def _result_close(got, ref):
    for f in ("estimate", "p_value", "ci_lower", "ci_upper",
              "standard_error"):
        close(getattr(got, f), getattr(ref, f))
    close(got.samples, ref.samples)
    assert got.as_dict().keys() == ref.as_dict().keys()


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_bootstrap_correlation_on_jax_draws(monkeypatch, method):
    x, y = _pairs(10, (60,), ties=method == "spearman")
    key = jax.random.PRNGKey(11)
    idx = _jidx(key, 500, 60)
    stat = {"pearson": (tcore.pearson, jboot._bootstrap_pearson_jit),
            "spearman": (tcore.spearman, jboot._bootstrap_spearman_jit)}
    tstat, jstat = stat[method]
    close(tboot._bootstrap_stat(tstat, t32(x), t32(y), torch.from_numpy(idx)),
          jstat(jnp.asarray(x), jnp.asarray(y), key, 500))
    monkeypatch.setattr(tboot, "resample_indices", _Feed(idx))
    _result_close(tboot.bootstrap_correlation(x, y, gen(), 500, method=method,
                                              device=CPU),
                  jboot.bootstrap_correlation(x, y, key, 500, method=method))


def test_bootstrap_correlation_refuses_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tboot.bootstrap_correlation([1, 2, 3], [1, 2, 4], gen(),
                                    method="kendall", device=CPU)


def test_bootstrap_mean_ci_on_jax_draws(monkeypatch):
    v = np.random.default_rng(12).beta(2, 5, 150)
    key = jax.random.PRNGKey(13)
    idx = _jidx(key, 800, v.size)
    close(tboot._resampled_means(t32(v), torch.from_numpy(idx)),
          jboot._resampled_means_jit(jnp.asarray(v, jnp.float32),
                                     jnp.asarray(idx)))
    monkeypatch.setattr(tboot, "resample_indices", _Feed(idx))
    _result_close(tboot.bootstrap_mean_ci(v, gen(), 800, device=CPU),
                  jboot.bootstrap_mean_ci(v, key, 800))


@pytest.mark.parametrize("metric", ["mae", "rmse", "mape"])
def test_bootstrap_metric_matrix_on_jax_draws(monkeypatch, metric):
    rng = np.random.default_rng(14)
    x = rng.uniform(0, 1, 45)
    x[3] = 0.0                                  # mape's eps branch
    y = np.clip(x + rng.normal(0, 0.1, 45), 0, 1)
    key = jax.random.PRNGKey(15)
    monkeypatch.setattr(tboot, "resample_indices", _Feed(_jidx(key, 300, 45)))
    got = tboot.bootstrap_metric_matrix(getattr(tboot, metric), x, y, gen(),
                                        300, device=CPU)
    ref = jboot.bootstrap_metric_matrix(getattr(jboot, metric), x, y, key, 300)
    close(got, ref)


def test_permutation_test_on_jax_draws(monkeypatch):
    """JAX relabels by ``jax.random.permutation(k, pooled)`` per split
    key, which is ``pooled[jax.random.permutation(k, n)]``: those index
    permutations go through the port's reduction and public function."""
    rng = np.random.default_rng(16)
    a, b = rng.normal(0.3, 1, 30), rng.normal(0.0, 1, 25)
    key = jax.random.PRNGKey(17)
    n = a.size + b.size
    keys = jax.random.split(key, 2000)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))
    pooled = np.concatenate([a, b]).astype(np.float32)
    close(tboot._permutation_diffs(t32(pooled), torch.from_numpy(perms), 30),
          jboot._permutation_diffs_jit(keys, jnp.asarray(pooled), 30))
    monkeypatch.setattr(tboot, "permutations", _Feed(perms))
    got = tboot.permutation_test_difference(a, b, gen(), 2000, device=CPU)
    ref = jboot.permutation_test_difference(a, b, key, 2000)
    assert got == ref


def test_normal_approx_mc_difference_on_jax_draws(monkeypatch):
    key = jax.random.PRNGKey(18)
    k1, k2 = jax.random.split(key)
    z = [np.asarray(jax.random.normal(k, (5000,))) for k in (k1, k2)]
    monkeypatch.setattr(tboot, "standard_normal", _Feed(*z))
    got = tboot.normal_approx_mc_difference(0.6, 0.1, 0.55, 0.12, gen(),
                                            5000, device=CPU)
    ref = jboot.normal_approx_mc_difference(0.6, 0.1, 0.55, 0.12, key, 5000)
    for k in ref:
        close(got[k], ref[k])


def test_simulate_individuals_on_jax_draws(monkeypatch):
    rng = np.random.default_rng(19)
    means, stds = rng.uniform(0, 1, 12), rng.uniform(0.05, 0.4, 12)
    key = jax.random.PRNGKey(20)
    z = np.asarray(jax.random.normal(key, (64, 12)))
    monkeypatch.setattr(tboot, "standard_normal", _Feed(z))
    close(tboot.simulate_individuals(means, stds, gen(), 64, device=CPU),
          jboot.simulate_individuals(means, stds, key, 64))


@pytest.mark.parametrize("seed", [21, 22])
def test_bootstrap_mean_ci_own_generators_within_mc_tolerance(seed):
    """Each package on its own draws: the CI endpoints agree within
    ``_mc_tol`` of the bootstrap standard error at n_boot = 2,000."""
    v = np.random.default_rng(seed).beta(2, 5, 400)
    ref = jboot.bootstrap_mean_ci(v, jax.random.PRNGKey(seed), 2000)
    got = tboot.bootstrap_mean_ci(v, gen(seed), 2000, device=CPU)
    tol = _mc_tol(ref.standard_error, 2000)
    assert got.estimate == ref.estimate
    assert abs(got.ci_lower - ref.ci_lower) <= tol
    assert abs(got.ci_upper - ref.ci_upper) <= tol
    # The same generator seed gives the same CIs, bitwise.
    again = tboot.bootstrap_mean_ci(v, gen(seed), 2000, device=CPU)
    assert (again.ci_lower, again.ci_upper) == (got.ci_lower, got.ci_upper)


def test_bootstrap_correlation_own_generators_within_mc_tolerance():
    x, y = _pairs(23, (200,), ties=False)
    ref = jboot.bootstrap_correlation(x, y, jax.random.PRNGKey(23), 2000)
    got = tboot.bootstrap_correlation(x, y, gen(23), 2000, device=CPU)
    tol = _mc_tol(ref.standard_error, 2000)
    assert abs(got.ci_lower - ref.ci_lower) <= tol
    assert abs(got.ci_upper - ref.ci_upper) <= tol


# ---------------------------------------------------------------------------
# correlations
# ---------------------------------------------------------------------------

def _pivot(seed=24, n=50, m=18, holes=0.1, ties=False):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, n)
    x = base[:, None] * rng.uniform(0.5, 1.0, m) + rng.normal(0, 0.2, (n, m))
    if ties:
        x = np.round(x, 1)
    x[rng.random(x.shape) < holes] = np.nan
    return x


@pytest.mark.parametrize("ties", [False, True])
def test_masked_correlation_matrices_match_jax(ties):
    x = _pivot(ties=ties)
    x[:, 17] = np.nan
    x[:2, 17] = [0.3, 0.4]                    # a column with 2 observations
    x32 = x.astype(np.float32)
    # Pearson's cross-product form cov = n sxy - sx sy cancels: the same
    # float32 products summed in another order differ by up to ~4e-6
    # after it (seen 3.7e-6), hence 5e-6 for that matrix alone.
    close(tcorr.masked_pearson_matrix(t32(x32)),
          jcorr.masked_pearson_matrix(jnp.asarray(x32)), tol=5e-6)
    close(tcorr.masked_spearman_matrix(t32(x32)),
          jcorr.masked_spearman_matrix(jnp.asarray(x32)))
    for method in ("pearson", "spearman"):
        np.testing.assert_array_equal(
            tcorr._masked_corr_matrix_f64(x, method),
            jcorr._masked_corr_matrix_f64(x, method))


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_bootstrap_correlation_matrix_on_jax_draws(method):
    x = _pivot(25, n=30, m=8)
    key = jax.random.PRNGKey(26)
    idx = _jidx(key, 200, x.shape[0])
    ref = jcorr.bootstrap_correlation_matrix(x, key, method, 200)
    got = tcorr.bootstrap_correlation_matrix(x, None, method, 200,
                                             indices=idx, device=CPU)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if k in ("correlation_matrix", "correlation_values"):
            np.testing.assert_array_equal(got[k], r)
        else:
            close(got[k], r)


def test_bootstrap_correlation_matrix_checks_indices_and_draws():
    x = _pivot(27, n=12, m=4)
    with pytest.raises(ValueError, match="shape"):
        tcorr.bootstrap_correlation_matrix(x, None, n_bootstrap=3,
                                           indices=np.zeros((2, 12)),
                                           device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tcorr.bootstrap_correlation_matrix(x, None, n_bootstrap=2,
                                           indices=np.full((2, 12), 12),
                                           device=CPU)
    a = tcorr.bootstrap_correlation_matrix(x, gen(3), n_bootstrap=50,
                                           device=CPU)
    b = tcorr.bootstrap_correlation_matrix(x, gen(3), n_bootstrap=50,
                                           device=CPU)
    assert a["mean_ci"] == b["mean_ci"] and a["std_ci"] == b["std_ci"]


def test_cross_rater_mean_correlation_matches_jax():
    x = _pivot(28, n=40, m=10, holes=0.3)
    for min_items in (5, 30):
        close(tcorr.cross_rater_mean_correlation(x, min_items, device=CPU),
              jcorr.cross_rater_mean_correlation(x, min_items))


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_pairwise_agreement_stats_matches_jax(scale):
    v = np.random.default_rng(29).uniform(0, scale, 80)
    got = tagree.pairwise_agreement_stats(v, scale, device=CPU)
    ref = jagree.pairwise_agreement_stats(v, scale)
    assert got.keys() == ref.keys()
    for k in ref:
        close(got[k], ref[k])


def test_per_item_agreement_on_jax_draws(monkeypatch):
    rng = np.random.default_rng(30)
    items = {f"q{i}": rng.uniform(0, 100, rng.integers(2, 30))
             for i in range(4)}
    items["single"] = np.array([50.0])
    items["holes"] = np.array([np.nan, 20.0, 40.0])
    key = jax.random.PRNGKey(31)
    monkeypatch.setattr(tboot, "resample_indices",
                        _Feed(_jidx(key, 500, 5)))
    got = tagree.per_item_agreement(items, 100.0, gen(), 500, device=CPU)
    ref = jagree.per_item_agreement(items, 100.0, key, 500)
    assert got["per_item"].keys() == ref["per_item"].keys()
    for item, stats in ref["per_item"].items():
        for k, v in stats.items():
            close(got["per_item"][item][k], v)
    for k in ("overall_mean", "overall_std", "n_items",
              "overall_mean_ci_lower", "overall_mean_ci_upper"):
        close(got[k], ref[k])
    none = tagree.per_item_agreement({"a": [1.0]}, 1.0, gen(), device=CPU)
    assert none == jagree.per_item_agreement({"a": [1.0]}, 1.0, key)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

def _fit_draws(key, max_it, n):
    """JAX's draws at its own schedule: split into (fit, sim) keys, fit
    iteration i from fold_in(fit_key, i), the final sample from sim_key."""
    fit_key, sim_key = jax.random.split(key)
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(fit_key, i), (n,))) for i in range(max_it)])
    return fit_key, draws, np.asarray(jax.random.normal(sim_key, (n,)))


@pytest.mark.parametrize("shape", [(2, 5), (0.6, 0.6), (8, 1.5)])
def test_fit_loop_on_jax_draws(shape):
    values = np.random.default_rng(32).beta(*shape, 300)
    tm, ts = np.float32(values.mean()), np.float32(values.std())
    fit_key, draws, _ = _fit_draws(jax.random.PRNGKey(33), 30, 20_000)
    mu, sigma, iters = tfits._fit_loop(t32(draws), torch.tensor(tm),
                                       torch.tensor(ts), 1e-4, 0.5)
    jmu, jsigma, jiters = jfits._fit_loop_jit(fit_key, jnp.asarray(tm),
                                              jnp.asarray(ts), 20_000, 30,
                                              1e-4, 0.5)
    assert iters == int(jiters)
    close(mu, jmu)
    close(sigma, jsigma)


@pytest.mark.parametrize("shape", [(2, 5), (0.5, 0.5)])
def test_truncated_normal_mc_fit_on_jax_draws(monkeypatch, shape):
    values = np.random.default_rng(34).beta(*shape, 400)
    values[:10] = 0.0
    values[10:14] = 1.0
    key = jax.random.PRNGKey(35)
    _, draws, sim = _fit_draws(key, 30, 20_000)
    monkeypatch.setattr(tfits, "standard_normal", _Feed(draws, sim))
    got, gsample = tfits.truncated_normal_mc_fit(values, gen(), 20_000,
                                                 prompt_idx=2,
                                                 column_name="rel",
                                                 device=CPU)
    ref, rsample = jfits.truncated_normal_mc_fit(values, key, 20_000,
                                                 prompt_idx=2,
                                                 column_name="rel")
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if isinstance(r, (bool, str)) or k in ("Iterations", "Prompt"):
            assert got[k] == r, k
        else:
            # mu and sigma may differ in their last float32 bit (XLA may
            # contract the loop's multiply-adds); the final sample
            # inherits it, and the KS / Anderson statistics over 20,000
            # of its values move by up to ~6e-6 relative (seen on the
            # AD statistic), hence 1e-5 for this dict.
            close(got[k], r, tol=1e-5)
    close(gsample, rsample)


@pytest.mark.parametrize("values", [[], [np.nan], [0.0, 1.0, 0.0]])
def test_truncated_normal_mc_fit_failures_match_jax(values):
    got, gs = tfits.truncated_normal_mc_fit(np.asarray(values), gen(),
                                            device=CPU)
    ref, rs = jfits.truncated_normal_mc_fit(np.asarray(values),
                                            jax.random.PRNGKey(0))
    assert got.keys() == ref.keys() and gs.size == rs.size == 0
    for k, r in ref.items():
        assert got[k] == r or (isinstance(r, float) and math.isnan(r)
                               and math.isnan(got[k])), k


def test_truncated_normal_mc_fit_own_generator_fits():
    """On its own draws the port's fit reaches the moments the reference
    fit reaches: the simulated mean and std within the fit's 1 % gate."""
    values = np.random.default_rng(36).beta(3, 4, 500)
    got, sample = tfits.truncated_normal_mc_fit(values, gen(36), 50_000,
                                                device=CPU)
    assert sample.shape == (50_000,)
    assert got["Mean Relative Error"] < 0.01
    assert got["Std Relative Error"] < 0.01


# ---------------------------------------------------------------------------
# normality (numpy/scipy float64 on both sides: bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 40, 300])
def test_normality_tests_bitwise_jax(n):
    v = np.random.default_rng(37).normal(0.5, 0.1, n)
    _equal_nested(tnorm.normality_tests(v, 3), jnorm.normality_tests(v, 3))


def test_normality_tests_give_kstest_a_callable_cdf(monkeypatch):
    """Fault C4: scipy 1.18 (the card's machine) raises on
    ``kstest(x, "norm", args=(mu, sigma))``; the port passes the fitted
    CDF as a callable, with the same results (a kstest that refuses a
    named distribution stands in for scipy 1.18 here)."""
    real = scipy_stats.kstest

    def kstest(rvs, cdf, *args, **kwargs):
        if isinstance(cdf, str):
            raise TypeError("ndtr() takes from 1 to 2 positional arguments "
                            "but 3 were given")
        return real(rvs, cdf, *args, **kwargs)

    v = np.random.default_rng(39).normal(0.5, 0.1, 300)
    want = jnorm.normality_tests(v, 3)
    monkeypatch.setattr(tnorm.scipy_stats, "kstest", kstest)
    _equal_nested(tnorm.normality_tests(v, 3), want)


def test_compare_distributions_and_ad_pvalue_bitwise_jax():
    rng = np.random.default_rng(38)
    a, b = rng.normal(0, 1, 60), rng.normal(0.4, 1.2, 45)
    assert tnorm.compare_distributions(a, b) == jnorm.compare_distributions(a, b)
    crit = np.array([0.5, 0.6, 0.75, 0.9, 1.05])
    for s in (0.1, 0.55, 0.7, 0.8, 1.0, 2.0, 11.0):
        assert (tnorm.anderson_darling_pvalue(s, crit)
                == jnorm.anderson_darling_pvalue(s, crit))


# ---------------------------------------------------------------------------
# streaming finalize
# ---------------------------------------------------------------------------

def _lattice(seed=39, P=3, R=60):
    rng = np.random.default_rng(seed)
    acc = tstream.empty_accum(P, R, seed=seed)
    filled = rng.random((P, R)) < 0.85
    yes = rng.random((P, R)).astype(np.float32)
    no = (rng.random((P, R)) * (1 - yes)).astype(np.float32)
    valid = filled & (rng.random((P, R)) < 0.95)
    acc.filled[filled] = 1
    rel = (yes / (yes + no)).astype(np.float32)
    acc.rel[valid] = rel[valid]
    acc.dec[valid] = (yes > no)[valid]
    conf = rng.uniform(0, 100, (P, R)).astype(np.float32)
    acc.conf[valid] = conf[valid]
    return acc


def _to_jax(acc):
    return jstream.HostAccum(filled=acc.filled.copy(), rel=acc.rel.copy(),
                             conf=acc.conf.copy(), dec=acc.dec.copy(),
                             seed=acc.seed)


def _equal_nested(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_nested(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_nested(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
    else:
        assert a == b


def test_counts_kappa_and_moments_bitwise_jax():
    acc = _lattice()
    jacc = _to_jax(acc)
    assert tstream.FLOAT_TOL == jstream.FLOAT_TOL
    assert acc.rows_folded == jacc.rows_folded
    for k, v in jstream.contingency(jacc).items():
        np.testing.assert_array_equal(tstream.contingency(acc)[k], v)
    assert tstream.kappa(acc) == jstream.kappa(jacc)
    for field in ("rel", "conf"):
        for p in range(3):
            vals = tstream.prompt_values(acc, field, p)
            np.testing.assert_array_equal(vals,
                                          jstream.prompt_values(jacc, field, p))
            assert tstream._moments(vals) == jstream._moments(vals)
    _equal_nested(tstream._moments(np.array([])),
                  jstream._moments(np.array([])))
    _equal_nested(tstream.summarize(acc, n_boot=0, device=CPU),
                  jstream.summarize(jacc, n_boot=0))


def test_group_counts_and_kappa_from_counts_bitwise_jax():
    rng = np.random.default_rng(40)
    g, d = rng.integers(0, 5, 200), rng.integers(0, 2, 200)
    for got, ref in zip(tstream.group_counts(g, d),
                        jstream.group_counts(g, d)):
        np.testing.assert_array_equal(got, ref)
    n_g, s_g = tstream.group_counts(g, d)
    assert (tstream.kappa_from_counts(n_g, s_g)
            == jstream.kappa_from_counts(n_g, s_g))
    for got, ref in zip(tstream.group_counts(np.array([]), np.array([])),
                        jstream.group_counts(np.array([]), np.array([]))):
        np.testing.assert_array_equal(got, ref)


def test_merge_accums_matches_jax():
    acc = _lattice(41)
    halves = []
    for part in (0, 1):
        h = tstream.empty_accum(3, 60, acc.seed)
        m = (acc.filled > 0) & ((np.arange(60) % 2) == part)
        for name in ("filled", "rel", "conf", "dec"):
            getattr(h, name)[m] = getattr(acc, name)[m]
        halves.append(h)
    merged = tstream.merge_accums(halves)
    jmerged = jstream.merge_accums([_to_jax(h) for h in halves])
    for name in ("filled", "rel", "conf", "dec"):
        np.testing.assert_array_equal(getattr(merged, name),
                                      getattr(jmerged, name))
        np.testing.assert_array_equal(getattr(merged, name),
                                      getattr(acc, name))
    with pytest.raises(ValueError, match="overlap"):
        tstream.merge_accums([acc, halves[0]])
    same = tstream.merge_accums([acc, halves[0]], allow_identical_overlap=True)
    np.testing.assert_array_equal(same.rel, acc.rel)
    bad = _lattice(41)
    bad.rel[bad.filled > 0] += 0.25
    with pytest.raises(ValueError, match="DIVERGENT"):
        tstream.merge_accums([acc, bad], allow_identical_overlap=True)


def test_bootstrap_ci_seeded_and_summarize_on_jax_draws(monkeypatch):
    """The port's finalize with JAX's keyed indices (fold_in(PRNGKey(seed),
    p) [, salt]) in place of its own: the same CIs within TOL."""
    acc = _lattice(42, P=2, R=150)

    def jax_indices(words, n_boot, n, device):
        seed, p, salt = words
        key = jax.random.fold_in(jax.random.PRNGKey(seed), p)
        if salt:
            key = jax.random.fold_in(key, salt)
        return torch.from_numpy(_jidx(key, n_boot, n)).to(device)

    monkeypatch.setattr(tstream, "generator_for", lambda *w: w)
    monkeypatch.setattr(tstream, "resample_indices", jax_indices)
    got = tstream.summarize(acc, n_boot=400, device=CPU)
    ref = jstream.summarize(_to_jax(acc), n_boot=400)
    for gp, rp in zip(got["per_prompt"], ref["per_prompt"]):
        for field in ("relative_prob", "weighted_confidence"):
            for k, r in rp[field].items():
                close(gp[field][k], r)
    v = tstream.prompt_values(acc, "conf", 1)
    g1 = tstream.bootstrap_mean_ci_seeded(v, 5, 1, 300, salt=10_000,
                                          device=CPU)
    r1 = jstream.bootstrap_mean_ci_seeded(v, 5, 1, 300, salt=10_000)
    for k in r1:
        close(g1[k], r1[k])
    empty = tstream.bootstrap_mean_ci_seeded(np.array([]), 5, 0, 10,
                                             device=CPU)
    assert all(math.isnan(x) for x in empty.values())


def test_summarize_own_generator_within_mc_tolerance_and_reproducible():
    acc = _lattice(43, P=2, R=600)
    got = tstream.summarize(acc, n_boot=2000, device=CPU)
    ref = jstream.summarize(_to_jax(acc), n_boot=2000)
    for gp, rp in zip(got["per_prompt"], ref["per_prompt"]):
        for field in ("relative_prob", "weighted_confidence"):
            tol = _mc_tol(rp[field]["standard_error"], 2000)
            for k in ("ci_lower", "ci_upper"):
                assert abs(gp[field][k] - rp[field][k]) <= tol, (field, k)
    _equal_nested(got, tstream.summarize(acc, n_boot=2000, device=CPU))


def _rows(module, acc, cells):
    """D6 rows whose readouts reproduce ``acc``'s slots: yes = rel, no =
    1 - rel (quarantined slots null), one row a filled slot."""
    rows = []
    for c in cells:
        p, r = c
        if not acc.filled[p, r]:
            continue
        rel = float(acc.rel[p, r])
        ok = not math.isnan(rel)
        conf = float(acc.conf[p, r])
        rows.append(module.PerturbationRow(
            model="m", original_main=f"prompt {p}", response_format="rf",
            confidence_format="cf", rephrased_main=f"prompt {p} take {r}",
            full_rephrased_prompt="b", full_confidence_prompt="c",
            model_response="Yes", model_confidence_response="50",
            log_probabilities="", token_1_prob=rel if ok else None,
            token_2_prob=(1.0 - rel) if ok else None,
            confidence_value=None,
            weighted_confidence=None if math.isnan(conf) else conf))
    return rows


def test_accum_from_rows_bitwise_jax_frame(tmp_path):
    """The port's rows (objects, and dicts read back from its CSV) give
    the JAX package's lattice from the same rows as a pandas frame."""
    acc = _lattice(44, P=2, R=30)
    slots = [(p, r) for p in range(2) for r in range(30)]
    smap = {(f"prompt {p}", f"prompt {p} take {r}"): (p, r) for p, r in slots}
    trows = _rows(tschemas, acc, slots)
    path = tmp_path / "d6.csv"
    tschemas.write_perturbation_results(trows, path)
    jacc = jstream.accum_from_rows(jschemas.read_results_frame(path), smap,
                                   2, 30, seed=9)
    for rows in (trows, tschemas.read_results(path)):
        got = tstream.accum_from_rows(rows, smap, 2, 30, seed=9)
        for name in ("filled", "rel", "conf", "dec"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(jacc, name))
        assert got.seed == jacc.seed == 9
    # A row of another grid maps nowhere and is skipped.
    stray = [dict(tschemas.read_results(path)[0],
                  **{"Rephrased Main Part": "elsewhere"})]
    assert tstream.accum_from_rows(stray, smap, 2, 30, 0).rows_folded == 0


def test_slot_map_and_assert_parity_match_jax():
    from lir_tpu.engine import grid as jgrid
    from lir_tpu_torch.data import LEGAL_PROMPTS
    from lir_tpu_torch.engine import grid as tgrid

    perts = [[f"{p.main} v{i}" for i in range(3)] for p in LEGAL_PROMPTS]
    cells = tgrid.build_grid("m", LEGAL_PROMPTS, perts)
    jcells = jgrid.build_grid("m", LEGAL_PROMPTS, perts)
    assert (tstream.slot_map_from_cells(cells)
            == jstream.slot_map_from_cells(jcells))
    acc = _lattice(45)
    s = tstream.summarize(acc, n_boot=50, device=CPU)
    tstream.assert_parity(s, s)
    jstream.assert_parity(s, s)
    off = tstream.summarize(acc, n_boot=50, device=CPU)
    off["per_prompt"][1]["relative_prob"]["mean"] += 1e-3
    with pytest.raises(AssertionError, match="relative_prob.mean"):
        tstream.assert_parity(s, off)
    off = tstream.summarize(acc, n_boot=0, device=CPU)
    off["kappa"]["kappa"] += 1e-12
    with pytest.raises(AssertionError):
        tstream.assert_parity(tstream.summarize(acc, n_boot=0, device=CPU),
                              off)
