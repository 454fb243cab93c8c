"""The port's survey pipeline (``lir_tpu_torch.survey``) against the JAX
package's (``lir_tpu.survey``) on the same seeded Qualtrics fixture and
D1/D2 pair (``lir_tpu_torch.data.synthetic``), on the CPU.

Tolerances:
- exact: the exclusion counts and thresholds, the question match, every
  count and ``n_*``, every string and flag, the JSON keys and their order
  in every artifact; the D7 payload to 1e-12 (numpy float64 on both
  sides: in fact bitwise);
- 1e-6 of max(1, |x|): every bootstrap, permutation and Monte Carlo
  reduction fed JAX's own draws. The JAX run records each draw it makes
  (``resample_indices(key, ...)``, the permutations and normals of its
  keys, the simulated bootstrap's group indices and normals), and the
  port's draw helpers replay them in the same order; the pure reductions
  are also held to the JAX kernels one by one;
- each package on its own generator: every value that no draw decides
  exactly as above, and each CI endpoint or bootstrap mean within a Monte
  Carlo band derived beforehand from n_boot and the statistic's spread
  (``_mc_tol``), never fitted to a seed;
- the same seed twice: every artifact byte for byte.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats as scipy_stats

from lir_tpu.stats import agreement as jagree
from lir_tpu.stats import core as jcore
from lir_tpu.stats import streaming as jstream
from lir_tpu.survey import consolidated as jcons
from lir_tpu.survey import family_differences as jfam
from lir_tpu.survey import human_llm as jhl
from lir_tpu.survey import loader as jload
from lir_tpu.survey import run as jrun
from lir_tpu.survey import simulated as jsim
from lir_tpu_torch.data import synthetic
from lir_tpu_torch.data.table import read_table, to_numeric
from lir_tpu_torch.engine import stream_stats as tss
from lir_tpu_torch.stats import bootstrap as tboot
from lir_tpu_torch.stats import streaming as tstream
from lir_tpu_torch.survey import consolidated as tcons
from lir_tpu_torch.survey import human_llm as thl
from lir_tpu_torch.survey import loader as tload
from lir_tpu_torch.survey import run as trun
from lir_tpu_torch.survey import simulated as tsim

CPU = "cpu"
TOL = 1e-6
N_RESPONDENTS = 100
QUICK = dict(n_bootstrap_standard=50, n_bootstrap_small=20,
             n_bootstrap_large=200)
JSONS = ("survey_analysis_detailed.json", "consolidated_analysis_results.json",
         "llm_human_agreement_analysis.json",
         "llm_human_agreement_bootstrap.json", "family_differences.json",
         "bootstrap_confidence_intervals.json",
         "correlation_pvalues_analysis.json", "proportion_analysis.json")
FIGURES = ("best_worst_model_agreement.png", "model_mae_comparison.png",
           "correlation_pvalue_distributions.png")


# ---------------------------------------------------------------------------
# JAX's draws, recorded; the port's draw helpers, replaying them
# ---------------------------------------------------------------------------

@jax.jit
def _jax_perms(keys, pooled):
    return jax.vmap(lambda k: jax.random.permutation(k, pooled.shape[0]))(keys)


def _jax_sim_draws(keys, n_groups, n_q):
    def one(k):
        kg, kh = jax.random.split(k)
        return (jax.random.randint(kg, (), 0, n_groups),
                jax.random.normal(kh, (n_q,)))
    return jax.vmap(one)(keys)


_jax_sim_draws = jax.jit(_jax_sim_draws, static_argnums=(1, 2))


class Recorder:
    """Wraps the JAX survey's draw sites (in the namespaces its modules
    look them up in) to record each draw, in call order, then call the
    original."""

    def __init__(self):
        self.draws = []

    def install(self, mp):
        rec = self.draws

        def idx_of(orig):
            def f(key, n_boot, n):
                out = orig(key, n_boot, n)
                rec.append(("idx", np.asarray(out)))
                return out
            return f

        for mod in (jcons, jhl, jsim):
            mp.setattr(mod, "resample_indices", idx_of(mod.resample_indices))

        def boot_corr(orig):
            def f(x, y, key, n_boot=1000, *a, **kw):
                rec.append(("idx", np.asarray(jcore.resample_indices(
                    key, n_boot, len(x)))))
                return orig(x, y, key, n_boot, *a, **kw)
            return f

        def boot_mean(orig):
            def f(values, key, n_boot=1000, *a, **kw):
                rec.append(("idx", np.asarray(jcore.resample_indices(
                    key, n_boot, len(values)))))
                return orig(values, key, n_boot, *a, **kw)
            return f

        def perm_test(orig):
            def f(a, b, key, n_perm=10_000):
                pooled = jnp.zeros(len(a) + len(b))
                rec.append(("perm", np.asarray(_jax_perms(
                    jax.random.split(key, n_perm), pooled))))
                return orig(a, b, key, n_perm)
            return f

        def mc_diff(orig):
            def f(mean_a, std_a, mean_b, std_b, key, n_draws=10_000):
                for k in jax.random.split(key):
                    rec.append(("normal", np.asarray(
                        jax.random.normal(k, (n_draws,)))))
                return orig(mean_a, std_a, mean_b, std_b, key, n_draws)
            return f

        def sim(orig):
            def f(keys, means, stds, vals, usable):
                g, z = _jax_sim_draws(keys, means.shape[0], means.shape[1])
                rec.append(("sim", (np.asarray(g), np.asarray(z))))
                return orig(keys, means, stds, vals, usable)
            return f

        mp.setattr(jcons, "bootstrap_correlation",
                   boot_corr(jcons.bootstrap_correlation))
        mp.setattr(jagree, "bootstrap_mean_ci",
                   boot_mean(jagree.bootstrap_mean_ci))
        mp.setattr(jhl, "bootstrap_mean_ci", boot_mean(jhl.bootstrap_mean_ci))
        mp.setattr(jhl, "permutation_test_difference",
                   perm_test(jhl.permutation_test_difference))
        mp.setattr(jfam, "normal_approx_mc_difference",
                   mc_diff(jfam.normal_approx_mc_difference))
        mp.setattr(jsim, "_simulated_correlations",
                   sim(jsim._simulated_correlations))


class Replay:
    """Stands in for the port's draw helpers: hands out the recorded JAX
    draws in order, each checked for its kind and shape."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def _next(self, kind, shape):
        got_kind, arr = self.draws[self.used]
        self.used += 1
        got_shape = tuple(np.shape(arr[1] if kind == "sim" else arr))
        assert (got_kind, got_shape) == (kind, tuple(shape)), (
            self.used, got_kind, got_shape, kind, shape)
        return arr

    def idx(self, generator, n_boot, n, device=CPU):
        return torch.from_numpy(np.asarray(self._next("idx", (n_boot, n)),
                                           np.int64)).to(device)

    def perm(self, generator, n_perm, n, device=CPU):
        return torch.from_numpy(np.asarray(self._next("perm", (n_perm, n)),
                                           np.int64)).to(device)

    def normal(self, generator, shape, device=CPU):
        return torch.from_numpy(np.asarray(self._next("normal", shape),
                                           np.float32)).to(device)

    def sim(self, generator, n_draws, n_groups, n_q):
        g, z = self._next("sim", (n_draws, n_q))
        return (torch.from_numpy(np.asarray(g, np.int64)),
                torch.from_numpy(np.asarray(z, np.float32)))

    def install(self, mp):
        for mod in (tboot, tcons, thl, tsim):
            mp.setattr(mod, "resample_indices", self.idx)
        mp.setattr(tboot, "permutations", self.perm)
        mp.setattr(tboot, "standard_normal", self.normal)
        mp.setattr(tsim, "_simulated_draws", self.sim)


# ---------------------------------------------------------------------------
# Fixtures: one JAX run (recorded), the port on its draws, on its own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("survey")
    survey = synthetic.write_synthetic_survey(root / "survey.csv",
                                              n_respondents=N_RESPONDENTS)
    d1, d2 = synthetic.write_synthetic_comparison(root / "d1.csv",
                                                  root / "d2.csv")
    return dict(root=root, survey=survey, d1=d1, d2=d2)


def _port(inputs, out, **kw):
    return trun.run_survey_pipeline(inputs["survey"], inputs["d2"],
                                    inputs["d1"], out, device=CPU,
                                    **dict(QUICK, **kw))


@pytest.fixture(scope="module")
def runs(inputs):
    root = inputs["root"]
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.install(mp)
        jax_res = jrun.run_survey_pipeline(inputs["survey"], inputs["d2"],
                                           inputs["d1"], root / "jax",
                                           **QUICK)
    replay = Replay(rec.draws)
    with pytest.MonkeyPatch.context() as mp:
        replay.install(mp)
        on_jax = _port(inputs, root / "port_jax_draws", make_figures=False)
    own = _port(inputs, root / "port", make_figures=False)
    return dict(jax=root / "jax", on_jax=root / "port_jax_draws",
                own=root / "port", jax_res=jax_res, on_jax_res=on_jax,
                own_res=own, replay=replay, n_draws=len(rec.draws))


def _load(d: Path, name: str):
    return json.loads((d / name).read_text())


def _walk(a, b, path, tol, out, scale=1.0):
    """Every difference of ``a`` from ``b``: keys and their order, list
    lengths, types, strings and flags exact, numbers within ``tol`` of
    max(scale, |b|) (NaN equals NaN). Under a comparison of two groups
    (a dict with ``base_mean`` and ``instruct_mean``), ``scale`` is the
    larger of the two means: a difference of two float32 reductions
    carries their magnitude's rounding (and a relative change, that
    rounding over the base mean)."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or list(a) != list(b):
            out.append((path, "keys", a if not isinstance(a, dict) else list(a),
                        list(b)))
            return
        means = [b[k] for k in ("base_mean", "instruct_mean")
                 if isinstance(b.get(k), float) and math.isfinite(b[k])]
        if len(means) == 2:
            scale = max(scale, *map(abs, means))
        for k in b:
            # 100 * difference / base_mean: the difference's rounding
            # scaled by the same factor.
            s = (scale * 100.0 / abs(b["base_mean"])
                 if k == "relative_change_pct" and len(means) == 2
                 and b["base_mean"] else scale)
            _walk(a[k], b[k], f"{path}.{k}", tol, out, s)
    elif isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            out.append((path, "length", a, b))
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]", tol, out, scale)
    elif isinstance(b, (bool, str)) or b is None:
        if a != b or type(a) is not type(b):
            out.append((path, "value", a, b))
    else:
        if type(a) is not type(b):
            out.append((path, "type", a, b))
        elif not (math.isnan(b) and math.isnan(a)) and (
                abs(a - b) > tol * max(scale, abs(b)) or math.isnan(a)
                or math.isnan(b)):
            out.append((path, "number", a, b))


def assert_same(a, b, tol, label=""):
    out = []
    _walk(a, b, label, tol, out)
    assert not out, out[:10]


def _mc_tol(se: float, n_boot: int, p: float = 0.025) -> float:
    """Four standard deviations of the difference of two independent
    percentile-bootstrap estimates of the p-quantile of an approximately
    normal statistic with standard error ``se`` (the quantile's
    asymptotic variance p (1 - p) / (n_boot phi(z_p)^2) se^2, times two
    for the difference)."""
    z = scipy_stats.norm.ppf(p)
    sd = math.sqrt(p * (1 - p) / n_boot) / scipy_stats.norm.pdf(z) * se
    return 4.0 * math.sqrt(2.0) * sd


def _mean_tol(sd: float, n: int) -> float:
    """Four standard deviations of the difference of two independent
    means of ``n`` draws with spread ``sd``."""
    return 4.0 * math.sqrt(2.0) * sd / math.sqrt(n)


# ---------------------------------------------------------------------------
# Loader: counts, cases, match, D7
# ---------------------------------------------------------------------------

def test_to_numeric_is_pandas():
    cells = ["50", "7", np.nan, "fifty", "1e2", "3.5", " 4", "inf", "-0",
             "0x10", "1_000", "+5", "5.", ""]
    arr = np.empty(len(cells), dtype=object)
    arr[:] = cells
    ref = pd.to_numeric(pd.Series(arr), errors="coerce").to_numpy()
    got = to_numeric(arr)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert np.signbit(got[8]) == np.signbit(ref[8])
    ints = np.empty(2, dtype=object)
    ints[:] = ["50", " 7"]
    assert to_numeric(ints).dtype == pd.to_numeric(pd.Series(ints)).dtype


@pytest.fixture(scope="module")
def loaded(inputs):
    jdf, jcols = jload.load_survey(inputs["survey"])
    tdf, tcols = tload.load_survey(inputs["survey"])
    jclean, jstats = jload.apply_exclusions(jdf, jcols)
    tclean, tstats = tload.apply_exclusions(tdf, tcols)
    return dict(jdf=jdf, tdf=tdf, cols=(jcols, tcols), jclean=jclean,
                tclean=tclean, jstats=jstats, tstats=tstats)


def test_exclusion_counts_and_thresholds_exact(loaded):
    assert loaded["cols"][0] == loaded["cols"][1]
    assert loaded["tstats"] == loaded["jstats"]
    assert list(loaded["tstats"]) == list(loaded["jstats"])
    assert (list(loaded["tclean"]["ResponseId"])
            == list(loaded["jclean"]["ResponseId"]))
    for col in loaded["cols"][0]:
        np.testing.assert_array_equal(
            np.asarray(loaded["tclean"][col], float),
            loaded["jclean"][col].to_numpy(float))


def _rid(df, row):
    return df["ResponseId"][row]


@pytest.mark.parametrize("row,case", sorted(synthetic.SURVEY_CASES.items()))
def test_fixture_case(loaded, row, case):
    """Each fixture case, by name, lands where the JAX loader puts it."""
    tdf, tclean, stats = loaded["tdf"], loaded["tclean"], loaded["tstats"]
    rid = _rid(tdf, row)
    kept = rid in set(tclean["ResponseId"])
    assert kept == (rid in set(loaded["jclean"]["ResponseId"]))
    dur = np.asarray(tdf["Duration (in seconds)"], float)
    expected_kept = case in ("one_answer", "attention_unanswered",
                             "non_numeric_slider")
    assert kept == expected_kept, case
    if case in ("missing_duration", "non_numeric_duration"):
        assert np.isnan(dur[row])
        # Dropped but in no count: the counted exclusions fall short of
        # the total by the NaN durations.
        counted = (stats["duration_excluded"] + stats["identical_excluded"]
                   + stats["attention_failed"])
        assert stats["total_excluded"] - counted == 2
    if case == "non_numeric_slider":
        g = row % 5 + 1
        assert np.isnan(np.asarray(tdf[f"Q{g}_3"], float)[row])
        assert np.isnan(loaded["jdf"][f"Q{g}_3"].to_numpy(float)[row])
    if case == "one_answer":
        g = row % 5 + 1
        answered = [c for c in tload.group_question_ids(g)
                    if not np.isnan(np.asarray(tdf[c], float)[row])]
        assert answered == [f"Q{g}_1"]
    if case == "attention_unanswered":
        assert np.isnan(np.asarray(tdf[f"Q{row % 5 + 1}_8"], float)[row])


def test_exclusion_order_counts(loaded):
    """Identical before attention, duration before both: the two rows
    that fail two criteria count once, under the first."""
    s = loaded["tstats"]
    assert (s["duration_excluded"], s["identical_excluded"],
            s["attention_failed"]) == (2, 2, 1)
    assert s["total_excluded"] == 7
    assert s["final_count"] == N_RESPONDENTS - 7


def test_question_text_and_match_exact(inputs):
    jmap = jload.extract_question_text(inputs["survey"])
    tmap = tload.extract_question_text(inputs["survey"])
    assert tmap == jmap and list(tmap) == list(jmap)
    jm = jload.match_survey_to_llm_questions(pd.read_csv(inputs["d2"]), jmap)
    tm = tload.match_survey_to_llm_questions(read_table(inputs["d2"]), tmap)
    assert tm == jm and list(tm) == list(jm)
    assert len(tm) == 50 and synthetic.UNMATCHED_PROMPT not in tm
    assert tload.canonical_question_mapping() == jload.canonical_question_mapping()
    assert tm == tload.canonical_question_mapping()


def test_d7_payload(loaded):
    jcols, tcols = loaded["cols"]
    ref = jload.survey_detailed(loaded["jclean"], jcols)
    got = tload.survey_detailed(loaded["tclean"], tcols)
    assert_same(got, ref, 1e-12)
    assert json.dumps(got) == json.dumps(ref)


# ---------------------------------------------------------------------------
# The pure reductions on JAX's draws
# ---------------------------------------------------------------------------

def _aligned(inputs, loaded, model):
    detailed = jload.survey_detailed(loaded["jclean"], loaded["cols"][0])
    avgs = jhl.human_averages_from_detailed(
        detailed, jload.canonical_question_mapping())
    d2 = pd.read_csv(inputs["d2"])
    return jhl.aligned_vectors(d2[d2["model"] == model], avgs)


@pytest.mark.parametrize("model", [synthetic.SURVEY_EXTRA_INSTRUCT[1],
                                   synthetic.SURVEY_ERROR_MODEL])
def test_boot_metrics_on_jax_draws(inputs, loaded, model):
    h, m, valid, _ = _aligned(inputs, loaded, model)
    idx = jcore.resample_indices(jax.random.PRNGKey(3), 400, h.size)
    m0 = np.where(valid, m, 0.0)
    ref = jhl._boot_metric_kernel(jnp.asarray(h), jnp.asarray(m0),
                                  jnp.asarray(valid), idx, h.size)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    got = thl._boot_metrics(f32(h), f32(m0), torch.from_numpy(valid),
                            torch.from_numpy(np.asarray(idx, np.int64)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().astype(float),
                                   np.asarray(r, float), rtol=TOL, atol=TOL,
                                   equal_nan=True)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("side", ["human", "llm"])
def test_boot_pair_sums_on_jax_draws(inputs, loaded, side):
    if side == "human":
        x = jcons._human_group_matrix(loaded["jclean"], 2)
        min_answered = jcons.MIN_ANSWERED
    else:
        d2 = pd.read_csv(inputs["d2"])
        x = jcons._llm_group_pivot(d2, jload.canonical_question_mapping(),
                                   2).T
        min_answered = 0
    idx = jcore.resample_indices(jax.random.PRNGKey(4), 60, x.shape[1])
    rs, rc = jcons._boot_pair_sums(jnp.asarray(x), idx, min_answered)
    s, c = tcons._boot_pair_sums(torch.from_numpy(x.astype(np.float32)),
                                 torch.from_numpy(np.asarray(idx, np.int64)),
                                 min_answered)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_allclose(s.numpy() / np.maximum(c.numpy(), 1),
                               np.asarray(rs) / np.maximum(np.asarray(rc), 1),
                               rtol=TOL, atol=TOL)


def test_simulated_correlations_on_jax_draws(inputs, loaded):
    detailed = jload.survey_detailed(loaded["jclean"], loaded["cols"][0])
    d1 = pd.read_csv(inputs["d1"])
    canonical = jload.canonical_question_mapping()
    for model in ("EleutherAI/pythia-6.9b", "tiiuae/falcon-7b-instruct"):
        t = jsim.model_group_tensors(d1[d1["model"] == model], canonical,
                                     detailed)
        keys = jax.random.split(jax.random.PRNGKey(5), 3000)
        ref = np.asarray(jsim._simulated_correlations(
            keys, *(jnp.asarray(a) for a in t)))
        g, z = _jax_sim_draws(keys, 5, 10)
        got = tsim._simulated_correlations(
            torch.from_numpy(np.asarray(g, np.int64)),
            torch.from_numpy(np.asarray(z)), *(
                torch.from_numpy(np.asarray(a, np.float32)) for a in t[:3]),
            torch.from_numpy(t[3])).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   equal_nan=True)
    tt = tsim.model_group_tensors(
        read_table(inputs["d1"]).where("model", "EleutherAI/pythia-6.9b"),
        canonical, detailed)
    for a, b in zip(tt, jsim.model_group_tensors(
            d1[d1["model"] == "EleutherAI/pythia-6.9b"], canonical, detailed)):
        np.testing.assert_array_equal(a, b)
    assert not tt[3][1] and tt[3].sum() == 4       # group 2: 7 matched


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JSONS)
def test_pipeline_on_jax_draws(runs, name):
    """Every artifact of the port fed JAX's draws is JAX's: keys, order,
    counts, strings and flags exact, numbers within 1e-6."""
    assert_same(_load(runs["on_jax"], name), _load(runs["jax"], name), TOL,
                name)


def test_pipeline_replayed_every_jax_draw(runs):
    assert runs["replay"].used == runs["n_draws"] > 0
    assert ((runs["on_jax"] / "consolidated_report.txt").read_text()
            == (runs["jax"] / "consolidated_report.txt").read_text())


# Paths of values that no draw decides, per artifact.
_DETERMINISTIC = {
    "survey_analysis_detailed.json": [()],
    "llm_human_agreement_analysis.json": [()],
    "correlation_pvalues_analysis.json": [()],
    "proportion_analysis.json": [()],
    "consolidated_analysis_results.json": [
        ("exclusion_stats",), ("matching_stats",),
        ("human_llm_correlation", "correlation"),
        ("human_llm_correlation", "p_value"),
        ("human_llm_correlation", "n_questions"),
        ("per_item_agreement", "human", "overall_mean"),
        ("per_item_agreement", "human", "overall_std"),
        ("per_item_agreement", "human", "per_item_details"),
        ("per_item_agreement", "llm", "per_item_details"),
        ("meta_correlation", "correlation"), ("meta_correlation", "p_value"),
        ("meta_correlation", "n_matched_items"),
        ("cross_prompt_correlations", "human", "mean_correlation"),
        ("cross_prompt_correlations", "human", "n_pairs"),
        ("cross_prompt_correlations", "llm", "std_correlation"),
        ("cross_prompt_correlations", "llm", "n_pairs"),
    ],
}


def _at(obj, path):
    for k in path:
        obj = obj[k]
    return obj


@pytest.mark.parametrize("name", sorted(_DETERMINISTIC))
def test_pipeline_own_generator_deterministic_values(runs, name):
    own, ref = _load(runs["own"], name), _load(runs["jax"], name)
    _walk_keys(own, ref)
    for path in _DETERMINISTIC[name]:
        assert_same(_at(own, path), _at(ref, path), TOL, f"{name}{path}")


def _walk_keys(a, b):
    """The same keys in the same order everywhere (values aside)."""
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _walk_keys(a[k], b[k])


def _ci_close(own, ref, se, n_boot, label):
    tol = _mc_tol(se, n_boot)
    assert abs(own - ref) <= tol, (label, own, ref, tol)


def test_pipeline_own_generator_cis_within_mc_band(runs):
    """Each package on its own generator: the CIs within the band of
    their n_boot."""
    n_std, n_small, n_large = (QUICK["n_bootstrap_standard"],
                               QUICK["n_bootstrap_small"],
                               QUICK["n_bootstrap_large"])
    name = "consolidated_analysis_results.json"
    own, ref = _load(runs["own"], name), _load(runs["jax"], name)
    hc_o, hc_r = own["human_llm_correlation"], ref["human_llm_correlation"]
    for k in ("ci_lower", "ci_upper"):
        _ci_close(hc_o[k], hc_r[k], hc_r["standard_error"], n_std, k)
    for side in ("human", "llm"):
        o, r = (own["per_item_agreement"][side],
                ref["per_item_agreement"][side])
        se = (r["overall_mean_ci_upper"] - r["overall_mean_ci_lower"]) / 3.92
        for k in ("overall_mean_ci_lower", "overall_mean_ci_upper"):
            _ci_close(o[k], r[k], se, n_std, f"{side} {k}")
    for side, n in (("human", n_small), ("llm", n_small),
                    ("difference", n_std)):
        o = own["cross_prompt_correlations"][side]
        r = ref["cross_prompt_correlations"][side]
        se = (r["ci_upper"] - r["ci_lower"]) / 3.92
        for k in ("ci_lower", "ci_upper"):
            _ci_close(o[k], r[k], se, n, f"cross {side} {k}")

    own9 = {(r["model"], r["model_type"]): r for r in _load(
        runs["own"], "llm_human_agreement_bootstrap.json")["model_results"]}
    ref9 = {(r["model"], r["model_type"]): r for r in _load(
        runs["jax"], "llm_human_agreement_bootstrap.json")["model_results"]}
    assert list(sorted(own9)) == list(sorted(ref9))
    for key, r in ref9.items():
        o = own9[key]
        assert o["n_bootstrap"] == r["n_bootstrap"] == n_std
        for metric in ("mae", "mse"):
            sd = r[f"{metric}_std"]
            assert abs(o[f"{metric}_mean"] - r[f"{metric}_mean"]) <= _mean_tol(
                sd, n_std), (key, metric)
            for k in ("ci_lower", "ci_upper"):
                _ci_close(o[f"{metric}_{k}"], r[f"{metric}_{k}"], sd, n_std,
                          (key, metric, k))

    own_sim = _load(runs["own"], "bootstrap_confidence_intervals.json")
    ref_sim = _load(runs["jax"], "bootstrap_confidence_intervals.json")
    assert list(own_sim["model_stats"]) == list(ref_sim["model_stats"])
    for model, r in ref_sim["model_stats"].items():
        o = own_sim["model_stats"][model]
        assert o["type"] == r["type"]
        assert abs(o["mean_corr"] - r["mean_corr"]) <= _mean_tol(
            r["std_corr"], 500), model
    for kind in ("base", "instruct"):
        o = own_sim["overall_results"][kind]
        r = ref_sim["overall_results"][kind]
        se = (r["ci_upper"] - r["ci_lower"]) / 3.92
        for k in ("ci_lower", "ci_upper"):
            _ci_close(o[k], r[k], se, n_large, (kind, k))

    own_fam = _load(runs["own"], "family_differences.json")
    ref_fam = _load(runs["jax"], "family_differences.json")
    assert list(own_fam) == list(ref_fam)
    for family, metrics in ref_fam.items():
        assert "missing" not in metrics
        for metric, r in metrics.items():
            # se = sqrt(std_base^2 + std_instruct^2), both from the D9
            # bootstraps: the MC draws' spread; the D9 means under it move
            # by the n_std bootstrap's noise.
            lo, hi = r["ci_propagated_std"]
            se = (hi - lo) / 3.92
            tol = _mean_tol(se, 10_000) + _mean_tol(se, n_std)
            got = own_fam[family][metric]["mc_difference"]["difference_mean"]
            assert abs(got - r["mc_difference"]["difference_mean"]) <= tol, (
                family, metric)


def test_pipeline_same_seed_bitwise(runs, inputs, tmp_path):
    _port(inputs, tmp_path / "again", make_figures=False)
    for p in sorted(runs["own"].iterdir()):
        assert (tmp_path / "again" / p.name).read_bytes() == p.read_bytes(), \
            p.name


def test_error_model_unmatched_prompt_and_nan_relative_prob(runs):
    """The D2's model whose rows are NaN (a model that failed to load):
    neither package raises; it has no agreement metrics from the D2 and
    is left out of the p-value pivot, as in JAX; the D1's copy of it (its
    mass NaN, so relative probability 0.5) is a constant model. The
    unmatched prompt counts among the LLM prompts and not the matches;
    the NaN relative probability is skipped where JAX skips it."""
    err = synthetic.SURVEY_ERROR_MODEL
    for d in (runs["own"], runs["jax"]):
        pts = _load(d, "llm_human_agreement_analysis.json")["model_results"]
        assert [(r["model"], r["model_type"]) for r in pts
                if r["model"] == err] == [(err, "base")]
        boot = _load(d, "llm_human_agreement_bootstrap.json")["model_results"]
        row = [r for r in boot if r["model"] == err]
        assert len(row) == 1 and row[0]["model_type"] == "base"
        assert math.isnan(row[0]["pearson_r_mean"])
        pv = _load(d, "correlation_pvalues_analysis.json")["llm_correlations"]
        assert all(err not in (r["model1"], r["model2"]) for r in pv)
        cons = _load(d, "consolidated_analysis_results.json")["matching_stats"]
        assert (cons["n_llm_prompts"], cons["n_matched"]) == (51, 50)
        sim = _load(d, "bootstrap_confidence_intervals.json")
        assert err not in sim["model_stats"]
        prop = _load(d, "proportion_analysis.json")
        assert sum(r["model"] == err for r in prop["invalid_responses"]) == 50
    llm_items = runs["own_res"]["consolidated"]["llm_item_agreement"]
    ref_items = runs["jax_res"]["consolidated"]["llm_item_agreement"]
    for prompt, r in ref_items["per_item"].items():
        assert llm_items["per_item"][prompt]["n_models"] == r["n_models"]
    # The zero-mass row's prompt counts one model fewer; the unmatched
    # prompt has one model.
    nan_prompt = list(synthetic.question_leans())[7]
    counts = {p: r["n_models"] for p, r in llm_items["per_item"].items()}
    n_d2 = len(synthetic.SURVEY_FAMILY_MODELS) + 2
    assert counts[nan_prompt] == n_d2 - 1
    assert synthetic.UNMATCHED_PROMPT not in counts     # one value: skipped
    assert sum(v == n_d2 for v in counts.values()) == 49


def test_figures_are_the_jax_file_names(runs, inputs, tmp_path):
    _port(inputs, tmp_path / "figs")
    port_png = sorted(p.name for p in (tmp_path / "figs").glob("*.png"))
    jax_png = sorted(p.name for p in runs["jax"].glob("*.png"))
    assert port_png == jax_png == sorted(FIGURES)
    assert sorted(p.name for p in (tmp_path / "figs").iterdir()) == sorted(
        p.name for p in runs["jax"].iterdir())


def test_make_figures_false_writes_every_json_and_no_png(runs):
    names = sorted(p.name for p in runs["own"].iterdir())
    assert names == sorted(JSONS + ("consolidated_report.txt",))
    assert sorted(set(p.name for p in runs["jax"].iterdir())
                  - set(names)) == sorted(FIGURES)


# ---------------------------------------------------------------------------
# The streaming accumulator's entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sink_snapshot():
    """A StreamSink on the CPU folded from seeded readouts: 3 prompts x
    40 rephrasings, two dispatches of 32 rows with pad rows, a few rows
    invalid (zero mass)."""
    from dataclasses import dataclass

    @dataclass
    class Cell:
        prompt_idx: int
        rephrase_idx: int

    rng = np.random.default_rng(21)
    sink = tss.StreamSink(3, 40, seed=77, device=CPU)
    cells = [Cell(p, r) for p in range(3) for r in range(40)]
    rng.shuffle(cells)
    for start in range(0, 96, 32):
        batch = cells[start:start + 32]
        yes = rng.uniform(0.0, 0.9, 32).astype(np.float32)
        no = (rng.uniform(0.0, 1.0, 32) * (1 - yes)).astype(np.float32)
        yes[:2] = no[:2] = 0.0
        sink.fold(torch.from_numpy(yes), torch.from_numpy(no),
                  torch.from_numpy(rng.uniform(0, 100, 32).astype(np.float32)),
                  torch.full((32, 20), -1.0), batch[:30])
    return sink.snapshot()


def _jax_accum(acc):
    return jstream.HostAccum(filled=acc.filled.copy(), rel=acc.rel.copy(),
                             conf=acc.conf.copy(), dec=acc.dec.copy(),
                             seed=acc.seed)


def test_llm_prompt_estimates_from_accum_on_jax_draws(sink_snapshot,
                                                      monkeypatch):
    acc = sink_snapshot
    ref = jhl.llm_prompt_estimates_from_accum(_jax_accum(acc), n_boot=500)
    draws = []
    for p in sorted(ref):
        key = jax.random.fold_in(jax.random.PRNGKey(acc.seed), p)
        draws.append(("idx", np.asarray(jcore.resample_indices(
            key, 500, ref[p]["n"]))))
    monkeypatch.setattr(tstream, "resample_indices", Replay(draws).idx)
    got = thl.llm_prompt_estimates_from_accum(acc, n_boot=500, device=CPU)
    assert list(got) == list(ref) and len(got) == 3
    for p, r in ref.items():
        assert got[p]["n"] == r["n"]
        assert got[p]["estimate"] == r["estimate"]
        assert_same(got[p], r, TOL, str(p))


def test_llm_prompt_estimates_from_accum_own_generator(sink_snapshot):
    acc = sink_snapshot
    ref = jhl.llm_prompt_estimates_from_accum(_jax_accum(acc), n_boot=2000)
    got = thl.llm_prompt_estimates_from_accum(acc, n_boot=2000, device=CPU)
    again = thl.llm_prompt_estimates_from_accum(acc, n_boot=2000, device=CPU)
    assert got == again
    for p, r in ref.items():
        assert (got[p]["n"], got[p]["estimate"]) == (r["n"], r["estimate"])
        for k in ("ci_lower", "ci_upper"):
            _ci_close(got[p][k], r[k], r["standard_error"], 2000, (p, k))
        assert got[p]["n"] == int(((acc.filled[p] > 0)
                                   & np.isfinite(acc.rel[p])).sum())
