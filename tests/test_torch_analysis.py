"""The port's analysis drivers (``lir_tpu_torch.analysis``) against the JAX
package's (``lir_tpu.analysis``) on the same artifacts, on the CPU.

- The perturbation analysis of the pinned synthetic D6 (both models,
  after a CSV round trip): summary, normality and kappa floats to 1e-6,
  compliance counts and every string exact, the ``.tex`` files
  identical, the truncated-normal fit's deterministic columns to 1e-6
  and its Monte Carlo columns within the executed reference's bands; the
  same outputs against the golden ``analyze_perturbation_results``
  (the executed reference), with ``test_reference_differential``'s
  tolerances.
- pandas' type inference (caveat R4): a confidence column of integers
  with one empty cell reads as floats in both packages, so both count
  every integer answer a float error; "None"/"NA" cells are missing.
- Base-vs-instruct, model graph and combined kappa on a seeded D1/D2
  written by the port's own writers (50 questions, 6 models in 3
  base/instruct families plus a filtered Mistral model, NaN cells, a zero
  probability, a duplicate (prompt, model) row): deterministic outputs to
  1e-6 or exact, bootstrap quantities within the Monte Carlo bands of
  ``test_reference_differential`` (each package on its own generator).
- Determinism: the same seed gives the same artifacts, byte for byte.
- The synthetic fixture is the JAX package's, value for value.
"""

import csv
import filecmp
import json
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from lir_tpu.analysis import base_vs_instruct as j_bvi
from lir_tpu.analysis import kappa_combined as j_kappa
from lir_tpu.analysis import model_graph as j_graph
from lir_tpu.analysis import perturbation as j_pert
from lir_tpu.data import synthetic as j_synth
from lir_tpu_torch.analysis import base_vs_instruct as t_bvi
from lir_tpu_torch.analysis import kappa_combined as t_kappa
from lir_tpu_torch.analysis import model_graph as t_graph
from lir_tpu_torch.analysis import perturbation as t_pert
from lir_tpu_torch.data import WORD_MEANING_QUESTIONS, ScoreRow, schemas
from lir_tpu_torch.data import synthetic as t_synth
from lir_tpu_torch.data.table import cell_text, is_missing

GOLDEN = Path(__file__).parent / "golden" / "reference_executed.json"
MODELS = ["synthetic-scorer-v1", "synthetic-edge-v1"]
CI_ABS = 0.06       # |delta| of independently resampled CI endpoints
BOOT_ABS = 0.03     # |delta| of independently resampled bootstrap means
SELF_KAPPA_ABS = 0.02


def _diff_frames(ours: pd.DataFrame, ref: pd.DataFrame, *, loose=(),
                 loose_abs=0.0, exact=(), skip=()):
    """Column-wise diff with per-column tolerance (the rules of
    test_reference_differential._diff_frames)."""
    assert len(ours) == len(ref), (len(ours), len(ref))
    for col in ref.columns:
        if col in skip:
            continue
        r = ref[col].to_numpy()
        assert col in ours.columns, f"missing column {col!r}"
        o = ours[col].to_numpy()
        if col in exact:
            assert list(o) == list(r), col
        elif col in loose:
            np.testing.assert_allclose(
                o.astype(float), r.astype(float), atol=loose_abs,
                rtol=0.05, equal_nan=True, err_msg=col)
        elif np.issubdtype(r.dtype, np.number) and r.dtype != bool:
            np.testing.assert_allclose(
                o.astype(float), r.astype(float), rtol=1e-6, atol=1e-9,
                equal_nan=True, err_msg=col)
        else:
            assert list(o) == list(r), col


def _close(a, b, rel=0.0, abs_tol=0.0) -> bool:
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return True
    return abs(a - b) <= max(abs_tol, rel * abs(b))


# ---------------------------------------------------------------------------
# The perturbation analysis on the pinned synthetic D6
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pert(tmp_path_factory):
    """Both packages' analyze_model on each synthetic model, the D6 read
    back from the port's CSV by each package's own reader."""
    root = tmp_path_factory.mktemp("pert")
    d6 = t_synth.write_synthetic_d6(root / "combined_results.csv")
    frame = pd.read_csv(d6)
    table = schemas.read_results_frame(d6)
    out = {}
    for i, model in enumerate(MODELS):
        jdir, tdir = root / "jax" / model, root / "port" / model
        j_pert.analyze_model(frame[frame["Model"] == model].copy(), model,
                             jdir, make_figures=False)
        res = t_pert.analyze_model(table.where("Model", model), model, tdir,
                                   model_idx=i, make_figures=False,
                                   device="cpu")
        out[model] = {"jax": jdir, "port": tdir, "result": res}
    return out


PERT_TABLES = {
    "summary_statistics": dict(exact=("First Token", "Second Token")),
    "normality_test_results": dict(exact=("Column", "KS Normal (p>0.05)",
                                          "AD Normal (stat<crit)")),
    "cohens_kappa_results": dict(exact=("Model",)),
    "output_compliance_results": dict(exact=(
        "Prompt", "Expected_First_Tokens", "Total_Samples",
        "First_Token_Compliant", "First_Token_Non_Compliant",
        "Conditional_Subsequent_Compliant",
        "Conditional_Subsequent_Non_Compliant")),
    "confidence_compliance_results": dict(exact=(
        "Prompt", "Total_Confidence_Samples", "Confidence_Compliant",
        "Confidence_Non_Compliant", "Float_Errors", "Text_Errors",
        "Out_Of_Range_Errors", "Other_Errors")),
}
TEX_FILES = ("prompt_perturbation_tables.tex",
             "prompt_perturbation_standalone.tex", "compliance_summary.tex",
             "confidence_compliance_summary.tex")
# The truncated fit's columns fixed by the data (not the draws).
FIT_DETERMINISTIC = ("Observed Mean", "Observed Std Dev", "Interior Mean",
                     "Interior Std Dev", "Zero Proportion", "One Proportion")
FIT_MC = ("Underlying Normal Mean", "Underlying Normal Std Dev",
          "Simulated Mean", "Simulated Std Dev")


@pytest.mark.parametrize("stem", sorted(PERT_TABLES))
@pytest.mark.parametrize("model", MODELS)
def test_perturbation_tables_vs_jax(pert, model, stem):
    ours = pd.read_csv(pert[model]["port"] / f"{stem}.csv")
    ref = pd.read_csv(pert[model]["jax"] / f"{stem}.csv")
    assert list(ours.columns) == list(ref.columns)
    assert dict(ours.dtypes) == dict(ref.dtypes)
    _diff_frames(ours, ref, **PERT_TABLES[stem])


@pytest.mark.parametrize("name", TEX_FILES)
@pytest.mark.parametrize("model", MODELS)
def test_perturbation_latex_identical_to_jax(pert, model, name):
    assert filecmp.cmp(pert[model]["port"] / name, pert[model]["jax"] / name,
                       shallow=False), name


@pytest.mark.parametrize("model", MODELS)
def test_perturbation_truncated_fit_vs_jax(pert, model):
    ours = pd.read_csv(pert[model]["port"] / "truncated_normal_test_results.csv")
    ref = pd.read_csv(pert[model]["jax"] / "truncated_normal_test_results.csv")
    assert list(ours.columns) == list(ref.columns)
    assert list(ours["Prompt"]) == list(ref["Prompt"])
    assert list(ours["Column"]) == list(ref["Column"])
    assert list(ours["Model Type"]) == list(ref["Model Type"])
    for i in range(len(ref)):
        scale = 100.0 if ref.loc[i, "Column"] == "Weighted Confidence" else 1.0
        for col in FIT_DETERMINISTIC:
            assert _close(ours.loc[i, col], ref.loc[i, col], rel=1e-6,
                          abs_tol=1e-9 * scale), (i, col)
        for col in FIT_MC:
            assert _close(ours.loc[i, col], ref.loc[i, col], rel=0.05,
                          abs_tol=0.05 * scale), (i, col)
        assert _close(ours.loc[i, "KS Statistic"], ref.loc[i, "KS Statistic"],
                      abs_tol=0.08), i


def _golden(model, stem):
    if not GOLDEN.exists():
        pytest.skip("no golden capture")
    return pd.DataFrame(json.loads(GOLDEN.read_text())
                        ["analyze_perturbation_results"][model][stem])


@pytest.mark.parametrize("stem", [
    "summary_statistics", "normality_test_results", "cohens_kappa_results",
    "output_compliance_results", "confidence_compliance_results"])
@pytest.mark.parametrize("model", MODELS)
def test_perturbation_tables_vs_executed_reference(pert, model, stem):
    ours = pd.read_csv(pert[model]["port"] / f"{stem}.csv")
    _diff_frames(ours, _golden(model, stem), **PERT_TABLES[stem])


@pytest.mark.parametrize("model", MODELS)
def test_perturbation_truncated_fit_vs_executed_reference(pert, model):
    """The executed reference's fit ran on its own 100,000 draws: the
    deterministic columns to 1e-6 (inflation shares to 1e-12), the Monte
    Carlo ones within rel 0.05 and KS within abs 0.08."""
    ref = _golden(model, "truncated_normal_test_results")
    ours = pd.read_csv(pert[model]["port"] / "truncated_normal_test_results.csv")
    key = ["Prompt", "Column"]
    ref = ref.sort_values(key).reset_index(drop=True)
    ours = ours.sort_values(key).reset_index(drop=True)
    assert list(ours["Prompt"]) == list(ref["Prompt"])
    assert list(ours["Column"]) == list(ref["Column"])
    for i in range(len(ref)):
        scale = 100.0 if float(ref.loc[i, "Observed Mean"]) > 1.5 else 1.0
        for col in ("Observed Mean", "Observed Std Dev", "Interior Mean",
                    "Interior Std Dev"):
            assert _close(ours.loc[i, col], ref.loc[i, col], rel=1e-6,
                          abs_tol=1e-9 * scale), (i, col)
        for col in ("Zero Proportion", "One Proportion"):
            assert _close(ours.loc[i, col], ref.loc[i, col],
                          abs_tol=1e-12), (i, col)
        for col in FIT_MC:
            assert _close(ours.loc[i, col], ref.loc[i, col], rel=0.05,
                          abs_tol=0.05 * scale), (i, col)
        assert _close(ours.loc[i, "KS Statistic"], ref.loc[i, "KS Statistic"],
                      abs_tol=0.08), i


def test_perturbation_returned_tables_are_the_written_files(pert):
    """The tables analyze_model returns are the ones it wrote: each field
    the value's text (floats by repr, so they round-trip exactly)."""
    model = MODELS[1]
    res = pert[model]["result"]
    assert res["status"] == "ok"
    for key, stem in (("summary", "summary_statistics"),
                      ("truncated", "truncated_normal_test_results"),
                      ("compliance", "output_compliance_results"),
                      ("confidence_compliance",
                       "confidence_compliance_results")):
        with (pert[model]["port"] / f"{stem}.csv").open(newline="") as f:
            header, *rows = list(csv.reader(f))
        assert res[key].columns == header
        for j, col in enumerate(header):
            want = ["" if is_missing(v) else str(cell_text(v))
                    for v in res[key][col]]
            assert [r[j] for r in rows] == want, (stem, col)


def test_insufficient_rows_guard_matches_jax(tmp_path):
    """Fewer than MIN_ROWS_FOR_ANALYSIS rows: only the status summary."""
    frame = j_synth.synthetic_perturbation_frame().head(60)
    csv = tmp_path / "small.csv"
    frame.to_csv(csv, index=False)
    j_pert.analyze_model(pd.read_csv(csv), "m", tmp_path / "jax",
                         make_figures=False)
    res = t_pert.analyze_model(schemas.read_results_frame(csv), "m",
                               tmp_path / "port", make_figures=False,
                               device="cpu")
    assert res["status"] == "insufficient_data"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert (tmp_path / "port" / "summary_statistics.csv").read_bytes() == (
        tmp_path / "jax" / "summary_statistics.csv").read_bytes()


def test_analyze_all_models_layout_matches_jax(tmp_path):
    """One directory per model, named as the JAX package names it, with
    the same files; the port's model i draws with model_idx = i."""
    d6 = t_synth.write_synthetic_d6(tmp_path / "d6.xlsx")
    assert d6.suffix == ".csv"
    j_pert.analyze_all_models(d6, tmp_path / "jax", n_simulations=2000,
                              make_figures=False)
    res = t_pert.analyze_all_models(tmp_path / "d6.xlsx", tmp_path / "port",
                                    n_simulations=2000, make_figures=False,
                                    device="cpu")
    assert list(res) == MODELS

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")


# ---------------------------------------------------------------------------
# pandas' type inference (caveat R4)
# ---------------------------------------------------------------------------

def _r4_records():
    """The scorer model's rows with every confidence answer an integer but
    one, which is empty; and the edge model's with "None"/"NA" answers."""
    recs = [dict(r) for r in t_synth.synthetic_records()]
    scorer = [r for r in recs if r["Model"] == t_synth.SYNTH_MODEL]
    scorer[7]["Model Confidence Response"] = ""
    edge = [r for r in recs if r["Model"] == t_synth.SYNTH_EDGE_MODEL]
    for i, r in enumerate(edge):
        if i % 3 == 0:
            r["Model Confidence Response"] = ("None", "NA", "null")[i % 9 // 3]
    return scorer, edge


@pytest.mark.parametrize("which", ["ints_and_one_empty", "none_and_na"])
def test_r4_confidence_compliance_counts_as_jax(tmp_path, which):
    scorer, edge = _r4_records()
    recs = scorer if which == "ints_and_one_empty" else edge
    csv = tmp_path / "d6.csv"
    schemas._write_csv(csv, [[schemas._cell(r[c])
                              for c in schemas.PERTURBATION_COLUMNS]
                             for r in recs])
    frame = j_pert.add_relative_prob(pd.read_csv(csv))
    table = t_pert.add_relative_prob(schemas.read_results_frame(csv))
    assert table["Model Confidence Response"].dtype == frame[
        "Model Confidence Response"].to_numpy().dtype
    ref = j_pert.check_confidence_compliance(frame, j_synth.LEGAL_PROMPTS)
    ours = t_pert.check_confidence_compliance(table, t_synth.LEGAL_PROMPTS)
    for col in ref.columns:
        np.testing.assert_array_equal(np.asarray(ours[col], float),
                                      ref[col].to_numpy(float), err_msg=col)
    if which == "ints_and_one_empty":
        # The column read as floats: every answer renders "85.0", so none
        # is compliant and all are float errors, in both packages.
        assert table["Model Confidence Response"].dtype == np.float64
        assert list(ours["Confidence_Compliant"]) == [0] * 5
        assert sum(ours["Total_Confidence_Samples"]) == len(recs) - 1
        assert list(ours["Float_Errors"]) == list(
            ours["Total_Confidence_Samples"])
    else:
        assert sum(ours["Total_Confidence_Samples"]) < sum(
            1 for r in recs if r["Model Confidence Response"] is not None)


# ---------------------------------------------------------------------------
# Base-vs-instruct, model graph and combined kappa on a seeded D1/D2
# ---------------------------------------------------------------------------

FAMILIES = (("meta-llama/llama-7b", "meta-llama/llama-7b-chat"),
            ("tiiuae/falcon-7b", "tiiuae/falcon-7b-instruct"),
            ("EleutherAI/pythia-6.9b", "EleutherAI/pythia-6.9b-dolly"))
MISTRAL = "mistralai/Mistral-7B-Instruct-v0.1"


def seeded_comparison_rows(seed: int = 20261018, n_questions: int = 50):
    """ScoreRows of 6 models in 3 base/instruct families and one Mistral
    model over the first ``n_questions`` word-meaning questions: a latent
    per-question lean plus per-model noise; NaN cells, a zero probability
    and a duplicate (prompt, model) row."""
    rng = np.random.default_rng(seed)
    questions = WORD_MEANING_QUESTIONS[:n_questions]
    lean = rng.uniform(0.05, 0.95, n_questions)
    models = [(name, kind) for fam in FAMILIES
              for name, kind in zip(fam, ("base", "instruct"))]
    rows = []
    for name, kind in models + [(MISTRAL, "instruct")]:
        for qi, q in enumerate(questions):
            rel = float(np.clip(lean[qi] + rng.normal(0, 0.2), 0.01, 0.99))
            total = float(rng.uniform(0.2, 0.9))
            yes, no = rel * total, (1 - rel) * total
            rows.append(ScoreRow(q, name, kind, "Yes" if yes > no else "No",
                                 yes, no))
    for i in (3, 57, 140, 222):
        rows[i].yes_prob = rows[i].no_prob = float("nan")
    rows[75].yes_prob = 0.0
    dup = ScoreRow(**{**rows[260].__dict__})
    dup.yes_prob, dup.no_prob = 0.61, 0.12
    rows.append(dup)
    return rows


@pytest.fixture(scope="module")
def d1_d2(tmp_path_factory):
    root = tmp_path_factory.mktemp("d1d2")
    rows = seeded_comparison_rows()
    d1, d2 = root / "model_comparison_results.csv", \
        root / "instruct_model_comparison_results.csv"
    schemas.write_model_comparison_csv(rows, d1)
    schemas.write_instruct_comparison_csv(rows, d2)
    d6 = t_synth.write_synthetic_d6(root / "combined_results.csv")
    return root, d1, d2, d6


def test_family_differences_vs_jax(d1_d2, tmp_path):
    _, d1, _, _ = d1_d2
    ref = j_bvi.run_base_vs_instruct_analysis(d1, tmp_path / "jax",
                                              make_figures=False)
    ours = t_bvi.run_base_vs_instruct_analysis(d1, tmp_path / "port",
                                               make_figures=False)
    assert list(ours["statistics"]["Model_Family"]) == [
        "llama", "falcon", "pythia"]
    for name in ("model_rel_prob_statistics.csv",
                 "prompt_rel_prob_differences.csv",
                 "prompt_rel_prob_heatmap_data.csv"):
        o = pd.read_csv(tmp_path / "port" / name)
        r = pd.read_csv(tmp_path / "jax" / name)
        assert list(o.columns) == list(r.columns), name
        _diff_frames(o, r, exact=("Model_Family", "Num_Samples", "Prompt",
                                  "Model Family"))
    # A zero probability drops its pair; every family is paired on the
    # questions both of its models answered.
    n = dict(zip(ref["statistics"]["Model_Family"],
                 ref["statistics"]["Num_Samples"]))
    assert n == dict(zip(ours["statistics"]["Model_Family"],
                         ours["statistics"]["Num_Samples"]))
    assert min(n.values()) < 50


@pytest.fixture(scope="module")
def graph(d1_d2, tmp_path_factory):
    _, _, d2, _ = d1_d2
    root = tmp_path_factory.mktemp("graph")
    ref = j_graph.run_model_graph_analysis(d2, root / "jax",
                                           make_figures=False)
    ours = t_graph.run_model_graph_analysis(d2, root / "port",
                                            make_figures=False, device="cpu")
    return root, ref, ours


def test_model_graph_deterministic_outputs_vs_jax(graph):
    root, ref, ours = graph
    assert ours["pivot"].columns == list(ref["pivot"].columns)
    assert ours["pivot"].index == list(ref["pivot"].index)
    np.testing.assert_array_equal(ours["pivot"].values,
                                  ref["pivot"].to_numpy())
    assert MISTRAL not in ours["pivot"].columns
    assert ours["reference_differences"]["reference_model"] == ref[
        "reference_differences"]["reference_model"]
    rd, od = (ref["reference_differences"]["differences"],
              ours["reference_differences"]["differences"])
    assert list(od) == list(rd)
    for model in rd:
        np.testing.assert_array_equal(od[model], rd[model])
    for name in ("model_pearson_correlation_matrix.csv",
                 "model_spearman_correlation_matrix.csv",
                 "model_pairwise_kappa_matrix.csv"):
        o = pd.read_csv(root / "port" / name, index_col=0)
        r = pd.read_csv(root / "jax" / name, index_col=0)
        assert list(o.index) == list(r.index) and list(o.columns) == list(
            r.columns), name
        np.testing.assert_allclose(o.to_numpy(), r.to_numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for method in ("pearson", "spearman"):
        for k in ("mean_correlation", "median_correlation",
                  "std_correlation", "min_correlation", "max_correlation"):
            assert _close(ours["correlations"][method][k],
                          ref["correlations"][method][k], rel=1e-6,
                          abs_tol=1e-9), (method, k)


def test_model_graph_bootstrap_within_monte_carlo_bands(graph):
    root, ref, ours = graph
    for method in ("pearson", "spearman"):
        for k in ("mean_ci", "median_ci", "std_ci"):
            for o, r in zip(ours["correlations"][method][k],
                            ref["correlations"][method][k]):
                assert _close(o, r, abs_tol=CI_ABS), (method, k, o, r)
    o = pd.read_csv(root / "port" / "aggregate_kappa_results.csv")
    r = pd.read_csv(root / "jax" / "aggregate_kappa_results.csv")
    assert list(o.columns) == list(r.columns)
    _diff_frames(o, r, loose=("kappa_ci_lower", "kappa_ci_upper"),
                 loose_abs=CI_ABS, exact=("n_prompts", "n_models"))


def test_model_graph_reference_fallback_draws_as_jax(d1_d2, tmp_path):
    """With no Baichuan anchor the reference model is drawn by
    np.random.default_rng(seed), as in the JAX package, for several
    seeds."""
    _, _, d2, _ = d1_d2
    frame = j_graph.filter_models(pd.read_csv(d2))
    table = t_graph.filter_models(schemas.read_results_frame(d2))
    picks = []
    for seed in range(6):
        r = j_graph.reference_model_differences(frame,
                                                np.random.default_rng(seed))
        o = t_graph.reference_model_differences(table,
                                                np.random.default_rng(seed))
        assert o["reference_model"] == r["reference_model"]
        picks.append(o["reference_model"])
    assert len(set(picks)) > 1


@pytest.fixture(scope="module")
def kappa(d1_d2, tmp_path_factory):
    _, _, d2, d6 = d1_d2
    root = tmp_path_factory.mktemp("kappa")
    ref = j_kappa.run_kappa_analysis(d2, d6, root / "jax",
                                     make_figures=False)
    ours = t_kappa.run_kappa_analysis(d2, d6, root / "port",
                                      make_figures=False, device="cpu")
    return root, ref, ours


def test_kappa_model_side_vs_jax(kappa):
    root, _, _ = kappa
    for name in ("model_kappa_metrics.csv", "model_legal_kappas.csv"):
        o = pd.read_csv(root / "port" / name)
        r = pd.read_csv(root / "jax" / name)
        assert list(o.columns) == list(r.columns), name
        _diff_frames(o, r, exact=("prompt", "n_models", "title", "source"))


def test_kappa_perturbation_side_vs_jax(kappa):
    root, _, _ = kappa
    for name in ("perturbation_kappa_metrics.csv",
                 "perturbation_legal_kappas.csv"):
        o = pd.read_csv(root / "port" / name)
        r = pd.read_csv(root / "jax" / name)
        assert list(o.columns) == list(r.columns), name
        _diff_frames(o, r, exact=("prompt", "n_variations", "title",
                                  "source"),
                     loose=("self_kappa", "self_kappa_std", "min_kappa",
                            "max_kappa"), loose_abs=0.1)
        for a, b in zip(o["self_kappa"], r["self_kappa"]):
            assert _close(a, b, abs_tol=SELF_KAPPA_ABS), (name, a, b)


def test_combined_kappa_vs_jax(kappa):
    root, ref, ours = kappa
    o = pd.read_csv(root / "port" / "combined_kappa_results.csv")
    r = pd.read_csv(root / "jax" / "combined_kappa_results.csv")
    assert list(o.columns) == list(r.columns)
    assert len(r) > 0
    _diff_frames(o, r, exact=("Prompt", "Model Interpretation"),
                 loose=("Perturbation Kappa", "Combined Mean Kappa",
                        "Combined Median Kappa", "Combined Lower CI",
                        "Combined Upper CI"), loose_abs=CI_ABS,
                 skip=("Perturbation Interpretation",
                       "Combined Interpretation"))
    for col in ("Combined Mean Kappa", "Combined Median Kappa"):
        for a, b in zip(o[col], r[col]):
            assert _close(a, b, abs_tol=BOOT_ABS), (col, a, b)
    tex_o = (root / "port" / "kappa_analysis_table.tex").read_text()
    tex_r = (root / "jax" / "kappa_analysis_table.tex").read_text()
    assert [ln.split(" & ")[:2] for ln in tex_o.splitlines()] == [
        ln.split(" & ")[:2] for ln in tex_r.splitlines()]


# ---------------------------------------------------------------------------
# Determinism and the fixture
# ---------------------------------------------------------------------------

def _artifacts(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_same_seed_same_artifacts_bitwise(d1_d2, tmp_path):
    _, d1, d2, d6 = d1_d2
    runs = []
    for k in range(2):
        out = tmp_path / f"run{k}"
        t_pert.analyze_all_models(d6, out / "perturbation",
                                  n_simulations=5000, make_figures=False,
                                  device="cpu")
        t_bvi.run_base_vs_instruct_analysis(d1, out / "bvi",
                                            make_figures=False)
        t_graph.run_model_graph_analysis(d2, out / "graph", n_bootstrap=200,
                                         make_figures=False, device="cpu")
        t_kappa.run_kappa_analysis(d2, d6, out / "kappa", n_bootstrap=200,
                                   make_figures=False, device="cpu")
        runs.append(_artifacts(out))
    assert len(runs[0]) >= 30
    assert runs[0] == runs[1]


def test_synthetic_records_equal_jax():
    ours = t_synth.synthetic_perturbation_frame()
    ref = j_synth.synthetic_perturbation_frame()
    assert ours.columns == list(ref.columns)
    assert len(ours) == len(ref)
    for col in ref.columns:
        r = ref[col].to_numpy()
        o = ours[col]
        nan_r = pd.isna(r)
        assert list(pd.isna(o)) == list(nan_r), col
        assert [a for a, m in zip(o, nan_r) if not m] == [
            b for b, m in zip(r, nan_r) if not m], col


def test_synthetic_d6_is_the_jax_csv(tmp_path):
    ours = t_synth.write_synthetic_d6(tmp_path / "port.csv")
    j_synth.synthetic_perturbation_frame().to_csv(tmp_path / "jax.csv",
                                                  index=False)
    assert ours.read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_r5_all_nan_model_stops_model_graph_as_jax(tmp_path):
    """Caveat R5: a D2 with a model whose every row is NaN (a model that
    failed to load) stops both packages' model graph with KeyError on
    that model."""
    rows = [r for r in seeded_comparison_rows() if r.model in FAMILIES[0]]
    for r in rows:
        if r.model == FAMILIES[0][1]:
            r.yes_prob = r.no_prob = float("nan")
    d2 = tmp_path / "d2.csv"
    schemas.write_instruct_comparison_csv(rows, d2)
    with pytest.raises(KeyError) as ref:
        j_graph.run_model_graph_analysis(d2, tmp_path / "jax",
                                         make_figures=False)
    with pytest.raises(KeyError) as ours:
        t_graph.run_model_graph_analysis(d2, tmp_path / "port",
                                         make_figures=False, device="cpu")
    assert ours.value.args == ref.value.args == (FAMILIES[0][1],)
