"""The port's pandas-free table (``lir_tpu_torch.data.table``), LaTeX
generators and figures against pandas and the JAX package, on the CPU.

- ``read_table`` gives each column pandas' ``read_csv`` type and values
  (its default float converter included), ``Table.to_csv`` files read
  back under pandas to the same values, and ``unique``, ``codes``,
  ``groups``, ``pivot_table``, ``merge`` and ``Pivot.dropna`` order and
  aggregate as pandas does, NaN and duplicates included.
- The LaTeX tables are the JAX package's text on the same rows and
  generator (the all-numeric table's integers printed as floats, as
  ``DataFrame.iterrows`` gives them).
- The figures: each driver with ``make_figures=True`` writes the files
  the JAX package writes; without matplotlib a driver asked for figures
  raises before it writes anything; the QQ band's batched sort equals
  the JAX package's on the same resample indices.
"""

import io
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from lir_tpu.analysis import base_vs_instruct as j_bvi
from lir_tpu.analysis import kappa_combined as j_kappa
from lir_tpu.analysis import model_graph as j_graph
from lir_tpu.analysis import perturbation as j_pert
from lir_tpu.report import figures as j_figures
from lir_tpu.report import latex as j_latex
from lir_tpu_torch.analysis import base_vs_instruct as t_bvi
from lir_tpu_torch.analysis import kappa_combined as t_kappa
from lir_tpu_torch.analysis import model_graph as t_graph
from lir_tpu_torch.analysis import perturbation as t_pert
from lir_tpu_torch.data import schemas
from lir_tpu_torch.data import synthetic as t_synth
from lir_tpu_torch.data.table import (NA_STRINGS, Table, infer_column,
                                      parse_float, read_table)
from lir_tpu_torch.report import figures as t_figures
from lir_tpu_torch.report import latex as t_latex

from test_torch_analysis import seeded_comparison_rows

# ---------------------------------------------------------------------------
# Reading and writing CSV as pandas does
# ---------------------------------------------------------------------------

CELLS = ["1", "+1", " 1", "1 ", "\t1", "-0", "00012", "1_0", "1.0", "1e3",
         "1E3", ".5", "5.", "1.5e+3", "+.5e-2", "inf", "-inf", "+inf", "Inf",
         "INF", "Infinity", "-Infinity", "iNf", "0x1", "1d3", "--1", "1e",
         "e3", "nan(1)", "NAN", "True", "false", "TRUE", "yes", "0.1",
         "0.27629176373482295", "1e400", "2.2250738585072014e-308"]


def _pandas_column(cells):
    text = "a\n" + "\n".join(f'"{c}"' for c in cells) + "\n"
    return pd.read_csv(io.StringIO(text))["a"].to_numpy()


def _same(ours: np.ndarray, ref: np.ndarray):
    kind = "object" if ref.dtype.kind in "OUT" else ref.dtype.name
    assert (ours.dtype.name if ours.dtype.kind != "O" else "object") == (
        "object" if kind not in ("int64", "float64", "bool") else kind)
    for a, b in zip(ours, ref):
        assert (a == b) or (pd.isna(a) and pd.isna(b)), (a, b)


@pytest.mark.parametrize("cell", CELLS)
def test_infer_column_matches_read_csv(cell):
    """Each cell alone, with an integer, and with a missing cell."""
    for cells in ([cell], [cell, "2"], [cell, ""], [cell, "NA", "3"]):
        _same(infer_column(cells), _pandas_column(cells))


def test_na_strings_are_pandas_defaults():
    from pandas._libs.parsers import STR_NA_VALUES

    assert NA_STRINGS == frozenset(STR_NA_VALUES)
    for na in sorted(NA_STRINGS - {""}):
        _same(infer_column(["1", na, "2"]), _pandas_column(["1", na, "2"]))


def test_parse_float_is_pandas_converter():
    """Bit for bit against read_csv on repr, %.20f and %.25e texts of
    random doubles across the exponent range (where ``float(text)``
    differs from read_csv on a third of them)."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.uniform(0, 1, 3000), rng.normal(0, 1e6, 1000),
                           10.0 ** rng.uniform(-320, 308, 1000)])
    texts = ([repr(float(v)) for v in vals]
             + [f"{v:.20f}" for v in vals[:500]]
             + [f"{v:.25e}" for v in vals[:500]])
    ref = pd.read_csv(io.StringIO("a\n" + "\n".join(texts) + "\n"))["a"]
    ours = np.array([parse_float(t) for t in texts])
    np.testing.assert_array_equal(ours, ref.to_numpy())
    assert sum(float(t) != r for t, r in zip(texts, ref)) > 100


def test_read_table_matches_read_csv_on_d6(tmp_path):
    d6 = t_synth.write_synthetic_d6(tmp_path / "d6.csv")
    ours, ref = read_table(d6), pd.read_csv(d6)
    assert ours.columns == list(ref.columns)
    for col in ref.columns:
        _same(ours[col], ref[col].to_numpy())


def test_read_table_skips_blank_lines_and_pads_short_rows(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text('a,b,c\n1,x,2.5\n\n2,"y\nz"\n3,,\n')
    ours, ref = read_table(path), pd.read_csv(path)
    assert len(ours) == len(ref) == 3
    for col in ref.columns:
        _same(ours[col], ref[col].to_numpy())


def test_to_csv_reads_back_under_pandas(tmp_path):
    records = [{"i": 1, "f": 0.1, "s": "a,b", "b": True, "n": None},
               {"i": 2, "f": float("nan"), "s": 'q"t', "b": False,
                "n": float("inf")},
               {"i": 3, "f": 1e-17, "s": "line\nbreak", "b": True, "n": 2.5}]
    Table.from_records(records).to_csv(tmp_path / "port.csv")
    pd.DataFrame(records).to_csv(tmp_path / "pandas.csv", index=False)
    ours, ref = pd.read_csv(tmp_path / "port.csv"), pd.read_csv(
        tmp_path / "pandas.csv")
    pd.testing.assert_frame_equal(ours, ref)
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "pandas.csv").read_bytes()


def test_empty_table_writes_what_pandas_writes(tmp_path):
    Table.from_records([]).to_csv(tmp_path / "port.csv")
    pd.DataFrame([]).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "pandas.csv").read_bytes()


def _random_frame(seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 120
    keys = np.array([f"k{i}" for i in rng.integers(0, 9, n)], dtype=object)
    keys[rng.random(n) < 0.05] = np.nan
    cols = np.array([f"c{i}" for i in rng.integers(0, 5, n)], dtype=object)
    vals = rng.normal(0, 1, n)
    vals[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({"key": keys, "col": cols, "val": vals})


def _table(frame: pd.DataFrame) -> Table:
    return Table({c: frame[c].to_numpy() for c in frame.columns})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_operations_order_as_pandas(seed):
    frame = _random_frame(seed)
    tab = _table(frame)
    ref_u = frame["key"].unique()
    ours_u = tab.unique("key")
    assert len(ours_u) == len(ref_u)
    for a, b in zip(ours_u, ref_u):
        assert a == b or (pd.isna(a) and pd.isna(b))
    np.testing.assert_array_equal(tab.codes("key"),
                                  pd.factorize(frame["key"])[0])
    groups = tab.groups("key")
    ref_groups = list(frame.groupby("key"))
    assert [k for k, _ in groups] == [k for k, _ in ref_groups]
    for (_, g), (_, rg) in zip(groups, ref_groups):
        np.testing.assert_array_equal(g["val"], rg["val"].to_numpy())

    pivot = tab.pivot_table("key", "col", "val")
    ref = frame.pivot_table(index="key", columns="col", values="val")
    assert pivot.index == list(ref.index)
    assert pivot.columns == list(ref.columns)
    np.testing.assert_array_equal(pivot.values, ref.to_numpy())
    for thresh in (None, 2, 4):
        kept = pivot.dropna(thresh=thresh)
        rk = ref.dropna() if thresh is None else ref.dropna(thresh=thresh)
        assert kept.index == list(rk.index)
        np.testing.assert_array_equal(kept.values, rk.to_numpy())


def test_pivot_drops_all_missing_models_as_pandas():
    """A model whose every value is NaN leaves the pivot, and asking for
    its column raises KeyError, as under pandas (caveat R5)."""
    frame = pd.DataFrame({"prompt": ["a", "b", "a", "b"],
                          "model": ["m1", "m1", "m2", "m2"],
                          "relative_prob": [0.2, 0.4, np.nan, np.nan]})
    ref = frame.pivot_table(index="prompt", columns="model",
                            values="relative_prob")
    pivot = _table(frame).pivot_table("prompt", "model", "relative_prob")
    assert pivot.columns == list(ref.columns) == ["m1"]
    with pytest.raises(KeyError):
        ref["m2"]
    with pytest.raises(KeyError):
        pivot["m2"]


@pytest.mark.parametrize("with_nan", [False, True])
def test_merge_orders_as_pandas(with_nan):
    """Duplicate keys on both sides, unmatched keys, missing keys, empty
    sides; seed 3 hits pandas' shortcut (as many pairs as left rows)."""
    keys = list("abcde") + ([np.nan] if with_nan else [])
    for seed in range(150):
        rng = np.random.default_rng(seed)
        nl, nr = (12, 9) if seed == 3 else rng.integers(0, 14, 2)
        left = pd.DataFrame({
            "prompt": rng.choice(keys, nl).astype(object),
            "v": rng.normal(size=nl), "w": np.arange(nl)})
        right = pd.DataFrame({
            "prompt": rng.choice(keys[1:] + ["f"], nr).astype(object),
            "v": rng.normal(size=nr)})
        ref = pd.merge(left, right, on="prompt",
                       suffixes=("_base", "_instruct"))
        ours = _table(left).merge(_table(right), "prompt",
                                  ("_base", "_instruct"))
        assert ours.columns == list(ref.columns)
        for col in ("w", "v_base", "v_instruct"):
            np.testing.assert_array_equal(ours[col], ref[col].to_numpy(),
                                          err_msg=f"seed {seed} {col}")


# ---------------------------------------------------------------------------
# LaTeX
# ---------------------------------------------------------------------------

def test_compliance_tables_are_the_jax_text():
    """An all-numeric table prints its integers as floats (iterrows), a
    table with a text column as integers; a missing conditional rate
    prints N/A."""
    comp = [{"Prompt": 1, "Expected_First_Tokens": "A, B", "Total_Samples": 9,
             "First_Token_Compliant": 0, "First_Token_Non_Compliant": 9,
             "First_Token_Compliance_Rate": 0.0,
             "First_Token_Non_Compliance_Rate": 100.0},
            {"Prompt": 2, "Expected_First_Tokens": "C, D", "Total_Samples": 7,
             "First_Token_Compliant": 5, "First_Token_Non_Compliant": 2,
             "First_Token_Compliance_Rate": 500 / 7,
             "First_Token_Non_Compliance_Rate": 200 / 7,
             "Conditional_Subsequent_Compliant": 4,
             "Conditional_Subsequent_Non_Compliant": 1,
             "Conditional_Subsequent_Compliance_Rate": 80.0,
             "Conditional_Subsequent_Non_Compliance_Rate": 20.0}]
    assert t_latex.compliance_latex_table(Table.from_records(comp)) == \
        j_latex.compliance_latex_table(pd.DataFrame(comp))
    conf = [{"Prompt": p, "Total_Confidence_Samples": 10 * p,
             "Confidence_Compliant": p, "Confidence_Non_Compliant": 9 * p,
             "Confidence_Compliance_Rate": 10.0,
             "Confidence_Non_Compliance_Rate": 90.0, "Float_Errors": p,
             "Text_Errors": 2, "Out_Of_Range_Errors": 3, "Other_Errors": 0}
            for p in (1, 2, 3)]
    text = t_latex.confidence_compliance_latex_table(Table.from_records(conf))
    assert text == j_latex.confidence_compliance_latex_table(
        pd.DataFrame(conf))
    assert "\n1.0 & 90.000 & 10.0 &" in text


@pytest.fixture(scope="module")
def d6(tmp_path_factory):
    return t_synth.write_synthetic_d6(tmp_path_factory.mktemp("d6") / "d6.csv")


@pytest.mark.parametrize("prompt_idx", [0, 3, 7])
def test_perturbation_latex_table_is_the_jax_text(d6, prompt_idx):
    """Rows with ties, NaN and missing confidences; fewer rows than
    chunks; the shared generator left in the same state."""
    frame = j_pert.add_relative_prob(pd.read_csv(d6))
    table = t_pert.add_relative_prob(read_table(d6))
    sub = frame[frame["Model"] == t_synth.SYNTH_EDGE_MODEL]
    tsub = table.where("Model", t_synth.SYNTH_EDGE_MODEL)
    prompt = sub["Original Main Part"].unique()[prompt_idx % 5]
    for n in (None, 15):
        f = sub[sub["Original Main Part"] == prompt]
        t = tsub.where("Original Main Part", prompt)
        if n is not None:
            f, t = f.head(n), t.take(np.arange(n))
        rj, rt = np.random.default_rng(5), np.random.default_rng(5)
        assert t_latex.perturbation_latex_table(
            t, prompt_idx, "main", ("X", "Y"), rt) == \
            j_latex.perturbation_latex_table(f, prompt_idx, "main",
                                             ("X", "Y"), rj)
        assert rt.integers(1 << 30) == rj.integers(1 << 30)


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------

def _names(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))


def test_perturbation_figures_same_files_as_jax(d6, tmp_path):
    frame = pd.read_csv(d6)
    table = schemas.read_results_frame(d6)
    model = t_synth.SYNTH_EDGE_MODEL
    j_pert.analyze_model(frame[frame["Model"] == model].copy(), model,
                         tmp_path / "jax", n_simulations=2000)
    t_pert.analyze_model(table.where("Model", model), model,
                         tmp_path / "port", n_simulations=2000, device="cpu")
    assert len(_names(tmp_path / "port")) == 32
    assert _names(tmp_path / "port") == _names(tmp_path / "jax")


def test_comparison_figures_same_files_as_jax(d6, tmp_path):
    rows = seeded_comparison_rows()
    d1, d2 = tmp_path / "d1.csv", tmp_path / "d2.csv"
    schemas.write_model_comparison_csv(rows, d1)
    schemas.write_instruct_comparison_csv(rows, d2)
    j_bvi.run_base_vs_instruct_analysis(d1, tmp_path / "jax" / "bvi")
    t_bvi.run_base_vs_instruct_analysis(d1, tmp_path / "port" / "bvi")
    j_graph.run_model_graph_analysis(d2, tmp_path / "jax" / "graph",
                                     n_bootstrap=100)
    t_graph.run_model_graph_analysis(d2, tmp_path / "port" / "graph",
                                     n_bootstrap=100, device="cpu")
    j_kappa.run_kappa_analysis(d2, d6, tmp_path / "jax" / "kappa",
                               n_bootstrap=100)
    t_kappa.run_kappa_analysis(d2, d6, tmp_path / "port" / "kappa",
                               n_bootstrap=100, device="cpu")
    names = _names(tmp_path / "port")
    assert names == _names(tmp_path / "jax")
    assert {n.split("/")[0] for n in names} == {"bvi", "graph", "kappa"}


@pytest.mark.parametrize("driver", ["perturbation", "base_vs_instruct",
                                    "model_graph", "kappa"])
def test_figures_without_matplotlib_raise_before_writing(
        monkeypatch, d6, tmp_path, driver):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match="matplotlib"):
        if driver == "perturbation":
            t_pert.analyze_all_models(d6, out, device="cpu")
        elif driver == "base_vs_instruct":
            t_bvi.run_base_vs_instruct_analysis(d6, out)
        elif driver == "model_graph":
            t_graph.run_model_graph_analysis(d6, out, device="cpu")
        else:
            t_kappa.run_kappa_analysis(d6, d6, out, device="cpu")
    assert not out.exists() or not any(out.rglob("*"))


def test_qq_band_sort_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    vals = rng.normal(size=257)
    idx = rng.integers(0, vals.size, (300, vals.size))
    ours = t_figures._sorted_resamples(
        torch.from_numpy(vals.astype(np.float32)), torch.from_numpy(idx))
    ref = j_figures._sorted_resamples(jnp.asarray(vals, jnp.float32),
                                      jnp.asarray(idx))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
