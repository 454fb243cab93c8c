"""The port's perturbation sweep against the JAX package's, end to end.

One module-scoped JAX sweep (the JAX engine with both interpreter hooks
armed and the features the port does not have off: streaming statistics,
piggybacking, the prefix cache, the compile plan, the numerics guard;
``spec_decode=False``, since spec == sequential is the reference's own
bitwise invariant, one JAX run serves both port routes) over a 15-cell
grid whose plan holds a grouped dispatch, a cascade dispatch and two
no-trunk shared dispatches. The port runs the same grid on ``device="cpu"``
with the same parameters. D6 rows must be equal in order and in every text
or integer field; probabilities and log-prob values agree within 1e-5,
the weighted confidence (a 0-100 value) within 1e-5 relative, top-20 ids
exact where neighbouring values are separated.

Also here: the CSV writer against the JAX writer under pandas (append,
schema-mismatch backup, torn-tail truncation, the corrupt-file side
file), each package resuming the other's manifest and artifact, the
checkpoint flushes, and a writer failure that must not mark unflushed
rows done.
"""

import dataclasses
import inspect
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data import schemas as jschemas
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu.utils.manifest import SweepManifest as JaxManifest
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LegalPrompt
from lir_tpu_torch.data import schemas as tschemas
from lir_tpu_torch.engine import grid as tgrid
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.utils.manifest import SweepManifest

from test_torch_engine import CFG, WEIGHT_SCALE

FTOL = 1e-5
MODEL = "sweep-tiny"
RF, CF = "Answer Yes or No .", "Give a number from 0 to 100 ."


def _grid():
    """Four prompts: A's rephrasings keep its 20-word text and vary a short
    ending (a 4-cell prefix group); B's share a 36-word preamble and then
    differ (a cascade trunk, too short a share of each prompt to group);
    C's and D's open differently (no trunk). D's 3-cell tail is promoted
    into B's bucket (slot refill), leaving 3 B cells padded to 4."""
    rng = np.random.default_rng(3)

    def words(n, tag):
        return " ".join(f"{tag}{int(x)}" for x in rng.integers(0, 10**6, n))

    a_main = words(20, "a")
    pre = words(36, "p")
    b_body = words(40, "b")
    c_main = words(30, "c")
    d_main = words(40, "d")
    prompts = [LegalPrompt(main=m, response_format=RF,
                           target_tokens=("Yes", "No"), confidence_format=CF)
               for m in (a_main, f"{pre} {b_body}", c_main, d_main)]
    perts = [
        [f"{a_main} variant {i} {words(1 + i, 'x')}" for i in range(3)],
        [f"{pre} version {i} : {words(40, 'y')}" for i in range(3)],
        [f"{words(3, 'z')} {c_main} {words(i, 'w')}" for i in range(3)],
        [f"{words(2, 'v')} {d_main}" for i in range(2)],
    ]
    return prompts, perts


PROMPTS, PERTS = _grid()
N_CELLS = sum(1 + len(p) for p in PERTS)
JAX_PROMPTS = [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                              target_tokens=p.target_tokens,
                              confidence_format=p.confidence_format)
               for p in PROMPTS]


def _tree():
    cfg_j = JaxModelConfig(**CFG)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    return cfg_j, tree


def _jax_engine(cfg_j, tree):
    return JaxEngine(
        jax.tree.map(jnp.asarray, tree), cfg_j, JaxFakeTokenizer(),
        JaxRuntimeConfig(batch_size=4, max_new_tokens=12, spec_decode=False,
                         piggyback_prefill=False, prefix_cache=False,
                         aot_precompile=False, streaming_stats=False,
                         numerics_guard=False))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(tree, JAX engine, JAX rows, the JAX run's results path)."""
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    cfg_j, tree = _tree()
    jeng = _jax_engine(cfg_j, tree)
    path = tmp_path_factory.mktemp("jax") / "results.csv"
    rows = jsweep.run_perturbation_sweep(jeng, MODEL, JAX_PROMPTS, PERTS,
                                         path, checkpoint_every=5)
    assert len(rows) == N_CELLS
    assert jeng.occupancy.grouped_cells == 4
    assert jeng.cascade_stats.cascade_dispatches == 1
    yield tree, jeng, rows, path
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _port_engine(tree, **rt):
    cfg = ModelConfig(**CFG)
    return ScoringEngine(params_from_jax(tree, cfg, device="cpu"), cfg,
                         FakeTokenizer(),
                         RuntimeConfig(batch_size=4, max_new_tokens=12, **rt),
                         device="cpu")


def _separated(vals):
    gap = np.abs(np.diff(vals))
    sep = np.ones(len(vals), bool)
    sep[1:] &= gap > FTOL
    sep[:-1] &= gap > FTOL
    return sep


TEXT_FIELDS = ("model", "original_main", "response_format",
               "confidence_format", "rephrased_main", "full_rephrased_prompt",
               "full_confidence_prompt", "model_response",
               "model_confidence_response", "confidence_value")


def _compare_rows(jrows, trows):
    assert len(jrows) == len(trows)
    for a, b in zip(jrows, trows):
        for f in TEXT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for f in ("token_1_prob", "token_2_prob"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       atol=FTOL, rtol=0, err_msg=f)
        np.testing.assert_allclose(b.weighted_confidence,
                                   a.weighted_confidence, rtol=FTOL, atol=0)
        la, lb = (json.loads(a.log_probabilities),
                  json.loads(b.log_probabilities))
        va, vb = np.asarray(list(la.values())), np.asarray(list(lb.values()))
        assert len(va) == len(vb) == 20
        np.testing.assert_allclose(vb, va, atol=FTOL, rtol=0)
        sep = _separated(va)
        assert np.asarray(list(la))[sep].tolist() == \
            np.asarray(list(lb))[sep].tolist()


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """The port's sweep of the grid: speculative (default), sequential and
    the legacy loop; each (engine, rows, results path)."""
    tree = jax_run[0]
    out = {}
    for name, rt in (("spec", {}), ("sequential", dict(spec_decode=False)),
                     ("legacy", dict(ragged_scheduler=False))):
        eng = _port_engine(tree, **rt)
        path = tmp_path_factory.mktemp(name) / "results.csv"
        rows = tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                             path, checkpoint_every=5)
        out[name] = (eng, rows, path)
    return out


@pytest.mark.parametrize("route", ["spec", "sequential"])
def test_sweep_rows_match_jax(jax_run, port_runs, route):
    """The ragged sweep plans the JAX sweep's dispatches (a grouped one, a
    cascade one, two without a trunk) and writes its rows, in its order."""
    _, jeng, jrows, _ = jax_run
    eng, trows, path = port_runs[route]
    _compare_rows(jrows, trows)
    assert dataclasses.asdict(eng.occupancy) == \
        dataclasses.asdict(jeng.occupancy)
    assert eng.occupancy.grouped_cells == 4
    casc = eng.cascade_stats
    assert casc["cascade_dispatches"] == 1
    assert casc["dense_fallbacks"] == 2
    if route == "spec":
        assert eng.spec_stats["spec_dispatches"] == 2
        assert "dense_shared_dispatches" not in casc
    else:
        assert casc["dense_shared_dispatches"] == 2
        assert not eng.spec_stats
    assert [r["Rephrased Main Part"] for r in tschemas.read_results(path)] \
        == [r.rephrased_main for r in trows]


def test_legacy_loop_rows_match_jax(jax_run, port_runs):
    """``ragged_scheduler=False`` batches in grid order on the dense shared
    path: every cell's row is the JAX ragged sweep's (matched by cell; the
    padding differs, which the readouts mask out)."""
    _, _, jrows, _ = jax_run
    eng, trows, _ = port_runs["legacy"]
    assert eng.occupancy is None
    assert eng.cascade_stats["dense_shared_dispatches"] == 4
    by_key = {r.rephrased_main: r for r in jrows}
    assert [r.rephrased_main for r in trows] == \
        [c.rephrased_main for c in tgrid.build_grid(MODEL, PROMPTS, PERTS)]
    _compare_rows([by_key[r.rephrased_main] for r in trows], trows)


def test_absent_features_are_absent_and_rows_match(jax_run, port_runs):
    """The JAX sweep's engine features the port has not ported are not
    flags of the port (none can be set and ignored), the sweep's
    parameters are the JAX sweep's (the reasoning mode's included), and
    the port's rows are the JAX sweep's with all of them off. The
    streaming sink, the numerics guard, the prefix cache and piggyback
    chains are ported: their flags default as the JAX package's."""
    fields = {f.name for f in dataclasses.fields(RuntimeConfig)}
    for name in ("lease_shards", "aot_precompile"):
        assert name not in fields
    for name in ("sweep_full_completions", "sweep_group_min_prefix",
                 "sweep_group_min_cells", "streaming_stats",
                 "numerics_guard", "row_artifact", "prefix_cache",
                 "prefix_cache_pages", "prefix_page_size",
                 "piggyback_prefill"):
        assert getattr(RuntimeConfig(), name) == \
            getattr(JaxRuntimeConfig(), name)
    params = inspect.signature(tsweep.run_perturbation_sweep).parameters
    jparams = inspect.signature(jsweep.run_perturbation_sweep).parameters
    assert list(params) == list(jparams)
    for name in ("reasoning", "reasoning_runs", "seed", "checkpoint_every"):
        assert params[name].default == jparams[name].default
    _compare_rows(jax_run[2], port_runs["spec"][1])


def test_artifact_parses_to_the_jax_frame(jax_run, port_runs):
    """The port's CSV, flushed in the same checkpoints, parses under pandas
    to the JAX writer's frame: the same columns and text, floats within
    the tolerances above."""
    a = pd.read_csv(jax_run[3])
    b = pd.read_csv(port_runs["spec"][2])
    assert list(b.columns) == list(jschemas.PERTURBATION_COLUMNS)
    num = ["Token_1_Prob", "Token_2_Prob", "Odds_Ratio",
           "Weighted Confidence"]
    pd.testing.assert_frame_equal(a.drop(columns=num + ["Log Probabilities"]),
                                  b.drop(columns=num + ["Log Probabilities"]))
    np.testing.assert_allclose(b[num].to_numpy(), a[num].to_numpy(),
                               rtol=1e-4, atol=FTOL)


def test_rerun_resumes_and_dispatches_nothing(jax_run, port_runs):
    tree = jax_run[0]
    _, _, path = port_runs["spec"]
    before = path.read_bytes()
    eng = _port_engine(tree)
    assert tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                         path) == []
    assert path.read_bytes() == before
    assert not eng.cascade_stats and not eng.spec_stats
    assert eng.occupancy is None


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_resumes_the_other_packages_artifact(jax_run, port_runs, tmp_path,
                                             resumer):
    """Each package resumes from the other's full manifest + artifact and
    has nothing left to score."""
    src = port_runs["spec"][2] if resumer == "jax" else jax_run[3]
    for suffix in (".csv", ".manifest.jsonl", ".csv.offset"):
        shutil.copy(src.with_name(src.stem + suffix),
                    tmp_path / ("results" + suffix))
    path = tmp_path / "results.csv"
    if resumer == "port":
        eng = _port_engine(jax_run[0])
        assert tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                             path) == []
        assert not eng.cascade_stats
    else:
        assert jsweep.run_perturbation_sweep(jax_run[1], MODEL, JAX_PROMPTS,
                                             PERTS, path) == []
    assert len(pd.read_csv(path)) == N_CELLS


def test_port_resumes_partial_jax_run(jax_run, tmp_path):
    """The JAX run's manifest with only its first 6 rows marked, and no
    artifact: the port scores exactly the other cells (rows as the JAX
    run's, matched by cell) and appends them."""
    _, _, jrows, jpath = jax_run
    done = [l for l in jpath.with_suffix(".manifest.jsonl")
            .read_text().splitlines() if l][:6]
    path = tmp_path / "results.csv"
    path.with_suffix(".manifest.jsonl").write_text("\n".join(done) + "\n")
    eng = _port_engine(jax_run[0])
    rows = tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS, path)
    keys = {json.loads(l)["rephrased_main"] for l in done}
    assert sorted(r.rephrased_main for r in rows) == \
        sorted(r.rephrased_main for r in jrows if r.rephrased_main not in keys)
    by_key = {r.rephrased_main: r for r in jrows}
    _compare_rows([by_key[r.rephrased_main] for r in rows], rows)
    man = JaxManifest(path.with_suffix(".manifest.jsonl"),
                      tgrid.RESUME_KEY_FIELDS)
    assert len(man) == N_CELLS


@pytest.mark.parametrize("every", [1, 5, 100])
def test_checkpoint_flushes(jax_run, tmp_path, monkeypatch, every):
    """A flush after each drained batch once ``checkpoint_every`` rows are
    pending, and one at the end: batches of 4, 4, 4, 3 cells."""
    writes = []
    real = tschemas.write_perturbation_results

    def counting(rows, path, append=True):
        writes.append(len(rows))
        return real(rows, path, append=append)

    monkeypatch.setattr(tsweep.schemas, "write_perturbation_results",
                        counting)
    path = tmp_path / "results.csv"
    rows = tsweep.run_perturbation_sweep(_port_engine(jax_run[0]), MODEL,
                                         PROMPTS, PERTS, path,
                                         checkpoint_every=every)
    assert writes == {1: [4, 4, 3, 4], 5: [8, 7], 100: [15]}[every]
    assert len(rows) == len(tschemas.read_results(path)) == N_CELLS
    assert len(SweepManifest(path.with_suffix(".manifest.jsonl"),
                             tgrid.RESUME_KEY_FIELDS)) == N_CELLS


def test_writer_failure_preserves_resume(jax_run, tmp_path, monkeypatch):
    """A flush failure in the writer thread re-raises on the caller's
    thread, and only rows of SUCCESSFUL flushes are marked done, so a
    resumed sweep scores exactly the unflushed cells (the JAX package's
    tests/test_sweep.py pins the same)."""
    real = tschemas.write_perturbation_results
    calls = {"n": 0}

    def failing(rows, path, append=True):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        return real(rows, path, append=append)

    monkeypatch.setattr(tsweep.schemas, "write_perturbation_results", failing)
    path = tmp_path / "results.csv"
    eng = _port_engine(jax_run[0])
    with pytest.raises(OSError, match="disk full"):
        tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS, path,
                                      checkpoint_every=4)
    # Done records only: the manifest also carries the streaming sink's
    # ``{"__meta__": {"stream_seed": ...}}`` line, as the JAX one does.
    marked = [l for l in path.with_suffix(".manifest.jsonl")
              .read_text().splitlines() if l and "__meta__" not in l]
    assert len(marked) == 4
    assert len(tschemas.read_results(path)) == 4
    monkeypatch.setattr(tsweep.schemas, "write_perturbation_results", real)
    resumed = tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS, path,
                                            checkpoint_every=4)
    assert len(resumed) == N_CELLS - 4
    recs = tschemas.read_results(path)
    assert len(recs) == N_CELLS
    assert len({r["Rephrased Main Part"] for r in recs}) == N_CELLS


# ---------------------------------------------------------------------------
# Confidence parse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,complete", [
    ("85", True), ("85", False), ("about 85 percent", False),
    ("I am 90% sure", True), ("<17> <2>", True), ("<17> <2>", False),
    ("250", True), ("-5 then 40", True), ("no number", True), ("", True),
    ("100", True), ("101 or 7", True), ("0", True), ("3.5", True),
    ("x12y 40", False), ("  60  ", False),
])
def test_parse_confidence_matches_jax(text, complete):
    assert tsweep._parse_confidence(text, complete) == \
        jsweep._parse_confidence(text, complete)


# ---------------------------------------------------------------------------
# The D6 writer, the reader and the manifest against the JAX package's
# ---------------------------------------------------------------------------

def _row(module, i, **kw):
    base = dict(
        model="m", original_main=f"q{i // 2}", response_format="rf",
        confidence_format="cf", rephrased_main=f"r{i}, with \"quotes\"\nand "
        f"a newline", full_rephrased_prompt=f"p{i}",
        full_confidence_prompt=f"c{i}", model_response="Yes",
        model_confidence_response="85", log_probabilities='{"1": -0.5}',
        token_1_prob=0.6 + i * 1e-3, token_2_prob=0.3 / (i + 1),
        confidence_value=85, weighted_confidence=80.0 + i / 7)
    base.update(kw)
    return module.PerturbationRow(**base)


ROW_SETS = {
    "plain": [{}, {}, {}],
    "nulls": [{"confidence_value": None}, {}, {"weighted_confidence": None}],
    "zero_no_prob": [{"token_2_prob": 0.0}, {"token_1_prob": 0.0,
                                              "token_2_prob": 0.0}],
    "tiny_floats": [{"token_1_prob": 1.25e-12}, {"token_2_prob": 7e-300}],
    "no_measurement": [{"token_1_prob": None, "token_2_prob": None,
                        "confidence_value": None,
                        "weighted_confidence": None,
                        "log_probabilities": ""}, {}],
}


@pytest.mark.parametrize("case", sorted(ROW_SETS))
def test_writer_frame_matches_jax(tmp_path, case):
    """The same rows through both writers, in two flushes: pandas reads
    the same frame from either file."""
    kws = ROW_SETS[case]
    for module, name in ((jschemas, "j"), (tschemas, "t")):
        rows = [_row(module, i, **kw) for i, kw in enumerate(kws)]
        module.write_perturbation_results(rows[:1], tmp_path / f"{name}.csv")
        module.write_perturbation_results(rows[1:], tmp_path / f"{name}.csv")
    a, b = pd.read_csv(tmp_path / "j.csv"), pd.read_csv(tmp_path / "t.csv")
    pd.testing.assert_frame_equal(a, b)
    recs = tschemas.read_results(tmp_path / "j.csv")
    assert [r["Rephrased Main Part"] for r in recs] == \
        a["Rephrased Main Part"].tolist()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_writers_append_to_each_other(tmp_path, first):
    mods = (jschemas, tschemas) if first == "jax" else (tschemas, jschemas)
    path = tmp_path / "r.csv"
    for k, module in enumerate(mods):
        module.write_perturbation_results([_row(module, k)], path)
    ref = tmp_path / "ref.csv"
    jschemas.write_perturbation_results([_row(jschemas, 0),
                                         _row(jschemas, 1)], ref)
    pd.testing.assert_frame_equal(pd.read_csv(path), pd.read_csv(ref))


def test_writer_schema_mismatch_backs_up(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("a,b\n1,2\n")
    tschemas.write_perturbation_results([_row(tschemas, 0)], path)
    assert (tmp_path / "r_backup.csv").read_text() == "a,b\n1,2\n"
    assert len(pd.read_csv(path)) == 1
    assert list(pd.read_csv(path).columns) == \
        list(tschemas.PERTURBATION_COLUMNS)


@pytest.mark.parametrize("sidecar", [True, False])
def test_writer_truncates_torn_tail(tmp_path, sidecar):
    """A kill mid-append leaves a torn tail: with the known-good offset it
    is cut at the recorded size (even a tail inside an open quote); a file
    without the sidecar drops a partial last line before its one-time
    validation."""
    path = tmp_path / "r.csv"
    tschemas.write_perturbation_results([_row(tschemas, 0)], path)
    good = path.read_bytes()
    torn = b'm,q9,rf,cf,"torn\n' if sidecar else b"m,q9,rf,cf,torn"
    with path.open("ab") as f:
        f.write(torn)
    if not sidecar:
        path.with_name("r.csv.offset").unlink()
    tschemas.write_perturbation_results([_row(tschemas, 1)], path)
    assert path.read_bytes().startswith(good)
    ref = tmp_path / "ref.csv"
    jschemas.write_perturbation_results([_row(jschemas, 0),
                                         _row(jschemas, 1)], ref)
    pd.testing.assert_frame_equal(pd.read_csv(path), pd.read_csv(ref))


def test_writer_keeps_corrupt_file_and_writes_beside_it(tmp_path):
    """No sidecar and a field left open: the file is kept as it is and
    the new rows go to ``_new``, appended there by the next flush."""
    path = tmp_path / "r.csv"
    tschemas.write_perturbation_results([_row(tschemas, 0)], path)
    path.with_name("r.csv.offset").unlink()
    with path.open("a") as f:
        f.write('m,q9,rf,cf,"open\n')
    damaged = path.read_bytes()
    for i in (1, 2):
        tschemas.write_perturbation_results([_row(tschemas, i)], path)
    assert path.read_bytes() == damaged
    side = pd.read_csv(tmp_path / "r_new.csv")
    assert side["Rephrased Main Part"].tolist() == [
        _row(tschemas, i).rephrased_main for i in (1, 2)]


def test_resolve_results_path_moves_xlsx_to_csv(tmp_path):
    assert tschemas.resolve_results_path(tmp_path / "r.xlsx") == \
        tmp_path / "r.csv"
    assert tschemas.resolve_results_path(tmp_path / "r.csv") == \
        tmp_path / "r.csv"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_format_is_shared(tmp_path, writer):
    """One JSONL format: each package's manifest reads the other's done
    keys and metadata, and skips a torn trailing line."""
    path = tmp_path / "m.jsonl"
    W, R = ((JaxManifest, SweepManifest) if writer == "jax"
            else (SweepManifest, JaxManifest))
    w = W(path, tgrid.RESUME_KEY_FIELDS)
    recs = [{"model": "m", "original_main": f"o{i}",
             "rephrased_main": f"r{i}, \"q\""} for i in range(3)]
    w.mark_done_many(recs)
    w.set_meta("stream_seed", 42)
    with path.open("a") as f:
        f.write('{"model": "m", "original')
    r = R(path, tgrid.RESUME_KEY_FIELDS)
    assert len(r) == 3 and all(r.is_done(x) for x in recs)
    assert r.meta == {"stream_seed": 42}
    r.mark_done({"model": "m", "original_main": "o9", "rephrased_main": "r9"})
    assert len(W(path, tgrid.RESUME_KEY_FIELDS)) == 4


def test_manifest_seeds_from_artifact_like_jax(tmp_path):
    """from_existing_results reads the done keys of a CSV artifact as the
    JAX one does with pandas: rows with more fields than the header are
    skipped, rows with an empty key field do not count."""
    path = tmp_path / "r.csv"
    rows = [_row(tschemas, i) for i in range(3)]
    rows.append(_row(tschemas, 3, rephrased_main=""))
    tschemas.write_perturbation_results(rows, path)
    with path.open("a") as f:
        f.write("m,x,rf,cf,extra," + ",".join(["z"] * 20) + "\n")
    done = []
    for module in (SweepManifest, JaxManifest):
        m = module.from_existing_results(
            tmp_path / f"{module.__module__}.jsonl", path,
            tgrid.RESUME_KEY_FIELDS, column_map=tgrid.RESUME_COLUMN_MAP)
        done.append(sorted(m._done))
    assert done[0] == done[1] and len(done[0]) == 3


def test_odds_ratio_matches_jax():
    for kw in ({}, {"token_2_prob": 0.0}, {"token_1_prob": None}):
        a = _row(jschemas, 0, **kw).odds_ratio
        b = _row(tschemas, 0, **kw).odds_ratio
        assert a == b or (math.isnan(a) and math.isnan(b))


def test_manifest_pending_and_atomic_writes_match_jax(tmp_path):
    from lir_tpu.utils import manifest as jman
    from lir_tpu_torch.utils import manifest as tman

    recs = [{"model": "m", "original_main": "o", "rephrased_main": f"r{i}"}
            for i in range(5)]
    t = SweepManifest(tmp_path / "t.jsonl", tgrid.RESUME_KEY_FIELDS)
    j = JaxManifest(tmp_path / "j.jsonl", tgrid.RESUME_KEY_FIELDS)
    for m in (t, j):
        m.mark_done_many(recs[1:3])
    assert list(t.pending(recs)) == list(j.pending(recs)) == \
        [recs[0], recs[3], recs[4]]
    obj = {"rows": [1, 2.5, None], "text": "é \"q\""}
    tman.atomic_write_json(tmp_path / "t.json", obj)
    jman.atomic_write_json(tmp_path / "j.json", obj)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["j.json", "j.jsonl", "t.json", "t.jsonl"]


# ---------------------------------------------------------------------------
# The sweep with the confidence early stop armed
# ---------------------------------------------------------------------------

def _surface(i):
    """A per-token surface for the stop tables: every fifth id a prefixed
    pure digit run, the next one a bare digit that glues onto it."""
    if i == 0:
        return "<pad>"
    if i % 5 == 0:
        return f"▁{i % 100}"
    if i % 5 == 1:
        return str(i % 10)
    return f"▁t{i}"


class _Surfaces:
    """Per-token strings, so that tokens.digit_stop_classes arms the
    early stop (FakeTokenizer has none)."""

    all_special_ids = [0]

    def convert_ids_to_tokens(self, ids):
        return [_surface(int(i)) for i in ids]


class _JaxStopTokenizer(_Surfaces, JaxFakeTokenizer):
    pass


class _StopTokenizer(_Surfaces, FakeTokenizer):
    pass


STOP_PROMPTS, STOP_PERTS = [PROMPTS[0], PROMPTS[2]], [PERTS[0], PERTS[2]]


@pytest.fixture(scope="module")
def stop_run(jax_run, tmp_path_factory):
    """The JAX sweep of the grouped and the flat prompt (8 cells) with the
    stop tables armed; (JAX engine, rows)."""
    tree, jeng0, _, _ = jax_run
    jeng = JaxEngine(jeng0.params, jeng0.cfg, _JaxStopTokenizer(), jeng0.rt)
    assert jeng.digit_stop_mask is not None
    rows = jsweep.run_perturbation_sweep(
        jeng, MODEL, [JAX_PROMPTS[0], JAX_PROMPTS[2]], STOP_PERTS,
        tmp_path_factory.mktemp("jax_stop") / "results.csv")
    return jeng, rows


def _stop_engine(tree, **rt):
    cfg = ModelConfig(**CFG)
    return ScoringEngine(params_from_jax(tree, cfg, device="cpu"), cfg,
                         _StopTokenizer(),
                         RuntimeConfig(batch_size=4, max_new_tokens=12, **rt),
                         device="cpu")


@pytest.mark.parametrize("route", ["spec", "sequential"])
def test_sweep_with_early_stop_matches_jax(jax_run, stop_run, tmp_path,
                                           route):
    """Grouped rows on per-row stop tables (binary rows EOS-only,
    confidence rows the digit stop), the shared dispatch on the digit
    stop: the same rows, and the same decode-step occupancy from the
    retire positions."""
    jeng, jrows = stop_run
    eng = _stop_engine(jax_run[0], **({} if route == "spec"
                                      else dict(spec_decode=False)))
    assert eng.digit_stop_mask is not None
    np.testing.assert_array_equal(eng.digit_stop_mask.numpy(),
                                  np.asarray(jeng.digit_stop_mask))
    rows = tsweep.run_perturbation_sweep(eng, MODEL, STOP_PROMPTS, STOP_PERTS,
                                         tmp_path / "results.csv")
    _compare_rows(jrows, rows)
    assert dataclasses.asdict(eng.occupancy) == \
        dataclasses.asdict(jeng.occupancy)
    occ = eng.occupancy
    assert occ.grouped_cells == 4
    assert 0 < occ.decode_steps_live < occ.decode_steps_paid


def test_grouped_dispatch_with_early_stop_matches_jax(jax_run, stop_run):
    """ScoringEngine.decode_fused_grouped with ``early_stop`` on both
    packages: the stop_sel layout (odd member rows on the digit table)."""
    from lir_tpu.engine import scheduler as jsched
    from lir_tpu_torch.engine import scheduler as tsched

    from test_torch_scheduler import BINS, CONFS, MAINS, _compare, _groups

    jeng = stop_run[0]
    teng = _stop_engine(jax_run[0])
    t1 = np.full((4,), FakeTokenizer.YES, np.int32)
    t2 = np.full((4,), FakeTokenizer.NO, np.int32)
    outs = []
    for module, eng in ((jsched, jeng), (tsched, teng)):
        groups = _groups(module, eng, MAINS, BINS, CONFS, False)
        outs.append(eng.decode_fused_grouped(groups, t1, t2, 4, 8, True,
                                             bucket=32, sfx_bucket=16)[0])
    _compare(*outs)
    assert bool((outs[1].generated == 0).any())


def test_writer_thread_under_fast_switching(jax_run, port_runs, tmp_path):
    """The writer thread decodes and flushes while the main thread
    tokenizes and dispatches: with the interpreter switching threads
    every microsecond and a flush after every batch, the rows, the
    artifact and the manifest stay whole and in dispatch order."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        path = tmp_path / "results.csv"
        rows = tsweep.run_perturbation_sweep(_port_engine(jax_run[0]), MODEL,
                                             PROMPTS, PERTS, path,
                                             checkpoint_every=1)
    finally:
        sys.setswitchinterval(old)
    ref = port_runs["spec"][1]
    assert [r.rephrased_main for r in rows] == \
        [r.rephrased_main for r in ref]
    assert [r["Rephrased Main Part"] for r in tschemas.read_results(path)] \
        == [r.rephrased_main for r in ref]
    assert len(SweepManifest(path.with_suffix(".manifest.jsonl"),
                             tgrid.RESUME_KEY_FIELDS)) == N_CELLS
