"""The port's streaming-statistics sink and the sweep's numerics guard
against the JAX package's.

- ``stream_fold_plain`` (the CPU twin of ``csrc/stream_fold.cu``) against
  JAX's ``fold_update`` on the same rows, pad rows, guard-invalid rows,
  zero-mass rows and strided inputs, guard on and off: every lattice
  entry bitwise (``filled`` and ``dec`` exact; ``rel`` and ``conf``
  bitwise as float32 bits: both compute one correctly rounded float32
  add and division).
- ``test_torch_sweep``'s 15-cell grid swept by both packages with their
  sinks on (the JAX engine as ``test_torch_sweep``'s, the sink and the
  guard at their defaults): counts, decisions and kappa exact, moments
  within
  ``stats.streaming.FLOAT_TOL`` (the readouts themselves differ by up to
  1e-5, ``test_torch_sweep``'s FTOL).
- Fault C3 (ROADMAP §C), repaired: one readout poisoned with NaN in both
  packages is quarantined identically in both D6 artifacts and is NaN in
  both lattices.
- Streaming against the CSV reload inside the port, kill and resume,
  the streaming-only mode, the manifest's seed, and each package reading
  the other's ``.accum.npz``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data import schemas as jschemas
from lir_tpu.engine import score as jscore
from lir_tpu.engine import stream_stats as jss
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu.stats import streaming as jstream
from lir_tpu_torch import ops
from lir_tpu_torch.data import schemas as tschemas
from lir_tpu_torch.engine import grid as tgrid
from lir_tpu_torch.engine import score as tscore
from lir_tpu_torch.engine import stream_stats as tss
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.guard import numerics
from lir_tpu_torch.ops.stream_fold import stream_fold_plain
from lir_tpu_torch.stats import streaming as tstream
from lir_tpu_torch.utils.manifest import SweepManifest

from test_torch_sweep import (CFG, JAX_PROMPTS, MODEL, N_CELLS, PERTS,
                              PROMPTS, _port_engine, _tree)

N_REPH = 1 + max(len(p) for p in PERTS)
POISON_ROW = 1        # row of the first dispatch whose P(yes) is NaN


# ---------------------------------------------------------------------------
# The fold against JAX's fold_update
# ---------------------------------------------------------------------------

def _fold_rows(seed, B=24, K=20, R=7):
    """Readouts with every predicate branch: valid, pad rows (ridx = R),
    NaN / negative / > 1 probabilities, a sum over 1, zero mass, a
    confidence out of range, NaN and positive log-probs, exact ties."""
    rng = np.random.default_rng(seed)
    yes = rng.uniform(0, 0.7, B).astype(np.float32)
    no = (rng.uniform(0, 1, B) * (1 - yes)).astype(np.float32)
    wc = rng.uniform(0, 100, B).astype(np.float32)
    lp = -rng.exponential(2.0, (B, K)).astype(np.float32)
    yes[1], no[2], yes[3] = np.nan, -0.01, 1.2
    yes[4], no[4] = 0.7, 0.4
    yes[5] = no[5] = 0.0
    wc[6], wc[7] = 100.5, np.nan
    lp[8, 3], lp[9, 0] = np.nan, 0.5
    yes[10] = no[10] = 0.25
    yes[11], no[11] = -5e-5, 1.00005     # inside the slop: valid
    ridx = np.arange(B, dtype=np.int32) % R
    pidx = (np.arange(B, dtype=np.int32) // R) % 3
    ridx[-3:] = R                        # pad rows
    pidx[-1] = 3                         # a prompt past the lattice
    return yes, no, wc, lp, pidx, ridx.astype(np.int32)


def _jax_fold(P, R, rows, guard, prior=None):
    acc = jss.new_accum(P, R) if prior is None else {
        k: jnp.asarray(v) for k, v in prior.items()}
    yes, no, wc, lp, pidx, ridx = rows
    out = jss.fold_update(acc, jnp.asarray(yes), jnp.asarray(no),
                          jnp.asarray(wc), jnp.asarray(lp),
                          jnp.asarray(pidx), jnp.asarray(ridx), guard=guard)
    return {k: np.asarray(v) for k, v in out.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("strided", [False, True])
def test_fold_plain_bitwise_jax_fold_update(guard, strided):
    """Two folds into one lattice (the second over other rows, part of
    them refolding the first's slots): every entry bitwise JAX's."""
    P, R = 4, 7
    acc = tss.new_accum(P, R, device="cpu")
    ref = None
    for seed in (0, 1):
        rows = _fold_rows(seed, R=R)
        yes, no, wc, lp, pidx, ridx = (torch.from_numpy(a.copy())
                                       for a in rows)
        if strided:                      # the grouped branch's row views
            yes, no, wc = (torch.stack([t, t], 1)[:, 0] for t in (yes, no, wc))
            lp = torch.stack([lp, lp], 1)[:, 0]
            assert not yes.is_contiguous()
        before = ops.stream_fold.launches
        tss.fold_update(acc, yes, no, wc, lp, pidx, ridx, guard=guard)
        assert ops.stream_fold.launches == before   # CPU: the plain twin
        ref = _jax_fold(P, R, rows, guard, prior=ref)
    for name in ("filled", "rel", "conf", "dec"):
        np.testing.assert_array_equal(_bits(acc[name].numpy()),
                                      _bits(ref[name]), err_msg=name)
    assert int(acc["filled"].sum()) == 21        # 3 pad rows dropped


def test_fold_twin_is_stream_fold_on_cpu_and_idempotent():
    rows = [torch.from_numpy(a) for a in _fold_rows(3)]
    a = tss.new_accum(4, 7, device="cpu")
    b = tss.new_accum(4, 7, device="cpu")
    ops.stream_fold(a, *rows)
    stream_fold_plain(b, *rows)
    snap = {k: v.clone() for k, v in a.items()}
    ops.stream_fold(a, *rows)
    for k in a:
        assert torch.equal(_as_bits(a[k]), _as_bits(b[k]))
        assert torch.equal(_as_bits(a[k]), _as_bits(snap[k]))


def _as_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_sink_fold_drops_pad_rows_and_counts():
    sink = tss.StreamSink(1, 4, seed=0, device="cpu")

    @dataclasses.dataclass
    class Cell:
        prompt_idx: int = 0
        rephrase_idx: int = 2

    yes = torch.tensor([0.8, 999.0])          # row 1 is padding
    no = torch.tensor([0.1, 999.0])
    wc = torch.tensor([50.0, -5.0])
    lp = torch.full((2, 20), -1.0)
    sink.fold(yes, no, wc, lp, [Cell()])
    acc = sink.snapshot()
    assert acc.rows_folded == 1
    assert acc.filled[0, 2] == 1 and acc.dec[0, 2] == 1
    sink.fold(yes, no, wc, lp, [Cell()])
    again = sink.snapshot()
    np.testing.assert_array_equal(acc.rel, again.rel)
    assert sink.stats.summary()["dispatch_folds"] == 2
    assert sink.stats.summary()["rows_folded"] == 2
    assert sink.stats.summary()["accum_bytes"] == 16 * 4


def test_wrapper_refuses_bad_inputs_and_non_cuda_lattices():
    acc = {k: v.to("meta") for k, v in tss.new_accum(2, 3, "cpu").items()}
    z = torch.zeros(2, device="meta")
    i = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.stream_fold(acc, z, z, z, torch.zeros((2, 20), device="meta"),
                        i, i)


# ---------------------------------------------------------------------------
# The sweep with the sink: both packages on test_torch_sweep's grid
# ---------------------------------------------------------------------------

def _jax_engine(tree):
    cfg_j = JaxModelConfig(**CFG)
    return JaxEngine(
        jax.tree.map(jnp.asarray, tree), cfg_j, JaxFakeTokenizer(),
        JaxRuntimeConfig(batch_size=4, max_new_tokens=12, spec_decode=False,
                         piggyback_prefill=False, prefix_cache=False,
                         aot_precompile=False))


def _poison(module):
    """readout_from_fused with P(yes) of POISON_ROW of the FIRST dispatch
    set to NaN (the stand-in for a corrupt kernel or card)."""
    real = module.readout_from_fused
    calls = {"n": 0}

    def poisoned(fused, *args, **kw):
        res = real(fused, *args, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            if isinstance(res.yes_prob, torch.Tensor):
                y = res.yes_prob.clone()
                y[POISON_ROW] = float("nan")
            else:
                y = res.yes_prob.at[POISON_ROW].set(jnp.nan)
            res = dataclasses.replace(res, yes_prob=y)
        return res

    return poisoned


@pytest.fixture(scope="module")
def tree():
    return _tree()[1]


@pytest.fixture(scope="module")
def interpret():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


@pytest.fixture(scope="module")
def runs(tree, interpret, tmp_path_factory):
    """Both packages' sweeps of the grid with their sinks on, clean and
    with one poisoned readout: {(package, poisoned): (rows, lattice,
    results path, engine)}."""
    out = {}
    for poisoned in (False, True):
        mp = pytest.MonkeyPatch()
        if poisoned:
            mp.setattr(jsweep.score_mod, "readout_from_fused",
                       _poison(jscore))
            mp.setattr(tsweep.score_mod, "readout_from_fused",
                       _poison(tscore))
        try:
            jeng = _jax_engine(tree)
            jpath = tmp_path_factory.mktemp("jax") / "results.csv"
            jrows = jsweep.run_perturbation_sweep(
                jeng, MODEL, JAX_PROMPTS, PERTS, jpath, checkpoint_every=5)
            out["jax", poisoned] = (jrows, jeng.stream_sink.snapshot(),
                                    jpath, jeng)
            teng = _port_engine(tree)
            tpath = tmp_path_factory.mktemp("port") / "results.csv"
            trows = tsweep.run_perturbation_sweep(
                teng, MODEL, PROMPTS, PERTS, tpath, checkpoint_every=5)
            out["port", poisoned] = (trows, teng.stream_sink.snapshot(),
                                     tpath, teng)
        finally:
            mp.undo()
    return out


def _slot_map():
    return tstream.slot_map_from_cells(tgrid.build_grid(MODEL, PROMPTS, PERTS))


def _jax_accum(acc):
    return jstream.HostAccum(filled=acc.filled, rel=acc.rel, conf=acc.conf,
                             dec=acc.dec, seed=acc.seed)


@pytest.mark.parametrize("poisoned", [False, True])
def test_sweep_lattice_matches_jax_sweep(runs, poisoned):
    _, jacc, _, _ = runs["jax", poisoned]
    trows, tacc, _, teng = runs["port", poisoned]
    assert tacc.rows_folded == jacc.rows_folded == N_CELLS
    assert tacc.seed == jacc.seed == 42
    np.testing.assert_array_equal(tacc.filled, jacc.filled)
    np.testing.assert_array_equal(tacc.dec, jacc.dec)
    np.testing.assert_array_equal(np.isnan(tacc.rel), np.isnan(jacc.rel))
    tsum = tstream.summarize(tacc, n_boot=0, device="cpu")
    jsum = jstream.summarize(_jax_accum(jacc), n_boot=0)
    tstream.assert_parity(tsum, jsum)
    assert tsum["kappa"] == jsum["kappa"]
    stats = teng.stream_sink.stats.summary()
    assert stats["rows_folded"] == N_CELLS
    # One fold a dispatch: the grouped, cascade and two no-trunk ones.
    assert stats["dispatch_folds"] == 4
    assert stats["checkpoints"] == 2            # the flushes of 8 and 7
    assert len(trows) == N_CELLS


def test_c3_poisoned_readout_quarantined_as_in_jax(runs):
    """Fault C3: the port's sweep wrote a NaN readout as a plausible row.
    Now the poisoned cell is the JAX package's quarantined row, field for
    field, in the rows returned and in the CSV on disk; the guard counts
    it; both lattices hold it as NaN / invalid; its neighbours are the
    clean run's."""
    jrows, jacc, jpath, jeng = runs["jax", True]
    trows, tacc, tpath, teng = runs["port", True]
    jbad = [r for r in jrows if r.model_response == numerics.NUMERICS_ERROR]
    tbad = [r for r in trows if r.model_response == numerics.NUMERICS_ERROR]
    assert len(jbad) == len(tbad) == 1
    assert dataclasses.asdict(tbad[0]) == dataclasses.asdict(jbad[0])
    assert "P(yes) not finite" in tbad[0].model_confidence_response
    assert [r.rephrased_main for r in trows] == [r.rephrased_main
                                                 for r in jrows]
    jcsv = jschemas.read_results_frame(jpath)
    tcsv = tschemas.read_results(tpath)
    i = [r["Rephrased Main Part"] for r in tcsv].index(tbad[0].rephrased_main)
    for col in ("Model Response", "Model Confidence Response",
                "Log Probabilities", "Token_1_Prob", "Token_2_Prob",
                "Confidence Value", "Weighted Confidence", "Odds_Ratio"):
        j = jcsv[col].iloc[i]
        assert tcsv[i][col] == ("" if isinstance(j, float) and math.isnan(j)
                                else str(j)), col
    assert teng.guard_stats.quarantined == {"sweep": 1}
    assert teng.guard_stats.checked == {"sweep": N_CELLS}
    p, r = _slot_map()[(tbad[0].original_main, tbad[0].rephrased_main)]
    assert math.isnan(tacc.rel[p, r]) and math.isnan(jacc.rel[p, r])
    assert tacc.dec[p, r] == jacc.dec[p, r] == -1
    assert tacc.filled[p, r] == 1
    clean = {r.rephrased_main: r for r in runs["port", False][0]}
    for row in trows:
        if row is not tbad[0]:
            assert row == clean[row.rephrased_main]


def test_guard_off_writes_the_poisoned_row_verbatim(tree, interpret,
                                                    tmp_path, monkeypatch):
    """``numerics_guard=False`` (``--no-numerics-guard``): the NaN lands in
    the row, as in the JAX package, and the fold accepts the row (its
    relative probability NaN from the NaN readout, its decision -1)."""
    monkeypatch.setattr(tsweep.score_mod, "readout_from_fused",
                        _poison(tscore))
    eng = _port_engine(tree, numerics_guard=False)
    rows = tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                         tmp_path / "r.csv")
    assert not any(r.model_response == numerics.NUMERICS_ERROR for r in rows)
    assert sum(math.isnan(r.token_1_prob) for r in rows) == 1
    assert not eng.guard_stats.checked
    acc = eng.stream_sink.snapshot()
    assert int(np.isfinite(acc.conf).sum()) == N_CELLS


def test_streaming_matches_csv_reload_in_the_port(runs):
    _, acc, path, _ = runs["port", True]
    streamed = tstream.summarize(acc, n_boot=200, device="cpu")
    reload = tstream.accum_from_rows(tschemas.read_results(path), _slot_map(),
                                     len(PROMPTS), N_REPH, acc.seed)
    tstream.assert_parity(streamed, tstream.summarize(reload, n_boot=200,
                                                      device="cpu"))
    np.testing.assert_array_equal(acc.dec, reload.dec)
    np.testing.assert_array_equal(acc.filled, reload.filled)


def test_accumulator_files_cross_packages(runs, tmp_path):
    """The port's ``.accum.npz`` loads in the JAX package and the JAX
    package's in the port; each package's finalize over the other's file
    equals the writer's own, bitwise on counts and kappa."""
    for writer, reader_load, reader_sum, own_sum in (
            ("port", jss.load_accum, jstream.summarize,
             lambda a: tstream.summarize(a, n_boot=0, device="cpu")),
            ("jax", tss.load_accum,
             lambda a: tstream.summarize(a, n_boot=0, device="cpu"),
             lambda a: jstream.summarize(_jax_accum(a), n_boot=0))):
        _, acc, path, _ = runs[writer, False]
        loaded = reader_load(path.with_suffix(tss.ACCUM_SUFFIX))
        for name in ("filled", "rel", "conf", "dec"):
            np.testing.assert_array_equal(_bits(getattr(loaded, name)),
                                          _bits(getattr(acc, name)))
        assert loaded.seed == acc.seed
        got, ref = reader_sum(loaded), own_sum(acc)
        assert got["kappa"] == ref["kappa"]
        for g, r in zip(got["per_prompt"], ref["per_prompt"]):
            for k in ("n_folded", "n_valid", "n_yes", "n_no"):
                assert g[k] == r[k]
    assert jss.ACCUM_SUFFIX == tss.ACCUM_SUFFIX


def test_port_resumes_the_jax_run_with_its_accumulator(runs, tree,
                                                       tmp_path):
    """The JAX run's CSV, manifest and accumulator: the port has nothing
    left to score, keeps the recorded seed, and its sink holds the JAX
    lattice."""
    _, jacc, jpath, _ = runs["jax", False]
    for suffix in (".csv", ".manifest.jsonl", ".csv.offset", ".accum.npz"):
        shutil.copy(jpath.with_name(jpath.stem + suffix),
                    tmp_path / ("results" + suffix))
    eng = _port_engine(tree)
    assert tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                         tmp_path / "results.csv") == []
    acc = eng.stream_sink.snapshot()
    for name in ("filled", "rel", "conf", "dec"):
        np.testing.assert_array_equal(_bits(getattr(acc, name)),
                                      _bits(getattr(jacc, name)))
    assert eng.stream_sink.stats.summary()["dispatch_folds"] == 0


class _Killed(BaseException):
    """Stands in for a kill between the lattice checkpoint and the row
    append of one flush."""


def test_kill_between_checkpoint_and_append_resumes_bitwise(tree, interpret,
                                                           tmp_path,
                                                           monkeypatch):
    clean = tmp_path / "clean.csv"
    tsweep.run_perturbation_sweep(_port_engine(tree), MODEL, PROMPTS, PERTS,
                                  clean, checkpoint_every=4)
    clean_acc = tss.load_accum(clean.with_suffix(tss.ACCUM_SUFFIX))

    real = tschemas.write_perturbation_results
    calls = {"n": 0}

    def killed_on_second(rows, path, append=True):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Killed()
        return real(rows, path, append=append)

    monkeypatch.setattr(tsweep.schemas, "write_perturbation_results",
                        killed_on_second)
    path = tmp_path / "killed.csv"
    with pytest.raises(_Killed):
        tsweep.run_perturbation_sweep(_port_engine(tree), MODEL, PROMPTS,
                                      PERTS, path, checkpoint_every=4)
    partial = tss.load_accum(path.with_suffix(tss.ACCUM_SUFFIX))
    marked = SweepManifest(path.with_suffix(".manifest.jsonl"),
                           tgrid.RESUME_KEY_FIELDS)
    # The checkpoint of the killed flush was written: a superset of the
    # four rows marked done.
    assert len(marked) == 4 and partial.rows_folded >= 8
    monkeypatch.setattr(tsweep.schemas, "write_perturbation_results", real)
    eng = _port_engine(tree)
    resumed = tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS, path,
                                            checkpoint_every=4)
    assert len(resumed) == N_CELLS - 4
    acc = tss.load_accum(path.with_suffix(tss.ACCUM_SUFFIX))
    assert acc.rows_folded == N_CELLS
    for name in ("filled", "rel", "conf", "dec"):
        np.testing.assert_array_equal(_bits(getattr(acc, name)),
                                      _bits(getattr(clean_acc, name)))
    assert acc.seed == clean_acc.seed


def test_streaming_only_mode_writes_no_rows_and_marks_the_manifest(
        tree, interpret, tmp_path, runs):
    """``row_artifact=False`` (``--no-row-artifact``): no rows, no CSV,
    every cell marked done after a lattice checkpoint, the payload bytes
    counted as avoided, and the lattice the row-writing run's, bitwise;
    a re-run dispatches nothing."""
    path = tmp_path / "r.csv"
    eng = _port_engine(tree, row_artifact=False)
    assert tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS, path,
                                         checkpoint_every=5) == []
    assert not path.exists()
    stats = eng.stream_sink.stats.summary()
    assert stats["rows_folded"] == N_CELLS and stats["host_bytes_avoided"] > 0
    man = SweepManifest(path.with_suffix(".manifest.jsonl"),
                        tgrid.RESUME_KEY_FIELDS)
    assert len(man) == N_CELLS and man.meta["stream_seed"] == 42
    acc = tss.load_accum(path.with_suffix(tss.ACCUM_SUFFIX))
    ref = runs["port", False][1]
    for name in ("filled", "rel", "conf", "dec"):
        np.testing.assert_array_equal(_bits(getattr(acc, name)),
                                      _bits(getattr(ref, name)))
    again = _port_engine(tree, row_artifact=False)
    assert tsweep.run_perturbation_sweep(again, MODEL, PROMPTS, PERTS,
                                         path) == []
    assert again.stream_sink.stats.summary()["dispatch_folds"] == 0
    assert again.stream_sink.snapshot().rows_folded == N_CELLS


def test_stream_seed_recorded_and_cis_reproducible(tree, interpret,
                                                   tmp_path):
    """The bootstrap seed rides the manifest: a ``--no-streaming-stats``
    re-run analysed from its CSV with the recorded seed gives the same
    CIs (within FLOAT_TOL of the float32 lattice), and the legacy loop
    folds its tail's pad rows to nothing."""
    eng = _port_engine(tree)
    tsweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                  tmp_path / "on.csv", seed=1234)
    man = SweepManifest(tmp_path / "on.manifest.jsonl",
                        tgrid.RESUME_KEY_FIELDS)
    assert man.meta["stream_seed"] == 1234
    streamed = eng.stream_sink.finalize(n_boot=200)
    assert streamed["seed"] == 1234

    off = _port_engine(tree, streaming_stats=False)
    tsweep.run_perturbation_sweep(off, MODEL, PROMPTS, PERTS,
                                  tmp_path / "off.csv", seed=1234)
    assert off.stream_sink is None
    assert not (tmp_path / "off.accum.npz").exists()
    replay = tstream.summarize(tstream.accum_from_rows(
        tschemas.read_results(tmp_path / "off.csv"), _slot_map(),
        len(PROMPTS), N_REPH, man.meta["stream_seed"]), n_boot=200,
        device="cpu")
    tstream.assert_parity(streamed, replay)

    legacy = _port_engine(tree, ragged_scheduler=False)
    tsweep.run_perturbation_sweep(legacy, MODEL, PROMPTS, PERTS,
                                  tmp_path / "legacy.csv")
    acc = legacy.stream_sink.snapshot()
    ragged = eng.stream_sink.snapshot()
    assert acc.rows_folded == N_CELLS
    np.testing.assert_array_equal(acc.dec, ragged.dec)
    tstream.assert_parity(tstream.summarize(acc, n_boot=0, device="cpu"),
                          tstream.summarize(ragged, n_boot=0, device="cpu"))


def test_log_line_and_finalize_counters(runs):
    _, _, _, teng = runs["port", False]
    sink = teng.stream_sink
    out = sink.finalize(n_boot=0)
    assert out["rows_folded"] == N_CELLS
    assert sink.stats.summary()["finalize_s"] >= 0
    json.dumps(sink.stats.summary())
