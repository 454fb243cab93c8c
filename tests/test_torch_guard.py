"""The perturbation sweep's dispatch recovery against its own clean run and
the JAX sweep's (CPU, a tiny decoder, a 12-cell grid).

One module-scoped JAX sweep (interpreter hooks armed) runs under a fault
plan that fails dispatch calls 0 and 2: its rows are JAX's clean rows
(JAX's own recovery test) and its ``recovered_dispatches`` are the count
the port must match under the same plan. The port's clean sweep is held
to those rows under the parity bar; every faulted port sweep is held to
the port's clean rows BITWISE, except where the fault quarantines rows:

- injected dispatch faults, recovered after ``reset_dispatch_state``;
- a hang (three times the calibrated deadline, at least 0.5 s),
  counted in ``stalls``;
- a real slow dispatch past its deadline on a prefix-cache engine,
  which its retry waits out (never two dispatches in the engine) or,
  with a short grace, which poisons the engine;
- NaN rows, quarantined exactly, their neighbours bitwise;
- an out-of-memory error, as an error text and as a
  ``torch.cuda.OutOfMemoryError``, reclaimed by the governor and retried
  once; a second one raises ``HbmExhausted``;
- an ``hbm_squeeze`` through ``wrap_governor``, whose rungs walk as the
  JAX governor's do under the same squeeze;
- a ``draft_corrupt``, whose speculative rows equal the clean rows;
- an ``InjectedPreemption`` at a checkpoint, a torn manifest tail, and a
  resume that ends equal to the uninterrupted run.

Each dispatch ticks the governor once (the engine's tick; the recovery
adds none). No wall-clock bar: counters and rows only.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu import faults as jfaults
from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import GovernorConfig as JaxGovernorConfig
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch import faults
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import GovernorConfig, RuntimeConfig
from lir_tpu_torch.data import LegalPrompt, schemas
from lir_tpu_torch.engine import grid as tgrid
from lir_tpu_torch.engine import hbm
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.utils.manifest import SweepManifest

from test_torch_sweep import _compare_rows

CFG = dict(name="guard-tiny", vocab_size=FakeTokenizer.VOCAB, hidden_size=32,
           n_layers=1, n_heads=2, n_kv_heads=2, intermediate_size=64,
           max_seq_len=128)
WEIGHT_SCALE = 4.0
MODEL = "g"
RT = dict(batch_size=2, max_seq_len=128, piggyback_prefill=False,
          spec_decode=False)
PLAN = dict(fail_calls=(0, 2))


def _grid():
    rng = np.random.default_rng(3)
    words = "coverage policy flood water damage claim insurer".split()

    def text():
        return " ".join(rng.choice(words) for _ in range(8)) + " ?"

    lp = LegalPrompt(main=text(), response_format="Answer Yes or No .",
                     target_tokens=("Yes", "No"),
                     confidence_format="Number from 0 to 100 .")
    return [lp], [[text() for _ in range(11)]]


PROMPTS, PERTS = _grid()
N_CELLS = 12


def _tree():
    cfg_j = JaxModelConfig(**CFG)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(1), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    return cfg_j, tree


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(tree, JAX engine, JAX rows under the fault plan, its plan)."""
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    cfg_j, tree = _tree()
    jeng = JaxEngine(
        jax.tree.map(jnp.asarray, tree), cfg_j, JaxFakeTokenizer(),
        JaxRuntimeConfig(aot_precompile=False, streaming_stats=False,
                         prefix_cache=False, **RT),
        governor_config=JaxGovernorConfig(sustain_ticks=1))
    plan = jfaults.FaultPlan(0, {"dispatch": jfaults.SiteSchedule(**PLAN),
                                 "hbm": jfaults.SiteSchedule.hbm_squeeze_at(
                                     1, frac=0.5, calls=2)})
    jfaults.wrap_engine(jeng, plan)
    jfaults.wrap_governor(jeng.governor, plan)
    jprompts = [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                               target_tokens=p.target_tokens,
                               confidence_format=p.confidence_format)
                for p in PROMPTS]
    rows = jsweep.run_perturbation_sweep(
        jeng, MODEL, jprompts, PERTS,
        tmp_path_factory.mktemp("jax") / "results.csv", checkpoint_every=100)
    assert len(rows) == N_CELLS
    yield tree, jeng, rows, plan
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _engine(tree, gov=None, **rt):
    cfg = ModelConfig(**CFG)
    return ScoringEngine(params_from_jax(tree, cfg, device="cpu"), cfg,
                         FakeTokenizer(), RuntimeConfig(**{**RT, **rt}),
                         device="cpu", governor_config=gov)


def _sweep(engine, path, **kw):
    return tsweep.run_perturbation_sweep(engine, MODEL, PROMPTS, PERTS, path,
                                         checkpoint_every=100, **kw)


def _count_ticks(engine):
    box = {"n": 0}
    inner = engine.governor.tick

    def tick():
        box["n"] += 1
        inner()

    engine.governor.tick = tick
    return box


def _bitwise(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.fixture(scope="module")
def clean(jax_run, tmp_path_factory):
    """The port's clean sweep: (rows, planned dispatches, ticks)."""
    eng = _engine(jax_run[0])
    ticks = _count_ticks(eng)
    rows = _sweep(eng, tmp_path_factory.mktemp("clean") / "r.csv")
    n_disp = len(tsweep._plan_ragged(eng, tgrid.build_grid(
        MODEL, PROMPTS, PERTS), 4, 8)[0])
    return rows, n_disp, ticks["n"]


def test_clean_rows_match_jax_and_tick_once_a_dispatch(jax_run, clean):
    rows, n_disp, ticks = clean
    _compare_rows(jax_run[2], rows)
    assert ticks == n_disp


def test_dispatch_faults_recover_like_jax(jax_run, clean, tmp_path):
    eng = _engine(jax_run[0])
    ticks = _count_ticks(eng)
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule(**PLAN)})
    faults.wrap_engine(eng, plan)
    rows = _sweep(eng, tmp_path / "r.csv")
    assert all(_bitwise(a, b) for a, b in zip(rows, clean[0]))
    assert len(rows) == N_CELLS
    assert plan.stats.injected == {"dispatch": 2}
    assert eng.fault_stats.recovered_dispatches == \
        jax_run[1].fault_stats.recovered_dispatches == 2
    assert ticks["n"] == clean[1]     # a failed attempt never ticked


def test_hang_is_stalled_by_the_watchdog_and_recovered(jax_run, clean,
                                                       tmp_path):
    eng = _engine(jax_run[0], watchdog_multiple=2.0, watchdog_floor_s=0.05)
    # Two clean sweeps calibrate the watchdog past its cold first sample
    # (inflated by the seed headroom). The hang then lasts three times
    # the largest deadline of the grid's dispatches, and at least 0.5 s.
    for k in range(2):
        _sweep(eng, tmp_path / f"warm{k}.csv")
    costs = tsweep_costs(eng)
    hang_s = max(0.5, 3 * max(eng.watchdog.deadline_for(c) for c in costs))
    stalls0 = eng.guard_stats.stalls.get("sweep", 0)
    recovered0 = eng.fault_stats.recovered_dispatches
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.hang_at(
        1, seconds=hang_s)})
    faults.wrap_engine(eng, plan)
    rows = _sweep(eng, tmp_path / "r.csv")
    assert all(_bitwise(a, b) for a, b in zip(rows, clean[0]))
    # The hang's stall and its recovery (a loaded host may add a stall
    # of a slow clean dispatch; its rows are the same).
    assert eng.guard_stats.stalls["sweep"] - stalls0 >= 1
    assert eng.fault_stats.recovered_dispatches - recovered0 >= 1
    assert plan.stats.injected == {"dispatch": 1}
    deadline, fired = eng.watchdog.last_stall
    assert fired >= deadline and deadline < hang_s


def _slow_at(engine, call, seconds):
    """``decode_fused_shared`` sleeping ``seconds`` (not woken by the
    watchdog) before its real call ``call``; returns the most calls
    seen inside at once and the event set when the slow one has left."""
    import threading

    inner = engine.decode_fused_shared
    lock = threading.Lock()
    box = {"n": 0, "inside": 0, "most": 0}
    left = threading.Event()

    def wrapped(*a, **kw):
        with lock:
            k = box["n"]
            box["n"] += 1
            box["inside"] += 1
            box["most"] = max(box["most"], box["inside"])
        try:
            if k == call:
                time.sleep(seconds)
            return inner(*a, **kw)
        finally:
            with lock:
                box["inside"] -= 1
            if k == call:
                left.set()

    engine.decode_fused_shared = wrapped
    return box, left


@pytest.mark.parametrize("grace_s", [60.0, 0.05],
                         ids=["waited-out", "poisoned"])
def test_a_slow_dispatch_past_its_deadline_never_runs_beside_its_retry(
        jax_run, tmp_path, grace_s):
    """A real dispatch on a prefix-cache engine that passes its deadline
    keeps running on its abandoned worker (the pages it inserts, the
    carry it may park). Its retry waits for it, so no two dispatches
    are ever inside the engine at once, and the rows hold JAX's under
    the parity bar; with a short grace the sweep raises EnginePoisoned
    instead of dispatching beside it."""
    from lir_tpu_torch.guard.watchdog import EnginePoisoned

    eng = _engine(jax_run[0], watchdog_multiple=2.0, watchdog_floor_s=0.05,
                  prefix_cache=True)
    assert eng.prefix_cache is not None
    for k in range(2):
        _sweep(eng, tmp_path / f"warm{k}.csv")
    slow_s = max(0.5, 3 * max(eng.watchdog.deadline_for(c)
                              for c in tsweep_costs(eng)))
    eng.watchdog.grace_s = grace_s
    stalls0 = eng.guard_stats.stalls.get("sweep", 0)
    box, left = _slow_at(eng, 1, slow_s)
    if grace_s < slow_s:
        with pytest.raises(EnginePoisoned):
            _sweep(eng, tmp_path / "r.csv")
        assert eng.guard_stats.poisoned >= 1
        assert left.wait(60)
    else:
        rows = _sweep(eng, tmp_path / "r.csv")
        _compare_rows(jax_run[2], rows)
        assert eng.fault_stats.recovered_dispatches >= 1
        assert eng.guard_stats.poisoned == 0
    assert eng.guard_stats.stalls["sweep"] - stalls0 >= 1
    assert box["most"] == 1


def tsweep_costs(engine):
    """The watchdog's price of each planned dispatch of the grid (the
    sweep's rule for shared dispatches without a trunk)."""
    from lir_tpu_torch.engine import scheduler as sched

    rt = engine.rt
    dispatches = tsweep._plan_ragged(
        engine, tgrid.build_grid(MODEL, PROMPTS, PERTS),
        rt.sweep_decode_tokens, rt.sweep_confidence_tokens)[0]
    return [sched.bucket_cost(
        (2 if d.kind == "grouped" else 1) * len(d.items), d.bucket,
        rt.batch_size, rt.sweep_decode_tokens + rt.sweep_confidence_tokens,
        fused_decode=rt.fused_decode, spec_decode=engine.spec_supported())
        for d in dispatches]


def test_nan_rows_are_quarantined_exactly(jax_run, clean, tmp_path):
    eng = _engine(jax_run[0])
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.nan_at(
        1, rows=(1,))})
    faults.wrap_engine(eng, plan)
    rows = _sweep(eng, tmp_path / "r.csv")
    bad = [i for i, (a, b) in enumerate(zip(rows, clean[0]))
           if not _bitwise(a, b)]
    assert len(bad) == 1
    assert rows[bad[0]].model_response == "error:numerics"
    assert rows[bad[0]].token_1_prob is None
    assert rows[bad[0]].rephrased_main == clean[0][bad[0]].rephrased_main
    assert eng.guard_stats.quarantined == {"sweep": 1}


def _oom_wrap(engine, errors):
    """``decode_fused_shared`` raising errors[k] on its k-th call (None:
    the real call)."""
    inner = engine.decode_fused_shared
    calls = {"n": 0}

    def wrapped(*a, **kw):
        k = calls["n"]
        calls["n"] += 1
        if k < len(errors) and errors[k] is not None:
            raise errors[k]
        return inner(*a, **kw)

    engine.decode_fused_shared = wrapped


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4 GiB"),
], ids=["text", "instance"])
def test_oom_is_reclaimed_and_retried_once(jax_run, clean, tmp_path, error):
    eng = _engine(jax_run[0])
    freed = []
    eng.governor.set_action("evict_weights",
                            engage=lambda: freed.append(1) or True)
    _oom_wrap(eng, [None, error])
    rows = _sweep(eng, tmp_path / "r.csv")
    assert all(_bitwise(a, b) for a, b in zip(rows, clean[0]))
    st = eng.governor.stats
    assert st.oom_events == {"sweep": 1} and st.oom_reclaims == 1
    assert freed == [1]
    assert eng.fault_stats.recovered_dispatches == 0
    # A second OOM on the retry is the irreducible dispatch.
    eng2 = _engine(jax_run[0])
    eng2.governor.set_action("evict_weights", engage=lambda: True)
    _oom_wrap(eng2, [error, error])
    with pytest.raises(hbm.HbmExhausted, match="survived governor reclaim"):
        _sweep(eng2, tmp_path / "r2.csv")
    assert eng2.governor.stats.oom_exhausted == 1


def test_hbm_squeeze_walks_the_rungs_as_jax(jax_run, clean, tmp_path):
    eng = _engine(jax_run[0], gov=GovernorConfig(sustain_ticks=1))
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule(**PLAN),
                                "hbm": faults.SiteSchedule.hbm_squeeze_at(
                                    1, frac=0.5, calls=2)})
    faults.wrap_engine(eng, plan)
    faults.wrap_governor(eng.governor, plan)
    rows = _sweep(eng, tmp_path / "r.csv")
    assert all(_bitwise(a, b) for a, b in zip(rows, clean[0]))
    got, want = eng.governor.stats, jax_run[1].governor.stats
    assert got.squeezes == want.squeezes == 1
    assert got.rung_downs == want.rung_downs and got.rung_downs
    assert got.rung_ups == want.rung_ups and got.rung_ups
    assert eng.governor.level == jax_run[1].governor.level == 0


def test_corrupt_drafts_leave_the_speculative_rows(jax_run, tmp_path):
    ref = _sweep(_engine(jax_run[0], spec_decode=True), tmp_path / "a.csv")
    eng = _engine(jax_run[0], spec_decode=True)
    plan = faults.FaultPlan(0, {"draft": faults.SiteSchedule.draft_corrupt_at(
        1, rows=(0, 1))})
    faults.wrap_engine(eng, plan)
    rows = _sweep(eng, tmp_path / "b.csv")
    assert all(_bitwise(a, b) for a, b in zip(rows, ref))
    assert plan.stats.injected == {"draft": 1}
    assert eng.spec_stats["spec_dispatches"] >= 2


def test_preemption_then_torn_manifest_resumes_to_the_clean_rows(
        jax_run, clean, tmp_path):
    out = tmp_path / "r.csv"
    plan = faults.FaultPlan(0, {"manifest_write":
                                faults.SiteSchedule.kill_at(1)})
    manifest = SweepManifest(out.with_suffix(".manifest.jsonl"),
                             tgrid.RESUME_KEY_FIELDS)
    manifest.mark_done_many = plan.wrap("manifest_write",
                                        manifest.mark_done_many)
    with pytest.raises(faults.InjectedPreemption):
        tsweep.run_perturbation_sweep(_engine(jax_run[0]), MODEL, PROMPTS,
                                      PERTS, out, manifest=manifest,
                                      checkpoint_every=2)
    faults.tear_jsonl_tail(out.with_suffix(".manifest.jsonl"))
    tsweep.run_perturbation_sweep(_engine(jax_run[0]), MODEL, PROMPTS, PERTS,
                                  out, checkpoint_every=2)
    got = schemas.read_results(out)
    keys = [r["Rephrased Main Part"] for r in got]
    assert len(keys) == N_CELLS == len(set(keys))
    by_key = {r.rephrased_main: r for r in clean[0]}
    for r in got:
        want = by_key[r["Rephrased Main Part"]]
        assert float(r["Token_1_Prob"]) == want.token_1_prob
        assert r["Model Response"] == want.model_response
