"""The port's model-comparison sweep and loaded engines against the JAX
package and the executed reference scorer.

- The sweep: the same tiny checkpoints (``tools/tiny_checkpoints.py``: a
  byte-BPE GPT-2 as a base model, a Unigram/Metaspace llama as an
  instruct one) plus a spec with no checkpoint, through the port's
  ``run_model_comparison_sweep`` (``engine_factory`` on the CPU) and the
  JAX one, over the same 6 questions, with one row of the instruct model
  forced to NaN in both. D1 and D2 read back with pandas: text columns
  exact, ``yes_prob`` / ``no_prob`` / ``odds_ratio`` / ``relative_prob``
  within 1e-5, NaN rows identical; the ``per_model`` statuses equal; the
  forced row quarantined in both.
- The scorer oracle: the port's engine from ``load_engine`` on the
  ``bpe-gpt2``, ``sp-llama``, ``sp-llama-bos`` and ``chain-gpt2``
  checkpoints against ``tests/golden/reference_executed.json
  ["scorer_oracle"]`` with ``test_reference_scorer_oracle``'s bars
  (positions and found flags exact, probabilities within 2e-3, derived
  readouts within 1 %, chain completions exact), at ``max_seq_len=256``.
"""

import dataclasses
import json
import math

import numpy as np
import pandas as pd
import pytest

from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.engine import multi as jmulti
from lir_tpu.models import factory as jfactory
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import WORD_MEANING_QUESTIONS, schemas
from lir_tpu_torch.engine import multi
from lir_tpu_torch.models import factory

from test_reference_scorer_oracle import GOLDEN_PATH, _diff_case

FTOL = 1e-5
QUESTIONS = list(WORD_MEANING_QUESTIONS[:6])
BASE, CHAT, ABSENT = "tiny/gpt2-base", "tiny/llama-chat", "absent/model"
FORCED_NAN = 2          # the instruct model's row forced to NaN
RT = dict(batch_size=4, max_new_tokens=12, max_seq_len=256)
TEXT = ("prompt", "model", "model_family", "base_or_instruct", "model_output")
FLOATS = ("yes_prob", "no_prob", "odds_ratio", "relative_prob")


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    from tiny_checkpoints import build_bpe_gpt2, build_sp_llama

    root = tmp_path_factory.mktemp("ckpts")
    build_bpe_gpt2(root / BASE.replace("/", "__"))
    build_sp_llama(root / CHAT.split("/")[-1])   # the second candidate dir
    return root


def _forcing(make):
    """An engine factory whose instruct engine returns row FORCED_NAN with
    a NaN P(yes) (a corrupt readout the numerics guard must catch)."""
    def factory_(name):
        eng = make(name)
        if name == CHAT:
            score = eng.score_prompts

            def forced(prompts, **kw):
                rows = score(prompts, **kw)
                rows[FORCED_NAN] = dataclasses.replace(
                    rows[FORCED_NAN], yes_prob=float("nan"))
                return rows
            eng.score_prompts = forced
        return eng
    return factory_


SPECS = [(BASE, "base"), (CHAT, "instruct"), (ABSENT, "instruct")]


@pytest.fixture(scope="module")
def sweeps(ckpt_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    jart = jmulti.run_model_comparison_sweep(
        [jmulti.ModelSpec(*s) for s in SPECS],
        _forcing(jfactory.engine_factory(ckpt_root, JaxRuntimeConfig(**RT))),
        out / "jax", questions=QUESTIONS)
    tart = multi.run_model_comparison_sweep(
        [multi.ModelSpec(*s) for s in SPECS],
        _forcing(factory.engine_factory(ckpt_root, RuntimeConfig(**RT),
                                        device="cpu")),
        out / "torch", questions=QUESTIONS)
    return out, jart, tart


def assert_frames_match(port: pd.DataFrame, ref: pd.DataFrame):
    assert list(port.columns) == list(ref.columns)
    assert len(port) == len(ref)
    for col in port.columns:
        if col in TEXT:
            assert port[col].tolist() == ref[col].tolist(), col
        else:
            a, b = port[col].to_numpy(float), ref[col].to_numpy(float)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=col)
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=col)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], atol=FTOL, rtol=0,
                                       err_msg=col)


@pytest.mark.parametrize("name", ["model_comparison_results.csv",
                                  "instruct_model_comparison_results.csv"])
def test_d1_d2_match_the_jax_sweep(sweeps, name):
    out, _, _ = sweeps
    port = pd.read_csv(out / "torch" / name)
    ref = pd.read_csv(out / "jax" / name)
    assert set(FLOATS) & set(port.columns)
    assert_frames_match(port, ref)
    n = len(QUESTIONS)
    assert len(port) == (3 * n if name.startswith("model") else 2 * n)


def test_statuses_quarantine_and_nan_rows_match(sweeps):
    out, jart, tart = sweeps
    assert {k: v["status"] for k, v in tart["per_model"].items()} == {
        k: v["status"] for k, v in jart["per_model"].items()}
    per = tart["per_model"]
    assert per[BASE]["status"] == "ok"
    assert per[CHAT]["status"].startswith("error:numerics")
    assert per[CHAT]["rows_quarantined"] == jart["per_model"][CHAT][
        "rows_quarantined"] == 1
    assert per[ABSENT]["status"].startswith(multi.MODEL_ERROR)
    for key in ("rows", "yes_no_found"):
        assert ({k: v.get(key) for k, v in per.items()}
                == {k: v.get(key) for k, v in jart["per_model"].items()})
    recs = tart["model_comparison_csv"]
    chat = [r for r in recs if r["model"] == CHAT]
    assert chat[FORCED_NAN]["model_output"] == "ERROR"
    assert math.isnan(chat[FORCED_NAN]["yes_prob"])
    assert sum(math.isnan(r["yes_prob"]) for r in recs) == len(QUESTIONS) + 1
    guard, jguard = tart["guard"], jart["guard"]
    assert guard["quarantined"] == jguard["quarantined"] == {"multi": 2}
    assert guard["checked"] == jguard["checked"]
    assert tart["throughput"]["prompts"] == jart["throughput"]["prompts"]
    assert tart["throughput"]["tokens_in"] == jart["throughput"]["tokens_in"]
    assert list(tart["fleet"]) == list(jart["fleet"])
    for key in ("loads", "prefetch_hits", "prefetch_misses", "cache_hits",
                "model_swaps"):
        assert tart["fleet"][key] == jart["fleet"][key], key
    log = (out / "torch" / "sweep_session_log.txt").read_text()
    assert "=== tiny/llama-chat (instruct) ===" in log
    assert "quarantined" in log


def test_writer_records_round_trip_through_pandas(sweeps):
    """The records the writers return are the rows on disk, floats
    bitwise (pandas' round-trip parser: its default one may move the
    last bit)."""
    out, _, tart = sweeps
    frame = pd.read_csv(out / "torch" / "model_comparison_results.csv",
                        float_precision="round_trip")
    recs = tart["model_comparison_csv"]
    assert frame["prompt"].tolist() == [r["prompt"] for r in recs]
    np.testing.assert_array_equal(
        frame["odds_ratio"].to_numpy(float),
        np.array([r["odds_ratio"] for r in recs], float))
    assert [tuple(r) for r in recs[:1]] == [schemas.MODEL_COMPARISON_COLUMNS]


def test_the_factory_tries_the_three_candidate_dirs(ckpt_root, tmp_path):
    from lir_tpu_torch.backends.fake import FakeTokenizer

    (tmp_path / "org").mkdir()
    (tmp_path / "org" / "nested").symlink_to(ckpt_root / "llama-chat",
                                             target_is_directory=True)
    make = factory.engine_factory(tmp_path, tokenizer=FakeTokenizer(vocab=512),
                                  device="cpu")
    assert make("org/nested").cfg.name == str(tmp_path / "org" / "nested")
    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
        make("org/missing")


def test_format_routing_and_pairs_match_jax():
    names = ["meta-llama/Llama-2-7b-hf", "bigscience/bloom-7b1",
             "baichuan-inc/Baichuan2-7B-Chat", "tiiuae/falcon-7b-instruct"]
    for kind in ("base_vs_instruct", "instruct_only"):
        for name in names:
            for bi in ("base", "instruct"):
                got = multi.format_for(multi.ModelSpec(name, bi), kind)
                want = jmulti.format_for(jmulti.ModelSpec(name, bi), kind)
                assert got(QUESTIONS[0]) == want(QUESTIONS[0])
    pairs = [("a/base", "a/chat"), ("b/base", "b/instruct")]
    assert ([dataclasses.astuple(s) for s in multi.base_instruct_pairs(pairs)]
            == [dataclasses.astuple(s) for s in jmulti.base_instruct_pairs(pairs)])
    spec = multi.ModelSpec("x/y", "base")
    # repr: NaN fields compare equal as text.
    assert ([repr(dataclasses.asdict(r))
             for r in multi.nan_rows_for_model(spec, QUESTIONS)]
            == [repr(dataclasses.asdict(r)) for r in jmulti.nan_rows_for_model(
                jmulti.ModelSpec("x/y", "base"), QUESTIONS)])


# ---------------------------------------------------------------------------
# The executed reference scorer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_PATH.read_text())["scorer_oracle"]


def _engine(path):
    return factory.load_engine(path, RuntimeConfig(
        batch_size=4, max_new_tokens=50, max_seq_len=256), device="cpu")


def _builders():
    from tiny_checkpoints import build_bpe_gpt2, build_chain_gpt2, build_sp_llama

    return {"bpe-gpt2": build_bpe_gpt2, "sp-llama": build_sp_llama,
            "chain-gpt2": lambda p: build_chain_gpt2(p)[:3]}


@pytest.mark.parametrize("key", ["bpe-gpt2", "sp-llama", "chain-gpt2"])
def test_loaded_engine_matches_the_executed_reference(golden, tmp_path, key):
    group = golden[key]
    _builders()[key](tmp_path / key)
    engine = _engine(tmp_path / key)
    assert engine.yes_id == group["yes_id"]
    assert engine.no_id == group["no_id"]
    rows = engine.score_prompts([c["prompt"] for c in group["cases"]])
    for row, case in zip(rows, group["cases"]):
        for ref in (case["ref_cbvi"], case["ref_cim"]):
            _diff_case(row, ref, check_completion=(key == "chain-gpt2"))
    if key == "chain-gpt2":
        never = [r for r, c in zip(rows, group["cases"]) if c["key"] == "never"]
        assert never[0].yes_no_found is False
        assert never[0].position_found == 0


def test_bos_tokenizer_targets_resolve_past_the_special(golden, tmp_path):
    """The reference resolves both targets of a bos-prepending tokenizer
    to <s> (yes == no, relative_prob 0.5 for every prompt); the port, as
    the JAX package, resolves them to the metaspace pieces."""
    from tiny_checkpoints import build_sp_llama

    group = golden["sp-llama-bos"]
    ref = group["cases"][0]["ref_cim"]
    assert group["yes_id"] == group["no_id"] == group["bos_id"]
    assert ref["relative_prob"] == 0.5
    build_sp_llama(tmp_path / "bos", add_bos=True)
    engine = _engine(tmp_path / "bos")
    assert engine.yes_id != group["bos_id"] and engine.no_id != group["bos_id"]
    assert engine.yes_id == golden["sp-llama"]["yes_id"]
    assert engine.no_id == golden["sp-llama"]["no_id"]
    row = engine.score_prompts([group["cases"][0]["prompt"]])[0]
    assert np.isfinite(row.relative_prob)
    assert row.yes_prob != row.no_prob
