"""The port's CLI (``python -m lir_tpu_torch sweep|perturb|analyze|survey|
repro``) on the CPU.

- ``sweep`` writes the D1/D2 CSVs that ``run_model_comparison_sweep``
  writes when called directly on the same checkpoints, byte for byte.
- ``perturb`` on a ``perturbations.json`` written by the JAX package's
  ``schemas.save_perturbations`` writes the D6 CSV that
  ``run_perturbation_sweep`` writes when called directly
  (``tests/test_torch_sweep.py`` holds that function against the JAX
  sweep); the port's perturbation cache is the JAX package's file.
  With ``--spec-draft-model`` a second checkpoint drafts through a fleet
  (the D6 rows are the self-drafting run's); a draft model that cannot
  draft (the scored model itself, another vocabulary, speculation off)
  is refused.
- Every ported flag lands in the config field the JAX parser fills
  (both parsers run with their engine factories replaced by a recorder).
- ``--param-cache`` reaches ``engine_factory(cache_root=)`` on ``sweep``,
  ``perturb`` and ``serve`` (as the JAX parser's), and the watchdog
  flags reach RuntimeConfig and the engine's watchdog on all three
  (``sweep``'s word-meaning batches run under it in the port).
- ``serve`` on a tiny checkpoint round-trips JSONL (a ``{"op":
  "stats"}`` line included) to the library server's results, cold and
  then warm through ``--param-cache`` (no conversion the second time);
  ``serve --replicas 2`` to a direct single-server dispatch, bitwise;
  ``serve --replicas 2 --migrate-prefill-replicas 1`` (with and without
  ``--no-migrate``) to the library server within the bars, its stats
  line holding the ``"migrate"`` block;
  ``serve --fleet-models a,b`` answers ``fleet_score`` lines and
  single-model lines as the library's ``FleetScoringServer``. Its flags
  land in the JAX ``ServeConfig`` / ``RuntimeConfig`` / ``RouterConfig``
  fields and the fleet's arguments, the JAX command's refused
  combinations are refused, and the flags of tiers, meshes, the
  sentinels and tracing (ROADMAP A8d, A9, "Also open") are
  rejected.
- A flag of a feature the port does not have yet is rejected, as are
  ``--int8-dynamic`` without ``--int8`` and ``--full-completions`` with a
  decode budget; the default device is the card.
- ``analyze`` writes the files ``lir_tpu.cli analyze`` writes on the same
  inputs, with the same CSV headers; its flags are the JAX command's plus
  ``--device`` (default the card); it exits 2 without an input, and
  without matplotlib it skips the figures with a log line.
- ``repro --quick --no-figures`` writes the files the JAX command writes
  (less the survey figures, which the JAX survey pipeline draws
  whatever the flag says), with the same CSV headers and JSON structure,
  and the survey artifacts no draw decides equal to JAX's; ``survey
  --quick`` writes what repro's survey step writes, byte for byte, with
  the JAX file names. Both take the JAX flags plus ``--device`` (default
  the card); repro on a D2 with a failed model's NaN rows stops at the
  model graph (caveat R5).
"""

import dataclasses
import json
import inspect

import numpy as np
import pytest
import torch

import lir_tpu.cli as jcli
from lir_tpu.data import schemas as jschemas
from lir_tpu.data.prompts import LEGAL_PROMPTS as JAX_LEGAL_PROMPTS
from lir_tpu_torch import cli
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LEGAL_PROMPTS, WORD_MEANING_QUESTIONS, schemas
from lir_tpu_torch.engine import multi, sweep
from lir_tpu_torch.models import factory

BASE, CHAT = "tiny/gpt2-base", "tiny/llama-chat"
PERTURB_MODEL = "tiny/llama-bpe"


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    import transformers as tf
    from tiny_checkpoints import (build_bpe_gpt2, build_bpe_tokenizer,
                                  build_sp_llama)

    root = tmp_path_factory.mktemp("ckpts")
    build_bpe_gpt2(root / BASE.replace("/", "__"))
    build_sp_llama(root / CHAT.replace("/", "__"))
    # A rotary model for the legal prompts (~600 byte-BPE tokens, past the
    # tiny GPT-2's position table).
    fast = build_bpe_tokenizer()
    torch.manual_seed(2)
    model = tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=len(fast), hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=1024, tie_word_embeddings=False)).eval()
    path = root / PERTURB_MODEL.replace("/", "__")
    model.save_pretrained(path)
    fast.save_pretrained(path)
    return root


def test_sweep_writes_the_library_calls_csvs(ckpt_root, tmp_path):
    cli.main(["sweep", "--checkpoints", str(ckpt_root), "--models",
              f"{BASE}:base", CHAT, "--out", str(tmp_path / "cli"),
              "--batch-size", "32", "--device", "cpu"])
    multi.run_model_comparison_sweep(
        [multi.ModelSpec(BASE, "base"), multi.ModelSpec(CHAT, "instruct")],
        factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=32),
                               device="cpu"),
        tmp_path / "lib", questions=WORD_MEANING_QUESTIONS)
    for name in ("model_comparison_results.csv",
                 "instruct_model_comparison_results.csv"):
        got = (tmp_path / "cli" / name).read_bytes()
        assert got == (tmp_path / "lib" / name).read_bytes(), name
    d1 = schemas.read_results(tmp_path / "cli" / "model_comparison_results.csv")
    assert len(d1) == 2 * len(WORD_MEANING_QUESTIONS)
    assert {r["base_or_instruct"] for r in d1} == {"base", "instruct"}
    assert (tmp_path / "cli" / "sweep_session_log.txt").exists()


def _perturb_cache(tmp_path):
    entries = [((p.main, p.response_format, tuple(p.target_tokens),
                 p.confidence_format),
                [f"Rephrasing {j} of prompt {i}: {p.main[:80]}" for j in range(3)])
               for i, p in enumerate(JAX_LEGAL_PROMPTS)]
    cache = tmp_path / "perturbations.json"
    jschemas.save_perturbations(cache, entries)
    return cache


def test_perturb_writes_the_library_calls_d6(ckpt_root, tmp_path):
    cache = _perturb_cache(tmp_path)
    cli.main(["perturb", "--checkpoints", str(ckpt_root), "--model",
              PERTURB_MODEL, "--perturbations", str(cache), "--out",
              str(tmp_path / "cli.xlsx"), "--subset-size", "6",
              "--batch-size", "8", "--device", "cpu"])
    engine = factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=8),
                                    device="cpu")(PERTURB_MODEL)
    rows = sweep.run_perturbation_sweep(
        engine, PERTURB_MODEL, LEGAL_PROMPTS,
        [r for _, r in schemas.load_perturbations(cache)],
        tmp_path / "lib.csv", subset_size=6)
    assert len(rows) == 6
    cli_recs = schemas.read_results(tmp_path / "cli.csv")
    assert cli_recs == schemas.read_results(tmp_path / "lib.csv")
    assert {r["Model"] for r in cli_recs} == {PERTURB_MODEL}


DRAFT_MODEL = "tiny/llama-bpe-draft"


def test_perturb_with_a_draft_model_drafts_through_the_fleet(
        ckpt_root, tmp_path, monkeypatch):
    """``--spec-draft-model`` arms fleet drafting on the scored engine:
    a copy of the scored model's checkpoint drafts, and the D6 rows are
    the self-drafting run's. A perfect drafter's draft is rejected only
    where a row stops inside a window (the draft model does not apply
    the stop rule, as in the JAX package): at most once a row."""
    draft_dir = ckpt_root / DRAFT_MODEL.replace("/", "__")
    if not draft_dir.exists():
        draft_dir.symlink_to(ckpt_root / PERTURB_MODEL.replace("/", "__"))
    cache = _perturb_cache(tmp_path)
    engines = []
    real = sweep.run_perturbation_sweep

    def spy(engine, *a, **kw):
        engines.append((engine, engine._spec_draft is not None))
        return real(engine, *a, **kw)

    monkeypatch.setattr(sweep, "run_perturbation_sweep", spy)
    common = ["perturb", "--checkpoints", str(ckpt_root), "--model",
              PERTURB_MODEL, "--perturbations", str(cache),
              "--subset-size", "6", "--batch-size", "8", "--device", "cpu"]
    cli.main(common + ["--out", str(tmp_path / "self.xlsx")])
    cli.main(common + ["--out", str(tmp_path / "draft.xlsx"),
                       "--spec-draft-model", DRAFT_MODEL])
    assert [armed for _, armed in engines] == [False, True]
    engine = engines[1][0]
    engine.spec_flush()
    st = engine.spec_stats
    assert st["accepted_fleet"] > 0
    assert 0 <= st["draft_fleet"] - st["accepted_fleet"] <= 6
    assert st["draft_ngram"] == st["draft_tree"] == 0
    assert engine._spec_draft is None                     # released
    assert (schemas.read_results(tmp_path / "draft.csv")
            == schemas.read_results(tmp_path / "self.csv"))


@pytest.mark.parametrize("extra,error", [
    (["--spec-draft-model", PERTURB_MODEL], SystemExit),
    (["--spec-draft-model", CHAT], ValueError),
    (["--spec-draft-model", BASE, "--no-spec-decode"], SystemExit),
], ids=["itself", "another-vocab", "no-spec-decode"])
def test_perturb_refuses_a_draft_model_that_cannot_draft(
        ckpt_root, tmp_path, extra, error):
    cache = _perturb_cache(tmp_path)
    with pytest.raises(error):
        cli.main(["perturb", "--checkpoints", str(ckpt_root), "--model",
                  PERTURB_MODEL, "--perturbations", str(cache), "--out",
                  str(tmp_path / "d.xlsx"), "--subset-size", "6",
                  "--batch-size", "8", "--device", "cpu"] + extra)


def test_perturb_without_a_valid_cache_refuses(ckpt_root, tmp_path):
    jschemas.save_perturbations(tmp_path / "p.json", [])
    with pytest.raises(RuntimeError, match="No valid perturbation cache"):
        cli.main(["perturb", "--checkpoints", str(ckpt_root), "--model",
                  PERTURB_MODEL, "--perturbations", str(tmp_path / "p.json"),
                  "--device", "cpu"])


# ---------------------------------------------------------------------------
# Flags -> config fields, against the JAX parser
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _capture(monkeypatch, where: str, argv):
    """Run a CLI with its engine factory replaced by a recorder; return
    (runtime, spec config, cascade config, keyword arguments)."""
    seen = {}

    def fake_factory(root, rt, *a, **kw):
        seen.update(root=root, rt=rt, kw=kw)
        raise _Stop

    monkeypatch.setattr(f"{where}.models.factory.engine_factory", fake_factory)
    with pytest.raises(_Stop):
        if where == "lir_tpu":
            jcli.main(["--no-compile-cache"] + argv)
        else:
            cli.main(argv)
    return seen


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


_PERTURB = ["perturb", "--checkpoints", "ck", "--model", "m"]
PERTURB_FLAGS = [
    [], ["--batch-size", "8"], ["--full-completions"],
    ["--sweep-decode-tokens", "2"], ["--sweep-confidence-tokens", "16"],
    ["--no-early-stop"], ["--max-seq-len", "512"], ["--max-new-tokens", "20"],
    ["--no-ragged-scheduler"], ["--sweep-group-min-prefix", "8"],
    ["--sweep-group-min-cells", "0"], ["--scan-positions", "3"],
    ["--no-fused-decode"], ["--no-spec-decode"], ["--spec-k", "6"],
    ["--spec-ngram", "3"], ["--no-cascade-prefill"],
    ["--cascade-min-trunk", "64"], ["--cascade-trunk-quantum", "32"],
    ["--cascade-min-rows", "4"], ["--cascade-int8-qk"],
    ["--no-cascade-decode"], ["--no-cascade-fused-suffix"],
    ["--int8"], ["--int8", "--int8-dynamic"],
    ["--no-streaming-stats"], ["--no-row-artifact"], ["--no-numerics-guard"],
    ["--prefix-cache"], ["--prefix-cache", "--prefix-cache-pages", "8"],
    ["--prefix-cache", "--prefix-page-size", "32"], ["--no-spec-tree-probe"],
    ["--spec-tree-tails", "4"], ["--no-piggyback"], ["--kv-cache-int8"],
    ["--kv-cache-int8", "--int8", "--no-piggyback"],
]


@pytest.mark.parametrize("flags", PERTURB_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_perturb_flags_land_in_the_jax_fields(monkeypatch, flags):
    from lir_tpu_torch.config import CascadeConfig, SpecConfig

    port = _capture(monkeypatch, "lir_tpu_torch", _PERTURB + flags)
    ref = _capture(monkeypatch, "lir_tpu", _PERTURB + flags)
    rt_names = [f.name for f in dataclasses.fields(RuntimeConfig)]
    assert _fields(port["rt"], rt_names) == _fields(ref["rt"], rt_names)
    for key, cls in (("spec_config", SpecConfig),
                     ("cascade_config", CascadeConfig)):
        names = [f.name for f in dataclasses.fields(cls)]
        assert (_fields(port["kw"][key], names)
                == _fields(ref["kw"][key], names)), key
    for key in ("quantize_int8", "int8_dynamic", "kv_cache_int8"):
        assert port["kw"][key] == ref["kw"][key], key
    assert port["kw"]["device"] == "cuda"


def test_prefix_cache_flags_reach_the_configs(monkeypatch):
    """The five prefix-cache flags land in RuntimeConfig / SpecConfig with
    the values the JAX parser gives them."""
    flags = ["--prefix-cache", "--prefix-cache-pages", "24",
             "--prefix-page-size", "32", "--no-spec-tree-probe",
             "--spec-tree-tails", "5"]
    port = _capture(monkeypatch, "lir_tpu_torch", _PERTURB + flags)
    ref = _capture(monkeypatch, "lir_tpu", _PERTURB + flags)
    for got in (port, ref):
        rt, spec = got["rt"], got["kw"]["spec_config"]
        assert (rt.prefix_cache, rt.prefix_cache_pages,
                rt.prefix_page_size) == (True, 24, 32)
        assert (spec.tree_probe, spec.tree_tails_per_node) == (False, 5)
    defaults = _capture(monkeypatch, "lir_tpu_torch", _PERTURB)
    assert not defaults["rt"].prefix_cache
    assert defaults["kw"]["spec_config"].tree_probe


SWEEP_FLAGS = [[], ["--batch-size", "16"], ["--int8"],
               ["--int8", "--int8-dynamic"], ["--kv-cache-int8"],
               ["--sweep-kind", "instruct_only"], ["--out", "elsewhere"]]


@pytest.mark.parametrize("flags", SWEEP_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_sweep_flags_land_in_the_jax_fields(monkeypatch, flags):
    argv = ["sweep", "--checkpoints", "ck", "--models", "a/b:base", "c/d"] + flags
    calls = {}

    def recorder(where):
        def run(specs, factory_, out_dir, **kw):
            calls[where] = dict(specs=[(s.name, s.base_or_instruct)
                                       for s in specs], out=out_dir, kw=kw)
            raise _Stop
        return run

    got = {}
    for where, main in (("lir_tpu_torch", cli.main),
                        ("lir_tpu", lambda a: jcli.main(["--no-compile-cache"] + a))):
        seen = {}
        monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                            lambda root, rt, *a, **kw: seen.update(
                                root=root, rt=rt, kw=kw))
        monkeypatch.setattr(f"{where}.engine.multi.run_model_comparison_sweep",
                            recorder(where))
        with pytest.raises(_Stop):
            main(argv)
        got[where] = seen
    port, ref = got["lir_tpu_torch"], got["lir_tpu"]
    assert port["root"] == ref["root"]
    rt_names = [f.name for f in dataclasses.fields(RuntimeConfig)]
    assert _fields(port["rt"], rt_names) == _fields(ref["rt"], rt_names)
    for key in ("quantize_int8", "int8_dynamic", "kv_cache_int8"):
        assert port["kw"][key] == ref["kw"][key], key
    p, r = calls["lir_tpu_torch"], calls["lir_tpu"]
    assert p["specs"] == r["specs"] and p["out"] == r["out"]
    assert p["kw"]["sweep_kind"] == r["kw"]["sweep_kind"]


# Flags of features the port does not have yet (ROADMAP names the item
# that brings each).
UNPORTED = [
    ["--mesh", "1x8"],
    ["--lease-cells", "8"], ["--trace-buffer", "8"], ["--lease-shards"],
    ["--lease-ttl", "5"],
    ["--trace-out", "t.json"], ["--multihost"],
    ["--dtype", "float32"],
    ["--no-aot-precompile"], ["--barrier-timeout", "5"],
]


# The fleet's and the memory governor's flags: perturb's land in
# RuntimeConfig (--spec-draft-model) and GovernorConfig (the --hbm-*
# flags), sweep's in run_model_comparison_sweep's weight_prefetch and
# weight_cache_bytes (FleetConfig's fields).
MEMORY_FLAGS = [
    ("perturb", []), ("perturb", ["--spec-draft-model", "drafty"]),
    ("perturb", ["--no-hbm-governor"]), ("perturb", ["--hbm-budget-gb", "12"]),
    ("perturb", ["--hbm-reserve-frac", "0.1"]),
    ("perturb", ["--hbm-engage-pressure", "0.8"]),
    ("perturb", ["--hbm-hysteresis", "0.2"]),
    ("perturb", ["--hbm-sustain-ticks", "3"]),
    ("perturb", ["--hbm-evict-pages", "8"]),
    ("sweep", []), ("sweep", ["--weight-cache-gb", "1.5"]),
    ("sweep", ["--no-weight-prefetch"]),
    ("sweep", ["--weight-cache-gb", "0.25", "--no-weight-prefetch"]),
]


@pytest.mark.parametrize("command,flags", MEMORY_FLAGS,
                         ids=lambda f: " ".join(f) if isinstance(f, list)
                         else f)
def test_memory_flags_land_in_the_jax_fields(monkeypatch, command, flags):
    from lir_tpu.config import GovernorConfig as JaxGovernorConfig
    from lir_tpu_torch.config import FleetConfig, GovernorConfig

    gov_names = [f.name for f in dataclasses.fields(GovernorConfig)]
    assert gov_names == [f.name for f in
                         dataclasses.fields(JaxGovernorConfig)]
    if command == "perturb":
        port = _capture(monkeypatch, "lir_tpu_torch", _PERTURB + flags)
        ref = _capture(monkeypatch, "lir_tpu", _PERTURB + flags)
        rt_names = [f.name for f in dataclasses.fields(RuntimeConfig)]
        assert "spec_draft_model" in rt_names
        assert _fields(port["rt"], rt_names) == _fields(ref["rt"], rt_names)
        pg, rg = port["kw"]["governor_config"], ref["kw"]["governor_config"]
        assert _fields(pg, gov_names) == _fields(rg, gov_names)
        assert pg.budget_bytes == rg.budget_bytes
        return
    argv = ["sweep", "--checkpoints", "ck", "--models", "a/b"] + flags
    calls = {}
    for where, main in (("lir_tpu_torch", cli.main),
                        ("lir_tpu", lambda a: jcli.main(["--no-compile-cache"]
                                                        + a))):
        def run(specs, factory_, out_dir, _where=where, **kw):
            calls[_where] = kw
            raise _Stop
        monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                            lambda *a, **kw: None)
        monkeypatch.setattr(f"{where}.engine.multi.run_model_comparison_sweep",
                            run)
        with pytest.raises(_Stop):
            main(argv)
    port, ref = calls["lir_tpu_torch"], calls["lir_tpu"]
    for key in ("weight_prefetch", "weight_cache_bytes"):
        assert port[key] == ref[key], key
    gb = float(flags[flags.index("--weight-cache-gb") + 1]) \
        if "--weight-cache-gb" in flags else 0.0
    fleet = FleetConfig(weight_cache_gb=gb,
                        weight_prefetch="--no-weight-prefetch" not in flags)
    assert (port["weight_cache_bytes"], port["weight_prefetch"]) == (
        fleet.weight_cache_bytes, fleet.weight_prefetch)


@pytest.mark.parametrize("flag", UNPORTED, ids=lambda f: f[0])
def test_unported_flags_are_rejected(flag, capsys):
    assert f'"{flag[0]}"' in inspect.getsource(jcli)   # a real JAX flag
    with pytest.raises(SystemExit) as exc:
        cli.main(_PERTURB + flag + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_invalid_combinations_are_rejected():
    with pytest.raises(SystemExit) as exc:
        cli.main(_PERTURB + ["--int8-dynamic", "--device", "cpu"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit, match="full-completions"):
        cli.main(_PERTURB + ["--full-completions", "--sweep-decode-tokens",
                             "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(_PERTURB + ["--spec-k", "0", "--device", "cpu"])


def test_default_device_is_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["sweep", "--checkpoints", str(tmp_path), "--models", "a/b",
                  "--out", str(tmp_path / "out")])


def test_perturbation_cache_matches_the_jax_format(tmp_path):
    """save/load/validate: the port writes the JAX package's file byte for
    byte, and the cache rule refuses a changed prompt list."""
    from lir_tpu_torch.engine.rephrase import load_or_generate_perturbations

    entries = [((p.main, p.response_format, tuple(p.target_tokens),
                 p.confidence_format), [f"r{i}", "ü"])
               for i, p in enumerate(LEGAL_PROMPTS)]
    schemas.save_perturbations(tmp_path / "port.json", entries)
    jschemas.save_perturbations(tmp_path / "jax.json", entries)
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert schemas.load_perturbations(tmp_path / "jax.json") == entries
    assert schemas.validate_perturbation_cache(entries, LEGAL_PROMPTS)
    rotated = LEGAL_PROMPTS[1:] + LEGAL_PROMPTS[:1]
    assert not schemas.validate_perturbation_cache(entries, rotated)
    assert not schemas.validate_perturbation_cache(entries[:-1], LEGAL_PROMPTS)
    assert load_or_generate_perturbations(tmp_path / "port.json",
                                          LEGAL_PROMPTS) == entries
    with pytest.raises(RuntimeError, match="No valid perturbation cache"):
        load_or_generate_perturbations(tmp_path / "port.json", LEGAL_PROMPTS[1:])
    # A missing cache with a rephraser: generated (default key
    # prng_key(42)) and saved as the JAX package generates and saves it.
    def script(texts, key):
        k0, k1 = (int(x) for x in key.reshape(-1).tolist())
        return [f"1. {k0} {i}\n2 {k1 % 97}\nmore" for i in range(len(texts))]

    from lir_tpu.engine.rephrase import (
        load_or_generate_perturbations as jax_load_or_generate)

    kw = dict(sessions_per_prompt=3, rephrasings_per_session=2)
    got = load_or_generate_perturbations(tmp_path / "missing.json",
                                         LEGAL_PROMPTS, script, **kw)
    ref = jax_load_or_generate(tmp_path / "missing_jax.json",
                               JAX_LEGAL_PROMPTS, script, **kw)
    assert got == ref
    assert ((tmp_path / "missing.json").read_bytes()
            == (tmp_path / "missing_jax.json").read_bytes())


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------

def _analysis_inputs(root):
    from lir_tpu_torch.data import synthetic

    from test_torch_analysis import seeded_comparison_rows

    rows = seeded_comparison_rows()
    d1, d2 = root / "d1.csv", root / "d2.csv"
    schemas.write_model_comparison_csv(rows, d1)
    schemas.write_instruct_comparison_csv(rows, d2)
    d6 = synthetic.write_synthetic_d6(root / "d6.csv")
    return ["--perturbation-results", str(d6), "--base-csv", str(d1),
            "--instruct-csv", str(d2), "--no-figures", "--n-simulations",
            "5000"]


def test_analyze_writes_the_jax_files(tmp_path):
    """``python -m lir_tpu_torch analyze --device cpu`` with all three
    inputs writes the files ``lir_tpu.cli analyze`` writes, with the same
    CSV headers."""
    import subprocess
    import sys
    from pathlib import Path

    inputs = _analysis_inputs(tmp_path)
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "lir_tpu_torch", "analyze", *inputs, "--out",
         str(tmp_path / "port"), "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    jcli.main(["--no-compile-cache", "analyze", *inputs, "--out",
               str(tmp_path / "jax")])

    def files(base):
        return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                      if p.is_file())
    port, ref = files(tmp_path / "port"), files(tmp_path / "jax")
    assert port == ref
    assert {p.split("/")[0] for p in port} == {
        "perturbation", "base_vs_instruct", "model_graph", "kappa"}
    for name in port:
        if name.endswith(".csv"):
            head = [(b / name).read_text().split("\n", 1)[0]
                    for b in (tmp_path / "port", tmp_path / "jax")]
            assert head[0] == head[1], name


def test_analyze_without_inputs_exits_2():
    with pytest.raises(SystemExit) as exc:
        cli.main(["analyze", "--device", "cpu"])
    assert exc.value.code == 2


def test_analyze_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = _analysis_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["analyze", *inputs, "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_analyze_flags_are_the_jax_flags_and_device():
    import argparse

    def flags(add):
        sub = argparse.ArgumentParser().add_subparsers()
        add(sub)
        return {s: a.default for a in sub.choices["analyze"]._actions
                for s in a.option_strings}

    port, ref = flags(cli._add_analyze), flags(jcli._add_analyze)
    assert set(port) == set(ref) | {"--device"}
    assert {k: port[k] for k in ref} == ref
    assert port["--device"] == "cuda"


def test_analyze_without_matplotlib_skips_figures(monkeypatch, tmp_path,
                                                  caplog):
    """Without matplotlib the command logs that figures were skipped and
    writes every other artifact; --no-figures is then not needed."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    inputs = [a for a in _analysis_inputs(tmp_path) if a != "--no-figures"]
    with caplog.at_level("WARNING", logger="lir_tpu_torch"):
        cli.main(["analyze", *inputs, "--out", str(tmp_path / "out"),
                  "--device", "cpu"])
    assert any("matplotlib is not installed; figures skipped" in r.message
               for r in caplog.records)
    assert not list((tmp_path / "out").rglob("*.png"))
    assert (tmp_path / "out" / "kappa" / "combined_kappa_results.csv").exists()


# ---------------------------------------------------------------------------
# survey and repro
# ---------------------------------------------------------------------------

SURVEY_RESPONDENTS = 100


def _survey_data(root, error_model=False):
    from lir_tpu_torch.data import synthetic

    data = root / "data"
    data.mkdir(parents=True, exist_ok=True)
    synthetic.write_synthetic_survey(data / "word_meaning_survey_results.csv",
                                     n_respondents=SURVEY_RESPONDENTS)
    synthetic.write_synthetic_comparison(
        data / "model_comparison_results.csv",
        data / "instruct_model_comparison_results.csv",
        error_model=error_model)
    return data


@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """``repro --quick --no-figures`` of both packages and the port's
    ``survey --quick`` on the same data directory (a D2 without the
    failed model's NaN rows, which stop the model graph: caveat R5)."""
    root = tmp_path_factory.mktemp("repro")
    data = _survey_data(root)
    jcli.main(["--no-compile-cache", "repro", "--data", str(data), "--out",
               str(root / "jax"), "--quick", "--no-figures"])
    cli.main(["repro", "--data", str(data), "--out", str(root / "port"),
              "--quick", "--no-figures", "--device", "cpu"])
    cli.main(["survey", "--survey",
              str(data / "word_meaning_survey_results.csv"), "--instruct",
              str(data / "instruct_model_comparison_results.csv"), "--base",
              str(data / "model_comparison_results.csv"), "--out",
              str(root / "port_survey"), "--quick", "--device", "cpu"])
    return root


def _files(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.is_file())


def _keys(a, b, path=""):
    """The same JSON structure: keys in the same order, lists of the same
    length (the values apart)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            _keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for x, y in zip(a, b):
            _keys(x, y, path)


def test_repro_writes_the_jax_artifacts(repro_runs):
    """The port's repro writes every file of the JAX command's (the JAX
    survey pipeline draws its figures whatever --no-figures says; the
    port's does not: its one departure), with the same CSV headers and
    the same JSON structure; the artifacts no draw decides are JAX's to
    1e-6 (tests/test_torch_survey.py holds the rest on JAX's draws)."""
    import json
    import math

    port, ref = _files(repro_runs / "port"), _files(repro_runs / "jax")
    survey_png = {f"survey/{n}" for n in (
        "best_worst_model_agreement.png", "model_mae_comparison.png",
        "correlation_pvalue_distributions.png")}
    assert set(ref) - set(port) == survey_png and set(port) < set(ref)
    assert {p.split("/")[0] for p in port} == {
        "survey", "base_vs_instruct", "model_graph"}
    for name in port:
        a, b = repro_runs / "port" / name, repro_runs / "jax" / name
        if name.endswith(".csv"):
            assert (a.read_text().split("\n", 1)[0]
                    == b.read_text().split("\n", 1)[0]), name
        if name.endswith(".json"):
            _keys(json.loads(a.read_text()), json.loads(b.read_text()), name)
    for name in ("survey_analysis_detailed.json",
                 "llm_human_agreement_analysis.json",
                 "correlation_pvalues_analysis.json",
                 "proportion_analysis.json"):
        got = json.loads((repro_runs / "port" / "survey" / name).read_text())
        want = json.loads((repro_runs / "jax" / "survey" / name).read_text())

        def close(x, y):
            if isinstance(y, dict):
                return all(close(x[k], y[k]) for k in y)
            if isinstance(y, list):
                return all(close(u, v) for u, v in zip(x, y))
            if isinstance(y, float):
                return (math.isnan(x) and math.isnan(y)) or abs(x - y) <= (
                    1e-6 * max(1.0, abs(y)))
            return x == y and type(x) is type(y)
        assert close(got, want), name


def test_survey_command_is_the_pipeline(repro_runs):
    """``survey --quick`` writes what repro's survey step writes, byte for
    byte (one function, one seed, the same budgets), plus the figures,
    with the JAX command's file names."""
    survey = repro_runs / "port_survey"
    names = _files(survey)
    assert names == [n.split("/", 1)[1] for n in _files(repro_runs / "jax")
                     if n.startswith("survey/")]
    for name in _files(repro_runs / "port" / "survey"):
        assert ((survey / name).read_bytes()
                == (repro_runs / "port" / "survey" / name).read_bytes()), name


def test_repro_stops_at_the_model_graph_on_a_failed_model(tmp_path):
    """Caveat R5 through repro: a D2 holding a model whose every row is
    NaN stops the model graph with KeyError on that model, after the
    survey artifacts are written (the survey pipeline takes those rows)."""
    from lir_tpu_torch.data import synthetic

    data = _survey_data(tmp_path, error_model=True)
    with pytest.raises(KeyError) as exc:
        cli.main(["repro", "--data", str(data), "--out", str(tmp_path / "out"),
                  "--quick", "--no-figures", "--device", "cpu"])
    assert exc.value.args == (synthetic.SURVEY_ERROR_MODEL,)
    assert (tmp_path / "out" / "survey" / "proportion_analysis.json").exists()


@pytest.mark.parametrize("command", ["survey", "repro"])
def test_survey_flags_are_the_jax_flags_and_device(command):
    import argparse

    def flags(add):
        sub = argparse.ArgumentParser().add_subparsers()
        add(sub)
        return {s: a.default for a in sub.choices[command]._actions
                for s in a.option_strings}

    adder = {"survey": "_add_survey", "repro": "_add_repro"}[command]
    port, ref = flags(getattr(cli, adder)), flags(getattr(jcli, adder))
    assert set(port) == set(ref) | {"--device"}
    assert {k: port[k] for k in ref} == ref
    assert port["--device"] == "cuda"


@pytest.mark.parametrize("command", ["survey", "repro"])
def test_survey_commands_default_to_the_card(monkeypatch, tmp_path, command):
    data = _survey_data(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["survey", "--survey",
             str(data / "word_meaning_survey_results.csv"), "--instruct",
             str(data / "instruct_model_comparison_results.csv")]
            if command == "survey" else ["repro", "--data", str(data)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_survey_without_matplotlib_skips_figures(monkeypatch, tmp_path,
                                                 caplog):
    import sys

    data = _survey_data(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level("WARNING", logger="lir_tpu_torch"):
        cli.main(["survey", "--survey",
                  str(data / "word_meaning_survey_results.csv"), "--instruct",
                  str(data / "instruct_model_comparison_results.csv"),
                  "--out", str(tmp_path / "out"), "--quick", "--device",
                  "cpu"])
    assert any("survey: matplotlib is not installed; figures skipped"
               in r.message for r in caplog.records)
    assert not list((tmp_path / "out").rglob("*.png"))
    assert (tmp_path / "out" / "proportion_analysis.json").exists()


# ---------------------------------------------------------------------------
# --param-cache, the watchdog flags and serve
# ---------------------------------------------------------------------------

_SWEEP = ["sweep", "--checkpoints", "ck", "--models", "a/b"]
_SERVE = ["serve", "--checkpoints", "ck", "--model", "m"]


def _capture_sweep(monkeypatch, where, argv):
    seen = {}
    monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                        lambda root, rt, *a, **kw: seen.update(rt=rt, kw=kw))

    def run(*a, **kw):
        raise _Stop

    monkeypatch.setattr(f"{where}.engine.multi.run_model_comparison_sweep",
                        run)
    with pytest.raises(_Stop):
        if where == "lir_tpu":
            jcli.main(["--no-compile-cache"] + argv)
        else:
            cli.main(argv)
    return seen


@pytest.mark.parametrize("command", ["sweep", "perturb", "serve"])
def test_param_cache_reaches_the_factory_as_in_jax(monkeypatch, command,
                                                   tmp_path):
    flags = ["--param-cache", str(tmp_path / "pc")]
    if command == "sweep":
        port = _capture_sweep(monkeypatch, "lir_tpu_torch", _SWEEP + flags)
        ref = _capture_sweep(monkeypatch, "lir_tpu", _SWEEP + flags)
        none = _capture_sweep(monkeypatch, "lir_tpu_torch", _SWEEP)
    else:
        argv = (_PERTURB if command == "perturb" else _SERVE) + flags
        port = _capture(monkeypatch, "lir_tpu_torch", argv)
        ref = _capture(monkeypatch, "lir_tpu", argv)
        none = _capture(monkeypatch, "lir_tpu_torch", argv[:-2])
    assert port["kw"]["cache_root"] == ref["kw"]["cache_root"] == \
        tmp_path / "pc"
    assert none["kw"]["cache_root"] is None


@pytest.mark.parametrize("flag,value,field", [
    ("--watchdog-floor", "5", "watchdog_floor_s"),
    ("--watchdog-multiple", "2.5", "watchdog_multiple"),
    ("--watchdog-multiple", "0", "watchdog_multiple"),
])
def test_watchdog_flags_set_the_engines_watchdog(monkeypatch, flag, value,
                                                 field):
    """Each watchdog flag lands in the JAX RuntimeConfig field (perturb,
    serve; the JAX sweep has none) and an engine built from that runtime
    watches with it."""
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models import decoder, registry

    cfg = registry.tiny("llama")
    params = decoder.init_params(cfg, device="cpu")
    for argv in (_PERTURB, _SERVE, _SWEEP):
        if argv is _SWEEP:
            rt = _capture_sweep(monkeypatch, "lir_tpu_torch",
                                argv + [flag, value])["rt"]
        else:
            rt = _capture(monkeypatch, "lir_tpu_torch",
                          argv + [flag, value])["rt"]
            ref = _capture(monkeypatch, "lir_tpu", argv + [flag, value])["rt"]
            assert getattr(rt, field) == getattr(ref, field)
        assert getattr(rt, field) == float(value)
        wd = ScoringEngine(params, cfg, FakeTokenizer(), rt,
                           device="cpu").watchdog
        assert (wd.floor_s if field == "watchdog_floor_s"
                else wd.multiple) == float(value)
        assert wd.enabled == (rt.watchdog_multiple > 0)


SERVE_FLAGS = [
    [], ["--batch-size", "8"], ["--sweep-decode-tokens", "2"],
    ["--sweep-confidence-tokens", "5"], ["--queue-depth", "9"],
    ["--linger-ms", "3"], ["--cache-entries", "0"],
    ["--deadline", "interactive=2.5", "--deadline", "bulk=99"],
    ["--breaker-cooldown", "1.5"], ["--no-prefix-cache"],
    ["--prefix-cache-pages", "64"], ["--prefix-page-size", "32"],
    ["--no-pad-full"], ["--no-degrade-ladder"],
    ["--max-consecutive-failures", "5"], ["--stream-window", "0"],
    ["--no-streaming-stats"], ["--no-numerics-guard"], ["--int8"],
    ["--int8", "--int8-dynamic"], ["--kv-cache-int8"],
    ["--hbm-budget-gb", "20"], ["--no-hbm-governor"],
]


def _capture_serve(monkeypatch, where, argv):
    """(runtime, factory kwargs, ServeConfig) of a serve command line."""
    seen = {}

    def fake_factory(root, rt, *a, **kw):
        seen.update(rt=rt, kw=kw)
        return lambda name: object()

    class Server:
        def __init__(self, engine, name, config, **kw):
            seen["serve"] = config
            raise _Stop

    monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                        fake_factory)
    monkeypatch.setattr(f"{where}.serve.ScoringServer", Server)
    with pytest.raises(_Stop):
        if where == "lir_tpu":
            jcli.main(["--no-compile-cache"] + argv)
        else:
            cli.main(argv)
    return seen


@pytest.mark.parametrize("flags", SERVE_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_serve_flags_land_in_the_jax_fields(monkeypatch, flags):
    from lir_tpu_torch.config import GovernorConfig, ServeConfig

    port = _capture_serve(monkeypatch, "lir_tpu_torch", _SERVE + flags)
    ref = _capture_serve(monkeypatch, "lir_tpu", _SERVE + flags)
    rt_names = [f.name for f in dataclasses.fields(RuntimeConfig)]
    assert _fields(port["rt"], rt_names) == _fields(ref["rt"], rt_names)
    assert dataclasses.asdict(port["serve"]) == \
        dataclasses.asdict(ref["serve"])
    assert [f.name for f in dataclasses.fields(ServeConfig)] == \
        [f.name for f in dataclasses.fields(ref["serve"])]
    gov = [f.name for f in dataclasses.fields(GovernorConfig)]
    assert _fields(port["kw"]["governor_config"], gov) == \
        _fields(ref["kw"]["governor_config"], gov)
    for key in ("quantize_int8", "int8_dynamic", "kv_cache_int8"):
        assert port["kw"][key] == ref["kw"][key], key
    assert port["kw"]["device"] == "cuda"


# Flags of the JAX serve command that wait for the memory tiers
# (ROADMAP A8d), meshes (A9), the sentinels and tracing ("Also open").
SERVE_UNPORTED = [
    ["--mesh", "1x8"], ["--no-precompile"], ["--tiered"],
    ["--tier-host-mb", "64"], ["--sentinels", "legal"],
    ["--trace-out", "t.json"],
]


@pytest.mark.parametrize("flag", SERVE_UNPORTED, ids=lambda f: f[0])
def test_serve_rejects_the_flags_of_later_items(flag, capsys):
    assert f'"{flag[0]}"' in inspect.getsource(jcli)   # a real JAX flag
    with pytest.raises(SystemExit) as exc:
        cli.main(_SERVE + flag + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_serve_round_trips_jsonl_cold_then_warm(ckpt_root, tmp_path, capsys,
                                                monkeypatch):
    from lir_tpu_torch.config import ServeConfig
    from lir_tpu_torch.data.prompts import LEGAL_PROMPTS
    from lir_tpu_torch.models import loader
    from lir_tpu_torch.serve import ScoringServer, ServeRequest

    reqs = tmp_path / "reqs.jsonl"
    lines = [{"id": f"r{i}", "prompt": f"Is a tomato a vegetable {i} ?",
              "class": "interactive"} for i in range(5)]
    lines.insert(3, {"op": "stats"})
    reqs.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    argv = ["serve", "--checkpoints", str(ckpt_root), "--model", CHAT,
            "--requests", str(reqs), "--device", "cpu", "--batch-size", "4",
            "--linger-ms", "0", "--param-cache", str(tmp_path / "pc")]
    outs = []
    with monkeypatch.context() as m:
        for run in ("cold", "warm"):
            if run == "warm":
                m.setattr(loader, "convert_decoder", _no_convert)
            cli.main(argv)
            outs.append([{k: v for k, v in json.loads(x).items()
                          if k != "latency_s"}
                         for x in capsys.readouterr().out.strip().split("\n")])
    assert (tmp_path / "pc" / CHAT.replace("/", "__") / "cfg.json").exists()
    cold, warm = outs
    assert cold == warm
    assert cold[0]["op"] == "stats" and "kappa" in cold[0]["stats"]
    results = cold[1:]
    assert [r["request_id"] for r in results] == [f"r{i}" for i in range(5)]
    assert all(r["status"] == "ok" for r in results)
    eng = factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=4),
                                 device="cpu")(CHAT)
    lp = LEGAL_PROMPTS[0]
    server = ScoringServer(eng, CHAT, ServeConfig(linger_s=0.0))
    futs = [server.submit(ServeRequest(
        binary_prompt=f"{x['prompt']} {lp.response_format}",
        confidence_prompt=f"{x['prompt']} {lp.confidence_format}",
        klass="interactive", request_id=x["id"]))
        for x in lines if "prompt" in x]
    server.start()
    try:
        lib = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    for a, b in zip(lib, results):
        assert (a.token_1_prob, a.model_response, a.log_probabilities) == \
            (b["token_1_prob"], b["model_response"], b["log_probabilities"])


def _no_convert(*a, **kw):
    raise AssertionError("a warm --param-cache load converted the checkpoint")


# ---------------------------------------------------------------------------
# serve --replicas and --fleet-models
# ---------------------------------------------------------------------------

ROUTER_FLAGS = [
    [], ["--replicas", "3"], ["--hedge-threshold", "2.5"],
    ["--replica-failure-threshold", "4"], ["--replica-cooldown", "1.5"],
    ["--residency-bonus", "3"], ["--pressure-weight", "0"],
    ["--slo-wait-weight", "2"], ["--router-tick", "0.1"],
    ["--router-cache-entries", "0"],
]


def _capture_router(monkeypatch, where, argv):
    """(RouterConfig, replicas, ServeConfig) a serve command line gives
    its router loop."""
    mod = jcli if where == "lir_tpu" else cli
    seen = {}
    monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                        lambda root, rt, *a, **kw: (lambda name: object()))

    def run(args, serve_cfg, factory, n_replicas):
        seen.update(router=mod._router_cfg(args), n=n_replicas,
                    serve=serve_cfg, migrate=mod._migrate_cfg(args))
        raise _Stop

    monkeypatch.setattr(mod, "_run_router_serve", run)
    with pytest.raises(_Stop):
        if where == "lir_tpu":
            jcli.main(["--no-compile-cache"] + argv)
        else:
            cli.main(argv)
    return seen


@pytest.mark.parametrize("flags", ROUTER_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_router_flags_land_in_the_jax_fields(monkeypatch, flags):
    from lir_tpu_torch.config import RouterConfig

    if "--replicas" not in flags:
        flags = ["--replicas", "2"] + flags
    port = _capture_router(monkeypatch, "lir_tpu_torch", _SERVE + flags)
    ref = _capture_router(monkeypatch, "lir_tpu", _SERVE + flags)
    assert dataclasses.asdict(port["router"]) == \
        dataclasses.asdict(ref["router"])
    assert [f.name for f in dataclasses.fields(RouterConfig)] == \
        [f.name for f in dataclasses.fields(ref["router"])]
    assert port["n"] == ref["n"] == port["router"].replicas
    assert dataclasses.asdict(port["serve"]) == \
        dataclasses.asdict(ref["serve"])


MIGRATE_FLAGS = [
    [], ["--no-migrate"], ["--migrate-prefill-replicas", "1"],
    ["--migrate-chunk-pages", "4"], ["--migrate-inflight-chunks", "3"],
    ["--migrate-min-prefix", "64"], ["--migrate-page-bonus", "1.5"],
    ["--no-migrate-verify"], ["--migrate-timeout", "2.5"],
]


@pytest.mark.parametrize("flags", MIGRATE_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_migrate_flags_land_in_the_jax_fields(monkeypatch, flags):
    from lir_tpu_torch.config import MigrationConfig

    argv = _SERVE + ["--replicas", "2"] + flags
    port = _capture_router(monkeypatch, "lir_tpu_torch", argv)
    ref = _capture_router(monkeypatch, "lir_tpu", argv)
    assert dataclasses.asdict(port["migrate"]) == \
        dataclasses.asdict(ref["migrate"])
    assert [f.name for f in dataclasses.fields(MigrationConfig)] == \
        [f.name for f in dataclasses.fields(ref["migrate"])]
    if flags:
        assert port["migrate"] != MigrationConfig()


FLEET_FLAGS = [[], ["--fleet-deadline", "5"], ["--weight-cache-gb", "4"],
               ["--no-weight-prefetch"]]


def _capture_fleet(monkeypatch, where, argv):
    """The model ids, ``ModelFleet.from_engines`` keywords and fleet
    server keywords a ``serve --fleet-models`` line gives."""
    seen = {}
    monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                        lambda root, rt, *a, **kw: (lambda name: name))

    def from_engines(engines, **kw):
        seen.update(models=[m for m, _ in engines], fleet=kw)
        return object()

    def server(fleet, config, **kw):
        seen.update(server={k: v for k, v in kw.items() if k != "tiers"})
        raise _Stop

    monkeypatch.setattr(f"{where}.engine.fleet.ModelFleet.from_engines",
                        from_engines)
    monkeypatch.setattr(f"{where}.serve.FleetScoringServer", server)
    with pytest.raises(_Stop):
        if where == "lir_tpu":
            jcli.main(["--no-compile-cache"] + argv)
        else:
            cli.main(argv)
    return seen


@pytest.mark.parametrize("flags", FLEET_FLAGS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_fleet_serve_flags_reach_the_fleet_as_in_jax(monkeypatch, flags):
    argv = ["serve", "--checkpoints", "ck", "--fleet-models", "a/b,c/d"]
    port = _capture_fleet(monkeypatch, "lir_tpu_torch", argv + flags)
    ref = _capture_fleet(monkeypatch, "lir_tpu", argv + flags)
    assert port == ref
    assert port["models"] == ["a/b", "c/d"]


@pytest.mark.parametrize("flags", [
    ["--model", "m", "--fleet-models", "a,b"],
    ["--replicas", "2", "--fleet-models", "a,b"],
    ["--model", "m", "--replicas", "2", "--state-checkpoint", "s.json"],
    ["--fleet-models", "a,b", "--state-checkpoint", "s.json"],
    ["--fleet-models", ","],
    [],
], ids=["model-and-fleet", "replicas-fleet", "replicas-checkpoint",
        "fleet-checkpoint", "fleet-empty", "neither"])
def test_serve_refuses_the_jax_combinations(monkeypatch, flags):
    for where in ("lir_tpu_torch", "lir_tpu"):
        monkeypatch.setattr(f"{where}.models.factory.engine_factory",
                            lambda root, rt, *a, **kw: (lambda name: name))
        argv = ["serve", "--checkpoints", "ck"] + flags
        with pytest.raises(SystemExit) as exc:
            if where == "lir_tpu":
                jcli.main(["--no-compile-cache"] + argv)
            else:
                cli.main(argv)
        assert isinstance(exc.value.code, str), (where, exc.value.code)


def _request_lines(tmp_path, lines):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return reqs


def _out_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().split("\n")]


def test_serve_replicas_round_trips_jsonl_bitwise(ckpt_root, tmp_path,
                                                  capsys):
    """``serve --replicas 2`` (prefix cache off): every payload bitwise a
    direct single-server dispatch of the same request, the stats line the
    router's health view, every request resolved once."""
    from lir_tpu_torch.config import ServeConfig
    from lir_tpu_torch.data.prompts import LEGAL_PROMPTS
    from lir_tpu_torch.serve import ScoringServer, ServeRequest

    lines = [{"id": f"r{i}", "prompt": f"Is a tomato a vegetable {i} ?",
              "class": "interactive"} for i in range(6)]
    lines.insert(2, {"op": "stats"})
    reqs = _request_lines(tmp_path, lines)
    cli.main(["serve", "--checkpoints", str(ckpt_root), "--model", CHAT,
              "--replicas", "2", "--requests", str(reqs), "--device", "cpu",
              "--batch-size", "4", "--linger-ms", "0", "--no-prefix-cache",
              "--router-cache-entries", "0"])
    out = _out_lines(capsys)
    stats = out[0]
    assert stats["op"] == "stats" and set(stats["replicas"]) == {"r0", "r1"}
    assert set(stats["migrate"].values()) == {0}    # no page pool: no chain
    results = out[1:]
    assert [r["request_id"] for r in results] == [f"r{i}" for i in range(6)]
    assert all(r["status"] == "ok" for r in results)
    eng = factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=4),
                                 device="cpu")(CHAT)
    lp = LEGAL_PROMPTS[0]
    server = ScoringServer(eng, CHAT, ServeConfig(linger_s=0.0,
                                                  prefix_cache=False))
    server.start()
    try:
        for x, got in zip([x for x in lines if "prompt" in x], results):
            want = server.submit(ServeRequest(
                binary_prompt=f"{x['prompt']} {lp.response_format}",
                confidence_prompt=f"{x['prompt']} {lp.confidence_format}",
                klass="interactive", request_id=x["id"])).result(120)
            for f in ("model_response", "model_confidence_response",
                      "token_1_prob", "token_2_prob", "log_probabilities",
                      "confidence_value", "weighted_confidence"):
                assert got[f] == getattr(want, f), f
    finally:
        server.stop()


def _library_results(ckpt_root, lines, prefix_cache=True):
    """The library ScoringServer's results for the prompt lines."""
    from lir_tpu_torch.config import ServeConfig
    from lir_tpu_torch.data.prompts import LEGAL_PROMPTS
    from lir_tpu_torch.serve import ScoringServer, ServeRequest

    eng = factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=4),
                                 device="cpu")(CHAT)
    lp = LEGAL_PROMPTS[0]
    server = ScoringServer(eng, CHAT, ServeConfig(
        linger_s=0.0, prefix_cache=prefix_cache)).start()
    try:
        return [server.submit(ServeRequest(
            binary_prompt=f"{x['prompt']} {lp.response_format}",
            confidence_prompt=f"{x['prompt']} {lp.confidence_format}",
            klass="interactive", request_id=x["id"])).result(120)
            for x in lines if "prompt" in x]
    finally:
        server.stop()


_TRUNK = ("Under the homeowner policy, a claim for water damage from a "
          "burst pipe in the insured dwelling is covered unless the insured "
          "failed to maintain heat in the building while it was vacant, and "
          "the insurer bears the burden of proving that exclusion applies")


@pytest.mark.parametrize("no_migrate", [False, True],
                         ids=["migrate", "no-migrate"])
def test_serve_migrate_prefill_replicas_round_trips_jsonl(
        ckpt_root, tmp_path, capsys, caplog, no_migrate):
    """``serve --replicas 2 --migrate-prefill-replicas 1``: r0 takes the
    prefill role and r1 decodes; requests sharing a long trunk migrate
    their pages from r0 to r1 (``--no-migrate``: none do, r1 scores
    them colocated); every payload as the library server's, every
    request resolved once, the stats line (answered at once, with the
    chains under way) and the final router stats holding the "migrate"
    block."""
    lines = [{"id": f"m{i}", "prompt": f"{_TRUNK} (case {i}) ?",
              "class": "interactive"} for i in range(4)]
    lines.append({"op": "stats"})
    reqs = _request_lines(tmp_path, lines)
    argv = ["serve", "--checkpoints", str(ckpt_root), "--model", CHAT,
            "--replicas", "2", "--migrate-prefill-replicas", "1",
            "--migrate-min-prefix", "16", "--requests", str(reqs),
            "--device", "cpu", "--batch-size", "4", "--linger-ms", "0",
            "--router-cache-entries", "0"]
    with caplog.at_level("INFO", logger="lir_tpu_torch.cli"):
        cli.main(argv + (["--no-migrate"] if no_migrate else []))
    final = json.loads(next(
        r.getMessage() for r in caplog.records
        if r.getMessage().startswith("router stats: "))[len("router stats: "):])
    out = _out_lines(capsys)
    stats, results = out[0], out[1:]
    assert stats["op"] == "stats"
    assert {r: v["role"] for r, v in stats["replicas"].items()} == \
        {"r0": "prefill", "r1": "decode"}
    mig = final["migrate"]
    assert set(stats["migrate"]) == set(mig)
    assert [r["request_id"] for r in results] == [f"m{i}" for i in range(4)]
    assert all(r["status"] == "ok" for r in results)
    assert final["router"]["per_replica"] == {"r1": 4}
    if no_migrate:
        assert set(mig.values()) == {0}
    else:
        assert stats["migrate"]["prefill_ops"] >= 1
        assert mig["migrations"] >= 1 and mig["pages_migrated"] > 0
        assert mig["refetch_fallbacks"] == 0
    for want, got in zip(_library_results(ckpt_root, lines), results):
        for f in ("model_response", "model_confidence_response",
                  "confidence_value", "log_probabilities"):
            assert got[f] == getattr(want, f), f
        for f in ("token_1_prob", "token_2_prob", "weighted_confidence"):
            np.testing.assert_allclose(got[f], getattr(want, f), rtol=1e-5,
                                       atol=1e-6, err_msg=f)


def test_serve_fleet_models_answers_fleet_and_single_lines(ckpt_root,
                                                           tmp_path, capsys):
    """``serve --fleet-models`` on two checkpoints: a line without
    "model" is a fleet_score fan-out, one with "model" a single-model
    request; both as the library's FleetScoringServer answers them."""
    from lir_tpu_torch.config import ServeConfig
    from lir_tpu_torch.data.prompts import LEGAL_PROMPTS
    from lir_tpu_torch.engine.fleet import ModelFleet
    from lir_tpu_torch.serve import FleetScoringServer, ServeRequest

    lines = [{"id": f"f{i}", "prompt": f"Is a whale a fish {i} ?"}
             for i in range(3)]
    lines.append({"id": "s0", "prompt": "Is a whale a fish 9 ?",
                  "model": CHAT})
    lines.append({"op": "stats"})
    reqs = _request_lines(tmp_path, lines)
    cli.main(["serve", "--checkpoints", str(ckpt_root), "--fleet-models",
              f"{CHAT},{BASE}", "--requests", str(reqs), "--device", "cpu",
              "--batch-size", "4", "--linger-ms", "0",
              "--fleet-deadline", "600"])
    out = _out_lines(capsys)
    stats = out[0]
    assert stats["op"] == "stats" and set(stats) == {"op", "serve", "fleet"}
    fleet_out, single = out[1:4], out[4]
    assert [r["request_id"] for r in fleet_out] == ["f0", "f1", "f2"]
    assert all(r["status"] == "ok" and r["n_models"] == 2
               for r in fleet_out)
    assert single["request_id"] == "s0" and single["status"] == "ok"
    make = factory.engine_factory(ckpt_root, RuntimeConfig(batch_size=4),
                                  device="cpu")
    fleet = ModelFleet.from_engines([(m, make(m)) for m in (CHAT, BASE)])
    server = FleetScoringServer(fleet, ServeConfig(linger_s=0.0),
                                fleet_deadline_s=600.0).start()
    lp = LEGAL_PROMPTS[0]

    def req(x):
        return ServeRequest(
            binary_prompt=f"{x['prompt']} {lp.response_format}",
            confidence_prompt=f"{x['prompt']} {lp.confidence_format}",
            klass="batch", request_id=x["id"])

    try:
        for x, got in zip(lines[:3], fleet_out):
            want = server.submit_fleet(req(x)).result(120)
            assert got["per_model"] == want["per_model"]
            assert got["kappa"] == want["kappa"]
        want = server.submit(req(lines[3]), CHAT).result(120)
        assert (single["token_1_prob"], single["model_response"]) == \
            (want.token_1_prob, want.model_response)
    finally:
        server.stop()
        fleet.shutdown()
