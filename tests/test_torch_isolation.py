"""The port stands alone: it imports neither JAX nor the JAX package (nor
pandas, openpyxl, matplotlib or seaborn, which the card's machine lacks,
nor transformers,
safetensors or tokenizers, which its loader does without), and its
entry points never fall back to the CPU on their own."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import lir_tpu_torch
import lir_tpu_torch.config, lir_tpu_torch.data, lir_tpu_torch.ops
import lir_tpu_torch.backends.fake, lir_tpu_torch.models.convert
import lir_tpu_torch.engine.runner, lir_tpu_torch.engine.sweep
import lir_tpu_torch.engine.spec, lir_tpu_torch.engine.prefix_tree
import lir_tpu_torch.models.paged, lir_tpu_torch.models.encdec
import lir_tpu_torch.engine.scheduler, lir_tpu_torch.engine.grid
import lir_tpu_torch.utils.manifest, lir_tpu_torch.utils.profiling
import lir_tpu_torch.models.quant, lir_tpu_torch.ops.flash_attention
import lir_tpu_torch.ops.cascade_prefill
import lir_tpu_torch.models.loader, lir_tpu_torch.models.factory
import lir_tpu_torch.engine.multi, lir_tpu_torch.engine.rephrase
import lir_tpu_torch.engine.hbm, lir_tpu_torch.engine.fleet
import lir_tpu_torch.models.weights
import lir_tpu_torch.guard.numerics, lir_tpu_torch.utils.logging
import lir_tpu_torch.guard.watchdog, lir_tpu_torch.utils.retry
import lir_tpu_torch.faults, lir_tpu_torch.faults.breaker
import lir_tpu_torch.faults.ladder, lir_tpu_torch.faults.plan
import lir_tpu_torch.models.cache
import lir_tpu_torch.serve, lir_tpu_torch.serve.queue
import lir_tpu_torch.serve.cache, lir_tpu_torch.serve.batcher
import lir_tpu_torch.serve.server, lir_tpu_torch.serve.router
import lir_tpu_torch.serve.migrate
import lir_tpu_torch.cli
import lir_tpu_torch.stats, lir_tpu_torch.stats.core, lir_tpu_torch.stats.kappa
import lir_tpu_torch.stats.bootstrap, lir_tpu_torch.stats.correlations
import lir_tpu_torch.stats.agreement, lir_tpu_torch.stats.fits
import lir_tpu_torch.stats.normality, lir_tpu_torch.stats.streaming
import lir_tpu_torch.engine.stream_stats, lir_tpu_torch.ops.stream_fold
import lir_tpu_torch.engine.prng, lir_tpu_torch.ops.sample
import lir_tpu_torch.ops.kv_int8_attention
import lir_tpu_torch.analysis, lir_tpu_torch.analysis.perturbation
import lir_tpu_torch.analysis.base_vs_instruct, lir_tpu_torch.analysis.model_graph
import lir_tpu_torch.analysis.kappa_combined
import lir_tpu_torch.report, lir_tpu_torch.report.figures
import lir_tpu_torch.report.latex
import lir_tpu_torch.data.synthetic, lir_tpu_torch.data.table
import lir_tpu_torch.survey, lir_tpu_torch.survey.loader
import lir_tpu_torch.survey.human_llm, lir_tpu_torch.survey.consolidated
import lir_tpu_torch.survey.family_differences, lir_tpu_torch.survey.simulated
import lir_tpu_torch.survey.pvalues, lir_tpu_torch.survey.proportions
import lir_tpu_torch.survey.run, lir_tpu_torch.report.survey_figures
import chip_smoke, kernel_ab, kernel_variants, profile_batch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "lir_tpu" or m.startswith("lir_tpu.")
             or m.split(".")[0] in ("pandas", "openpyxl", "transformers",
                                    "safetensors", "tokenizers",
                                    "matplotlib", "seaborn"))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []", out.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_default_device_raises_without_cuda(monkeypatch):
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models import decoder, registry

    _no_cuda(monkeypatch)
    cfg = registry.tiny("llama")
    params = decoder.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringEngine(params, cfg, FakeTokenizer(vocab=cfg.vocab_size))


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return node.numpy()


@pytest.mark.parametrize("entry", ["init_params", "params_from_jax",
                                   "convert_decoder", "encdec.init_params",
                                   "convert_t5"])
def test_param_entry_points_default_to_cuda(monkeypatch, entry):
    from lir_tpu_torch.models import convert, decoder, encdec, loader, registry

    cfg = registry.tiny("llama")
    tree = _numpy_tree(decoder.init_params(cfg, device="cpu"))
    t5 = registry.T5Config(vocab_size=64, hidden_size=32, n_layers=1,
                           n_heads=2, head_dim=16, intermediate_size=48)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "init_params":
            decoder.init_params(cfg)
        elif entry == "params_from_jax":
            convert.params_from_jax(tree, cfg)
        elif entry == "convert_decoder":
            loader.convert_decoder({}, cfg, "llama")
        elif entry == "encdec.init_params":
            encdec.init_params(t5)
        else:
            loader.convert_t5({}, t5)


@pytest.mark.parametrize("entry", ["load_engine", "engine_factory"])
def test_loader_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """Neither loads a byte before refusing the missing card; neither
    falls back to the CPU."""
    import chip_smoke
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.models import decoder, factory, registry

    cfg = registry.tiny("llama")
    chip_smoke.export_hf_llama(decoder.init_params(cfg, device="cpu"), cfg,
                               tmp_path / "tiny-llama")
    tok = FakeTokenizer(vocab=cfg.vocab_size)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "load_engine":
            factory.load_engine(tmp_path / "tiny-llama", tokenizer=tok)
        else:
            factory.engine_factory(tmp_path, tokenizer=tok)("tiny-llama")


def test_cuda_wrappers_refuse_non_cuda_tensors():
    """A wrapper given a tensor on neither the CPU nor a card raises; it
    never reroutes to the plain version."""
    from lir_tpu_torch import ops

    q = torch.zeros((1, 2, 4), device="meta")
    k = torch.zeros((2, 8, 1, 4), device="meta")
    m = torch.ones((1, 8), dtype=torch.int32, device="meta")
    p = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_decode(q, k, k, p, m)
    q2 = torch.zeros((1, 3, 2, 4), device="meta")
    p2 = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_decode_mq(q2, k, k, p2, m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_decode_mq_trunk(q2, torch.zeros((2, 80, 1, 4), device="meta"),
                                  torch.zeros((2, 80, 1, 4), device="meta"), p2,
                                  torch.ones((1, 80), dtype=torch.int32,
                                             device="meta"), trunk_len=70)
    cascade_args = (torch.zeros((1, 2, 2, 4), device="meta"),
                    torch.zeros((1, 2, 2, 4), device="meta"),
                    torch.zeros((1, 2, 2, 4), device="meta"),
                    torch.zeros((2, 3, 4), device="meta"),
                    torch.zeros((2, 3, 4), device="meta"),
                    torch.ones((1, 2), dtype=torch.int32, device="meta"),
                    torch.ones((1, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.cascade_attention(*cascade_args)
    for int8_qk in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            ops.cascade_attention(*cascade_args, int8_qk=int8_qk,
                                  fused_suffix=False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(torch.zeros((1, 4, 2, 32), device="meta"),
                            torch.zeros((1, 4, 1, 32), device="meta"),
                            torch.zeros((1, 4, 1, 32), device="meta"))


def test_row_wrappers_refuse_non_cuda_tensors():
    """The row kernels' wrappers, the fused add and norm among them, raise
    on a tensor on neither the CPU nor a card."""
    from lir_tpu_torch import ops

    x = torch.zeros((2, 64), dtype=torch.bfloat16, device="meta")
    s = torch.zeros((64,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.row_gemm(x, torch.zeros((64, 8), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.row_norm(x, s, None, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.row_add_norm(x, x, s, s, 1e-5)


@pytest.mark.parametrize("hd", [48, 144])
def test_bf16_cascade_kernel_refuses_untiled_head_dims(hd):
    """The bf16 fused cascade runs on the tensor-core tiles, built for
    _build.TILE_HEAD_DIMS; another head dim raises before any launch (no
    float32 CUDA-core route for bf16 inputs)."""
    from lir_tpu_torch.ops import cascade_prefill

    bf = dict(dtype=torch.bfloat16, device="meta")
    ints = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="head dims"):
        cascade_prefill._cascade_cuda(
            torch.zeros((1, 2, 2, hd), **bf), torch.zeros((1, 2, 2, hd), **bf),
            torch.zeros((1, 2, 2, hd), **bf), torch.zeros((2, 3, hd), **bf),
            torch.zeros((2, 3, hd), **bf), torch.ones((1, 2), **ints),
            torch.ones((1, 2), **ints), None)


def test_int8_product_refuses_non_cuda_tensors():
    """The s8 x s8 product has the CPU's int32 matmul and the card's
    torch._int_mm, and nothing else: no float fallback."""
    from lir_tpu_torch.models.quant import int8_dot

    x = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_dot(x, torch.zeros((8, 8), dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("entry", ["init_quantized_params"])
def test_quantized_init_defaults_to_cuda(monkeypatch, entry):
    from lir_tpu_torch.models import quant, registry

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quant.init_quantized_params(registry.tiny("llama"))


@pytest.mark.parametrize("driver", ["analyze_all_models", "analyze_model",
                                    "run_model_graph_analysis",
                                    "run_kappa_analysis"])
def test_analysis_drivers_default_to_cuda(monkeypatch, tmp_path, driver):
    """The analysis drivers whose statistics run on a device resolve it
    before reading or writing anything, and never fall back to the CPU."""
    from lir_tpu_torch.analysis import kappa_combined, model_graph
    from lir_tpu_torch.analysis import perturbation
    from lir_tpu_torch.data import synthetic

    d6 = synthetic.write_synthetic_d6(tmp_path / "d6.csv")
    out = tmp_path / "out"
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if driver == "analyze_all_models":
            perturbation.analyze_all_models(d6, out, make_figures=False)
        elif driver == "analyze_model":
            perturbation.analyze_model(synthetic.synthetic_perturbation_frame(),
                                       "m", out, make_figures=False)
        elif driver == "run_model_graph_analysis":
            model_graph.run_model_graph_analysis(d6, out, make_figures=False)
        else:
            kappa_combined.run_kappa_analysis(d6, d6, out, make_figures=False)
    assert not out.exists()


@pytest.mark.parametrize("entry", [
    "run_survey_pipeline", "run_consolidated_analysis", "bootstrap_all_models",
    "bootstrap_results_payload", "analyze_family_differences",
    "run_simulated_bootstrap", "run_pvalue_analysis",
    "llm_prompt_estimates_from_accum"])
def test_survey_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """The survey's entry points whose statistics run on a device resolve
    it before reading or writing anything, and never fall back to the
    CPU."""
    from lir_tpu_torch.data import synthetic
    from lir_tpu_torch.data.table import read_table
    from lir_tpu_torch.stats import streaming
    from lir_tpu_torch import survey

    s = synthetic.write_synthetic_survey(tmp_path / "s.csv", n_respondents=30)
    d1, d2 = synthetic.write_synthetic_comparison(tmp_path / "d1.csv",
                                                  tmp_path / "d2.csv")
    df, cols = survey.load_survey(s)
    clean, stats = survey.apply_exclusions(df, cols)
    t1, t2 = read_table(d1), read_table(d2)
    detailed = survey.survey_detailed(clean, cols)
    canonical = survey.canonical_question_mapping()
    avgs = survey.human_averages_from_detailed(detailed, canonical)
    results = [{"model": "m", "model_type": "base", "mae_mean": 0.1,
                "mse_mean": 0.1, "mape_mean": 1.0},
               {"model": "n", "model_type": "instruct", "mae_mean": 0.2,
                "mse_mean": 0.2, "mape_mean": 2.0}]
    payload = {"model_results": [
        {"model": m, **{f"{k}_{s}": 0.1 for k in ("mae", "mse", "mape")
                        for s in ("mean", "std", "ci_lower", "ci_upper")}}
        for m in ("tiiuae/falcon-7b", "tiiuae/falcon-7b-instruct")]}
    acc = streaming.empty_accum(1, 4, seed=0)
    acc.filled[:] = 1
    acc.rel[:] = 0.5
    calls = {
        "run_survey_pipeline": lambda: survey.run_survey_pipeline(
            s, d2, d1, tmp_path / "out", make_figures=False),
        "run_consolidated_analysis": lambda: survey.run_consolidated_analysis(
            clean, cols, t2, canonical, stats),
        "bootstrap_all_models": lambda: survey.bootstrap_all_models(
            avgs, t2, t1),
        "bootstrap_results_payload": lambda: survey.bootstrap_results_payload(
            results),
        "analyze_family_differences":
            lambda: survey.analyze_family_differences(payload),
        "run_simulated_bootstrap": lambda: survey.run_simulated_bootstrap(
            t1, canonical, detailed),
        "run_pvalue_analysis": lambda: survey.run_pvalue_analysis(t2, t1, df),
        "llm_prompt_estimates_from_accum":
            lambda: survey.llm_prompt_estimates_from_accum(acc),
    }
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not (tmp_path / "out").exists()
