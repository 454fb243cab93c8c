"""The port's T5 encoder-decoder branch against the JAX package.

The same weights (JAX ``encdec.init_params`` trees or tiny HF checkpoints
from ``tools/tiny_checkpoints.py``) go through both packages on the CPU
in float32:

- ``_relative_bucket`` exact over rel in [-4096, 4096], both directions,
  at (32, 128) and (8, 20) buckets and max distance;
- ``encode`` / ``decode`` / ``forward`` within 1e-5 (gated untied and
  ReLU tied, left-padded masks); ``t5_greedy_decode`` ids exact, step
  logits within 1e-5; the decoder capture path ``greedy_decode`` ids
  exact, logits within 1e-5 (the JAX decode step on its dense path, the
  Pallas kernel's plain reference on the CPU);
- ``readout_from_step_logits`` on crafted logits: ints exact, floats
  within 1e-6;
- ``quantize_encdec_params`` bitwise (static and dynamic); the int8
  forward against JAX's within 1e-5 and against the dense forward at
  ``tests/test_quant.py``'s bars;
- ``t5_config_from_hf`` of a parsed ``config.json`` field by field
  against the JAX function on ``AutoConfig``, ``convert_t5`` leaf for
  leaf from the state dict and from the saved safetensors;
- ``load_engine(device="cpu")`` on the ``sp-t5`` / ``chain-t5-*``
  checkpoints against the JAX engine and the executed reference's golden
  (``test_reference_scorer_oracle``'s bars);
- the model-comparison sweep over a T5 base/instruct pair against the
  JAX sweep, the ``sweep`` command against the library call, the model
  graph over its D2, and a T5 engine in the perturbation sweep raising in
  both packages (ROADMAP caveat R7).

The JAX engines' compiled decodes are shared: one T5 shape per engine
config, built once per module.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LEGAL_PROMPTS as JAX_LEGAL
from lir_tpu.engine import generate as jgen, multi as jmulti, score as jscore
from lir_tpu.engine import sweep as jsweep
from lir_tpu.models import decoder as jdec, encdec as jenc, factory as jfactory
from lir_tpu.models import loader as jloader, quant as jquant
from lir_tpu.models import registry as jreg
from lir_tpu_torch import cli
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LEGAL_PROMPTS, WORD_MEANING_QUESTIONS
from lir_tpu_torch.engine import generate, multi, score, sweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import encdec, factory, loader, quant, registry
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.quant import QuantTensor

from test_reference_scorer_oracle import GOLDEN_PATH, _diff_case

FTOL = 1e-5
# Larger weights than the 0.02 init, so that the logits of the tiny
# models spread out and no two candidate tokens sit within float noise
# (the tied head's d_model^-0.5 rescale takes the larger factor).
WEIGHT_SCALE = {"gated_untied": 5.0, "relu_tied": 12.0}
NORMS = {"ln_attn", "ln_mlp", "ln_cross", "enc_final_ln", "dec_final_ln"}
TINY = dict(vocab_size=97, hidden_size=32, n_layers=2, n_heads=4, head_dim=8,
            intermediate_size=48, relative_attention_num_buckets=8,
            relative_attention_max_distance=20)
KINDS = {"gated_untied": dict(gated_mlp=True, tie_embeddings=False),
         "relu_tied": dict(gated_mlp=False, tie_embeddings=True,
                           activation="relu")}
RT = dict(batch_size=4, max_new_tokens=12, max_seq_len=256)
BASE, CHAT = "tiny/t5-base", "tiny/flan-t5-base"
QUESTIONS = list(WORD_MEANING_QUESTIONS[:4])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops are too small to share out: on a host loaded
    by other test workers, torch's intra-op thread team makes them many
    times slower. The module runs on one thread and gives the count
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale(tree, factor):
    """Every matrix and embedding times ``factor``, norms unchanged."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scale(v, factor)
        else:
            out[k] = v if k in NORMS else v * factor
    return out


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX cfg, JAX tree as numpy, port cfg, port params)."""
    out = {}
    for i, (kind, kw) in enumerate(sorted(KINDS.items())):
        jcfg = jreg.T5Config(name=f"t5-{kind}", **TINY, **kw)
        tcfg = registry.T5Config(name=f"t5-{kind}", **TINY, **kw)
        tree = _scale(jax.tree.map(np.asarray, jenc.init_params(
            jcfg, jax.random.PRNGKey(i))), WEIGHT_SCALE[kind])
        out[kind] = (jcfg, tree, tcfg, params_from_jax(tree, tcfg,
                                                       device="cpu"))
    return out


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _inputs(seed=0, vocab=97):
    """Left-padded encoder tokens and a right-masked decoder buffer."""
    rng = np.random.default_rng(seed)
    enc = rng.integers(0, vocab, (3, 9)).astype(np.int32)
    emask = np.ones((3, 9), np.int32)
    emask[0, :4] = 0
    emask[1, :1] = 0
    dec = rng.integers(0, vocab, (3, 6)).astype(np.int32)
    dmask = np.ones((3, 6), np.int32)
    dmask[2, 4:] = 0
    return enc, emask, dec, dmask


# ---------------------------------------------------------------------------
# The model's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bucket_exact(buckets, max_distance, bidirectional):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(jenc._relative_bucket(jnp.asarray(rel), bidirectional,
                                           buckets, max_distance))
    got = encdec._relative_bucket(torch.from_numpy(rel), bidirectional,
                                  buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_encode_decode_forward_match_jax(models, kind):
    jcfg, tree, tcfg, params = models[kind]
    enc, emask, dec, dmask = _inputs()
    jp = _jtree(tree)
    j_enc = jenc.encode(jp, jcfg, jnp.asarray(enc), jnp.asarray(emask))
    t_enc = encdec.encode(params, tcfg, torch.from_numpy(enc),
                          torch.from_numpy(emask))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=FTOL,
                               rtol=0)
    j_dec = jenc.decode(jp, jcfg, j_enc, jnp.asarray(emask), jnp.asarray(dec),
                        jnp.asarray(dmask))
    t_dec = encdec.decode(params, tcfg, t_enc, torch.from_numpy(emask),
                          torch.from_numpy(dec), torch.from_numpy(dmask))
    assert t_dec.dtype == torch.float32
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=FTOL,
                               rtol=0)
    t_fwd = encdec.forward(params, tcfg, torch.from_numpy(enc),
                           torch.from_numpy(emask), torch.from_numpy(dec),
                           torch.from_numpy(dmask))
    np.testing.assert_array_equal(t_fwd.numpy(), t_dec.numpy())
    # The spread the tolerance is judged against.
    assert np.ptp(np.asarray(j_dec)) > 1.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_t5_greedy_decode_matches_jax(models, kind):
    jcfg, tree, tcfg, params = models[kind]
    enc, emask, _, _ = _inputs(1)
    jg, jl = jgen.t5_greedy_decode(_jtree(tree), jcfg, jnp.asarray(enc),
                                   jnp.asarray(emask), max_new_tokens=6)
    tg, tl = generate.t5_greedy_decode(params, tcfg, torch.from_numpy(enc),
                                       torch.from_numpy(emask),
                                       max_new_tokens=6)
    assert tg.dtype == torch.int32 and tuple(tl.shape) == (3, 6, 97)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FTOL, rtol=0)


def test_decoder_capture_path_matches_jax():
    """``greedy_decode`` and a decoder engine's ``decode_prompts`` (the
    flash-decode route on the card) against the JAX capture path."""
    kw = dict(name="capture-tiny", vocab_size=FakeTokenizer.VOCAB,
              hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
              intermediate_size=128, max_seq_len=512)
    jcfg, tcfg = jreg.ModelConfig(**kw), registry.ModelConfig(**kw)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    tree = {k: ({n: (a * 4.0 if n.startswith("w") else a)
                 for n, a in v.items()} if k == "layers" else
                (v * 4.0 if k in ("tok_embed", "lm_head") else v))
            for k, v in tree.items()}
    params = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(3, 900, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[0, :5] = 0
    mask[2, :2] = 0
    jg, jl = jgen.greedy_decode(_jtree(tree), jcfg, jnp.asarray(toks),
                                jnp.asarray(mask), max_new_tokens=5)
    teng = ScoringEngine(params, tcfg, FakeTokenizer(),
                         RuntimeConfig(max_new_tokens=5), device="cpu")
    tg, tl = generate.greedy_decode(params, teng.cfg, torch.from_numpy(toks),
                                    torch.from_numpy(mask), max_new_tokens=5)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FTOL, rtol=0)
    prompts = ["a b c d", "Is a tomato a vegetable ? Yes"]
    eg, el = teng.decode_prompts(prompts)
    toks2, mask2 = teng._pad_batch(prompts)
    g2, l2 = generate.greedy_decode(params, teng.cfg, toks2, mask2,
                                    max_new_tokens=5)
    assert torch.equal(eg, g2) and torch.equal(el, l2)


def _crafted_logits():
    """(4, 12, 16) logits: row 0 finds yes at position 0; row 1 no as the
    runner-up at position 3; row 2 never (fallback to 0); row 3 has yes
    and no at -inf everywhere (P = 0, relative_prob NaN)."""
    rng = np.random.default_rng(6)
    lg = rng.standard_normal((4, 12, 16)).astype(np.float32)
    yes, no = 5, 9
    lg[:, :, yes] = -8.0
    lg[:, :, no] = -8.0
    lg[0, 0, yes] = 9.0
    lg[1, 3, 2] = 9.0
    lg[1, 3, no] = 8.0
    lg[3, :, yes] = -np.inf
    lg[3, :, no] = -np.inf
    gen = np.argmax(lg, -1).astype(np.int32)
    return lg, gen, yes, no


@pytest.mark.parametrize("scan", [10, 3])
def test_readout_from_step_logits_matches_jax(scan):
    lg, gen, yes, no = _crafted_logits()
    ref = jscore.readout_from_step_logits(jnp.asarray(lg), jnp.asarray(gen),
                                          jnp.int32(yes), jnp.int32(no),
                                          scan_positions=scan)
    got = score.readout_from_step_logits(torch.from_numpy(lg),
                                         torch.from_numpy(gen), yes, no,
                                         scan_positions=scan)
    want_pos = [0, 3 if scan > 3 else 0, 0, 0]
    np.testing.assert_array_equal(np.asarray(ref.position_found), want_pos)
    for f in ("position_found", "yes_no_found", "generated"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("yes_prob", "no_prob", "yes_logprob", "no_logprob",
              "odds_ratio", "relative_prob"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-6,
                                   rtol=1e-6, err_msg=f)
    assert math.isnan(float(got.relative_prob[3]))


# ---------------------------------------------------------------------------
# int8 trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dynamic", [False, True])
def test_quantize_encdec_bitwise_and_forward(models, dynamic):
    jcfg, tree, tcfg, params = models["gated_untied"]
    jq = jax.tree.map(np.asarray, jquant.quantize_encdec_params(
        _jtree(tree), dynamic=dynamic))
    tq = quant.quantize_encdec_params(params, dynamic=dynamic)
    for side in ("encoder", "decoder"):
        for name, leaf in tq[side].items():
            ref = jq[side][name]
            if name in quant.ENCDEC_MATRICES:
                assert isinstance(leaf, QuantTensor) and leaf.dynamic == dynamic
                np.testing.assert_array_equal(leaf.q.numpy(), ref.q)
                np.testing.assert_array_equal(leaf.scale.numpy(), ref.scale)
            else:
                np.testing.assert_array_equal(leaf.numpy(), ref)
    assert not tq["lm_head"].dynamic
    np.testing.assert_array_equal(tq["lm_head"].q.numpy(), jq["lm_head"].q)
    assert tq["shared_embed"] is params["shared_embed"]
    # The JAX tree converts to the same port tree.
    conv = params_from_jax(jq, tcfg, device="cpu")
    assert torch.equal(conv["decoder"]["co"].q, tq["decoder"]["co"].q)

    enc, emask, dec, dmask = _inputs(2)
    jl = np.asarray(jenc.forward(_jtree(jq), jcfg, jnp.asarray(enc),
                                 jnp.asarray(emask), jnp.asarray(dec),
                                 jnp.asarray(dmask)))
    args = (torch.from_numpy(enc), torch.from_numpy(emask),
            torch.from_numpy(dec), torch.from_numpy(dmask))
    tl = encdec.forward(tq, tcfg, *args).numpy()
    np.testing.assert_allclose(tl, jl, atol=FTOL, rtol=0)
    # Against the dense forward: tests/test_quant.py's bars.
    dense = torch.softmax(encdec.forward(params, tcfg, *args), -1).numpy()
    pq = torch.softmax(torch.from_numpy(tl), -1).numpy()
    np.testing.assert_allclose(pq, dense, atol=8e-2)
    rel_d = dense[..., 5] / (dense[..., 5] + dense[..., 9] + 1e-12)
    rel_q = pq[..., 5] / (pq[..., 5] + pq[..., 9] + 1e-12)
    np.testing.assert_allclose(rel_q, rel_d, atol=5e-2)
    assert quant.param_bytes(tq) < 0.55 * quant.param_bytes(params)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """sp-t5 as the base model (and, through a symlink, the instruct one),
    the two chain T5s for the golden's scan positions."""
    from tiny_checkpoints import build_chain_t5, build_sp_t5

    root = tmp_path_factory.mktemp("t5_ckpts")
    _, model, _ = build_sp_t5(root / BASE.replace("/", "__"))
    os.symlink(root / BASE.replace("/", "__"), root / CHAT.replace("/", "__"))
    build_chain_t5(root / "chain-t5-pos2")
    build_chain_t5(root / "chain-t5-never", never=True)
    return root, model


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


V10 = {"model_type": "t5", "vocab_size": 64, "d_model": 32, "d_kv": 8,
       "d_ff": 48, "num_layers": 2, "num_heads": 4,
       "decoder_start_token_id": 0}


@pytest.mark.parametrize("form", ["saved", "v1_0_minimal"])
def test_t5_config_from_hf_matches_jax(ckpt_root, tmp_path, form):
    import transformers as tf

    if form == "saved":
        path = ckpt_root[0] / BASE.replace("/", "__")
    else:
        path = tmp_path / "t5-v1_0"
        path.mkdir()
        (path / "config.json").write_text(json.dumps(V10))
    raw = json.loads((path / "config.json").read_text())
    ref = jloader.t5_config_from_hf(tf.AutoConfig.from_pretrained(
        path, local_files_only=True))
    got = loader.t5_config_from_hf(raw, name=str(path))
    assert _fields(got) == _fields(ref)
    assert factory.is_encoder_decoder(path.name, raw)
    if form == "v1_0_minimal":
        assert (got.gated_mlp, got.activation, got.tie_embeddings,
                got.relative_attention_max_distance) == (False, "relu", True,
                                                         128)


def test_convert_t5_matches_jax(ckpt_root):
    root, model = ckpt_root
    cfg_j = jloader.t5_config_from_hf(model.config)
    cfg_t = loader.t5_config_from_hf(model.config)
    assert _fields(cfg_t) == _fields(cfg_j)
    ref = jax.tree.map(np.asarray, jloader.convert_t5(model.state_dict(),
                                                      cfg_j))
    saved = factory.load_state_dict(root / BASE.replace("/", "__"))
    assert "encoder.embed_tokens.weight" not in saved
    for sd in (model.state_dict(), saved):
        got = loader.convert_t5(sd, cfg_t, device="cpu")
        assert set(got) == set(ref)
        for key, node in got.items():
            if isinstance(node, dict):
                assert set(node) == set(ref[key])
                for name, t in node.items():
                    np.testing.assert_array_equal(t.numpy(), ref[key][name])
            else:
                np.testing.assert_array_equal(node.numpy(), ref[key])
    bf = loader.convert_t5(saved, cfg_t, dtype=torch.bfloat16, device="cpu")
    ref_bf = jloader.convert_t5(model.state_dict(), cfg_j, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        bf["decoder"]["cv"].float().numpy(),
        np.asarray(ref_bf["decoder"]["cv"]).astype(np.float32))


def _golden(key):
    return json.loads(GOLDEN_PATH.read_text())["scorer_oracle"][key]


def _close(field, got, want):
    """FTOL absolute; the odds ratio, a ratio of two probabilities (34.5
    on sp-t5's first golden prompt, where a float32 ulp is 3.8e-6),
    FTOL relative."""
    if field == "odds_ratio":
        np.testing.assert_allclose(got, want, rtol=FTOL, atol=0, err_msg=field)
    else:
        np.testing.assert_allclose(got, want, atol=FTOL, rtol=0, err_msg=field)


def _same_rows(a, b):
    """JAX PromptScores against the port's: discrete fields and text
    exact, floats as :func:`_close`."""
    for ra, rb in zip(a, b, strict=True):
        assert (ra.prompt, ra.completion, ra.position_found,
                ra.yes_no_found) == (rb.prompt, rb.completion,
                                     rb.position_found, rb.yes_no_found)
        for f in ("yes_prob", "no_prob", "relative_prob", "odds_ratio"):
            _close(f, getattr(rb, f), getattr(ra, f))


def test_load_engine_matches_jax_and_golden(ckpt_root):
    root, _ = ckpt_root
    group = _golden("sp-t5")
    prompts = [c["prompt"] for c in group["cases"]]
    path = root / BASE.replace("/", "__")
    teng = factory.load_engine(path, RuntimeConfig(**RT), device="cpu")
    assert teng.encoder_decoder and isinstance(teng.cfg, registry.T5Config)
    assert (teng.yes_id, teng.no_id) == (group["yes_id"], group["no_id"])
    assert not teng.spec_supported() and not teng.cascade_supported()
    teng.enable_prefix_cache()
    assert teng.prefix_cache is None
    rows = teng.score_prompts(prompts)
    jeng = jfactory.load_engine(path, JaxRuntimeConfig(**RT))
    _same_rows(jeng.score_prompts(prompts), rows)
    for row, case in zip(rows, group["cases"]):
        _diff_case(row, case["ref_cbvi"])
        _diff_case(row, case["ref_cim"])
    # The capture path's ids are the completion's.
    gen, steps = teng.decode_prompts(prompts)
    assert steps.shape[:2] == gen.shape and steps.dtype == torch.float32
    with pytest.raises(ValueError, match="decoder-only"):
        teng.decode_fused(prompts, np.zeros(3, np.int32),
                          np.zeros(3, np.int32))


@pytest.mark.parametrize("key", ["chain-t5-pos2", "chain-t5-never"])
def test_chain_t5_pins_scan_positions(ckpt_root, key):
    """The executed reference's outcome (found at 2, or never: the
    position-0 fallback), completions exact."""
    group = _golden(key)
    eng = factory.load_engine(ckpt_root[0] / key, RuntimeConfig(**RT),
                              device="cpu")
    rows = eng.score_prompts([c["prompt"] for c in group["cases"]])
    for row, case in zip(rows, group["cases"]):
        assert [row.position_found, row.yes_no_found] == group["designed"]
        _diff_case(row, case["ref_cbvi"], check_completion=key.endswith("pos2"))
        _diff_case(row, case["ref_cim"], check_completion=key.endswith("pos2"))


def test_int8_load_is_quantize_encdec_params(ckpt_root):
    path = ckpt_root[0] / BASE.replace("/", "__")
    dense = factory.load_engine(path, RuntimeConfig(**RT), device="cpu")
    q8 = factory.load_engine(path, RuntimeConfig(**RT), quantize_int8=True,
                             int8_dynamic=True, device="cpu")
    want = quant.quantize_encdec_params(dense.params, dynamic=True)
    for side in ("encoder", "decoder"):
        for name, leaf in want[side].items():
            got = q8.params[side][name]
            if isinstance(leaf, QuantTensor):
                assert got.dynamic and torch.equal(got.q, leaf.q)
                assert torch.equal(got.scale, leaf.scale)
            else:
                assert torch.equal(got, leaf)
    rows = q8.score_prompts(QUESTIONS)
    assert all(0.0 <= r.yes_prob <= 1.0 for r in rows)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

SPECS = [(BASE, "base"), (CHAT, "instruct")]
TEXT = ("prompt", "model", "model_family", "base_or_instruct", "model_output")


@pytest.fixture(scope="module")
def sweeps(ckpt_root, tmp_path_factory):
    root, _ = ckpt_root
    out = tmp_path_factory.mktemp("t5_sweeps")
    jart = jmulti.run_model_comparison_sweep(
        [jmulti.ModelSpec(*s) for s in SPECS],
        jfactory.engine_factory(root, JaxRuntimeConfig(**RT)),
        out / "jax", questions=QUESTIONS)
    tart = multi.run_model_comparison_sweep(
        [multi.ModelSpec(*s) for s in SPECS],
        factory.engine_factory(root, RuntimeConfig(**RT), device="cpu"),
        out / "torch", questions=QUESTIONS)
    return out, jart, tart


@pytest.mark.parametrize("name", ["model_comparison_results.csv",
                                  "instruct_model_comparison_results.csv"])
def test_model_comparison_sweep_matches_jax(sweeps, name):
    out, jart, tart = sweeps
    port = pd.read_csv(out / "torch" / name)
    ref = pd.read_csv(out / "jax" / name)
    assert list(port.columns) == list(ref.columns)
    assert len(port) == len(ref) == len(QUESTIONS) * (
        2 if name.startswith("model") else 1)
    for col in port.columns:
        if col in TEXT:
            assert port[col].tolist() == ref[col].tolist(), col
        else:
            a, b = port[col].to_numpy(float), ref[col].to_numpy(float)
            assert np.isfinite(a).all(), col
            _close(col, a, b)
    per = tart["per_model"]
    assert {k: v["status"] for k, v in per.items()} == {
        k: v["status"] for k, v in jart["per_model"].items()}
    assert all(v["status"] == "ok" for v in per.values())


def test_sweep_command_and_model_graph(ckpt_root, monkeypatch, tmp_path):
    """The ``sweep`` command on the T5 pair writes the library call's
    bytes, and ``analyze``'s model graph over its D2 runs to its end.
    The command sweeps every word-meaning question; QUESTIONS keep the
    decodes few on the CPU."""
    root, _ = ckpt_root
    library = multi.run_model_comparison_sweep
    monkeypatch.setattr(multi, "run_model_comparison_sweep",
                        functools.partial(library, questions=QUESTIONS))
    cli.main(["sweep", "--checkpoints", str(root), "--models",
              f"{BASE}:base", CHAT, "--out", str(tmp_path / "cli"),
              "--batch-size", "32", "--device", "cpu"])
    library([multi.ModelSpec(*s) for s in SPECS],
            factory.engine_factory(root, RuntimeConfig(batch_size=32),
                                   device="cpu"),
            tmp_path / "lib", questions=QUESTIONS)
    for name in ("model_comparison_results.csv",
                 "instruct_model_comparison_results.csv"):
        got = (tmp_path / "cli" / name).read_bytes()
        assert got == (tmp_path / "lib" / name).read_bytes(), name
    d2 = tmp_path / "cli" / "instruct_model_comparison_results.csv"
    assert len(pd.read_csv(d2)) == len(QUESTIONS)
    cli.main(["analyze", "--instruct-csv", str(d2), "--no-figures", "--out",
              str(tmp_path / "analysis"), "--device", "cpu"])
    kappa = pd.read_csv(tmp_path / "analysis" / "model_graph"
                        / "model_pairwise_kappa_matrix.csv")
    assert list(kappa.columns)[1:] == [CHAT]


def test_t5_engine_in_perturbation_sweep_raises_in_both(ckpt_root, tmp_path):
    """ROADMAP caveat R7: a T5 engine's first dispatch of the perturbation
    sweep is the decoder-only shared dispatch, in both packages; the port
    raises before a row is written."""
    path = ckpt_root[0] / BASE.replace("/", "__")
    perts = [["Is it covered?"]] * len(LEGAL_PROMPTS)
    jeng = jfactory.load_engine(path, JaxRuntimeConfig(**RT))
    with pytest.raises(AssertionError):
        jsweep.run_perturbation_sweep(jeng, "t5", JAX_LEGAL[:1], perts[:1],
                                      tmp_path / "jax.csv")
    teng = factory.load_engine(path, RuntimeConfig(**RT), device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        sweep.run_perturbation_sweep(teng, "t5", LEGAL_PROMPTS[:1],
                                     perts[:1], tmp_path / "torch.csv")
    assert teng.stream_sink is None
    assert not (tmp_path / "torch.csv").exists()


def test_t5_engine_checks_its_tree(models):
    """An encoder-decoder engine reads its device from ``shared_embed``;
    ``params_from_jax`` refuses a tree of the other shape or depth."""
    jcfg, tree, tcfg, params = models["relu_tied"]
    eng = ScoringEngine(params, tcfg, FakeTokenizer(vocab=97),
                        RuntimeConfig(max_new_tokens=3), device="cpu",
                        encoder_decoder=True)
    assert eng.cfg is tcfg
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(tcfg, tie_embeddings=False),
                        device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        params_from_jax(tree, dataclasses.replace(tcfg, n_layers=3),
                        device="cpu")


def test_chip_smoke_t5_export_reads_back_in_transformers(tmp_path):
    """``chip_smoke.py``'s T5 checkpoint (HF key names, flan-t5-base's
    config fields, fp16 by its own writer) is a real HF T5: transformers
    loads it and its logits are the port's on the fp16-rounded weights;
    ``load_engine`` gives those weights back leaf for leaf."""
    import chip_smoke
    import transformers as tf

    cfg = registry.T5Config(name="t5-export", vocab_size=64, hidden_size=32,
                            n_layers=2, n_heads=4, head_dim=8,
                            intermediate_size=48)
    params = chip_smoke.t5_params(cfg, seed=1, device="cpu",
                                  dtype=torch.float32)
    chip_smoke.export_hf_t5(params, cfg, tmp_path / "t5")
    half = {k: ({n: t.half().float() for n, t in v.items()}
                if isinstance(v, dict) else v.half().float())
            for k, v in params.items()}
    hf = tf.T5ForConditionalGeneration.from_pretrained(
        tmp_path / "t5", local_files_only=True).eval()
    enc, emask, dec, dmask = _inputs(7, vocab=64)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(enc).long(),
                 attention_mask=torch.from_numpy(emask).long(),
                 decoder_input_ids=torch.from_numpy(dec).long()).logits
    got = encdec.forward(half, cfg, torch.from_numpy(enc),
                         torch.from_numpy(emask), torch.from_numpy(dec))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=FTOL, rtol=0)
    eng = factory.load_engine(tmp_path / "t5", RuntimeConfig(**RT),
                              tokenizer=FakeTokenizer(vocab=64), device="cpu")
    want = dict(chip_smoke.leaves(half))
    for path, leaf in chip_smoke.leaves(eng.params):
        assert torch.equal(leaf, want[path]), path
