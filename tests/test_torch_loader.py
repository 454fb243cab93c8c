"""The port's checkpoint loader against the JAX package's and transformers.

Each of the eight transformers families (built as ``_hf_tiny`` builds
them, random weights from a fixed seed) is written with
``save_pretrained`` and loaded by the port without transformers or
safetensors (``models/factory.py`` reads the files itself):

- (a) ``config_from_hf`` of the parsed ``config.json`` equals the JAX
  function on ``AutoConfig.from_pretrained`` of the directory, field by
  field, also from a minimal ``config.json`` (sizes only, or the model
  type alone), which pins the port's defaults table;
- (b) the tree equals ``params_from_jax`` of the JAX converter on the
  model's own state dict, bitwise in float32, from one file, shards, a
  ``.bin``, and float16 / bfloat16 checkpoints (whose casts must be the
  JAX path's, in float32 and in bfloat16);
- (c) the port's logits are within 2e-3 of transformers' on the CPU, at
  every position (the SURVEY §7 gate ``test_model_parity`` applies to
  the JAX side).

Qwen-v1 and Baichuan have no transformers class: their native state
dicts (the ``TestQwenV1NativeNames`` construction) are made from a
transformers llama's weights, so their logits are held against it. Also
here: ``chip_smoke.py``'s safetensors writer and HF-layout export read
back by the real ``safetensors`` and ``transformers``, the reader's
dtypes, and the refusals.
"""

import dataclasses
import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.models import loader as jloader
from lir_tpu_torch.models import decoder, factory, loader
from lir_tpu_torch.models.convert import params_from_jax

from test_model_parity import FAMILIES, TINY, _hf_tiny

LOGIT_TOL = 2e-3


def _jax_tree(hf_sd, jcfg, fam, dtype=jnp.float32):
    tree = jloader.convert_decoder(hf_sd, jcfg, fam, dtype=dtype)
    return jax.tree.map(np.asarray, tree)


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _assert_config_equal(port_cfg, jax_cfg):
    assert _cfg_fields(port_cfg) == _cfg_fields(jax_cfg)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, (path, k, a[k].dtype, b[k].dtype)
            assert torch.equal(a[k], b[k]), f"{path}/{k} differs"


def _load(path, dtype=torch.float32):
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg, fam = loader.config_from_hf(hf_cfg, name=str(path))
    params = loader.convert_decoder(factory.load_state_dict(path), cfg, fam,
                                    dtype=dtype, device="cpu")
    return cfg, fam, params


def _all_position_logits(params, cfg, tokens):
    """Logits at every position: one prefill a prefix length."""
    out = []
    for s in range(1, tokens.shape[1] + 1):
        tok = torch.as_tensor(tokens[:, :s])
        logits, _, _ = decoder.prefill(params, cfg, tok, torch.ones_like(tok),
                                       max_len=s)
        out.append(logits.float())
    return torch.stack(out, dim=1).numpy()


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.as_tensor(tokens.astype(np.int64))).logits.float().numpy()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """family -> (eval model, its save_pretrained directory)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for fam in FAMILIES:
        torch.manual_seed(0)
        model = _hf_tiny(fam).eval()
        path = root / fam
        model.save_pretrained(path)
        out[fam] = (model, path)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_config_matches_jax(saved, family):
    import transformers as tf

    _, path = saved[family]
    port_cfg, port_fam = loader.config_from_hf(
        json.loads((path / "config.json").read_text()), name=str(path))
    jax_cfg, jax_fam = jloader.config_from_hf(
        tf.AutoConfig.from_pretrained(path, local_files_only=True))
    assert port_fam == jax_fam
    _assert_config_equal(port_cfg, jax_cfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_bitwise_jax_and_logits_match_transformers(saved, family):
    model, path = saved[family]
    cfg, fam, params = _load(path)
    jcfg, jfam = jloader.config_from_hf(model.config)
    ref = params_from_jax(_jax_tree(model.state_dict(), jcfg, jfam), cfg,
                          device="cpu")
    _assert_trees_equal(params, ref)

    tokens = np.random.default_rng(7).integers(
        0, TINY["vocab"], size=(2, 12)).astype(np.int32)
    np.testing.assert_allclose(_all_position_logits(params, cfg, tokens),
                               _hf_logits(model, tokens),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


_MINIMAL = {
    "gpt2": dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4),
    "bloom": dict(vocab_size=256, hidden_size=64, n_layer=2, n_head=4),
    "falcon": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4),
    "opt": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, ffn_dim=256),
}
_SIZES = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128)


@pytest.mark.parametrize("sizes", [True, False], ids=["sizes", "bare"])
@pytest.mark.parametrize("family", FAMILIES)
def test_minimal_config_takes_the_class_defaults(tmp_path, family, sizes):
    """A config.json with the model type (and the sizes) only: every other
    field the adapter reads comes from the class defaults, the port's
    table against AutoConfig's classes."""
    import transformers as tf

    cfg_json = {"model_type": family}
    if sizes:
        cfg_json.update(_MINIMAL.get(family, _SIZES))
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    port_cfg, port_fam = loader.config_from_hf(cfg_json, name=str(tmp_path))
    jax_cfg, jax_fam = jloader.config_from_hf(
        tf.AutoConfig.from_pretrained(tmp_path, local_files_only=True))
    assert port_fam == jax_fam
    _assert_config_equal(port_cfg, jax_cfg)


@pytest.mark.parametrize("form", ["sharded", "bin"])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_storage_forms_give_the_same_tree(saved, tmp_path, family, form):
    model, path = saved[family]
    _, _, ref = _load(path)
    if form == "sharded":
        model.save_pretrained(tmp_path, max_shard_size="20KB")
        assert (tmp_path / "model.safetensors.index.json").exists()
        assert len(list(tmp_path.glob("model-*.safetensors"))) > 2
    else:
        model.save_pretrained(tmp_path, safe_serialization=False)
        assert not list(tmp_path.glob("*.safetensors"))
    _, _, params = _load(tmp_path)
    _assert_trees_equal(params, ref)


@pytest.mark.parametrize("stored", [torch.float16, torch.bfloat16],
                         ids=["fp16", "bf16"])
@pytest.mark.parametrize("family", ["llama", "bloom"])
def test_half_checkpoints_cast_as_the_jax_path(saved, tmp_path, family, stored):
    """A float16 / bfloat16 checkpoint, sharded, loaded to float32 and to
    bfloat16: bitwise the JAX converter's casts of the same tensors."""
    model, _ = saved[family]
    half = _hf_tiny(family).to(stored).eval()
    half.load_state_dict({k: v.to(stored) for k, v in model.state_dict().items()})
    half.save_pretrained(tmp_path, max_shard_size="20KB")
    jcfg, jfam = jloader.config_from_hf(half.config)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        cfg, _, params = _load(tmp_path, dtype)
        ref = params_from_jax(_jax_tree(half.state_dict(), jcfg, jfam, jdtype),
                              cfg, device="cpu")
        _assert_trees_equal(params, ref)


# ---------------------------------------------------------------------------
# Qwen-v1 and Baichuan: native names, no transformers class
# ---------------------------------------------------------------------------

def _tiny_llama(attention_bias: bool):
    import transformers as tf

    torch.manual_seed(3)
    model = tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        attention_bias=attention_bias, tie_word_embeddings=False)).eval()
    if attention_bias:
        with torch.no_grad():
            for layer in model.model.layers:
                layer.self_attn.o_proj.bias.zero_()   # Qwen-v1's c_proj has none
    return model


def _native(family, llama_sd, L=2):
    """Qwen-v1 / Baichuan native state dict of a llama's weights."""
    g = llama_sd
    if family == "qwen":
        sd = {"transformer.wte.weight": g["model.embed_tokens.weight"],
              "transformer.ln_f.weight": g["model.norm.weight"],
              "lm_head.weight": g["lm_head.weight"]}
    else:
        sd = {"model.embed_tokens.weight": g["model.embed_tokens.weight"],
              "model.norm.weight": g["model.norm.weight"],
              "lm_head.weight": g["lm_head.weight"]}
    for i in range(L):
        q = f"model.layers.{i}."
        qkv = torch.cat([g[q + f"self_attn.{n}_proj.weight"] for n in "qkv"])
        if family == "qwen":
            p = f"transformer.h.{i}."
            sd[p + "ln_1.weight"] = g[q + "input_layernorm.weight"]
            sd[p + "attn.c_attn.weight"] = qkv
            sd[p + "attn.c_attn.bias"] = torch.cat(
                [g[q + f"self_attn.{n}_proj.bias"] for n in "qkv"])
            sd[p + "attn.c_proj.weight"] = g[q + "self_attn.o_proj.weight"]
            sd[p + "ln_2.weight"] = g[q + "post_attention_layernorm.weight"]
            sd[p + "mlp.w1.weight"] = g[q + "mlp.up_proj.weight"]
            sd[p + "mlp.w2.weight"] = g[q + "mlp.gate_proj.weight"]
            sd[p + "mlp.c_proj.weight"] = g[q + "mlp.down_proj.weight"]
        else:
            p = f"model.layers.{i}."
            for n in ("input_layernorm", "post_attention_layernorm",
                      "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                      "mlp.down_proj"):
                sd[p + n + ".weight"] = g[q + n + ".weight"]
            sd[p + "self_attn.W_pack.weight"] = qkv
    return {k: v.contiguous() for k, v in sd.items()}


_NATIVE_CONFIGS = {
    "qwen": dict(model_type="qwen", vocab_size=128, hidden_size=32,
                 num_hidden_layers=2, num_attention_heads=4, seq_length=64,
                 intermediate_size=96, layer_norm_epsilon=1e-6,
                 rotary_emb_base=10000.0, no_bias=True),
    "baichuan": dict(model_type="baichuan", vocab_size=128, hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=4,
                     max_position_embeddings=64, intermediate_size=48,
                     rms_norm_eps=1e-6),
}


@pytest.mark.parametrize("family", ["qwen", "baichuan"])
def test_native_qwen_v1_and_baichuan(tmp_path, family):
    from safetensors.torch import save_file

    llama = _tiny_llama(attention_bias=(family == "qwen"))
    native = _native(family, llama.state_dict())
    save_file(native, str(tmp_path / "model.safetensors"))
    cfg_json = _NATIVE_CONFIGS[family]
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))

    cfg, fam, params = _load(tmp_path)
    jcfg, jfam = jloader.config_from_hf(
        SimpleNamespace(**cfg_json, name_or_path=str(tmp_path)))
    assert fam == jfam == family
    _assert_config_equal(cfg, jcfg)
    np_sd = {k: v.numpy() for k, v in native.items()}
    ref = params_from_jax(_jax_tree(np_sd, jcfg, jfam), cfg, device="cpu")
    _assert_trees_equal(params, ref)

    tokens = np.random.default_rng(5).integers(0, 128, (2, 10)).astype(np.int32)
    np.testing.assert_allclose(_all_position_logits(params, cfg, tokens),
                               _hf_logits(llama, tokens),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_qwen_v1_llama_format_names_take_the_llama_mapping(tmp_path):
    """A Qwen-v1 checkpoint already renamed to llama names ("qwen_llama")
    gives the native checkpoint's tree."""
    llama = _tiny_llama(attention_bias=True)
    native = _native("qwen", llama.state_dict())
    cfg, _ = loader.config_from_hf(_NATIVE_CONFIGS["qwen"])
    renamed = {k: v for k, v in llama.state_dict().items()
               if "o_proj.bias" not in k}
    _assert_trees_equal(
        loader.convert_decoder(renamed, cfg, "qwen", device="cpu"),
        loader.convert_decoder(native, cfg, "qwen", device="cpu"))


# ---------------------------------------------------------------------------
# The reader, the refusals
# ---------------------------------------------------------------------------

def test_reader_decodes_the_safetensors_dtypes(tmp_path):
    """Every dtype the reader decodes comes back bitwise as the real
    reader gives it; another dtype raises only when its key is asked for."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((7,), generator=g).half(),
        "bf16": torch.randn((2, 3, 4), generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (3, 3), generator=g, dtype=torch.uint8),
        "bool": torch.rand((5,), generator=g) > 0.5,
        "i32": torch.randint(-2**31, 2**31 - 1, (4,), generator=g,
                             dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (2, 2), generator=g,
                             dtype=torch.int64),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 4)),
        "f64": torch.randn((3,), generator=g, dtype=torch.float64),
    }
    path = tmp_path / "model.safetensors"
    save_file(tensors, str(path))
    sd = factory.load_state_dict(tmp_path)
    assert set(sd) == set(tensors)
    with safe_open(str(path), framework="pt") as f:
        for key in tensors:
            if key == "f64":
                continue
            got, want = sd[key], f.get_tensor(key)
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert torch.equal(got, want), key
    with pytest.raises(TypeError, match="F64"):
        sd["f64"]


def test_encoder_decoder_checkpoint_is_refused(tmp_path):
    """An encoder-decoder directory takes the T5 route (its loading is
    held in tests/test_torch_t5.py): one without weights is refused for
    them, not through the decoder's mapping."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "t5", "is_encoder_decoder": True, "d_model": 64}))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        factory.load_engine(tmp_path, tokenizer=object(), device="cpu")
    assert factory.is_encoder_decoder("google/flan-t5-base")
    assert factory.is_encoder_decoder("ckpt", {"model_type": "t5"})
    assert not factory.is_encoder_decoder("meta-llama/Llama-2-7b-hf",
                                          {"model_type": "llama"})


def test_missing_transformers_asks_for_a_tokenizer(saved, monkeypatch):
    _, path = saved["llama"]
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="tokenizer="):
        factory.load_engine(path, device="cpu")


def test_loaded_engine_defaults(saved):
    """float32 on the CPU, the config's name is the directory, and the
    tokenizer comes from the directory (AutoTokenizer) or the caller."""
    from lir_tpu_torch.backends.fake import FakeTokenizer

    _, path = saved["llama"]
    tok = FakeTokenizer(vocab=TINY["vocab"])
    eng = factory.load_engine(path, tokenizer=tok, device="cpu")
    assert eng.tokenizer is tok
    assert eng.cfg.name == str(path)
    assert eng.params["layers"]["wq"].dtype == torch.float32
    int8 = factory.load_engine(path, tokenizer=tok, device="cpu",
                               quantize_int8=True, int8_dynamic=True)
    assert int8.params["layers"]["wq"].q.dtype == torch.int8
    assert int8.params["layers"]["wq"].dynamic


# ---------------------------------------------------------------------------
# chip_smoke's checkpoint writer, read back by the real libraries
# ---------------------------------------------------------------------------

def test_chip_smoke_export_reads_back_in_safetensors_and_transformers(tmp_path):
    import transformers as tf
    from safetensors import safe_open

    import chip_smoke
    from lir_tpu_torch.models import registry

    cfg = dataclasses.replace(registry.tiny("llama"), name="tiny-llama")
    params = decoder.init_params(cfg, seed=4, device="cpu")
    g = torch.Generator().manual_seed(5)
    for norm in ("ln1", "ln2"):            # norms other than ones
        params["layers"][norm]["scale"].add_(
            0.1 * torch.randn(params["layers"][norm]["scale"].shape, generator=g))
    files = chip_smoke.export_hf_llama(params, cfg, tmp_path)
    assert len(files) == 2
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    want = chip_smoke.hf_llama_tensors(params, cfg)
    assert set(index["weight_map"]) == set(want)
    for name, shard in index["weight_map"].items():
        with safe_open(str(tmp_path / shard), framework="pt") as f:
            got = f.get_tensor(name)
        assert got.dtype == torch.float16
        assert torch.equal(got, want[name].half()), name

    hf = tf.LlamaForCausalLM.from_pretrained(tmp_path, torch_dtype=torch.float32,
                                             local_files_only=True).eval()
    _, _, loaded = _load(tmp_path)
    half = {k: v for k, v in chip_smoke.leaves(params)}
    for path, leaf in chip_smoke.leaves(loaded):
        assert torch.equal(leaf, half[path].half().float()), path
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 8))
    np.testing.assert_allclose(
        _all_position_logits(loaded, cfg, tokens.astype(np.int32)),
        _hf_logits(hf, tokens), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    port_cfg, _ = loader.config_from_hf(
        json.loads((tmp_path / "config.json").read_text()), name=cfg.name)
    assert port_cfg == cfg
