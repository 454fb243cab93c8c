"""HF checkpoint -> the port's parameter tree.

Port of ``lir_tpu/models/loader.py``. The same
per-family mappings take an HF state dict straight into the stacked
layer tree that ``models/decoder.py`` consumes, on the target device:

- Every stacked leaf is allocated ONCE, on the device, in the target
  dtype; each layer's tensor moves from the state dict (a memory map of
  the checkpoint, see ``models/factory.py``) to the device in its stored
  dtype, and is split, transposed and cast there into its slot. No
  second host copy of the checkpoint is ever made.
- The casts give the JAX path's bits: a float16 or bfloat16 checkpoint
  widens exactly to float32 and rounds to nearest-even into the target
  dtype, as ``_np`` then ``jnp.asarray(dtype=...)`` do in the JAX
  package.
- Conventions are the JAX package's: projections are (in, out), torch
  ``nn.Linear`` is (out, in) and is transposed, GPT-2's ``Conv1D`` is
  already (in, out); fused QKV layouts are de-interleaved per family.

``config_from_hf`` reads a parsed ``config.json`` (a mapping) or a
config object; for a mapping, every key the mapping leaves out takes the
default of the transformers config class for its model type
(``_HF_DEFAULTS``), so the result equals the JAX function's on
``AutoConfig.from_pretrained`` of the same directory without importing
transformers. ``convert_t5`` and ``t5_config_from_hf`` do the same for
the T5 family (``models/encdec.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .convert import check_tree
from .registry import ModelConfig, T5Config

Params = Dict[str, Any]

_PREFIXES = ("transformer.", "model.", "gpt_neox.")


class _SD:
    """State-dict view with the JAX loader's prefix stripping. A lookup
    returns the stored tensor moved to ``device`` in its stored dtype
    (numpy arrays are taken as tensors first); nothing is materialised
    for keys never asked for."""

    def __init__(self, sd: Mapping[str, Any], device: torch.device):
        self.sd = sd
        self.device = device

    def _key(self, key: str) -> str:
        if key in self.sd:
            return key
        for pref in _PREFIXES:
            if pref + key in self.sd:
                return pref + key
        raise KeyError(key)

    def __call__(self, key: str) -> torch.Tensor:
        t = self.sd[self._key(key)]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, copy=True))
        return t.to(self.device)

    def has(self, key: str) -> bool:
        try:
            self._key(key)
            return True
        except KeyError:
            return False


def _lin(w: torch.Tensor) -> torch.Tensor:
    """torch Linear (out, in) -> ours (in, out), as a view."""
    return w.T


# ---------------------------------------------------------------------------
# Per-family layer extractors: (sd, cfg, i) -> dict of per-layer tensors
# ---------------------------------------------------------------------------

def _split_qkv_headmajor(w: torch.Tensor, b, H: int, hd: int):
    """gpt-neox / bloom fusion: rows are [h0:(q k v), h1:(q k v), ...].

    w: (3*H*hd, D) torch layout -> three (D, H*hd)."""
    D = w.shape[1]
    w3 = w.reshape(H, 3, hd, D)
    outs = [w3[:, j].reshape(H * hd, D).T for j in range(3)]
    if b is None:
        return outs, (None, None, None)
    b3 = b.reshape(H, 3, hd)
    return outs, [b3[:, j].reshape(H * hd) for j in range(3)]


def _layer_gpt2(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    p = f"h.{i}."
    D = cfg.hidden_size
    ca_w = sd(p + "attn.c_attn.weight")          # Conv1D: (D, 3D) = (in, out)
    ca_b = sd(p + "attn.c_attn.bias")
    return {
        "ln1.scale": sd(p + "ln_1.weight"), "ln1.bias": sd(p + "ln_1.bias"),
        "wq": ca_w[:, :D], "wk": ca_w[:, D:2 * D], "wv": ca_w[:, 2 * D:],
        "bq": ca_b[:D], "bk": ca_b[D:2 * D], "bv": ca_b[2 * D:],
        "wo": sd(p + "attn.c_proj.weight"), "bo": sd(p + "attn.c_proj.bias"),
        "ln2.scale": sd(p + "ln_2.weight"), "ln2.bias": sd(p + "ln_2.bias"),
        "w_up": sd(p + "mlp.c_fc.weight"), "b_up": sd(p + "mlp.c_fc.bias"),
        "w_down": sd(p + "mlp.c_proj.weight"), "b_down": sd(p + "mlp.c_proj.bias"),
    }


def _layer_gptneox(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    (wq, wk, wv), (bq, bk, bv) = _split_qkv_headmajor(
        sd(p + "attention.query_key_value.weight"),
        sd(p + "attention.query_key_value.bias"), cfg.n_heads, cfg.head_dim)
    return {
        "ln1.scale": sd(p + "input_layernorm.weight"),
        "ln1.bias": sd(p + "input_layernorm.bias"),
        "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
        "wo": _lin(sd(p + "attention.dense.weight")),
        "bo": sd(p + "attention.dense.bias"),
        "ln2.scale": sd(p + "post_attention_layernorm.weight"),
        "ln2.bias": sd(p + "post_attention_layernorm.bias"),
        "w_up": _lin(sd(p + "mlp.dense_h_to_4h.weight")),
        "b_up": sd(p + "mlp.dense_h_to_4h.bias"),
        "w_down": _lin(sd(p + "mlp.dense_4h_to_h.weight")),
        "b_down": sd(p + "mlp.dense_4h_to_h.bias"),
    }


def _layer_llama(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    out = {
        "ln1.scale": sd(p + "input_layernorm.weight"),
        "wq": _lin(sd(p + "self_attn.q_proj.weight")),
        "wk": _lin(sd(p + "self_attn.k_proj.weight")),
        "wv": _lin(sd(p + "self_attn.v_proj.weight")),
        "wo": _lin(sd(p + "self_attn.o_proj.weight")),
        "ln2.scale": sd(p + "post_attention_layernorm.weight"),
        "w_gate": _lin(sd(p + "mlp.gate_proj.weight")),
        "w_up": _lin(sd(p + "mlp.up_proj.weight")),
        "w_down": _lin(sd(p + "mlp.down_proj.weight")),
    }
    if cfg.qkv_bias:  # qwen-style
        out.update({"bq": sd(p + "self_attn.q_proj.bias"),
                    "bk": sd(p + "self_attn.k_proj.bias"),
                    "bv": sd(p + "self_attn.v_proj.bias")})
    return out


def _layer_qwen1(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    """Qwen-v1 native names: ``h.{i}.attn.c_attn`` is a fused (3D, D)
    q|k|v Linear WITH bias; the MLP is ``c_proj(w1(x) * silu(w2(x)))``,
    so w2 is the gate and w1 the up-projection."""
    p = f"h.{i}."
    D = cfg.hidden_size
    ca = sd(p + "attn.c_attn.weight")  # (3D, D)
    cb = sd(p + "attn.c_attn.bias")
    return {
        "ln1.scale": sd(p + "ln_1.weight"),
        "wq": _lin(ca[:D]), "wk": _lin(ca[D:2 * D]), "wv": _lin(ca[2 * D:]),
        "bq": cb[:D], "bk": cb[D:2 * D], "bv": cb[2 * D:],
        "wo": _lin(sd(p + "attn.c_proj.weight")),
        "ln2.scale": sd(p + "ln_2.weight"),
        "w_gate": _lin(sd(p + "mlp.w2.weight")),
        "w_up": _lin(sd(p + "mlp.w1.weight")),
        "w_down": _lin(sd(p + "mlp.c_proj.weight")),
    }


def _layer_baichuan(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    """Baichuan2 packs qkv as W_pack (3D, D), q|k|v blocks (not interleaved)."""
    p = f"layers.{i}."
    D = cfg.hidden_size
    wp = sd(p + "self_attn.W_pack.weight")  # (3D, D)
    return {
        "ln1.scale": sd(p + "input_layernorm.weight"),
        "wq": _lin(wp[:D]), "wk": _lin(wp[D:2 * D]), "wv": _lin(wp[2 * D:]),
        "wo": _lin(sd(p + "self_attn.o_proj.weight")),
        "ln2.scale": sd(p + "post_attention_layernorm.weight"),
        "w_gate": _lin(sd(p + "mlp.gate_proj.weight")),
        "w_up": _lin(sd(p + "mlp.up_proj.weight")),
        "w_down": _lin(sd(p + "mlp.down_proj.weight")),
    }


def _layer_falcon(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    """falcon-7b MQA fusion: rows = [H query heads | 1 key head | 1 value head]."""
    p = f"h.{i}."
    H, hd = cfg.n_heads, cfg.head_dim
    w = sd(p + "self_attention.query_key_value.weight")  # ((H+2)*hd, D)
    w3 = w.reshape(H + 2, hd, -1)
    return {
        "ln1.scale": sd(p + "input_layernorm.weight"),
        "ln1.bias": sd(p + "input_layernorm.bias"),
        "wq": w3[:H].reshape(H * hd, -1).T, "wk": w3[H].T, "wv": w3[H + 1].T,
        "wo": _lin(sd(p + "self_attention.dense.weight")),
        "w_up": _lin(sd(p + "mlp.dense_h_to_4h.weight")),
        "w_down": _lin(sd(p + "mlp.dense_4h_to_h.weight")),
    }


def _layer_bloom(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    p = f"h.{i}."
    (wq, wk, wv), (bq, bk, bv) = _split_qkv_headmajor(
        sd(p + "self_attention.query_key_value.weight"),
        sd(p + "self_attention.query_key_value.bias"), cfg.n_heads, cfg.head_dim)
    return {
        "ln1.scale": sd(p + "input_layernorm.weight"),
        "ln1.bias": sd(p + "input_layernorm.bias"),
        "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
        "wo": _lin(sd(p + "self_attention.dense.weight")),
        "bo": sd(p + "self_attention.dense.bias"),
        "ln2.scale": sd(p + "post_attention_layernorm.weight"),
        "ln2.bias": sd(p + "post_attention_layernorm.bias"),
        "w_up": _lin(sd(p + "mlp.dense_h_to_4h.weight")),
        "b_up": sd(p + "mlp.dense_h_to_4h.bias"),
        "w_down": _lin(sd(p + "mlp.dense_4h_to_h.weight")),
        "b_down": sd(p + "mlp.dense_4h_to_h.bias"),
    }


def _layer_opt(sd: _SD, cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    p = f"decoder.layers.{i}."
    return {
        "ln1.scale": sd(p + "self_attn_layer_norm.weight"),
        "ln1.bias": sd(p + "self_attn_layer_norm.bias"),
        "wq": _lin(sd(p + "self_attn.q_proj.weight")),
        "bq": sd(p + "self_attn.q_proj.bias"),
        "wk": _lin(sd(p + "self_attn.k_proj.weight")),
        "bk": sd(p + "self_attn.k_proj.bias"),
        "wv": _lin(sd(p + "self_attn.v_proj.weight")),
        "bv": sd(p + "self_attn.v_proj.bias"),
        "wo": _lin(sd(p + "self_attn.out_proj.weight")),
        "bo": sd(p + "self_attn.out_proj.bias"),
        "ln2.scale": sd(p + "final_layer_norm.weight"),
        "ln2.bias": sd(p + "final_layer_norm.bias"),
        "w_up": _lin(sd(p + "fc1.weight")), "b_up": sd(p + "fc1.bias"),
        "w_down": _lin(sd(p + "fc2.weight")), "b_down": sd(p + "fc2.bias"),
    }


_LAYER_FNS: Dict[str, Callable[[_SD, ModelConfig, int], Dict[str, torch.Tensor]]] = {
    "gpt2": _layer_gpt2, "gpt_neox": _layer_gptneox, "llama": _layer_llama,
    "mistral": _layer_llama, "qwen2": _layer_llama, "qwen": _layer_qwen1,
    "qwen_llama": _layer_llama,
    "baichuan": _layer_baichuan, "falcon": _layer_falcon,
    "RefinedWebModel": _layer_falcon, "bloom": _layer_bloom, "opt": _layer_opt,
}

_EMBED_KEYS = {
    "gpt2": "wte.weight", "gpt_neox": "embed_in.weight",
    "llama": "embed_tokens.weight", "mistral": "embed_tokens.weight",
    "qwen2": "embed_tokens.weight", "qwen": "wte.weight",
    "qwen_llama": "embed_tokens.weight",
    "baichuan": "embed_tokens.weight",
    "falcon": "word_embeddings.weight", "RefinedWebModel": "word_embeddings.weight",
    "bloom": "word_embeddings.weight", "opt": "decoder.embed_tokens.weight",
}

_FINAL_LN = {
    "gpt2": ("ln_f.weight", "ln_f.bias"),
    "gpt_neox": ("final_layer_norm.weight", "final_layer_norm.bias"),
    "llama": ("norm.weight", None), "mistral": ("norm.weight", None),
    "qwen2": ("norm.weight", None), "qwen": ("ln_f.weight", None),
    "qwen_llama": ("norm.weight", None),
    "baichuan": ("norm.weight", None),
    "falcon": ("ln_f.weight", "ln_f.bias"),
    "RefinedWebModel": ("ln_f.weight", "ln_f.bias"),
    "bloom": ("ln_f.weight", "ln_f.bias"),
    "opt": ("decoder.final_layer_norm.weight", "decoder.final_layer_norm.bias"),
}


def _copy(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A fresh tensor of ``t`` in ``dtype`` on ``t``'s device (never a
    view of the checkpoint's memory map)."""
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def convert_decoder(state_dict: Mapping[str, Any], cfg: ModelConfig,
                    family: str, dtype: torch.dtype = torch.float32,
                    device="cuda") -> Params:
    """Build the stacked-layer tree ``models/decoder.py`` expects on
    ``device``: each stacked leaf allocated once, filled layer by layer
    (see the module docstring). Raises when the tree's keys are not the
    ones ``cfg`` needs."""
    dev = resolve_device(device)
    sd = _SD(state_dict, dev)
    if family == "qwen" and not sd.has("h.0.attn.c_attn.weight"):
        # A Qwen-v1 checkpoint pre-converted to llama-format names.
        family = "qwen_llama"
    layer_fn = _LAYER_FNS[family]

    layers: Params = {}
    stacked: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        for key, t in layer_fn(sd, cfg, i).items():
            dst = stacked.get(key)
            if dst is None:
                dst = stacked[key] = torch.empty(
                    (cfg.n_layers, *t.shape), dtype=dtype, device=dev)
                if "." in key:  # "ln1.scale" -> layers["ln1"]["scale"]
                    a, b = key.split(".")
                    layers.setdefault(a, {})[b] = dst
                else:
                    layers[key] = dst
            dst[i].copy_(t)

    params: Params = {"tok_embed": _copy(sd(_EMBED_KEYS[family]), dtype),
                      "layers": layers}
    if cfg.pos_embedding == "learned":
        pk = {"gpt2": "wpe.weight", "opt": "decoder.embed_positions.weight"}[family]
        params["pos_embed"] = _copy(sd(pk), dtype)
    if cfg.embedding_norm:
        params["embed_ln"] = {
            "scale": _copy(sd("word_embeddings_layernorm.weight"), dtype),
            "bias": _copy(sd("word_embeddings_layernorm.bias"), dtype)}
    if cfg.final_norm:
        wkey, bkey = _FINAL_LN[family]
        fl = {"scale": _copy(sd(wkey), dtype)}
        if bkey is not None:
            fl["bias"] = _copy(sd(bkey), dtype)
        params["final_ln"] = fl
    if not cfg.tie_embeddings:
        for head_key in ("embed_out.weight", "lm_head.weight"):
            if sd.has(head_key):
                params["lm_head"] = _copy(_lin(sd(head_key)), dtype)
                break
        else:
            raise KeyError("untied lm head not found in state dict")

    check_tree(params, cfg, f"{family} checkpoint's tree")
    return params


def convert_t5(state_dict: Mapping[str, Any], cfg: T5Config,
               dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Build the T5 tree ``models/encdec.py`` expects on ``device``, each
    stacked leaf allocated once and filled layer by layer, as
    :func:`convert_decoder`. The embedding is read from ``shared.weight``
    (a safetensors T5 may hold no ``encoder``/``decoder.embed_tokens``
    copies of it); ``cfg.n_layers`` sizes BOTH stacks, as in the JAX
    converter."""
    dev = resolve_device(device)
    sd = _SD(state_dict, dev)

    def layer(side: str, cross: bool, i: int) -> Dict[str, torch.Tensor]:
        p = f"{side}.block.{i}."
        row = {
            "ln_attn": sd(p + "layer.0.layer_norm.weight"),
            "wq": _lin(sd(p + "layer.0.SelfAttention.q.weight")),
            "wk": _lin(sd(p + "layer.0.SelfAttention.k.weight")),
            "wv": _lin(sd(p + "layer.0.SelfAttention.v.weight")),
            "wo": _lin(sd(p + "layer.0.SelfAttention.o.weight")),
        }
        if cross:
            row.update({
                "ln_cross": sd(p + "layer.1.layer_norm.weight"),
                "cq": _lin(sd(p + "layer.1.EncDecAttention.q.weight")),
                "ck": _lin(sd(p + "layer.1.EncDecAttention.k.weight")),
                "cv": _lin(sd(p + "layer.1.EncDecAttention.v.weight")),
                "co": _lin(sd(p + "layer.1.EncDecAttention.o.weight")),
            })
        m = f"{p}layer.{2 if cross else 1}."
        row["ln_mlp"] = sd(m + "layer_norm.weight")
        for name in (("wi_0", "wi_1") if cfg.gated_mlp else ("wi",)):
            row[name] = _lin(sd(m + f"DenseReluDense.{name}.weight"))
        row["wo_mlp"] = _lin(sd(m + "DenseReluDense.wo.weight"))
        return row

    def stack(side: str, cross: bool) -> Params:
        out: Params = {}
        for i in range(cfg.n_layers):
            for key, t in layer(side, cross, i).items():
                if key not in out:
                    out[key] = torch.empty((cfg.n_layers, *t.shape),
                                           dtype=dtype, device=dev)
                out[key][i].copy_(t)
        return out

    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    params: Params = {
        "shared_embed": _copy(sd("shared.weight"), dtype),
        "enc_rel_embed": _copy(sd("encoder." + rel), dtype),
        "dec_rel_embed": _copy(sd("decoder." + rel), dtype),
        "encoder": stack("encoder", cross=False),
        "enc_final_ln": _copy(sd("encoder.final_layer_norm.weight"), dtype),
        "decoder": stack("decoder", cross=True),
        "dec_final_ln": _copy(sd("decoder.final_layer_norm.weight"), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _copy(_lin(sd("lm_head.weight")), dtype)
    check_tree(params, cfg, "T5 checkpoint's tree")
    return params


# ---------------------------------------------------------------------------
# HF-config adapters
# ---------------------------------------------------------------------------

# The transformers config classes' defaults (transformers 4.57) for
# exactly the fields config_from_hf reads: a parsed config.json takes
# these where it leaves a key out, as AutoConfig's class would
# (save_pretrained drops keys equal to PretrainedConfig's defaults, such
# as gpt2's tie_word_embeddings=True, and older files lack newer keys).
# "qwen" (Qwen-v1), "baichuan" and "RefinedWebModel" have no transformers
# class: their keys are read as the checkpoint gives them, with the JAX
# function's own fallbacks.
_HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
                 n_positions=1024, layer_norm_epsilon=1e-5,
                 tie_word_embeddings=True),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576,
                     rotary_pct=0.25, rotary_emb_base=10000,
                     max_position_embeddings=2048, layer_norm_eps=1e-5,
                     use_parallel_residual=True, tie_word_embeddings=False),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, max_position_embeddings=2048,
                  rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
                  tie_word_embeddings=False),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=131072,
                    rms_norm_eps=1e-6, rope_theta=10000.0,
                    tie_word_embeddings=False),
    "qwen2": dict(vocab_size=151936, hidden_size=4096, intermediate_size=22016,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32, max_position_embeddings=32768,
                  rms_norm_eps=1e-6, rope_theta=10000.0,
                  tie_word_embeddings=False),
    "falcon": dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                   num_attention_heads=71, layer_norm_epsilon=1e-5,
                   multi_query=True, max_position_embeddings=2048,
                   tie_word_embeddings=True),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, max_position_embeddings=2048,
                ffn_dim=3072, tie_word_embeddings=True),
    "t5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
               num_layers=6, num_heads=8, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               feed_forward_proj="relu", is_encoder_decoder=True,
               tie_word_embeddings=True, decoder_start_token_id=None),
}

# Keys a config class stores under another name (its attribute_map, and
# the n_embed keyword bloom and falcon accept for hidden_size).
_HF_ALIASES: Dict[str, Dict[str, str]] = {
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings": "n_positions",
             "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"},
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head",
              "n_embed": "hidden_size"},
    "falcon": {"n_embed": "hidden_size"},
    "t5": {"hidden_size": "d_model", "num_attention_heads": "num_heads",
           "num_hidden_layers": "num_layers", "head_dim": "d_kv"},
}

# Classes whose __init__ sets num_key_value_heads = num_attention_heads
# when it is None.
_KV_FROM_HEADS = ("llama", "mistral", "qwen2")


class _HFView:
    """Attribute view of a parsed config.json with the class defaults of
    its model type filled in (what ``AutoConfig`` would return)."""

    def __init__(self, cfg: Mapping[str, Any]):
        mt = cfg["model_type"]
        aliases = _HF_ALIASES.get(mt, {})
        vals = dict(_HF_DEFAULTS.get(mt, {}))
        vals.update({aliases.get(k, k): v for k, v in cfg.items()})
        if mt in _KV_FROM_HEADS and vals.get("num_key_value_heads") is None:
            vals["num_key_value_heads"] = vals.get("num_attention_heads")
        vals.setdefault("name_or_path", vals.pop("_name_or_path", ""))
        self.__dict__.update(vals)


def config_from_hf(hf_cfg, name: Optional[str] = None) -> Tuple[ModelConfig, str]:
    """Map an HF config (a parsed ``config.json`` or a config object) to
    (ModelConfig, family), as the JAX function does. ``name`` sets
    ``ModelConfig.name`` (``load_engine`` passes the checkpoint
    directory, as ``AutoConfig`` sets ``name_or_path``)."""
    if isinstance(hf_cfg, Mapping):
        hf_cfg = _HFView(hf_cfg)
    mt = hf_cfg.model_type
    g = lambda *names, d=None: next(
        (getattr(hf_cfg, n) for n in names if getattr(hf_cfg, n, None) is not None), d)
    if name is None:
        name = getattr(hf_cfg, "name_or_path", mt) or mt
    common = dict(
        name=name,
        vocab_size=hf_cfg.vocab_size,
        hidden_size=g("hidden_size", "n_embd", "d_model"),
        n_layers=g("num_hidden_layers", "n_layer", "num_layers"),
        n_heads=g("num_attention_heads", "n_head"),
        max_seq_len=g("max_position_embeddings", "n_positions", "seq_length", d=2048),
    )
    if mt == "gpt2":
        # The config is authoritative on tying: an untied checkpoint
        # carries a real lm_head.weight that must be used.
        return ModelConfig(**common, intermediate_size=4 * common["hidden_size"],
                           pos_embedding="learned", norm="layernorm",
                           norm_eps=hf_cfg.layer_norm_epsilon, activation="gelu_new",
                           gated_mlp=False, qkv_bias=True, attn_out_bias=True,
                           mlp_bias=True,
                           tie_embeddings=bool(getattr(
                               hf_cfg, "tie_word_embeddings", True))), "gpt2"
    if mt == "gpt_neox":
        return ModelConfig(**common, intermediate_size=hf_cfg.intermediate_size,
                           pos_embedding="rotary", rotary_pct=hf_cfg.rotary_pct,
                           rope_theta=getattr(hf_cfg, "rotary_emb_base", 10000.0),
                           norm="layernorm", norm_eps=hf_cfg.layer_norm_eps,
                           activation="gelu", gated_mlp=False,
                           parallel_block=hf_cfg.use_parallel_residual,
                           qkv_bias=True, attn_out_bias=True, mlp_bias=True), "gpt_neox"
    if mt in ("llama", "mistral", "qwen2", "baichuan"):
        return ModelConfig(**common, intermediate_size=hf_cfg.intermediate_size,
                           n_kv_heads=g("num_key_value_heads"),
                           rope_theta=g("rope_theta", d=10000.0),
                           norm_eps=hf_cfg.rms_norm_eps,
                           qkv_bias=(mt == "qwen2" and getattr(
                               hf_cfg, "attention_bias", False)) or bool(
                               getattr(hf_cfg, "use_bias", False)),
                           tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings",
                                                       False))), mt
    if mt == "qwen":
        # Qwen-v1: config.intermediate_size counts BOTH mlp halves (each
        # projection is intermediate_size // 2 wide). no_bias=False
        # checkpoints carry c_proj/mlp biases the mapping does not read.
        if not getattr(hf_cfg, "no_bias", True):
            raise ValueError(
                "Qwen-v1 with no_bias=False (biased c_proj/mlp) is not "
                "supported by the native mapping")
        return ModelConfig(**common,
                           intermediate_size=hf_cfg.intermediate_size // 2,
                           rope_theta=g("rotary_emb_base", d=10000.0),
                           norm_eps=g("layer_norm_epsilon", d=1e-6),
                           qkv_bias=True,
                           tie_embeddings=bool(getattr(
                               hf_cfg, "tie_word_embeddings", False))), "qwen"
    if mt in ("falcon", "RefinedWebModel"):
        return ModelConfig(**common, intermediate_size=4 * common["hidden_size"],
                           n_kv_heads=1 if g("multi_query", d=True) else common["n_heads"],
                           pos_embedding="rotary", norm="layernorm",
                           norm_eps=hf_cfg.layer_norm_epsilon,
                           activation="gelu", gated_mlp=False, parallel_block=True,
                           shared_block_ln=True, tie_embeddings=True), "falcon"
    if mt == "bloom":
        return ModelConfig(**common, intermediate_size=4 * common["hidden_size"],
                           pos_embedding="alibi", norm="layernorm",
                           norm_eps=hf_cfg.layer_norm_epsilon, activation="gelu_new",
                           gated_mlp=False, embedding_norm=True, qkv_bias=True,
                           attn_out_bias=True, mlp_bias=True,
                           tie_embeddings=True), "bloom"
    if mt == "opt":
        return ModelConfig(**common, intermediate_size=hf_cfg.ffn_dim,
                           pos_embedding="learned", learned_pos_offset=2,
                           norm="layernorm", activation="relu", gated_mlp=False,
                           qkv_bias=True, attn_out_bias=True, mlp_bias=True,
                           tie_embeddings=True), "opt"
    raise ValueError(f"unsupported model_type {mt!r}")


def t5_config_from_hf(hf_cfg, name: Optional[str] = None) -> T5Config:
    """Map an HF T5 config (a parsed ``config.json`` or a config object)
    to T5Config, as the JAX function does. ``num_layers`` sizes both
    stacks (``num_decoder_layers`` is not read), as in the JAX package.
    ``name`` as in :func:`config_from_hf`."""
    if isinstance(hf_cfg, Mapping):
        hf_cfg = _HFView(hf_cfg)
    if name is None:
        name = getattr(hf_cfg, "name_or_path", "t5") or "t5"
    return T5Config(
        name=name, vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.d_model,
        n_layers=hf_cfg.num_layers, n_heads=hf_cfg.num_heads,
        head_dim=hf_cfg.d_kv, intermediate_size=hf_cfg.d_ff,
        norm_eps=hf_cfg.layer_norm_epsilon,
        relative_attention_num_buckets=hf_cfg.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(
            hf_cfg, "relative_attention_max_distance", 128),
        gated_mlp="gated" in hf_cfg.feed_forward_proj,
        activation="gelu_new" if "gelu" in hf_cfg.feed_forward_proj else "relu",
        tie_embeddings=bool(hf_cfg.tie_word_embeddings),
        decoder_start_token_id=hf_cfg.decoder_start_token_id,
    )
