"""Functional T5-family encoder-decoder (t5-v1_1, flan-t5, T0, tk-instruct).

Port of ``lir_tpu/models/encdec.py``. The reference routes
"t5|t0|tk-instruct" repos through ``AutoModelForSeq2SeqLM``
(compare_instruct_models.py:471-475) and reads yes/no probabilities
from the decoder's generated positions (compare_base_vs_instruct.py:
203-241). Relative position buckets, RMSNorm, gated-GeLU (v1.1) or ReLU
(v1.0) MLP, no biases anywhere, float32 softmax and logits.

- Parameters are a plain dict with the JAX package's tree layout: each
  stack's layers are STACKED on a leading axis (``params["encoder"]["wq"]``
  is (L, D, H*hd)) and a Python loop walks the layer axis where the JAX
  package scans it.
- The JAX package computes this branch with XLA einsums, outside any
  Pallas kernel; here the products are ``torch`` matmuls in the same
  order of rounding: attention scores in the activation dtype, then
  float32 with the bias added, probabilities back in the activation
  dtype before the PV product. T5 scales no scores by 1/sqrt(d), which
  is why no fused attention call (SDPA) computes them.
- The linear layers take dense or int8 weights (``models/quant.py``), an
  activation shared by several dynamic int8 matrices quantized once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .decoder import _layer, mask_positions
from .quant import QuantTensor, matmul as _mm, shared_quant as _sq
from .registry import T5Config

Params = Dict[str, Any]


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar tensor on ``device``, computed on the CPU: a
    Python-number divisor would become a reciprocal multiply in PyTorch's
    CUDA kernels, and the constant is then the same bits on every device."""
    return torch.tensor(x, dtype=torch.float32).to(device)


def _relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """HF T5 relative_position_bucket, int32 in and out, the log-spaced
    buckets in float32 and truncated toward zero as the JAX package does."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(rel.dtype) * num_buckets
        n = torch.abs(rel)
    else:
        n = torch.clamp_min(-rel, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(_f32(max_distance / max_exact, "cpu")).to(rel.device)
    val_large = max_exact + (
        torch.log(n.float() / _f32(max_exact, rel.device) + 1e-6)
        / log_ratio * (num_buckets - max_exact)).to(rel.dtype)
    val_large = torch.clamp_max(val_large, num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _rel_bias(rel_embed: torch.Tensor, q_pos: torch.Tensor,
              k_pos: torch.Tensor, cfg: T5Config,
              bidirectional: bool) -> torch.Tensor:
    """(B, S), (B, T) mask-aware positions -> additive bias (B, H, S, T)
    float32."""
    rel = k_pos[:, None, :] - q_pos[:, :, None]          # (B, S, T)
    buckets = _relative_bucket(rel, bidirectional,
                               cfg.relative_attention_num_buckets,
                               cfg.relative_attention_max_distance)
    bias = rel_embed[buckets.long()]                     # (B, S, T, H)
    return bias.permute(0, 3, 1, 2).float()


def _mask_bias(allowed: torch.Tensor) -> torch.Tensor:
    """Boolean key validity -> additive float32 bias: 0 or -1e9."""
    neg = torch.tensor(-1e9, dtype=torch.float32, device=allowed.device)
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    return torch.where(allowed, zero, neg)


def _attn(q, k, v, bias) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, T, H, hd), bias float32 (B, H|1, S, T).
    T5: NO 1/sqrt(d). The scores are rounded to q's dtype before the
    float32 bias add, and the probabilities cast back to it before PV."""
    B, S, H, hd = q.shape
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * hd)


def _proj(x, w) -> torch.Tensor:
    """Dense or int8 (QuantTensor) projection; ``quant.matmul`` takes
    both, the dynamic s8 x s8 mode included."""
    return _mm(x, w)


def _mlp(x, lp: Params, cfg: T5Config) -> torch.Tensor:
    """Gated: tanh-GeLU of wi_0 times wi_1 (one quantized activation for
    both); else ReLU. ``cfg.activation`` is not read, as in the JAX
    package."""
    if cfg.gated_mlp:
        xq = _sq(x, lp["wi_0"], lp["wi_1"])
        h = (F.gelu(_proj(xq, lp["wi_0"]), approximate="tanh")
             * _proj(xq, lp["wi_1"]))
    else:
        h = F.relu(_proj(x, lp["wi"]))
    return _proj(h, lp["wo_mlp"])


def _heads(x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)


def _self_attn(h, lp: Params, cfg: T5Config, bias) -> torch.Tensor:
    a_in = _rmsnorm(h, lp["ln_attn"], cfg.norm_eps)
    aq = _sq(a_in, lp["wq"], lp["wk"], lp["wv"])
    q = _heads(_proj(aq, lp["wq"]), cfg)
    k = _heads(_proj(aq, lp["wk"]), cfg)
    v = _heads(_proj(aq, lp["wv"]), cfg)
    return h + _proj(_attn(q, k, v, bias), lp["wo"])


def param_tree(cfg: T5Config, leaf) -> Params:
    """The JAX package's T5 param tree, each leaf made by
    ``leaf(name, shape, kind)`` in a fixed order (``kind`` "normal" or
    "ones")."""
    D, H, hd, F_, L = (cfg.hidden_size, cfg.n_heads, cfg.head_dim,
                       cfg.intermediate_size, cfg.n_layers)

    def stack(cross: bool) -> Params:
        p = {"ln_attn": leaf("ln_attn", (L, D), "ones")}
        for name in ("wq", "wk", "wv"):
            p[name] = leaf(name, (L, D, H * hd), "normal")
        p["wo"] = leaf("wo", (L, H * hd, D), "normal")
        p["ln_mlp"] = leaf("ln_mlp", (L, D), "ones")
        for name in (("wi_0", "wi_1") if cfg.gated_mlp else ("wi",)):
            p[name] = leaf(name, (L, D, F_), "normal")
        p["wo_mlp"] = leaf("wo_mlp", (L, F_, D), "normal")
        if cross:
            p["ln_cross"] = leaf("ln_cross", (L, D), "ones")
            for name in ("cq", "ck", "cv"):
                p[name] = leaf(name, (L, D, H * hd), "normal")
            p["co"] = leaf("co", (L, H * hd, D), "normal")
        return p

    nb = cfg.relative_attention_num_buckets
    params: Params = {
        "shared_embed": leaf("shared_embed", (cfg.vocab_size, D), "normal"),
        "enc_rel_embed": leaf("enc_rel_embed", (nb, H), "normal"),
        "dec_rel_embed": leaf("dec_rel_embed", (nb, H), "normal"),
        "encoder": stack(cross=False),
        "enc_final_ln": leaf("enc_final_ln", (D,), "ones"),
        "decoder": stack(cross=True),
        "dec_final_ln": leaf("dec_final_ln", (D,), "ones"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf("lm_head", (D, cfg.vocab_size), "normal")
    return params


def init_params(cfg: T5Config, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Params:
    """Random-normal init (scale 0.02; norms ones) made on ``device`` from
    a seeded ``torch.Generator``, with the JAX package's tree layout."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def leaf(name, shape, kind):
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            return x.mul_(0.02)
        return torch.ones(shape, device=dev, dtype=dtype)

    return param_tree(cfg, leaf)


def encode(params: Params, cfg: T5Config, tokens: torch.Tensor,
           attn_mask: torch.Tensor) -> torch.Tensor:
    """Encoder stack: (B, S) -> (B, S, D). Left padding works: positions
    come from the mask's cumsum, padded keys take a -1e9 bias."""
    positions = mask_positions(attn_mask)
    x = params["shared_embed"][tokens.long()]
    bias = (_rel_bias(params["enc_rel_embed"], positions, positions, cfg, True)
            + _mask_bias(attn_mask[:, None, None, :] > 0))
    for i in range(cfg.n_layers):
        lp = _layer(params["encoder"], i)
        x = _self_attn(x, lp, cfg, bias)
        x = x + _mlp(_rmsnorm(x, lp["ln_mlp"], cfg.norm_eps), lp, cfg)
    return _rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def decode(params: Params, cfg: T5Config, enc_out: torch.Tensor,
           enc_mask: torch.Tensor, dec_tokens: torch.Tensor,
           dec_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (teacher-forced) decoder pass -> float32 logits (B, S_dec, V).

    For the first decoded position alone, feed
    ``dec_tokens = [[decoder_start_token_id]]``."""
    B, S = dec_tokens.shape
    if dec_mask is None:
        dec_mask = torch.ones_like(dec_tokens)
    positions = mask_positions(dec_mask)
    x = params["shared_embed"][dec_tokens.long()]
    causal = ((positions[:, None, :] <= positions[:, :, None])
              & (dec_mask[:, None, :] > 0))
    self_bias = (_rel_bias(params["dec_rel_embed"], positions, positions, cfg,
                           False)
                 + _mask_bias(causal[:, None, :, :]))
    cross_bias = _mask_bias(enc_mask[:, None, None, :] > 0)
    for i in range(cfg.n_layers):
        lp = _layer(params["decoder"], i)
        x = _self_attn(x, lp, cfg, self_bias)
        c_in = _rmsnorm(x, lp["ln_cross"], cfg.norm_eps)
        eq = _sq(enc_out, lp["ck"], lp["cv"])
        cq = _heads(_proj(c_in, lp["cq"]), cfg)
        ck = _heads(_proj(eq, lp["ck"]), cfg)
        cv = _heads(_proj(eq, lp["cv"]), cfg)
        x = x + _proj(_attn(cq, ck, cv, cross_bias), lp["co"])
        x = x + _mlp(_rmsnorm(x, lp["ln_mlp"], cfg.norm_eps), lp, cfg)
    x = _rmsnorm(x, params["dec_final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        # T5 v1.0 ties and rescales by d_model^-0.5, the factor rounded to
        # the activation dtype first (the JAX package's weak-typed scalar).
        head = params["shared_embed"].T
        x = x * torch.tensor(cfg.hidden_size ** -0.5, dtype=x.dtype,
                             device=x.device)
    else:
        head = params["lm_head"]
    if isinstance(head, QuantTensor):
        return _mm(x.float(), head)              # weight-only int8 head
    return torch.einsum("bsd,dv->bsv", x.float(), head.float())


def forward(params: Params, cfg: T5Config, enc_tokens: torch.Tensor,
            enc_mask: torch.Tensor, dec_tokens: torch.Tensor,
            dec_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    enc_out = encode(params, cfg, enc_tokens, enc_mask)
    return decode(params, cfg, enc_out, enc_mask, dec_tokens, dec_mask)
