"""Unified functional decoder-only transformer in PyTorch.

Port of ``lir_tpu/models/decoder.py``: one forward covers GPT-2, the
GPT-NeoX family, Llama-2 / Mistral / Qwen / Baichuan2, Falcon (MQA +
shared-LN parallel block), Bloom (ALiBi + embedding LayerNorm) and OPT,
selected by ``registry.ModelConfig`` knobs.

- Parameters are a plain dict with the JAX package's tree layout: the
  layers are STACKED on a leading axis (``params["layers"]["wq"]`` is
  (L, D, H*hd)) and a Python loop walks the layer axis where the JAX
  package scans it.
- Activations run in the parameter dtype; softmax and the logits are
  float32.
- The KV cache keeps the JAX layout (L, K, T, B, hd), head-major and
  batch-minor, so the kernels see the JAX public shapes. The port
  updates the cache IN PLACE (slot writes into the preallocated tensor)
  where the JAX package returns a new array: one cache per dispatch,
  never a copy of it.
- Decode steps route through ``ops.flash_decode`` / ``flash_decode_trunk``,
  speculative verify windows through ``ops.flash_decode_mq`` /
  ``flash_decode_mq_trunk``, the shared-trunk prefill through
  ``ops.cascade_attention`` (fused, or two-leg with a float or int8
  QK^T trunk leg), and with ``cfg.use_flash_attention`` the prompt
  prefill through ``ops.flash_attention``. On a CUDA tensor those launch
  the hand-written kernels; on a CPU tensor they run their plain
  versions, so the routing is the same on both.
- The linear layers take dense or int8 weights (``models/quant.py``
  QuantTensor leaves: weight-only, or dynamic s8 x s8 -> s32).
- With ``cfg.kv_cache_int8`` each side of the cache is a (payload int8
  (L, K, T, B, hd), scale float32 (L, K, T, B)) pair, the JAX nesting
  ``((kq, ks), (vq, vs))``: the prefill quantizes each layer's k/v into
  it (its own attention stays float), and the cached attention of
  ``extend``, ``decode_step`` and ``verify_extend`` runs
  ``ops.kv_int8_attention`` (s8 x s8 products) instead of the float
  routes. :func:`cache_map` walks either layout's leaves.
- The decode step and the speculative verify window run their bf16
  projections and norms through ``ops.row_gemm`` / ``ops.row_norm``,
  whose rows do not depend on the row count, and the window's head once
  per position at the step's shape: a window of B * S rows then gives
  each row the step's bits (on the CPU the same ops are the plain ones).
  In sequential blocks there, each residual add is the same launch as
  the norm after it (``ops.row_add_norm``): a block hands its MLP output
  to the next block's ln1, and the last block's to the final norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..device import resolve_device
from ..ops.kv_int8_attention import causal_bias
from .quant import (QuantTensor, dynamic_quant as _quant_kv, matmul as _mm,
                    shared_quant as _shared_quant)
from .registry import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Param init (random weights; the tree layout of the JAX package)
# ---------------------------------------------------------------------------

def param_tree(cfg: ModelConfig, leaf) -> Params:
    """The JAX package's param tree layout, each leaf made by
    ``leaf(name, shape, kind)`` in a fixed order (``kind`` is "normal",
    "ones" or "zeros"; ``name`` the leaf's key, "scale"/"bias" inside a
    norm)."""
    D, H, K, hd, F_, L = (cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.intermediate_size, cfg.n_layers)

    def norm_p(*lead) -> Params:
        p = {"scale": leaf("scale", (*lead, D), "ones")}
        if cfg.norm == "layernorm":
            p["bias"] = leaf("bias", (*lead, D), "zeros")
        return p

    layers: Params = {"ln1": norm_p(L)}
    for name, shape in (("wq", (L, D, H * hd)), ("wk", (L, D, K * hd)),
                        ("wv", (L, D, K * hd)), ("wo", (L, H * hd, D)),
                        ("w_up", (L, D, F_)), ("w_down", (L, F_, D))):
        layers[name] = leaf(name, shape, "normal")
    if not cfg.shared_block_ln:
        layers["ln2"] = norm_p(L)
    if cfg.gated_mlp:
        layers["w_gate"] = leaf("w_gate", (L, D, F_), "normal")
    biases = []
    if cfg.qkv_bias:
        biases += [("bq", (L, H * hd)), ("bk", (L, K * hd)), ("bv", (L, K * hd))]
    if cfg.attn_out_bias:
        biases.append(("bo", (L, D)))
    if cfg.mlp_bias:
        biases += [("b_up", (L, F_)), ("b_down", (L, D))]
    for name, shape in biases:
        layers[name] = leaf(name, shape, "zeros")

    params: Params = {"tok_embed": leaf("tok_embed", (cfg.vocab_size, D),
                                        "normal"),
                      "layers": layers}
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = leaf(
            "pos_embed", (cfg.max_seq_len + cfg.learned_pos_offset, D),
            "normal")
    if cfg.embedding_norm:
        params["embed_ln"] = {"scale": leaf("scale", (D,), "ones"),
                              "bias": leaf("bias", (D,), "zeros")}
    if cfg.final_norm:
        params["final_ln"] = norm_p()
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf("lm_head", (D, cfg.vocab_size), "normal")
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Params:
    """Random-normal init (scale 0.02) made on ``device`` from a seeded
    ``torch.Generator``, with the JAX package's tree layout."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def leaf(name, shape, kind):
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            return x.mul_(0.02)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, device=dev, dtype=dtype)

    return param_tree(cfg, leaf)


def _layer(tree, i: int):
    """Layer ``i`` of the stacked layer tree (views, no copies); a
    QuantTensor slices payload and scales together."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    return ops.row_norm_plain(x, p["scale"],
                              None if cfg.norm == "rmsnorm" else p["bias"],
                              cfg.norm_eps)


def _row_norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_norm` of the decode step and the verify window: on bf16
    activations through ``ops.row_norm``, whose rows do not depend on how
    many rows the call holds (on a CPU tensor it is :func:`_norm`)."""
    if x.dtype != torch.bfloat16:
        return _norm(x, p, cfg)
    return ops.row_norm(x, p["scale"],
                        None if cfg.norm == "rmsnorm" else p["bias"],
                        cfg.norm_eps)


def _row_add_norm(x: torch.Tensor, d: torch.Tensor, p: Params,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + d`` and :func:`_row_norm` of ``s``: on bf16 activations
    ``ops.row_add_norm`` (on the card one launch, ``s`` bitwise torch's
    bf16 add and the norm bitwise ``ops.row_norm`` of it; on the CPU the
    add and :func:`_norm`), on others the add and :func:`_norm`."""
    if x.dtype != torch.bfloat16 or d.dtype != x.dtype:
        s = x + d
        return s, _norm(s, p, cfg)
    return ops.row_add_norm(x, d, p["scale"],
                            None if cfg.norm == "rmsnorm" else p["bias"],
                            cfg.norm_eps)


def _row_mm(x, w) -> torch.Tensor:
    """The step's and the window's projections: a dense bf16 weight goes
    through ``ops.row_gemm`` (each row's bits independent of the row
    count; on a CPU tensor ``x @ w``), any other through
    ``quant.matmul``, whose int8 products are exact integers and whose
    scale folds are element-wise."""
    if (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
            and x.dtype == w.dtype == torch.bfloat16):
        return ops.row_gemm(x, w)
    return _mm(x, w)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "gelu_new":
        return F.gelu(x, approximate="tanh")
    return F.relu(x)


def _rope_sincos(positions: torch.Tensor, rotary_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for rotate-half RoPE. positions: (..., S) int."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions.float()[..., None] * inv_freq     # (..., S, rd/2)
    return torch.sin(angles), torch.cos(angles)


def _apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                rotary_dim: int) -> torch.Tensor:
    """x: (B, S, nH, hd); rotate-half convention (HF llama/neox/falcon)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot[..., : rotary_dim // 2], rot[..., rotary_dim // 2:]
    sin = sin[:, :, None, :].to(x.dtype)      # (B, S, 1, rd/2)
    cos = cos[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (bloom). Matches HF build_alibi_tensor."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** (2 * i + 1) for i in range(n_heads - closest)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def _slopes_or_none(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    if cfg.pos_embedding == "alibi":
        return alibi_slopes(cfg.n_heads, device)
    return None


# Block edge of the JAX prefill flash kernel: a length is flash-routed when
# it is at most one block or a multiple of it.
FLASH_BLOCK = 128


def _flash_ok(cfg: ModelConfig, S: int, T: int, key_mask) -> bool:
    """The prefill flash route, the JAX gate exactly: the flag on, a key
    mask, full self-attention (T == S) and a length of at most one block
    or a multiple of it. Ragged lengths stay dense. As for the decode
    kernels, no backend enters the decision."""
    return (cfg.use_flash_attention and key_mask is not None and T == S
            and (S % FLASH_BLOCK == 0 or S <= FLASH_BLOCK))


def _attention(q, k, v, bias, cfg: ModelConfig, key_mask=None) -> torch.Tensor:
    """Prefill self-attention. q: (B,S,H,hd); k,v: (B,T,K,hd); bias:
    (B,H|1,S,T) additive float32, or None on the flash route.

    With :func:`_flash_ok` it runs ``ops.flash_attention``: causal, keys
    masked by ``key_mask`` (any pattern), ALiBi on mask-aware key
    positions, a query row with no valid key giving 0. Otherwise dense;
    GQA/MQA contracts grouped query heads against the un-repeated k/v
    (h = k*G + g), as the flash kernel indexes kv head h // G."""
    B, S, H, hd = q.shape
    K, T = k.shape[2], k.shape[1]
    G = H // K
    if _flash_ok(cfg, S, T, key_mask):
        slopes = _slopes_or_none(cfg, q.device)
        kpos = mask_positions(key_mask) if slopes is not None else None
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), key_mask=key_mask,
                                  alibi_slopes=slopes, key_positions=kpos)
        return out.reshape(B, S, H * hd)
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores.reshape(B, H, S, T) / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.reshape(B, K, G, S, T), v)
    return out.reshape(B, S, H * hd)


def _fused_decode_ok(cfg: ModelConfig, S: int, fused_ctx) -> bool:
    """The flash-decode route: a single-query cached step over a float
    cache with the flag on. The kernels run on CUDA tensors and their
    plain versions on CPU tensors, so no backend enters the decision."""
    return (cfg.fused_decode and not cfg.kv_cache_int8
            and fused_ctx is not None and S == 1)


def _attention_cached_flash(q, k, v, cfg: ModelConfig, fused_ctx,
                            trunk_len: int = 0) -> torch.Tensor:
    """Decode-step attention through the flash-decode kernels; with
    ``trunk_len`` > 0 (a shared-trunk dispatch with cascade decode on)
    through the trunk-aware variant, bitwise the flat kernel."""
    B, S, H, hd = q.shape
    q_pos, key_mask, key_positions = fused_ctx
    slopes = _slopes_or_none(cfg, q.device)
    q1 = q[:, 0].contiguous()
    if trunk_len > 0:
        out = ops.flash_decode_trunk(q1, k, v, q_pos, key_mask,
                                     key_positions=key_positions,
                                     alibi_slopes=slopes, trunk_len=trunk_len)
    else:
        out = ops.flash_decode(q1, k, v, q_pos, key_mask,
                               key_positions=key_positions,
                               alibi_slopes=slopes)
    return out.reshape(B, S, H * hd)


def _fused_decode_mq_ok(cfg: ModelConfig, S: int, fused_ctx) -> bool:
    """The multi-query flash-decode route: a verify window of S > 1
    teacher-forced queries whose fused_ctx positions are (B, S). As for
    :func:`_fused_decode_ok`, no backend enters the decision."""
    return (cfg.fused_decode and not cfg.kv_cache_int8
            and fused_ctx is not None and S > 1 and fused_ctx[0].dim() == 2)


def _attention_cached_flash_mq(q, k, v, cfg: ModelConfig, fused_ctx,
                               trunk_len: int = 0) -> torch.Tensor:
    """Verify-window attention through the multi-query kernels: S
    queries per row over the cache (the window's own k/v already
    written) in one launch, each query's reduction bitwise the
    single-query kernel's. ``trunk_len`` > 0 routes the trunk-aware
    sibling, bitwise the flat one."""
    B, S, H, hd = q.shape
    q_pos, key_mask, key_positions = fused_ctx
    slopes = _slopes_or_none(cfg, q.device)
    q = q.contiguous()
    if trunk_len > 0:
        out = ops.flash_decode_mq_trunk(q, k, v, q_pos, key_mask,
                                        key_positions=key_positions,
                                        alibi_slopes=slopes,
                                        trunk_len=trunk_len)
    else:
        out = ops.flash_decode_mq(q, k, v, q_pos, key_mask,
                                  key_positions=key_positions,
                                  alibi_slopes=slopes)
    return out.reshape(B, S, H * hd)


def _attention_cascade(q, k, v, trunk_kv, suffix_mask, q_positions,
                       cfg: ModelConfig, int8_qk: bool = False,
                       trunk_k_int8=None) -> torch.Tensor:
    """Shared-trunk prefill window through the cascade kernels. q:
    (B, R, H, hd); k/v: (B, R, K, hd) the window's own post-RoPE k/v;
    trunk_kv: (K, Tt, hd) pair. ``cfg.cascade_fused_suffix`` without
    ``int8_qk`` takes the fused kernel; otherwise the two-leg route, its
    trunk leg in float or (``int8_qk``) int8 QK^T, the latter on the
    trunk keys' ``trunk_k_int8`` (payload, scales) pair."""
    B, R, H, hd = q.shape
    tk, tv = trunk_kv
    out = ops.cascade_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                tk, tv, suffix_mask, q_positions,
                                alibi_slopes=_slopes_or_none(cfg, q.device),
                                int8_qk=int8_qk,
                                fused_suffix=cfg.cascade_fused_suffix,
                                trunk_k_int8=trunk_k_int8)
    return out.reshape(B, R, H * hd)


def _attention_cached_int8(q, kq, ks, vq, vs, cfg: ModelConfig,
                           fused_ctx) -> torch.Tensor:
    """Cached attention over the int8 cache (payloads (K, T, B, hd),
    scales (K, T, B)) through ``ops.kv_int8_attention``: the JAX
    package's ``_attention_cached_int8``, its bias built from the
    ``fused_ctx`` triple (query positions (B,) or (B, S), cache mask and
    key positions (B, T)) as ``_causal_bias`` builds it."""
    q_pos, key_mask, key_positions = fused_ctx
    B, S = q.shape[:2]
    return ops.kv_int8_attention(
        q.contiguous(), kq, ks, vq, vs, q_pos.reshape(B, S), key_mask,
        key_positions, alibi_slopes=_slopes_or_none(cfg, q.device))


def _write_int8(side, x, cache_index, S: int, rows):
    """Quantize the step's (B, S, K, hd) k or v per vector and write the
    payload and scales into one cache side at ``cache_index`` (one slot
    for every row, or a (B, S) tensor of each row's slots)."""
    xq, xs = _quant_kv(x)
    cq, cs = side
    if isinstance(cache_index, torch.Tensor):
        cq[:, cache_index, rows] = xq.permute(2, 0, 1, 3)
        cs[:, cache_index, rows] = xs.permute(2, 0, 1)
    else:
        cq[:, cache_index:cache_index + S] = xq.permute(2, 1, 0, 3)
        cs[:, cache_index:cache_index + S] = xs.permute(2, 1, 0)


def _attention_cached(q, k, v, bias, cfg: ModelConfig) -> torch.Tensor:
    """Dense attention of S queries over the CACHE layout (K, T, B, hd):
    the chunked extension (``extend``), the decode step and the verify
    window with the flash route off. A view of the cache cut to a shorter
    extent is made contiguous first, so that the products see the same
    layout, and round the same way, as on a cache of that extent."""
    B, S, H, hd = q.shape
    K = k.shape[0]
    G = H // K
    k, v = k.contiguous(), v.contiguous()
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,ktbd->bkgst", qg, k).float()
    scores = scores.reshape(B, H, S, -1) / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    pg = probs.reshape(B, K, G, S, -1)
    out = torch.einsum("bkgst,ktbd->bskgd", pg, v)
    return out.reshape(B, S, H * hd)


def _block(x, lp: Params, cfg: ModelConfig, sin, cos, bias, cache_kv,
           cache_index, key_mask=None, attn_impl=None, fused_ctx=None,
           trunk_len: int = 0, row_ops: bool = False, pending=None):
    """One transformer block. Returns (new_x, (k, v), pending).

    With ``cache_kv`` (one layer's (K, T, B, hd) views of the cache) the
    step's k/v are written into the cache in place, at slots
    ``cache_index`` .. + S, or with a (B, S) tensor ``cache_index`` at
    each row's own slots, and the queries attend over the cache; the
    returned pair is the cache views. On an int8 cache (each side a
    (payload, scales) pair) the k/v are quantized as they are written and
    the queries attend through ``ops.kv_int8_attention``, whose masks
    come from ``fused_ctx``. Otherwise the block attends over
    its own k/v (dense, or ``attn_impl(q, k, v, key_mask)``) and returns
    them (B, S, K, hd). ``row_ops`` (the decode step and the verify
    window) takes the norms and projections whose rows do not depend on
    the row count (:func:`_row_norm`, :func:`_row_mm`); in a sequential
    block it also takes each residual add with the norm after it
    (:func:`_row_add_norm`): ``pending``, the previous block's MLP output
    not yet added to x, is added with ln1, and the block returns its own
    MLP output as the next ``pending`` instead of adding it (None
    elsewhere, where new_x has every add).
    """
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norm = _row_norm if row_ops else _norm
    mm = _row_mm if row_ops else _mm
    fuse = row_ops and not cfg.parallel_block

    if pending is not None:
        x, h_attn_in = _row_add_norm(x, pending, lp["ln1"], cfg)
    else:
        h_attn_in = norm(x, lp["ln1"], cfg)
    h_qkv = _shared_quant(h_attn_in, lp["wq"], lp["wk"], lp["wv"])
    q = mm(h_qkv, lp["wq"])
    k = mm(h_qkv, lp["wk"])
    v = mm(h_qkv, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.pos_embedding == "rotary":
        rd = cfg.rotary_dim
        q = _apply_rope(q, sin, cos, rd)
        k = _apply_rope(k, sin, cos, rd)

    if cache_kv is not None and cfg.kv_cache_int8:
        ck, cv = cache_kv
        rows = torch.arange(B, device=x.device)[:, None]
        _write_int8(ck, k, cache_index, S, rows)
        _write_int8(cv, v, cache_index, S, rows)
        attn = _attention_cached_int8(q, *ck, *cv, cfg, fused_ctx)
    elif cache_kv is not None:
        ck, cv = cache_kv
        if isinstance(cache_index, torch.Tensor):
            rows = torch.arange(B, device=x.device)[:, None]
            ck[:, cache_index, rows] = k.permute(2, 0, 1, 3).to(ck.dtype)
            cv[:, cache_index, rows] = v.permute(2, 0, 1, 3).to(cv.dtype)
        else:
            ck[:, cache_index:cache_index + S] = (
                k.permute(2, 1, 0, 3).to(ck.dtype))
            cv[:, cache_index:cache_index + S] = (
                v.permute(2, 1, 0, 3).to(cv.dtype))
        if _fused_decode_ok(cfg, S, fused_ctx):
            attn = _attention_cached_flash(q, ck, cv, cfg, fused_ctx,
                                           trunk_len=trunk_len)
        elif _fused_decode_mq_ok(cfg, S, fused_ctx):
            attn = _attention_cached_flash_mq(q, ck, cv, cfg, fused_ctx,
                                              trunk_len=trunk_len)
        else:
            attn = _attention_cached(q, ck, cv, bias, cfg)
    elif attn_impl is not None:
        ck, cv = k, v
        attn = attn_impl(q, k, v, key_mask)
    else:
        ck, cv = k, v
        attn = _attention(q, k, v, bias, cfg, key_mask=key_mask)
    attn = mm(attn, lp["wo"])
    if cfg.attn_out_bias:
        attn = attn + lp["bo"]

    if cfg.parallel_block:
        mlp_in = h_attn_in if cfg.shared_block_ln else norm(x, lp["ln2"], cfg)
    elif fuse:
        x, mlp_in = _row_add_norm(x, attn, lp["ln2"], cfg)
    else:
        x = x + attn
        mlp_in = norm(x, lp["ln2"], cfg)

    mlp_q = (_shared_quant(mlp_in, lp["w_up"], lp["w_gate"])
             if cfg.gated_mlp else mlp_in)
    up = mm(mlp_q, lp["w_up"])
    if cfg.mlp_bias:
        up = up + lp["b_up"]
    if cfg.gated_mlp:
        gate = mm(mlp_q, lp["w_gate"])
        hidden = _act(gate, cfg.activation) * up
    else:
        hidden = _act(up, cfg.activation)
    mlp = mm(hidden, lp["w_down"])
    if cfg.mlp_bias:
        mlp = mlp + lp["b_down"]

    if fuse:
        return x, (ck, cv), mlp
    out = x + attn + mlp if cfg.parallel_block else x + mlp
    return out, (ck, cv), None


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, row_ops: bool = False) -> torch.Tensor:
    x = params["tok_embed"][tokens.long()]
    if cfg.pos_embedding == "learned":
        # Clip out-of-table positions to the last row (JAX mode="clip").
        table = params["pos_embed"]
        idx = torch.clamp(positions.long() + cfg.learned_pos_offset,
                          0, table.shape[0] - 1)
        x = x + table[idx]
    if cfg.embedding_norm:
        norm = _row_norm if row_ops else _norm
        x = norm(x, params["embed_ln"],
                 dataclasses.replace(cfg, norm="layernorm"))
    return x


def _head_weight(params: Params, cfg: ModelConfig):
    """The head as the logit product takes it: float32 dense, or the
    weight-only int8 QuantTensor."""
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head if isinstance(head, QuantTensor) else head.float()


def _head(cfg: ModelConfig, x: torch.Tensor, head) -> torch.Tensor:
    """Float32 logits of the (final-normed) x against ``_head_weight``."""
    if isinstance(head, QuantTensor):
        logits = _mm(x.float(), head)               # weight-only int8 head
    else:
        logits = torch.einsum("bsd,dv->bsv", x.float(), head)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.final_norm:
        x = _norm(x, params["final_ln"], cfg)
    return _head(cfg, x, _head_weight(params, cfg))


def _row_final(params: Params, cfg: ModelConfig, x: torch.Tensor,
               pending) -> torch.Tensor:
    """The decode step's and the verify window's x after the last block:
    its pending MLP output added (with the final norm in one
    :func:`_row_add_norm` launch) and the final norm taken."""
    if pending is not None:
        if not cfg.final_norm:
            return x + pending
        return _row_add_norm(x, pending, params["final_ln"], cfg)[1]
    return _row_norm(x, params["final_ln"], cfg) if cfg.final_norm else x


def _causal_bias(attn_mask, positions, cfg: ModelConfig, key_positions=None,
                 key_mask=None) -> torch.Tensor:
    """Additive float32 attention bias (B, H|1, S, T). ``positions`` are
    mask-aware indices (pads get 0); causality compares positions, so
    left-padded batches behave exactly like unpadded prompts."""
    if key_positions is None:
        key_positions, key_mask = positions, attn_mask
    return causal_bias(positions, key_mask, key_positions,
                       _slopes_or_none(cfg, positions.device))


def mask_positions(attn_mask: torch.Tensor) -> torch.Tensor:
    """Mask-aware position ids: pads -> 0, tokens -> 0..n-1 (left-pad safe)."""
    return torch.clamp_min(
        torch.cumsum(attn_mask, dim=-1, dtype=torch.int32) - 1, 0)


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------

def _run_blocks(params: Params, cfg: ModelConfig, x, sin, cos, bias, cache,
                cache_index, fused_ctx=None, trunk_len: int = 0,
                row_ops: bool = False):
    """The layer loop over the stacked params and cache (in place).
    Returns (x, pending): the last block's MLP output not yet added to x
    (``row_ops`` and sequential blocks), else None."""
    pending = None
    for i in range(cfg.n_layers):
        x, _, pending = _block(x, _layer(params["layers"], i), cfg, sin, cos,
                               bias, cache_map(lambda c: c[i], cache),
                               cache_index, fused_ctx=fused_ctx,
                               trunk_len=trunk_len, row_ops=row_ops,
                               pending=pending)
    return x, pending


def cache_map(fn, cache, *others):
    """``fn`` over the cache's leaves (and the matching leaves of
    ``others``), keeping its nesting: the float (ck, cv) pair or the int8
    ((kq, ks), (vq, vs)) pairs of pairs."""
    if isinstance(cache, (tuple, list)):
        return tuple(cache_map(fn, c, *(o[i] for o in others))
                     for i, c in enumerate(cache))
    return fn(cache, *others)


def cache_leaves(cache):
    """The cache's tensors in order (two float leaves, or kq, ks, vq,
    vs)."""
    if isinstance(cache, (tuple, list)):
        return [leaf for c in cache for leaf in cache_leaves(c)]
    return [cache]


def kv_cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                   dtype_bytes: int = 2) -> int:
    """Device bytes of one decode KV cache at (batch, max_len): an int8
    cache stores a 1-byte payload and a float32 scale a (kv head, slot,
    row) vector (the JAX package's ``models/cache.kv_cache_bytes``)."""
    per_side = cfg.n_layers * cfg.n_kv_heads * max_len * batch
    if cfg.kv_cache_int8:
        return 2 * (per_side * cfg.head_dim + per_side * 4)
    return 2 * per_side * cfg.head_dim * dtype_bytes


def _zeros_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, dev):
    shape = (cfg.n_layers, cfg.n_kv_heads, max_len, batch, cfg.head_dim)
    if cfg.kv_cache_int8:
        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return (side(), side())
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda"):
    """Per-layer KV cache stacked on the layer axis: an (L, K, T, B, hd)
    pair of ``dtype``, or with ``cfg.kv_cache_int8`` a (payload int8
    (L, K, T, B, hd), scale float32 (L, K, T, B)) pair each side."""
    return _zeros_cache(cfg, batch, max_len, dtype, resolve_device(device))


def gather_rows(cache, row_idx: torch.Tensor):
    """Broadcast/reorder KV-cache rows along the batch axis (axis 3 of
    every leaf, the int8 scales' too): the cross-cell prefix-reuse
    primitive. The grouped decode prefills one row per distinct prefix
    (G rows) and gathers it out to one row per member prompt (M rows,
    ``row_idx`` maps member -> group) before the members' suffix
    extension. A copy, as the JAX package's ``models/cache.gather_rows``."""
    idx = row_idx.long()
    return cache_map(lambda c: c.index_select(3, idx), cache)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            attn_mask: torch.Tensor, max_len: int, cache=None):
    """Run the prompt, fill the KV cache, return last-position logits.

    tokens/attn_mask: (B, S), LEFT padded (or right padded by the shared
    paths, which ignore the returned logits/positions). Returns
    (logits_last (B, V) float32, cache (L, K, max_len, B, hd) pair,
    next_positions (B,)). Slots past S are zeros, as the JAX prefill pads.
    With ``cfg.kv_cache_int8`` each layer's k/v are quantized into the
    int8 cache (payload and scales); the prompt's own attention reads
    the float k/v. ``cache``: buffers of this layout and extent to fill
    instead of new ones (the piggyback chain's carry), every slot
    overwritten.
    """
    B, S = tokens.shape
    positions = mask_positions(attn_mask)
    x = _embed(params, cfg, tokens, positions)
    sin = cos = None
    if cfg.pos_embedding == "rotary":
        sin, cos = _rope_sincos(positions, cfg.rotary_dim, cfg.rope_theta)
    # The flash route masks inside the kernel: no (B, H|1, S, S) bias.
    bias = (None if _flash_ok(cfg, S, S, attn_mask)
            else _causal_bias(attn_mask, positions, cfg))
    if cache is None:
        cache = _zeros_cache(cfg, B, max_len, x.dtype, x.device)
    else:
        cache_map(lambda c: c[:, :, S:].zero_(), cache)
    ck, cv = cache
    for i in range(cfg.n_layers):
        x, (k, v), _ = _block(x, _layer(params["layers"], i), cfg, sin, cos,
                              bias, None, None, key_mask=attn_mask)
        if cfg.kv_cache_int8:
            # Per vector over hd, then (B, S, K[, hd]) -> (K, S, B[, hd]).
            for side, t in ((ck, k), (cv, v)):
                tq, ts = _quant_kv(t)
                side[0][i, :, :S] = tq.permute(2, 1, 0, 3)
                side[1][i, :, :S] = ts.permute(2, 1, 0)
        else:
            ck[i, :, :S] = k.permute(2, 1, 0, 3)      # (B,S,K,hd) -> (K,S,B,hd)
            cv[i, :, :S] = v.permute(2, 1, 0, 3)
    logits = _unembed(params, cfg, x[:, -1:, :])[:, 0, :]
    next_positions = positions[:, -1] + 1
    return logits, cache, next_positions


def extend(params: Params, cfg: ModelConfig, cache, suffix_tokens: torch.Tensor,
           suffix_mask: torch.Tensor, cache_mask: torch.Tensor,
           start_index: int):
    """Teacher-forced multi-token cache extension (chunked prefill).

    Runs ``suffix_tokens`` (B, S2), RIGHT-padded, through the layers in one
    pass over the filled cache plus the suffix itself, writing the suffix
    k/v at slots [start_index, start_index + S2). ``cache_mask``: (B, T)
    validity over the FULL cache including the suffix slots. Returns
    (last-valid-position logits (B, V) float32, cache, next_positions (B,)).
    """
    B, S2 = suffix_tokens.shape
    key_positions = mask_positions(cache_mask)
    qpos = key_positions[:, start_index:start_index + S2]
    x = _embed(params, cfg, suffix_tokens, qpos)
    sin = cos = None
    if cfg.pos_embedding == "rotary":
        sin, cos = _rope_sincos(qpos, cfg.rotary_dim, cfg.rope_theta)
    if cfg.kv_cache_int8:
        # The int8 route builds its bias from the positions and the mask.
        bias, ctx = None, (qpos, cache_mask, key_positions)
    else:
        bias = _causal_bias(suffix_mask, qpos, cfg,
                            key_positions=key_positions, key_mask=cache_mask)
        ctx = None
    x, _ = _run_blocks(params, cfg, x, sin, cos, bias, cache, start_index,
                       fused_ctx=ctx)
    last = torch.clamp_min(suffix_mask.sum(dim=-1) - 1, 0).long()   # (B,)
    rows = torch.arange(B, device=x.device)
    logits = _unembed(params, cfg, x[rows, last][:, None, :])[:, 0, :]
    next_positions = qpos[rows, last] + 1
    return logits, cache, next_positions


def cascade_extend(params: Params, cfg: ModelConfig, trunk_cache,
                   rem_tokens: torch.Tensor, rem_mask: torch.Tensor,
                   trunk_len: int, total_len: int, int8_qk: bool = False):
    """Shared-trunk cascade prefill: build a B-row cache from ONE trunk.

    ``trunk_cache`` is a (L, K, Tt, 1, hd) pair computed once at batch 1
    (every slot real, slot == position). Each row's remainder
    ``rem_tokens``/``rem_mask`` (B, R), RIGHT-padded, runs through the
    layers attending via the cascade kernels (trunk leg + causal suffix
    leg, merged exactly; ``int8_qk`` quantizes the trunk leg's QK^T:
    every layer's trunk keys at once, one ``ops.quantize_rows`` over the
    (L * K * Tt, hd) rows, each layer's slice handed to its trunk leg).
    The returned cache broadcasts the trunk at slots [0, trunk_len),
    holds the remainder k/v at [trunk_len, trunk_len + R) and zeros up
    to ``total_len``. It needs a float cache (the engine gates the
    cascade off on an int8 one, as the JAX engine does).
    """
    if cfg.kv_cache_int8:
        raise ValueError("cascade prefill needs a float KV cache")
    B, R = rem_tokens.shape
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    qpos = trunk_len + mask_positions(rem_mask)                  # (B, R)
    x = _embed(params, cfg, rem_tokens, qpos)
    sin = cos = None
    if cfg.pos_embedding == "rotary":
        sin, cos = _rope_sincos(qpos, cfg.rotary_dim, cfg.rope_theta)
    tck, tcv = trunk_cache                                # (L, K, Tt, 1, hd)
    shape = (L, K, total_len, B, hd)
    ck = torch.zeros(shape, dtype=tck.dtype, device=tck.device)
    cv = torch.zeros(shape, dtype=tcv.dtype, device=tcv.device)
    ck[:, :, :trunk_len] = tck
    cv[:, :, :trunk_len] = tcv
    keys8 = None
    if int8_qk:
        Tt = tck.shape[2]
        kq, ks = ops.quantize_rows(tck.reshape(L * K * Tt, hd))
        keys8 = (kq.view(L, K, Tt, hd), ks.view(L, K, Tt))
    for i in range(L):
        tk = tck[i, :, :, 0].contiguous()
        tv = tcv[i, :, :, 0].contiguous()
        tk8 = None if keys8 is None else (keys8[0][i], keys8[1][i])

        def impl(q, k, v, key_mask, tk=tk, tv=tv, tk8=tk8):
            return _attention_cascade(q, k, v, (tk, tv), rem_mask, qpos, cfg,
                                      int8_qk, tk8)

        x, (k, v), _ = _block(x, _layer(params["layers"], i), cfg, sin, cos,
                              None, None, None, key_mask=rem_mask,
                              attn_impl=impl)
        ck[i, :, trunk_len:trunk_len + R] = k.permute(2, 1, 0, 3).to(ck.dtype)
        cv[i, :, trunk_len:trunk_len + R] = v.permute(2, 1, 0, 3).to(cv.dtype)
    return ck, cv


def decode_step(params: Params, cfg: ModelConfig, cache, token: torch.Tensor,
                position: torch.Tensor, step_index: int,
                prompt_mask: torch.Tensor, trunk_len: int = 0):
    """One greedy-decode step.

    token: (B,) current input; position: (B,) its mask-aware position;
    step_index: the cache slot this token's k/v land in, one for every
    row, or a (B,) tensor of each row's own slot (a fleet draft model's
    steps in the speculative loop's compacted windows); prompt_mask:
    (B, T) validity over the FULL cache. ``trunk_len`` marks the cache's
    leading row-identical trunk slots on a shared-trunk dispatch (used
    when ``cfg.cascade_decode``). Returns (logits (B, V) float32, cache).
    """
    B = token.shape[0]
    if isinstance(step_index, torch.Tensor):
        step_index = step_index.to(torch.long).reshape(B, 1)
    x = _embed(params, cfg, token[:, None], position[:, None], row_ops=True)
    sin = cos = None
    if cfg.pos_embedding == "rotary":
        sin, cos = _rope_sincos(position[:, None], cfg.rotary_dim,
                                cfg.rope_theta)
    key_positions = mask_positions(prompt_mask)
    bias = None
    if not cfg.fused_decode and not cfg.kv_cache_int8:
        ones = torch.ones((B, 1), dtype=torch.int32, device=token.device)
        bias = _causal_bias(ones, position[:, None], cfg,
                            key_positions=key_positions, key_mask=prompt_mask)
    x, pending = _run_blocks(
        params, cfg, x, sin, cos, bias, cache, step_index,
        fused_ctx=(position, prompt_mask, key_positions),
        trunk_len=int(trunk_len) if cfg.cascade_decode else 0, row_ops=True)
    x = _row_final(params, cfg, x, pending)
    logits = _head(cfg, x, _head_weight(params, cfg))[:, 0, :]
    return logits, cache


def verify_extend(params: Params, cfg: ModelConfig, cache,
                  chunk_tokens: torch.Tensor, cache_mask: torch.Tensor,
                  start_index, trunk_len: int = 0):
    """Teacher-forced VERIFY window (speculative decode): run the S-token
    draft window [current emission, drafts...] through the layers in one
    forward, writing its k/v in place at cache slots [start, start + S)
    and returning the logits at EVERY window position — the multi-query
    sibling of :func:`decode_step`. ``start_index`` is one slot for every
    row, or a (B,) tensor of each row's own start (the speculative loop
    starts each row's window at its next free slot).

    ``cache_mask`` is the FULL cache validity with the window's S slots
    already set. Positions derive from the mask's cumsum, so each query
    sits at its row's next logical position, and causality compares
    positions, so a query never sees a later draft. With
    ``cfg.fused_decode`` the window goes through the multi-query kernels
    (``trunk_len`` > 0 and ``cfg.cascade_decode``: the trunk-aware one);
    otherwise through the dense route, with the causal bias built here.

    The norms, adds and projections are the decode step's row-invariant
    ones (``row_ops``), and the head runs once per window position at the
    step's shape, so on the kernel route window position j gives the bits
    :func:`decode_step` gives for the same row, token, slot and cache.
    Returns (logits (B, S, V) float32, cache)."""
    B, S2 = chunk_tokens.shape
    key_positions = mask_positions(cache_mask)
    if isinstance(start_index, torch.Tensor):
        slots = (start_index.to(torch.long)[:, None]
                 + torch.arange(S2, device=cache_mask.device)[None, :])
        qpos = key_positions.gather(1, slots)
    else:
        slots = start_index
        qpos = key_positions[:, start_index:start_index + S2]
    x = _embed(params, cfg, chunk_tokens, qpos, row_ops=True)
    sin = cos = None
    if cfg.pos_embedding == "rotary":
        sin, cos = _rope_sincos(qpos, cfg.rotary_dim, cfg.rope_theta)
    bias = None
    if not cfg.fused_decode and not cfg.kv_cache_int8:
        ones = torch.ones((B, S2), dtype=torch.int32, device=x.device)
        bias = _causal_bias(ones, qpos, cfg, key_positions=key_positions,
                            key_mask=cache_mask)
    x, pending = _run_blocks(
        params, cfg, x, sin, cos, bias, cache, slots,
        fused_ctx=(qpos, cache_mask, key_positions),
        trunk_len=int(trunk_len) if cfg.cascade_decode else 0, row_ops=True)
    x = _row_final(params, cfg, x, pending)
    head = _head_weight(params, cfg)
    logits = torch.cat([_head(cfg, x[:, j:j + 1].contiguous(), head)
                        for j in range(S2)], dim=1)
    return logits, cache
