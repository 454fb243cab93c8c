"""Parameters of the JAX package, as numpy arrays, into the port.

``params_from_jax`` takes the tree ``lir_tpu.models.decoder.init_params``
or ``encdec.init_params`` (or a checkpoint loader) produces — given as
nested dicts of numpy arrays, never as JAX arrays, so this module needs
no JAX — and returns the port's parameter dict with the same layout on
``device``; int8 trees (``quantize_decoder_params``,
``quantize_encdec_params``) convert too. The two packages then
compute the same function, which is how the tests hold the port against
the reference.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from .quant import QuantTensor
from .registry import T5Config


def _expected_keys(cfg):
    """(top-level keys, {stacked subtree: its keys}) of ``cfg``'s tree:
    a decoder's one ``layers`` stack, or T5's ``encoder`` and
    ``decoder`` stacks."""
    if isinstance(cfg, T5Config):
        enc = {"ln_attn", "wq", "wk", "wv", "wo", "ln_mlp", "wo_mlp"}
        enc |= {"wi_0", "wi_1"} if cfg.gated_mlp else {"wi"}
        top = {"shared_embed", "enc_rel_embed", "dec_rel_embed", "encoder",
               "enc_final_ln", "decoder", "dec_final_ln"}
        if not cfg.tie_embeddings:
            top.add("lm_head")
        return top, {"encoder": enc,
                     "decoder": enc | {"ln_cross", "cq", "ck", "cv", "co"}}
    layers = {"ln1", "wq", "wk", "wv", "wo", "w_up", "w_down"}
    if not cfg.shared_block_ln:
        layers.add("ln2")
    if cfg.gated_mlp:
        layers.add("w_gate")
    if cfg.qkv_bias:
        layers |= {"bq", "bk", "bv"}
    if cfg.attn_out_bias:
        layers.add("bo")
    if cfg.mlp_bias:
        layers |= {"b_up", "b_down"}
    top = {"tok_embed", "layers"}
    if cfg.pos_embedding == "learned":
        top.add("pos_embed")
    if cfg.embedding_norm:
        top.add("embed_ln")
    if cfg.final_norm:
        top.add("final_ln")
    if not cfg.tie_embeddings:
        top.add("lm_head")
    return top, {"layers": layers}


def check_tree(tree: Mapping[str, Any], cfg, what: str = "param tree") -> None:
    """Raise unless ``tree`` has the keys ``cfg`` needs and every stack
    ``cfg.n_layers`` layers."""
    top, stacks = _expected_keys(cfg)
    if set(tree) != top:
        raise ValueError(f"{what} does not match {cfg.name}: top "
                         f"{sorted(tree)} vs {sorted(top)}")
    for side, keys in stacks.items():
        if set(tree[side]) != keys:
            raise ValueError(f"{what} does not match {cfg.name}: {side} "
                             f"{sorted(tree[side])} vs {sorted(keys)}")
        L = tree[side]["wq"].shape[0]
        if L != cfg.n_layers:
            raise ValueError(f"{what} has {L} {side}, {cfg.name} has "
                             f"{cfg.n_layers}")


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _is_quant(node) -> bool:
    """A quantized leaf of the JAX package (its ``QuantTensor``, numpy
    payload and scales), recognised by its attributes."""
    return all(hasattr(node, a) for a in ("q", "scale", "dynamic"))


def params_from_jax(tree: Mapping[str, Any], cfg, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """Convert a JAX-layout param tree of numpy arrays to the port's params.

    ``dtype`` casts every float leaf (None keeps each array's own dtype).
    A quantized leaf (the JAX ``QuantTensor`` with numpy ``q``/``scale``,
    as ``jax.tree.map(np.asarray, tree)`` leaves it) becomes the port's
    :class:`~lir_tpu_torch.models.quant.QuantTensor` with its int8
    payload, float32 scales and ``dynamic`` tag unchanged. Raises when
    the tree's keys do not match what ``cfg`` needs.
    """
    dev = resolve_device(device)
    check_tree(tree, cfg)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if _is_quant(node):
            # int8 payload and float32 scales keep their dtypes.
            return QuantTensor(q=_to_tensor(node.q, dev, None),
                               scale=_to_tensor(node.scale, dev, None),
                               dynamic=bool(node.dynamic))
        return _to_tensor(node, dev, dtype)

    return conv(tree)
