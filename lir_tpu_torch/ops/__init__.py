"""The port's kernels: the single import point for every attention kernel.

- ``flash_decode``: one decode step of single-query attention over the
  cache (``csrc/flash_decode.cu``: row-split kernel + merge kernel).
- ``flash_decode_trunk``: the trunk-aware decode step of shared-trunk
  dispatches (the same source: trunk kernel + row-split kernel over the
  tail + merge), bitwise the flat kernel.
- ``flash_decode_mq`` / ``flash_decode_mq_trunk``: the speculative
  verify window, S queries per row (the same source and kernels, which
  take S queries a row); query j bitwise ``flash_decode``, the trunk
  variant bitwise the flat one.
- ``cascade_attention``: the shared-trunk prefill window. Its fused
  route is one kernel (``csrc/cascade_prefill.cu``); its two-leg route
  runs the trunk-leg kernels ``cascade_prefix`` (float32 QK^T) or
  ``cascade_prefix_int8`` (int8 QK^T on the trunk keys' ``quantize_rows``
  payload, which ``decoder.cascade_extend`` makes for every layer at
  once) of the same source, then ``cascade_suffix_merge`` (suffix leg
  and merge, a persistent TMA + wgmma kernel), whose arithmetic and key
  tiles are the fused kernel's: fused == two-leg bitwise on the card.
- ``flash_attention``: prefill self-attention, causal with a key mask
  of any pattern (``csrc/flash_attention.cu``).
- ``merge_partials``: the log-sum-exp merge of partials (plain PyTorch;
  the kernels run it in device code).
- ``row_gemm`` / ``row_norm`` / ``row_add_norm``: the bf16 projections,
  norms and residual-add-then-norms of the decode step and the verify
  window, each row reduced in one fixed order whatever the number of
  rows (``csrc/row_gemm.cu``), so a window's row is bitwise the step's.
- ``stream_fold``: the sweep's streaming-statistics fold, one dispatch's
  readouts into the (P, R) accumulator lattice in place
  (``csrc/stream_fold.cu``; the counterpart of the JAX package's XLA
  ``fold_update``).
- ``gumbel_argmax``: temperature sampling, each row's next token by the
  Gumbel-max trick on JAX's threefry draws (``csrc/sample.cu``; the
  counterpart of the JAX package's XLA ``jax.random.categorical``).
- ``kv_int8_attention``: the cached attention of an int8 KV cache (the
  chunked extension, the decode step and the verify window), both
  products s8 x s8 -> s32 with the query and the value-scaled
  probabilities quantized per vector (``csrc/kv_int8_attention.cu``; the
  counterpart of the JAX package's XLA ``_attention_cached_int8``).

Each wrapper keeps a plain int ``launches`` that it raises by one where
it launches its CUDA kernel, and nowhere else (``flash_attention`` also
counts each route in ``route_launches``); :func:`reset_launches` and
:func:`launch_counts` read them together.
"""

from __future__ import annotations

from typing import Dict

from .cascade_prefill import (cascade_attention, cascade_attention_plain,
                              cascade_prefix, cascade_prefix_int8,
                              cascade_suffix_merge, prefix_partials,
                              prefix_partials_int8, quantize_rows,
                              suffix_merge_plain)
from .flash_attention import flash_attention, flash_attention_plain
from .kv_int8_attention import kv_int8_attention, kv_int8_attention_plain
from .flash_decode import (DECODE_SPLIT, flash_decode, flash_decode_mq,
                           flash_decode_mq_plain, flash_decode_mq_trunk,
                           flash_decode_mq_trunk_plain, flash_decode_plain,
                           flash_decode_trunk, flash_decode_trunk_plain)
from .lse import merge_partials
from .row_gemm import (gemm_splits, row_add_norm, row_add_norm_plain,
                       row_gemm, row_gemm_plain, row_norm, row_norm_plain)
from .sample import gumbel_argmax, gumbel_argmax_plain
from .stream_fold import stream_fold, stream_fold_plain

KERNELS = {
    "flash_decode": flash_decode,
    "flash_decode_trunk": flash_decode_trunk,
    "cascade_attention": cascade_attention,
    "flash_decode_mq": flash_decode_mq,
    "flash_decode_mq_trunk": flash_decode_mq_trunk,
    "cascade_prefix": cascade_prefix,
    "cascade_prefix_int8": cascade_prefix_int8,
    "flash_attention": flash_attention,
    "row_gemm": row_gemm,
    "row_norm": row_norm,
    "row_add_norm": row_add_norm,
    "cascade_suffix_merge": cascade_suffix_merge,
    "quantize_rows": quantize_rows,
    "stream_fold": stream_fold,
    "gumbel_argmax": gumbel_argmax,
    "kv_int8_attention": kv_int8_attention,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.route_launches = dict.fromkeys(
        flash_attention.route_launches, 0)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "DECODE_SPLIT", "KERNELS", "cascade_attention", "cascade_attention_plain",
    "cascade_prefix", "cascade_prefix_int8", "cascade_suffix_merge",
    "flash_attention", "gumbel_argmax", "gumbel_argmax_plain",
    "quantize_rows", "suffix_merge_plain",
    "flash_attention_plain", "flash_decode", "flash_decode_mq",
    "flash_decode_mq_plain", "flash_decode_mq_trunk",
    "flash_decode_mq_trunk_plain", "flash_decode_plain", "flash_decode_trunk",
    "flash_decode_trunk_plain", "launch_counts", "merge_partials",
    "prefix_partials", "prefix_partials_int8", "reset_launches",
    "gemm_splits", "kv_int8_attention", "kv_int8_attention_plain",
    "row_add_norm", "row_add_norm_plain", "row_gemm",
    "row_gemm_plain", "row_norm", "row_norm_plain", "stream_fold",
    "stream_fold_plain",
]
