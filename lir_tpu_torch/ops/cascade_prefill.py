"""Shared-trunk cascade attention for one layer's remainder window.

Port of ``lir_tpu/ops/cascade_prefill.py:cascade_attention`` on both of
its routes, chosen as the JAX function chooses them:

- the FUSED route (``fused_suffix`` and not ``int8_qk``; TPU kernel
  ``_fused_cascade_kernel``): on a CUDA tensor one launch of the kernel
  of ``csrc/cascade_prefill.cu`` (trunk leg, suffix leg and merge);
- the TWO-LEG route (otherwise): the trunk-leg partials of every
  flattened query against the whole trunk (TPU kernel ``_prefix_kernel``),
  in float32 QK^T (:func:`cascade_prefix`) or with in-kernel int8 QK^T
  (:func:`cascade_prefix_int8`), on a CUDA tensor the trunk-leg kernels
  of the same source; then the suffix leg (:func:`suffix_partials`) and
  :func:`~lir_tpu_torch.ops.lse.merge_partials` in plain PyTorch, as
  they are XLA in the JAX package.

On a CPU tensor each wrapper runs its plain version: :func:`prefix_partials`
or :func:`prefix_partials_int8` for the trunk leg, and for the fused
route :func:`cascade_attention_plain` (the two-leg float function). On
bf16 tensors the fused kernel and the float-QK^T trunk leg run on tensor
cores (``csrc/attn_mma.cuh``), for the head dims of
``_build.TILE_HEAD_DIMS`` (another raises); float32 tensors take their
float32-exact CUDA-core kernels. The source notes in
``csrc/cascade_prefill.cu`` say what bounds the kernels on the H100 and
why they match their plain versions within float tolerance rather than
bitwise.

Layout (the JAX package's public shapes): q (B, R, H, hd); window k, v
(B, R, K, hd); trunk k, v (K, Tt, hd), one row, slot t is position t;
suffix_mask and q_positions (B, R); alibi_slopes (H,).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.quant import dynamic_quant
from . import _build
from .lse import merge_partials

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain version: the two-leg decomposition
# ---------------------------------------------------------------------------

def _trunk_softmax(s, trunk_v, slopes):
    """ALiBi on slot positions, then the partial softmax and PV of the
    trunk leg: (o, m, l) from scores (B, K, R, G, Tt)."""
    K, Tt = trunk_v.shape[0], trunk_v.shape[1]
    if slopes is not None:
        kp = torch.arange(Tt, device=s.device, dtype=torch.float32)
        s = s + slopes.float().reshape(1, K, 1, -1, 1) * kp
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkrgt,ktd->bkrgd", p, trunk_v.float())
    return o, m, p.sum(dim=-1)


def prefix_partials(q, trunk_k, trunk_v, slopes):
    """Trunk-leg partials (o, m, l) shaped (B, K, R, G, hd) / (B, K, R, G):
    every query against the whole trunk, no mask, ALiBi on slot
    positions, float32 QK^T."""
    B, R, H, hd = q.shape
    K = trunk_k.shape[0]
    qg = q.reshape(B, R, K, H // K, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("brkgd,ktd->bkrgt", qg, trunk_k.float())
    return _trunk_softmax(s, trunk_v, slopes)


def prefix_partials_int8(q, trunk_k, trunk_v, slopes):
    """:func:`prefix_partials` with int8 QK^T: each query row and each
    trunk key row quantized over hd by ``models.quant.dynamic_quant``,
    the s32 dot folded as ``f32(s32) * (q_scale * sm_scale) * k_scale``
    (the TPU kernel's order). The s32 dot runs as a float32 product of
    the payloads: every partial sum is an integer below
    hd * 127**2 < 2**24, so it is exact in any order (on a card with
    TF32 off)."""
    B, R, H, hd = q.shape
    K = trunk_k.shape[0]
    qq, qs = dynamic_quant(q.reshape(B, R, K, H // K, hd))
    kq, ks = dynamic_quant(trunk_k)                      # (K, Tt, hd), (K, Tt)
    s32 = torch.einsum("brkgd,ktd->bkrgt", qq.float(), kq.float())
    qsm = (qs * (1.0 / math.sqrt(hd))).permute(0, 2, 1, 3)   # (B, K, R, G)
    s = s32 * qsm[..., None] * ks[None, :, None, None, :]
    return _trunk_softmax(s, trunk_v, slopes)


def suffix_partials(q, sfx_k, sfx_v, suffix_mask, q_positions, slopes):
    """Suffix-leg partials over each row's own window: causal on the
    mask-aware positions, ALiBi on key positions. A fully-masked query
    row gives m = -inf, l = 0 and defers to the trunk leg."""
    B, R, H, hd = q.shape
    K = sfx_k.shape[2]
    G = H // K
    qg = q.reshape(B, R, K, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("brkgd,btkd->bkrgt", qg, sfx_k.float())
    kp = q_positions.float()                                # keys = queries
    if slopes is not None:
        s = s + (slopes.float().reshape(1, K, 1, G, 1)
                 * kp[:, None, None, None, :])
    valid = ((suffix_mask[:, None, :] > 0)
             & (q_positions[:, None, :] <= q_positions[:, :, None]))
    s = s.masked_fill(~valid[:, None, :, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.where(torch.isfinite(s), torch.exp(s - m[..., None]),
                    torch.zeros((), device=s.device))
    o = torch.einsum("bkrgt,btkd->bkrgd", p, sfx_v.float())
    return o, m, p.sum(dim=-1)


def _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask, q_positions,
             alibi_slopes, trunk_leg) -> torch.Tensor:
    """The two-leg route: ``trunk_leg`` partials + suffix partials +
    merge, in float32. (B, R, H, hd) in q's dtype."""
    B, R, H, hd = q.shape
    o_t, m_t, l_t = trunk_leg(q, trunk_k, trunk_v, alibi_slopes)
    o_s, m_s, l_s = suffix_partials(q, sfx_k, sfx_v, suffix_mask,
                                    q_positions, alibi_slopes)
    out = merge_partials(torch.stack([o_t, o_s], dim=2),
                         torch.stack([m_t, m_s], dim=2),
                         torch.stack([l_t, l_s], dim=2), axis=2)
    return out.permute(0, 2, 1, 3, 4).reshape(B, R, H, hd).to(q.dtype)


def cascade_attention_plain(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                            q_positions, alibi_slopes=None) -> torch.Tensor:
    """The fused kernel's function: the float two-leg route, written out.
    (B, R, H, hd) in q's dtype."""
    return _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                    q_positions, alibi_slopes, prefix_partials)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("cascade_prefill")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lir_cascade_attention.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.lir_cascade_attention.restype = i
        lib.lir_cascade_prefix.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.lir_cascade_prefix.restype = i
        _LIB = lib
    return _LIB


def _cascade_cuda(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                  q_positions, alibi_slopes) -> torch.Tensor:
    if q.dtype not in _DTYPES:
        raise TypeError(f"cascade kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or sfx_k.dim() != 4 or trunk_k.dim() != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)} window "
                         f"{tuple(sfx_k.shape)} trunk {tuple(trunk_k.shape)}")
    B, R, H, hd = q.shape
    K, Tt = trunk_k.shape[0], trunk_k.shape[1]
    if (tuple(sfx_k.shape) != (B, R, K, hd) or sfx_v.shape != sfx_k.shape
            or tuple(trunk_k.shape) != (K, Tt, hd)
            or trunk_v.shape != trunk_k.shape or H % K):
        raise ValueError(f"q {tuple(q.shape)}, window {tuple(sfx_k.shape)} and "
                         f"trunk {tuple(trunk_k.shape)} do not match")
    for name, t in (("sfx_k", sfx_k), ("sfx_v", sfx_v), ("trunk_k", trunk_k),
                    ("trunk_v", trunk_v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"cascade kernel needs a contiguous {name}")
    if not q.is_contiguous():
        raise ValueError("cascade kernel needs a contiguous q")
    if q.dtype == torch.bfloat16:
        # The tensor-core route: tiles built for these head dims, rows
        # copied 16 bytes at a time.
        if hd not in _build.TILE_HEAD_DIMS:
            raise ValueError(f"bf16 cascade kernel is built for head dims "
                             f"{_build.TILE_HEAD_DIMS}, got {hd}")
        for name, t in (("q", q), ("sfx_k", sfx_k), ("sfx_v", sfx_v),
                        ("trunk_k", trunk_k), ("trunk_v", trunk_v)):
            if t.data_ptr() % 16:
                raise ValueError(f"bf16 cascade kernel needs a 16-byte "
                                 f"aligned {name}")
    for name, t in (("suffix_mask", suffix_mask), ("q_positions", q_positions)):
        if tuple(t.shape) != (B, R) or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {(B, R)} on {q.device}")
    smask = suffix_mask.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    G = H // K
    slopes_rg = None
    if alibi_slopes is not None:
        # Per-flattened-row slopes (row n = r * G + g of kv head kh uses
        # head kh * G + g), built here as the JAX wrapper builds them.
        slopes_rg = (alibi_slopes.to(device=q.device, dtype=torch.float32)
                     .reshape(K, 1, G).expand(K, R, G).reshape(K, R * G)
                     .contiguous())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(_lib().lir_cascade_attention(
        q.data_ptr(), sfx_k.data_ptr(), sfx_v.data_ptr(), trunk_k.data_ptr(),
        trunk_v.data_ptr(), smask.data_ptr(), qpos.data_ptr(),
        None if slopes_rg is None else slopes_rg.data_ptr(), out.data_ptr(),
        B, R, H, K, Tt, hd, _DTYPES[q.dtype], stream), "cascade_attention")
    return out


def _prefix_cuda(q, trunk_k, trunk_v, alibi_slopes, int8_qk: bool):
    """Launch the trunk-leg kernel: (o, m, l) float32 partials shaped
    (B, K, R, G, hd) / (B, K, R, G), as :func:`prefix_partials`."""
    if q.device.type != "cuda":
        raise ValueError(f"trunk-leg kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"trunk-leg kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or trunk_k.dim() != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)} trunk {tuple(trunk_k.shape)}")
    B, R, H, hd = q.shape
    K, Tt = trunk_k.shape[0], trunk_k.shape[1]
    if (tuple(trunk_k.shape) != (K, Tt, hd) or trunk_v.shape != trunk_k.shape
            or H % K):
        raise ValueError(f"q {tuple(q.shape)} and trunk {tuple(trunk_k.shape)} "
                         f"do not match")
    if hd not in _build.TILE_HEAD_DIMS:
        raise ValueError(f"trunk-leg kernel is built for head dims "
                         f"{_build.TILE_HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("trunk_k", trunk_k), ("trunk_v", trunk_v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"trunk-leg kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    G = H // K
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, K, R, G, hd), **f32)
    m = torch.empty((B, K, R, G), **f32)
    l = torch.empty((B, K, R, G), **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(_lib().lir_cascade_prefix(
        q.data_ptr(), trunk_k.data_ptr(), trunk_v.data_ptr(),
        None if slopes is None else slopes.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, R, H, K, Tt, hd, _DTYPES[q.dtype],
        int(int8_qk), stream), "cascade_prefix_int8" if int8_qk else "cascade_prefix")
    return o, m, l


def cascade_prefix(q, trunk_k, trunk_v, alibi_slopes=None):
    """Trunk-leg partials of the two-leg route, float32 QK^T. CUDA
    tensors launch the kernel of ``csrc/cascade_prefill.cu``; CPU tensors
    run :func:`prefix_partials`."""
    if q.device.type == "cpu":
        return prefix_partials(q, trunk_k, trunk_v, alibi_slopes)
    out = _prefix_cuda(q, trunk_k, trunk_v, alibi_slopes, int8_qk=False)
    cascade_prefix.launches += 1
    return out


def cascade_prefix_int8(q, trunk_k, trunk_v, alibi_slopes=None):
    """Trunk-leg partials of the two-leg route, int8 QK^T quantized in
    the kernel. CUDA tensors launch the kernel of
    ``csrc/cascade_prefill.cu``; CPU tensors run
    :func:`prefix_partials_int8`."""
    if q.device.type == "cpu":
        return prefix_partials_int8(q, trunk_k, trunk_v, alibi_slopes)
    out = _prefix_cuda(q, trunk_k, trunk_v, alibi_slopes, int8_qk=True)
    cascade_prefix_int8.launches += 1
    return out


def cascade_attention(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                      q_positions, alibi_slopes=None, int8_qk: bool = False,
                      fused_suffix: bool = True) -> torch.Tensor:
    """Shared-trunk cascade attention: softmax over trunk + window keys,
    exact. Returns (B, R, H, hd) in q's dtype.

    ``fused_suffix`` without ``int8_qk`` takes the fused route: CUDA
    tensors launch the fused kernel, CPU tensors run
    :func:`cascade_attention_plain`. Otherwise the two-leg route: the
    trunk leg through :func:`cascade_prefix_int8` (``int8_qk``) or
    :func:`cascade_prefix`, then the suffix leg and the merge."""
    if fused_suffix and not int8_qk:
        if q.device.type == "cpu":
            return cascade_attention_plain(q, sfx_k, sfx_v, trunk_k, trunk_v,
                                           suffix_mask, q_positions,
                                           alibi_slopes)
        if q.device.type != "cuda":
            raise ValueError(f"cascade kernel needs CUDA tensors, got {q.device}")
        out = _cascade_cuda(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                            q_positions, alibi_slopes)
        cascade_attention.launches += 1
        return out
    return _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                    q_positions, alibi_slopes,
                    cascade_prefix_int8 if int8_qk else cascade_prefix)


cascade_attention.launches = 0
cascade_prefix.launches = 0
cascade_prefix_int8.launches = 0
