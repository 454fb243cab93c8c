"""Shared-trunk cascade attention for one layer's remainder window.

Port of ``lir_tpu/ops/cascade_prefill.py:cascade_attention`` on both of
its routes, chosen as the JAX function chooses them:

- the FUSED route (``fused_suffix`` and not ``int8_qk``; TPU kernel
  ``_fused_cascade_kernel``): on a CUDA tensor one launch of the kernel
  of ``csrc/cascade_prefill.cu`` (trunk leg, suffix leg and merge);
- the TWO-LEG route (otherwise): the trunk-leg partials of every
  flattened query against the whole trunk (TPU kernel ``_prefix_kernel``),
  in float32 QK^T (:func:`cascade_prefix`) or int8 QK^T
  (:func:`cascade_prefix_int8`; on bf16 after :func:`quantize_rows` of
  the trunk keys), then the suffix leg and the merge
  (:func:`cascade_suffix_merge`; XLA in the JAX package). On a CUDA
  tensor each is a kernel of the same source.

On a CUDA tensor the fused route is BITWISE the two-leg route with float
QK^T, as the JAX package's fused kernel is: the fused kernel walks the
trunk with the trunk leg's own code, then the window, then merges in
``merge_partials``' order, and the suffix merge walks the window in the
same tiles with the same arithmetic (on wgmma, which gives mma.sync's
bits for the same chains) and merges the same way after a read of the
trunk partials. On a CPU tensor each wrapper runs its plain
version: :func:`prefix_partials` or :func:`prefix_partials_int8` for the
trunk leg, :func:`suffix_merge_plain` for the suffix merge, and
:func:`cascade_attention_plain` (the two-leg float function) for the
fused route. bf16 tensors run on tensor cores (``csrc/attn_mma.cuh``;
the int8 trunk leg on IMMA) and float32 tensors on float32-exact
CUDA-core kernels, for the head dims of ``_build.TILE_HEAD_DIMS``
(another raises). The source notes in ``csrc/cascade_prefill.cu`` say
what bounds the kernels on the H100 and why they match their plain
versions within float tolerance rather than bitwise.

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


def prefix_partials_int8(q, trunk_k, trunk_v, slopes, trunk_k_int8=None):
    """:func:`prefix_partials` with int8 QK^T: each query row and each
    trunk key row quantized over hd by ``models.quant.dynamic_quant``,
    the s32 dot folded as ``f32(s32) * (q_scale * sm_scale) * k_scale``
    (the TPU kernel's order). ``trunk_k_int8``: the trunk keys' (payload
    (K, Tt, hd), scales (K, Tt)) quantized already by the same rule (a
    layer's slice of one quantization of every layer's keys), used as
    they are. The s32 dot runs as a float32 product of the payloads:
    every partial sum is an integer below hd * 127**2 < 2**24, so it is
    exact in any order (on a card with TF32 off)."""
    B, R, H, hd = q.shape
    K = trunk_k.shape[0]
    qq, qs = dynamic_quant(q.reshape(B, R, K, H // K, hd))
    kq, ks = (dynamic_quant(trunk_k) if trunk_k_int8 is None
              else trunk_k_int8)                         # (K, Tt, hd), (K, Tt)
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


def suffix_merge_plain(q, sfx_k, sfx_v, o_t, m_t, l_t, suffix_mask,
                       q_positions, alibi_slopes=None) -> torch.Tensor:
    """The two-leg route after its trunk leg: the suffix partials and the
    merge with the trunk partials (o_t, m_t, l_t), in float32.
    (B, R, H, hd) in q's dtype."""
    B, R, H, hd = q.shape
    o_s, m_s, l_s = suffix_partials(q, sfx_k, sfx_v, suffix_mask,
                                    q_positions, alibi_slopes)
    out = merge_partials(torch.stack([o_t, o_s], dim=2),
                         torch.stack([m_t, m_s], dim=2),
                         torch.stack([l_t, l_s], dim=2), axis=2)
    return out.permute(0, 2, 1, 3, 4).reshape(B, R, H, hd).to(q.dtype)


def _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask, q_positions,
             alibi_slopes, trunk_leg, **trunk_kw) -> torch.Tensor:
    """The two-leg route: ``trunk_leg`` partials, then
    :func:`cascade_suffix_merge` (suffix partials + merge).
    (B, R, H, hd) in q's dtype."""
    o_t, m_t, l_t = trunk_leg(q, trunk_k, trunk_v, alibi_slopes, **trunk_kw)
    return cascade_suffix_merge(q, sfx_k, sfx_v, o_t, m_t, l_t, suffix_mask,
                                q_positions, alibi_slopes)


def cascade_attention_plain(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                            q_positions, alibi_slopes=None) -> torch.Tensor:
    """The fused kernel's function: the float two-leg route, written out
    in plain PyTorch on any device. (B, R, H, hd) in q's dtype."""
    return suffix_merge_plain(q, sfx_k, sfx_v,
                              *prefix_partials(q, trunk_k, trunk_v,
                                               alibi_slopes),
                              suffix_mask, q_positions, alibi_slopes)


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
        lib.lir_cascade_suffix_merge.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.lir_cascade_suffix_merge.restype = i
        lib.lir_cascade_prefix.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.lir_cascade_prefix.restype = i
        for fn in (lib.lir_quantize_rows, lib.lir_quantize_rows_f32):
            fn.argtypes = [p] * 3 + [i] * 2 + [p]
            fn.restype = i
        _LIB = lib
    return _LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_same(q, named) -> None:
    """Every tensor of ``named`` on q's device in q's dtype, contiguous and
    16-byte aligned (the kernels copy rows 16 bytes at a time)."""
    for name, t in named:
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"cascade kernels need a contiguous, 16-byte "
                             f"aligned {name}")


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"cascade kernels need CUDA tensors, got {q.device}")


def _check_q(q):
    """q (B, R, H, hd) in a dtype and head dim the kernels are built for."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"cascade kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"bad shape q {tuple(q.shape)}")
    hd = q.shape[-1]
    if hd not in _build.TILE_HEAD_DIMS:
        raise ValueError(f"cascade kernels are built for head dims "
                         f"{_build.TILE_HEAD_DIMS}, got {hd}")


def _window_args(q, sfx_k, sfx_v, suffix_mask, q_positions, alibi_slopes,
                 K: int):
    """Checked window inputs: the int32 mask and positions and the
    float32 (H,) slopes (or None)."""
    B, R, H, hd = q.shape
    if tuple(sfx_k.shape) != (B, R, K, hd) or sfx_v.shape != sfx_k.shape or H % K:
        raise ValueError(f"q {tuple(q.shape)} and window {tuple(sfx_k.shape)} "
                         f"do not match {K} kv heads")
    _check_same(q, (("q", q), ("sfx_k", sfx_k), ("sfx_v", sfx_v)))
    ints = []
    for name, t in (("suffix_mask", suffix_mask), ("q_positions", q_positions)):
        if tuple(t.shape) != (B, R) or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {(B, R)} on {q.device}")
        ints.append(t.to(torch.int32).contiguous())
    slopes = None
    if alibi_slopes is not None:
        if tuple(alibi_slopes.shape) != (H,):
            raise ValueError(f"alibi_slopes is {tuple(alibi_slopes.shape)}, "
                             f"expected ({H},)")
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    return ints[0], ints[1], slopes


def _check_trunk(q, trunk_k, trunk_v):
    B, R, H, hd = q.shape
    if trunk_k.dim() != 3 or trunk_k.shape[2] != hd or trunk_v.shape != trunk_k.shape:
        raise ValueError(f"q {tuple(q.shape)} and trunk {tuple(trunk_k.shape)} "
                         f"do not match")
    _check_same(q, (("trunk_k", trunk_k), ("trunk_v", trunk_v)))
    return trunk_k.shape[0], trunk_k.shape[1]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cascade_cuda(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                  q_positions, alibi_slopes) -> torch.Tensor:
    _check_q(q)
    K, Tt = _check_trunk(q, trunk_k, trunk_v)
    smask, qpos, slopes = _window_args(q, sfx_k, sfx_v, suffix_mask,
                                       q_positions, alibi_slopes, K)
    B, R, H, hd = q.shape
    out = torch.empty_like(q)
    _build.check(_lib().lir_cascade_attention(
        q.data_ptr(), sfx_k.data_ptr(), sfx_v.data_ptr(), trunk_k.data_ptr(),
        trunk_v.data_ptr(), smask.data_ptr(), qpos.data_ptr(), _ptr(slopes),
        out.data_ptr(), B, R, H, K, Tt, hd, _DTYPES[q.dtype], _stream(q)),
        "cascade_attention")
    return out


def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of (..., hd) by the dynamic rule of
    ``models.quant.dynamic_quant``: (int8 payload (..., hd), float32
    scales (...)), the pair the int8 trunk leg reads. CUDA tensors (bf16
    or float32, hd a multiple of 16 up to 128) launch
    ``csrc/cascade_prefill.cu``'s pass, bitwise the plain rule, once for
    any number of rows (``decoder.cascade_extend`` hands it every layer's
    trunk keys at once); CPU tensors run
    :func:`~lir_tpu_torch.models.quant.dynamic_quant`."""
    if x.device.type == "cpu":
        return dynamic_quant(x)
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise TypeError(f"the quantization pass takes bfloat16 or float32 "
                        f"CUDA tensors, got {x.dtype} on {x.device}")
    hd = x.shape[-1]
    if hd % 16 or hd > 128 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the quantization pass needs a contiguous, 16-byte "
                         f"aligned input of width a multiple of 16 up to 128, "
                         f"got {tuple(x.shape)}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = x.numel() // hd
    if rows:
        entry = (_lib().lir_quantize_rows if x.dtype == torch.bfloat16
                 else _lib().lir_quantize_rows_f32)
        _build.check(entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, hd,
                           _stream(x)), "quantize_rows")
        quantize_rows.launches += 1
    return q, s


def _check_keys_int8(trunk_k, trunk_k_int8):
    """The pre-quantized trunk keys: an int8 payload shaped as the keys,
    float32 scales over their rows, contiguous on the keys' device."""
    kq, ks = trunk_k_int8
    if (kq.dtype != torch.int8 or ks.dtype != torch.float32
            or kq.shape != trunk_k.shape or ks.shape != trunk_k.shape[:-1]
            or kq.device != trunk_k.device or ks.device != trunk_k.device
            or not (kq.is_contiguous() and ks.is_contiguous())):
        raise ValueError(f"trunk_k_int8 must be a contiguous int8 payload "
                         f"{tuple(trunk_k.shape)} and float32 scales "
                         f"{tuple(trunk_k.shape[:-1])} on {trunk_k.device}")
    return kq, ks


def _prefix_cuda(q, trunk_k, trunk_v, alibi_slopes, int8_qk: bool,
                 trunk_k_int8=None):
    """Launch the trunk-leg kernel: (o, m, l) float32 partials shaped
    (B, K, R, G, hd) / (B, K, R, G), as :func:`prefix_partials`. With
    int8 QK^T the kernel reads the trunk keys quantized apart:
    ``trunk_k_int8`` where given, else :func:`quantize_rows` of them
    (once per key); bf16 runs on IMMA."""
    _check_cuda(q)
    _check_q(q)
    K, Tt = _check_trunk(q, trunk_k, trunk_v)
    B, R, H, hd = q.shape
    if H % K:
        raise ValueError(f"{H} query heads over {K} kv heads")
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    tk, tks = trunk_k, None
    if int8_qk:
        tk, tks = (quantize_rows(trunk_k) if trunk_k_int8 is None
                   else _check_keys_int8(trunk_k, trunk_k_int8))
    G = H // K
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, K, R, G, hd), **f32)
    m = torch.empty((B, K, R, G), **f32)
    l = torch.empty((B, K, R, G), **f32)
    _build.check(_lib().lir_cascade_prefix(
        q.data_ptr(), tk.data_ptr(), _ptr(tks), trunk_v.data_ptr(),
        _ptr(slopes), o.data_ptr(), m.data_ptr(), l.data_ptr(), B, R, H, K,
        Tt, hd, _DTYPES[q.dtype], int(int8_qk), _stream(q)),
        "cascade_prefix_int8" if int8_qk else "cascade_prefix")
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


def cascade_prefix_int8(q, trunk_k, trunk_v, alibi_slopes=None,
                        trunk_k_int8=None):
    """Trunk-leg partials of the two-leg route, int8 QK^T. CUDA tensors
    launch the kernels of ``csrc/cascade_prefill.cu``: the trunk keys'
    quantization pass (:func:`quantize_rows`; not where ``trunk_k_int8``
    hands over its (payload, scales) pair), then s8 QK^T (bf16: on IMMA;
    float32: in the CUDA-core kernel); CPU tensors run
    :func:`prefix_partials_int8`."""
    if q.device.type == "cpu":
        return prefix_partials_int8(q, trunk_k, trunk_v, alibi_slopes,
                                    trunk_k_int8)
    out = _prefix_cuda(q, trunk_k, trunk_v, alibi_slopes, int8_qk=True,
                       trunk_k_int8=trunk_k_int8)
    cascade_prefix_int8.launches += 1
    return out


def cascade_suffix_merge(q, sfx_k, sfx_v, o_t, m_t, l_t, suffix_mask,
                         q_positions, alibi_slopes=None) -> torch.Tensor:
    """The two-leg route's suffix leg and merge over the trunk partials
    (o_t, m_t, l_t) of :func:`cascade_prefix` or
    :func:`cascade_prefix_int8`. Returns (B, R, H, hd) in q's dtype.

    CUDA tensors launch ``csrc/cascade_prefill.cu``'s suffix merge (bf16:
    the persistent TMA + wgmma ``suffix_merge_kernel``), whose window
    walk and merge are the fused kernel's arithmetic on the same tiles,
    so the route is bitwise the fused kernel (float QK^T); CPU tensors
    run :func:`suffix_merge_plain`."""
    if q.device.type == "cpu":
        return suffix_merge_plain(q, sfx_k, sfx_v, o_t, m_t, l_t, suffix_mask,
                                  q_positions, alibi_slopes)
    _check_cuda(q)
    _check_q(q)
    B, R, H, hd = q.shape
    if sfx_k.dim() != 4:
        raise ValueError(f"bad window shape {tuple(sfx_k.shape)}")
    K = sfx_k.shape[2]
    smask, qpos, slopes = _window_args(q, sfx_k, sfx_v, suffix_mask,
                                       q_positions, alibi_slopes, K)
    G = H // K
    for name, t, shape in (("o_t", o_t, (B, K, R, G, hd)),
                           ("m_t", m_t, (B, K, R, G)),
                           ("l_t", l_t, (B, K, R, G))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    out = torch.empty_like(q)
    _build.check(_lib().lir_cascade_suffix_merge(
        q.data_ptr(), sfx_k.data_ptr(), sfx_v.data_ptr(), o_t.data_ptr(),
        m_t.data_ptr(), l_t.data_ptr(), smask.data_ptr(), qpos.data_ptr(),
        _ptr(slopes), out.data_ptr(), B, R, H, K, hd, _DTYPES[q.dtype],
        _stream(q)), "cascade_suffix_merge")
    cascade_suffix_merge.launches += 1
    return out


def cascade_attention(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                      q_positions, alibi_slopes=None, int8_qk: bool = False,
                      fused_suffix: bool = True,
                      trunk_k_int8=None) -> torch.Tensor:
    """Shared-trunk cascade attention: softmax over trunk + window keys,
    exact. Returns (B, R, H, hd) in q's dtype.

    ``fused_suffix`` without ``int8_qk`` takes the fused route: CUDA
    tensors launch the fused kernel, CPU tensors run
    :func:`cascade_attention_plain`. Otherwise the two-leg route: the
    trunk leg through :func:`cascade_prefix_int8` (``int8_qk``, which
    takes the trunk keys' pre-quantized ``trunk_k_int8`` pair where
    given) or :func:`cascade_prefix`, then :func:`cascade_suffix_merge`."""
    if trunk_k_int8 is not None and not int8_qk:
        raise ValueError("trunk_k_int8 is the int8 trunk leg's: pass int8_qk")
    if fused_suffix and not int8_qk:
        if q.device.type == "cpu":
            return cascade_attention_plain(q, sfx_k, sfx_v, trunk_k, trunk_v,
                                           suffix_mask, q_positions,
                                           alibi_slopes)
        _check_cuda(q)
        out = _cascade_cuda(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                            q_positions, alibi_slopes)
        cascade_attention.launches += 1
        return out
    if int8_qk:
        return _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                        q_positions, alibi_slopes, cascade_prefix_int8,
                        trunk_k_int8=trunk_k_int8)
    return _two_leg(q, sfx_k, sfx_v, trunk_k, trunk_v, suffix_mask,
                    q_positions, alibi_slopes, cascade_prefix)


cascade_attention.launches = 0
cascade_prefix.launches = 0
cascade_prefix_int8.launches = 0
cascade_suffix_merge.launches = 0
quantize_rows.launches = 0
