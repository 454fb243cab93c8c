"""Prefill flash attention: exact self-attention without the (S, S) scores.

Port of ``lir_tpu/ops/flash_attention.py:flash_attention`` (TPU kernel
``_flash_kernel``). On a CUDA tensor the wrapper launches a hand-written
kernel of ``csrc/flash_attention.cu``, by shape (:func:`route`): bf16 at
head dims 64 and 128 the persistent TMA + wgmma kernel, bf16 at the
other tile head dims the mma.sync kernel, float32 the CUDA-core kernel.
On a CPU tensor it runs the plain PyTorch version beside them. The
source note in ``csrc/flash_attention.cu`` says what bounds the kernels
on the H100 and what their design does about that.

The function: causal on slot indices (key j <= query i), keys masked by a
(B, S) key mask of any pattern, ALiBi as ``slope_h * key_position`` on
mask-aware positions, softmax in float32; a query row with no valid key
returns 0 (the kernel's 1e-30 floor). The dense decoder path gives such
a row garbage instead; the engine ignores it either way.

Layout (the JAX package's public shapes): q (B, S, H, hd); k, v
(B, S, K, hd) un-repeated for GQA/MQA: query head h = kh * G + g reads kv
head kh (the JAX decoder repeats k/v to H heads before its kernel, which
is the same function); key_mask, key_positions (B, S); alibi_slopes (H,).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# The kernel of each route, by the C entry's route code (lir_flash_route):
# float32 on CUDA cores; bf16 on mma.sync (head dims 32, 80, 96, only the
# tiny test configs); bf16 on the persistent TMA + wgmma kernel (head dims
# 64 and 128, every full-size decoder family).
ROUTES = ("fp32", "mma", "wgmma")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call of ``dtype`` and head dim ``hd`` launches,
    as the C library picks it (``lir_flash_route``)."""
    code = _lib().lir_flash_route(int(dtype == torch.bfloat16), hd)
    if code < 0:
        raise ValueError(f"no flash kernel for {dtype} at head dim {hd}")
    return ROUTES[code]


def flash_attention_plain(q, k, v, key_mask=None, alibi_slopes=None,
                          key_positions=None) -> torch.Tensor:
    """The kernel's function in float32, written out. Returns
    (B, S, H, hd) in q's dtype; a query row with no valid key gives 0."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    if key_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    qg = q.reshape(B, S, K, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if alibi_slopes is not None:
        if key_positions is None:
            raise ValueError("alibi_slopes requires key_positions")
        s = s + (alibi_slopes.float().reshape(1, K, G, 1, 1)
                 * key_positions.float()[:, None, None, None, :])
    idx = torch.arange(S, device=q.device)
    valid = (key_mask > 0)[:, None, :] & (idx[None, :] <= idx[:, None])[None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s), torch.exp(s - m),
                    torch.zeros((), device=s.device))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lir_flash_attention.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.lir_flash_attention.restype = i
        lib.lir_flash_route.argtypes = [i, i]
        lib.lir_flash_route.restype = i
        _LIB = lib
    return _LIB


def _flash_cuda(q, k, v, key_mask, alibi_slopes, key_positions) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, S, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"match")
    if hd not in _build.TILE_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims "
                         f"{_build.TILE_HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    if key_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    if tuple(key_mask.shape) != (B, S) or key_mask.device != q.device:
        raise ValueError(f"key_mask is {tuple(key_mask.shape)} on "
                         f"{key_mask.device}, expected {(B, S)} on {q.device}")
    mask = key_mask.to(torch.int32).contiguous()
    slopes = kpos = None
    if alibi_slopes is not None:
        if key_positions is None:
            raise ValueError("alibi_slopes requires key_positions")
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
        kpos = key_positions.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(kpos.shape) != (B, S) or tuple(slopes.shape) != (H,):
            raise ValueError(f"key_positions {tuple(kpos.shape)} / slopes "
                             f"{tuple(slopes.shape)} do not match {(B, S, H)}")
    out = torch.empty_like(q)
    name = route(q.dtype, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(_lib().lir_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        None if kpos is None else kpos.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        B, S, H, K, hd, int(q.dtype == torch.bfloat16), stream),
        "flash_attention")
    return out, name


def flash_attention(q, k, v, key_mask=None, alibi_slopes=None,
                    key_positions=None) -> torch.Tensor:
    """Exact causal prefill attention, (B, S, H, hd) layout, O(S * hd)
    memory (the decoder's only use of the JAX function: ``causal=True``).

    CUDA tensors launch a kernel of ``csrc/flash_attention.cu``, chosen
    by :func:`route` (counted per route in ``route_launches``); CPU
    tensors run :func:`flash_attention_plain`. ``key_positions`` must
    come with ``alibi_slopes`` (mask-aware positions,
    ``decoder.mask_positions``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, alibi_slopes,
                                     key_positions)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    out, name = _flash_cuda(q, k, v, key_mask, alibi_slopes, key_positions)
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
