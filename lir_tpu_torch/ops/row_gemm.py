"""Row-invariant linear layer and norm: the decode step's and the verify
window's bf16 projections and norms.

No Pallas original: the JAX package leaves these to XLA. The port needs
its own kernels because the speculative verify window must give each row
the bits of the sequential decode step (``engine/generate._spec_tail``),
and the window runs B * spec_k rows through every projection where the
step runs B. A library GEMM, and PyTorch's row reductions, choose their
reduction plan from the number of rows; :func:`row_gemm` and
:func:`row_norm` reduce every row in one fixed order, whatever M is and
wherever the row sits (``csrc/row_gemm.cu`` says how).

:func:`row_add_norm` is the residual add before a norm and that norm in
one launch (the sum bitwise torch's bf16 add, the norm bitwise
:func:`row_norm` of it).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs its plain version (:func:`row_gemm_plain`, which is ``x @ w``,
:func:`row_norm_plain`, the decoder's norm, and
:func:`row_add_norm_plain`, the add then that norm), so the CPU tests
see the decoder's own arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# Columns of a kernel block (two warpgroups of 64), the depth of one
# chunk of K, the blocks a launch should reach, the least chunks a split
# keeps, and the most splits (one cluster of blocks adds them: 8 is the
# portable cluster size). 96 blocks of 128 columns stream a weight from
# device memory as fast as 128 or more do on the H100, and fewer splits
# mean fewer, smaller clusters to place and less to add.
_TILE_N, _BK, _MIN_BLOCKS, _MIN_CHUNKS, _MAX_SPLITS = 128, 64, 96, 4, 8


def gemm_splits(n: int, k: int) -> int:
    """Split count of K for an (n, k) weight: a function of the weight's
    shape alone, never of the rows, so each output element's reduction
    order is fixed by (n, k). The fewest splits whose (128-column tile,
    split) blocks number 96 or more, each split keeping at least 4
    chunks of 64, at most 8 splits."""
    tiles = -(-int(n) // _TILE_N)
    chunks = -(-int(k) // _BK)
    s = 1
    while (tiles * s < _MIN_BLOCKS and s < _MAX_SPLITS
           and chunks // (s + 1) >= _MIN_CHUNKS):
        s += 1
    cps = -(-chunks // s)
    return -(-chunks // cps)              # every split keeps a chunk


def row_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: the function the kernel computes."""
    return torch.matmul(x, w)


def row_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """RMSNorm (``bias`` None) or LayerNorm over the last axis in float32,
    the result in x's dtype: the decoder's norm."""
    xf = x.float()
    if bias is None:
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * scale.float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def row_add_norm_plain(x: torch.Tensor, d: torch.Tensor, scale: torch.Tensor,
                       bias: Optional[torch.Tensor], eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + d`` and :func:`row_norm_plain` of ``s``: the decoder's
    residual add and the norm after it."""
    s = x + d
    return s, row_norm_plain(s, scale, bias, eps)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("row_gemm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lir_row_gemm.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.lir_row_gemm.restype = i
        lib.lir_row_norm.argtypes = [p] * 4 + [i] * 2 + [ctypes.c_float, p]
        lib.lir_row_norm.restype = i
        lib.lir_row_add_norm.argtypes = [p] * 6 + [i] * 2 + [ctypes.c_float, p]
        lib.lir_row_add_norm.restype = i
        _LIB = lib
    return _LIB


def _check_bf16(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.bfloat16:
        raise TypeError(f"{name} is {t.dtype} on {t.device}; the row kernels "
                        f"take bfloat16 on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the row kernels need a contiguous, 16-byte aligned "
                         f"{name}")


def row_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with each row's bits independent of the rows
    beside it. CUDA tensors (bf16, K and N multiples of 8) launch
    ``csrc/row_gemm.cu``; CPU tensors run :func:`row_gemm_plain`."""
    if x.device.type == "cpu":
        return row_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"row_gemm needs CPU or CUDA tensors, got {x.device}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"row_gemm of {tuple(x.shape)} and {tuple(w.shape)}")
    K, N = w.shape
    if K % 8 or N % 8:
        raise ValueError(f"row_gemm needs K and N multiples of 8, got "
                         f"({K}, {N})")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    _check_bf16("x", x2, x.device)
    _check_bf16("w", w, x.device)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_lib().lir_row_gemm(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
        gemm_splits(N, K), stream), "row_gemm")
    row_gemm.launches += 1
    return out.reshape(*lead, N)


# The widest row of the norm kernels: 1,024 threads of two 16-byte chunks.
_MAX_NORM_WIDTH = 16384


def _norm_rows(name: str, x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x as contiguous (M, D) rows, after the norm kernels' checks."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CPU or CUDA tensors, got {x.device}")
    D = x.shape[-1]
    if D % 8 or D > _MAX_NORM_WIDTH or tuple(scale.shape) != (D,) or (
            bias is not None and tuple(bias.shape) != (D,)):
        raise ValueError(f"{name} of width {D} with scale "
                         f"{tuple(scale.shape)}: the width must be a multiple "
                         f"of 8, at most {_MAX_NORM_WIDTH}, and match the "
                         f"scale")
    x2 = x.reshape(-1, D).contiguous()
    _check_bf16("x", x2, x.device)
    _check_bf16("scale", scale, x.device)
    if bias is not None:
        _check_bf16("bias", bias, x.device)
    return x2


def row_norm(x: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """RMSNorm (``bias`` None) or LayerNorm over the last axis, each row
    reduced in one fixed order. CUDA tensors (bf16, width a multiple of
    8) launch ``csrc/row_gemm.cu``; CPU tensors run
    :func:`row_norm_plain`."""
    if x.device.type == "cpu":
        return row_norm_plain(x, scale, bias, eps)
    x2 = _norm_rows("row_norm", x, scale, bias)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(_lib().lir_row_norm(
            x2.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            x2.shape[0], x2.shape[1], float(eps), stream), "row_norm")
        row_norm.launches += 1
    return out.reshape(x.shape)


def row_add_norm(x: torch.Tensor, d: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one pass: ``(s, h)`` with
    ``s = x + d`` (bitwise torch's bf16 add) and ``h`` bitwise
    :func:`row_norm` of ``s``. CUDA tensors (bf16, as :func:`row_norm`
    takes them) launch ``csrc/row_gemm.cu``; CPU tensors run
    :func:`row_add_norm_plain`."""
    if x.device.type == "cpu":
        return row_add_norm_plain(x, d, scale, bias, eps)
    if d.shape != x.shape:
        raise ValueError(f"row_add_norm of {tuple(x.shape)} and "
                         f"{tuple(d.shape)}")
    x2 = _norm_rows("row_add_norm", x, scale, bias)
    d2 = d.reshape(x2.shape).contiguous()
    _check_bf16("d", d2, x.device)
    s, h = torch.empty_like(x2), torch.empty_like(x2)
    if x2.shape[0]:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(_lib().lir_row_add_norm(
            x2.data_ptr(), d2.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), s.data_ptr(),
            h.data_ptr(), x2.shape[0], x2.shape[1], float(eps), stream),
            "row_add_norm")
        row_add_norm.launches += 1
    return s.reshape(x.shape), h.reshape(x.shape)


row_gemm.launches = 0
row_norm.launches = 0
row_add_norm.launches = 0
