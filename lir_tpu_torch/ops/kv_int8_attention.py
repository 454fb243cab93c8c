"""Cached attention over the int8 KV cache: S queries a row against the
int8 payloads and their float32 scales, every product s8 x s8 -> s32.

No Pallas original: the counterpart of the JAX package's XLA einsums in
``_attention_cached_int8`` (``lir_tpu/models/decoder.py:229-262``), which
``extend``, ``decode_step`` and ``verify_extend`` run on an engine with
``ModelConfig.kv_cache_int8``. PyTorch has no batched s8 x s8 product on
CUDA (``torch._int_mm`` is 2-D), so the card runs a kernel of its own,
``csrc/kv_int8_attention.cu``. The function, per batch row b, query
position s and query head h = k * G + g of kv head k:

1. the query (hd,) quantized by ``models.quant.dynamic_quant``: scale
   ``max(amax, 1e-8) / 127`` (an IEEE division), payload
   ``round_half_even(x / scale)`` clipped to +-127;
2. s32 dots against the payload ``kq`` (K, T, B, hd), the scores
   ``s32 * qs * ks``, then ``/ sqrt(hd) + bias`` in that order, and a
   float32 softmax over the T slots;
3. the probabilities times the value scales ``vs``, quantized over T by
   the same rule, s32 dots against ``vq``, times their scale, cast to
   q's dtype.

The bias is the JAX package's ``_causal_bias``: 0 where the key is valid
(``key_mask``) and its position is at most the query's, a finite -1e9
elsewhere, plus ALiBi's ``slope * key_position``. A query whose every key
is masked gets a finite, near-uniform row.

On a CUDA tensor :func:`kv_int8_attention` launches the kernel with the
launch plan of :func:`plan` (T split across the blocks of a cluster, the
query rows a block); on a CPU tensor it runs
:func:`kv_int8_attention_plain`, the JAX function line by line. The
products of the twin run in float64, whose every partial sum of int8
products is an exact integer, so its s32 parts are the kernel's bit for
bit on any device; the float chains differ in their order, and where
that moves a value of the probabilities across a rounding tie their
int8 level moves by one (:func:`tie_bar` bounds that).
:func:`split_chain` runs the twin's chain with the softmax sum in the
kernel's order for the plan's split, to show on the CPU that the bar
covers that order.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.quant import dynamic_quant
from . import _build

# Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 80, 96, 128)
# The kernel's constants (csrc/kv_int8_attention.cu): slots a ring
# stage, stages of the ring (double buffering: deeper rings measured
# slower on the H100), query rows a block, blocks a cluster (the portable
# size), the rows from which a block runs the int8 tensor cores, and the
# bytes of a transposed value row.
TILE = 32
STAGES = 2
MAX_ROWS = 64
MAX_SPLITS = 8
MMA_ROWS = 8
VT_PITCH = TILE + 4
# Key bytes a block of a cluster aims at: T splits into the fewest blocks
# (at most MAX_SPLITS) whose slices hold at most this many.
SPLIT_BYTES = 65_536
# The kernel's static shared memory: four float/int slots a row (the
# query and probability scales, slopes and query positions).
STATIC_SMEM = 4 * MAX_ROWS * 4
# The H100's opt-in shared memory a block.
SMEM_OPTIN = 232_448
NEG = -1e9


def causal_bias(q_pos: torch.Tensor, key_mask: torch.Tensor,
                key_positions: torch.Tensor,
                alibi_slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """The additive float32 bias (B, H|1, S, T) of the JAX package's
    ``_causal_bias`` (the decoder's, and this twin's): 0 where the key is
    valid and its position is not after the query's, -1e9 elsewhere,
    plus ALiBi's ``slope * key_position``."""
    qp = q_pos[:, :, None]
    kp = key_positions[:, None, :]
    allowed = (kp <= qp) & (key_mask[:, None, :] > 0)
    neg = torch.tensor(NEG, dtype=torch.float32, device=allowed.device)
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    bias = torch.where(allowed, zero, neg)[:, None, :, :]
    if alibi_slopes is not None:
        bias = bias + (alibi_slopes.float()[None, :, None, None]
                       * kp.float()[:, None, :, :])
    return bias


def _s32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 x int8 einsum, exact: float64 products and sums of
    integers far below 2^53, returned as int32."""
    return torch.einsum(spec, a.double(), b.double()).to(torch.int32)


def _qk_s32(q, kq):
    """(quantized query (B, S, K, G, hd), scales (B, S, H), s32 scores
    (B, K, G, S, T)) of step 1 and the first products of step 2."""
    B, S, H, hd = q.shape
    K = kq.shape[0]
    qq, qs = dynamic_quant(q)
    qq = qq.reshape(B, S, K, H // K, hd)
    return qq, qs, _s32("bskgd,ktbd->bkgst", qq, kq)


def _plain(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
           alibi_slopes, slice_: Optional[int] = None):
    """The twin's chain: (float32 output (B, S, H, hd), value-scaled
    probabilities pw (B, H, S, T), their scales ps (B, H, S)). With
    ``slice_``, the softmax is exp(x - max) over :func:`split_sum`'s sum
    of it in the kernel's order for slices of that many slots."""
    B, S, H, hd = q.shape
    K = kq.shape[0]
    G = H // K
    bias = causal_bias(q_pos, key_mask, key_positions, alibi_slopes)
    _, qs, s32 = _qk_s32(q, kq)
    scores = (s32.float().reshape(B, H, S, -1)
              * qs.permute(0, 2, 1)[:, :, :, None]
              * ks.permute(2, 0, 1).repeat_interleave(G, dim=1)[:, :, None, :])
    scores = scores / math.sqrt(hd) + bias
    if slice_ is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = e / split_sum(e, slice_)[..., None]
    pw = probs * vs.permute(2, 0, 1).repeat_interleave(G, dim=1)[:, :, None, :]
    pq, ps = dynamic_quant(pw)
    pq = pq.reshape(B, K, G, S, -1)
    o32 = _s32("bkgst,ktbd->bskgd", pq, vq)
    out = o32.float().reshape(B, S, H, hd) * ps.permute(0, 2, 1)[..., None]
    return out, pw, ps


def kv_int8_attention_plain(q, kq, ks, vq, vs, q_pos, key_mask,
                            key_positions, alibi_slopes=None
                            ) -> torch.Tensor:
    """The JAX package's ``_attention_cached_int8`` in PyTorch. q (B, S,
    H, hd) float; kq/vq (K, T, B, hd) int8; ks/vs (K, T, B) float32;
    q_pos (B, S), key_mask and key_positions (B, T) ints. Returns
    (B, S, H * hd) in q's dtype."""
    B, S, H, hd = q.shape
    out, _, _ = _plain(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
                       alibi_slopes)
    return out.to(q.dtype).reshape(B, S, H * hd)


def tie_bar(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
            alibi_slopes=None, tie: float = 1e-2) -> torch.Tensor:
    """How far the kernel's output may lie from the twin's, element by
    element ((B, S, H * hd) float32). Their s32 parts are equal and
    their float chains differ only in order, so the two values of
    ``pw / ps`` differ by far less than ``tie`` (127 levels, relative
    errors of a few float32 units over T terms); a level can differ only
    where the twin's value lies within ``tie`` of a rounding tie, by
    one. Each such key moves an output element by ``ps * |vq|`` there;
    one unit in the last place of q's dtype (a few float32 units: the two
    ``ps`` may differ in their last bits) covers the final product."""
    B, S, H, hd = q.shape
    G = H // kq.shape[0]
    out, pw, ps = _plain(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
                         alibi_slopes)
    x = pw / ps[..., None]
    near = ((x - torch.floor(x)) - 0.5).abs() < tie            # (B, H, S, T)
    vabs = vq.abs().repeat_interleave(G, dim=0)                # (H, T, B, hd)
    moved = torch.einsum("bhst,htbd->bshd", near.double(), vabs.double())
    ulp = 2.0 ** (-7 if q.dtype == torch.bfloat16 else -20)
    bar = (moved.float() * ps.permute(0, 2, 1)[..., None]
           + out.abs() * ulp + 1e-30)
    return bar.reshape(B, S, H * hd)


def qk_s32_plain(q, kq) -> torch.Tensor:
    """The twin's s32 scores as (B, H, S, T), the layout the kernel's
    ``s32_out`` takes: the integer part both hold bit for bit."""
    B, S, H, _ = q.shape
    return _qk_s32(q, kq)[2].reshape(B, H, S, -1)


def split_sum(e: torch.Tensor, slice_: int) -> torch.Tensor:
    """The kernel's float32 sum of ``e`` (..., T) over its last axis for
    slices of ``slice_`` slots: in each slice, lane j of a warp adds slots
    j, j + 32, ... in that order; the 32 lanes' sums meet by warp_sum's
    butterfly (xor 16, 8, 4, 2, 1); the slices' sums are added in rank
    order. (Empty lanes and slices add zeros, which move no bit.)"""
    e = e.float()
    T = e.shape[-1]
    lanes = torch.arange(32, device=e.device)
    total = None
    for lo in range(0, T, slice_):
        part = e[..., lo:lo + slice_]
        part = torch.nn.functional.pad(part, (0, (-part.shape[-1]) % 32))
        part = part.reshape(*part.shape[:-1], -1, 32)
        acc = torch.zeros(part.shape[:-2] + (32,), dtype=torch.float32,
                          device=e.device)
        for j in range(part.shape[-2]):
            acc = acc + part[..., j, :]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lanes ^ off]
        total = acc[..., 0] if total is None else total + acc[..., 0]
    return total


class Plan(NamedTuple):
    """A launch of the kernel: ``splits`` blocks a cluster, each of
    ``slice`` slots of T (rank c takes [c * slice, (c + 1) * slice) cut
    at T), ``rows`` query rows a block in ``chunks`` chunks of the S * G
    rows of a (batch row, kv head) pair, ``smem`` bytes of dynamic shared
    memory."""

    splits: int
    slice: int
    rows: int
    chunks: int
    smem: int

    @property
    def mma(self) -> bool:
        """Whether the blocks run both products on the int8 tensor
        cores (mma.sync s8): from MMA_ROWS rows a block."""
        return self.rows >= MMA_ROWS


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def split_of(T: int, hd: int) -> Tuple[int, int]:
    """(splits, slice) of T cache slots of head dim ``hd``: the fewest
    blocks, at most MAX_SPLITS, whose slices hold at most SPLIT_BYTES of
    keys, each slice a multiple of 8 slots. From T and hd alone, so every
    float reduction of a row runs in one order whatever B, S, G or the
    row chunk."""
    splits = min(MAX_SPLITS, -(-T * hd // SPLIT_BYTES))
    return splits, _up(-(-T // splits), 8)


@functools.lru_cache(maxsize=None)
def dyn_smem(hd: int, rows: int, slice_: int, splits: int) -> int:
    """Dynamic shared memory of a block (csrc/kv_int8_attention.cu's
    Layout): the ring, the s32 partial output, the cluster's exchange
    (three floats a row from every block), the transposed value tile
    (IMMA), float32 scores and int8 probabilities of its rows over the
    slice, the query payloads, and four 4-byte values a slot (the key and
    value scales, key position and mask); dp4a blocks add a second s32
    output, their groups' sum."""
    mma = rows >= MMA_ROWS
    hdp = _up(hd, 32)
    kp = hdp + 16
    ntp = _up(slice_, TILE)
    rp = _up(rows, 16) if mma else rows
    qpitch = kp if mma else hd
    ppitch = ntp + 16 if mma else ntp
    return (_up(STAGES * TILE * kp, 16) + _up(rows * hd * 4, 16)
            * (1 if mma else 2) + _up(3 * splits * rows * 4, 16)
            + (_up(hdp * VT_PITCH, 16) if mma else 0)
            + _up(rows * slice_ * 4, 16) + _up(rp * ppitch, 16)
            + _up(rp * qpitch, 16) + 16 * slice_)


@functools.lru_cache(maxsize=None)
def _most_rows(T: int, hd: int, smem_limit: int) -> int:
    """The most query rows (at most MAX_ROWS) a block of T slots holds."""
    splits, slice_ = split_of(T, hd)
    rows = MAX_ROWS
    while rows > 0 and (dyn_smem(hd, rows, slice_, splits)
                        > smem_limit - STATIC_SMEM):
        rows -= 1
    if rows < 1:
        raise ValueError(f"kv_int8_attention: {T} cache slots do not fit a "
                         f"block's {smem_limit} bytes of shared memory")
    return rows


def plan(T: int, hd: int, SG: int, smem_limit: int = SMEM_OPTIN) -> Plan:
    """The launch plan of T cache slots, head dim ``hd`` and ``SG`` = S *
    G query rows a (batch row, kv head) pair: :func:`split_of`'s split,
    and a block takes all SG rows up to MAX_ROWS, fewer where a block's
    shared memory (``smem_limit`` less STATIC_SMEM) would not hold them,
    in chunks of equal size."""
    if hd not in HEAD_DIMS or T < 1 or SG < 1:
        raise ValueError(f"kv_int8_attention: no plan for T={T}, hd={hd}, "
                         f"{SG} query rows")
    splits, slice_ = split_of(T, hd)
    chunks = -(-SG // min(SG, _most_rows(T, hd, smem_limit)))
    rows = -(-SG // chunks)
    return Plan(splits, slice_, rows, chunks,
                dyn_smem(hd, rows, slice_, splits))


def split_chain(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
                alibi_slopes=None):
    """The twin's chain with the softmax sum in the kernel's order for
    :func:`plan`'s split of these inputs (:func:`split_sum`): (float32
    output (B, S, H, hd), pw (B, H, S, T), ps (B, H, S))."""
    return _plain(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
                  alibi_slopes, slice_=split_of(kq.shape[1], q.shape[-1])[1])


_LIB = None
_SMEM: Dict[torch.device, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("kv_int8_attention")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.lir_kv_int8_attention.argtypes = [
            p, i, p, q, p, q, p, q, p, q, p, p, p, p, i, i, i, i, i, i, i, i,
            i, ctypes.c_float, p, p, p]
        lib.lir_kv_int8_attention.restype = i
        for name, n in (("lir_kv_int8_smem", 4),
                        ("lir_kv_int8_static_smem", 3),
                        ("lir_kv_int8_max_smem", 1)):
            getattr(lib, name).argtypes = [i] * n
            getattr(lib, name).restype = i
        _LIB = lib
    return _LIB


def _check(q, kq, ks, vq, vs, q_pos, key_mask, key_positions, slopes):
    dev = q.device
    B, S, H, hd = q.shape
    K, T = kq.shape[0], kq.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError(f"kv_int8_attention: q must be contiguous float32 or "
                         f"bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS or H % K:
        raise ValueError(f"kv_int8_attention: head dim {hd} (instantiated "
                         f"for {HEAD_DIMS}) with {H} heads over {K}")
    for name, t in (("kq", kq), ("vq", vq)):
        if (t.device != dev or t.dtype != torch.int8
                or t.shape != (K, T, B, hd)
                or t.stride()[1:] != (B * hd, hd, 1)
                or t.data_ptr() % 16 or t.stride(0) % 16):
            raise ValueError(f"kv_int8_attention: {name} must be int8 "
                             f"({K}, {T}, {B}, {hd}) with dense (T, B, hd) "
                             f"planes 16-byte aligned on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()}")
    for name, t in (("ks", ks), ("vs", vs)):
        if (t.device != dev or t.dtype != torch.float32
                or t.shape != (K, T, B) or t.stride()[1:] != (B, 1)):
            raise ValueError(f"kv_int8_attention: {name} must be float32 "
                             f"({K}, {T}, {B}) with dense (T, B) planes on "
                             f"{dev}")
    for name, t, shape in (("q_pos", q_pos, (B, S)),
                           ("key_mask", key_mask, (B, T)),
                           ("key_positions", key_positions, (B, T))):
        if t.device != dev or t.dtype != torch.int32 or t.shape != shape:
            raise ValueError(f"kv_int8_attention: {name} must be int32 "
                             f"{shape} on {dev}")
    if slopes is not None and (slopes.device != dev
                               or slopes.dtype != torch.float32
                               or slopes.shape != (H,)):
        raise ValueError(f"kv_int8_attention: alibi_slopes must be float32 "
                         f"({H},) on {dev}")


def kv_int8_attention(q, kq, ks, vq, vs, q_pos, key_mask, key_positions,
                      alibi_slopes=None, s32_out=None) -> torch.Tensor:
    """(B, S, H * hd) attention output in q's dtype. CUDA tensors launch
    ``csrc/kv_int8_attention.cu``; CPU tensors run
    :func:`kv_int8_attention_plain`. ``s32_out`` (card only, a check's
    hook): an int32 (B, H, S, T) tensor the kernel also writes its QK^T
    s32 scores into."""
    dev = q.device
    if dev.type == "cpu":
        return kv_int8_attention_plain(q, kq, ks, vq, vs, q_pos, key_mask,
                                       key_positions, alibi_slopes)
    if dev.type != "cuda":
        raise ValueError(f"kv_int8_attention needs CPU or CUDA tensors, "
                         f"got {dev}")
    q_pos = q_pos.to(torch.int32).contiguous()
    key_mask = key_mask.to(torch.int32).contiguous()
    key_positions = key_positions.to(torch.int32).contiguous()
    slopes = (None if alibi_slopes is None
              else alibi_slopes.to(torch.float32).contiguous())
    _check(q, kq, ks, vq, vs, q_pos, key_mask, key_positions, slopes)
    B, S, H, hd = q.shape
    K, T = kq.shape[0], kq.shape[1]
    if s32_out is not None and (s32_out.dtype != torch.int32
                                or s32_out.shape != (B, H, S, T)
                                or not s32_out.is_contiguous()):
        raise ValueError("kv_int8_attention: s32_out must be contiguous "
                         f"int32 ({B}, {H}, {S}, {T})")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    lib = _lib()
    smem = _SMEM.get(dev)
    if smem is None:
        smem = lib.lir_kv_int8_max_smem(dev.index or 0)
        _SMEM[dev] = smem
    pl = plan(T, hd, S * (H // K), smem)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.lir_kv_int8_attention(
        q.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0,
        kq.data_ptr(), kq.stride(0), ks.data_ptr(), ks.stride(0),
        vq.data_ptr(), vq.stride(0), vs.data_ptr(), vs.stride(0),
        q_pos.data_ptr(), key_mask.data_ptr(), key_positions.data_ptr(),
        0 if slopes is None else slopes.data_ptr(), B, S, H, K, T, hd,
        pl.rows, pl.splits, pl.slice,
        float(np.float32(math.sqrt(hd))), out.data_ptr(),
        0 if s32_out is None else s32_out.data_ptr(), stream),
        "kv_int8_attention")
    kv_int8_attention.launches += 1
    return out.reshape(B, S, H * hd)


kv_int8_attention.launches = 0
