"""Flash decode: single- and multi-query attention over the KV cache.

Port of ``lir_tpu/ops/flash_decode.py``: ``flash_decode`` (TPU kernel
``_decode_kernel``), ``flash_decode_trunk`` (``_trunk_decode_kernel``
plus ``_decode_kernel`` over the tail splits), ``flash_decode_mq``
(``_decode_kernel_mq``: the speculative verify window, S teacher-forced
queries per row) and ``flash_decode_mq_trunk``
(``_trunk_decode_kernel_mq`` plus ``_decode_kernel_mq`` over the tail
splits). On a CUDA tensor each wrapper launches the hand-written kernels
of ``csrc/flash_decode.cu``; on a CPU tensor it runs the plain PyTorch
version beside it. The source note in ``csrc/flash_decode.cu`` says
what bounds the kernels on the H100 and what their design does about
that.

The split ladder is the port's own: fixed splits of ``DECODE_SPLIT``
keys, the last one ragged and masked (the JAX package's ``pick_split``
takes the largest divisor of T, a TPU tiling choice that degenerates to
splits of 8 keys at this slice's cache extents). Every kernel shares the
ladder and one per-split function, so the trunk kernels' output is
bitwise the flat kernels' when the trunk rows are identical, and query j
of ``flash_decode_mq`` is bitwise ``flash_decode`` with
``q_positions[:, j]``. On a CUDA tensor the single-query functions run
the multi-query kernels at S = 1.

Layout (the JAX package's public shapes): q (B, H, hd), or (B, S, H, hd)
for the multi-query functions; k, v (K, T, B, hd) un-repeated for
GQA/MQA (query head h = kh * G + g); q_positions (B,), or (B, S);
key_mask, key_positions (B, T); alibi_slopes (H,).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

# Keys per split of the cache. Both kernels and the plain versions use it.
DECODE_SPLIT = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def n_splits(T: int) -> int:
    """Splits of a T-slot cache (the last one may be ragged)."""
    return -(-int(T) // DECODE_SPLIT)


def trunk_splits(trunk_len: int, T: int) -> int:
    """Splits lying fully inside the shared trunk; at least one split
    always stays in the per-row tail (the slot being decoded is there)."""
    return max(0, min(int(trunk_len), int(T) - 1)) // DECODE_SPLIT


def _default_positions(key_mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.cumsum(key_mask, dim=-1, dtype=torch.int32)
                           - 1, 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_decode_plain(q, k, v, q_positions, key_mask, key_positions=None,
                       alibi_slopes=None) -> torch.Tensor:
    """Dense single-query attention in float32: the function the kernel
    computes, written out. Returns (B, H, hd) in q's dtype; an all-masked
    row gives zeros (the merge's 1e-30 floor)."""
    B, H, hd = q.shape
    K = k.shape[0]
    G = H // K
    if key_positions is None:
        key_positions = _default_positions(key_mask)
    qf = q.float().reshape(B, K, G, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,ktbd->bkgt", qf, k.float())
    if alibi_slopes is not None:
        s = s + (alibi_slopes.float().reshape(1, K, G, 1)
                 * key_positions.float()[:, None, None, :])
    valid = (key_mask > 0) & (key_positions <= q_positions[:, None])
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s), torch.exp(s - m),
                    torch.zeros((), device=s.device))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,ktbd->bkgd", p, v.float())
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def flash_decode_mq_plain(q, k, v, q_positions, key_mask, key_positions=None,
                          alibi_slopes=None) -> torch.Tensor:
    """Multi-query attention, q (B, S, H, hd) and q_positions (B, S): one
    :func:`flash_decode_plain` per query, as the kernel reduces one query
    at a time. Returns (B, S, H, hd) in q's dtype."""
    if key_positions is None:
        key_positions = _default_positions(key_mask)
    return torch.stack([
        flash_decode_plain(q[:, s], k, v, q_positions[:, s], key_mask,
                           key_positions, alibi_slopes)
        for s in range(q.shape[1])], dim=1)


def _trunk_from_row0(k, v, trunk_len: int):
    """k/v with the slots of the full trunk splits read from cache row 0
    for every row: what the trunk kernels see."""
    B = k.shape[2]
    tk = trunk_splits(trunk_len, k.shape[1]) * DECODE_SPLIT
    if tk:
        k = torch.cat([k[:, :tk, :1].expand(-1, -1, B, -1), k[:, tk:]], dim=1)
        v = torch.cat([v[:, :tk, :1].expand(-1, -1, B, -1), v[:, tk:]], dim=1)
    return k, v


def flash_decode_trunk_plain(q, k, v, q_positions, key_mask,
                             key_positions=None, alibi_slopes=None,
                             trunk_len: int = 0) -> torch.Tensor:
    """The trunk kernel's function: slots of the full trunk splits are
    read from cache row 0 for every row, the rest from each row."""
    k, v = _trunk_from_row0(k, v, trunk_len)
    return flash_decode_plain(q, k, v, q_positions, key_mask, key_positions,
                              alibi_slopes)


def flash_decode_mq_trunk_plain(q, k, v, q_positions, key_mask,
                                key_positions=None, alibi_slopes=None,
                                trunk_len: int = 0) -> torch.Tensor:
    """The multi-query trunk kernels' function."""
    k, v = _trunk_from_row0(k, v, trunk_len)
    return flash_decode_mq_plain(q, k, v, q_positions, key_mask,
                                 key_positions, alibi_slopes)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lir_flash_decode_splits.argtypes = [p] * 10 + [i] * 10 + [p]
        lib.lir_flash_decode_splits.restype = i
        lib.lir_flash_decode_trunk_splits.argtypes = [p] * 10 + [i] * 10 + [p]
        lib.lir_flash_decode_trunk_splits.restype = i
        lib.lir_flash_decode_merge.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.lir_flash_decode_merge.restype = i
        _LIB = lib
    return _LIB


def _prepare(q, k, v, q_positions, key_mask, key_positions, alibi_slopes):
    """Check what the kernels take (q (B, S, H, hd), q_positions (B, S));
    raise on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"flash decode kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash decode kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    K, T, Bk, hdk = k.shape
    if Bk != B or hdk != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash decode kernel needs contiguous q, k, v")
    if hd % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash decode kernel needs a head dim that is a "
                         f"multiple of 8 and 16-byte aligned q, k, v; got hd "
                         f"{hd}")
    if key_positions is None:
        key_positions = _default_positions(key_mask)
    ints = []
    for name, t, shape in (("q_positions", q_positions, (B, S)),
                           ("key_mask", key_mask, (B, T)),
                           ("key_positions", key_positions, (B, T))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {q.device}")
        ints.append(t.to(torch.int32).contiguous())
    slopes = None
    if alibi_slopes is not None:
        if tuple(alibi_slopes.shape) != (H,):
            raise ValueError(f"alibi_slopes is {tuple(alibi_slopes.shape)}, "
                             f"expected ({H},)")
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    return ints, slopes


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def decode_legs(q, k, v, q_positions, key_mask, key_positions=None,
                alibi_slopes=None, trunk_len: int = 0):
    """The kernel launches for q (B, S, H, hd) on CUDA tensors, each a
    callable of no arguments: ``"trunk"`` (the trunk leg over the full
    trunk splits, only where there is one), ``"rows"`` (the row leg over
    the rest) and ``"merge"``. Run in that order, they fill ``out``
    (B, S, H, hd). Returns ``(out, legs)``. The wrappers below run them;
    they count no launch, so they can also be timed one by one."""
    (qpos, mask, kpos), slopes = _prepare(q, k, v, q_positions, key_mask,
                                          key_positions, alibi_slopes)
    B, S, H, hd = q.shape
    K, T = k.shape[0], k.shape[1]
    G = H // K
    ns = n_splits(T)
    nt = trunk_splits(trunk_len, T)
    f32 = dict(device=q.device, dtype=torch.float32)
    o_p = torch.empty((B, K, ns, S, G, hd), **f32)
    m_p = torch.empty((B, K, ns, S, G), **f32)
    l_p = torch.empty((B, K, ns, S, G), **f32)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            mask.data_ptr(), kpos.data_ptr(), _ptr(slopes), o_p.data_ptr(),
            m_p.data_ptr(), l_p.data_ptr(), B, S, H, K, T, hd, DECODE_SPLIT,
            ns)
    code = _DTYPES[q.dtype]
    legs = {}
    if nt:
        legs["trunk"] = lambda: _build.check(
            lib.lir_flash_decode_trunk_splits(*args, nt, code, stream),
            "flash decode (trunk splits)")
    legs["rows"] = lambda: _build.check(
        lib.lir_flash_decode_splits(*args, nt, code, stream),
        "flash decode (row splits)")
    legs["merge"] = lambda: _build.check(lib.lir_flash_decode_merge(
        o_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), out.data_ptr(),
        B, S, H, K, ns, hd, code, stream), "flash decode (merge)")
    return out, legs


def _decode_cuda(q, k, v, q_positions, key_mask, key_positions,
                 alibi_slopes, trunk_len: int) -> torch.Tensor:
    """The kernels on q (B, S, H, hd): the trunk leg over the full trunk
    splits (when there are any), the row leg over the rest, then the
    merge. Returns (B, S, H, hd)."""
    out, legs = decode_legs(q, k, v, q_positions, key_mask, key_positions,
                            alibi_slopes, trunk_len)
    for launch in legs.values():
        launch()
    return out


def flash_decode(q, k, v, q_positions, key_mask, key_positions=None,
                 alibi_slopes=None) -> torch.Tensor:
    """One decode step of attention. Returns (B, H, hd) in q's dtype.

    CUDA tensors launch ``csrc/flash_decode.cu`` (the row leg, then the
    merge); CPU tensors run :func:`flash_decode_plain`."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_positions, key_mask,
                                  key_positions, alibi_slopes)
    out = _decode_cuda(q[:, None], k, v, q_positions[:, None], key_mask,
                       key_positions, alibi_slopes, 0)[:, 0]
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_trunk(q, k, v, q_positions, key_mask, key_positions=None,
                       alibi_slopes=None, trunk_len: int = 0) -> torch.Tensor:
    """Trunk-aware decode step for shared-trunk dispatches: the cache's
    leading ``trunk_len`` slots are identical across rows, so the full
    splits inside the trunk read K/V from row 0 for all rows (the trunk
    leg); the tail splits run the row leg. Bitwise the flat kernel. With no full trunk split it is :func:`flash_decode`.

    CUDA tensors launch ``csrc/flash_decode.cu``; CPU tensors run
    :func:`flash_decode_trunk_plain`."""
    if trunk_splits(trunk_len, k.shape[1]) == 0:
        return flash_decode(q, k, v, q_positions, key_mask, key_positions,
                            alibi_slopes)
    if q.device.type == "cpu":
        return flash_decode_trunk_plain(q, k, v, q_positions, key_mask,
                                        key_positions, alibi_slopes,
                                        trunk_len)
    out = _decode_cuda(q[:, None], k, v, q_positions[:, None], key_mask,
                       key_positions, alibi_slopes, trunk_len)[:, 0]
    flash_decode_trunk.launches += 1
    return out


flash_decode_trunk.launches = 0


def flash_decode_mq(q, k, v, q_positions, key_mask, key_positions=None,
                    alibi_slopes=None) -> torch.Tensor:
    """Multi-query decode attention: S teacher-forced queries per row over
    the cache in one launch — the speculative verify window, already
    written into the cache at its slots. q (B, S, H, hd) post-RoPE;
    q_positions (B, S), each query's mask-aware position: causality
    (``key_positions <= q_positions[:, s]``) keeps a query from seeing
    later drafts. Returns (B, S, H, hd) in q's dtype; query j is bitwise
    :func:`flash_decode` with ``q_positions[:, j]``.

    CUDA tensors launch ``csrc/flash_decode.cu`` (the row leg, all S
    queries of a row reduced together against each tile, then the merge);
    CPU tensors run :func:`flash_decode_mq_plain`."""
    if q.device.type == "cpu":
        return flash_decode_mq_plain(q, k, v, q_positions, key_mask,
                                     key_positions, alibi_slopes)
    out = _decode_cuda(q, k, v, q_positions, key_mask, key_positions,
                       alibi_slopes, 0)
    flash_decode_mq.launches += 1
    return out


flash_decode_mq.launches = 0


def flash_decode_mq_trunk(q, k, v, q_positions, key_mask, key_positions=None,
                          alibi_slopes=None, trunk_len: int = 0) -> torch.Tensor:
    """Trunk-aware multi-query decode: :func:`flash_decode_mq` with the
    :func:`flash_decode_trunk` split dedup, so a verify window in a
    shared-trunk dispatch reads the trunk K/V once per (kv head, split,
    group of rows) instead of once per row. Bitwise
    :func:`flash_decode_mq`. With no full trunk split it is
    :func:`flash_decode_mq`.

    CUDA tensors launch ``csrc/flash_decode.cu`` (trunk leg, row leg over
    the tail splits, merge); CPU tensors run
    :func:`flash_decode_mq_trunk_plain`."""
    if trunk_splits(trunk_len, k.shape[1]) == 0:
        return flash_decode_mq(q, k, v, q_positions, key_mask, key_positions,
                               alibi_slopes)
    if q.device.type == "cpu":
        return flash_decode_mq_trunk_plain(q, k, v, q_positions, key_mask,
                                           key_positions, alibi_slopes,
                                           trunk_len)
    out = _decode_cuda(q, k, v, q_positions, key_mask, key_positions,
                       alibi_slopes, trunk_len)
    flash_decode_mq_trunk.launches += 1
    return out


flash_decode_mq_trunk.launches = 0
