"""The streaming-statistics fold: one dispatch's position-0 readouts into
the sweep's (P, R) accumulator lattice, in place.

No Pallas original: the counterpart of the JAX package's XLA-fused
``fold_update`` (``lir_tpu/engine/stream_stats.py:114``), one launch of
``csrc/stream_fold.cu`` a dispatch. Per row: the validity predicate
(the numerics guard's bounds, ``guard`` a launch argument), rel =
yes / (yes + no), conf = wconf, dec = yes > no, filled = 1, stored at
(pidx, ridx); a slot outside the lattice (pad rows carry ridx = R) is
dropped on the device, so nothing is read back.

On a CUDA tensor :func:`stream_fold` launches the kernel (one warp a
row, every load issued before any test: one round trip to memory); on a
CPU tensor it runs :func:`stream_fold_plain`, the same arithmetic in
torch (float32 bounds, correctly rounded division), bitwise the
kernel's.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import _build

# The numerics guard's bounds (guard/numerics.py), each the float32
# rounding of its double value, as the JAX fold compares float32 arrays
# with Python floats.
_P_EPS, _SUM_EPS, _CONF_EPS = 1e-4, 1e-3, 1e-3
_P_LO = float(np.float32(-_P_EPS))
_P_HI = float(np.float32(1.0 + _P_EPS))
_SUM_HI = float(np.float32(1.0 + _SUM_EPS))
_CONF_LO = float(np.float32(-_CONF_EPS))
_CONF_HI = float(np.float32(100.0 + _CONF_EPS))
_LP_HI = float(np.float32(_P_EPS))

LATTICE = ("filled", "rel", "conf", "dec")
_LATTICE_DTYPES = {"filled": torch.int32, "rel": torch.float32,
                   "conf": torch.float32, "dec": torch.int32}


def _in_range(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.isfinite(v) & (v >= lo) & (v <= hi)


def _row_values(yes: torch.Tensor, no: torch.Tensor, wconf: torch.Tensor,
                lp: torch.Tensor, guard: bool = True
                ) -> Dict[str, torch.Tensor]:
    """Per row (B,): the four lattice values the fold stores."""
    if guard:
        ok = (_in_range(yes, _P_LO, _P_HI) & _in_range(no, _P_LO, _P_HI)
              & ((yes + no) <= _SUM_HI)
              & _in_range(wconf, _CONF_LO, _CONF_HI)
              & ~torch.isnan(lp).any(dim=-1) & ~(lp > _LP_HI).any(dim=-1))
    else:
        ok = torch.ones(yes.shape, dtype=torch.bool, device=yes.device)
    total = yes + no
    mass = ok & (total > 0)
    nan = torch.full_like(yes, float("nan"))
    return {
        "filled": torch.ones(yes.shape, dtype=torch.int32, device=yes.device),
        "rel": torch.where(mass, yes / total, nan),
        "conf": torch.where(ok, wconf, nan),
        "dec": torch.where(mass, (yes > no).to(torch.int32),
                           torch.full(yes.shape, -1, dtype=torch.int32,
                                      device=yes.device)),
    }


def stream_fold_plain(acc: Dict[str, torch.Tensor], yes: torch.Tensor,
                      no: torch.Tensor, wconf: torch.Tensor,
                      lp: torch.Tensor, pidx: torch.Tensor,
                      ridx: torch.Tensor, guard: bool = True) -> None:
    """The fold in plain PyTorch, in place. Rows whose slot lies outside
    the lattice are written to a scratch slot past its end (one copy of
    the flattened lattice), so nothing is read back to drop them."""
    P, R = acc["filled"].shape
    pidx, ridx = pidx.long(), ridx.long()
    inside = (pidx >= 0) & (pidx < P) & (ridx >= 0) & (ridx < R)
    at = torch.where(inside, pidx * R + ridx, P * R)
    for name, vals in _row_values(yes.float(), no.float(), wconf.float(),
                                  lp.float(), guard).items():
        lat = acc[name]
        flat = torch.cat([lat.reshape(-1), lat.new_empty(1)])
        flat[at] = vals
        lat.copy_(flat[:-1].view(P, R))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("stream_fold")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.lir_stream_fold.argtypes = [p, q, p, q, p, q, p, q, q, i, p, p, i,
                                        p, p, p, p, i, i, i, p]
        lib.lir_stream_fold.restype = i
        _LIB = lib
    return _LIB


def _check(acc: Dict[str, torch.Tensor], yes, no, wconf, lp, pidx,
           ridx) -> None:
    dev = acc["filled"].device
    shape = acc["filled"].shape
    for name in LATTICE:
        t = acc[name]
        if (t.device != dev or t.dtype != _LATTICE_DTYPES[name]
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"stream_fold: lattice {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; it must be a "
                             f"contiguous {_LATTICE_DTYPES[name]} "
                             f"{tuple(shape)} on {dev}")
    B = yes.shape[0]
    for name, t in (("yes", yes), ("no", no), ("wconf", wconf)):
        if t.device != dev or t.dtype != torch.float32 or t.shape != (B,):
            raise ValueError(f"stream_fold: {name} must be float32 ({B},) on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if (lp.device != dev or lp.dtype != torch.float32 or lp.dim() != 2
            or lp.shape[0] != B):
        raise ValueError(f"stream_fold: lp must be float32 ({B}, K) on {dev}")
    for name, t in (("pidx", pidx), ("ridx", ridx)):
        if (t.device != dev or t.dtype != torch.int32 or t.shape != (B,)
                or not t.is_contiguous()):
            raise ValueError(f"stream_fold: {name} must be contiguous int32 "
                             f"({B},) on {dev}")


def stream_fold(acc: Dict[str, torch.Tensor], yes: torch.Tensor,
                no: torch.Tensor, wconf: torch.Tensor, lp: torch.Tensor,
                pidx: torch.Tensor, ridx: torch.Tensor,
                guard: bool = True) -> None:
    """Fold one dispatch into ``acc`` (the lattice: ``filled`` / ``dec``
    int32, ``rel`` / ``conf`` float32, all (P, R)) in place. ``yes``,
    ``no``, ``wconf`` (B,) and ``lp`` (B, K) float32 (any strides),
    ``pidx`` / ``ridx`` (B,) int32. CUDA tensors launch
    ``csrc/stream_fold.cu``; CPU tensors run :func:`stream_fold_plain`."""
    dev = acc["filled"].device
    if dev.type == "cpu":
        return stream_fold_plain(acc, yes, no, wconf, lp, pidx, ridx, guard)
    if dev.type != "cuda":
        raise ValueError(f"stream_fold needs CPU or CUDA tensors, got {dev}")
    _check(acc, yes, no, wconf, lp, pidx, ridx)
    P, R = acc["filled"].shape
    B = yes.shape[0]
    if B == 0:
        return None
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib().lir_stream_fold(
        yes.data_ptr(), yes.stride(0), no.data_ptr(), no.stride(0),
        wconf.data_ptr(), wconf.stride(0), lp.data_ptr(), lp.stride(0),
        lp.stride(1), lp.shape[1], pidx.data_ptr(), ridx.data_ptr(), B,
        acc["filled"].data_ptr(), acc["rel"].data_ptr(),
        acc["conf"].data_ptr(), acc["dec"].data_ptr(), P, R, int(guard),
        stream), "stream_fold")
    stream_fold.launches += 1
    return None


stream_fold.launches = 0
