"""Temperature sampling: the next token of each row by the Gumbel-max
trick on JAX's threefry draws.

No Pallas original: the counterpart of the JAX package's XLA
``jax.random.categorical`` in ``sample_decode``
(``lir_tpu/engine/generate.py:1442-1447``). Per row b the counter of
vocab index v is ``offsets[b] + v``, the noise ``-log(-log(u))`` of the
threefry uniform on [tiny, 1) under ``step_keys[b]``, and the id the
argmax of ``logits[b] / max(temperature, 1e-6) + noise`` (lowest index
on ties). With one key over (B, V) the offsets are ``b * V`` (the flat
index); with a key a row they are 0.

On a CUDA tensor :func:`gumbel_argmax` launches ``csrc/sample.cu``; on a
CPU tensor it runs :func:`gumbel_argmax_plain`, the same chain in torch
on ``engine/prng.py``. The source note in ``csrc/sample.cu`` says what
bounds the kernel and what its design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..engine import prng
from . import _build

# Blocks the kernel aims for per SM over the whole (chunks, B) grid.
_BLOCKS_PER_SM = 2


def temperature32(temperature: float) -> float:
    """``max(temperature, 1e-6)`` in float32, as the JAX sampler divides
    by ``jnp.maximum(temperature, 1e-6)`` on a float32 temperature."""
    return float(max(np.float32(temperature), np.float32(1e-6)))


def gumbel_scores_plain(logits: torch.Tensor, step_keys: torch.Tensor,
                        offsets: torch.Tensor, temperature: float
                        ) -> torch.Tensor:
    """The perturbed scores ``noise + logits / temperature`` (B, V)
    float32 of (B, V) logits, (B, 2) int64 keys and (B,) int64 offsets.
    The divisor is a float32 tensor: a Python-number divisor may become a
    reciprocal multiply in a device kernel."""
    B, V = logits.shape
    counter = (offsets.to(torch.int64)[:, None]
               + torch.arange(V, dtype=torch.int64, device=logits.device))
    keys = step_keys.to(torch.int64)
    y0, y1 = prng.threefry2x32(keys[:, 0:1], keys[:, 1:2], counter >> 32,
                               counter & prng.MASK)
    noise = prng.gumbel_from_bits(y0 ^ y1)
    temp = torch.tensor(temperature32(temperature), dtype=torch.float32,
                        device=logits.device)
    return noise + logits.float() / temp


def gumbel_argmax_plain(logits: torch.Tensor, step_keys: torch.Tensor,
                        offsets: torch.Tensor, temperature: float
                        ) -> torch.Tensor:
    """The sampler in plain PyTorch: (B,) int32 ids, the argmax of
    :func:`gumbel_scores_plain` (the lowest index on ties)."""
    return torch.argmax(gumbel_scores_plain(logits, step_keys, offsets,
                                            temperature),
                        dim=-1).to(torch.int32)


_LIB = None
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_SMS: Dict[torch.device, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("sample")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.lir_gumbel_argmax.argtypes = [p, q, i, i, p, p, ctypes.c_float, i,
                                          i, p, p, p, p, p]
        lib.lir_gumbel_argmax.restype = i
        lib.lir_sample_threads.restype = i
        _LIB = lib
    return _LIB


def _tickets(dev: torch.device, B: int) -> torch.Tensor:
    """The per-row ticket counters of the kernel's last-block reduction:
    zero between launches (the last block of a row clears its own), kept
    per device. One stream at a time uses them, as the port runs."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < B:
        t = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def grid_chunks(B: int, V: int, sms: int, threads: int):
    """(chunks a row, vocab entries a chunk): about ``_BLOCKS_PER_SM``
    blocks per SM over the grid, at least ``threads`` entries a chunk."""
    want = max(1, -(-_BLOCKS_PER_SM * sms // B))
    chunks = max(1, min(want, -(-V // threads)))
    chunk = -(-V // chunks)
    return -(-V // chunk), chunk


def _check(logits, step_keys, offsets) -> None:
    dev = logits.device
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or logits.stride(1) != 1:
        raise ValueError(f"gumbel_argmax: logits must be float32 (B, V) with "
                         f"unit column stride, got {logits.dtype} "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    B = logits.shape[0]
    if (step_keys.device != dev or step_keys.dtype != torch.int64
            or step_keys.shape != (B, 2) or not step_keys.is_contiguous()):
        raise ValueError(f"gumbel_argmax: step_keys must be contiguous int64 "
                         f"({B}, 2) on {dev}")
    if (offsets.device != dev or offsets.dtype != torch.int64
            or offsets.shape != (B,) or not offsets.is_contiguous()):
        raise ValueError(f"gumbel_argmax: offsets must be contiguous int64 "
                         f"({B},) on {dev}")


def gumbel_argmax(logits: torch.Tensor, step_keys: torch.Tensor,
                  offsets: torch.Tensor, temperature: float) -> torch.Tensor:
    """Each row's sampled id, (B,) int32. CUDA tensors launch
    ``csrc/sample.cu``; CPU tensors run :func:`gumbel_argmax_plain`."""
    dev = logits.device
    if dev.type == "cpu":
        return gumbel_argmax_plain(logits, step_keys, offsets, temperature)
    if dev.type != "cuda":
        raise ValueError(f"gumbel_argmax needs CPU or CUDA tensors, got {dev}")
    _check(logits, step_keys, offsets)
    B, V = logits.shape
    ids = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ids
    if V == 0:
        raise ValueError("gumbel_argmax: empty vocabulary")
    lib = _lib()
    sms = _SMS.get(dev)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SMS[dev] = sms
    nchunks, chunk = grid_chunks(B, V, sms, lib.lir_sample_threads())
    part_v = torch.empty(B * nchunks, dtype=torch.float32, device=dev)
    part_i = torch.empty(B * nchunks, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.lir_gumbel_argmax(
        logits.data_ptr(), logits.stride(0), B, V, step_keys.data_ptr(),
        offsets.data_ptr(), temperature32(temperature), nchunks, chunk,
        part_v.data_ptr(), part_i.data_ptr(), _tickets(dev, B).data_ptr(),
        ids.data_ptr(), stream), "gumbel_argmax")
    gumbel_argmax.launches += 1
    return ids


gumbel_argmax.launches = 0
