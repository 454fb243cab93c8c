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

On a CUDA tensor :func:`gumbel_argmax` launches ``csrc/sample.cu`` (one
thread-block cluster a row, in the launch plan of :func:`plan`); on a
CPU tensor it runs :func:`gumbel_argmax_plain`, the same chain in torch
on ``engine/prng.py``. The kernel keeps nothing between launches and the
wrapper allocates only the ids. The source note in ``csrc/sample.cu``
says what bounds the kernel and what its design does about it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..engine import prng
from . import _build

# The kernel's constants (csrc/sample.cu): threads a block, entries a
# thread takes at a time (one 16-byte load), blocks a cluster at most
# (16, the H100's non-portable size) and the portable size.
THREADS = 256
PER_THREAD = 4
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
# A cluster's slices are multiples of this many entries (a thread's unit
# divides it), and a block takes at least a unit a thread.
SLICE_ALIGN = 8
MIN_SLICE = THREADS * PER_THREAD
# Up to SPREAD blocks an SM over the grid, every row takes the largest
# cluster; past that, a row takes sms // B blocks (one block an SM).
SPREAD = 4


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


class Plan(NamedTuple):
    """A launch of the sampler: ``cluster`` blocks a row, each taking
    ``slice`` entries of it, in a grid of ``blocks`` = B * cluster
    blocks (x: the cluster's rank, y: the row)."""

    cluster: int
    slice: int
    blocks: int

    @property
    def non_portable(self) -> bool:
        """Whether the cluster exceeds the portable 8 blocks (the kernel
        then allows the non-portable size before it launches)."""
        return self.cluster > PORTABLE_CLUSTER


@functools.lru_cache(maxsize=256)
def plan(B: int, V: int, sms: int) -> Plan:
    """The launch plan of B rows of V entries on a card of ``sms`` SMs.
    While B * MAX_CLUSTER blocks stay within SPREAD blocks an SM, every
    row takes MAX_CLUSTER blocks: the card's scheduler places large
    clusters one to a GPC and doubles some up, and many small blocks even
    that out. Past it, a row takes ``sms // B`` blocks (at least one),
    one block an SM. A block keeps at least MIN_SLICE entries (fewer
    blocks for a small V); each slice is ``ceil(V / cluster)`` rounded up
    to SLICE_ALIGN. The grid is ``blocks`` = B * cluster blocks. The id
    does not depend on the plan (the argmax is order-free), only the
    time does."""
    if B < 1 or V < 1 or sms < 1:
        raise ValueError(f"gumbel_argmax: no plan for B={B}, V={V}, "
                         f"{sms} SMs")
    if B * MAX_CLUSTER <= SPREAD * sms:
        cluster = MAX_CLUSTER
    else:
        cluster = max(1, min(MAX_CLUSTER, sms // B))
    cluster = max(1, min(cluster, V // MIN_SLICE))
    slice_ = -(-(-(-V // cluster)) // SLICE_ALIGN) * SLICE_ALIGN
    return Plan(cluster, slice_, B * cluster)


def block_entries(p: Plan, V: int, rank: int, head: int,
                  per_thread: int = PER_THREAD) -> List[range]:
    """The vocab entries block ``rank`` of a row's cluster takes, as
    ranges, as the kernel splits them: the row's ``head`` entries before
    its first aligned unit (``min(V, head)``), then whole units of
    ``per_thread`` entries, ``slice / per_thread`` units a block in rank
    order, and the entries after the last whole unit; rank 0 also takes
    the head and those last entries."""
    head = min(V, head)
    units = (V - head) // per_thread
    per = p.slice // per_thread
    u0, u1 = rank * per, min(units, (rank + 1) * per)
    out = [range(head + u0 * per_thread, head + max(u0, u1) * per_thread)]
    if rank == 0:
        out += [range(head), range(head + units * per_thread, V)]
    return out


_LIB = None
_SMS: Dict[torch.device, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("sample")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.lir_gumbel_argmax.argtypes = [p, q, i, i, p, p, ctypes.c_float, i,
                                          i, p, p]
        lib.lir_gumbel_argmax.restype = i
        for name in ("lir_sample_threads", "lir_sample_per_thread",
                     "lir_sample_max_cluster"):
            getattr(lib, name).restype = i
        _LIB = lib
    return _LIB


def _sms(dev: torch.device) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SMS[dev] = sms
    return sms


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
    ``csrc/sample.cu`` in :func:`plan`'s clusters; CPU tensors run
    :func:`gumbel_argmax_plain`."""
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
    p = plan(B, V, _sms(dev))
    _build.check(_lib().lir_gumbel_argmax(
        logits.data_ptr(), logits.stride(0), B, V, step_keys.data_ptr(),
        offsets.data_ptr(), temperature32(temperature), p.cluster, p.slice,
        ids.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "gumbel_argmax")
    gumbel_argmax.launches += 1
    return ids


gumbel_argmax.launches = 0
