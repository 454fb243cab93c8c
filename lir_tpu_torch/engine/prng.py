"""JAX's threefry2x32 random keys and draws, on torch tensors.

The JAX package samples with ``jax.random`` under its defaults: the
threefry2x32 generator with ``jax_threefry_partitionable=True``. This
module computes the same keys and the same bits from the published
algorithm (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011: Threefry-2x32 with 20 rounds), so that a seed gives the port
the draws it gives the JAX package:

- a key is a pair of uint32 words, held here as the last dimension (of
  size 2) of an int64 tensor, on any device; leading dimensions are a
  batch of keys and every function is vectorised over them;
- ``prng_key(seed)`` = (0, seed) for a 32-bit seed;
- ``fold_in(key, d)`` = threefry(key, (0, d));
- ``split(key, n)[i]`` = threefry(key, (hi(i), lo(i))), the 64-bit
  counter i as two words, as ``iota_2x32_shape`` lays it out;
- the 32 random bits at flat index i of a shape are ``x0 ^ x1`` of
  threefry(key, (hi(i), lo(i)));
- a float32 uniform keeps the top 23 bits as the mantissa of a number in
  [1, 2), subtracts 1, then scales and shifts to [minval, maxval) and
  clamps at minval;
- Gumbel noise is ``-log(-log(u))`` of the uniform on [tiny, 1).

Bits, keys and uniforms are bitwise JAX's; the Gumbel noise differs from
XLA's by the last place of ``log`` where the two libraries round it
differently.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)

KeyLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words
    (broadcast against each other). Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def as_key(key: KeyLike, device=None) -> torch.Tensor:
    """A key (or a batch of keys) as an int64 tensor of uint32 words;
    numpy uint32 arrays (the JAX package's legacy keys) are accepted."""
    if isinstance(key, torch.Tensor):
        out = key.to(torch.int64)
    else:
        out = torch.as_tensor(np.asarray(key, dtype=np.int64))
    if out.shape[-1:] != (2,):
        raise ValueError(f"a threefry key ends in a dimension of 2, got "
                         f"{tuple(out.shape)}")
    return out if device is None else out.to(device)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def is_per_row_keys(key: KeyLike) -> bool:
    """True for a batch of keys (B, 2), one stream per row; False for one
    key (2,). The counterpart of the JAX package's check on legacy
    uint32 keys."""
    return len(tuple(key.shape if hasattr(key, "shape")
                     else np.shape(key))) == 2


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return key[..., 0], key[..., 1]


def fold_in(key: KeyLike, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data)). ``key`` (..., 2)
    and ``data`` (an int or a tensor broadcasting against key[..., 0])
    give keys of the broadcast shape + (2,)."""
    key = as_key(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2)."""
    key = as_key(key)
    hi, lo = _counters(num, key.device)
    k0, k1 = _words(key[..., None, :])
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack((y0, y1), dim=-1)


def random_bits32(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values: keys
    (..., 2) give (..., *shape)."""
    key = as_key(key)
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)), key.device)
    lead = key.shape[:-1]
    k0, k1 = _words(key.reshape(*lead, *([1] * len(shape)), 2))
    y0, y1 = threefry2x32(k0, k1, hi.view(shape), lo.view(shape))
    return y0 ^ y1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1 (exact)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _scale_to(floats: torch.Tensor, minval: float, maxval: float
              ) -> torch.Tensor:
    """floats * (maxval - minval) + minval, clamped below at minval, as
    XLA computes it: the span rounded to float32, then one fused
    multiply-add. The float64 product of two float32 numbers is exact,
    so the float64 sum rounded to float32 is the fused result (up to a
    double rounding that needs the sum to land on a float32 halfway
    point). For the [0, 1) and [tiny, 1) ranges the span is 1 and every
    step is exact in float32."""
    span = float(np.float32(maxval) - np.float32(minval))
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    if span == 1.0:
        return torch.maximum(lo, floats + lo)
    fused = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, fused)


def uniform(key: KeyLike, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _scale_to(bits_to_unit(random_bits32(key, shape)), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1) from the
    bits (``jax.random.gumbel``'s default "low" mode)."""
    u = _scale_to(bits_to_unit(bits), TINY, 1.0)
    return -torch.log(-torch.log(u))


def gumbel(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``."""
    return gumbel_from_bits(random_bits32(key, shape))
