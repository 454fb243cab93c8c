"""Statistic primitives shared by every stats function.

Port of ``lir_tpu/stats/core.py``: Pearson/Spearman correlation, average
ranks with tie handling, resample-index generation and the percentile
CI, as plain torch functions that broadcast over leading axes, so a
bootstrap is one batched computation over a (n_boot, n) index tensor.

Random draws. The JAX package draws from ``jax.random`` keys; torch
cannot reproduce those streams. So every function here that draws takes
an explicit CPU ``torch.Generator`` and makes its draws on the CPU (the
same bits whatever device the statistic then runs on), then moves them
to ``device``; each statistic is a pure reduction of those draws, which
the tests feed JAX's own draws. :func:`generator_for` is the one seeding
rule of the port's keyed draws.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson r along the last axis. Broadcasts over leading axes."""
    xm = x - x.mean(dim=-1, keepdim=True)
    ym = y - y.mean(dim=-1, keepdim=True)
    cov = (xm * ym).sum(dim=-1)
    denom = torch.sqrt((xm * xm).sum(dim=-1) * (ym * ym).sum(dim=-1))
    return torch.where(denom > 0, cov / denom, torch.nan)


def average_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks (1-based) with ties given their average rank, along the last
    axis — ``scipy.stats.rankdata(method='average')``, by the same O(n^2)
    pairwise comparison as the JAX package."""
    lt = (x[..., :, None] > x[..., None, :]).sum(dim=-1)
    eq = (x[..., :, None] == x[..., None, :]).sum(dim=-1)
    return (lt + (eq + 1) / 2.0).to(x.dtype)


def spearman(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rho along the last axis (Pearson of average ranks)."""
    return pearson(average_ranks(x), average_ranks(y))


def generator_for(*words: int) -> torch.Generator:
    """A CPU generator seeded from integer words, e.g. ``(seed,
    prompt_idx, salt)``: the seed is the first 64-bit word of
    ``numpy.random.SeedSequence([w mod 2**64 for w in words])``, so
    nearby words give unrelated streams and the rule is fixed across
    numpy versions."""
    entropy = [int(w) % 2**64 for w in words]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    gen = torch.Generator()
    gen.manual_seed(int(state))
    return gen


def resample_indices(generator: torch.Generator, n_boot: int, n: int,
                     device="cuda") -> torch.Tensor:
    """(n_boot, n) with-replacement resample indices, drawn on the CPU
    from ``generator`` and moved to ``device``."""
    idx = torch.randint(0, n, (n_boot, n), generator=generator,
                        dtype=torch.int64)
    return idx.to(resolve_device(device))


def permutations(generator: torch.Generator, n_perm: int, n: int,
                 device="cuda") -> torch.Tensor:
    """(n_perm, n) permutations of range(n), each the argsort of float64
    uniforms drawn on the CPU from ``generator``, moved to ``device``."""
    u = torch.rand((n_perm, n), generator=generator, dtype=torch.float64)
    return torch.argsort(u, dim=-1).to(resolve_device(device))


def standard_normal(generator: torch.Generator, shape: Sequence[int],
                    device="cuda") -> torch.Tensor:
    """float32 standard normals of ``shape``, drawn on the CPU from
    ``generator`` and moved to ``device``."""
    z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    return z.to(resolve_device(device))


def percentile_ci(samples: torch.Tensor, confidence: float = 0.95
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Percentile CI along the last axis, NaNs ignored, linear
    interpolation (``jnp.nanpercentile``); returns (lower, upper)."""
    alpha = (1.0 - confidence) / 2.0
    lower = torch.nanquantile(samples, alpha, dim=-1)
    upper = torch.nanquantile(samples, 1.0 - alpha, dim=-1)
    return lower, upper


def nan_filter(x, *others):
    """Host-side helper: keep positions finite in every array (the reference
    filters NaN/inf before every statistic, SURVEY.md §4)."""
    arrs = [np.asarray(a, dtype=float) for a in (x, *others)]
    mask = np.ones(arrs[0].shape[0], dtype=bool)
    for a in arrs:
        mask &= np.isfinite(a)
    out = tuple(a[mask] for a in arrs)
    return out if others else out[0]


def as_f32(values, device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``: the dtype the JAX
    package computes its statistics in (it never enables x64, so a
    float64 input runs in float32 there)."""
    arr = np.asarray(values, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(arr).to(resolve_device(device))
