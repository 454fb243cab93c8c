"""The port's prefill flash attention against the JAX package's kernel.

The same numpy inputs, made from a seed, go through the JAX
``flash_attention(..., interpret=True)`` (the Pallas kernel in the
interpreter, as the JAX package's own tests run it on the CPU; the JAX
function wants per-query-head k/v, so its k/v are repeated to H heads as
the JAX decoder repeats them) and through the port's wrapper on CPU
tensors, which runs the plain version over the un-repeated k/v.
Tolerance atol = rtol = 2e-5 in float32: the JAX kernel sums key blocks
with an online softmax, the plain version takes one softmax over all
keys. A query row with no valid key is 0 on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lir_tpu.ops.flash_attention import flash_attention as jax_flash
from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes, mask_positions

TOL = dict(atol=2e-5, rtol=2e-5)

CASES = {
    "short_full": dict(S=48, H=4, K=4),
    "block": dict(S=128, H=4, K=4, pad="left"),
    "two_blocks": dict(S=256, H=4, K=2, pad="left"),
    "left_pad": dict(S=64, H=4, K=4, pad="left"),
    "right_pad": dict(S=64, H=4, K=4, pad="right"),
    "holes": dict(S=64, H=4, K=4, pad="holes"),
    "gqa": dict(S=64, H=8, K=2, pad="left"),
    "mqa": dict(S=64, H=4, K=1, pad="right"),
    "alibi": dict(S=64, H=4, K=4, pad="left", alibi=True),
    "alibi_holes": dict(S=256, H=4, K=4, pad="holes", alibi=True),
    "masked_row": dict(S=64, H=4, K=2, pad="masked_row"),
}


def _inputs(case, seed=3):
    S, H, K, hd, B = case["S"], case["H"], case["K"], 16, 3
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    pad = case.get("pad")
    if pad == "left":
        mask[0, :5] = 0
        mask[1, :S - 3] = 0
    elif pad == "right":
        mask[0, S - 7:] = 0
        mask[2, 9:] = 0
    elif pad == "holes":
        mask[0, 10:20] = 0
        mask[1, ::3] = 0
        mask[2, :S // 2] = 0
    elif pad == "masked_row":
        mask[1, :] = 0                      # every query of row 1: no key
        mask[2, :S - 1] = 0                 # row 2: only its last slot
    return q, k, v, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    case = CASES[name]
    q, k, v, mask = _inputs(case)
    H, K = case["H"], case["K"]
    alibi = case.get("alibi", False)
    tmask = torch.from_numpy(mask)
    kpos = mask_positions(tmask) if alibi else None
    slopes = alibi_slopes(H) if alibi else None
    G = H // K
    ref = jax_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
                    jnp.asarray(np.repeat(v, G, axis=2)), causal=True,
                    key_mask=jnp.asarray(mask),
                    alibi_slopes=None if slopes is None else jnp.asarray(slopes.numpy()),
                    key_positions=None if kpos is None else jnp.asarray(kpos.numpy()),
                    interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), key_mask=tmask,
                              alibi_slopes=slopes, key_positions=kpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if case.get("pad") == "masked_row":
        assert np.all(got.numpy()[1] == 0.0)
        # Row 2's queries before its one valid slot see no key: 0 too.
        assert np.all(got.numpy()[2, :-1] == 0.0)


def test_flash_wrapper_counts_only_kernel_launches():
    q, k, v, mask = _inputs(CASES["gqa"])
    ops.reset_launches()
    ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), key_mask=torch.from_numpy(mask))
    assert ops.launch_counts()["flash_attention"] == 0
