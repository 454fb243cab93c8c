"""The two-leg cascade route against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX
``cascade_attention(..., fused_suffix=False)`` and its trunk-leg
``_prefix_partials`` with the Pallas kernel in the interpreter (as the
JAX package's own tests run it on the CPU), and through the port's
wrappers on CPU tensors, which run the plain versions: ``prefix_partials``
(float32 QK^T) and ``prefix_partials_int8`` (int8 QK^T). The int8
payloads and s32 dot products are exact on both sides and the scale
folds take the same order, so both variants hold to atol = rtol = 2e-5
in float32, the bar of the port's other kernel tests (the softmax sums
run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lir_tpu.ops.cascade_prefill import _prefix_partials as jax_prefix
from lir_tpu.ops.cascade_prefill import cascade_attention as jax_cascade
from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes
from lir_tpu_torch.models.quant import dynamic_quant

TOL = dict(atol=2e-5, rtol=2e-5)

# B * R * G is the flattened query count N: 3 * 7 * 1 = 21 rows is ragged
# against the JAX 128-row block (and the port's 64-row tile).
CASES = {
    "mha": dict(H=4, K=4),
    "gqa": dict(H=8, K=2),
    "mqa": dict(H=4, K=1),
    "alibi": dict(H=4, K=4, alibi=True),
    "ragged_n": dict(H=4, K=4, B=5, R=9),
    "right_pad": dict(H=4, K=2, pad="right"),
    "left_pad": dict(H=4, K=2, pad="left"),
}


def _inputs(case, seed=11):
    c = dict(case)
    B, R, H, K = c.get("B", 3), c.get("R", 7), c["H"], c["K"]
    hd, Tt = 16, 40
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, R, H, hd)).astype(np.float32)
    sk = rng.standard_normal((B, R, K, hd)).astype(np.float32)
    sv = rng.standard_normal((B, R, K, hd)).astype(np.float32)
    tk = rng.standard_normal((K, Tt, hd)).astype(np.float32)
    tv = rng.standard_normal((K, Tt, hd)).astype(np.float32)
    mask = np.ones((B, R), np.int32)
    if c.get("pad") == "right":
        mask[0, 4:] = 0
        mask[2, 1:] = 0
    elif c.get("pad") == "left":
        mask[0, :3] = 0
        mask[1, :R - 1] = 0
    qpos = (Tt + np.maximum(np.cumsum(mask, -1) - 1, 0)).astype(np.int32)
    slopes = alibi_slopes(H).numpy() if c.get("alibi") else None
    return (q, sk, sv, tk, tv, mask, qpos), slopes


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_two_leg_cascade_matches_jax(name, int8_qk):
    arrs, slopes = _inputs(CASES[name])
    ref = jax_cascade(*(jnp.asarray(a) for a in arrs),
                      alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                      int8_qk=int8_qk, fused_suffix=False, interpret=True)
    got = ops.cascade_attention(
        *(torch.from_numpy(a) for a in arrs),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        int8_qk=int8_qk, fused_suffix=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("name", ["mha", "mqa", "alibi", "ragged_n"])
def test_prefix_partials_match_jax(name, int8_qk):
    """The trunk-leg partials (o, m, l) themselves, in the (B, K, R, G)
    layout of both packages: m is the row max over the whole trunk."""
    (q, _, _, tk, tv, _, _), slopes = _inputs(CASES[name])
    ref = jax_prefix(jnp.asarray(q), jnp.asarray(tk), jnp.asarray(tv),
                     None if slopes is None else jnp.asarray(slopes),
                     int8_qk, 128, True)
    fn = ops.cascade_prefix_int8 if int8_qk else ops.cascade_prefix
    got = fn(torch.from_numpy(q), torch.from_numpy(tk), torch.from_numpy(tv),
             None if slopes is None else torch.from_numpy(slopes))
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_int8_scores_are_the_quantized_product():
    """The int8 twin's scores before the softmax: the s32 dot of the
    dynamic_quant payloads, exact, folded as (s32 * (qs * sm)) * ks."""
    (q, _, _, tk, tv, _, _), _ = _inputs(CASES["gqa"])
    qt, kt = torch.from_numpy(q), torch.from_numpy(tk)
    B, R, H, hd = qt.shape
    K = kt.shape[0]
    qq, qs = dynamic_quant(qt.reshape(B, R, K, H // K, hd))
    kq, ks = dynamic_quant(kt)
    s32 = torch.einsum("brkgd,ktd->bkrgt", qq.to(torch.int64), kq.to(torch.int64))
    s32f = torch.einsum("brkgd,ktd->bkrgt", qq.float(), kq.float())
    assert torch.equal(s32f, s32.float())
    o, m, l = ops.prefix_partials_int8(qt, kt, torch.from_numpy(tv), None)
    s = (s32.float() * (qs * (1.0 / np.sqrt(hd))).permute(0, 2, 1, 3)[..., None]
         * ks[None, :, None, None, :])
    assert torch.equal(m, s.amax(dim=-1))


def test_two_leg_wrappers_count_only_kernel_launches():
    """On CPU tensors the trunk-leg wrappers run their plain versions."""
    arrs, _ = _inputs(CASES["mha"])
    ops.reset_launches()
    for int8_qk in (False, True):
        ops.cascade_attention(*(torch.from_numpy(a) for a in arrs),
                              int8_qk=int8_qk, fused_suffix=False)
    assert ops.launch_counts()["cascade_prefix"] == 0
    assert ops.launch_counts()["cascade_prefix_int8"] == 0


@pytest.mark.parametrize("name", ["mha", "gqa", "mqa", "alibi"])
def test_prefix_partials_int8_take_a_slice_of_all_layers_keys(name):
    """The int8 trunk leg given its layer's slice of ONE dynamic_quant of
    every layer's trunk keys (as decoder.cascade_extend hands it over):
    the partials bitwise its own quantization's, and the two-leg route on
    that slice within the bar of the JAX package's."""
    (q, sk, sv, tk, tv, mask, qpos), slopes = _inputs(CASES[name])
    rng = np.random.default_rng(3)
    keys = np.stack([tk, rng.standard_normal(tk.shape).astype(np.float32) * 3,
                     np.zeros_like(tk)])                      # 3 layers
    L, (K, Tt, hd) = keys.shape[0], tk.shape
    kq, ks = dynamic_quant(torch.from_numpy(keys).reshape(L * K * Tt, hd))
    kq, ks = kq.view(L, K, Tt, hd), ks.view(L, K, Tt)
    t = torch.from_numpy
    ts = None if slopes is None else t(slopes)
    for i in range(L):
        own = ops.prefix_partials_int8(t(q), t(keys[i]), t(tv), ts)
        given = ops.prefix_partials_int8(t(q), t(keys[i]), t(tv), ts,
                                         trunk_k_int8=(kq[i], ks[i]))
        for a, b in zip(own, given):
            assert torch.equal(a, b)
    got = ops.cascade_attention(t(q), t(sk), t(sv), t(keys[1]), t(tv), t(mask),
                                t(qpos), alibi_slopes=ts, int8_qk=True,
                                fused_suffix=False, trunk_k_int8=(kq[1], ks[1]))
    ref = jax_cascade(*(jnp.asarray(a) for a in (q, sk, sv, keys[1], tv, mask, qpos)),
                      alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                      int8_qk=True, fused_suffix=False, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
