"""The port's kernel modules against the JAX package's kernels.

The same numpy inputs, made from a seed, go through the JAX public
function in the Pallas interpreter (as the JAX package's own tests run
it on the CPU) and through the port's wrapper on CPU tensors, which runs
the plain PyTorch version. Tolerance atol = rtol = 2e-5 in float32: the
two frameworks sum in different orders (the JAX kernels merge split
partials, the plain versions take one softmax over all keys).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lir_tpu.ops.cascade_prefill import cascade_attention as jax_cascade
from lir_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from lir_tpu.ops.flash_decode import flash_decode_trunk as jax_flash_trunk
from lir_tpu.ops.lse import merge_partials as jax_merge
from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes
from lir_tpu_torch.ops.flash_decode import DECODE_SPLIT, trunk_splits

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _positions(mask):
    return np.maximum(np.cumsum(mask, axis=-1) - 1, 0).astype(np.int32)


def _decode_inputs(seed, B, H, K, hd, T, mask_kind="full", trunk_len=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((K, T, B, hd)).astype(np.float32)
    v = rng.standard_normal((K, T, B, hd)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    if mask_kind == "left":
        for b in range(B):
            mask[b, :3 + 5 * b] = 0
    elif mask_kind == "right":
        for b in range(B):
            mask[b, T - 4 - 7 * b:] = 0
    elif mask_kind == "masked_split":
        # Row 1's first 70 slots masked: whole splits of both ladders empty.
        mask[1, :70] = 0
    elif mask_kind == "masked_row":
        mask[1, :] = 0
    if trunk_len:
        k[:, :trunk_len] = k[:, :trunk_len, :1]
        v[:, :trunk_len] = v[:, :trunk_len, :1]
    kpos = _positions(mask)
    qpos = kpos.max(axis=-1).astype(np.int32)
    return q, k, v, qpos, mask, kpos


DECODE_CASES = {
    "mha": dict(H=4, K=4, hd=16),
    "gqa2": dict(H=4, K=2, hd=16),
    "gqa4": dict(H=8, K=2, hd=16),
    "mqa": dict(H=4, K=1, hd=16),
    "alibi": dict(H=4, K=4, hd=16, alibi=True),
    "left_pad": dict(H=4, K=2, hd=16, mask_kind="left"),
    "right_pad": dict(H=4, K=2, hd=16, mask_kind="right"),
    "masked_split": dict(H=4, K=2, hd=16, mask_kind="masked_split"),
    "masked_row": dict(H=4, K=4, hd=16, mask_kind="masked_row"),
}


def _run_both(case, seed, T, trunk_len=0):
    kw = dict(case)
    alibi = kw.pop("alibi", False)
    mask_kind = kw.pop("mask_kind", "full")
    q, k, v, qpos, mask, kpos = _decode_inputs(seed, 3, T=T,
                                               mask_kind=mask_kind,
                                               trunk_len=trunk_len, **kw)
    slopes = alibi_slopes(kw["H"]).numpy() if alibi else None
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(qpos), jnp.asarray(mask))
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, qpos, mask))
    jslopes = None if slopes is None else jnp.asarray(slopes)
    tslopes = None if slopes is None else torch.from_numpy(slopes)
    return jargs, targs, jnp.asarray(kpos), torch.from_numpy(kpos), jslopes, tslopes


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_flash_decode_matches_jax(name):
    jargs, targs, jkp, tkp, jsl, tsl = _run_both(DECODE_CASES[name], 0, T=80)
    ref = jax_flash_decode(*jargs, key_positions=jkp, alibi_slopes=jsl,
                           block_k=16, interpret=True)
    got = ops.flash_decode(*targs, key_positions=tkp, alibi_slopes=tsl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("trunk_len", [10, 150])
@pytest.mark.parametrize("name", ["mha", "gqa4", "mqa", "alibi"])
def test_flash_decode_trunk_matches_jax_and_flat(name, trunk_len):
    T = 176
    jargs, targs, jkp, tkp, jsl, tsl = _run_both(DECODE_CASES[name], 1, T=T,
                                                 trunk_len=trunk_len)
    assert (trunk_splits(trunk_len, T) > 0) == (trunk_len >= DECODE_SPLIT)
    ref = jax_flash_trunk(*jargs, key_positions=jkp, alibi_slopes=jsl,
                          trunk_len=trunk_len, block_k=16, interpret=True)
    got = ops.flash_decode_trunk(*targs, key_positions=tkp, alibi_slopes=tsl,
                                 trunk_len=trunk_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    flat = ops.flash_decode(*targs, key_positions=tkp, alibi_slopes=tsl)
    assert torch.equal(got, flat)


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    m = rng.standard_normal((2, 5, 3)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 5, 3)).astype(np.float32)
    m[0, 1, :] = -np.inf        # an empty partition
    l[0, 1, :] = 0.0
    m[1, :, 2] = -np.inf        # an all-empty row
    l[1, :, 2] = 0.0
    ref = jax_merge(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l), axis=1)
    got = ops.merge_partials(torch.from_numpy(o), torch.from_numpy(m),
                             torch.from_numpy(l), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.all(got.numpy()[1, 2] == 0.0)


CASCADE_CASES = {
    "mha": dict(H=4, K=4),
    "gqa2": dict(H=4, K=2),
    "gqa4": dict(H=8, K=2),
    "mqa": dict(H=4, K=1),
    "alibi": dict(H=4, K=4, alibi=True),
    "padded_rows": dict(H=4, K=2, pad=True),
    "masked_row": dict(H=4, K=2, masked_row=True),
}


@pytest.mark.parametrize("name", sorted(CASCADE_CASES))
def test_cascade_attention_matches_jax(name):
    case = dict(CASCADE_CASES[name])
    H, K = case["H"], case["K"]
    B, R, hd, Tt = 3, 8, 16, 24
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, R, H, hd)).astype(np.float32)
    sk = rng.standard_normal((B, R, K, hd)).astype(np.float32)
    sv = rng.standard_normal((B, R, K, hd)).astype(np.float32)
    tk = rng.standard_normal((K, Tt, hd)).astype(np.float32)
    tv = rng.standard_normal((K, Tt, hd)).astype(np.float32)
    mask = np.ones((B, R), np.int32)
    if case.get("pad"):
        mask[0, 5:] = 0
        mask[2, 2:] = 0
    if case.get("masked_row"):
        mask[1, :] = 0
    qpos = (Tt + _positions(mask)).astype(np.int32)
    slopes = alibi_slopes(H).numpy() if case.get("alibi") else None
    ref = jax_cascade(jnp.asarray(q), jnp.asarray(sk), jnp.asarray(sv),
                      jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(mask),
                      jnp.asarray(qpos),
                      alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                      interpret=True)
    got = ops.cascade_attention(
        *(torch.from_numpy(a) for a in (q, sk, sv, tk, tv, mask, qpos)),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no count."""
    ops.reset_launches()
    _, targs, _, tkp, _, _ = _run_both(DECODE_CASES["mha"], 0, T=80)
    ops.flash_decode(*targs, key_positions=tkp)
    ops.flash_decode_trunk(*targs, key_positions=tkp, trunk_len=70)
    q, k, v, qpos, mask = targs
    q2, qpos2 = q[:, None].repeat(1, 2, 1, 1), qpos[:, None].repeat(1, 2)
    ops.flash_decode_mq(q2, k, v, qpos2, mask, key_positions=tkp)
    ops.flash_decode_mq_trunk(q2, k, v, qpos2, mask, key_positions=tkp,
                              trunk_len=70)
    x = torch.randn((3, 16))
    ops.row_gemm(x, torch.randn((16, 8)))
    ops.row_norm(x, torch.ones(16), None, 1e-5)
    ops.row_add_norm(x, x, torch.ones(16), None, 1e-5)
    ops.quantize_rows(x)
    qf = torch.randn((1, 5, 2, 64))
    ops.flash_attention(qf, qf, qf)
    acc = {"filled": torch.zeros((2, 4), dtype=torch.int32),
           "rel": torch.zeros((2, 4)), "conf": torch.zeros((2, 4)),
           "dec": torch.zeros((2, 4), dtype=torch.int32)}
    r = torch.rand(3)
    ops.stream_fold(acc, r, r, r, -torch.rand((3, 20)),
                    torch.zeros(3, dtype=torch.int32),
                    torch.arange(3, dtype=torch.int32))
    ops.gumbel_argmax(torch.randn((3, 50)),
                      torch.zeros((3, 2), dtype=torch.int64),
                      torch.zeros(3, dtype=torch.int64), 0.9)
    k8 = torch.zeros((2, 80, 3, 16), dtype=torch.int8)
    s8 = torch.ones((2, 80, 3))
    ops.kv_int8_attention(torch.randn((3, 2, 4, 16)), k8, s8, k8, s8,
                          torch.zeros((3, 2), dtype=torch.int32), mask, tkp)
    assert set(ops.flash_attention.route_launches.values()) == {0}
    assert ops.launch_counts() == {"flash_decode": 0, "flash_decode_trunk": 0,
                                   "cascade_attention": 0,
                                   "flash_decode_mq": 0,
                                   "flash_decode_mq_trunk": 0,
                                   "cascade_prefix": 0,
                                   "cascade_prefix_int8": 0,
                                   "flash_attention": 0,
                                   "row_gemm": 0, "row_norm": 0,
                                   "row_add_norm": 0,
                                   "cascade_suffix_merge": 0,
                                   "quantize_rows": 0, "stream_fold": 0,
                                   "gumbel_argmax": 0,
                                   "kv_int8_attention": 0}
