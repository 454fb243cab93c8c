"""The int8-KV attention kernel's launch plan and its split summation
order, on the CPU (no engine is built).

- ``ops.kv_int8_attention.plan``: for T from 1 to 3,000, every head dim
  the kernel is built for and S * G from 1 to 64 query rows a (batch row,
  kv head) pair, the cluster's blocks cover every cache slot once and the
  row chunks every query row once; a block's shared memory fits the
  H100's opt-in 232,448 bytes; a cluster has at most 8 blocks; and the
  split is ``split_of(T, hd)`` whatever the rows or the card's limit.
- ``split_sum`` adds in the order the kernel documents (lanes, butterfly,
  blocks in rank order), checked against a scalar float32 loop.
- ``split_chain`` (the twin's chain with the softmax sum in that order
  for the plan's split) against the JAX package's
  ``_attention_cached_int8`` on seeded numpy inputs: the s32 scores are
  the exact integer products, every ``pw / ps`` lies within 1e-3 of the
  unsplit twin's, and the output lies within ``tie_bar`` of the JAX
  output, so the kernel's bar holds for the split's merge order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch.models import decoder

kv = importlib.import_module("lir_tpu_torch.ops.kv_int8_attention")

# Compiled once a shape (op-by-op dispatch costs seconds on the CPU).
_attention = jax.jit(jdec._attention_cached_int8, static_argnums=(6,))
_bias = jax.jit(jdec._causal_bias, static_argnums=(2,))
_quant = jax.jit(jdec._quant_kv)


def _slots(p, T):
    """Each cluster rank's slots of T, as the kernel takes them."""
    return [t for c in range(p.splits)
            for t in range(c * p.slice, min(T, (c + 1) * p.slice))]


def _rows(p, SG):
    """Each chunk's query rows of S * G, as the kernel takes them."""
    return [r for c in range(p.chunks)
            for r in range(c * p.rows, min(SG, (c + 1) * p.rows))]


@pytest.mark.parametrize("hd", kv.HEAD_DIMS)
def test_plan_covers_every_slot_and_row_and_fits(hd):
    for T in range(1, 3001):
        split = kv.split_of(T, hd)
        assert 1 <= split[0] <= kv.MAX_SPLITS
        assert _slots(kv.plan(T, hd, 1), T) == list(range(T))
        for SG in range(1, 65):
            p = kv.plan(T, hd, SG)
            assert (p.splits, p.slice) == split
            assert 1 <= p.rows <= kv.MAX_ROWS
            assert (p.chunks - 1) * p.rows < SG <= p.chunks * p.rows
            assert p.smem + kv.STATIC_SMEM <= 232_448
            assert p.mma == (p.rows >= kv.MMA_ROWS)
    # A smaller card moves rows into chunks, not the split.
    p = kv.plan(3000, hd, 64, smem_limit=100_000)
    assert (p.splits, p.slice) == kv.split_of(3000, hd)
    assert p.smem + kv.STATIC_SMEM <= 100_000
    assert p.chunks > 1 and _rows(p, 64) == list(range(64))


def test_split_sum_is_the_documented_order():
    rng = np.random.default_rng(7)
    for T, slice_ in ((1, 8), (37, 40), (100, 40), (300, 104)):
        e = rng.random((2, T)).astype(np.float32)
        want = []
        for row in e:
            total = None
            for lo in range(0, T, slice_):
                part = row[lo:lo + slice_]
                lanes = [np.float32(0.0)] * 32
                for t, x in enumerate(part):
                    lanes[t % 32] = np.float32(lanes[t % 32] + x)
                for off in (16, 8, 4, 2, 1):
                    lanes = [np.float32(lanes[i] + lanes[i ^ off])
                             for i in range(32)]
                total = lanes[0] if total is None else np.float32(
                    total + lanes[0])
            want.append(total)
        got = kv.split_sum(torch.from_numpy(e), slice_).numpy()
        np.testing.assert_array_equal(got, np.array(want, np.float32))


def _inputs(seed, B, S, H, K, hd, T, all_masked_row):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kq = rng.integers(-127, 128, (K, T, B, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (K, T, B, hd)).astype(np.int8)
    ks = (rng.random((K, T, B)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((K, T, B)) * 0.02 + 1e-3).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, T // 3:T // 3 + 5] = 0
    mask[:, T - 2:] = 0
    if all_masked_row:
        mask[B - 1] = 0
    kpos = np.maximum(np.cumsum(mask, -1) - 1, 0).astype(np.int32)
    qpos = (kpos.max(-1)[:, None] - (S - 1) + np.arange(S)[None]).astype(
        np.int32)
    return q, kq, ks, vq, vs, qpos, mask, kpos


# (S, H, K, hd, T, alibi, all_masked_row): two, three and three blocks a
# cluster (split_of), MHA / GQA / MQA, ALiBi, a row with every key masked.
SPLIT_CASES = [(1, 4, 4, 128, 600, True, False),
               (4, 4, 2, 128, 1100, False, False),
               (3, 4, 1, 64, 2100, False, True)]


@pytest.mark.parametrize("S,H,K,hd,T,alibi,all_masked", SPLIT_CASES)
def test_split_chain_within_the_bar_of_jax(S, H, K, hd, T, alibi,
                                           all_masked):
    B = 2
    assert kv.split_of(T, hd)[0] > 1
    arrays = _inputs(T + S, B, S, H, K, hd, T, all_masked)
    q, kq, ks, vq, vs, qpos, mask, kpos = arrays
    jcfg = JaxModelConfig(name="kv8-plan", vocab_size=128, hidden_size=H * hd,
                          n_layers=1, n_heads=H, n_kv_heads=K,
                          intermediate_size=64, max_seq_len=4096,
                          kv_cache_int8=True,
                          pos_embedding="alibi" if alibi else "rotary")
    bias = _bias(jnp.ones((B, S), jnp.int32), jnp.asarray(qpos), jcfg,
                 key_positions=jnp.asarray(kpos), key_mask=jnp.asarray(mask))
    ref = np.asarray(_attention(*(jnp.asarray(a) for a in arrays[:5]), bias,
                                jcfg))
    args = tuple(torch.as_tensor(a) for a in arrays)
    slopes = decoder.alibi_slopes(H) if alibi else None
    # The s32 scores: the exact integer products.
    qq, _ = _quant(jnp.asarray(q))
    s32 = np.einsum("bshd,htbd->bhst", np.asarray(qq).astype(np.int64),
                    np.repeat(kq.astype(np.int64), H // K, axis=0))
    np.testing.assert_array_equal(kv.qk_s32_plain(args[0], args[1]).numpy(),
                                  s32)
    out, pw, ps = kv.split_chain(*args, alibi_slopes=slopes)
    _, pw_u, ps_u = kv._plain(*args, slopes)
    x, x_u = pw / ps[..., None], pw_u / ps_u[..., None]
    assert float((x - x_u).abs().max()) < 1e-3
    bar = kv.tie_bar(*args, alibi_slopes=slopes)
    err = (out.reshape(B, S, -1) - torch.as_tensor(ref.copy())).abs()
    assert bool((err <= bar).all()), float((err - bar).max())
