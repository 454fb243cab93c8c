"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA card (decided inside
the test, never at import). Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). bf16 kernel output against the float32 plain
version of the same bf16 inputs, atol = rtol = 1e-2 (bf16 output
rounding); the trunk kernels bitwise the flat ones, and query j of the
multi-query kernel bitwise the single-query kernel at its position.
"""

import pytest
import torch

from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("H,K,hd,alibi", [(8, 8, 128, False), (8, 2, 128, False),
                                          (71, 1, 64, False), (8, 8, 64, True)])
def test_flash_decode_kernels_match_plain(gen, H, K, hd, alibi):
    B, T, trunk = 4, 300, 200
    q = _rnd(gen, B, H, hd)
    k, v = _rnd(gen, K, T, B, hd), _rnd(gen, K, T, B, hd)
    k[:, :trunk] = k[:, :trunk, :1]
    v[:, :trunk] = v[:, :trunk, :1]
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    mask[1, 220:260] = 0
    mask[:, T - 2:] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = kpos.max(-1).values.to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    flat = ops.flash_decode(*args, **kw)
    torch.testing.assert_close(flat.float(),
                               ops.flash_decode_plain(*args, **kw).float(), **TOL)
    trunk_out = ops.flash_decode_trunk(*args, trunk_len=trunk, **kw)
    assert torch.equal(trunk_out, flat)


@pytest.mark.parametrize("H,K,hd,alibi", [(8, 8, 128, False), (8, 2, 128, False),
                                          (71, 1, 64, False), (8, 8, 64, True)])
def test_flash_decode_mq_kernels_match_plain(gen, H, K, hd, alibi):
    B, S, T, trunk = 4, 4, 300, 200
    q = _rnd(gen, B, S, H, hd)
    k, v = _rnd(gen, K, T, B, hd), _rnd(gen, K, T, B, hd)
    k[:, :trunk] = k[:, :trunk, :1]
    v[:, :trunk] = v[:, :trunk, :1]
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    mask[1, 220:260] = 0
    mask[:, T - 2:] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    top = kpos.max(-1).values
    qpos = (top[:, None] - (S - 1)
            + torch.arange(S, device="cuda")[None]).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    mq = ops.flash_decode_mq(q, k, v, qpos, mask, **kw)
    ref = ops.flash_decode_mq_plain(q, k, v, qpos, mask, **kw)
    torch.testing.assert_close(mq.float(), ref.float(), **TOL)
    for j in range(S):
        one = ops.flash_decode(q[:, j].contiguous(), k, v,
                               qpos[:, j].contiguous(), mask, **kw)
        assert torch.equal(mq[:, j], one)
    trunk_out = ops.flash_decode_mq_trunk(q, k, v, qpos, mask,
                                          trunk_len=trunk, **kw)
    assert torch.equal(trunk_out, mq)


@pytest.mark.parametrize("H,K,hd,alibi", [(8, 8, 128, False), (8, 2, 128, False),
                                          (71, 1, 64, False), (8, 8, 64, True)])
def test_cascade_kernel_matches_plain(gen, H, K, hd, alibi):
    B, R, Tt = 3, 40, 100
    q = _rnd(gen, B, R, H, hd)
    sk, sv = _rnd(gen, B, R, K, hd), _rnd(gen, B, R, K, hd)
    tk, tv = _rnd(gen, K, Tt, hd), _rnd(gen, K, Tt, hd)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    mask[1, 30:] = 0
    mask[2, :] = 0
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    args = (q, sk, sv, tk, tv, mask, qpos)
    got = ops.cascade_attention(*args, alibi_slopes=slopes)
    ref = ops.cascade_attention_plain(*args, alibi_slopes=slopes)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


def test_wrapper_counts_launches(gen):
    ops.reset_launches()
    q = _rnd(gen, 2, 4, 64)
    k = _rnd(gen, 4, 70, 2, 64)
    mask = torch.ones((2, 70), dtype=torch.int32, device="cuda")
    qpos = torch.full((2,), 69, dtype=torch.int32, device="cuda")
    ops.flash_decode(q, k, k, qpos, mask)
    assert ops.launch_counts()["flash_decode"] == 1
    ops.flash_decode_mq(q[:, None], k, k, qpos[:, None], mask)
    ops.flash_decode_mq_trunk(q[:, None], k, k, qpos[:, None], mask,
                              trunk_len=64)
    counts = ops.launch_counts()
    assert (counts["flash_decode"], counts["flash_decode_mq"],
            counts["flash_decode_mq_trunk"]) == (1, 1, 1)
