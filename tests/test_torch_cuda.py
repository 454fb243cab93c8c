"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA card (decided inside
the test, never at import), but for the pure-Python check that the
int8-KV cases reach every launch plan. Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). bf16 kernel output against the float32 plain
version of the same bf16 inputs, atol = rtol = 1e-2 (bf16 output
rounding); the trunk kernels bitwise the flat ones, and query j of the
multi-query kernel bitwise the single-query kernel at its position, at
the decode kernels' block edges too. The
trunk-leg kernels' float32 partials against their plain versions'
within 1e-3 (sums of ~100 terms in another order); with int8 QK^T the
row max bitwise (the scores are). The cascade cases cover the tile
edges of the bf16 tensor-core kernels (R * G not a multiple of 16, a
ragged last key tile, every head dim they are built for, a batch row
whose window is fully masked, ALiBi) and one float32 case each, which
takes the CUDA-core kernels; the prefill flash cases cover every head
dim of its bf16 tensor-core kernels, S up to 512, GQA, MQA and ALiBi,
and the route each head dim takes (the wgmma kernel at hd 64 and 128,
across the 64-row tile edges: S = 1, 63, 64, 65, 128, 200, 512). The
row kernels' rows are bitwise at every row count; ``row_add_norm``'s
sum is bitwise torch's bf16 add and its norm bitwise ``row_norm`` of it.
The persistent suffix merge is held at R = 80, under 64 and a multiple
of 64, MHA / GQA / MQA, ALiBi, ragged, holed, left-padded and fully
masked windows and every head dim, and the trunk keys' quantization pass
bitwise ``dynamic_quant`` at every layer's keys of a llama-2-7b dispatch.
A tiny fp16 HF checkpoint (``chip_smoke.export_hf_llama``) loads to the
card bitwise as it loads to the CPU, in bf16, in float32 and quantized.
The streaming-statistics fold is bitwise its plain twin (guard on and
off, strided readouts, refolds), and the sink on the card holds the CPU
sink's lattice bitwise, its finalize's CIs within 1e-6 of the CPU's.
The sampler (``gumbel_argmax``) gives its plain twin's ids in both key
modes, at vocabularies that are and are not a multiple of its unit, at
B = 1 to 64 (every cluster size its plan takes there, 1 to 16 blocks),
with a NaN logit, a row of NaNs and tied scores (the lowest index, also
across a cluster's blocks), on row views whose stride is not a multiple
of 4, launch after launch and on a second stream; the C library's
constants are the planner's. The int8-KV attention kernel (``kv_int8_attention``) holds its
twin's s32 scores bitwise and its output within ``tie_bar`` (one int8
level of the probabilities at each key near a rounding tie), at S = 1,
a verify window and 16 queries, MHA / GQA / MQA, ALiBi, every head dim
it is built for, float32 and bf16 queries, a row with every key masked,
a cache view cut short of its extent, and an extent whose scores take
fewer rows a block; its cases hit every cluster size the launch plan
can choose (1 to 8 blocks), blocks of 8 to 64 rows on IMMA (head dims
32, 80, 96, 128) and rows past 64 in two chunks. A row
attended alone and inside a batch of verify windows gives the same
bits, and the C library's shared-memory layout is the planner's.
"""

import dataclasses

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


def _rnd(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# (H, K, hd, alibi, R, Tt, dtype) of the cascade kernels' cases: the
# llama-2-7b main-path shape (R = 80, Tt = 432), R = 81 and a last key
# tile of 1 or 0 extra keys (Tt = 65, 64), falcon-7b's G = 71 with R = 3
# (R * G = 213), head dims 32, 80 and 96 beside 64 and 128, and float32.
BF16, F32 = torch.bfloat16, torch.float32
CASCADE_CASES = [
    (8, 8, 128, False, None, None, BF16), (8, 2, 128, False, None, None, BF16),
    (71, 1, 64, False, None, None, BF16), (8, 8, 64, True, None, None, BF16),
    (32, 32, 128, False, 80, 432, BF16), (8, 8, 128, False, 81, 64, BF16),
    (8, 2, 128, True, 80, 65, BF16), (71, 1, 64, False, 3, 432, BF16),
    (8, 8, 32, False, 80, 65, BF16), (8, 8, 80, True, 81, 100, BF16),
    (8, 8, 96, False, None, 432, BF16), (8, 2, 64, True, None, None, F32),
]


def _case_id(case):
    H, K, hd, alibi, R, Tt, dtype = case
    return (f"H{H}K{K}hd{hd}{'-alibi' if alibi else ''}-R{R or 'd'}-Tt{Tt or 'd'}"
            f"{'-f32' if dtype == F32 else ''}")


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


# (B, S, H, K, hd, T, trunk_len, alibi, dtype) at the edges of the decode
# kernels' blocking: batch rows that the trunk leg's row blocks do not
# divide (B * S * G rows in blocks of at most 32, spread evenly), a trunk
# that ends inside a split, no trunk, a ragged last split (T % 64 of 44,
# 1 and 8), falcon-7b's G = 71 (284 rows of a batch row, nine blocks),
# ALiBi, and float32 tiles.
DECODE_EDGE_CASES = [
    (9, 4, 8, 2, 128, 300, 200, False, BF16), (5, 4, 8, 8, 128, 257, 0, False, BF16),
    (3, 4, 71, 1, 64, 300, 130, False, BF16), (33, 4, 32, 32, 128, 576, 432, False, BF16),
    (7, 2, 8, 8, 64, 200, 191, True, BF16), (4, 3, 8, 2, 32, 150, 100, False, F32),
]


@pytest.mark.parametrize("B,S,H,K,hd,T,trunk,alibi,dtype", DECODE_EDGE_CASES,
                         ids=[f"B{c[0]}S{c[1]}H{c[2]}K{c[3]}hd{c[4]}T{c[5]}t{c[6]}"
                              f"{'-alibi' if c[7] else ''}{'-f32' if c[8] == F32 else ''}"
                              for c in DECODE_EDGE_CASES])
def test_flash_decode_mq_trunk_bitwise_at_block_edges(gen, B, S, H, K, hd, T, trunk,
                                                      alibi, dtype):
    """The multi-query kernels against their plain versions, mq_trunk
    bitwise mq, query j of mq bitwise the single-query kernel, and the
    single-query trunk kernel bitwise the flat one."""
    q = _rnd(gen, B, S, H, hd, dtype=dtype)
    k, v = _rnd(gen, K, T, B, hd, dtype=dtype), _rnd(gen, K, T, B, hd, dtype=dtype)
    k[:, :trunk] = k[:, :trunk, :1]
    v[:, :trunk] = v[:, :trunk, :1]
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(B):
        lo = max(trunk, T // 2) + (b * 7) % max(T // 4, 1)
        mask[b, lo:lo + 3 + b % 5] = 0
    mask[:, T - 2:] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = (kpos.max(-1).values[:, None] - (S - 1)
            + torch.arange(S, device="cuda")[None]).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    mq = ops.flash_decode_mq(q, k, v, qpos, mask, **kw)
    ref = ops.flash_decode_mq_plain(q, k, v, qpos, mask, **kw)
    torch.testing.assert_close(mq.float(), ref.float(), **TOL)
    assert torch.equal(ops.flash_decode_mq_trunk(q, k, v, qpos, mask, trunk_len=trunk,
                                                 **kw), mq)
    for j in range(S):
        qj, pj = q[:, j].contiguous(), qpos[:, j].contiguous()
        one = ops.flash_decode(qj, k, v, pj, mask, **kw)
        assert torch.equal(mq[:, j], one)
        assert torch.equal(ops.flash_decode_trunk(qj, k, v, pj, mask, trunk_len=trunk,
                                                  **kw), one)


def test_flash_decode_refuses_head_dim_off_the_tile_rows(gen):
    """The decode kernels copy 16-byte tile rows: a head dim that is not a
    multiple of 8 raises before any launch."""
    q = _rnd(gen, 2, 4, 12)
    k = _rnd(gen, 4, 70, 2, 12)
    mask = torch.ones((2, 70), dtype=torch.int32, device="cuda")
    qpos = torch.full((2,), 69, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_decode(q, k, k, qpos, mask)


@pytest.mark.parametrize("H,K,hd,alibi,R,Tt,dtype", CASCADE_CASES,
                         ids=[_case_id(c) for c in CASCADE_CASES])
def test_cascade_kernel_matches_plain(gen, H, K, hd, alibi, R, Tt, dtype):
    B, R, Tt = 3, R or 40, Tt or 100
    q = _rnd(gen, B, R, H, hd, dtype=dtype)
    sk, sv = _rnd(gen, B, R, K, hd, dtype=dtype), _rnd(gen, B, R, K, hd, dtype=dtype)
    tk, tv = _rnd(gen, K, Tt, hd, dtype=dtype), _rnd(gen, K, Tt, hd, dtype=dtype)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    mask[1, (3 * R) // 4:] = 0
    mask[2, :] = 0                       # a fully masked window
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    args = (q, sk, sv, tk, tv, mask, qpos)
    got = ops.cascade_attention(*args, alibi_slopes=slopes)
    ref = ops.cascade_attention_plain(*args, alibi_slopes=slopes)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


def test_bf16_cascade_kernels_refuse_untiled_head_dim(gen):
    """bf16 on the card runs only on the tensor-core tiles: a head dim
    they are not built for raises, and never reaches the CUDA-core code."""
    q = _rnd(gen, 1, 4, 2, 48)
    k = _rnd(gen, 1, 4, 2, 48)
    tk = _rnd(gen, 2, 70, 48)
    mask = torch.ones((1, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        ops.cascade_attention(q, k, k, tk, tk, mask, mask)
    with pytest.raises(ValueError, match="head dims"):
        ops.cascade_prefix(q, tk, tk)


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


@pytest.mark.parametrize("H,K,hd,alibi,R,Tt,dtype", CASCADE_CASES,
                         ids=[_case_id(c) for c in CASCADE_CASES])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_cascade_prefix_kernels_match_plain(gen, H, K, hd, alibi, R, Tt, dtype,
                                            int8_qk):
    """The trunk-leg kernels (a ragged last tile of flattened queries and
    of trunk keys) against their plain versions, and the two-leg route
    through them against its plain two-leg function."""
    B, R, Tt = 3, R or 21, Tt or 100
    q = _rnd(gen, B, R, H, hd, dtype=dtype)
    sk, sv = _rnd(gen, B, R, K, hd, dtype=dtype), _rnd(gen, B, R, K, hd, dtype=dtype)
    tk, tv = _rnd(gen, K, Tt, hd, dtype=dtype), _rnd(gen, K, Tt, hd, dtype=dtype)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kernel = ops.cascade_prefix_int8 if int8_qk else ops.cascade_prefix
    plain = ops.prefix_partials_int8 if int8_qk else ops.prefix_partials
    got = kernel(q, tk, tv, slopes)
    ref = plain(q, tk, tv, slopes)
    if int8_qk:
        # Bitwise payloads and exact s32 dots, folded in the same order:
        # the scores, and so their row max, are the plain version's.
        assert torch.equal(got[1], ref[1])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    mask[1, (3 * R) // 4:] = 0
    mask[2, :] = 0                       # a fully masked window
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    out = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos,
                                alibi_slopes=slopes, int8_qk=int8_qk,
                                fused_suffix=False)
    ref_out = ops.cascade_attention(q.cpu(), sk.cpu(), sv.cpu(), tk.cpu(),
                                    tv.cpu(), mask.cpu(), qpos.cpu(),
                                    alibi_slopes=None if slopes is None
                                    else slopes.cpu(), int8_qk=int8_qk,
                                    fused_suffix=False)
    torch.testing.assert_close(out.float().cpu(), ref_out.float(), **TOL)


# (H, K, hd, alibi, dtype) of the prefill flash kernel's cases: MHA, GQA,
# falcon-7b's MQA (71 / 1), ALiBi, every head dim of the bf16 tensor-core
# kernel, and float32 (the CUDA-core kernel).
FLASH_CASES = [
    (8, 8, 128, False, BF16), (8, 2, 128, False, BF16), (71, 1, 64, False, BF16),
    (8, 8, 64, True, BF16), (8, 8, 32, False, BF16), (8, 2, 80, True, BF16),
    (8, 8, 96, False, BF16), (8, 2, 64, True, F32),
]


@pytest.mark.parametrize("S", [48, 128, 256, 512])
@pytest.mark.parametrize("H,K,hd,alibi,dtype", FLASH_CASES,
                         ids=[f"H{c[0]}K{c[1]}hd{c[2]}{'-alibi' if c[3] else ''}"
                              f"{'-f32' if c[4] == F32 else ''}" for c in FLASH_CASES])
def test_flash_attention_kernel_matches_plain(gen, H, K, hd, alibi, dtype, S):
    B = 3
    q = _rnd(gen, B, S, H, hd, dtype=dtype)
    k, v = _rnd(gen, B, S, K, hd, dtype=dtype), _rnd(gen, B, S, K, hd, dtype=dtype)
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    mask[0, :S // 3] = 0                      # left pad
    mask[1, 5:9] = 0                          # a hole
    mask[2, :] = 0                            # no valid key: zeros
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(key_mask=mask, alibi_slopes=slopes,
              key_positions=kpos if alibi else None)
    got = ops.flash_attention(q, k, v, **kw)
    ref = ops.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    assert bool((got[2] == 0).all())


# The persistent TMA + wgmma route (bf16, hd 64 and 128): MHA, GQA and
# falcon-7b's MQA head counts, S across the 64-row item and key tile edges.
WGMMA_HEADS = [(32, 32), (32, 8), (71, 1)]
WGMMA_S = [1, 63, 64, 65, 128, 200, 512]


def _flash_mask(S, B=4):
    """Left pad, right pad, holes, and a batch row with no valid key."""
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    mask[0, :S // 3] = 0
    mask[1, (2 * S) // 3 + 1:] = 0
    mask[2, 3::7] = 0
    mask[2, S // 2:S // 2 + 9] = 0
    mask[3, :] = 0
    return mask


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("S", WGMMA_S)
@pytest.mark.parametrize("H,K", WGMMA_HEADS, ids=[f"H{h}K{k}" for h, k in WGMMA_HEADS])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_wgmma_kernel_matches_plain(gen, hd, H, K, S, alibi):
    """The wgmma route against the plain version within the bf16 bar, a
    row with no valid key giving 0; the launch is counted on that route."""
    mask = _flash_mask(S)
    B = mask.shape[0]
    q = _rnd(gen, B, S, H, hd)
    k, v = _rnd(gen, B, S, K, hd), _rnd(gen, B, S, K, hd)
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(key_mask=mask, alibi_slopes=slopes,
              key_positions=kpos if alibi else None)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.route_launches == {"fp32": 0, "mma": 0, "wgmma": 1}
    ref = ops.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    assert bool((got[3] == 0).all())


def test_flash_attention_routes_by_head_dim(gen):
    """bf16 at hd 64 and 128 takes the wgmma kernel, at hd 96 the mma.sync
    one, float32 the CUDA-core one: each launch counted on its route, the
    route as the C library states it, none at a head dim not built."""
    from lir_tpu_torch.ops.flash_attention import route
    ops.reset_launches()
    for hd, dtype in ((64, BF16), (128, BF16), (96, BF16), (64, F32)):
        q = _rnd(gen, 2, 70, 4, hd, dtype=dtype)
        k = _rnd(gen, 2, 70, 2, hd, dtype=dtype)
        ops.flash_attention(q, k, k)
    assert ops.flash_attention.route_launches == {"fp32": 1, "mma": 1, "wgmma": 2}
    assert ops.launch_counts()["flash_attention"] == 4
    assert [route(BF16, hd) for hd in (32, 64, 80, 96, 128)] == [
        "mma", "wgmma", "mma", "mma", "wgmma"]
    with pytest.raises(ValueError):
        route(BF16, 48)


def test_new_wrappers_count_launches(gen):
    ops.reset_launches()
    q = _rnd(gen, 2, 8, 4, 64)
    tk = _rnd(gen, 4, 70, 64)
    ops.cascade_prefix(q, tk, tk)
    ops.cascade_prefix_int8(q, tk, tk)
    k = _rnd(gen, 2, 8, 2, 64)
    ops.flash_attention(q, k, k)
    counts = ops.launch_counts()
    assert (counts["cascade_prefix"], counts["cascade_prefix_int8"],
            counts["flash_attention"]) == (1, 1, 1)


def test_quantization_on_card_is_bitwise_the_cpu_rule(gen):
    """dynamic_quant and quantize on the card: payloads and scales
    bitwise the CPU's (which the CPU tests hold bitwise to the JAX
    package's): IEEE division, round half to even."""
    from lir_tpu_torch.models import quant

    x = torch.randn((64, 4096), generator=gen, device="cuda") * 3
    q_card, s_card = quant.dynamic_quant(x)
    q_cpu, s_cpu = quant.dynamic_quant(x.cpu())
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(q_card.cpu(), q_cpu)
    w = quant.quantize(x)
    w_cpu = quant.quantize(x.cpu())
    assert torch.equal(w.scale.cpu(), w_cpu.scale)
    assert torch.equal(w.q.cpu(), w_cpu.q)


@pytest.mark.parametrize("rows", [3, 16, 17, 40])
def test_int8_matmul_on_card_matches_cpu(gen, rows):
    """The dynamic route on the card (torch._int_mm, rows padded past 16)
    against the CPU's int32 product: the s32 products exact, so the
    float32 outputs bitwise."""
    from lir_tpu_torch.models import quant

    x = torch.randn((rows, 256), generator=gen, device="cuda")
    w = torch.randn((256, 96), generator=gen, device="cuda") * 0.02
    wq = dataclasses.replace(quant.quantize(w), dynamic=True)
    got = quant.matmul(x, wq)
    ref = quant.matmul(x.cpu(), dataclasses.replace(
        quant.quantize(w.cpu()), dynamic=True))
    assert torch.equal(got.cpu(), ref)
    with pytest.raises(ValueError, match="multiples"):
        quant.int8_dot(torch.zeros((20, 12), dtype=torch.int8, device="cuda"),
                       torch.zeros((12, 8), dtype=torch.int8, device="cuda"))


# (K, N) of the row-invariant GEMM's cases: every llama-2-7b projection
# (wq / wk / wv / wo, w_up / w_gate, w_down; split-K on), mistral-7b's
# GQA wk / wv (N = 1024, 8 splits), a K with a ragged last chunk, a width
# that is not a multiple of the 128-column item, falcon's single kv head.
ROW_GEMM_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (200, 96),
                   (4544, 64), (4096, 1024)]
# Row counts around the kernel's 32-row products and 128-row blocks.
ROW_COUNTS = (1, 2, 3, 7, 16, 31, 32, 33, 64, 100, 127, 128, 129, 200, 255)


@pytest.mark.parametrize("K,N", ROW_GEMM_SHAPES,
                         ids=[f"K{k}N{n}" for k, n in ROW_GEMM_SHAPES])
def test_row_gemm_rows_bitwise_at_every_row_count(gen, K, N):
    """A row's output of row_gemm is the same bits at every M from 1 to
    256 (across the 32-row products and the 128-row blocks) and in any
    place among the rows (rows permuted), and within bf16 rounding of
    torch.matmul."""
    x = _rnd(gen, 256, K)
    w = _rnd(gen, K, N) * 0.05
    full = ops.row_gemm(x, w)
    torch.testing.assert_close(full.float(), (x.float() @ w.float()),
                               atol=2e-2, rtol=2e-2)
    perm = torch.randperm(256, generator=gen, device="cuda")
    assert torch.equal(ops.row_gemm(x[perm], w), full[perm])
    for m in ROW_COUNTS:
        assert torch.equal(ops.row_gemm(x[:m], w), full[:m]), m
        assert torch.equal(ops.row_gemm(x[perm[:m]], w), full[perm[:m]]), m


def test_row_gemm_split_reduction_back_to_back_and_on_two_streams(gen):
    """The in-launch split reduction: launches of different shapes (2, 3,
    8 and 1 splits) back to back on one stream, and the same launches on
    two streams at once, each give the bits of the launch alone (each
    launch adds its splits in its own blocks' shared memory, so nothing
    carries over between launches or streams)."""
    shapes = [(4096, 11008), (11008, 4096), (4096, 1024), (64, 64), (4096, 4096)]
    cases = [(_rnd(gen, m, k), _rnd(gen, k, n) * 0.05)
             for m, (k, n) in zip((32, 128, 7, 200, 129), shapes)]
    alone = [ops.row_gemm(x, w) for x, w in cases]
    torch.cuda.synchronize()
    for _ in range(3):
        again = [ops.row_gemm(x, w) for x, w in cases]
        for a, b in zip(again, alone):
            assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    main_out, side_out = [], []
    for _ in range(3):
        for x, w in cases:
            main_out.append(ops.row_gemm(x, w))
            with torch.cuda.stream(side):
                side_out.append(ops.row_gemm(x, w))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(main_out, side_out)):
        assert torch.equal(a, alone[i % len(cases)]) and torch.equal(b, a), i


@pytest.mark.parametrize("layer", [False, True])
def test_row_norm_rows_bitwise_and_close(gen, layer):
    """row_norm's rows are the same bits at any row count and within bf16
    rounding of the decoder's plain norm."""
    x = _rnd(gen, 128, 4096) * 3
    scale = _rnd(gen, 4096)
    bias = _rnd(gen, 4096) if layer else None
    full = ops.row_norm(x, scale, bias, 1e-5)
    ref = ops.row_norm_plain(x, scale, bias, 1e-5)
    torch.testing.assert_close(full.float(), ref.float(), **TOL)
    for m in (1, 32, 100):
        assert torch.equal(ops.row_norm(x[-m:], scale, bias, 1e-5), full[-m:])


NORM_WIDTHS = (4096, 4544, 5120)


@pytest.mark.parametrize("layer", [False, True])
@pytest.mark.parametrize("D", NORM_WIDTHS)
def test_row_add_norm_bitwise_add_then_norm(gen, D, layer):
    """row_add_norm's s is bitwise torch's bf16 x + d and its h bitwise
    row_norm(s), within bf16 rounding of the plain version; each row's s
    and h are the same bits at 15 row counts from 1 to 255 and in any
    place among the rows (rows permuted). llama's width, falcon-7b's and
    h2ogpt's, RMSNorm and LayerNorm."""
    x = _rnd(gen, 255, D) * 3
    d = _rnd(gen, 255, D)
    scale = _rnd(gen, D)
    bias = _rnd(gen, D) if layer else None
    s, h = ops.row_add_norm(x, d, scale, bias, 1e-5)
    assert torch.equal(s, x + d)
    assert torch.equal(h, ops.row_norm(s, scale, bias, 1e-5))
    _, ref = ops.row_add_norm_plain(x, d, scale, bias, 1e-5)
    torch.testing.assert_close(h.float(), ref.float(), **TOL)
    perm = torch.randperm(255, generator=gen, device="cuda")
    ps, ph = ops.row_add_norm(x[perm], d[perm], scale, bias, 1e-5)
    assert torch.equal(ps, s[perm]) and torch.equal(ph, h[perm])
    for m in ROW_COUNTS:
        ms, mh = ops.row_add_norm(x[perm[:m]], d[perm[:m]], scale, bias, 1e-5)
        assert torch.equal(ms, s[perm[:m]]) and torch.equal(mh, h[perm[:m]]), m


def test_row_add_norm_counts_launches_and_refuses(gen):
    ops.reset_launches()
    x = _rnd(gen, 4, 64)
    ops.row_add_norm(x, x, _rnd(gen, 64), None, 1e-5)
    assert ops.launch_counts()["row_add_norm"] == 1
    with pytest.raises(ValueError, match="row_add_norm of"):
        ops.row_add_norm(x, x[:2], _rnd(gen, 64), None, 1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.row_add_norm(x, x.float(), _rnd(gen, 64), None, 1e-5)
    assert ops.launch_counts()["row_add_norm"] == 1


def test_row_kernels_count_launches_and_refuse(gen):
    ops.reset_launches()
    x = _rnd(gen, 4, 64)
    ops.row_gemm(x, _rnd(gen, 64, 16))
    ops.row_norm(x, _rnd(gen, 64), None, 1e-5)
    counts = ops.launch_counts()
    assert (counts["row_gemm"], counts["row_norm"]) == (1, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.row_gemm(x.float(), _rnd(gen, 64, 16).float())
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.row_gemm(_rnd(gen, 4, 12), _rnd(gen, 12, 16))


def test_decode_kernels_bitwise_across_cache_extents(gen):
    """The invariants the compacted speculative slots rest on: the same
    valid keys at the same slots give the same bits whatever the cache's
    extent (trailing splits with no valid key, their slots holding
    other data) and with a split of no valid key ahead of live ones, on
    the flat, trunk, multi-query and multi-query trunk kernels; and a
    verify window's query j (later window slots valid but after it) is
    bitwise the single-query step over a cache where they are masked."""
    B, H, K, hd, S, trunk = 4, 8, 2, 128, 4, 128
    T1, T2 = 300, 520
    k = _rnd(gen, K, T2, B, hd)
    v = _rnd(gen, K, T2, B, hd)
    k[:, :trunk] = k[:, :trunk, :1]
    v[:, :trunk] = v[:, :trunk, :1]
    mask = torch.zeros((B, T2), dtype=torch.int32, device="cuda")
    mask[:, :T1 - S] = 1
    mask[:, 130:200] = 0                  # split 2 (128..191) fully masked
    base = T1 - S
    q = _rnd(gen, B, S, H, hd)
    for trunk_len in (0, trunk):
        win = mask.clone()
        win[:, base:base + S] = 1
        kpos = torch.clamp_min(torch.cumsum(win, -1, dtype=torch.int32) - 1, 0)
        qpos = kpos[:, base:base + S].contiguous()
        mq = (ops.flash_decode_mq_trunk if trunk_len else ops.flash_decode_mq)
        one = ops.flash_decode_trunk if trunk_len else ops.flash_decode
        kw = dict(trunk_len=trunk_len) if trunk_len else {}
        got_long = mq(q, k, v, qpos, win, key_positions=kpos, **kw)
        short = (k[:, :T1].contiguous(), v[:, :T1].contiguous())
        got_short = mq(q, *short, qpos, win[:, :T1].contiguous(),
                       key_positions=kpos[:, :T1].contiguous(), **kw)
        assert torch.equal(got_long, got_short), trunk_len
        for j in range(S):
            step = mask[:, :T1].clone()
            step[:, base:base + j + 1] = 1
            spos = torch.clamp_min(torch.cumsum(step, -1, dtype=torch.int32) - 1, 0)
            ref = one(q[:, j].contiguous(), *short, qpos[:, j].contiguous(), step,
                      key_positions=spos, **kw)
            assert torch.equal(got_long[:, j], ref), (trunk_len, j)


@pytest.mark.parametrize("H,K,hd,alibi,R,Tt,dtype", CASCADE_CASES,
                         ids=[_case_id(c) for c in CASCADE_CASES])
def test_fused_cascade_bitwise_two_leg(gen, H, K, hd, alibi, R, Tt, dtype):
    """The fused kernel is bitwise cascade_prefix + cascade_suffix_merge
    (the JAX package's fused == two-leg invariant), and the two-leg
    route through cascade_attention is that pair."""
    B, R, Tt = 3, R or 40, Tt or 100
    q = _rnd(gen, B, R, H, hd, dtype=dtype)
    sk, sv = _rnd(gen, B, R, K, hd, dtype=dtype), _rnd(gen, B, R, K, hd, dtype=dtype)
    tk, tv = _rnd(gen, K, Tt, hd, dtype=dtype), _rnd(gen, K, Tt, hd, dtype=dtype)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    mask[1, (3 * R) // 4:] = 0
    mask[2, :] = 0                       # a fully masked window
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    fused = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos, alibi_slopes=slopes)
    o, m, l = ops.cascade_prefix(q, tk, tv, slopes)
    pair = ops.cascade_suffix_merge(q, sk, sv, o, m, l, mask, qpos, slopes)
    assert torch.equal(fused, pair)
    two_leg = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos,
                                    alibi_slopes=slopes, fused_suffix=False)
    assert torch.equal(two_leg, fused)
    ref = ops.suffix_merge_plain(q, sk, sv, o, m, l, mask, qpos, slopes)
    torch.testing.assert_close(pair.float(), ref.float(), **TOL)


@pytest.mark.parametrize("hd,Tt", [(32, 100), (64, 65), (80, 100), (96, 432),
                                   (128, 432), (128, 1)])
def test_cascade_prefix_int8_imma_matches_plain(gen, hd, Tt):
    """The bf16 int8 trunk leg (key quantization pass + IMMA QK^T +
    split-P PV): the row max bitwise the plain twin's, the partials
    within 1e-3; the quantization pass bitwise dynamic_quant."""
    from lir_tpu_torch.models import quant

    B, R, H, K = 3, 21, 8, 2
    q = _rnd(gen, B, R, H, hd) * 3
    tk, tv = _rnd(gen, K, Tt, hd) * 2, _rnd(gen, K, Tt, hd)
    slopes = alibi_slopes(H, "cuda") if hd == 80 else None
    kq, ks = ops.quantize_rows(tk)
    rq, rs = quant.dynamic_quant(tk)
    assert torch.equal(kq, rq) and torch.equal(ks, rs)
    got = ops.cascade_prefix_int8(q, tk, tv, slopes)
    ref = ops.prefix_partials_int8(q, tk, tv, slopes)
    assert torch.equal(got[1], ref[1])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3)


# (hd, Tt, alibi) of the wgmma trunk leg's tile edges: trunk lengths
# around its 64-key tiles and 4-stage ring (1, 63, 65, 257, 433), every
# head dim it is built for, ALiBi.
PREFIX_EDGE_CASES = [(128, 1, False), (128, 63, True), (128, 257, False),
                     (96, 65, False), (80, 433, True), (64, 129, True),
                     (32, 300, False)]


@pytest.mark.parametrize("hd,Tt,alibi", PREFIX_EDGE_CASES,
                         ids=[f"hd{h}-Tt{t}{'-alibi' if a else ''}"
                              for h, t, a in PREFIX_EDGE_CASES])
def test_cascade_prefix_wgmma_tile_edges(gen, hd, Tt, alibi):
    """The bf16 trunk leg on wgmma at its tile edges: Tt not a multiple of
    the 64-key tile, N = B * R * G = 252 flattened queries (not a multiple
    of the block's 128 rows), G = 4: the partials within 1e-3 of the plain
    version, and the fused kernel bitwise the trunk leg + suffix merge."""
    B, R, H, K = 3, 21, 8, 2
    q = _rnd(gen, B, R, H, hd)
    sk, sv = _rnd(gen, B, R, K, hd), _rnd(gen, B, R, K, hd)
    tk, tv = _rnd(gen, K, Tt, hd), _rnd(gen, K, Tt, hd)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    got = ops.cascade_prefix(q, tk, tv, slopes)
    ref = ops.prefix_partials(q, tk, tv, slopes)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    mask[1, 15:] = 0
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    fused = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos, alibi_slopes=slopes)
    pair = ops.cascade_suffix_merge(q, sk, sv, *got, mask, qpos, slopes)
    assert torch.equal(fused, pair)


def test_cascade_new_launches_count(gen):
    ops.reset_launches()
    q = _rnd(gen, 2, 8, 4, 64)
    tk = _rnd(gen, 4, 70, 64)
    sk = _rnd(gen, 2, 8, 4, 64)
    mask = torch.ones((2, 8), dtype=torch.int32, device="cuda")
    qpos = 70 + torch.arange(8, device="cuda", dtype=torch.int32)[None].expand(2, -1)
    ops.cascade_attention(q, sk, sk, tk, tk, mask, qpos, int8_qk=True)
    counts = ops.launch_counts()
    assert (counts["quantize_rows"], counts["cascade_prefix_int8"],
            counts["cascade_suffix_merge"], counts["cascade_attention"]) == (1, 1, 1, 0)


# (H, K, hd, alibi, R, B) of the suffix merge's cases: the cascade
# dispatch's R = 80, R under 64 (a 64-row item over several batch rows)
# and R a multiple of 64; B * R * G a multiple of 64 or not; MHA, GQA
# (mistral-7b's 32 / 8), MQA (falcon-7b's 71 / 1); ALiBi; every head dim
# the kernel is built for.
SUFFIX_CASES = [
    (32, 32, 128, False, 80, 5), (32, 8, 128, False, 80, 5), (71, 1, 64, False, 80, 5),
    (32, 32, 128, True, 80, 5), (8, 8, 128, False, 21, 5), (8, 4, 128, False, 7, 11),
    (8, 2, 64, True, 128, 5), (8, 8, 64, False, 64, 4), (8, 8, 32, False, 80, 5),
    (8, 8, 80, True, 33, 5), (8, 2, 96, False, 100, 5),
]


def _windows(B, R):
    """Right-padded window masks with a whole row, a holed row, a fully
    masked row and a left-padded row among them, and their positions
    after a 100-slot trunk."""
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    for b in range(B):
        kind = b % 5
        if kind == 1:
            mask[b, (3 * R) // 4:] = 0          # ragged (right-padded)
        elif kind == 2:
            mask[b, R // 3:(2 * R) // 3] = 0    # holed
        elif kind == 3:
            mask[b] = 0                         # all masked
        elif kind == 4:
            mask[b, :R // 2] = 0                # left-padded
    qpos = (100 + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                  0)).to(torch.int32)
    return mask, qpos


@pytest.mark.parametrize("H,K,hd,alibi,R,B", SUFFIX_CASES,
                         ids=[f"H{h}K{k}hd{d}{'-alibi' if a else ''}-R{r}-B{b}"
                              for h, k, d, a, r, b in SUFFIX_CASES])
def test_suffix_merge_kernel_matches_plain_and_fused(gen, H, K, hd, alibi, R, B):
    """The persistent suffix merge within 1e-2 of suffix_merge_plain, and
    bitwise the fused kernel (which walks the same window tiles with the
    same arithmetic on mma.sync): fused == cascade_prefix + suffix merge."""
    q = _rnd(gen, B, R, H, hd)
    sk, sv = _rnd(gen, B, R, K, hd), _rnd(gen, B, R, K, hd)
    tk, tv = _rnd(gen, K, 100, hd), _rnd(gen, K, 100, hd)
    mask, qpos = _windows(B, R)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    o, m, l = ops.cascade_prefix(q, tk, tv, slopes)
    got = ops.cascade_suffix_merge(q, sk, sv, o, m, l, mask, qpos, slopes)
    ref = ops.suffix_merge_plain(q, sk, sv, o, m, l, mask, qpos, slopes)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    fused = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos, alibi_slopes=slopes)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("rows,dtype", [(442368, BF16), (13831, BF16), (1000, F32), (33, F32)],
                         ids=["all-layers", "rows-13831", "f32-rows-1000", "f32-rows-33"])
def test_quantize_rows_all_layers_bitwise_dynamic_quant(gen, rows, dtype):
    """The trunk keys' quantization pass at the all-layers shape of a
    llama-2-7b dispatch (32 layers x 32 kv heads x 432 keys) and at row
    counts that are not a multiple of its 32-row chunks, bf16 and float32:
    payloads and scales bitwise dynamic_quant's."""
    from lir_tpu_torch.models import quant

    x = _rnd(gen, rows, 128, dtype=dtype) * 3
    x[1] = 0                                 # a zero row: the 1e-8 floor
    kq, ks = ops.quantize_rows(x)
    rq, rs = quant.dynamic_quant(x)
    assert torch.equal(kq, rq) and torch.equal(ks, rs)


def test_cascade_extend_int8_quantizes_trunk_keys_once(gen):
    """decoder.cascade_extend with int8 QK^T quantizes every layer's trunk
    keys in one launch and runs each layer's trunk leg on its slice:
    quantize_rows 1, the int8 trunk leg and the suffix merge once a layer;
    the cache is the one the per-layer quantization gives, bitwise."""
    from lir_tpu_torch.models import decoder, registry

    cfg = dataclasses.replace(registry.ModelConfig(
        name="cuda-tiny", vocab_size=512, hidden_size=256, n_layers=3, n_heads=4,
        n_kv_heads=2, intermediate_size=512, max_seq_len=256),
        cascade_fused_suffix=False)
    params = decoder.init_params(cfg, seed=3, device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(3, 500, (4, 90), generator=gen, device="cuda")
    trunk = 70
    ones = torch.ones((1, trunk), dtype=torch.int32, device="cuda")
    _, tcache, _ = decoder.prefill(params, cfg, tokens[:1, :trunk], ones, trunk)
    rem_mask = torch.ones((4, 20), dtype=torch.int32, device="cuda")
    rem_mask[1, 15:] = 0
    ops.reset_launches()
    ck, cv = decoder.cascade_extend(params, cfg, tcache, tokens[:, trunk:], rem_mask,
                                    trunk, 120, int8_qk=True)
    counts = ops.launch_counts()
    assert (counts["quantize_rows"], counts["cascade_prefix_int8"],
            counts["cascade_suffix_merge"]) == (1, 3, 3)
    real = ops.cascade_attention

    def per_layer(*a, trunk_k_int8=None, **kw):
        return real(*a, **kw)

    decoder.ops.cascade_attention = per_layer
    try:
        ck1, cv1 = decoder.cascade_extend(params, cfg, tcache, tokens[:, trunk:],
                                          rem_mask, trunk, 120, int8_qk=True)
    finally:
        decoder.ops.cascade_attention = real
    assert torch.equal(ck, ck1) and torch.equal(cv, cv1)


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_checkpoint_loads_to_the_card_as_to_the_cpu(gen, tmp_path, dtype, int8):
    import chip_smoke
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.models import decoder, factory, quant, registry

    cfg = registry.tiny("llama")
    chip_smoke.export_hf_llama(decoder.init_params(cfg, seed=7, device="cpu"),
                               cfg, tmp_path)
    tok = FakeTokenizer(vocab=cfg.vocab_size)
    kw = dict(dtype=dtype, tokenizer=tok, quantize_int8=int8, int8_dynamic=int8)
    card = factory.load_engine(tmp_path, device="cuda", **kw).params
    host = factory.load_engine(tmp_path, device="cpu", **kw).params
    host = dict(chip_smoke.leaves(host))
    for path, leaf in chip_smoke.leaves(card):
        ref = host[path]
        if isinstance(leaf, quant.QuantTensor):
            assert torch.equal(leaf.q.cpu(), ref.q), path
            assert torch.equal(leaf.scale.cpu(), ref.scale), path
        else:
            assert leaf.device.type == "cuda" and leaf.dtype == dtype
            assert torch.equal(leaf.cpu(), ref), path


def _fold_inputs(gen, B, K, P, R):
    """Readouts with every branch of the fold's predicate (NaN, negative,
    over-1 and zero-mass rows, NaN and positive log-probs) and pad rows
    (ridx = R), on the card."""
    yes = torch.rand(B, generator=gen, device="cuda") * 0.7
    no = torch.rand(B, generator=gen, device="cuda") * (1 - yes)
    wc = torch.rand(B, generator=gen, device="cuda") * 100
    lp = -torch.rand((B, K), generator=gen, device="cuda") * 5
    yes[1], no[2], yes[3], wc[4] = float("nan"), -0.01, 1.2, 100.5
    yes[5] = no[5] = 0.0
    lp[6, 3], lp[7, 0] = float("nan"), 0.5
    if K > 32:       # past the first 32 columns: a lane's second read
        lp[8, K - 1] = float("nan")
    cells = torch.randperm(P * R, generator=gen, device="cuda")[:B]
    pidx, ridx = (cells // R).int(), (cells % R).int()
    ridx[-3:] = R
    return yes, no, wc, lp, pidx, ridx


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B,K", [(32, 20), (64, 20), (12, 40)])
def test_stream_fold_kernel_bitwise_plain(gen, guard, strided, B, K):
    """The fold kernel against its plain twin on the card, bitwise, over
    three folds into a (5, 2,000) lattice (the last refolding the first's
    rows: idempotent), B = 32 and 64 (one block of warps, then two) at
    K = 20, and K = 40 (a lane reads two log-probs)."""
    from lir_tpu_torch.engine.stream_stats import new_accum

    P, R = 5, 2000
    kern, plain = new_accum(P, R, "cuda"), new_accum(P, R, "cuda")
    batches = [_fold_inputs(gen, B, K, P, R) for _ in range(2)]
    for rows in batches + batches[:1]:
        yes, no, wc, lp, pidx, ridx = rows
        if strided:
            yes, no, wc = (torch.stack([t, t], 1)[:, 0] for t in (yes, no, wc))
            lp = torch.stack([lp, lp], 1)[:, 0]
        before = ops.stream_fold.launches
        ops.stream_fold(kern, yes, no, wc, lp, pidx, ridx, guard)
        assert ops.stream_fold.launches == before + 1
        ops.stream_fold_plain(plain, yes, no, wc, lp, pidx, ridx, guard)
    torch.cuda.synchronize()
    for name in kern:
        a, b = kern[name], plain[name]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    slots = {(int(p), int(r)) for rows in batches
             for p, r in zip(rows[4][:-3], rows[5][:-3])}
    assert int(kern["filled"].sum()) == len(slots)       # pad rows dropped


def test_stream_fold_refuses_wrong_inputs(gen):
    from lir_tpu_torch.engine.stream_stats import new_accum

    acc = new_accum(2, 8, "cuda")
    yes, no, wc, lp, pidx, ridx = _fold_inputs(gen, 12, 20, 2, 8)
    with pytest.raises(ValueError, match="float32"):
        ops.stream_fold(acc, yes.double(), no, wc, lp, pidx, ridx)
    with pytest.raises(ValueError, match="int32"):
        ops.stream_fold(acc, yes, no, wc, lp, pidx.long(), ridx)
    with pytest.raises(ValueError, match="lattice"):
        ops.stream_fold(dict(acc, rel=acc["rel"].t()), yes, no, wc, lp,
                        pidx, ridx)


def test_streaming_finalize_on_card_matches_cpu(gen):
    """The sink on the card holds the CPU sink's lattice bitwise, and
    summarize draws the same resample indices on either device: CIs
    within 1e-6 (float32 means reduced in another order)."""
    from lir_tpu_torch.engine.stream_stats import StreamSink
    from lir_tpu_torch.stats import streaming

    @dataclasses.dataclass
    class Cell:
        prompt_idx: int
        rephrase_idx: int

    sinks = {d: StreamSink(5, 400, seed=3, device=d) for d in ("cuda", "cpu")}
    for _ in range(20):
        yes, no, wc, lp, pidx, ridx = _fold_inputs(gen, 32, 20, 5, 400)
        cells = [Cell(int(p), int(r)) for p, r in zip(pidx[:-3], ridx[:-3])]
        for d, sink in sinks.items():
            sink.fold(yes.to(d), no.to(d), wc.to(d), lp.to(d), cells)
    card, host = sinks["cuda"].snapshot(), sinks["cpu"].snapshot()
    for name in ("filled", "dec"):
        assert (getattr(card, name) == getattr(host, name)).all()
    for name in ("rel", "conf"):
        assert (getattr(card, name).view("int32")
                == getattr(host, name).view("int32")).all()
    a = streaming.summarize(card, n_boot=1000, device="cuda")
    b = streaming.summarize(host, n_boot=1000, device="cpu")
    assert a["kappa"] == b["kappa"]
    for pa, pb in zip(a["per_prompt"], b["per_prompt"]):
        for field in ("relative_prob", "weighted_confidence"):
            for k in ("ci_lower", "ci_upper", "standard_error"):
                assert abs(pa[field][k] - pb[field][k]) <= 1e-6 * max(
                    1.0, abs(pb[field][k])), (field, k)


@pytest.mark.parametrize("B,V", [(1, 7), (8, 32000), (32, 32000), (3, 50257),
                                 (1, 32000), (64, 32000), (8, 32001), (8, 50),
                                 (40, 32000), (128, 4000)])
@pytest.mark.parametrize("per_row", [False, True], ids=["one_key", "per_row"])
def test_gumbel_argmax_matches_plain(gen, B, V, per_row):
    from lir_tpu_torch.engine.generate import sample_keys
    from lir_tpu_torch.ops.sample import gumbel_argmax_plain

    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    key = torch.randint(0, 2**32, (B, 2), generator=gen, device="cuda",
                        dtype=torch.int64)
    keys, offsets = sample_keys(key if per_row else key[0], B, V, 3, "cuda")
    if V > 7:
        logits[0, V // 2] = float("nan")
    for t in range(3):
        for temp in (0.9, 1e-4):
            got = ops.gumbel_argmax(logits, keys[t], offsets, temp)
            want = gumbel_argmax_plain(logits, keys[t], offsets, temp)
            assert torch.equal(got, want)
    if V > 7:
        assert int(got[0]) == V // 2   # NaN above every number
    # Every score tied: the lowest index wins.
    flat = torch.full((B, V), -float("inf"), device="cuda")
    assert torch.equal(ops.gumbel_argmax(flat, keys[0], offsets, 1.0),
                       gumbel_argmax_plain(flat, keys[0], offsets, 1.0))


def _sample_case(gen, B, V):
    from lir_tpu_torch.engine.generate import sample_keys

    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    key = torch.randint(0, 2**32, (2,), generator=gen, device="cuda",
                        dtype=torch.int64)
    keys, offsets = sample_keys(key, B, V, 1, "cuda")
    return logits, keys[0], offsets


def test_gumbel_argmax_strided_rows_nan_rows_and_ties(gen):
    """Rows that are views of a wider tensor (stride V + 3: each row at
    another 16-byte phase), a row of NaNs (id 0), NaNs at two places (the
    lower wins) and exact ties from V // 3 on, which span the cluster's
    blocks (at temperature 1e-4 logits of 1e6 round to one score)."""
    from lir_tpu_torch.ops.sample import gumbel_argmax_plain

    B, V = 8, 32000
    _, keys, offsets = _sample_case(gen, B, V)
    wide = torch.randn((B, V + 3), generator=gen, device="cuda") * 3
    for lo in range(4):
        logits = wide[:, lo:lo + V]
        for temp in (0.9, 1e-4):
            assert torch.equal(ops.gumbel_argmax(logits, keys, offsets, temp),
                               gumbel_argmax_plain(logits, keys, offsets, temp))
    logits = wide[:, 1:V + 1].clone()
    logits[0] = float("nan")
    logits[1, 17] = logits[1, V - 5] = float("nan")
    logits[2, V // 3:] = 1e6
    logits[3] = 1e6
    got = ops.gumbel_argmax(logits, keys, offsets, 1e-4)
    assert torch.equal(got, gumbel_argmax_plain(logits, keys, offsets, 1e-4))
    assert got[:4].tolist() == [0, 17, V // 3, 0]


def test_gumbel_argmax_second_stream_and_constants(gen):
    """A launch on a second stream, and launches back to back, give the
    same ids: the kernel keeps nothing between launches. The C library's
    constants are ``ops.sample``'s."""
    from lir_tpu_torch.ops import sample

    lib = sample._lib()
    assert (lib.lir_sample_threads(), lib.lir_sample_per_thread(),
            lib.lir_sample_max_cluster()) == (sample.THREADS,
                                              sample.PER_THREAD,
                                              sample.MAX_CLUSTER)
    for B in (8, 64):
        logits, keys, offsets = _sample_case(gen, B, 32000)
        first = ops.gumbel_argmax(logits, keys, offsets, 0.9)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            outs = [ops.gumbel_argmax(logits, keys, offsets, 0.9)
                    for _ in range(3)]
        again = ops.gumbel_argmax(logits, keys, offsets, 0.9)
        torch.cuda.synchronize()
        for ids in outs + [again]:
            assert torch.equal(ids, first)
        assert torch.equal(first, sample.gumbel_argmax_plain(
            logits, keys, offsets, 0.9))


# (B, S, H, K, hd, T, alibi, dtype, view) of the int8-KV attention's
# cases: llama-2-7b's decode step, a verify window and a 16-token
# extension, GQA, falcon-7b's MQA, bloom's ALiBi, head dims 32 / 80 / 96,
# float32 queries, a cache view cut to fewer slots than it holds, and
# 3,000 slots; then (ops.kv_int8_attention.plan) one slot, IMMA at head
# dim 80 in one block, a GQA verify window of 20 rows at the chain's
# extent, 128 rows in two chunks of 64, 1,088 slots at head dim 96, and
# clusters of 3, 4, 6, 7 and 8 blocks (the others: 1, 2 and 5 above).
KV8_CASES = [
    (32, 1, 32, 32, 128, 552, False, BF16, False),
    (32, 5, 32, 32, 128, 552, False, BF16, False),
    (8, 16, 32, 8, 128, 300, True, BF16, False),
    (4, 1, 71, 1, 64, 200, False, BF16, True),
    (3, 4, 8, 2, 32, 100, False, F32, False),
    (3, 2, 8, 8, 80, 65, True, BF16, False),
    (2, 16, 8, 2, 96, 3000, False, BF16, True),
    (2, 3, 4, 4, 64, 1, False, F32, False),
    (3, 16, 8, 2, 80, 40, True, BF16, False),
    (5, 5, 32, 8, 128, 156, False, BF16, False),
    (2, 16, 16, 2, 128, 257, False, BF16, True),
    (2, 1, 4, 4, 96, 1088, True, F32, False),
    (2, 1, 4, 4, 128, 1100, False, BF16, False),
    (2, 5, 8, 2, 128, 2000, True, BF16, True),
    (2, 2, 4, 4, 64, 6000, False, BF16, False),
    (1, 1, 4, 4, 128, 3500, False, F32, False),
    (1, 3, 8, 2, 128, 4097, False, BF16, False),
]


@pytest.mark.parametrize("B,S,H,K,hd,T,alibi,dtype,view", KV8_CASES)
def test_kv_int8_attention_matches_twin(gen, B, S, H, K, hd, T, alibi,
                                        dtype, view):
    from lir_tpu_torch.models.quant import dynamic_quant
    from lir_tpu_torch.ops.kv_int8_attention import (kv_int8_attention_plain,
                                                     qk_s32_plain, tie_bar)

    q = _rnd(gen, B, S, H, hd, dtype=dtype)
    extent = T + 7 if view else T
    kq, ks = dynamic_quant(_rnd(gen, K, extent, B, hd))
    vq, vs = dynamic_quant(_rnd(gen, K, extent, B, hd))
    if view:
        kq, ks, vq, vs = (x[:, :T] for x in (kq, ks, vq, vs))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    mask[0, T // 3:T // 3 + 9] = 0
    mask[:, T - 2:] = 0
    mask[B - 1] = 0                    # a row whose every key is masked
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = (kpos.max(-1).values[:, None] - (S - 1)
            + torch.arange(S, device="cuda")[None]).to(torch.int32)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    args = (q, kq, ks, vq, vs, qpos, mask, kpos)
    before = ops.kv_int8_attention.launches
    s32 = torch.empty((B, H, S, T), dtype=torch.int32, device="cuda")
    got = ops.kv_int8_attention(*args, alibi_slopes=slopes, s32_out=s32)
    ref = kv_int8_attention_plain(*args, alibi_slopes=slopes)
    bar = tie_bar(*args, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert ops.kv_int8_attention.launches == before + 1
    assert got.shape == (B, S, H * hd) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert torch.equal(s32, qk_s32_plain(q, kq))
    err = (got.float() - ref.float()).abs()
    assert bool((err <= bar).all()), float(err.max())
    # Launch after launch, the same bits.
    assert torch.equal(ops.kv_int8_attention(*args, alibi_slopes=slopes), got)


def test_kv_int8_attention_plans_cover_every_split_and_route():
    from lir_tpu_torch.ops.kv_int8_attention import MAX_SPLITS, plan

    plans = [plan(T, hd, S * H // K)
             for B, S, H, K, hd, T, *_ in KV8_CASES]
    assert {p.splits for p in plans} == set(range(1, MAX_SPLITS + 1))
    assert {p.mma for p in plans} == {False, True}
    assert max(p.chunks for p in plans) > 1
    assert {c[4] for p, c in zip(plans, KV8_CASES) if p.mma} >= {80, 96}


@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
def test_kv_int8_attention_row_alone_bitwise_in_batch(gen, H, K):
    from lir_tpu_torch.models.quant import dynamic_quant

    B, S, hd, T = 6, 5, 128, 1100
    q = _rnd(gen, B, S, H, hd)
    kq, ks = dynamic_quant(_rnd(gen, K, T, B, hd))
    vq, vs = dynamic_quant(_rnd(gen, K, T, B, hd))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    mask[:, T - 3:] = 0
    mask[1, 40:50] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = (kpos.max(-1).values[:, None] - (S - 1)
            + torch.arange(S, device="cuda")[None]).to(torch.int32)
    full = ops.kv_int8_attention(q, kq, ks, vq, vs, qpos, mask, kpos)
    for b, s in ((0, 0), (1, 4), (B - 1, 2)):
        alone = ops.kv_int8_attention(
            q[b:b + 1, s:s + 1].contiguous(),
            *(x[:, :, b:b + 1].contiguous() for x in (kq, ks, vq, vs)),
            qpos[b:b + 1, s:s + 1].contiguous(), mask[b:b + 1].contiguous(),
            kpos[b:b + 1].contiguous())
        assert torch.equal(alone[0, 0], full[b, s])


def test_kv_int8_attention_layout_is_the_planners(gen):
    import importlib

    kv = importlib.import_module("lir_tpu_torch.ops.kv_int8_attention")
    lib = kv._lib()
    for hd in kv.HEAD_DIMS:
        for dtype in (0, 1):
            for mma in (0, 1):
                assert 0 <= lib.lir_kv_int8_static_smem(hd, dtype, mma) \
                    <= kv.STATIC_SMEM
        for T, SG in ((1, 1), (156, 5), (552, 20), (1088, 64), (3000, 7)):
            p = kv.plan(T, hd, SG)
            assert lib.lir_kv_int8_smem(hd, p.rows, p.slice,
                                        p.splits) == p.smem
    assert lib.lir_kv_int8_max_smem(0) >= kv.SMEM_OPTIN


def test_kv_int8_attention_refuses_wrong_inputs(gen):
    q = _rnd(gen, 2, 1, 4, 64)
    k8 = torch.zeros((2, 10, 2, 64), dtype=torch.int8, device="cuda")
    sc = torch.ones((2, 10, 2), device="cuda")
    pos = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
    mask = torch.ones((2, 10), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.kv_int8_attention(_rnd(gen, 2, 1, 4, 48), k8[..., :48], sc,
                              k8[..., :48], sc, pos, mask, mask)
    with pytest.raises(ValueError, match="kq"):
        ops.kv_int8_attention(q, k8.float(), sc, k8, sc, pos, mask, mask)
    with pytest.raises(ValueError, match="ks"):
        ops.kv_int8_attention(q, k8, sc.half(), k8, sc, pos, mask, mask)


# ---------------------------------------------------------------------------
# Weight streaming and the fleet (models/weights.py, engine/fleet.py)
# ---------------------------------------------------------------------------

def _tiny_fleet_engines(n, layers=4):
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models import decoder, registry

    cfg = dataclasses.replace(registry.tiny("llama"), hidden_size=256,
                              intermediate_size=1024, n_layers=layers,
                              vocab_size=FakeTokenizer.VOCAB)
    return [(f"m{i}", ScoringEngine(
        decoder.init_params(cfg, seed=i, device="cuda", dtype=BF16), cfg,
        FakeTokenizer(), RuntimeConfig(batch_size=4), device="cuda"))
        for i in range(n)]


def test_restreamed_tree_is_bitwise_its_staged_original(gen):
    """host_stage pins every leaf; stream_params on a copy stream, in
    chunks that cut the matrices, lands every leaf bitwise, bf16 and
    int8 (payload and scales)."""
    from lir_tpu_torch.models import quant, weights

    (_, eng), = _tiny_fleet_engines(1)
    q8 = quant.quantize_decoder_params(eng.params, dynamic=True)
    for tree in (eng.params, q8):
        staged = weights.host_stage(tree)
        assert all(t.is_pinned() for t in weights.tensors(staged))
        streamed = weights.stream_params(staged, device="cuda",
                                         chunk_bytes=4096)
        torch.cuda.current_stream().synchronize()
        for a, b in zip(weights.tensors(streamed), weights.tensors(tree)):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_evict_then_prefetch_keeps_queued_reads(gen):
    """The caching-allocator hazard of the copy stream: a model streamed
    on the copy stream is read by kernels queued on the compute stream
    (held back by a spin kernel), evicted with no synchronize, and the
    next model is prefetched on the copy stream at once. The queued reads
    must still see the evicted model's weights (``record_stream`` keeps
    its blocks from the next load until they have run)."""
    from lir_tpu_torch.engine.fleet import ModelFleet
    from lir_tpu_torch.models import weights

    engines = _tiny_fleet_engines(3)
    nb = weights.tree_bytes(engines[0][1].params)
    fleet = ModelFleet.from_engines(engines, cache_budget_bytes=nb)
    try:
        assert fleet.cache.resident_models == ["m2"]
        e0 = fleet.acquire("m0")              # streamed on the copy stream
        ref = [t.float().sum() for t in weights.tensors(e0.params)]
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)      # ~1 s: hold the compute stream
        got = [t.float().sum() for t in weights.tensors(e0.params)]
        fleet.release("m0")
        assert fleet.evict_idle() and e0.params is None
        fleet.prefetch("m1")                  # the next load, at once
        e1 = fleet.acquire("m1")
        assert fleet.stats.prefetch_hits == 1
        fleet.release("m1")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        for a, b in zip(weights.tensors(e1.params),
                        weights.tensors(fleet.staged("m1"))):
            assert torch.equal(a.cpu(), b)
    finally:
        fleet.shutdown()
