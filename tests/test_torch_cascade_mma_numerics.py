"""The numerics of the bf16 tensor-core cascade kernels, emulated on the CPU.

``csrc/attn_wgmma.cuh`` (the trunk walk, on wgmma) and
``csrc/attn_mma.cuh`` (the window walk, on mma.sync) compute the fused
``cascade_attention`` and the two-leg trunk leg ``cascade_prefix`` from
raw bf16 operands: Q K^T as float32 sums of exact bf16 products, then
times sm_scale (q is never rounded after scaling), ALiBi and the mask in
float32, an online softmax over 64-key tiles (exp(x - m) as
exp2((x - m) * log2 e)), and P V with P split into bf16 hi + bf16 lo over
bf16 V, summed in float32 in 16-key steps (each step's hi product, then
its lo one). The fused kernel walks the trunk as the trunk leg does,
then the window under a fresh accumulator (64 flattened rows a block,
the window keys of their batch rows in 64-key tiles), then merges in
``merge_partials``' order (the two-leg route's arithmetic); the bf16
int8 trunk leg takes Q K^T as exact s8 integer sums (IMMA) folded by the
quantization scales. The emulation
below takes the same roundings in PyTorch, from numpy-seeded inputs at
llama-2-7b head width (hd = 128, Tt = 432, R = 80), and holds them to the
float32 plain versions at the card tests' bars: the trunk partials
(o, m, l) within atol = rtol = 1e-3 of ``prefix_partials`` (int8: of
``prefix_partials_int8``, the row max bitwise), the fused output within
1e-2 of ``cascade_attention_plain`` and of the plain two-leg route. It
also shows why P is split: with P rounded once to bf16 the partials miss
1e-3.

The prefill flash kernels (``flash_mma_kernel`` and ``flash_wgmma_kernel``
in ``csrc/flash_attention.cu``, the latter on attn_wgmma's tile step in
the same order: the card gives the two the same bits) take the same
arithmetic with one bf16 P: its emulation at hd 128, S = 128 and 512
(left-padded, holed and all-masked rows; MHA, GQA, ALiBi) stays within
the card's 1e-2 bar of ``flash_attention_plain`` with room to spare, so
its output, bf16 like the fused cascade's, does not need the split.
"""

import math

import numpy as np
import pytest
import torch

from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes

KEYS = 64                                  # the kernels' key tile
LOG2E = 1.4426950408889634
B, R, Tt, HD = 2, 80, 432, 128
CASES = {"mha": dict(H=4, K=4), "gqa": dict(H=8, K=2),
         "alibi": dict(H=4, K=4, alibi=True)}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(case, seed=7):
    H, K = case["H"], case["K"]
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16)

    q, sk, sv = rnd(B, R, H, HD), rnd(B, R, K, HD), rnd(B, R, K, HD)
    tk, tv = rnd(K, Tt, HD), rnd(K, Tt, HD)
    mask = torch.ones((B, R), dtype=torch.int32)
    mask[0, 60:] = 0                       # a right-padded window
    mask[1, :] = 0                         # a fully masked window
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1) - 1, 0)).to(torch.int32)
    slopes = alibi_slopes(H) if case.get("alibi") else None
    return q, sk, sv, tk, tv, mask, qpos, slopes


def _online(qg, keys, vals, fix, split):
    """The kernels' key walk: qg (B, K, M, hd) rows, keys / vals
    (B, K, T, hd), all float32 values of bf16; fix(s, k0) scales, adds
    ALiBi and masks the raw scores of keys k0 .. k0 + 63. Returns the
    float32 (o, m, l) against the final row max."""
    shape = qg.shape[:3]
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    o = torch.zeros(qg.shape)
    for k0 in range(0, keys.shape[2], KEYS):
        kt, vt = keys[:, :, k0:k0 + KEYS], vals[:, :, k0:k0 + KEYS]
        s = fix(torch.einsum("bkmd,bktd->bkmt", qg, kt), k0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
        p = torch.exp2((s - m_use[..., None]) * LOG2E)
        f = torch.exp2((m - m_use) * LOG2E)
        l = l * f + p.sum(dim=-1)
        hi = _bf16(p)
        lo = _bf16(p - hi)
        # P V in 16-key steps, each step's hi product then its lo one, into
        # the rescaled accumulator: the order of the kernels' wgmma (trunk
        # walk) and mma.sync (window and flash walks) steps.
        o = o * f[..., None]
        for j in range(0, kt.shape[2], 16):
            o = o + torch.einsum("bkmt,bktd->bkmd", hi[..., j:j + 16], vt[:, :, j:j + 16])
            if split:
                o = o + torch.einsum("bkmt,bktd->bkmd", lo[..., j:j + 16],
                                     vt[:, :, j:j + 16])
        m = m_new
    return o, m, l


def _emulate_prefix(q, tk, tv, slopes, split=True):
    """The trunk leg's partials, shaped as ``prefix_partials`` gives them."""
    H, K = q.shape[2], tk.shape[0]
    G = H // K
    qg = q.float().reshape(B, R, K, G, HD).permute(0, 2, 1, 3, 4).reshape(B, K, R * G, HD)
    keys = tk.float()[None].expand(B, -1, -1, -1)
    vals = tv.float()[None].expand(B, -1, -1, -1)
    sm = torch.tensor(1.0 / math.sqrt(HD), dtype=torch.float32)
    slope_rows = (None if slopes is None else
                  slopes.float().reshape(K, 1, G).expand(K, R, G).reshape(1, K, R * G, 1))

    def fix(s, k0):
        s = s * sm
        if slope_rows is not None:
            s = s + slope_rows * torch.arange(k0, k0 + s.shape[-1]).float()
        return s

    o, m, l = _online(qg, keys, vals, fix, split)
    return (o.reshape(B, K, R, G, HD), m.reshape(B, K, R, G), l.reshape(B, K, R, G))


def _emulate_prefix_int8(q, tk, tv, slopes):
    """The bf16 int8 trunk leg: query rows and trunk keys quantized by the
    dynamic rule, s8 QK^T as exact integer sums (IMMA), the scores folded
    as (f32(s32) * (q_scale * sm_scale)) * k_scale, then the split-P walk
    over bf16 V. Shaped as ``prefix_partials_int8`` gives them."""
    from lir_tpu_torch.models.quant import dynamic_quant

    H, K = q.shape[2], tk.shape[0]
    G = H // K
    qq, qs = dynamic_quant(q.reshape(B, R, K, G, HD))
    kq, ks = dynamic_quant(tk)
    qg = qq.float().permute(0, 2, 1, 3, 4).reshape(B, K, R * G, HD)
    keys = kq.float()[None].expand(B, -1, -1, -1)
    vals = tv.float()[None].expand(B, -1, -1, -1)
    qsm = (qs * (1.0 / math.sqrt(HD))).permute(0, 2, 1, 3).reshape(B, K, R * G, 1)
    slope_rows = (None if slopes is None else
                  slopes.float().reshape(K, 1, G).expand(K, R, G).reshape(1, K, R * G, 1))

    def fix(s, k0):
        k1 = k0 + s.shape[-1]
        s = s * qsm * ks[None, :, None, k0:k1]
        if slope_rows is not None:
            s = s + slope_rows * torch.arange(k0, k1).float()
        return s

    o, m, l = _online(qg, keys, vals, fix, split=True)
    return (o.reshape(B, K, R, G, HD), m.reshape(B, K, R, G), l.reshape(B, K, R, G))


def _emulate_window(q, sk, sv, mask, qpos, slopes):
    """The window walk of the fused kernel and the suffix merge: each block
    of 64 flattened rows n = (b * R + r) * G + g of a kv head (one
    warpgroup) walks, in 64-key tiles, the window keys of the batch rows
    its rows belong to; a row sees only its own batch row's keys
    (mask-aware, causal, ALiBi on key positions), under a fresh
    accumulator. A row with no valid key keeps m = -inf, l = 0. Shaped as
    ``suffix_partials`` gives them."""
    H, K = q.shape[2], sk.shape[2]
    G, RG = H // K, R * (H // K)
    N = B * RG
    sm = torch.tensor(1.0 / math.sqrt(HD), dtype=torch.float32)
    n = torch.arange(N)
    row_b, row_r = n // RG, (n % RG) // G
    row_pos = qpos.long()[row_b, row_r]
    key_b = torch.arange(B * R) // R
    key_pos = qpos.long().reshape(-1)
    key_live = mask.reshape(-1) > 0
    o = torch.zeros((B, K, RG, HD))
    m = torch.full((B, K, RG), -math.inf)
    l = torch.zeros((B, K, RG))
    for kh in range(K):
        qk = q.float().reshape(B * R, K, G, HD)[:, kh].reshape(N, HD)
        keys = sk.float()[:, :, kh].reshape(B * R, HD)
        vals = sv.float()[:, :, kh].reshape(B * R, HD)
        slope = (None if slopes is None else
                 slopes.float()[kh * G + n % G])
        for n0 in range(0, N, 64):
            rows = n[n0:n0 + 64]
            w0, w1 = int(row_b[rows[0]]) * R, (int(row_b[rows[-1]]) + 1) * R

            def fix(s, k0):
                w = torch.arange(w0 + k0, w0 + k0 + s.shape[-1])
                s = s * sm
                if slope is not None:
                    s = s + slope[rows][:, None] * key_pos[w].float()[None, :]
                ok = (key_live[w][None, :] & (key_b[w][None, :] == row_b[rows][:, None])
                      & (key_pos[w][None, :] <= row_pos[rows][:, None]))
                return s.masked_fill(~ok, -math.inf)

            ob, mb, lb = _online(qk[rows][None, None], keys[None, None, w0:w1],
                                 vals[None, None, w0:w1], fix, split=True)
            b, i = row_b[rows], n[rows] % RG
            o[b, kh, i], m[b, kh, i], l[b, kh, i] = ob[0, 0], mb[0, 0], lb[0, 0]
    return (o.reshape(B, K, R, G, HD), m.reshape(B, K, R, G), l.reshape(B, K, R, G))


def _merge(o_t, m_t, l_t, o_s, m_s, l_s, H):
    """merge_partials' order of the two partials: m, the weights, l, then
    (w_t o_t + w_s o_s) / max(l, 1e-30); (B, R, H, hd) in bf16."""
    m = torch.maximum(m_t, m_s)
    zero = torch.zeros(())
    w_t = torch.where(torch.isfinite(m_t), torch.exp(m_t - m), zero)
    w_s = torch.where(torch.isfinite(m_s), torch.exp(m_s - m), zero)
    l = w_t * l_t + w_s * l_s
    o = (w_t[..., None] * o_t + w_s[..., None] * o_s) / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 2, 1, 3, 4).reshape(B, R, H, HD).to(torch.bfloat16)


def _emulate_fused(q, sk, sv, tk, tv, mask, qpos, slopes):
    """The fused kernel: the trunk leg's own walk, then the window walk
    under a fresh accumulator, then the merge in merge_partials' order;
    the output rounded to bf16. The suffix merge is the same after a read
    of the trunk partials."""
    return _merge(*_emulate_prefix(q, tk, tv, slopes),
                  *_emulate_window(q, sk, sv, mask, qpos, slopes), q.shape[2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_p_trunk_partials_within_1e3(name):
    q, _, _, tk, tv, _, _, slopes = _inputs(CASES[name])
    got = _emulate_prefix(q, tk, tv, slopes)
    ref = ops.prefix_partials(q, tk, tv, slopes)
    for part, g, r in zip("oml", got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3, msg=part)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_emulation_within_1e2(name):
    args = _inputs(CASES[name])
    got = _emulate_fused(*args)
    ref = ops.cascade_attention_plain(*args[:7], alibi_slopes=args[7])
    assert got.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_emulation_is_the_two_leg_route(name):
    """The restructured fused kernel computes the two-leg route in its
    order: its emulation against the plain two-leg route (``_two_leg``
    through ``cascade_attention(fused_suffix=False)``) within the card's
    1e-2 bar, and its window walk against ``suffix_partials`` within
    1e-3 (a fully masked window: m = -inf and l = 0 in both)."""
    q, sk, sv, tk, tv, mask, qpos, slopes = _inputs(CASES[name])
    got = _emulate_fused(q, sk, sv, tk, tv, mask, qpos, slopes)
    ref = ops.cascade_attention(q, sk, sv, tk, tv, mask, qpos,
                                alibi_slopes=slopes, fused_suffix=False)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)
    from lir_tpu_torch.ops.cascade_prefill import suffix_partials

    win = _emulate_window(q, sk, sv, mask, qpos, slopes)
    plain = suffix_partials(q, sk, sv, mask, qpos, slopes)
    assert bool(torch.isinf(win[1][1]).all()) and bool((win[2][1] == 0).all())
    for part, g, r in zip("oml", win, plain):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3, msg=part)


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_imma_trunk_partials(name):
    """The bf16 int8 trunk leg on IMMA: its row max bitwise
    ``prefix_partials_int8``'s (exact s32 sums, the same fold order) and
    its partials within 1e-3 (split P)."""
    q, _, _, tk, tv, _, _, slopes = _inputs(CASES[name])
    got = _emulate_prefix_int8(q, tk, tv, slopes)
    ref = ops.prefix_partials_int8(q, tk, tv, slopes)
    assert torch.equal(got[1], ref[1])
    for part, g, r in zip("oml", got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-3, msg=part)


def test_single_bf16_p_misses_the_partials_bar():
    """The recorded reason for the split: one bf16 rounding of P moves the
    float32 partial o by far more than 1e-3 at this width."""
    q, _, _, tk, tv, _, _, _ = _inputs(CASES["mha"])
    o_single = _emulate_prefix(q, tk, tv, None, split=False)[0]
    o_split = _emulate_prefix(q, tk, tv, None)[0]
    o_ref = ops.prefix_partials(q, tk, tv, None)[0]
    assert not torch.allclose(o_single, o_ref, atol=1e-3, rtol=1e-3)
    err_single = float((o_single - o_ref).abs().max())
    err_split = float((o_split - o_ref).abs().max())
    assert err_single > 1e-2 and err_split < 1e-3, (err_single, err_split)


# The prefill flash kernel: (B, S) with a left-padded row, a row with a
# hole and an all-masked row, at both of the main path's bucket kinds
# (S <= 128, and a multiple of 128).
FLASH_S = (128, 512)


def _flash_inputs(case, S, seed=11):
    H, K = case["H"], case["K"]
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16)

    q, k, v = rnd(3, S, H, HD), rnd(3, S, K, HD), rnd(3, S, K, HD)
    mask = torch.ones((3, S), dtype=torch.int32)
    mask[0, :S // 3] = 0                   # left pad
    mask[1, S // 2:S // 2 + 5] = 0         # a hole
    mask[2, :] = 0                         # no valid key
    kpos = torch.clamp_min(torch.cumsum(mask, -1) - 1, 0).to(torch.int32)
    slopes = alibi_slopes(H) if case.get("alibi") else None
    return q, k, v, mask, slopes, kpos


def _emulate_flash(q, k, v, mask, slopes, kpos, split=False):
    """The flash kernel's walk for every (batch row, head): key tiles of
    64 from slot 0 to the end. The kernel starts at the tile of the row's
    first valid key and stops at its diagonal; the tiles it skips are
    all masked for the row, and a masked tile leaves (m, l, o) as they
    are, so the walks agree. Output normalized and rounded to bf16."""
    Bq, S, H, _ = q.shape
    G = H // k.shape[2]
    qg = q.float().permute(0, 2, 1, 3)                        # (B, H, S, hd)
    keys = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vals = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    sm = torch.tensor(1.0 / math.sqrt(HD), dtype=torch.float32)
    idx = torch.arange(S)

    def fix(s, k0):
        k1 = k0 + s.shape[-1]
        s = s * sm
        if slopes is not None:
            s = s + slopes.float()[None, :, None, None] * kpos[:, None, None, k0:k1].float()
        ok = ((mask[:, None, None, k0:k1] > 0)
              & (idx[None, None, None, k0:k1] <= idx[None, None, :, None]))
        return s.masked_fill(~ok, -math.inf)

    o, _, l = _online(qg, keys, vals, fix, split)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _share_of_bar(got, ref):
    """The largest error as a share of atol + rtol * |ref| at 1e-2."""
    err = (got.float() - ref.float()).abs()
    return float((err / (1e-2 + 1e-2 * ref.float().abs())).max())


@pytest.mark.parametrize("S", FLASH_S)
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_single_p_within_1e2(name, S):
    q, k, v, mask, slopes, kpos = _flash_inputs(CASES[name], S)
    got = _emulate_flash(q, k, v, mask, slopes, kpos)
    ref = ops.flash_attention_plain(q, k, v, mask, slopes,
                                    kpos if slopes is not None else None)
    assert got.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert bool((got[2] == 0).all())       # the all-masked row gives 0


def test_flash_single_p_needs_no_split():
    """The recorded reason for one bf16 P in the flash kernel: at S = 512
    its worst error is under 0.6 of the 1e-2 bar (the split would take it
    to the bf16 output rounding, about a quarter of the bar, for 1.5x the
    P V products)."""
    q, k, v, mask, _, kpos = _flash_inputs(CASES["mha"], 512)
    ref = ops.flash_attention_plain(q, k, v, mask)
    single = _share_of_bar(_emulate_flash(q, k, v, mask, None, kpos), ref)
    split = _share_of_bar(_emulate_flash(q, k, v, mask, None, kpos, split=True), ref)
    assert split < single < 0.6, (single, split)
