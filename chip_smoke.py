"""Drive the PyTorch port (``lir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Build: compile every kernel of ``lir_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once; print ptxas's registers,
   shared memory and spills per kernel, and the count of tensor-core
   instructions (HMMA, or HGMMA for wgmma) in each instantiation of the
   bf16 tensor-core kernels (``cascade_mma_kernel``, ``prefix_mma_kernel``,
   ``flash_mma_kernel``) from ``cuobjdump -sass`` of the built library;
   fail if one has none.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them (llama-2-7b widths, B = 32, the cache
   extents and trunks of phase 3's dispatches; the verify window's
   S = spec_k = 4 queries a row for the multi-query kernels; the trunk
   leg at the cascade dispatch's shape, float32 and int8 QK^T; the
   prefill flash kernel at buckets 64, 128 and 512), plus GQA
   (mistral-7b), MQA (falcon-7b) and ALiBi (bloom-7b1) shapes: bf16
   kernel output against the float32 plain version of the same bf16
   inputs, atol = rtol = 1e-2 (bf16 output rounding; the trunk leg's
   float32 partials to the same bar); the trunk decode kernels bitwise
   the flat ones, query j of the multi-query kernel bitwise the
   single-query kernel at its position, and the int8 trunk leg's row max
   bitwise its plain twin's (the int8 payloads and s32 dots are exact).
   Times by CUDA events after warm-up, the L2 cache flushed before every
   launch and the stream held by a spin kernel while the host enqueues it
   (device time, without the host's launch time); the SDPA yardstick (``library_ms``) is timed beside the float
   kernels and used nowhere in the port (no PyTorch call computes the
   int8-QK^T trunk leg); the two legs of ``flash_decode_mq_trunk`` and its
   merge are also timed one launch at a time. Then the whole slice at a
   small float32 size:
   the cascade and the speculative dispatch on the card against the same
   on the CPU (plain versions), the speculative dispatch against the
   sequential one on the card (ids exact, position-0 readouts bitwise),
   a speculative run given the sequential stream as its drafts, and the
   8-bit engine (dynamic int8 weights, int8 QK^T, flash prefill) on the
   card against the same on the CPU (ids exact, floats within 1e-2).
   Last, at llama-2-7b width, one decode step against one verify window
   from the same cache: their logit difference, and the step's top-2 gap
   where their argmax differs (printed, not asserted).
3. The slice at full width: llama-2-7b with seeded random bf16 weights
   made on the card, four engines sharing them. The word-meaning sweep
   over the 50 questions (dense prefill + the flat decode kernel); one
   shared dispatch of 32 cells sharing a ~430-token legal trunk (cascade
   prefill + the trunk decode kernel), and the same on an engine with
   the fused cascade off (the float trunk-leg kernel; its position-0
   yes>no decisions must equal the fused route's, its position-0
   probabilities within 1e-3); the 32 cells with no common trunk on the
   sequential engine (dense shared prefill + the flat kernel) and on the
   default engine (the speculative verify loop on the multi-query
   kernel); the trunk cells on the sequential engine and on an engine
   with the cascade prefill off (the verify loop on the trunk-aware
   multi-query kernel). Then the 8-bit engine at the same width, its
   int8 weights born on the card (``init_quantized_params``, dynamic):
   the word-meaning sweep (flash prefill + flat decode), the trunk
   dispatch (int8 trunk-leg kernel + trunk decode) and the no-trunk
   dispatch (flash prefill at bucket 128 + the verify loop), with rows/s
   and peak memory beside the bf16 engine's, and a profile of one of its
   word-meaning batches beside the bf16 one's. Each phase resets the
   launch counts just before it and reads them just after, and fails if
   a kernel of its path never launched; the speculative dispatches'
   position-0 readouts must be bitwise the sequential ones on the same
   cells.
4. The ``{"kernels": [...]}`` summary, the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from lir_tpu_torch import ops
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import CascadeConfig, RuntimeConfig
from lir_tpu_torch.data import (LEGAL_PROMPTS, WORD_MEANING_QUESTIONS,
                                format_base_prompt)
from lir_tpu_torch.engine import generate, sweep, tokens as tok
from lir_tpu_torch.engine.runner import SFX_BUCKETS, ScoringEngine
from lir_tpu_torch.models import decoder, quant, registry
from lir_tpu_torch.ops import _build
from lir_tpu_torch.ops.flash_decode import (decode_legs,
                                            flash_decode_mq_plain,
                                            flash_decode_mq_trunk_plain,
                                            flash_decode_plain,
                                            flash_decode_trunk_plain,
                                            trunk_splits, DECODE_SPLIT)
from lir_tpu_torch.ops.cascade_prefill import (cascade_attention_plain,
                                               prefix_partials,
                                               prefix_partials_int8)
from lir_tpu_torch.ops.flash_attention import flash_attention_plain

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, published
INT8_OP_PER_S = 1979e12          # H100 SXM dense int8 tensor cores, published
ATOL = RTOL = 1e-2
BATCH = 32
DEV = "cuda"
# SDPA groups query heads itself where this PyTorch supports it (2.5+).
_SDPA_GQA = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
# Each kernel's source, the TPU kernel it replaces, and the phase-2 case
# whose shape is its main-path shape in the summary line.
SOURCES = {
    "flash_decode": ("lir_tpu_torch/csrc/flash_decode.cu",
                     "lir_tpu/ops/flash_decode.py:65",
                     "llama2-7b/cascade-dispatch"),
    "flash_decode_trunk": ("lir_tpu_torch/csrc/flash_decode.cu",
                           "lir_tpu/ops/flash_decode.py:179",
                           "llama2-7b/cascade-dispatch"),
    "cascade_attention": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                          "lir_tpu/ops/cascade_prefill.py:204",
                          "llama2-7b/cascade-dispatch"),
    "flash_decode_mq": ("lir_tpu_torch/csrc/flash_decode.cu",
                        "lir_tpu/ops/flash_decode.py:348",
                        "llama2-7b/spec-dispatch"),
    "flash_decode_mq_trunk": ("lir_tpu_torch/csrc/flash_decode.cu",
                              "lir_tpu/ops/flash_decode.py:464",
                              "llama2-7b/spec-trunk-dispatch"),
    "cascade_prefix": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                       "lir_tpu/ops/cascade_prefill.py:68",
                       "llama2-7b/cascade-dispatch"),
    "cascade_prefix_int8": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                            "lir_tpu/ops/cascade_prefill.py:68",
                            "llama2-7b/cascade-dispatch"),
    "flash_attention": ("lir_tpu_torch/csrc/flash_attention.cu",
                        "lir_tpu/ops/flash_attention.py:41",
                        "llama2-7b/spec-dispatch"),
}
# The two-leg cascade against the fused one at full width (bf16): the
# position-0 probabilities of both branches within this absolute bound.
POS0_PROB_ATOL = 1e-3
# The 8-bit small slice on the card against the CPU: floats within this
# bound. The two devices' activations differ by ~1e-7 (other summation
# orders); where that crosses a rounding boundary of the per-token
# quantization one int8 payload moves by a step, which moves a logit by
# a few 1e-3 at this size (3.5e-3 seen in a top-k log-prob).
INT8_SLICE_TOL = 1e-2
# Position-0 readouts of a shared dispatch, held bitwise between the
# speculative and the sequential route.
POS0_FIELDS = ("topk_logprobs", "topk_ids", "weighted_confidence")


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# Phase 3's inputs (planned first, so phase 2 runs at their shapes)
# ---------------------------------------------------------------------------

def legal_cells(shared_trunk: bool):
    """32 (binary, confidence, yes id, no id) cells. With a trunk, every
    cell opens with the five legal questions' text (~430 words) and ends
    in its own variation; without, every cell opens differently."""
    trunk = " ".join(p.main for p in LEGAL_PROMPTS)
    cells = []
    for r in range(BATCH):
        p = LEGAL_PROMPTS[r % len(LEGAL_PROMPTS)]
        words = p.main.split()
        tail = " ".join(words[r % 7: r % 7 + 10 + r % 13])
        text = (f"{trunk} Variation {r}: {tail}" if shared_trunk
                else f"Variation {r}: {p.main} {tail}")
        cells.append((p.rephrased_binary(text), p.rephrased_confidence(text),
                      p.target_tokens))
    return cells


def plan_shared(engine: ScoringEngine, cells, rt: RuntimeConfig):
    """The bucket, trunk and cache extents decode_fused_shared will use:
    T0 for the sequential loop, T_spec for the speculative one."""
    t = engine.tokenizer
    bins = [t(b).input_ids for b, _, _ in cells]
    confs = [t(c).input_ids for _, c, _ in cells]
    lcp = [tok.shared_prefix_len(a, b) for a, b in zip(bins, confs)]
    bucket = tok.pick_bucket(lcp, engine.buckets)
    ba = tok.pick_bucket([len(a) - n for a, n in zip(bins, lcp)], SFX_BUCKETS)
    bb = tok.pick_bucket([len(c) - n for c, n in zip(confs, lcp)], SFX_BUCKETS)
    trunk = engine.cascade_trunk_for([a[:n] for a, n in zip(bins, lcp)],
                                     len(cells), bucket)
    T0 = bucket + max(ba + rt.sweep_decode_tokens,
                      bb + rt.sweep_confidence_tokens)
    T_spec = generate.spec_total_len(bucket, ba, bb, rt.sweep_decode_tokens,
                                     rt.sweep_confidence_tokens, rt.spec_k)
    return dict(bucket=bucket, trunk=trunk, T0=T0, T_spec=T_spec, lcp=lcp,
                prefix_rows=[a[:n] for a, n in zip(bins, lcp)])


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

_FLUSH = None


# Cycles of the spin kernel that holds the stream before each timed launch
# (~0.5 ms): longer than the host takes to enqueue a wrapper's launches.
SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (a 64 MB write), by CUDA events. A spin kernel between the flush
    and the start event keeps the stream busy while the host enqueues
    ``fn``, so the reading is device time, not the host's launch time."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def warm_up(seconds: float = 2.0) -> None:
    """Run the card at full load for ``seconds`` (bf16 products), so that
    the first timing does not read it at the idle clocks of the build."""
    x = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x @ x
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float, int8_ops: float = 0.0):
    """The least time for the work: bytes over the memory rate against
    bf16-rate FLOPs plus int8-rate operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / BF16_FLOP_PER_S + int8_ops / INT8_OP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_close(name, got, ref):
    err = (got.float() - ref.float()).abs()
    limit = ATOL + RTOL * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"atol=rtol={ATOL}")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(gen, B, H, K, hd, T, trunk_len, S=None):
    """Decode-step inputs at the main path's shapes: q (B, H, hd) and
    q_positions (B,), or with ``S`` a verify window, q (B, S, H, hd) and
    q_positions (B, S) at the row's last S valid slots."""
    dev = DEV
    qshape = (B, H, hd) if S is None else (B, S, H, hd)
    q = torch.randn(qshape, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((K, T, B, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((K, T, B, hd), generator=gen, device=dev).to(torch.bfloat16)
    if trunk_len:
        k[:, :trunk_len] = k[:, :trunk_len, :1]
        v[:, :trunk_len] = v[:, :trunk_len, :1]
    # The shared dispatch's mask: trunk and each row's prefix valid, the
    # right-padded gap to the bucket masked, the decode slots filling.
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    for b in range(B):
        lo = max(trunk_len, T // 2) + (b * 7) % max(T // 4, 1)
        mask[b, lo:lo + 5 + b % 9] = 0
    mask[:, T - 3:] = 0                     # decode slots not yet written
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = kpos.max(dim=-1).values.to(torch.int32)
    if S is not None:
        qpos = (qpos[:, None] - (S - 1)
                + torch.arange(S, device=dev)[None, :]).to(torch.int32)
    return q, k, v, qpos, mask, kpos


def decode_work(q, k, mask, trunk_len, hd, kpos=None, qpos=None):
    """Bytes and flops the decode function needs on these inputs: q, the
    valid-or-not K/V slots (each row's own, the trunk's once), the int
    arrays, the output; two flops per multiply-add of QK^T and PV over
    the keys each query may see. q is (B, H, hd), or (B, S, H, hd) with
    ``kpos``/``qpos`` for a verify window (each query its own keys)."""
    q4 = q if q.dim() == 4 else q[:, None]
    B, S, H, _ = q4.shape
    K, T = k.shape[0], k.shape[1]
    tk = trunk_splits(trunk_len, T) * DECODE_SPLIT
    kv_slots = tk + (T - tk) * B
    kv_bytes = 2 * K * kv_slots * hd * k.element_size()
    int_bytes = 4 * (2 * B * T + B * S)
    byts = nbytes(q) * 2 + kv_bytes + int_bytes
    if qpos is None:
        pairs = float(mask.sum())
    else:
        pairs = float(((mask > 0)[:, None, :]
                       & (kpos[:, None, :] <= qpos[:, :, None])).sum())
    return byts, 4.0 * H * hd * pairs


def _gqa(grouped: bool) -> dict:
    return {"enable_gqa": True} if grouped and _SDPA_GQA else {}


def _sdpa_kv(k, v, G):
    """K/V for the SDPA yardstick, (B, K, T, hd); repeated to the query
    heads (outside the timed call) where SDPA cannot group them."""
    if G > 1 and not _SDPA_GQA:
        return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return k, v


def check_decode(gen, label, B, H, K, hd, T, trunk_len, alibi, results):
    q, k, v, qpos, mask, kpos = decode_inputs(gen, B, H, K, hd, T, trunk_len)
    slopes = decoder.alibi_slopes(H, DEV) if alibi else None
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    flat = ops.flash_decode(*args, **kw)
    ref = flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    err_flat = check_close(f"flash_decode[{label}]", flat, ref)
    rows = []
    bias = torch.where((mask > 0)[:, None, None, :], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    kb, vb = _sdpa_kv(k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3), H // K)
    bias = bias.to(q.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kb, vb,
                                              attn_mask=bias, **_gqa(K != H))

    lib_ms = time_ms(sdpa)
    byts, flops = decode_work(q, k, mask, 0, hd)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(kernel="flash_decode", case=label, B=B, H=H, K=K, hd=hd,
                     T=T, max_abs_err=err_flat,
                     kernel_ms=time_ms(lambda: ops.flash_decode(*args, **kw)),
                     plain_ms=time_ms(lambda: flash_decode_plain(*args, **kw)),
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    if trunk_len:
        tkw = dict(kw, trunk_len=trunk_len)
        trunk = ops.flash_decode_trunk(*args, **tkw)
        tref = flash_decode_trunk_plain(*args, **tkw)
        torch.cuda.synchronize()
        err_trunk = check_close(f"flash_decode_trunk[{label}]", trunk, tref)
        if not torch.equal(trunk, flat):
            raise AssertionError(f"flash_decode_trunk[{label}] is not bitwise "
                                 f"the flat kernel")
        byts, flops = decode_work(q, k, mask, trunk_len, hd)
        b_ms, b_by = bound(byts, flops)
        rows.append(dict(
            kernel="flash_decode_trunk", case=label, B=B, H=H, K=K, hd=hd,
            T=T, trunk_len=trunk_len, max_abs_err=err_trunk,
            bitwise_equal_flat=True,
            kernel_ms=time_ms(lambda: ops.flash_decode_trunk(*args, **tkw)),
            plain_ms=time_ms(lambda: flash_decode_trunk_plain(*args, **tkw)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    for row in rows:
        log(json.dumps(row))
        results.append(row)


def check_decode_mq(gen, label, B, S, H, K, hd, T, trunk_len, alibi,
                    results):
    """The multi-query kernels at a verify window's shape: against their
    plain versions, query j bitwise the single-query kernel, and the
    trunk kernel (at ``trunk_len``) bitwise the flat one."""
    q, k, v, qpos, mask, kpos = decode_inputs(gen, B, H, K, hd, T, trunk_len,
                                              S=S)
    slopes = decoder.alibi_slopes(H, DEV) if alibi else None
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    mq = ops.flash_decode_mq(*args, **kw)
    ref = flash_decode_mq_plain(*args, **kw)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode_mq[{label}]", mq, ref)
    for j in range(S):
        one = ops.flash_decode(q[:, j].contiguous(), k, v,
                               qpos[:, j].contiguous(), mask, **kw)
        if not torch.equal(one, mq[:, j]):
            raise AssertionError(f"flash_decode_mq[{label}] query {j} is not "
                                 f"bitwise the single-query kernel")
    valid = ((mask > 0)[:, None, :]
             & (kpos[:, None, :] <= qpos[:, :, None]))          # (B, S, T)
    bias = torch.where(valid[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    bias = bias.to(q.dtype)
    kb, vb = _sdpa_kv(k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bias,
                                              **_gqa(K != H))

    lib_ms = time_ms(sdpa)
    rows = []
    byts, flops = decode_work(q, k, mask, 0, hd, kpos, qpos)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(
        kernel="flash_decode_mq", case=label, B=B, S=S, H=H, K=K, hd=hd, T=T,
        max_abs_err=err, bitwise_equal_single_query=True,
        kernel_ms=time_ms(lambda: ops.flash_decode_mq(*args, **kw)),
        plain_ms=time_ms(lambda: flash_decode_mq_plain(*args, **kw)),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    tkw = dict(kw, trunk_len=trunk_len)
    trunk = ops.flash_decode_mq_trunk(*args, **tkw)
    tref = flash_decode_mq_trunk_plain(*args, **tkw)
    torch.cuda.synchronize()
    err_trunk = check_close(f"flash_decode_mq_trunk[{label}]", trunk, tref)
    if not torch.equal(trunk, mq):
        raise AssertionError(f"flash_decode_mq_trunk[{label}] is not bitwise "
                             f"flash_decode_mq")
    byts, flops = decode_work(q, k, mask, trunk_len, hd, kpos, qpos)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(
        kernel="flash_decode_mq_trunk", case=label, B=B, S=S, H=H, K=K,
        hd=hd, T=T, trunk_len=trunk_len, max_abs_err=err_trunk,
        bitwise_equal_flat=True,
        kernel_ms=time_ms(lambda: ops.flash_decode_mq_trunk(*args, **tkw)),
        plain_ms=time_ms(lambda: flash_decode_mq_trunk_plain(*args, **tkw)),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        **mq_trunk_legs(args, kw, trunk_len, bias)))
    for row in rows:
        log(json.dumps(row))
        results.append(row)


def mq_trunk_legs(args, kw, trunk_len, bias):
    """The launches of ``flash_decode_mq_trunk`` timed one at a time: the
    trunk leg, the row leg over the tail splits, the merge. The tail leg
    beside its own bound (q, the tail's K/V slots of every row, the int
    arrays, the partials it writes; the products over the tail keys each
    query may see) and beside the plain multi-query function and SDPA on
    the tail keys alone."""
    q, k, v, qpos, mask = args
    kpos = kw["key_positions"]
    _, legs = decode_legs(*args, trunk_len=trunk_len, **kw)
    key = {"trunk": "trunk_leg_ms", "rows": "tail_leg_ms", "merge": "merge_ms"}
    times = {key[name]: time_ms(fn) for name, fn in legs.items()}
    tk = trunk_splits(trunk_len, k.shape[1]) * DECODE_SPLIT
    B, S, H, hd = q.shape
    K, T = k.shape[0], k.shape[1]
    kt, vt = k[:, tk:].contiguous(), v[:, tk:].contiguous()
    mt, pt = mask[:, tk:].contiguous(), kpos[:, tk:].contiguous()
    ns_tail = -(-(T - tk) // DECODE_SPLIT)
    partial_bytes = B * K * ns_tail * S * (H // K) * (hd + 2) * 4
    pairs = float(((mt > 0)[:, None, :] & (pt[:, None, :] <= qpos[:, :, None])).sum())
    byts = (nbytes(q, kt, vt, qpos) + 4 * 2 * mt.numel() + partial_bytes)
    b_ms, b_by = bound(byts, 4.0 * H * hd * pairs)
    tkw = dict(key_positions=pt, alibi_slopes=kw["alibi_slopes"])
    bt = bias[..., tk:].contiguous()
    kb, vb = _sdpa_kv(kt.permute(2, 0, 1, 3), vt.permute(2, 0, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bt,
                                              **_gqa(K != H))

    return dict(times, tail_leg_bound_ms=b_ms, tail_leg_bound_by=b_by,
                tail_leg_plain_ms=time_ms(lambda: flash_decode_mq_plain(
                    q, kt, vt, qpos, mt, **tkw)),
                tail_leg_library_ms=time_ms(sdpa))


def check_cascade(gen, label, B, R, H, K, hd, Tt, alibi, results):
    dev = DEV
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, sk, sv = rnd(B, R, H, hd), rnd(B, R, K, hd), rnd(B, R, K, hd)
    tk, tv = rnd(K, Tt, hd), rnd(K, Tt, hd)
    mask = torch.ones((B, R), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, R - (b * 5) % R:] = 0       # ragged right-padded windows
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    args = (q, sk, sv, tk, tv, mask, qpos)
    got = ops.cascade_attention(*args, alibi_slopes=slopes)
    ref = cascade_attention_plain(*args, alibi_slopes=slopes)
    torch.cuda.synchronize()
    err = check_close(f"cascade_attention[{label}]", got, ref)

    # Yardstick: SDPA over trunk + window keys under the same mask.
    G = H // K
    keys = torch.cat([tk[None].expand(B, -1, -1, -1),
                      sk.permute(0, 2, 1, 3)], dim=2)        # (B, K, Tt+R, hd)
    vals = torch.cat([tv[None].expand(B, -1, -1, -1),
                      sv.permute(0, 2, 1, 3)], dim=2)
    causal = ((mask[:, None, :] > 0)
              & (qpos[:, None, :] <= qpos[:, :, None]))      # (B, Rq, Rk)
    allowed = torch.cat([torch.ones((B, R, Tt), dtype=torch.bool, device=dev),
                         causal], dim=-1)
    kp = torch.cat([torch.arange(Tt, device=dev)[None].expand(B, -1).float(),
                    qpos.float()], dim=-1)
    bias = torch.where(allowed[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kp[:, None, None, :]
    bias = bias.to(bf)
    qh = q.permute(0, 2, 1, 3)
    keys, vals = _sdpa_kv(keys, vals, G)

    def sdpa():
        return F.scaled_dot_product_attention(qh, keys, vals, attn_mask=bias,
                                              **_gqa(G > 1))

    pairs = float(Tt * B * R + causal.sum())
    flops = 4.0 * H * hd * pairs
    byts = nbytes(q, sk, sv, tk, tv, mask, qpos, slopes) + nbytes(q)
    b_ms, b_by = bound(byts, flops)
    row = dict(kernel="cascade_attention", case=label, B=B, R=R, H=H, K=K,
               hd=hd, Tt=Tt, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.cascade_attention(
                   *args, alibi_slopes=slopes)),
               plain_ms=time_ms(lambda: cascade_attention_plain(
                   *args, alibi_slopes=slopes), iters=3),
               library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def check_prefix(gen, label, B, R, H, K, hd, Tt, alibi, results):
    """The trunk-leg kernels (float32 and int8 QK^T) against their plain
    versions: (o, m, l) within atol = rtol = 1e-2, and with int8 the row
    max m bitwise (the payloads and s32 dots are exact and fold in the
    same order). SDPA over the trunk with the same ALiBi bias is the
    float kernel's yardstick; no PyTorch call computes int8 QK^T."""
    dev = DEV
    bf = torch.bfloat16
    q = torch.randn((B, R, H, hd), generator=gen, device=dev).to(bf)
    tk = torch.randn((K, Tt, hd), generator=gen, device=dev).to(bf)
    tv = torch.randn((K, Tt, hd), generator=gen, device=dev).to(bf)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    G = H // K
    bias = None
    if alibi:
        bias = (slopes[:, None, None]
                * torch.arange(Tt, device=dev).float()[None, None, :]
                ).to(bf)[None].expand(B, -1, R, -1)
    qh = q.permute(0, 2, 1, 3)
    keys, vals = _sdpa_kv(tk[None].expand(B, -1, -1, -1),
                          tv[None].expand(B, -1, -1, -1), G)

    def sdpa():
        return F.scaled_dot_product_attention(qh, keys, vals, attn_mask=bias,
                                              **_gqa(G > 1))

    lib_ms = time_ms(sdpa)
    n_q = B * R * H
    out_bytes = n_q * (hd + 2) * 4
    byts = nbytes(q, tk, tv, slopes) + out_bytes
    for name, kernel, plain in (
            ("cascade_prefix", ops.cascade_prefix, prefix_partials),
            ("cascade_prefix_int8", ops.cascade_prefix_int8,
             prefix_partials_int8)):
        got = kernel(q, tk, tv, slopes)
        ref = plain(q, tk, tv, slopes)
        torch.cuda.synchronize()
        err = max(check_close(f"{name}[{label}]/{part}", g, r)
                  for part, g, r in zip("oml", got, ref))
        int8 = name.endswith("int8")
        if int8 and not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{name}[{label}]: row max is not bitwise "
                                 f"the plain twin's")
        pair_ops = 2.0 * n_q * Tt * hd                 # one product of QK^T or PV
        b_ms, b_by = bound(byts, pair_ops if int8 else 2 * pair_ops,
                           pair_ops if int8 else 0.0)
        row = dict(kernel=name, case=label, B=B, R=R, H=H, K=K, hd=hd, Tt=Tt,
                   max_abs_err=err, row_max_bitwise=int8 or None,
                   kernel_ms=time_ms(lambda: kernel(q, tk, tv, slopes)),
                   plain_ms=time_ms(lambda: plain(q, tk, tv, slopes), iters=3),
                   library_ms=None if int8 else lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        log(json.dumps(row))
        results.append(row)


def check_flash_attention(gen, label, B, S, H, K, hd, alibi, results):
    """The prefill flash kernel against its plain version at a bucket's
    shape: each row left-padded by its own amount (as the sweep pads
    prompts), one row with a hole. SDPA with the same causal mask, key
    mask and ALiBi bias is the yardstick."""
    dev = DEV
    bf = torch.bfloat16
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(bf)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, :(b * 7) % max(S // 2, 1)] = 0
    mask[1, S // 2:S // 2 + 3] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    kw = dict(key_mask=mask, alibi_slopes=slopes,
              key_positions=kpos if alibi else None)
    got = ops.flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention[{label}]", got, ref)
    idx = torch.arange(S, device=dev)
    allowed = (mask[:, None, :] > 0) & (idx[None, None, :] <= idx[None, :, None])
    bias = torch.where(allowed[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    bias = bias.to(bf)
    kb, vb = _sdpa_kv(k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bias,
                                              **_gqa(K != H))

    pairs = float(allowed.sum())
    byts = nbytes(q, k, v, mask, kpos if alibi else None, slopes) + nbytes(q)
    b_ms, b_by = bound(byts, 4.0 * H * hd * pairs)
    row = dict(kernel="flash_attention", case=label, B=B, S=S, H=H, K=K,
               hd=hd, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                iters=3),
               library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def _shared_dispatch(eng, rows, bucket):
    """One shared dispatch of the small slice: each row's binary and
    confidence prompts differ in their last two tokens."""
    n = len(rows)
    return eng.decode_fused_shared(
        [""] * n, [""] * n, np.full(n, 5, np.int32), np.full(n, 9, np.int32),
        new_tokens=3, conf_tokens=4, pretokenized_a=[r + [5, 6] for r in rows],
        pretokenized_b=[r + [7, 8] for r in rows], bucket=bucket,
        reuse_cache=True, n_real=n)


def compare_pos0(label, spec_outs, seq_outs):
    """The speculative route against the sequential one on the same
    cells: the first generated id and the position-0 readouts bitwise.
    Returns the share of the later generated ids that agree, and per
    branch the share of rows whose ids still all agree up to each
    position (a near-tie flip at one position changes every later id of
    its row)."""
    agree = total = 0
    prefix_agree = {}
    for fmt, a, b in zip(("binary", "confidence"), spec_outs, seq_outs):
        for name in POS0_FIELDS:
            if not torch.equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{label}/{fmt}: {name} is not bitwise "
                                     f"the sequential route's")
        for name in ("p_yes", "p_no", "generated"):
            if not torch.equal(getattr(a, name)[:, 0], getattr(b, name)[:, 0]):
                raise AssertionError(f"{label}/{fmt}: {name}[:, 0] is not "
                                     f"bitwise the sequential route's")
        same = a.generated[:, 1:] == b.generated[:, 1:]
        agree += int(same.sum())
        total += same.numel()
        rows_ok = torch.cumprod((a.generated == b.generated).int(), dim=1)
        prefix_agree[fmt] = rows_ok.float().mean(dim=0).tolist()
    return agree / max(total, 1), prefix_agree


def full_accept_check(params, cfg):
    """generate.greedy_decode_fused_shared_spec given the sequential
    stream as its drafts: the same ids, in ceil(T / k) windows or fewer
    a branch."""
    rng = np.random.default_rng(2)
    B, k, Ta, Tb = 4, 4, 4, 8
    rows = [[int(x) for x in rng.integers(3, 900, 20 + r)] for r in range(B)]
    prefix, prefix_mask = tok.right_pad_ids(rows, 32, 0)
    sfx_a, sfx_a_mask = tok.right_pad_ids([[5, 6]] * B, 8, 0)
    sfx_b, sfx_b_mask = tok.right_pad_ids([[7, 8]] * B, 8, 0)
    def t(a, dt=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=DEV)

    args = (params, cfg, t(prefix), t(prefix_mask), t(sfx_a), t(sfx_a_mask),
            t(sfx_b), t(sfx_b_mask), t([5] * B), t([9] * B), t([10, 11, 12]),
            t([1.0, 2.0, 3.0], torch.float32))
    seq_a, seq_b = generate.greedy_decode_fused_shared(
        *args, max_new_a=Ta, max_new_b=Tb)
    spec_args = []
    for sfx, seq, T in ((sfx_a, seq_a, Ta), (sfx_b, seq_b, Tb)):
        ctx = [r + list(map(int, s[:np.count_nonzero(s)])) for r, s in
               zip(rows, sfx)]
        width = 32 + 8 + T
        c = np.zeros((B, width), np.int32)
        for r, row in enumerate(ctx):
            c[r, :len(row)] = row
        spec_args += [t(c), t([len(r) for r in ctx]), seq.generated,
                      t([T] * B)]
    out_a, out_b, sp_a, sp_b = generate.greedy_decode_fused_shared_spec(
        *args, *spec_args, max_new_a=Ta, max_new_b=Tb, spec_k=k)
    for name, out, seq, sp, T in (("binary", out_a, seq_a, sp_a, Ta),
                                  ("confidence", out_b, seq_b, sp_b, Tb)):
        if not torch.equal(out.generated, seq.generated):
            raise AssertionError(f"full-accept {name}: ids differ from the "
                                 f"sequential stream")
        if int(sp.chunks) > -(-T // k):
            raise AssertionError(f"full-accept {name}: {int(sp.chunks)} "
                                 f"windows for {T} tokens at k = {k}")
    return int(sp_a.chunks), int(sp_b.chunks)


def small_slice_check():
    """The whole slice at a small float32 size: the engine on the card
    (kernels) against the engine on the CPU (plain versions), same
    params, through a cascade dispatch and a speculative one (token ids
    exact, floats within 1e-4); on the card, the speculative dispatch
    against the sequential one (ids exact, position-0 readouts bitwise)
    and a speculative run given the sequential stream as its drafts."""
    cfg = registry.ModelConfig(name="smoke-tiny", vocab_size=1000,
                               hidden_size=128, n_layers=2, n_heads=4,
                               n_kv_heads=2, intermediate_size=256,
                               max_seq_len=512)
    params_cpu = decoder.init_params(cfg, seed=1, device="cpu")
    for name, w in params_cpu["layers"].items():
        if name.startswith("w"):
            w.mul_(4.0)
    params_gpu = _to_device(params_cpu, DEV)
    rt = RuntimeConfig(batch_size=4, max_new_tokens=6)
    rng = np.random.default_rng(0)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    trunk_rows = [head + [int(x) for x in rng.integers(3, 900, 5 + r)]
                  for r in range(4)]
    flat_rows = [[int(x) for x in rng.integers(3, 900, 40 + r)]
                 for r in range(4)]
    outs = []
    for params, dev in ((params_gpu, DEV), (params_cpu, "cpu")):
        eng = ScoringEngine(params, cfg, FakeTokenizer(), rt, device=dev)
        casc = _shared_dispatch(eng, trunk_rows, 96)
        if eng.cascade_stats["cascade_dispatches"] != 1:
            raise AssertionError("small slice did not take the cascade")
        spec = _shared_dispatch(eng, flat_rows, 64)
        if eng.spec_stats["spec_dispatches"] != 1:
            raise AssertionError("small slice did not take the spec route")
        outs.append((casc, spec))
    for route, card, cpu in zip(("cascade", "spec"), *outs):
        for a, b in zip(card, cpu):
            if not torch.equal(a.generated.cpu(), b.generated):
                raise AssertionError(f"small slice {route}: generated ids "
                                     f"differ card vs CPU")
            for name in ("p_yes", "p_no", "topk_logprobs",
                         "weighted_confidence"):
                diff = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
                if not diff <= 1e-4:
                    raise AssertionError(f"small slice {route}: {name} "
                                         f"differs by {diff}")
    seq_eng = ScoringEngine(params_gpu, cfg, FakeTokenizer(),
                            RuntimeConfig(batch_size=4, max_new_tokens=6,
                                          spec_decode=False), device=DEV)
    seq = _shared_dispatch(seq_eng, flat_rows, 64)
    spec_card = outs[0][1]
    agree, _ = compare_pos0("small slice", spec_card, seq)
    if agree != 1.0 or not all(torch.equal(a.generated, b.generated)
                               for a, b in zip(spec_card, seq)):
        raise AssertionError("small slice: spec ids differ from sequential")
    chunks = full_accept_check(params_gpu, cfg)
    int8_diff, int8_launches = small_int8_check(cfg, params_cpu, trunk_rows,
                                                flat_rows)
    log(json.dumps({"phase": "small_slice", "ok": True,
                    "cascade_and_spec_vs_cpu": True,
                    "spec_vs_sequential_bitwise_pos0": True,
                    "full_accept_windows": {"binary": chunks[0],
                                            "confidence": chunks[1]},
                    "int8_vs_cpu_max_float_diff": int8_diff,
                    "int8_launches": int8_launches}))


def small_int8_check(cfg, params_cpu, trunk_rows, flat_rows):
    """The 8-bit engine at the small size: dynamic int8 weights, the
    two-leg cascade with int8 QK^T, flash prefill. On the card against
    the same engine on the CPU: ids exact, floats within INT8_SLICE_TOL.
    Returns the largest float difference and the card's launch counts,
    which must include every kernel of the 8-bit path."""
    cfg8 = dataclasses.replace(cfg, use_flash_attention=True)
    q_cpu = quant.quantize_decoder_params(params_cpu, dynamic=True)
    q_gpu = _to_device(q_cpu, DEV)
    rt = RuntimeConfig(batch_size=4, max_new_tokens=6,
                       cascade_fused_suffix=False)
    outs, launches = [], None
    for params, dev in ((q_gpu, DEV), (q_cpu, "cpu")):
        eng = ScoringEngine(params, cfg8, FakeTokenizer(), rt,
                            cascade_config=CascadeConfig(int8_qk=True),
                            device=dev)
        if dev == DEV:
            torch.cuda.synchronize()
            ops.reset_launches()
        outs.append((_shared_dispatch(eng, trunk_rows, 96),
                     _shared_dispatch(eng, flat_rows, 64)))
        if dev == DEV:
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        if (eng.cascade_stats["cascade_dispatches"] != 1
                or eng.spec_stats["spec_dispatches"] != 1):
            raise AssertionError("8-bit small slice did not route as planned")
    missing = [k for k in ("flash_attention", "cascade_prefix_int8",
                           "flash_decode_trunk", "flash_decode_mq")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"8-bit small slice: never launched {missing}")
    worst = {}
    for route, card, cpu in zip(("cascade", "spec"), *outs):
        for a, b in zip(card, cpu):
            if not torch.equal(a.generated.cpu(), b.generated):
                raise AssertionError(f"8-bit small slice {route}: generated "
                                     f"ids differ card vs CPU")
            for name in ("p_yes", "p_no", "topk_logprobs",
                         "weighted_confidence"):
                diff = float((getattr(a, name).cpu()
                              - getattr(b, name)).abs().max())
                worst[name] = max(worst.get(name, 0.0), diff)
                if not diff <= INT8_SLICE_TOL:
                    raise AssertionError(f"8-bit small slice {route}: {name} "
                                         f"differs by {diff}")
    return worst, launches


def verify_step_check(params, cfg, spec_k: int):
    """At full width in bf16: one decode step and one verify window from
    the same cache, the window's first query the step's token at the
    step's slot (its other positions random drafts). The two compute the
    same function; they differ only in rounding (the projections run as
    products of B * spec_k rows instead of B). Reports the largest
    difference of the position's logits and, for the rows whose argmax
    differs, the step logits' top-1 minus top-2 gap: flips at near-ties
    explain the full-width id disagreement that phase 3 prints."""
    rng = np.random.default_rng(3)
    B, S0 = BATCH, 64
    toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (B, S0)),
                           dtype=torch.int32, device=DEV)
    mask = torch.ones((B, S0), dtype=torch.int32, device=DEV)
    drafts = torch.as_tensor(rng.integers(3, cfg.vocab_size, (B, spec_k - 1)),
                             dtype=torch.int32, device=DEV)
    cm = F.pad(mask, (0, spec_k))
    cm_step, cm_ver = cm.clone(), cm.clone()
    cm_step[:, S0] = 1
    cm_ver[:, S0:] = 1
    with torch.inference_mode():
        logits0, cache, pos = decoder.prefill(params, cfg, toks, mask,
                                              S0 + spec_k)
        tok0 = torch.argmax(logits0, dim=-1).to(torch.int32)
        cache_v = (cache[0].clone(), cache[1].clone())
        step, _ = decoder.decode_step(params, cfg, cache, tok0, pos, S0,
                                      cm_step)
        V, _ = decoder.verify_extend(params, cfg, cache_v,
                                     torch.cat([tok0[:, None], drafts], 1),
                                     cm_ver, S0)
    v0 = V[:, 0]
    top2 = torch.topk(step, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flips = torch.argmax(v0, dim=-1) != torch.argmax(step, dim=-1)
    row = {"phase": "verify_vs_step", "B": B, "S": spec_k,
           "max_abs_logit_diff": float((v0 - step).abs().max()),
           "rows_argmax_differ": int(flips.sum()),
           "max_top2_gap_where_differ": (float(gap[flips].max())
                                         if bool(flips.any()) else None),
           "median_top2_gap": float(gap.median())}
    log(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

def check_scores(name, arrs):
    for key, a in arrs.items():
        a = torch.as_tensor(a).float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite {key}")
    p_yes = torch.as_tensor(arrs["p_yes"]).float()
    p_no = torch.as_tensor(arrs["p_no"]).float()
    for key, p in (("p_yes", p_yes), ("p_no", p_no)):
        if bool(((p < 0) | (p > 1)).any()):
            raise AssertionError(f"{name}: {key} outside [0, 1]")
    if bool((p_yes + p_no > 1 + 1e-5).any()):
        raise AssertionError(f"{name}: p_yes + p_no > 1")


def run_word_meaning(engine, label="word_meaning_sweep",
                     kernels=("flash_decode",)):
    """Word-meaning sweep: 50 D1 rows, 50 decode steps. Launch counts
    reset just before, read just after; fails unless every kernel in
    ``kernels`` launched."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = sweep.run_word_meaning_sweep(
        engine, "llama-2-7b (seeded random weights)", "base",
        WORD_MEANING_QUESTIONS, format_base_prompt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    if len(rows) != len(WORD_MEANING_QUESTIONS):
        raise AssertionError("word-meaning sweep lost rows")
    check_scores(label, {
        "p_yes": [r.yes_prob for r in rows], "p_no": [r.no_prob for r in rows]})
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    stats = dict(rows=len(rows), seconds=dt, rows_per_s=len(rows) / dt,
                 launches=launches)
    log(json.dumps({"phase": label, **stats}))
    return stats


def run_dispatch(label, engine, cells, rt, kernels, routing):
    """One 32-cell shared dispatch through ``decode_fused_shared``, the
    launch counts reset just before and read just after. Fails unless
    every kernel in ``kernels`` launched and every counter in ``routing``
    moved by exactly one."""
    t = engine.tokenizer
    yes = np.asarray([tok.first_token_id(t, " " + a) for _, _, (a, _) in cells],
                     np.int32)
    no = np.asarray([tok.first_token_id(t, " " + b) for _, _, (_, b) in cells],
                    np.int32)
    casc0, spec0 = dict(engine.cascade_stats), dict(engine.spec_stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = engine.decode_fused_shared(
        [c[0] for c in cells], [c[1] for c in cells], yes, no,
        new_tokens=rt.sweep_decode_tokens,
        conf_tokens=rt.sweep_confidence_tokens, reuse_cache=True,
        n_real=len(cells))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    engine.spec_flush()
    moved = {k: v - casc0.get(k, 0) for k, v in engine.cascade_stats.items()
             if v != casc0.get(k, 0)}
    spec = {k: v - spec0.get(k, 0) for k, v in engine.spec_stats.items()
            if v != spec0.get(k, 0)}
    for out, fmt in zip(outs, ("binary", "confidence")):
        check_scores(f"{label}/{fmt}", {
            "p_yes": out.p_yes, "p_no": out.p_no,
            "topk_logprobs": out.topk_logprobs,
            "weighted_confidence": out.weighted_confidence})
        if out.generated.shape[0] != len(cells):
            raise AssertionError(f"{label}: wrong batch")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    wrong = {k: moved.get(k, spec.get(k, 0)) for k in routing
             if moved.get(k, spec.get(k, 0)) != 1}
    if wrong:
        raise AssertionError(f"{label}: routing counters {wrong}, expected 1")
    stats = dict(rows=len(cells), ms_per_dispatch=dt * 1e3,
                 rows_per_s=len(cells) / dt, routing=moved, spec_stats=spec,
                 launches=launches)
    log(json.dumps({"phase": label, **stats}))
    return outs, stats


def compare_two_leg(two_leg, fused):
    """The two-leg cascade dispatch against the fused one on the same
    cells: every row's position-0 yes>no decision equal, the position-0
    probabilities within POS0_PROB_ATOL; the largest differences of the
    position-0 readouts are printed beside them."""
    row = {"phase": "two_leg_vs_fused", "decisions_equal": True}
    for fmt, a, b in zip(("binary", "confidence"), two_leg, fused):
        da = a.p_yes[:, 0] > a.p_no[:, 0]
        db = b.p_yes[:, 0] > b.p_no[:, 0]
        margin = (torch.log(b.p_yes[:, 0]) - torch.log(b.p_no[:, 0])).abs()
        row[f"{fmt}_min_abs_log_odds"] = float(margin.min())
        if not torch.equal(da, db):
            row["decisions_equal"] = False
            log(json.dumps(row))
            raise AssertionError(f"two-leg vs fused {fmt}: yes>no decision "
                                 f"differs on rows "
                                 f"{torch.nonzero(da != db).flatten().tolist()}")
        for name in ("p_yes", "p_no"):
            diff = float((getattr(a, name)[:, 0]
                          - getattr(b, name)[:, 0]).abs().max())
            row[f"{fmt}_{name}0_max_diff"] = diff
            if not diff <= POS0_PROB_ATOL:
                raise AssertionError(f"two-leg vs fused {fmt}: {name}[:, 0] "
                                     f"differs by {diff}")
        row[f"{fmt}_topk_logprobs_max_diff"] = float(
            (a.topk_logprobs - b.topk_logprobs).abs().max())
        row[f"{fmt}_weighted_confidence_max_diff"] = float(
            (a.weighted_confidence - b.weighted_confidence).abs().max())
        row[f"{fmt}_generated_ids_agree_share"] = float(
            (a.generated == b.generated).float().mean())
    log(json.dumps(row))
    return row


def run_int8_slice(cfg, tokenizer, cells_trunk, cells_flat, rt):
    """The 8-bit engine at llama-2-7b width: dynamic int8 weights born on
    the card, flash prefill, the two-leg cascade with int8 QK^T. Its
    phases: the word-meaning sweep, the trunk dispatch and the no-trunk
    dispatch, each with its own launch counts. Returns (per-phase stats,
    param bytes, peak memory over these phases)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params8 = quant.init_quantized_params(cfg, seed=0, device=DEV,
                                          dtype=torch.bfloat16, dynamic=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg8 = dataclasses.replace(cfg, use_flash_attention=True)
    engine8 = ScoringEngine(
        params8, cfg8, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_fused_suffix=False),
        cascade_config=CascadeConfig(int8_qk=True), device=DEV)
    stats = {"int8_word_meaning": run_word_meaning(
        engine8, "int8_word_meaning_sweep",
        ("flash_attention", "flash_decode"))}
    _, stats["int8_cascade_dispatch"] = run_dispatch(
        "int8_cascade_dispatch", engine8, cells_trunk, rt,
        ("cascade_prefix_int8", "flash_decode_trunk"),
        ("cascade_dispatches", "cascade_decode_dispatches"))
    _, stats["int8_spec_dispatch"] = run_dispatch(
        "int8_spec_dispatch", engine8, cells_flat, rt,
        ("flash_attention", "flash_decode_mq"), ("spec_dispatches",))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile_scoring(engine8, rt, "int8_profile")
    nbytes8 = quant.param_bytes(params8)
    log(json.dumps({"phase": "int8_slice", "init_seconds": init_s,
                    "param_bytes": nbytes8,
                    "max_memory_allocated_bytes": peak}))
    del engine8, params8
    torch.cuda.empty_cache()
    return stats, nbytes8, peak


def run_slice(params, cfg, tokenizer, engine, cells_trunk, cells_flat, rt):
    """Phase 3: every path of the slice at full width, each with its own
    launch counts. Returns (per-phase stats, launches summed over the
    phases)."""
    seq_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, spec_decode=False,
                      cascade_prefill=False), device=DEV)
    spec_trunk_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_prefill=False), device=DEV)
    two_leg_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_fused_suffix=False),
        device=DEV)
    stats = {"word_meaning": run_word_meaning(engine)}
    fused_out, stats["cascade_dispatch"] = run_dispatch(
        "cascade_dispatch", engine, cells_trunk, rt,
        ("cascade_attention", "flash_decode_trunk"),
        ("cascade_dispatches", "cascade_decode_dispatches"))
    two_leg_out, stats["two_leg_cascade_dispatch"] = run_dispatch(
        "two_leg_cascade_dispatch", two_leg_engine, cells_trunk, rt,
        ("cascade_prefix", "flash_decode_trunk"),
        ("cascade_dispatches", "cascade_decode_dispatches"))
    if stats["two_leg_cascade_dispatch"]["launches"]["cascade_attention"]:
        raise AssertionError("two-leg dispatch launched the fused kernel")
    stats["two_leg_cascade_dispatch"]["vs_fused"] = compare_two_leg(
        two_leg_out, fused_out)
    seq_out, stats["sequential_dispatch"] = run_dispatch(
        "sequential_dispatch", seq_engine, cells_flat, rt, ("flash_decode",),
        ("dense_shared_dispatches",))
    spec_out, stats["spec_dispatch"] = run_dispatch(
        "spec_dispatch", engine, cells_flat, rt, ("flash_decode_mq",),
        ("spec_dispatches",))
    seq_t_out, stats["sequential_trunk_dispatch"] = run_dispatch(
        "sequential_trunk_dispatch", seq_engine, cells_trunk, rt,
        ("flash_decode_trunk",),
        ("dense_shared_dispatches", "cascade_decode_dispatches"))
    spec_t_out, stats["spec_trunk_dispatch"] = run_dispatch(
        "spec_trunk_dispatch", spec_trunk_engine, cells_trunk, rt,
        ("flash_decode_mq_trunk",),
        ("spec_dispatches", "cascade_decode_dispatches"))
    for label, spec, seq in (("spec_dispatch", spec_out, seq_out),
                             ("spec_trunk_dispatch", spec_t_out, seq_t_out)):
        agree, by_position = compare_pos0(label, spec, seq)
        stats[label]["later_ids_agree_share"] = agree
        log(json.dumps({"phase": f"{label}_vs_sequential",
                        "position0_bitwise": True,
                        "later_ids_agree_share": agree,
                        "rows_agreeing_through_position": by_position}))
    total = {name: sum(st["launches"][name] for st in stats.values())
             for name in ops.KERNELS}
    return stats, total


def profile_scoring(engine, rt, label="profile"):
    """Where one word-meaning batch's time goes: a torch.profiler trace
    of ``decode_fused`` (prefill + the 50 greedy steps) at B = 32. The
    device-busy time is the union of the CUDA kernel intervals; it is
    set against the same call's host-clock time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    prompts = [format_base_prompt(q) for q in WORD_MEANING_QUESTIONS[:BATCH]]
    yes = np.full(BATCH, engine.yes_id, np.int32)
    no = np.full(BATCH, engine.no_id, np.int32)

    def call():
        engine.decode_fused(prompts, yes, no)
        torch.cuda.synchronize()

    call()
    t0 = time.perf_counter()
    call()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(json.dumps({"phase": label, "device_busy": "not measured",
                        "wall_ms": wall * 1e3}))
        return
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(json.dumps({
        "phase": label, "call": "decode_fused, B=32, 50 steps",
        "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / 1e3 / (wall * 1e3),
        "kernel_launches": len(kernels),
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top}}))


def kernel_label(mangled: str) -> str:
    """A kernel's name and raw template arguments from its mangled name,
    e.g. ``prefix_mma_kernel<Li128>``."""
    # Every start of a digit run: a length prefix may follow other digits
    # (an anonymous namespace's hash ends in digits).
    for m in re.finditer(r"(?=(\d+))", mangled):
        for n in range(len(m.group(1)), 0, -1):
            end = m.start() + n
            name = mangled[end:end + int(m.group(1)[:n])]
            if name.endswith("kernel") and name.isidentifier():
                args = re.match(r"I(.*?)EE", mangled[end + len(name):])
                return f"{name}<{args.group(1)}>" if args else name
    return mangled


def ptxas_report(name: str, text: str):
    """The register, shared-memory and spill lines of one build's ptxas
    report, each with the kernel it belongs to."""
    kernel = "?"
    for line in text.splitlines():
        found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if found:
            kernel = kernel_label(found.group(1))
        elif "registers" in line or "smem" in line or "spill" in line:
            log(f"ptxas[{name}] {kernel}: {line.strip()}")


def tensor_core_counts(name: str, kernels) -> dict:
    """Tensor-core instructions (HMMA, or HGMMA for wgmma) in each
    instantiation of ``kernels`` in the built library of ``csrc/<name>.cu``,
    counted in its ``cuobjdump -sass``. Fails if any has none."""
    counts, fn = {}, None
    for line in _build.sass(name).splitlines():
        found = re.search(r"Function : (\w+)", line)
        if found:
            fn = kernel_label(found.group(1))
            if any(k in fn for k in kernels):
                counts[fn] = 0
        elif fn in counts and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    log(json.dumps({"phase": "sass", "source": f"{name}.cu",
                    "tensor_core_instructions": counts}))
    missing = [k for k in kernels if not any(k in fn for fn in counts)]
    if missing or min(counts.values()) == 0:
        raise AssertionError(f"{name}: no tensor-core instructions in some "
                             f"of {kernels}: {counts}")
    return counts


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card, "| torch", torch.__version__, "cuda", torch.version.cuda)

    # Phase 1: build.
    t0 = time.perf_counter()
    secs = _build.build()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_seconds": secs}))
    for name, text in _build.BUILD_LOGS.items():
        ptxas_report(name, text)
    # The bf16 cascade kernels run on tensor cores: HMMA in their SASS.
    tensor_core_counts("cascade_prefill",
                       ("cascade_mma_kernel", "prefix_mma_kernel"))
    tensor_core_counts("flash_attention", ("flash_mma_kernel",))

    # Phase 3's shapes, planned up front.
    cfg = registry.llama2_7b()
    rt = RuntimeConfig(batch_size=BATCH)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init_params", "seconds": time.perf_counter() - t0,
                    "param_bytes": quant.param_bytes(params)}))
    tokenizer = FakeTokenizer(vocab=cfg.vocab_size)
    engine = ScoringEngine(params, cfg, tokenizer, rt, device="cuda")
    cells_trunk, cells_flat = legal_cells(True), legal_cells(False)
    plan_t = plan_shared(engine, cells_trunk, rt)
    plan_f = plan_shared(engine, cells_flat, rt)
    dtrunk = engine.decode_trunk_for(plan_t["prefix_rows"], BATCH,
                                     plan_t["bucket"])
    wm_len = max(len(tokenizer(format_base_prompt(q)).input_ids)
                 for q in WORD_MEANING_QUESTIONS)
    wm_T = tok.pick_bucket([wm_len], engine.buckets) + rt.max_new_tokens
    keys = ("bucket", "trunk", "T0", "T_spec")
    log(json.dumps({"phase": "plan", "cascade": {k: plan_t[k] for k in keys},
                    "dense": {k: plan_f[k] for k in keys},
                    "spec_decode_trunk": dtrunk, "word_meaning_T": wm_T}))
    if not plan_t["trunk"] or plan_f["trunk"] or dtrunk != plan_t["trunk"]:
        raise AssertionError(f"unexpected trunk plan {plan_t} / {plan_f}")

    # Phase 2: each kernel against its plain version on the card.
    warm_up()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    results = []
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T0, trunk = plan_t["T0"], plan_t["trunk"]
    check_decode(gen, "llama2-7b/cascade-dispatch", BATCH, H, K, hd, T0, trunk,
                 False, results)
    check_decode(gen, "llama2-7b/word-meaning", BATCH, H, K, hd, wm_T, 0,
                 False, results)
    check_decode(gen, "llama2-7b/dense-dispatch", BATCH, H, K, hd,
                 plan_f["T0"], 0, False, results)
    check_decode(gen, "mistral-7b/gqa", BATCH, 32, 8, 128, T0, trunk, False,
                 results)
    check_decode(gen, "falcon-7b/mqa", BATCH, 71, 1, 64, T0, trunk, False,
                 results)
    check_decode(gen, "bloom-7b1/alibi", BATCH, 32, 32, 128, T0, trunk, True,
                 results)
    S, Ts, Tf = rt.spec_k, plan_t["T_spec"], plan_f["T_spec"]
    # The untrunked spec dispatch has no trunk; its shape checks the trunk
    # kernel against the flat one at half its extent.
    check_decode_mq(gen, "llama2-7b/spec-dispatch", BATCH, S, H, K, hd, Tf,
                    DECODE_SPLIT * max(1, Tf // 2 // DECODE_SPLIT), False,
                    results)
    check_decode_mq(gen, "llama2-7b/spec-trunk-dispatch", BATCH, S, H, K, hd,
                    Ts, dtrunk, False, results)
    check_decode_mq(gen, "mistral-7b/gqa", BATCH, S, 32, 8, 128, Ts, dtrunk,
                    False, results)
    check_decode_mq(gen, "falcon-7b/mqa", BATCH, S, 71, 1, 64, Ts, dtrunk,
                    False, results)
    check_decode_mq(gen, "bloom-7b1/alibi", BATCH, S, 32, 32, 128, Ts, dtrunk,
                    True, results)
    R = plan_t["bucket"] - trunk
    check_cascade(gen, "llama2-7b/cascade-dispatch", BATCH, R, H, K, hd, trunk,
                  False, results)
    check_cascade(gen, "mistral-7b/gqa", BATCH, R, 32, 8, 128, trunk, False,
                  results)
    check_cascade(gen, "falcon-7b/mqa", BATCH, R, 71, 1, 64, trunk, False,
                  results)
    check_cascade(gen, "bloom-7b1/alibi", BATCH, R, 32, 32, 128, trunk, True,
                  results)
    check_prefix(gen, "llama2-7b/cascade-dispatch", BATCH, R, H, K, hd, trunk,
                 False, results)
    check_prefix(gen, "mistral-7b/gqa", BATCH, R, 32, 8, 128, trunk, False,
                 results)
    check_prefix(gen, "falcon-7b/mqa", BATCH, R, 71, 1, 64, trunk, False,
                 results)
    check_prefix(gen, "bloom-7b1/alibi", BATCH, R, 32, 32, 128, trunk, True,
                 results)
    Sf = plan_f["bucket"]
    for label, S in (("word-meaning", wm_T - rt.max_new_tokens),
                     ("spec-dispatch", Sf), ("bucket-512", 512)):
        check_flash_attention(gen, f"llama2-7b/{label}", BATCH, S, H, K, hd,
                              False, results)
    check_flash_attention(gen, "mistral-7b/gqa", BATCH, Sf, 32, 8, 128, False,
                          results)
    check_flash_attention(gen, "falcon-7b/mqa", BATCH, Sf, 71, 1, 64, False,
                          results)
    check_flash_attention(gen, "bloom-7b1/alibi", BATCH, Sf, 32, 32, 128, True,
                          results)
    small_slice_check()
    verify_step_check(params, engine.cfg, rt.spec_k)

    # Phase 3: the slice at full width through the engines.
    torch.cuda.reset_peak_memory_stats()
    stats, launches = run_slice(params, cfg, tokenizer, engine, cells_trunk,
                                cells_flat, rt)
    bf16_peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"phase": "slice", "launches": launches,
                    "max_memory_allocated_bytes": bf16_peak}))
    profile_scoring(engine, rt)
    stats8, bytes8, peak8 = run_int8_slice(cfg, tokenizer, cells_trunk,
                                           cells_flat, rt)
    for st in stats8.values():
        for name, n in st["launches"].items():
            launches[name] += n
    log(json.dumps({
        "phase": "int8_vs_bf16",
        "param_bytes": {"bf16": quant.param_bytes(params),
                        "int8": bytes8},
        "max_memory_allocated_bytes": {"bf16_phases": bf16_peak,
                                       "int8_phases_both_param_sets": peak8},
        "rows_per_s": {
            "word_meaning": [stats["word_meaning"]["rows_per_s"],
                             stats8["int8_word_meaning"]["rows_per_s"]],
            "cascade_dispatch": [stats["cascade_dispatch"]["rows_per_s"],
                                 stats8["int8_cascade_dispatch"]["rows_per_s"]],
            "spec_dispatch": [stats["spec_dispatch"]["rows_per_s"],
                              stats8["int8_spec_dispatch"]["rows_per_s"]]},
        "ms_per_dispatch": {
            "cascade_dispatch": [stats["cascade_dispatch"]["ms_per_dispatch"],
                                 stats8["int8_cascade_dispatch"]["ms_per_dispatch"]],
            "spec_dispatch": [stats["spec_dispatch"]["ms_per_dispatch"],
                              stats8["int8_spec_dispatch"]["ms_per_dispatch"]]},
        "order": ["bf16", "int8"]}))
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # Summary: each kernel at its main-path shape.
    kernels = []
    for name, (source, replaces, case) in SOURCES.items():
        rows = [r for r in results if r["kernel"] == name]
        main_row = next(r for r in rows if r["case"] == case)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, quant.QuantTensor):
        return quant.QuantTensor(q=tree.q.to(device),
                                 scale=tree.scale.to(device),
                                 dynamic=tree.dynamic)
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
