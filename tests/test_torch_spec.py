"""The port's speculative verify path against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function
and through the port on CPU tensors (the port's kernels then run their
plain PyTorch versions). The JAX side runs its multi-query Pallas
kernels in the interpreter: ``decoder.FUSED_DECODE_INTERPRET_ON_CPU`` is
armed for each test and restored after, so their arithmetic is the
oracle. Tolerances, float32 throughout:

- ops: atol 1e-5 against JAX (the two sum in different orders: the JAX
  kernels merge split partials, the plain versions take one softmax over
  all keys); query j of ``flash_decode_mq`` against the port's own
  ``flash_decode`` atol 1e-6;
- decoder: logits atol 1e-5, the written cache slots atol 1e-5;
- generate and engine: discrete outputs exact, ``SpecOut`` exact,
  floats 1e-5 (``_compare_fused``); the port's spec path against the
  port's sequential path: ids and position-0 readouts bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.ops.flash_decode import flash_decode_mq as jax_mq
from lir_tpu.ops.flash_decode import flash_decode_mq_trunk as jax_mq_trunk
from lir_tpu_torch import ops
from lir_tpu_torch.models.decoder import alibi_slopes
from lir_tpu_torch.ops.flash_decode import DECODE_SPLIT, trunk_splits

OPS_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _setup():
    from lir_tpu.models import decoder as jdec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = (jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU)
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    jdec.CASCADE_INTERPRET_ON_CPU = True
    yield
    jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU = old


# ---------------------------------------------------------------------------
# ops: flash_decode_mq, flash_decode_mq_trunk
# ---------------------------------------------------------------------------

MQ_CASES = {
    "mha": dict(H=4, K=4),
    "gqa": dict(H=8, K=2),
    "mqa": dict(H=4, K=1),
    "alibi": dict(H=4, K=4, alibi=True),
    "ragged": dict(H=4, K=2, ragged=True),
}


def _mq_inputs(seed, B, S, H, K, T, hd=16, ragged=False, trunk_len=0):
    """A verify window's inputs: the cache's last S valid slots hold the
    window, each query at its own position; ragged masks leave gaps
    (rejected slots of earlier windows) and right-padded prefixes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((K, T, B, hd)).astype(np.float32)
    v = rng.standard_normal((K, T, B, hd)).astype(np.float32)
    if trunk_len:
        k[:, :trunk_len] = k[:, :trunk_len, :1]
        v[:, :trunk_len] = v[:, :trunk_len, :1]
    mask = np.ones((B, T), np.int32)
    mask[:, T - 5:] = 0                        # window slots not yet used
    if ragged:
        for b in range(B):
            lo = max(trunk_len, T // 2) + 3 * b
            mask[b, lo:lo + 4 + 2 * b] = 0
    kpos = np.maximum(np.cumsum(mask, axis=-1) - 1, 0).astype(np.int32)
    top = kpos.max(axis=-1)
    qpos = (top[:, None] - (S - 1) + np.arange(S)[None, :]).astype(np.int32)
    return q, k, v, qpos, mask, kpos


def _both(arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("name", sorted(MQ_CASES))
def test_flash_decode_mq_matches_jax_and_single_query(name, S):
    case = dict(MQ_CASES[name])
    alibi = case.pop("alibi", False)
    arrays = _mq_inputs(0, 3, S, T=150, **case)
    (jq, jk, jv, jqp, jm, jkp), (tq, tk, tv, tqp, tm, tkp) = _both(arrays)
    slopes = alibi_slopes(case["H"]) if alibi else None
    jsl = None if slopes is None else jnp.asarray(slopes.numpy())
    ref = jax_mq(jq, jk, jv, jqp, jm, key_positions=jkp, alibi_slopes=jsl,
                 block_k=16, interpret=True)
    got = ops.flash_decode_mq(tq, tk, tv, tqp, tm, key_positions=tkp,
                              alibi_slopes=slopes)
    assert got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS_TOL)
    for j in range(S):
        one = ops.flash_decode(tq[:, j].contiguous(), tk, tv,
                               tqp[:, j].contiguous(), tm, key_positions=tkp,
                               alibi_slopes=slopes)
        np.testing.assert_allclose(got[:, j].numpy(), one.numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("trunk_len", [40, 64, 130])
@pytest.mark.parametrize("name", ["mha", "gqa", "mqa", "alibi", "ragged"])
def test_flash_decode_mq_trunk_matches_jax_and_flat(name, trunk_len):
    """Trunk extents below one split (the mq passthrough), on a split
    edge and off one."""
    case = dict(MQ_CASES[name])
    alibi = case.pop("alibi", False)
    T = 200
    arrays = _mq_inputs(1, 3, 3, T=T, trunk_len=trunk_len, **case)
    (jq, jk, jv, jqp, jm, jkp), (tq, tk, tv, tqp, tm, tkp) = _both(arrays)
    assert (trunk_splits(trunk_len, T) > 0) == (trunk_len >= DECODE_SPLIT)
    slopes = alibi_slopes(case["H"]) if alibi else None
    jsl = None if slopes is None else jnp.asarray(slopes.numpy())
    ref = jax_mq_trunk(jq, jk, jv, jqp, jm, key_positions=jkp,
                       alibi_slopes=jsl, trunk_len=trunk_len, block_k=16,
                       interpret=True)
    got = ops.flash_decode_mq_trunk(tq, tk, tv, tqp, tm, key_positions=tkp,
                                    alibi_slopes=slopes, trunk_len=trunk_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS_TOL)
    flat = ops.flash_decode_mq(tq, tk, tv, tqp, tm, key_positions=tkp,
                               alibi_slopes=slopes)
    assert torch.equal(got, flat)


# ---------------------------------------------------------------------------
# decoder: verify_extend
# ---------------------------------------------------------------------------

def _decoder_pair(family):
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models import registry as jreg
    from lir_tpu_torch.models import registry as treg
    from lir_tpu_torch.models.convert import params_from_jax

    cfg_j, cfg_t = jreg.tiny(family), treg.tiny(family)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"))


@pytest.mark.parametrize("trunk_len", [0, 64])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("family", ["mistral", "falcon", "bloom"])
def test_verify_extend_matches_jax(family, fused, trunk_len):
    from lir_tpu.models import decoder as jdec
    from lir_tpu_torch.models import decoder as tdec

    cfg_j, pj, cfg_t, pt = _decoder_pair(family)
    cfg_j = dataclasses.replace(cfg_j, fused_decode=fused, cascade_decode=True)
    cfg_t = dataclasses.replace(cfg_t, fused_decode=fused, cascade_decode=True)
    rng = np.random.default_rng(2)
    B, T, S, base = 3, 110, 4, 90
    L, K, hd = cfg_t.n_layers, cfg_t.n_kv_heads, cfg_t.head_dim
    ck = rng.standard_normal((L, K, T, B, hd)).astype(np.float32)
    cv = rng.standard_normal((L, K, T, B, hd)).astype(np.float32)
    if trunk_len:
        ck[:, :, :trunk_len] = ck[:, :, :trunk_len, :1]
        cv[:, :, :trunk_len] = cv[:, :, :trunk_len, :1]
    mask = np.zeros((B, T), np.int32)
    for b in range(B):
        mask[b, :70 + 4 * b] = 1                      # right-padded prefixes
        mask[b, 80:82 + b] = 1                        # an earlier window
    mask[:, base:base + S] = 1                        # this window
    toks = rng.integers(3, cfg_t.vocab_size, (B, S)).astype(np.int32)
    lj, (kj, vj) = jdec.verify_extend(
        pj, cfg_j, (jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(toks),
        jnp.asarray(mask), base, trunk_len=trunk_len)
    cache_t = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    lt, (kt, vt) = tdec.verify_extend(pt, cfg_t, cache_t,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(mask), base,
                                      trunk_len=trunk_len)
    assert lt.shape == (B, S, cfg_t.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=0)
    window = slice(base, base + S)
    for a, b in ((kj, kt), (vj, vt)):
        np.testing.assert_allclose(b[:, :, window].numpy(),
                                   np.asarray(a)[:, :, window], atol=1e-5,
                                   rtol=0)
    # In place: the port wrote the window into the tensors it was given.
    assert kt is cache_t[0] and vt is cache_t[1]


# ---------------------------------------------------------------------------
# generate: greedy_decode_fused_shared_spec at given drafts
# ---------------------------------------------------------------------------

from test_torch_engine import CFG, WEIGHT_SCALE, _compare_fused  # noqa: E402

BUCKET, SFX, TA, TB, SPEC_K = 32, 8, 4, 8, 4


@pytest.fixture(scope="module")
def models():
    """The engine-tiny model (2 layers, hidden 64, H = 4, K = 2) with the
    JAX init scaled up so no two candidate tokens sit within float noise,
    as JAX params and as the port's CPU params."""
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models.registry import ModelConfig as JaxModelConfig
    from lir_tpu_torch.models.convert import params_from_jax
    from lir_tpu_torch.models.registry import ModelConfig

    cfg_j = JaxModelConfig(**CFG)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    cfg_t = ModelConfig(**CFG)
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"), tree)


def _rows(seed, B=3, plen=24):
    """Distinct prompt tokens, so the n-gram drafter finds no accidental
    matches unless a test plants one."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(8, CFG["vocab_size"]), size=(B, plen + 2 * 4),
                     replace=False)
    prefixes = [list(map(int, ids[r, :plen - r])) for r in range(B)]
    sfx_a = [list(map(int, ids[r, plen:plen + 4 - r % 2])) for r in range(B)]
    sfx_b = [list(map(int, ids[r, plen + 4:])) for r in range(B)]
    return prefixes, sfx_a, sfx_b


def _shared_arrays(prefixes, sfx_a, sfx_b):
    from lir_tpu_torch.engine import tokens as tok

    prefix, prefix_mask = tok.right_pad_ids(prefixes, BUCKET, 0)
    a, a_mask = tok.right_pad_ids(sfx_a, SFX, 0)
    b, b_mask = tok.right_pad_ids(sfx_b, SFX, 0)
    B = len(prefixes)
    return (prefix, prefix_mask, a, a_mask, b, b_mask,
            np.full((B,), 7, np.int32), np.full((B,), 9, np.int32),
            np.arange(10, 16, dtype=np.int32),
            # Digit values 0..5: the weighted confidence scales the two
            # frameworks' rounding by the values, and atol is absolute.
            np.arange(6, dtype=np.float32))


def _spec_arrays(prefixes, sfx_a, sfx_b, draft_a=None, draft_b=None,
                 plant=False):
    """The drafting arrays. With ``plant``, the drafts are not given but
    planted in the n-gram drafter's context instead: each row's context
    opens with its own last token followed by the draft, so the drafter
    finds the draft after the row's last token and the emission."""
    B = len(prefixes)

    def ctx_of(sfx, budget, planted):
        ctx = np.zeros((B, BUCKET + SFX + 1 + budget), np.int32)
        lens = np.zeros((B,), np.int32)
        for r, row in enumerate(p + s for p, s in zip(prefixes, sfx)):
            if planted is not None:
                row = [row[-1]] + [int(x) for x in planted[r]] + row
            ctx[r, :len(row)] = row
            lens[r] = len(row)
        return ctx, lens

    def drafts(d, budget):
        toks = np.zeros((B, budget), np.int32)
        lens = np.zeros((B,), np.int32)
        if d is not None:
            toks[:] = np.asarray(d)[:, :budget]
            lens[:] = budget
        return toks, lens

    if plant:
        return (*ctx_of(sfx_a, TA, draft_a), *drafts(None, TA),
                *ctx_of(sfx_b, TB, draft_b), *drafts(None, TB))

    return (*ctx_of(sfx_a, TA, None), *drafts(draft_a, TA),
            *ctx_of(sfx_b, TB, None), *drafts(draft_b, TB))


def _run_pair(models, shared, spec=None, stops=None):
    """The JAX and the port's shared dispatch on the same arrays:
    sequential without ``spec``, speculative with it."""
    from lir_tpu.engine import generate as jgen
    from lir_tpu_torch.engine import generate as tgen

    cfg_j, pj, cfg_t, pt, _ = models
    jstops, tstops = {}, {}
    if stops is not None:
        table, eos = stops
        jstops = dict(stop_mask_a=jnp.asarray(table),
                      stop_mask_b=jnp.asarray(table), eos_id=jnp.int32(eos))
        tstops = dict(stop_mask_a=torch.from_numpy(table),
                      stop_mask_b=torch.from_numpy(table), eos_id=eos)
    jargs = [jnp.asarray(a) for a in shared]
    targs = [torch.from_numpy(np.asarray(a)) for a in shared]
    kw = dict(max_new_a=TA, max_new_b=TB)
    if spec is None:
        out_j = jgen.greedy_decode_fused_shared(pj, cfg_j, *jargs, **kw,
                                                **jstops)
        out_t = tgen.greedy_decode_fused_shared(pt, cfg_t, *targs, **kw,
                                                **tstops)
        return jax.device_get(out_j), out_t
    out_j = jgen.greedy_decode_fused_shared_spec(
        pj, cfg_j, *jargs, *(jnp.asarray(a) for a in spec), **kw,
        spec_k=SPEC_K, **jstops)
    out_t = tgen.greedy_decode_fused_shared_spec(
        pt, cfg_t, *targs, *(torch.from_numpy(a) for a in spec), **kw,
        spec_k=SPEC_K, **tstops)
    return jax.device_get(out_j), out_t


def _check_spec(models, case_rows, draft_fn, stops=None, plant=False):
    """Spec against JAX (SpecOut exact, outputs by _compare_fused) and
    against the port's own sequential path (ids and position-0 readouts
    bitwise). Returns the port's SpecOut pair and sequential outputs."""
    prefixes, sa, sb = case_rows
    shared = _shared_arrays(prefixes, sa, sb)
    _, (seq_a, seq_b) = _run_pair(models, shared, stops=stops)
    da, db = draft_fn(seq_a.generated.numpy(), seq_b.generated.numpy())
    spec = _spec_arrays(prefixes, sa, sb, da, db, plant=plant)
    (ja, jb, jsa, jsb), (ta, tb, tsa, tsb) = _run_pair(models, shared, spec,
                                                       stops)
    for js, ts in ((jsa, tsa), (jsb, tsb)):
        for f in ("drafted", "accepted", "chunks", "seq_steps"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ts, f).numpy(), err_msg=f)
    _compare_fused(ja, ta)
    _compare_fused(jb, tb)
    for spec_out, seq_out in ((ta, seq_a), (tb, seq_b)):
        for f in ("generated", "top2_ids", "topk_logprobs", "topk_ids",
                  "weighted_confidence"):
            assert torch.equal(getattr(spec_out, f), getattr(seq_out, f)), f
        for f in ("p_yes", "p_no"):
            assert torch.equal(getattr(spec_out, f)[:, 0],
                               getattr(seq_out, f)[:, 0]), f
    return (tsa, tsb), (seq_a, seq_b)


V_ = CFG["vocab_size"]
DRAFTS = {
    "zero_accept": lambda a, b: ((a + 1) % V_, (b + 1) % V_),
    "full_accept": lambda a, b: (a, b),
    "ragged": lambda a, b: (np.where(np.arange(len(a))[:, None] == 1,
                                     (a + 3) % V_, a),
                            np.where(np.arange(len(b))[:, None] == 1,
                                     (b + 3) % V_, b)),
}


@pytest.mark.parametrize("case", sorted(DRAFTS))
def test_spec_decode_matches_jax_and_sequential(models, case):
    (_, sp_b), _ = _check_spec(models, _rows(11), DRAFTS[case])
    accepted = int(sp_b.accepted.sum())
    # Given drafts cover the whole budget: every draft is from lane 0.
    assert int(sp_b.drafted[0]) == int(sp_b.drafted.sum()) > 0
    if case == "zero_accept":
        assert accepted == 0
        assert int(sp_b.chunks) == int(sp_b.seq_steps) == TB
    elif case == "full_accept":
        assert accepted == int(sp_b.drafted.sum()) > 0
        assert int(sp_b.chunks) == -(-TB // SPEC_K)
    else:
        assert 0 < accepted < int(sp_b.drafted.sum())


def test_ngram_drafts_match_jax(models):
    """No given drafts: the n-gram drafter drafts alone (lane 1), from a
    context planted with the sequential stream, so its drafts land."""
    (_, sp_b), _ = _check_spec(models, _rows(13), DRAFTS["full_accept"],
                               plant=True)
    assert int(sp_b.drafted[1]) == int(sp_b.drafted.sum()) > 0
    assert 0 < int(sp_b.accepted[1]) == int(sp_b.accepted.sum())
    assert int(sp_b.chunks) < TB


@pytest.mark.parametrize("digit_stop", [False, True])
def test_spec_stop_inside_draft_window(models, digit_stop):
    """A stop rule that triggers inside a draft window: EOS is the
    confidence branch's step-1 emission of row 0; with the digit stop,
    every row's step-0 emission opens a standalone digit run."""
    rows = _rows(12)
    shared = _shared_arrays(*rows)
    _, (_, free_b) = _run_pair(models, shared)
    gen = free_b.generated.numpy()
    eos = int(gen[0, 1])
    table = np.zeros((V_,), np.int32)
    if digit_stop:
        from lir_tpu_torch.engine import tokens as tok

        for t in gen[:, 0]:
            table[int(t)] = tok.STOP_PURE | tok.STOP_PREFIX | tok.STOP_ENDS_WORD
    (_, sp_b), (_, seq_b) = _check_spec(models, rows, DRAFTS["full_accept"],
                                        stops=(table, eos))
    assert bool((seq_b.generated[0] == eos).any())     # the stop engaged
    assert int(sp_b.chunks) <= int(sp_b.seq_steps) + 1


# ---------------------------------------------------------------------------
# engine: routing of decode_fused_shared
# ---------------------------------------------------------------------------

from test_torch_engine import _dispatch  # noqa: E402

SPEC_FIELDS = ("drafted_tokens", "accepted_tokens", "draft_ngram",
               "accepted_ngram", "decode_forwards", "seq_forwards")


def _engines(models, **rt):
    """A JAX engine (speculation on, piggybacking and the prefix cache
    off) and the port's CPU engine, with the same runtime flags."""
    from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
    from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
    from lir_tpu.engine.runner import ScoringEngine as JaxEngine
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine

    cfg_j, pj, cfg_t, pt, _ = models
    jrt = dict(spec_decode=True, spec_k=SPEC_K, piggyback_prefill=False,
               prefix_cache=False)
    jeng = JaxEngine(pj, cfg_j, JaxFakeTokenizer(), JaxRuntimeConfig(
        batch_size=4, max_new_tokens=12, **{**jrt, **rt}))
    teng = ScoringEngine(pt, cfg_t, FakeTokenizer(),
                         RuntimeConfig(batch_size=4, max_new_tokens=12, **rt),
                         device="cpu")
    return jeng, teng


def _trunk_rows(seed):
    rng = np.random.default_rng(seed)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    return [head + [int(x) for x in rng.integers(3, 900, 6 - (r % 3))]
            for r in range(4)]


def _check_spec_engine(jeng, teng, rows, bucket):
    out_j = _dispatch(jeng, rows, bucket)
    out_t = _dispatch(teng, rows, bucket)
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)
    jeng.spec_flush()
    teng.spec_flush()
    assert teng.spec_stats["spec_dispatches"] == 1
    assert jeng.spec_stats.spec_dispatches == 1
    assert teng.spec_stats["spec_rows"] == len(rows)
    for f in SPEC_FIELDS:
        assert teng.spec_stats[f] == getattr(jeng.spec_stats, f), f
    assert teng.spec_stats["decode_forwards"] > 0
    return out_t


def test_untrunked_dispatch_takes_spec(models):
    """The default engine: a dispatch with no shared trunk takes the
    speculative route and matches the JAX engine's; against the port's
    own sequential route, ids and position-0 readouts are bitwise."""
    jeng, teng = _engines(models)
    rng = np.random.default_rng(6)
    rows = [[int(x) for x in rng.integers(3, 900, 40 + r)] for r in range(4)]
    out_t = _check_spec_engine(jeng, teng, rows, 64)
    assert teng.cascade_stats["dense_shared_dispatches"] == 0
    assert teng.cascade_stats["cascade_decode_dispatches"] == 0
    _, seq = _engines(models, spec_decode=False)
    out_s = _dispatch(seq, rows, 64)
    assert seq.cascade_stats["dense_shared_dispatches"] == 1
    for a, b in zip(out_t, out_s):
        for f in ("generated", "topk_logprobs", "topk_ids",
                  "weighted_confidence"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in ("p_yes", "p_no"):
            assert torch.equal(getattr(a, f)[:, 0], getattr(b, f)[:, 0]), f


def test_trunk_dispatch_without_cascade_takes_spec_trunk(models):
    """Cascade prefill off: a shared-trunk dispatch takes the speculative
    route with a decode trunk (the trunk-aware multi-query kernel)."""
    from lir_tpu_torch.ops.flash_decode import trunk_splits

    jeng, teng = _engines(models, cascade_prefill=False)
    rows = _trunk_rows(5)
    _check_spec_engine(jeng, teng, rows, 96)
    assert teng.cascade_stats["cascade_decode_dispatches"] == 1
    assert teng.cascade_stats["cascade_dispatches"] == 0
    dtrunk = teng.decode_trunk_for(rows, len(rows), 96)
    assert dtrunk == 80 and trunk_splits(dtrunk, 96 + 8 + 4 * SPEC_K) > 0


def test_trunk_dispatch_with_cascade_keeps_cascade(models):
    jeng, teng = _engines(models)
    out_j = _dispatch(jeng, _trunk_rows(5), 96)
    out_t = _dispatch(teng, _trunk_rows(5), 96)
    assert teng.cascade_stats["cascade_dispatches"] == 1
    assert teng.spec_stats["spec_dispatches"] == 0
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)
