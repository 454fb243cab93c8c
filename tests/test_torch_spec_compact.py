"""The port's speculative route with compacted cache slots.

The port starts each row's verify window at the row's next free cache
slot, where the JAX package gives window c the fixed slots
slot0 + c * spec_k (``lir_tpu_torch/engine/generate._spec_tail``). Only
the slot discipline differs, so every consumed output must still be the
JAX package's: the same numpy-seeded inputs go through both on CPU
tensors (the port's kernels run their plain versions; the JAX side's
decode kernels in the Pallas interpreter, armed per test), at zero, full
and ragged draft acceptance, with the EOS and the digit early stop, on
the flat and the shared-trunk decode routes, for three decoder families
(GQA + rotary, MQA + parallel block, ALiBi + embedding LayerNorm).
Tolerances: ids, top-2 ids and ``SpecOut`` exact; floats 1e-5 against
JAX (``_compare_fused``); against the port's own sequential route, ids
and position-0 readouts bitwise. A pinned check holds the port's spec
cache gap-free: each window starts where the row's accepted tokens end,
and the cache slots of the emitted tokens hold what the sequential loop
writes there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_engine import WEIGHT_SCALE, _compare_fused

BUCKET, TRUNK, SFX, TA, TB, SPEC_K = 96, 64, 8, 4, 8, 4
B = 3


@pytest.fixture(autouse=True)
def _interpret():
    from lir_tpu.models import decoder as jdec

    old = (jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU)
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    jdec.CASCADE_INTERPRET_ON_CPU = True
    yield
    jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU = old


@pytest.fixture(scope="module", params=["mistral", "falcon", "bloom"])
def family(request):
    """One tiny decoder family, its weights scaled up so that no two
    candidate tokens sit within float noise, as JAX and port params."""
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models import registry as jreg
    from lir_tpu_torch.models import registry as treg
    from lir_tpu_torch.models.convert import params_from_jax

    cfg_j, cfg_t = jreg.tiny(request.param), treg.tiny(request.param)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    tree["tok_embed"] = tree["tok_embed"] * WEIGHT_SCALE
    if "lm_head" in tree:
        tree["lm_head"] = tree["lm_head"] * WEIGHT_SCALE
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"))


def _arrays(vocab, seed=5):
    """A shared dispatch's arrays: prefixes sharing their first TRUNK
    tokens (so the trunk route reads them once), ragged right-padded
    ends, distinct tokens otherwise; and each branch's drafter context."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(8, vocab), size=(B, 24 + 2 * SFX), replace=False)
    head = [int(x) for x in rng.choice(np.arange(8, vocab), TRUNK)]
    prefixes = [head + [int(x) for x in ids[r, :24 - 3 * r]] for r in range(B)]
    sfx_a = [[int(x) for x in ids[r, 24:24 + 3 - r % 2]] for r in range(B)]
    sfx_b = [[int(x) for x in ids[r, 24 + SFX:24 + SFX + 5]] for r in range(B)]

    def pad(rows, width):
        a = np.zeros((B, width), np.int32)
        m = np.zeros((B, width), np.int32)
        for r, row in enumerate(rows):
            a[r, :len(row)] = row
            m[r, :len(row)] = 1
        return a, m

    shared = (*pad(prefixes, BUCKET), *pad(sfx_a, SFX), *pad(sfx_b, SFX),
              np.full((B,), 11, np.int32), np.full((B,), 13, np.int32),
              np.arange(20, 26, dtype=np.int32), np.arange(6, dtype=np.float32))
    ctx = []
    for sfx, budget in ((sfx_a, TA), (sfx_b, TB)):
        c, _ = pad([p + s for p, s in zip(prefixes, sfx)], BUCKET + SFX + budget)
        ctx.append((c, np.asarray([len(p) + len(s) for p, s in
                                   zip(prefixes, sfx)], np.int32)))
    return shared, ctx


def _drafts(seq, budget, case, vocab):
    """Given drafts over the whole budget: the sequential stream (full
    acceptance), shifted (zero), or wrong at position 1 (ragged)."""
    if case == "full_accept":
        d = seq
    elif case == "zero_accept":
        d = (seq + 1) % vocab
    else:
        d = np.where(np.arange(seq.shape[1])[None, :] == 1, (seq + 3) % vocab, seq)
    return d[:, :budget].astype(np.int32), np.full((B,), budget, np.int32)


# (draft case, stop): every acceptance pattern, the EOS stop inside a
# window and the digit stop.
CASES = [("zero_accept", None), ("full_accept", "eos"), ("ragged", "digit")]


@pytest.mark.parametrize("trunk", [0, TRUNK])
@pytest.mark.parametrize("case,stop", CASES)
def test_compacted_spec_matches_jax_and_sequential(family, case, stop, trunk):
    from lir_tpu.engine import generate as jgen
    from lir_tpu_torch.engine import generate as tgen
    from lir_tpu_torch.engine import tokens as tok

    cfg_j, pj, cfg_t, pt = family
    vocab = cfg_t.vocab_size
    shared, ctx = _arrays(vocab)
    targs = [torch.from_numpy(np.asarray(a)) for a in shared]
    jargs = [jnp.asarray(a) for a in shared]
    kw = dict(max_new_a=TA, max_new_b=TB, decode_trunk=trunk)
    seq_t = tgen.greedy_decode_fused_shared(pt, cfg_t, *targs, **kw)
    stops_t, stops_j = {}, {}
    if stop is not None:
        gen_b = seq_t[1].generated.numpy()
        table = np.zeros((vocab,), np.int32)
        eos = int(gen_b[0, 1])
        if stop == "digit":
            for t in gen_b[:, 0]:
                table[int(t)] = tok.STOP_PURE | tok.STOP_PREFIX | tok.STOP_ENDS_WORD
        stops_t = dict(stop_mask_a=torch.from_numpy(table),
                       stop_mask_b=torch.from_numpy(table), eos_id=eos)
        stops_j = dict(stop_mask_a=jnp.asarray(table),
                       stop_mask_b=jnp.asarray(table), eos_id=jnp.int32(eos))
        seq_t = tgen.greedy_decode_fused_shared(pt, cfg_t, *targs, **kw, **stops_t)
    spec = []
    for (c, n), seq, budget in zip(ctx, seq_t, (TA, TB)):
        spec += [c, n, *_drafts(seq.generated.numpy(), budget, case, vocab)]
    out_t = tgen.greedy_decode_fused_shared_spec(
        pt, cfg_t, *targs, *(torch.from_numpy(a) for a in spec), **kw,
        spec_k=SPEC_K, **stops_t)
    out_j = jax.device_get(jgen.greedy_decode_fused_shared_spec(
        pj, cfg_j, *jargs, *(jnp.asarray(a) for a in spec), **kw,
        spec_k=SPEC_K, **stops_j))
    for js, ts in zip(out_j[2:], out_t[2:]):
        for f in ("drafted", "accepted", "chunks", "seq_steps"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ts, f).numpy(), err_msg=f)
    for jo, to, so in zip(out_j[:2], out_t[:2], seq_t):
        _compare_fused(jo, to)
        for f in ("generated", "top2_ids", "topk_logprobs", "topk_ids",
                  "weighted_confidence"):
            assert torch.equal(getattr(to, f), getattr(so, f)), f
        for f in ("p_yes", "p_no"):
            assert torch.equal(getattr(to, f)[:, 0], getattr(so, f)[:, 0]), f
    accepted = int(out_t[3].accepted.sum())
    if case == "zero_accept":
        assert accepted == 0
    elif case == "ragged":
        assert 0 < accepted < int(out_t[3].drafted.sum())


def test_spec_cache_has_no_gaps(family, monkeypatch):
    """Ragged acceptance, where the JAX package's windows leave masked
    gaps: the port's every window starts where its row's accepted tokens
    end (the mask valid up to it, nothing valid after the window), and
    after the loop the slots of the emitted tokens hold the k/v the
    sequential loop writes there."""
    from lir_tpu_torch.engine import generate as tgen
    from lir_tpu_torch.models import decoder as tdec

    _, _, cfg_t, pt = family
    vocab = cfg_t.vocab_size
    shared, ctx = _arrays(vocab, seed=9)
    prefix, pmask = (torch.from_numpy(a) for a in shared[:2])
    T, S = TB, BUCKET
    yes, no = (torch.from_numpy(a) for a in shared[6:8])
    empty_i = torch.zeros((0,), dtype=torch.int32)
    empty_f = torch.zeros((0,), dtype=torch.float32)
    logits0, cache, pos = tdec.prefill(pt, cfg_t, prefix, pmask, S + T * SPEC_K)
    seq_cache = tuple(c[:, :, :S + T].clone() for c in cache)
    seq, seq_cache = tgen._fused_tail(pt, cfg_t, logits0, seq_cache,
                                      F.pad(pmask, (0, T)), pos, S, yes, no,
                                      empty_i, empty_f, T, 5)
    drafts, dlen = _drafts(seq.generated.numpy(), T, "ragged", vocab)
    starts = []
    verify = tdec.verify_extend

    def spy(params, cfg, cache_, chunk, cmask, start, trunk_len=0):
        st = start.long()
        for b in range(B):
            s0 = int(st[b])
            assert bool((cmask[b, S:s0] == 1).all()), "a gap before the window"
            assert bool((cmask[b, s0:s0 + SPEC_K] == 1).all())
            assert not bool(cmask[b, s0 + SPEC_K:].any()), "valid slots after it"
        starts.append(st.clone())
        return verify(params, cfg, cache_, chunk, cmask, start, trunk_len)

    monkeypatch.setattr(tdec, "verify_extend", spy)
    c, n = ctx[1]
    out, cache, sp = tgen._spec_tail(
        pt, cfg_t, logits0, cache, F.pad(pmask, (0, T * SPEC_K)), S, yes, no,
        empty_i, empty_f, T, 5, SPEC_K, torch.from_numpy(c), torch.from_numpy(n),
        torch.from_numpy(drafts), torch.from_numpy(dlen))
    assert torch.equal(out.generated, seq.generated)
    assert 0 < int(sp.accepted.sum()) < int(sp.drafted.sum())
    # A window takes up where the last one's accepted tokens end.
    before = torch.stack(starts[:-1])
    steps = torch.stack(starts[1:]) - before
    live = before < S + T                         # rows still emitting
    assert int(steps[live].min()) >= 1 and int(steps[live].max()) <= SPEC_K
    assert bool((steps[live] < SPEC_K).any())     # rows that accepted less
    window = slice(S, S + T - 1)                  # every fed emission
    for got, ref in zip(cache, seq_cache):
        np.testing.assert_allclose(got[:, :, window].numpy(),
                                   ref[:, :, window].numpy(), atol=1e-5, rtol=0)
