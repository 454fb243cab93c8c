"""The int8 KV cache (``ModelConfig.kv_cache_int8``) against the JAX
package, on the CPU.

- The cache's nesting, shapes and dtypes are the JAX ``init_cache``'s;
  ``decoder.kv_cache_bytes`` and ``paged.kv_page_bytes`` are the JAX
  package's numbers.
- The prefill's payloads equal the JAX prefill's but for one level where
  a value sits at a rounding tie (the two packages' float k/v differ in
  their last bits; such entries are counted and bounded), its scales
  within 1e-6 relative, its pad slots zero.
- ``ops.kv_int8_attention_plain`` (the kernel's twin) equals the JAX
  ``_attention_cached_int8`` on the same int8 inputs within 1e-5, at S =
  1, 4 and 16 queries, K = H, 2 and 1 kv heads, with ALiBi, with masked
  keys and with a row whose every key is masked; its s32 scores are the
  exact integer products.
- The capture path (``greedy_decode``), the shared dispatches (the
  speculative and the sequential loop), the grouped dispatch and the
  paged dispatches (the prefix cache, cold and warm) of int8-KV engines
  write the JAX int8-KV sweep's rows (one JAX run, sequential: spec ==
  sequential is the reference's own invariant; the paged ones held to
  the JAX cold unpaged rows, ROADMAP R1): texts and integers exact,
  floats within the INT8_* bars; on the port every cached attention went
  through ``ops.kv_int8_attention`` and none through a flash-decode
  kernel. The paged dispatches are held to wider bars (PAGED_*): their
  remainder window is an extension whose attention reads the prefix from
  the int8 cache, where the cold prefill's reads its float k/v, so the
  window's own k/v carry the prefix's quantization error (the JAX
  package's paged front does the same); a text may differ from the cold
  one only at a position where its two candidates sit within
  PAGED_LOGP_TOL of each other (each flip checked by a forced decode on
  the int8 cache). The piggyback chain on an int8-KV engine is in
  ``tests/test_torch_piggyback.py``.
- ``cascade_supported`` and ``cascade_decode_supported`` are false on an
  int8-KV engine in both packages.
- ``load_engine(kv_cache_int8=True)`` sets the flag on a local decoder
  checkpoint and, on a T5 checkpoint, logs the JAX package's warning and
  goes on without it.
"""

import dataclasses
import json
import logging
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.engine import generate as jgen
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import cache as jcache
from lir_tpu.models import decoder as jdec
from lir_tpu.models import paged as jpaged
from lir_tpu.models import registry as jregistry
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch import ops
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.engine import generate, sweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder, factory, paged, registry
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.ops.kv_int8_attention import (kv_int8_attention_plain,
                                                 qk_s32_plain)

from test_torch_engine import CFG, WEIGHT_SCALE
from test_torch_sweep import JAX_PROMPTS, MODEL, PERTS, PROMPTS

FTOL = 1e-5
# The engines' floats against the JAX package's. An int8 cache turns a
# last-bit difference of a float k/v into a whole quantization level
# where the value sits at a rounding tie, so two programs that round
# their float products differently land apart by more than float noise:
# the JAX package's own speculative and sequential sweeps of this grid
# differ by 2.4e-6 in a probability, 1.4e-4 relative in a weighted
# confidence and 1.9e-3 nats in a top-20 log-prob (XLA compiles the two
# programs' prefills differently). The port's routes sit within 4e-6 of
# the JAX speculative sweep and within those amounts of its sequential
# one, which the test runs (one JAX compile); the bars leave about 5x
# room.
INT8_PROB_TOL = 1e-5
INT8_WCONF_RTOL = 7e-4
INT8_LOGP_TOL = 1e-2
# The paged dispatches against the JAX cold unpaged rows (measured on this
# grid: probabilities 8.4e-6, weighted confidence 3.4e-4 relative, top-20
# log-probs 7.9e-3 nats, one text flip at a 7.5e-4-nat gap): the bars
# leave about 4x room. A text may differ only where its two ids at the
# first differing position are within PAGED_LOGP_TOL.
PAGED_PROB_TOL = 5e-5
PAGED_WCONF_RTOL = 1.5e-3
PAGED_LOGP_TOL = 3e-2
TINY = dict(name="kv8-tiny", vocab_size=128, hidden_size=32, n_layers=2,
            n_heads=4, n_kv_heads=2, intermediate_size=64, max_seq_len=512)
# The JAX functions the tests call outside an engine, compiled once a
# shape (their op-by-op dispatch costs seconds on the CPU).
_init = jax.jit(jdec.init_params, static_argnums=(0,),
                static_argnames=("dtype",))
_prefill = jax.jit(jdec.prefill, static_argnums=(1, 4))
_attention = jax.jit(jdec._attention_cached_int8, static_argnums=(6,))
FLASH_KERNELS = ("flash_decode", "flash_decode_trunk", "flash_decode_mq",
                 "flash_decode_mq_trunk", "cascade_attention")


@pytest.fixture(scope="module", autouse=True)
def hooks():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


@pytest.mark.parametrize("preset", ["llama2_7b", "mistral_7b", "falcon_7b"])
def test_cache_layout_and_bytes_match_jax(preset):
    """init_cache's nesting, shapes and dtypes; kv_cache_bytes and
    kv_page_bytes, float and int8, equal to the JAX package's."""
    tcfg = getattr(registry, preset)()
    jcfg = getattr(jregistry, preset)()
    for int8 in (False, True):
        t = dataclasses.replace(tcfg, kv_cache_int8=int8)
        j = dataclasses.replace(jcfg, kv_cache_int8=int8)
        for batch, T in ((1, 1), (32, 552), (32, 1070)):
            assert decoder.kv_cache_bytes(t, batch, T) == \
                jcache.kv_cache_bytes(j, batch, T)
        for ps in (16, 32):
            assert paged.kv_page_bytes(t, ps) == jpaged.kv_page_bytes(j, ps)
    small = dataclasses.replace(ModelConfig(**TINY), kv_cache_int8=True)
    tc = decoder.init_cache(small, 3, 7, device="cpu")
    jc = jdec.init_cache(JaxModelConfig(**TINY, kv_cache_int8=True), 3, 7)
    assert [tuple(a.shape) for a in decoder.cache_leaves(tc)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jc)]
    assert [str(a.dtype).split(".")[-1] for a in decoder.cache_leaves(tc)] == \
        [str(a.dtype) for a in jax.tree.leaves(jc)] == \
        ["int8", "float32", "int8", "float32"]
    assert decoder.kv_cache_bytes(small, 3, 7) == sum(
        a.numel() * a.element_size() for a in decoder.cache_leaves(tc))


def _tiny_tree(seed=3):
    cfg_j = JaxModelConfig(**TINY, kv_cache_int8=True)
    tree = jax.tree.map(np.asarray, _init(
        cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32))
    return cfg_j, tree


def test_prefill_payload_matches_jax():
    """Payloads equal but for single levels at rounding ties (fewer than
    one entry in 500), scales within 1e-6 relative, pad slots zero."""
    cfg_j, tree = _tiny_tree()
    cfg = ModelConfig(**TINY, kv_cache_int8=True)
    pt = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(5)
    B, S, T = 4, 24, 40
    toks = rng.integers(3, 128, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :5] = 0
    mask[3, :11] = 0
    jl, jc, jpos = _prefill(jax.tree.map(jnp.asarray, tree), cfg_j,
                            jnp.asarray(toks), jnp.asarray(mask), T)
    tl, tc, tpos = decoder.prefill(pt, cfg, torch.as_tensor(toks),
                                   torch.as_tensor(mask), T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FTOL, rtol=0)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    moved = total = 0
    for side_t, side_j in zip(tc, jc):
        (tq, ts), (jq, js) = side_t, side_j
        d = tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
        assert np.abs(d).max() <= 1
        moved += int((d != 0).sum())
        total += d.size
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)
        assert not tq[:, :, S:].any() and not ts[:, :, S:].any()
    assert moved <= total / 500, (moved, total)


def _attention_inputs(seed, B, S, H, K, hd, T, all_masked_row=False):
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


# Every (S, K) pair plain; ALiBi and the all-masked row each at three.
ATTN_CASES = ([(S, K, False, False) for S in (1, 4, 16) for K in (4, 2, 1)]
              + [(1, 4, True, False), (4, 2, True, False),
                 (16, 1, True, False), (1, 2, False, True),
                 (4, 1, False, True), (16, 4, False, True)])


@pytest.mark.parametrize("S,K,alibi,all_masked", ATTN_CASES,
                         ids=lambda v: str(v))
def test_twin_matches_jax_int8_attention(S, K, alibi, all_masked):
    B, H, hd, T = 3, 4, 16, 37
    q, kq, ks, vq, vs, qpos, mask, kpos = _attention_inputs(
        S * 10 + K, B, S, H, K, hd, T, all_masked)
    jcfg = JaxModelConfig(**dict(TINY, n_kv_heads=K, kv_cache_int8=True,
                                 pos_embedding="alibi" if alibi
                                 else "rotary"))
    bias = jdec._causal_bias(jnp.ones((B, S), jnp.int32), jnp.asarray(qpos),
                             jcfg, key_positions=jnp.asarray(kpos),
                             key_mask=jnp.asarray(mask))
    ref = _attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                     jnp.asarray(vq), jnp.asarray(vs), bias, jcfg)
    T_ = torch.as_tensor
    slopes = decoder.alibi_slopes(H) if alibi else None
    got = kv_int8_attention_plain(T_(q), T_(kq), T_(ks), T_(vq), T_(vs),
                                  T_(qpos), T_(mask), T_(kpos), slopes)
    assert got.shape == (B, S, H * hd) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FTOL,
                               rtol=0)
    # The wrapper runs the twin on CPU tensors.
    same = ops.kv_int8_attention(T_(q), T_(kq), T_(ks), T_(vq), T_(vs),
                                 T_(qpos), T_(mask), T_(kpos), slopes)
    assert torch.equal(same, got)
    # The s32 scores are the integer products of the quantized query.
    qq, _ = jdec._quant_kv(jnp.asarray(q))
    s32 = np.einsum("bshd,htbd->bhst",
                    np.asarray(qq).astype(np.int64),
                    np.repeat(kq.astype(np.int64), H // K, axis=0))
    np.testing.assert_array_equal(qk_s32_plain(T_(q), T_(kq)).numpy(), s32)


def test_greedy_decode_matches_jax():
    """The capture path on an int8 cache: ids exact, step logits within
    1e-5."""
    cfg_j, tree = _tiny_tree(7)
    cfg = ModelConfig(**TINY, kv_cache_int8=True)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, 128, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[2, :4] = 0
    jg, jl = jgen.greedy_decode(jax.tree.map(jnp.asarray, tree), cfg_j,
                                jnp.asarray(toks), jnp.asarray(mask),
                                max_new_tokens=6)
    tg, tl = generate.greedy_decode(params_from_jax(tree, cfg, device="cpu"),
                                    cfg, torch.as_tensor(toks),
                                    torch.as_tensor(mask), max_new_tokens=6)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FTOL, rtol=0)


def _engine_tree():
    cfg_j = JaxModelConfig(**CFG, kv_cache_int8=True)
    tree = jax.tree.map(np.asarray, _init(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    return cfg_j, tree


RT = dict(batch_size=4, max_new_tokens=12, piggyback_prefill=False)


@pytest.fixture(scope="module")
def int8_sweeps(tmp_path_factory):
    """The JAX int8-KV engine's sweep of test_torch_sweep's grid (a
    grouped dispatch, three shared ones, no cascade on an int8 cache),
    and the port's: speculative, sequential, and with the prefix cache
    cold then warm on one engine. Every port run counts
    ``ops.kv_int8_attention`` calls and raises on a flash-decode or
    cascade kernel."""
    cfg_j, tree = _engine_tree()
    tmp = tmp_path_factory.mktemp("kv8")
    jeng = JaxEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                     JaxFakeTokenizer(),
                     JaxRuntimeConfig(**RT, aot_precompile=False,
                                      prefix_cache=False, spec_decode=False,
                                      streaming_stats=False))
    jrows = jsweep.run_perturbation_sweep(jeng, MODEL, JAX_PROMPTS, PERTS,
                                          tmp / "jax.csv")
    cfg = ModelConfig(**CFG, kv_cache_int8=True)
    pt = params_from_jax(tree, cfg, device="cpu")
    calls = {"kv_int8_attention": 0}
    real = ops.kv_int8_attention

    def counted(*a, **k):
        calls["kv_int8_attention"] += 1
        return real(*a, **k)

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} ran on an int8 KV cache")
        return fn

    out = {"jax": (jeng, jrows)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "kv_int8_attention", counted)
        for name in FLASH_KERNELS:
            mp.setattr(ops, name, refuse(name))
        for label, rt in (("spec", {}), ("sequential",
                                         dict(spec_decode=False))):
            eng = ScoringEngine(pt, cfg, FakeTokenizer(),
                                RuntimeConfig(**RT, **rt), device="cpu")
            calls["kv_int8_attention"] = 0
            rows = sweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                                tmp / f"{label}.csv")
            out[label] = (eng, rows, calls["kv_int8_attention"])
        eng = ScoringEngine(pt, cfg, FakeTokenizer(),
                            RuntimeConfig(**RT, prefix_cache=True,
                                          prefix_cache_pages=64),
                            device="cpu")
        for label in ("cold", "warm"):
            calls["kv_int8_attention"] = 0
            rows = sweep.run_perturbation_sweep(eng, MODEL, PROMPTS, PERTS,
                                                tmp / f"paged_{label}.csv")
            out[label] = (eng, rows, calls["kv_int8_attention"],
                          dict(eng.paged_dispatches))
    return out


def _ids(text):
    return [int(i) for i in re.findall(r"<(\d+)>", text)]


def _flip_gap(eng, prompt, ref_text, got_text):
    """|log p(ref id) - log p(got id)| at the first position where the two
    texts' ids differ: the prompt prefilled into an int8 cache, then the
    reference's ids before that position decoded teacher-forced through
    it (the unpaged route's arithmetic)."""
    a, b = _ids(ref_text), _ids(got_text)
    j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    toks = torch.tensor([eng.tokenizer(prompt).input_ids], dtype=torch.int32)
    n = toks.shape[1]
    logits, cache, pos = decoder.prefill(eng.params, eng.cfg, toks,
                                         torch.ones_like(toks), n + j)
    cm = torch.ones((1, n + j), dtype=torch.int32)
    cm[:, n:] = 0
    for t in range(j):
        cm[:, n + t] = 1
        logits, cache = decoder.decode_step(
            eng.params, eng.cfg, cache, torch.tensor([a[t]], dtype=torch.int32),
            pos + t, n + t, cm)
    lp = torch.log_softmax(logits[0], -1)
    return float((lp[a[j]] - lp[b[j]]).abs())


def _compare_rows(jrows, trows, flips=None):
    """Rows against the JAX rows, floats within the INT8_* bars. With
    ``flips`` (an engine and a list: the paged routes) the floats take
    the PAGED_* bars and a differing text is allowed where its flip gap
    is below PAGED_LOGP_TOL, and recorded."""
    ptol, wtol, ltol = ((INT8_PROB_TOL, INT8_WCONF_RTOL, INT8_LOGP_TOL)
                        if flips is None else
                        (PAGED_PROB_TOL, PAGED_WCONF_RTOL, PAGED_LOGP_TOL))
    assert [r.rephrased_main for r in trows] == \
        [r.rephrased_main for r in jrows]
    for a, b in zip(jrows, trows):
        for f, prompt in (("model_response", a.full_rephrased_prompt),
                          ("model_confidence_response",
                           a.full_confidence_prompt)):
            ref, got = getattr(a, f), getattr(b, f)
            if ref != got and flips is not None:
                gap = _flip_gap(flips[0], prompt, ref, got)
                assert gap < PAGED_LOGP_TOL, (f, ref, got, gap)
                flips[1].append(gap)
                continue
            assert ref == got, f
        if flips is None or a.model_confidence_response == \
                b.model_confidence_response:
            assert a.confidence_value == b.confidence_value
        for f in ("token_1_prob", "token_2_prob"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       atol=ptol, rtol=0, err_msg=f)
        np.testing.assert_allclose(b.weighted_confidence,
                                   a.weighted_confidence, rtol=wtol, atol=0)
        la, lb = (json.loads(a.log_probabilities),
                  json.loads(b.log_probabilities))
        np.testing.assert_allclose(sorted(lb.values()), sorted(la.values()),
                                   atol=ltol, rtol=0)


@pytest.mark.parametrize("route", ["spec", "sequential"])
def test_shared_and_grouped_dispatches_match_jax(int8_sweeps, route):
    jeng, jrows = int8_sweeps["jax"]
    eng, rows, n_int8 = int8_sweeps[route]
    _compare_rows(jrows, rows)
    assert eng.occupancy.grouped_cells == jeng.occupancy.grouped_cells == 4
    assert not eng.cascade_stats.get("cascade_dispatches")
    assert jeng.cascade_stats.cascade_dispatches == 0
    if route == "spec":
        assert eng.spec_stats["spec_dispatches"] == 3
    else:
        assert eng.cascade_stats["dense_shared_dispatches"] == 3
    assert n_int8 > 0


@pytest.mark.parametrize("visit", ["cold", "warm"])
def test_paged_dispatches_match_jax_unpaged(int8_sweeps, visit):
    """The prefix cache on an int8-KV engine (an int8 page pool) writes
    the JAX cold unpaged rows; the warm visit resumes from the pool."""
    _, jrows = int8_sweeps["jax"]
    eng, rows, n_int8, routes = int8_sweeps[visit]
    flips = []
    _compare_rows(jrows, rows, flips=(int8_sweeps["sequential"][0], flips))
    assert len(flips) <= 1
    assert n_int8 > 0
    pool = eng.prefix_cache.pool
    assert [a.dtype for a in decoder.cache_leaves(pool.leaves)] == \
        [torch.int8, torch.float32] * 2
    assert pool.page_nbytes() == paged.kv_page_bytes(eng.cfg, pool.page_size)
    if visit == "warm":
        assert sum(routes.values()) > 0
        assert eng.prefix_stats.hit_tokens > 0


def test_cascade_gates_off_in_both(int8_sweeps):
    jeng, _ = int8_sweeps["jax"]
    eng = int8_sweeps["spec"][0]
    assert not eng.cascade_supported() and not eng.cascade_decode_supported()
    assert not jeng.cascade_supported()
    assert not jeng.cascade_decode_supported()
    with pytest.raises(ValueError, match="float KV cache"):
        decoder.cascade_extend(eng.params, eng.cfg, None, None, None, 0, 0)


def test_load_engine_sets_the_flag_and_warns_on_t5(tmp_path, caplog):
    import chip_smoke

    cfg = ModelConfig(name="kv8-local", vocab_size=FakeTokenizer.VOCAB,
                      hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      intermediate_size=128, max_seq_len=512)
    chip_smoke.export_hf_llama(decoder.init_params(cfg, seed=7, device="cpu"),
                               cfg, tmp_path / "llama")
    eng = factory.load_engine(tmp_path / "llama", RuntimeConfig(batch_size=2),
                              tokenizer=FakeTokenizer(), device="cpu",
                              kv_cache_int8=True)
    assert eng.cfg.kv_cache_int8 and not eng.cascade_supported()
    plain = factory.load_engine(tmp_path / "llama",
                                RuntimeConfig(batch_size=2),
                                tokenizer=FakeTokenizer(), device="cpu")
    assert not plain.cfg.kv_cache_int8
    a = eng.score_prompts(["Is a bicycle a vehicle ?", "Is a car ?"])
    b = plain.score_prompts(["Is a bicycle a vehicle ?", "Is a car ?"])
    for x, y in zip(a, b):
        assert math.isfinite(x.yes_prob)
        assert abs(x.yes_prob - y.yes_prob) < 0.05
    t5 = registry.T5Config(name="kv8-t5", vocab_size=64, hidden_size=32,
                           n_layers=2, n_heads=4, head_dim=8,
                           intermediate_size=48)
    chip_smoke.export_hf_t5(chip_smoke.t5_params(t5, seed=1, device="cpu",
                                                 dtype=torch.float32),
                            t5, tmp_path / "t5")
    with caplog.at_level(logging.WARNING):
        t5_eng = factory.load_engine(tmp_path / "t5", RuntimeConfig(),
                                     tokenizer=FakeTokenizer(vocab=64),
                                     device="cpu", kv_cache_int8=True)
    assert t5_eng.encoder_decoder
    assert not hasattr(t5_eng.cfg, "kv_cache_int8")
    assert any("--kv-cache-int8 has no effect on encoder-decoder"
               in r.getMessage() for r in caplog.records)
