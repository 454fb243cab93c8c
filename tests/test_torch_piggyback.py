"""Piggyback chains (the JAX sweep's default dispatch stream) against the
JAX package, on the CPU.

- ``generate.shared_piggyback_prefill`` -> ``step`` -> ``step`` ->
  ``drain`` over three dispatches equals the JAX package's chain and the
  port's own three plain ``greedy_decode_fused_shared`` dispatches:
  integer outputs exact, floats within 1e-5 (the mirror of the JAX
  package's ``tests/test_kernels.py::TestPiggyback``).
- A perturbation sweep whose plan is three consecutive shared dispatches
  of one shape chains in both packages (a float and an int8 KV engine):
  the D6 rows agree (texts and integers exact, probabilities within
  1e-5, the 0-100 weighted confidence within 1e-5 relative) and the
  chain counters are the JAX engine's; with ``piggyback_prefill=False``
  the port's rows are the same and nothing chains; a failed chain step
  falls back to the plain path (``chain_fallbacks`` 1, rows unchanged).
- The gates: no chain on a T5 engine, with the prefix cache built, with
  the flag off or on a wrapped engine; ``PiggybackIneligible`` on a
  layout fallback and on a learned-position overrun, in both packages.

The JAX side runs with ``decoder.FUSED_DECODE_INTERPRET_ON_CPU`` armed,
so its decode loops take the Pallas kernel's arithmetic.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import generate as jgen
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import PiggybackIneligible as JaxIneligible
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LegalPrompt
from lir_tpu_torch.engine import generate, sweep
from lir_tpu_torch.engine.runner import PiggybackIneligible, ScoringEngine
from lir_tpu_torch.models import decoder, encdec
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig, T5Config

FTOL = 1e-5
TINY = dict(name="piggy-tiny", vocab_size=128, hidden_size=32, n_layers=2,
            n_heads=4, n_kv_heads=2, intermediate_size=64, max_seq_len=512)
ENGINE_CFG = dict(name="piggy-engine", vocab_size=FakeTokenizer.VOCAB,
                  hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  intermediate_size=128, max_seq_len=512)
# Larger weights than the 0.02 init, so that the tiny model's logits
# spread out and no two candidate tokens sit within float noise.
WEIGHT_SCALE = 4.0
S, SA, SB, NA, NB = 16, 4, 8, 3, 5
# The sweep's grid: one prompt and eleven rephrasings that differ after a
# few tokens, at batch 4: three shared dispatches of one shape.
PROMPT = dict(main="Does a vehicle include a bicycle ?",
              response_format="Answer Covered or Not .",
              target_tokens=("Covered", "Not"),
              confidence_format="Give a number from 0 to 100 .")
PERTS = ([f"Would a bicycle number {i} count as a vehicle maybe ?"
          for i in range(11)],)
RT = dict(batch_size=4, max_new_tokens=8, max_seq_len=256,
          sweep_group_min_cells=0)
CHAIN = {"chains_opened": 1, "piggybacked_steps": 2, "chains_drained": 1}


@pytest.fixture(scope="module", autouse=True)
def hooks():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _dispatch(seed, B=3, V=128):
    """One shared dispatch's right-padded inputs (numpy), with a short
    prefix row and short suffix rows."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, V, (B, S)).astype(np.int32)
    pm = np.ones((B, S), np.int32)
    pm[0, S - 4:] = 0
    sa = rng.integers(3, V, (B, SA)).astype(np.int32)
    sam = np.ones((B, SA), np.int32)
    sam[1, 2:] = 0
    sb = rng.integers(3, V, (B, SB)).astype(np.int32)
    sbm = np.ones((B, SB), np.int32)
    sbm[2, 5:] = 0
    return prefix, pm, sa, sam, sb, sbm


def _assert_out_close(a, b):
    """Two FusedDecodeOuts (either package's): integer fields exact,
    float fields within FTOL."""
    for f in dataclasses.fields(a):
        x = np.asarray(getattr(a, f.name))
        y = np.asarray(getattr(b, f.name))
        assert x.shape == y.shape, f.name
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, atol=FTOL, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


# The JAX init compiled once a config (its op-by-op dispatch costs
# seconds on the CPU).
_init = jax.jit(jdec.init_params, static_argnums=(0,),
                static_argnames=("dtype",))


def _tree(cfg_j, seed, scale=1.0):
    tree = jax.tree.map(np.asarray, _init(
        cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32))
    if scale != 1.0:
        for name, a in tree["layers"].items():
            if name.startswith("w"):
                tree["layers"][name] = a * scale
        for name in ("tok_embed", "lm_head"):
            tree[name] = tree[name] * scale
    return tree


def test_chain_equals_jax_chain_and_plain_dispatches():
    """prefill -> step -> step -> drain reproduces the JAX chain and three
    plain shared dispatches of the port, per row (the chain on an int8
    cache: ``test_sweep_chains_as_jax[int8_kv]``)."""
    cfg_j = JaxModelConfig(**TINY)
    cfg = ModelConfig(**TINY)
    tree = _tree(cfg_j, 3)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = params_from_jax(tree, cfg, device="cpu")
    yes, no = np.array([5, 6, 7], np.int32), np.array([9, 10, 11], np.int32)
    d_ids = np.arange(10, 30, dtype=np.int32)
    d_vals = np.arange(0.0, 20.0, dtype=np.float32)
    ds = [_dispatch(s) for s in (1, 2, 3)]
    tabs = (yes, no, d_ids, d_vals)
    J = jnp.asarray
    T = torch.as_tensor

    carry = jgen.shared_piggyback_prefill(pj, cfg_j, *map(J, ds[0]),
                                          max_new_a=NA, max_new_b=NB)
    jax_outs = []
    for d in ds[1:]:
        oa, ob, carry = jgen.shared_piggyback_step(
            pj, cfg_j, carry, *map(J, d), *map(J, tabs), max_new_a=NA,
            max_new_b=NB)
        jax_outs.append((oa, ob))
    slots = dict(slot0_a=S + SA, slot0_b=S + SA + NA + SB, max_new_a=NA,
                 max_new_b=NB)
    jax_outs.append(jgen.shared_piggyback_drain(pj, cfg_j, carry,
                                                *map(J, tabs), **slots))

    tcarry = generate.shared_piggyback_prefill(pt, cfg, *map(T, ds[0]),
                                               max_new_a=NA, max_new_b=NB)
    assert generate.piggyback_total_len(S, SA, SB, NA, NB) == \
        tcarry.cm_a.shape[1] == S + SA + NA + SB + NB
    buffers = [t.data_ptr() for t in decoder.cache_leaves(tcarry.cache)]
    outs = []
    for d in ds[1:]:
        oa, ob, tcarry = generate.shared_piggyback_step(
            pt, cfg, tcarry, *map(T, d), *map(T, tabs), max_new_a=NA,
            max_new_b=NB)
        outs.append((oa, ob))
        # The new carry fills the spent carry's buffers.
        assert [t.data_ptr()
                for t in decoder.cache_leaves(tcarry.cache)] == buffers
    outs.append(generate.shared_piggyback_drain(pt, cfg, tcarry,
                                                *map(T, tabs), **slots))
    plain = [generate.greedy_decode_fused_shared(
        pt, cfg, *map(T, d), *map(T, tabs), max_new_a=NA, max_new_b=NB)
        for d in ds]
    for got, ref, own in zip(outs, jax_outs, plain):
        for branch in range(2):
            _assert_out_close(got[branch], ref[branch])
            _assert_out_close(got[branch], own[branch])


def _jax_engine(tree, kv_int8, **rt):
    cfg_j = JaxModelConfig(**ENGINE_CFG, kv_cache_int8=kv_int8)
    return JaxEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                     JaxFakeTokenizer(),
                     JaxRuntimeConfig(**{**RT, **rt}, aot_precompile=False,
                                      streaming_stats=False,
                                      prefix_cache=False))


def _port_engine(tree, kv_int8, tokenizer=None, **rt):
    cfg = ModelConfig(**ENGINE_CFG, kv_cache_int8=kv_int8)
    return ScoringEngine(params_from_jax(tree, cfg, device="cpu"), cfg,
                         tokenizer or FakeTokenizer(),
                         RuntimeConfig(**{**RT, **rt}), device="cpu")


@pytest.fixture(scope="module")
def chain_sweeps(tmp_path_factory):
    """For a float and an int8 KV engine: the JAX sweep (chains on), the
    port's sweep with chains on and off; (tree, engines, rows) by key."""
    tree = _tree(JaxModelConfig(**ENGINE_CFG), 0, WEIGHT_SCALE)
    out = {"tree": tree}
    for kv_int8 in (False, True):
        tmp = tmp_path_factory.mktemp(f"chain_int8_{kv_int8}")
        jeng = _jax_engine(tree, kv_int8)
        jrows = jsweep.run_perturbation_sweep(
            jeng, "tiny", (JaxLegalPrompt(**PROMPT),), PERTS, tmp / "jax.csv")
        runs = {}
        for piggy in (True, False):
            eng = _port_engine(tree, kv_int8, piggyback_prefill=piggy)
            rows = sweep.run_perturbation_sweep(
                eng, "tiny", (LegalPrompt(**PROMPT),), PERTS,
                tmp / f"port_{piggy}.csv")
            runs[piggy] = (eng, rows)
        out[kv_int8] = dict(jax=(jeng, jrows), on=runs[True],
                            off=runs[False])
    return out


def _compare_rows(ref_rows, rows):
    assert [r.rephrased_main for r in rows] == \
        [r.rephrased_main for r in ref_rows]
    for a, b in zip(ref_rows, rows):
        for f in ("model_response", "model_confidence_response",
                  "confidence_value", "full_rephrased_prompt"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("token_1_prob", "token_2_prob"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       atol=FTOL, rtol=0, err_msg=f)
        np.testing.assert_allclose(b.weighted_confidence,
                                   a.weighted_confidence, rtol=FTOL, atol=0)
        la, lb = (json.loads(a.log_probabilities),
                  json.loads(b.log_probabilities))
        assert list(la) == list(lb)
        np.testing.assert_allclose(list(lb.values()), list(la.values()),
                                   atol=FTOL, rtol=0)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8_kv"])
def test_sweep_chains_as_jax(chain_sweeps, kv_int8):
    """The plan is three consecutive same-shape shared dispatches; both
    packages chain all three, with the same counters and rows."""
    (jeng, jrows), (eng, rows) = (chain_sweeps[kv_int8]["jax"],
                                  chain_sweeps[kv_int8]["on"])
    cells = [it for it in sweep.grid_mod.build_grid(
        "tiny", (LegalPrompt(**PROMPT),), PERTS)]
    dispatches, _ = sweep._plan_ragged(eng, cells, 4, 8)
    keys = {(d.kind, d.bucket, len(d.items), d.sfx_bucket_a, d.sfx_bucket_b)
            for d in dispatches}
    assert len(dispatches) == 3 and len(keys) == 1
    assert next(iter(keys))[0] == "shared"
    assert jeng.kernel_stats.counters == CHAIN
    assert eng.kernel_stats.counters == jeng.kernel_stats.counters
    assert not eng.spec_stats and not eng.cascade_stats
    _compare_rows(jrows, rows)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8_kv"])
def test_no_piggyback_rows_unchanged(chain_sweeps, kv_int8):
    """With ``piggyback_prefill=False`` nothing chains (every dispatch
    speculates, as the plain path does) and the rows are the chain's."""
    (eng_on, rows_on), (eng_off, rows_off) = (chain_sweeps[kv_int8]["on"],
                                              chain_sweeps[kv_int8]["off"])
    assert not eng_off.kernel_stats.counters
    assert not eng_off.piggyback_supported()
    assert eng_off.spec_stats["spec_dispatches"] == 3
    _compare_rows(rows_on, rows_off)


def test_failed_step_falls_back_to_the_plain_path(chain_sweeps, tmp_path,
                                                  monkeypatch):
    """A chain step that raises: the parked batch and the failed one are
    re-run plainly, the last dispatch plainly too (no run to ride), and
    the rows are the chain's."""
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("injected piggyback failure")

    monkeypatch.setattr(generate, "shared_piggyback_step", broken)
    eng = _port_engine(chain_sweeps["tree"], False)
    rows = sweep.run_perturbation_sweep(eng, "tiny", (LegalPrompt(**PROMPT),),
                                        PERTS, tmp_path / "broken.csv")
    assert len(calls) == 1
    assert eng.kernel_stats.counters == {"chains_opened": 1,
                                         "chain_fallbacks": 1}
    assert not eng.piggy_pending()
    assert eng.spec_stats["spec_dispatches"] == 3
    _compare_rows(chain_sweeps[False]["on"][1], rows)


def test_gates_match_jax(chain_sweeps):
    """No chain on a T5 engine, with the prefix cache built, with the
    flag off or on an engine whose shared dispatch is shadowed by an
    instance attribute (a wrapper); the JAX engine's gates agree."""
    tree = chain_sweeps["tree"]
    for kw, want in (({}, True), (dict(piggyback_prefill=False), False),
                     (dict(prefix_cache=True, prefix_cache_pages=4), False)):
        teng = _port_engine(tree, False, **kw)
        cfg_j = JaxModelConfig(**ENGINE_CFG)
        jeng = JaxEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                         JaxFakeTokenizer(),
                         JaxRuntimeConfig(**{**RT, **kw},
                                          aot_precompile=False))
        assert teng.piggyback_supported() is want, kw
        assert jeng.piggyback_supported() is want, kw
    teng = _port_engine(tree, False)
    teng.decode_fused_shared = lambda *a, **k: None
    assert not teng.piggyback_supported()
    t5 = T5Config(name="piggy-t5", vocab_size=FakeTokenizer.VOCAB,
                  hidden_size=32, n_layers=1, n_heads=2, head_dim=16,
                  intermediate_size=48)
    t5_eng = ScoringEngine(encdec.init_params(t5, seed=0, device="cpu"), t5,
                           FakeTokenizer(), RuntimeConfig(**RT),
                           device="cpu", encoder_decoder=True)
    assert not t5_eng.piggyback_supported()


def test_ineligible_dispatches_raise_in_both(chain_sweeps):
    """``PiggybackIneligible`` where the JAX engine raises it: a suffix
    past the largest suffix bucket (the layout fallback), and a chain
    cache past a learned-position table the plain dispatch fits."""
    tree = chain_sweeps["tree"]
    tok = FakeTokenizer()
    a = tok("Does a vehicle include a bicycle ? Answer Covered").input_ids
    b = tok("Does a vehicle include a bicycle ? " + "word " * 300).input_ids
    args = ([a, a], [b, b], 4, 8, False, 64, (8, 16))
    teng = _port_engine(tree, False)
    jeng = _jax_engine(tree, False)
    for eng, err in ((teng, PiggybackIneligible), (jeng, JaxIneligible)):
        with pytest.raises(err, match="layout fallback"):
            eng.decode_fused_shared_piggy(*args)
        assert not eng.piggy_pending()
    learned = dict(ENGINE_CFG, name="piggy-learned", pos_embedding="learned",
                   max_seq_len=96)
    cfg = ModelConfig(**learned)
    cfg_j = JaxModelConfig(**learned)
    ltree = _tree(cfg_j, 1)
    teng = ScoringEngine(params_from_jax(ltree, cfg, device="cpu"), cfg, tok,
                         RuntimeConfig(**RT), device="cpu")
    jeng = JaxEngine(jax.tree.map(jnp.asarray, ltree), cfg_j,
                     JaxFakeTokenizer(), JaxRuntimeConfig(
                         **RT, aot_precompile=False))
    args = ([a, a], [a[:-2] + [5, 6], a[:-2] + [7, 8]], 4, 8, False, 64,
            (8, 16))
    # The plain dispatch fits 64 + max(8 + 4, 16 + 8) = 88 <= 96 slots;
    # the chain's 64 + 8 + 4 + 16 + 8 = 100 do not.
    for eng, err in ((teng, PiggybackIneligible), (jeng, JaxIneligible)):
        with pytest.raises(err, match="learned-position"):
            eng.decode_fused_shared_piggy(*args)
