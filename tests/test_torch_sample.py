"""The port's temperature sampling against ``jax.random`` and the JAX
package's sampler, on the CPU.

- ``engine/prng.py`` against ``jax.random`` (threefry2x32 under
  ``jax_threefry_partitionable``, asserted on): keys, ``fold_in``,
  ``split``, bits and uniforms bitwise over 4,096 random keys in one
  vectorised call each; Gumbel noise within 1e-6 (the last place of
  ``log``, which XLA's and torch's CPU libraries round differently).
- ``ops.gumbel_argmax_plain`` (the kernel's twin, which a CPU tensor
  runs) against ``jax.random.categorical`` in both key modes: ids equal
  wherever JAX's top-2 perturbed scores are 1e-5 apart or more, and no
  row closer than that in these draws.
- ``generate.sample_decode`` against the JAX function on a tiny float32
  llama fed the same weights (``params_from_jax``): ids exact with per-row
  keys and with one key, on a dynamic-int8 tree, with the EOS stop on the
  chain probe of ``tests/test_engine_extras.py`` (its forwards stopping
  at the first all-done check), and at temperature 1e-4 equal to
  ``greedy_decode``.
- ``score_prompts_sampled`` and ``count_averaged_responses`` against the
  JAX engine's, and the reasoning sweep (``run_perturbation_sweep(
  reasoning=True)``) against the JAX sweep's D6 rows, every field equal;
  a resumed reasoning sweep samples what the whole run sampled.

The JAX engine and the tiny trees are built once for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import generate as jgen
from lir_tpu.engine import score as jscore
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models import quant as jquant
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch import ops
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LegalPrompt
from lir_tpu_torch.engine import generate as tgen
from lir_tpu_torch.engine import grid as tgrid
from lir_tpu_torch.engine import prng, score as tscore
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder as tdec
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.utils.manifest import SweepManifest

N_KEYS = 4096
GUMBEL_TOL = 1e-6
NEAR_TIE = 1e-5
CFG = dict(name="sample-tiny", vocab_size=FakeTokenizer.VOCAB,
           hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128, max_seq_len=512)
# Weights spread beyond the 0.02 init, so that the logits spread out.
WEIGHT_SCALE = 4.0
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tiny launch-bound ops: on a host whose cores are busy
    with other test workers, torch's intra-op thread team makes them many
    times slower. The module runs on one thread and gives the count
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture(scope="module")
def draws():
    """4,096 random keys and data words."""
    rng = np.random.default_rng(17)
    return _u32(rng, N_KEYS, 2), _u32(rng, N_KEYS)


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_jax_threefry_is_partitionable():
    """The port copies the partitionable layout of JAX's draws: a change
    of JAX's default must fail here first."""
    assert jax.config.jax_threefry_partitionable is True


def test_prng_key_is_jax():
    seeds = np.random.default_rng(5).integers(-2**31, 2**31, N_KEYS,
                                              dtype=np.int64)
    ref = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.int32))
    got = np.stack([prng.prng_key(int(s)).numpy() for s in seeds])
    np.testing.assert_array_equal(got, _i64(ref))


def test_fold_in_is_jax(draws):
    keys, data = draws
    ref = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data))
    got = prng.fold_in(_i64(keys), torch.as_tensor(_i64(data)))
    np.testing.assert_array_equal(got.numpy(), _i64(ref))


def test_split_is_jax(draws):
    keys, _ = draws
    ref = jax.vmap(lambda k: jax.random.split(k, 5))(jnp.asarray(keys))
    np.testing.assert_array_equal(prng.split(keys, 5).numpy(), _i64(ref))


def test_random_bits_is_jax(draws):
    keys, _ = draws
    ref = jax.vmap(lambda k: jax.random.bits(k, (3, 7), jnp.uint32))(
        jnp.asarray(keys))
    np.testing.assert_array_equal(prng.random_bits32(keys, (3, 7)).numpy(),
                                  _i64(ref))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)],
                         ids=["unit", "tiny", "shifted"])
def test_uniform_is_jax_bitwise(draws, lo, hi):
    keys, _ = draws
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (3, 7), minval=lo, maxval=hi))(jnp.asarray(keys)))
    got = prng.uniform(keys, (3, 7), lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_gumbel_is_jax_to_the_last_place(draws):
    keys, _ = draws
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (3, 7)))(
        jnp.asarray(keys)))
    got = prng.gumbel(keys, (3, 7)).numpy()
    assert np.abs(got - ref).max() <= GUMBEL_TOL


def test_per_row_key_test():
    assert prng.is_per_row_keys(np.zeros((4, 2), np.uint32))
    assert not prng.is_per_row_keys(prng.prng_key(0))
    assert jgen.is_per_row_keys(jnp.zeros((4, 2), jnp.uint32))


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "one_key"])
def test_gumbel_argmax_plain_is_jax_categorical(per_row):
    """Eight steps of (8, 4,000) logits at four temperatures: the twin's
    ids are ``jax.random.categorical``'s, with the step keys and offsets
    ``generate.sample_keys`` makes for each mode."""
    rng = np.random.default_rng(11)
    B, V, T = 8, 4000, 8
    key = (_u32(rng, B, 2) if per_row
           else np.asarray(jax.random.PRNGKey(3)))
    step_keys, offsets = tgen.sample_keys(key, B, V, T, "cpu")
    if per_row:
        jkeys = jax.vmap(lambda t: jax.vmap(
            lambda k: jax.random.fold_in(k, t))(jnp.asarray(key)))(
                jnp.arange(T))
    else:
        jkeys = jax.random.split(jnp.asarray(key), T)
    near, checked = 0, 0
    for t in range(T):
        temp = (0.5, 0.9, 1.0, 1.7)[t % 4]
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        scaled = jnp.asarray(logits) / jnp.maximum(jnp.float32(temp), 1e-6)
        if per_row:
            ref = jax.vmap(jax.random.categorical)(jkeys[t], scaled)
            noise = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jkeys[t])
        else:
            ref = jax.random.categorical(jkeys[t], scaled, axis=-1)
            noise = jax.random.gumbel(jkeys[t], (B, V))
        top2 = np.sort(np.asarray(noise + scaled), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) >= NEAR_TIE
        near += int((~clear).sum())
        got = ops.gumbel_argmax(torch.from_numpy(logits), step_keys[t],
                                offsets, temp).numpy()
        np.testing.assert_array_equal(got[clear], np.asarray(ref)[clear])
        checked += int(clear.sum())
    assert near == 0 and checked == B * T


# ---------------------------------------------------------------------------
# sample_decode, score_prompts_sampled, the reasoning sweep
# ---------------------------------------------------------------------------

def seeded_tree(cfg_j, seed: int = 0):
    """A float32 JAX-layout tree of numpy arrays in ``init_params``'
    shapes (its abstract evaluation; no compile): norm scales 1, every
    other leaf normal at 0.02 * WEIGHT_SCALE, from ``seed``."""
    shapes = jax.eval_shape(lambda: jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.02
                * WEIGHT_SCALE).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, port cfg, port params, numpy tree) of the
    tiny llama."""
    cfg_j = JaxModelConfig(**CFG)
    tree = seeded_tree(cfg_j)
    cfg_t = ModelConfig(**CFG)
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"), tree)


def _tokens():
    rng = np.random.default_rng(1)
    toks = rng.integers(3, CFG["vocab_size"], size=(4, 16)).astype(np.int32)
    mask = np.ones_like(toks)
    toks[0, :5], mask[0, :5] = 0, 0       # a left-padded row
    return toks, mask


def _both(jparams, cfg_j, tparams, cfg_t, key, **kw):
    toks, mask = _tokens()
    ref = jgen.sample_decode(jparams, cfg_j, jnp.asarray(toks),
                             jnp.asarray(mask), jnp.asarray(key), **kw)
    tkw = dict(kw)
    if tkw.get("eos_id") is not None:
        tkw["eos_id"] = int(tkw["eos_id"])
    got = tgen.sample_decode(tparams, cfg_t, torch.from_numpy(toks),
                             torch.from_numpy(mask), np.asarray(key), **tkw)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "one_key"])
def test_sample_decode_is_jax(tiny, per_row):
    cfg_j, jparams, cfg_t, tparams, _ = tiny
    key = (jax.random.split(jax.random.PRNGKey(7), 4) if per_row
           else jax.random.PRNGKey(7))
    ref, got = _both(jparams, cfg_j, tparams, cfg_t, key, temperature=0.9,
                     max_new_tokens=12)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.shape == (4, 12)


def test_sample_decode_int8_is_jax(tiny):
    """The dynamic-int8 tree (s8 x s8 products) samples JAX's ids."""
    cfg_j, _, cfg_t, _, tree = tiny
    qtree = jquant.quantize_decoder_params(jax.tree.map(jnp.asarray, tree),
                                           dynamic=True)
    tq = params_from_jax(jax.tree.map(np.asarray, qtree), cfg_t,
                         device="cpu")
    key = jax.random.split(jax.random.PRNGKey(9), 4)
    ref, got = _both(qtree, cfg_j, tq, cfg_t, key, temperature=0.9,
                     max_new_tokens=8)
    np.testing.assert_array_equal(got, ref)


def test_sample_decode_eos_stop_is_jax_and_stops_forwards(monkeypatch):
    """The chain probe of tests/test_engine_extras.py (5 -> 6 -> EOS -> 7
    at temperature ~0): stopped and unstopped ids equal JAX's, the stopped
    rows emit EOS fill, and the port's forwards end at the first all-done
    check (DONE_CHECK_EVERY steps) instead of running the budget."""
    from chain7b import chain_param_tree

    eos = 3
    kw = dict(name="sample-eos", vocab_size=64, hidden_size=32, n_layers=2,
              n_heads=4, intermediate_size=64, max_seq_len=64,
              tie_embeddings=False)
    cfg_j, cfg_t = JaxModelConfig(**kw), ModelConfig(**kw)
    chain = {5: (6, 7), 6: (eos, 7), eos: (7, 8), 7: (7, 8)}
    jparams = chain_param_tree(cfg_j, chain, junk_next=7, junk_second=8,
                               dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg_t,
                              device="cpu")
    toks = np.full((2, 4), 5, dtype=np.int32)
    mask = np.ones_like(toks)
    key = jax.random.PRNGKey(0)
    n_new = 20
    free_j = np.asarray(jgen.sample_decode(
        jparams, cfg_j, jnp.asarray(toks), jnp.asarray(mask), key,
        temperature=1e-4, max_new_tokens=n_new))
    stop_j = np.asarray(jgen.sample_decode(
        jparams, cfg_j, jnp.asarray(toks), jnp.asarray(mask), key,
        temperature=1e-4, max_new_tokens=n_new, eos_id=jnp.int32(eos)))
    forwards = []
    step = tdec.decode_step
    monkeypatch.setattr(tdec, "decode_step",
                        lambda *a, **k: forwards.append(1) or step(*a, **k))
    args = (tparams, cfg_t, torch.from_numpy(toks), torch.from_numpy(mask),
            np.asarray(key))
    free_t = tgen.sample_decode(*args, temperature=1e-4,
                                max_new_tokens=n_new).numpy()
    assert len(forwards) == n_new
    forwards.clear()
    stop_t = tgen.sample_decode(*args, temperature=1e-4,
                                max_new_tokens=n_new, eos_id=eos).numpy()
    np.testing.assert_array_equal(free_t, free_j)
    np.testing.assert_array_equal(stop_t, stop_j)
    for r0, r1 in zip(free_t, stop_t):
        k = int(np.argmax(r0 == eos))
        assert (r0 == eos).any() and (r0[k + 1:] != eos).any()
        np.testing.assert_array_equal(r1[:k + 1], r0[:k + 1])
        assert (r1[k:] == eos).all()
    assert len(forwards) == tgen.DONE_CHECK_EVERY - 1


def test_low_temperature_sampling_is_greedy(tiny):
    cfg_j, jparams, cfg_t, tparams, _ = tiny
    key = jax.random.PRNGKey(4)
    ref, got = _both(jparams, cfg_j, tparams, cfg_t, key, temperature=1e-4,
                     max_new_tokens=12)
    toks, mask = _tokens()
    greedy, _ = tgen.greedy_decode(tparams, cfg_t, torch.from_numpy(toks),
                                   torch.from_numpy(mask), max_new_tokens=12)
    np.testing.assert_array_equal(got, greedy.numpy())
    np.testing.assert_array_equal(got, ref)


COUNT_CASES = [
    (["Covered", "Not Covered", "Covered", "Not Covered"], "Covered",
     "Not Covered"),
    (["Not Covered", "x", "Not Covered"], "Not Covered", "Covered"),
    (["b", "a", "a", "b"], "a", "b"),
    (["Yes", "No", "Yes", "maybe"], "Yes", "No"),
    ([], "Yes", "No"),
]


@pytest.mark.parametrize("runs,t1,t2", COUNT_CASES)
def test_count_averaged_responses_is_jax(runs, t1, t2):
    assert (tscore.count_averaged_responses(runs, t1, t2)
            == jscore.count_averaged_responses(runs, t1, t2))


RF, CF = "Answer Yes or No .", "Give a number from 0 to 100 ."
# Targets that FakeTokenizer's "<id>" texts hold in some runs, so the
# count fractions are neither all 0 nor all 1.
TARGETS = ("<1", "<5")


def _grid():
    rng = np.random.default_rng(23)

    def words(n):
        return " ".join(f"w{int(x)}" for x in rng.integers(0, 10**6, n))

    prompts = [LegalPrompt(main=words(12), response_format=RF,
                           target_tokens=TARGETS, confidence_format=CF)
               for _ in range(2)]
    perts = [[words(12) for _ in range(3)] for _ in prompts]
    return prompts, perts


PROMPTS, PERTS = _grid()
JAX_PROMPTS = [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                              target_tokens=p.target_tokens,
                              confidence_format=p.confidence_format)
               for p in PROMPTS]
RUNS = 3


@pytest.fixture(scope="module")
def engines(tiny):
    cfg_j, jparams, cfg_t, tparams, _ = tiny
    jeng = JaxEngine(jparams, cfg_j, JaxFakeTokenizer(), JaxRuntimeConfig(
        batch_size=4, max_new_tokens=6, spec_decode=False,
        piggyback_prefill=False, prefix_cache=False, aot_precompile=False,
        streaming_stats=False))
    teng = ScoringEngine(tparams, cfg_t, FakeTokenizer(), RuntimeConfig(
        batch_size=4, max_new_tokens=6, spec_decode=False), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "one_key"])
def test_score_prompts_sampled_is_jax(engines, per_row):
    jeng, teng = engines
    texts = [tgrid.build_grid("m", PROMPTS, PERTS)[i].binary_prompt
             for i in range(4)]
    key = (jax.random.split(jax.random.PRNGKey(2), 4) if per_row
           else jax.random.PRNGKey(2))
    ref = jeng.score_prompts_sampled(texts, [TARGETS] * 4, n_runs=RUNS,
                                     key=key)
    got = teng.score_prompts_sampled(texts, [TARGETS] * 4, n_runs=RUNS,
                                     key=np.asarray(key))
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(r) for r in ref]
    assert any(0 < g.token_1_prob + g.token_2_prob for g in got)


@pytest.fixture(scope="module")
def reasoning_rows(engines, tmp_path_factory):
    """(JAX rows, the port's rows, the port's results path)."""
    jeng, teng = engines
    tmp = tmp_path_factory.mktemp("reasoning")
    ref = jsweep.run_perturbation_sweep(
        jeng, "m", JAX_PROMPTS, PERTS, tmp / "jax.csv", reasoning=True,
        reasoning_runs=RUNS)
    got = tsweep.run_perturbation_sweep(
        teng, "m", PROMPTS, PERTS, tmp / "port.csv", reasoning=True,
        reasoning_runs=RUNS)
    return ref, got, tmp


def test_reasoning_sweep_rows_are_jax(reasoning_rows):
    """Every D6 field equal: texts, count fractions (multiples of 1/3),
    no log-prob map, the weighted confidence the parsed integer."""
    ref, got, tmp = reasoning_rows
    assert len(got) == len(ref) == sum(1 + len(p) for p in PERTS)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(r) for r in ref]
    for r in got:
        for p in (r.token_1_prob, r.token_2_prob):
            assert abs(p * RUNS - round(p * RUNS)) < 1e-9
        assert r.log_probabilities == ""
        assert r.weighted_confidence == (
            None if r.confidence_value is None else float(r.confidence_value))
    assert not (tmp / "port.accum.npz").exists()   # no streaming sink


def test_reasoning_resume_is_cell_deterministic(engines, reasoning_rows,
                                                tmp_path):
    """The first bucket's cells marked done: the rest, one bucket of the
    same shape, samples exactly what the whole run sampled."""
    _, teng = engines
    _, whole, _ = reasoning_rows
    manifest = SweepManifest(tmp_path / "resumed.manifest.jsonl",
                             tgrid.RESUME_KEY_FIELDS)
    manifest.mark_done_many([
        {"model": "m", "original_main": r.original_main,
         "rephrased_main": r.rephrased_main} for r in whole[:4]])
    resumed = tsweep.run_perturbation_sweep(
        teng, "m", PROMPTS, PERTS, tmp_path / "resumed.csv",
        manifest=manifest, reasoning=True, reasoning_runs=RUNS)
    assert [dataclasses.asdict(r) for r in resumed] == \
        [dataclasses.asdict(r) for r in whole[4:]]
