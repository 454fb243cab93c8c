"""The port's scoring slice against the JAX engine, end to end.

JAX side: a ``lir_tpu`` ScoringEngine with FakeTokenizer, speculative
decode, piggybacking and the prefix cache off, and both interpreter hooks
armed, so that its Pallas kernels' arithmetic is the oracle. Port side:
the port's engine on ``device="cpu"`` with the same parameters. Discrete
outputs (generated ids, position_found, yes_no_found, top-2 ids, texts)
must be exact; probabilities and confidences agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import WORD_MEANING_QUESTIONS as JAX_QUESTIONS
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import WORD_MEANING_QUESTIONS, format_base_prompt
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig

FTOL = 1e-5
CFG = dict(name="engine-tiny", vocab_size=FakeTokenizer.VOCAB,
           hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128, max_seq_len=512)
# Larger weights than the 0.02 init, so that the logits of the tiny model
# spread out and no two candidate tokens sit within float noise.
WEIGHT_SCALE = 4.0


@pytest.fixture(scope="module")
def engines():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_j = JaxModelConfig(**CFG)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    jeng = JaxEngine(
        jax.tree.map(jnp.asarray, tree), cfg_j, JaxFakeTokenizer(),
        JaxRuntimeConfig(batch_size=4, max_new_tokens=12, spec_decode=False,
                         piggyback_prefill=False, prefix_cache=False))
    teng = ScoringEngine(
        params_from_jax(tree, ModelConfig(**CFG), device="cpu"),
        ModelConfig(**CFG), FakeTokenizer(),
        RuntimeConfig(batch_size=4, max_new_tokens=12, spec_decode=False),
        device="cpu")
    yield jeng, teng
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _compare_fused(a, b):
    """JAX FusedDecodeOut vs the port's."""
    for name in ("generated", "top2_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=name)
    for name in ("p_yes", "p_no", "weighted_confidence", "topk_logprobs"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   getattr(b, name).numpy(), atol=FTOL,
                                   rtol=0, err_msg=name)
    vals = np.asarray(a.topk_logprobs)
    ids_a, ids_b = np.asarray(a.topk_ids), b.topk_ids.numpy()
    # Ids are exact wherever the neighbouring values are separated.
    gap = np.diff(vals, axis=-1)
    sep = np.ones_like(vals, bool)
    sep[:, 1:] &= np.abs(gap) > FTOL
    sep[:, :-1] &= np.abs(gap) > FTOL
    np.testing.assert_array_equal(ids_a[sep], ids_b[sep])


def test_word_meaning_sweep_matches_jax(engines):
    jeng, teng = engines
    assert WORD_MEANING_QUESTIONS == JAX_QUESTIONS
    questions = WORD_MEANING_QUESTIONS[:5]
    jrows = jsweep.run_word_meaning_sweep(jeng, "m", "base", questions,
                                          format_base_prompt)
    trows = tsweep.run_word_meaning_sweep(teng, "m", "base", questions,
                                          format_base_prompt)
    assert len(trows) == len(questions)
    for a, b in zip(jrows, trows):
        assert (a.prompt, a.model_output, a.position_found, a.yes_no_found) \
            == (b.prompt, b.model_output, b.position_found, b.yes_no_found)
        for f in ("yes_prob", "no_prob", "relative_prob"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=FTOL, rtol=0, err_msg=f)


def _dispatch(eng, rows, bucket):
    bins = [r + [5, 6] for r in rows]
    conf = [r + [7, 8] for r in rows]
    t1 = np.asarray([5] * len(rows), np.int32)
    t2 = np.asarray([9] * len(rows), np.int32)
    return eng.decode_fused_shared(
        [""] * len(rows), [""] * len(rows), t1, t2, new_tokens=3,
        conf_tokens=4, pretokenized_a=bins, pretokenized_b=conf,
        bucket=bucket, sfx_buckets_ab=(8, 8), reuse_cache=True,
        n_real=len(rows))


def test_shared_trunk_dispatch_takes_cascade(engines):
    jeng, teng = engines
    rng = np.random.default_rng(5)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    rows = [head + [int(x) for x in rng.integers(3, 900, 6 - (r % 3))]
            for r in range(4)]
    before = dict(teng.cascade_stats)
    out_j = _dispatch(jeng, rows, 96)
    out_t = _dispatch(teng, rows, 96)
    assert jeng.cascade_stats.cascade_dispatches >= 1
    assert teng.cascade_stats["cascade_dispatches"] == \
        before.get("cascade_dispatches", 0) + 1
    assert teng.cascade_stats["cascade_decode_dispatches"] == \
        before.get("cascade_decode_dispatches", 0) + 1
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)


def test_untrunked_dispatch_takes_dense_shared(engines):
    jeng, teng = engines
    rng = np.random.default_rng(6)
    rows = [[int(x) for x in rng.integers(3, 900, 40 + r)] for r in range(4)]
    before = dict(teng.cascade_stats)
    out_j = _dispatch(jeng, rows, 64)
    out_t = _dispatch(teng, rows, 64)
    assert teng.cascade_stats["dense_shared_dispatches"] == \
        before.get("dense_shared_dispatches", 0) + 1
    assert teng.cascade_stats["cascade_dispatches"] == \
        before.get("cascade_dispatches", 0)
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)


@pytest.mark.parametrize("classes", ["digit_then_stop", "eos_only"])
def test_early_stop_matches_jax(engines, classes):
    """The fused loop with a stop table armed: every token a prefixed pure
    digit (a digit run opens at step 0 and closes at step 1, so every row
    is done from step 2 and the loop skips the model), or the EOS-only
    table."""
    from lir_tpu.engine import generate as jgen
    from lir_tpu.engine import tokens as jtok
    from lir_tpu_torch.engine import generate as tgen

    jeng, teng = engines
    V = CFG["vocab_size"]
    if classes == "digit_then_stop":
        table = np.full((V,), jtok.STOP_PURE | jtok.STOP_PREFIX, np.int32)
    else:
        table = jtok.eos_only_stop_classes(V)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, 900, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[2, :3] = 0
    ids = np.asarray([1, 1, 1], np.int32), np.asarray([2, 2, 2], np.int32)
    dig = np.asarray([10, 11, 12], np.int32), np.asarray([1.0, 2.0, 3.0],
                                                        np.float32)
    eos = 7
    out_j = jgen.greedy_decode_fused(
        jeng.params, jeng.cfg, jnp.asarray(toks), jnp.asarray(mask),
        *(jnp.asarray(a) for a in ids + dig), max_new_tokens=5,
        stop_mask=jnp.asarray(table), eos_id=jnp.int32(eos))
    t = torch.from_numpy
    out_t = tgen.greedy_decode_fused(
        teng.params, teng.cfg, t(toks), t(mask), *(t(a) for a in ids + dig),
        max_new_tokens=5, stop_mask=t(table), eos_id=eos)
    _compare_fused(out_j, out_t)
    if classes == "digit_then_stop":
        assert bool((out_t.generated[:, 2:] == eos).all())
