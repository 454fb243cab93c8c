"""The port's 8-bit scoring slice against the JAX engine, end to end.

Both engines hold the same dynamic-int8 parameters (the JAX
``quantize_decoder_params(..., dynamic=True)`` tree, handed to the port
through ``params_from_jax``) and run the 8-bit path: s8 x s8 -> s32
layer products, the weight-only lm_head, the prefill flash kernel
(``use_flash_attention``), the two-leg cascade with int8 QK^T in its
trunk leg (``cascade_fused_suffix=False``, ``CascadeConfig(int8_qk=True)``)
and the speculative verify loop on dispatches without a trunk. The JAX
side arms its three interpreter hooks (flash, cascade, fused decode) per
test, so its Pallas kernels' arithmetic is the oracle; the port runs on
``device="cpu"``, its kernels' plain versions.

Discrete outputs (generated ids, top-2 ids, position_found,
yes_no_found, texts) must be exact. Floats agree within 1e-4, looser
than the float engine's 1e-5: the two frameworks' activations differ by
~1e-7 (sums in another order, which can also change with the number of
CPU threads), and where such a drift crosses a rounding boundary of the
per-token quantization one int8 payload moves by one step, which moves
that product by one weight scale. (At these inputs the floats also held
to 1e-5.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import CascadeConfig as JaxCascadeConfig
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models import quant as jq
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import CascadeConfig, RuntimeConfig
from lir_tpu_torch.data import WORD_MEANING_QUESTIONS, format_base_prompt
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder as tdec
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.quant import QuantTensor
from lir_tpu_torch.models.registry import ModelConfig

FTOL = 1e-4
CFG = dict(name="engine-int8-tiny", vocab_size=FakeTokenizer.VOCAB,
           hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128, max_seq_len=512, use_flash_attention=True)
WEIGHT_SCALE = 4.0
RT = dict(batch_size=4, max_new_tokens=12, spec_k=4,
          cascade_fused_suffix=False)


@pytest.fixture(autouse=True)
def _hooks():
    names = ("FLASH_INTERPRET_ON_CPU", "CASCADE_INTERPRET_ON_CPU",
             "FUSED_DECODE_INTERPRET_ON_CPU")
    old = [getattr(jdec, n) for n in names]
    for n in names:
        setattr(jdec, n, True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    for n, v in zip(names, old):
        setattr(jdec, n, v)


@pytest.fixture(scope="module")
def engines():
    cfg_j = JaxModelConfig(**CFG)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    qtree = jq.quantize_decoder_params(jax.tree.map(jnp.asarray, tree),
                                       dynamic=True)
    jeng = JaxEngine(
        qtree, cfg_j, JaxFakeTokenizer(),
        JaxRuntimeConfig(piggyback_prefill=False, prefix_cache=False, **RT),
        cascade_config=JaxCascadeConfig(int8_qk=True))
    teng = ScoringEngine(
        params_from_jax(jax.tree.map(np.asarray, qtree), ModelConfig(**CFG),
                        device="cpu"),
        ModelConfig(**CFG), FakeTokenizer(), RuntimeConfig(**RT),
        cascade_config=CascadeConfig(int8_qk=True), device="cpu")
    assert isinstance(teng.params["layers"]["wq"], QuantTensor)
    assert teng.params["layers"]["wq"].dynamic
    return jeng, teng


def _compare_fused(a, b):
    for name in ("generated", "top2_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=name)
    for name in ("p_yes", "p_no", "weighted_confidence", "topk_logprobs"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   getattr(b, name).numpy(), atol=FTOL,
                                   rtol=0, err_msg=name)


def _dispatch(eng, rows, bucket):
    n = len(rows)
    return eng.decode_fused_shared(
        [""] * n, [""] * n, np.full(n, 5, np.int32), np.full(n, 9, np.int32),
        new_tokens=3, conf_tokens=4, pretokenized_a=[r + [5, 6] for r in rows],
        pretokenized_b=[r + [7, 8] for r in rows], bucket=bucket,
        sfx_buckets_ab=(8, 8), reuse_cache=True, n_real=n)


def _count_flash(monkeypatch):
    """Count the port's flash-route calls (on the CPU the wrapper's own
    count stays 0: it counts kernel launches only)."""
    calls = []
    real = tdec.ops.flash_attention

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)

    monkeypatch.setattr(tdec.ops, "flash_attention", spy)
    return calls


def test_trunk_dispatch_int8_cascade_matches_jax(engines, monkeypatch):
    """A shared-trunk dispatch: flash prefill of the trunk, the two-leg
    cascade with int8 QK^T, the trunk decode kernel."""
    jeng, teng = engines
    calls = _count_flash(monkeypatch)
    prefix_calls = []
    real_prefix = tdec.ops.cascade_attention

    def spy(*a, **kw):
        prefix_calls.append((kw["int8_qk"], kw["fused_suffix"]))
        return real_prefix(*a, **kw)

    monkeypatch.setattr(tdec.ops, "cascade_attention", spy)
    rng = np.random.default_rng(5)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    rows = [head + [int(x) for x in rng.integers(3, 900, 6 - (r % 3))]
            for r in range(4)]
    before = teng.cascade_stats["cascade_dispatches"]
    out_j = _dispatch(jeng, rows, 96)
    out_t = _dispatch(teng, rows, 96)
    assert teng.cascade_stats["cascade_dispatches"] == before + 1
    assert prefix_calls and set(prefix_calls) == {(True, False)}
    assert calls, "the trunk prefill did not take the flash route"
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)


def test_untrunked_dispatch_flash_and_spec_match_jax(engines, monkeypatch):
    """A dispatch with no common trunk: flash prefill at bucket 64, then
    the speculative verify loop."""
    jeng, teng = engines
    calls = _count_flash(monkeypatch)
    rng = np.random.default_rng(6)
    rows = [[int(x) for x in rng.integers(3, 900, 40 + r)] for r in range(4)]
    before = teng.spec_stats["spec_dispatches"]
    out_j = _dispatch(jeng, rows, 64)
    out_t = _dispatch(teng, rows, 64)
    assert teng.spec_stats["spec_dispatches"] == before + 1
    assert calls == [(4, 64, 4, 16)] * CFG["n_layers"]
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)


def test_word_meaning_sweep_int8_matches_jax(engines, monkeypatch):
    """score_prompts through the word-meaning sweep: flash prefill and
    the flat decode kernel on int8 weights."""
    jeng, teng = engines
    calls = _count_flash(monkeypatch)
    questions = WORD_MEANING_QUESTIONS[:4]
    jrows = jsweep.run_word_meaning_sweep(jeng, "m", "base", questions,
                                          format_base_prompt)
    trows = tsweep.run_word_meaning_sweep(teng, "m", "base", questions,
                                          format_base_prompt)
    assert calls, "no word-meaning prefill took the flash route"
    for a, b in zip(jrows, trows):
        assert (a.prompt, a.model_output, a.position_found, a.yes_no_found) \
            == (b.prompt, b.model_output, b.position_found, b.yes_no_found)
        for f in ("yes_prob", "no_prob", "relative_prob"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=FTOL, rtol=0, err_msg=f)


def test_int8_cascade_agrees_with_float_cascade(engines):
    """The same trunk dispatch with float QK^T in the trunk leg: the
    yes>no decision at position 0 is the int8 one's on every row."""
    _, teng = engines
    fl = ScoringEngine(teng.params, ModelConfig(**CFG), FakeTokenizer(),
                       RuntimeConfig(**RT), device="cpu")
    rng = np.random.default_rng(5)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    rows = [head + [int(x) for x in rng.integers(3, 900, 6 - (r % 3))]
            for r in range(4)]
    a = _dispatch(teng, rows, 96)[0]
    b = _dispatch(fl, rows, 96)[0]
    assert fl.cascade_stats["cascade_dispatches"] == 1
    np.testing.assert_array_equal((a.p_yes[:, 0] > a.p_no[:, 0]).numpy(),
                                  (b.p_yes[:, 0] > b.p_no[:, 0]).numpy())
    assert not fl.cascade_cfg.int8_qk


def test_trunk_dispatch_quantizes_trunk_keys_once_and_matches_jax(engines, monkeypatch):
    """The trunk dispatch's cascade extension quantizes every layer's
    trunk keys in one ops.quantize_rows call and each layer's int8 trunk
    leg reads its slice (counted at the decoder's lookups); its readouts
    still match the JAX engine's."""
    jeng, teng = engines
    quant_calls, keyed = [], []
    real_quant, real_cascade = tdec.ops.quantize_rows, tdec.ops.cascade_attention

    def quant_spy(x):
        quant_calls.append(tuple(x.shape))
        return real_quant(x)

    def cascade_spy(*a, **kw):
        keyed.append(kw.get("trunk_k_int8") is not None)
        return real_cascade(*a, **kw)

    monkeypatch.setattr(tdec.ops, "quantize_rows", quant_spy)
    monkeypatch.setattr(tdec.ops, "cascade_attention", cascade_spy)
    rng = np.random.default_rng(9)
    head = [int(x) for x in rng.integers(3, 900, 72)]
    rows = [head + [int(x) for x in rng.integers(3, 900, 3 + r)] for r in range(4)]
    out_j = _dispatch(jeng, rows, 96)
    out_t = _dispatch(teng, rows, 96)
    assert len(quant_calls) == 1
    assert keyed == [True] * CFG["n_layers"]
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)
