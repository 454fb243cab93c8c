"""The row-invariant decode ops and the trunk keys' quantization pass on
the CPU, against the JAX package.

``ops.row_gemm`` / ``ops.row_norm`` / ``ops.row_add_norm``
(``csrc/row_gemm.cu`` on the card) carry the decode step's and the
verify window's bf16 projections, norms and residual adds; on CPU
tensors they run their plain versions, which are the decoder's own
``x @ w``, norm, and add then norm. The same numpy-seeded inputs go through
the JAX package's ``quant.matmul`` and ``decoder._norm`` (float32, atol
1e-5). ``ops.quantize_rows`` (the bf16 int8 trunk leg's key quantization
on the card) is bitwise the JAX package's ``dynamic_quant`` on the CPU.
The decoder routes bf16 steps and windows through the row ops and
nothing else changes there: on the CPU a bf16 step is bitwise the step
with the library calls patched back in. The split count of the
kernel's K reduction is a function of the weight's shape alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu_torch import ops


def _rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_row_norm_matches_jax(norm):
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models.registry import ModelConfig

    rng = np.random.default_rng(0)
    x, scale, bias = _rnd(rng, 3, 5, 64, scale=3), _rnd(rng, 64), _rnd(rng, 64)
    cfg = ModelConfig(name="t", vocab_size=8, hidden_size=64, n_layers=1,
                      n_heads=2, intermediate_size=8, norm=norm)
    p = {"scale": jnp.asarray(scale)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(bias)
    ref = np.asarray(jdec._norm(jnp.asarray(x), p, cfg))
    got = ops.row_norm(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias) if norm == "layernorm" else None,
                       cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_row_add_norm_matches_jax(norm):
    """The residual add and the norm after it, against the JAX package's
    ``x + attn`` then ``decoder._norm``: the sum exact, the norm within
    the norm's 1e-5."""
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models.registry import ModelConfig

    rng = np.random.default_rng(3)
    x, d = _rnd(rng, 3, 5, 64, scale=3), _rnd(rng, 3, 5, 64)
    scale, bias = _rnd(rng, 64), _rnd(rng, 64)
    cfg = ModelConfig(name="t", vocab_size=8, hidden_size=64, n_layers=1,
                      n_heads=2, intermediate_size=8, norm=norm)
    p = {"scale": jnp.asarray(scale)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(bias)
    s_ref = jnp.asarray(x) + jnp.asarray(d)
    h_ref = np.asarray(jdec._norm(s_ref, p, cfg))
    s, h = ops.row_add_norm(torch.from_numpy(x), torch.from_numpy(d),
                            torch.from_numpy(scale),
                            torch.from_numpy(bias) if norm == "layernorm"
                            else None, cfg.norm_eps)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-5, rtol=0)


def test_row_gemm_matches_jax():
    from lir_tpu.models.quant import matmul as jmm

    rng = np.random.default_rng(1)
    x, w = _rnd(rng, 2, 4, 96), _rnd(rng, 96, 40, scale=0.1)
    ref = np.asarray(jmm(jnp.asarray(x), jnp.asarray(w)))
    got = ops.row_gemm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_quantize_rows_bitwise_jax():
    from lir_tpu.models.quant import dynamic_quant as jquant

    rng = np.random.default_rng(2)
    x = _rnd(rng, 4, 70, 64, scale=2)
    x[0, 3] = 0.0                                 # a zero row: the 1e-8 floor
    jq, js = jquant(jnp.asarray(x))
    q, s = ops.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("n,k,splits", [(4096, 4096, 3), (11008, 4096, 2),
                                        (4096, 11008, 3), (32000, 4096, 1),
                                        (96, 200, 1), (64, 4544, 8)])
def test_gemm_splits_follow_the_weight_shape(n, k, splits):
    """The kernel's K split: the fewest splits whose (128-column tile,
    split) blocks number 96 or more, each split at least 4 chunks of 64,
    at most 8 (one cluster adds them)."""
    assert ops.gemm_splits(n, k) == splits


def test_bf16_decode_runs_the_row_ops(monkeypatch):
    """A bf16 decode step and verify window go through row_gemm (every
    projection of every layer), row_norm (the first block's ln1) and
    row_add_norm (every other norm with the residual add before it), and
    on the CPU give the bits of the same forward with the library calls
    and the adds apart."""
    from lir_tpu_torch.models import decoder, registry

    cfg = registry.tiny("mistral")
    params = decoder.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    B, S = 2, 12
    tokens = torch.randint(3, cfg.vocab_size, (B, S), dtype=torch.int32)
    mask = torch.ones((B, S), dtype=torch.int32)
    T = S + 6
    calls = {"row_gemm": 0, "row_norm": 0, "row_add_norm": 0}

    def count(name):
        fn = getattr(ops, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def run():
        logits0, cache, pos = decoder.prefill(params, cfg, tokens, mask, T)
        cm = torch.nn.functional.pad(mask, (0, T - S))
        cm[:, S] = 1
        tok = torch.argmax(logits0, -1).to(torch.int32)
        step, cache = decoder.decode_step(params, cfg, cache, tok, pos, S, cm)
        cm[:, S + 1:S + 4] = 1
        win = torch.stack([torch.argmax(step, -1).to(torch.int32)] * 3, 1)
        start = torch.full((B,), S + 1, dtype=torch.int32)
        V, _ = decoder.verify_extend(params, cfg, cache, win, cm, start)
        return step, V

    monkeypatch.setattr(ops, "row_gemm", count("row_gemm"))
    monkeypatch.setattr(ops, "row_norm", count("row_norm"))
    monkeypatch.setattr(ops, "row_add_norm", count("row_add_norm"))
    got = run()
    L = cfg.n_layers
    assert calls == {"row_gemm": 2 * 7 * L, "row_norm": 2,
                     "row_add_norm": 2 * 2 * L}

    def add_then_norm(x, d, p, cfg):
        s = x + d
        return s, decoder._norm(s, p, cfg)

    monkeypatch.setattr(decoder, "_row_mm", decoder._mm)
    monkeypatch.setattr(decoder, "_row_norm", decoder._norm)
    monkeypatch.setattr(decoder, "_row_add_norm", add_then_norm)
    ref = run()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
