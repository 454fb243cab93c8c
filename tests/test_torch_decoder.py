"""The port's decoder against the JAX package's decoder, family by family.

Both packages get the same parameters (the JAX init, handed over as numpy
arrays through ``params_from_jax``) and the same token ids, and the
logits of ``prefill``, ``extend``, ``decode_step`` (flat and on a
cascade-built cache with a trunk) must agree within atol 1e-4 in
float32. The JAX side runs its flash-decode kernel in the Pallas
interpreter (the fused-decode hook armed, restored after), its cascade
kernel likewise (its CPU default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.models import decoder as jdec
from lir_tpu.models import registry as jreg
from lir_tpu_torch.models import decoder as tdec
from lir_tpu_torch.models import registry as treg
from lir_tpu_torch.models.convert import params_from_jax

FAMILIES = ["gpt2", "gptneox", "llama", "mistral", "falcon", "bloom", "opt"]
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = jdec.FUSED_DECODE_INTERPRET_ON_CPU
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _pair(family):
    cfg_j = jreg.tiny(family)
    cfg_t = treg.tiny(family)
    pj = jdec.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, pj)
    pt = params_from_jax(tree, cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_extend_decode_match_jax(family):
    cfg_j, pj, cfg_t, pt = _pair(family)
    rng = np.random.default_rng(0)
    B, S, S2, new = 2, 12, 3, 4
    T = S + S2 + new
    toks = rng.integers(3, cfg_j.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0                                         # left padding
    sfx = rng.integers(3, cfg_j.vocab_size, (B, S2)).astype(np.int32)
    sfx_mask = np.ones((B, S2), np.int32)
    sfx_mask[0, 2:] = 0                                     # right padding
    t = torch.from_numpy

    lj, cj, posj = jdec.prefill(pj, cfg_j, jnp.asarray(toks),
                                jnp.asarray(mask), T)
    lt, ct, post = tdec.prefill(pt, cfg_t, t(toks), t(mask), T)
    _close(lj, lt)
    _close(cj[0], ct[0])
    np.testing.assert_array_equal(np.asarray(posj), post.numpy())

    cm = np.concatenate([mask, sfx_mask, np.zeros((B, new), np.int32)], 1)
    lj, cj, posj = jdec.extend(pj, cfg_j, cj, jnp.asarray(sfx),
                               jnp.asarray(sfx_mask), jnp.asarray(cm), S)
    lt, ct, post = tdec.extend(pt, cfg_t, ct, t(sfx), t(sfx_mask), t(cm), S)
    _close(lj, lt)
    np.testing.assert_array_equal(np.asarray(posj), post.numpy())

    slot = S + S2
    cm[:, slot] = 1
    token = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    position = np.asarray(posj).astype(np.int32)
    lj, _ = jdec.decode_step(pj, cfg_j, cj, jnp.asarray(token),
                             jnp.asarray(position), slot, jnp.asarray(cm))
    lt, _ = tdec.decode_step(pt, cfg_t, ct, t(token), t(position), slot,
                             t(cm))
    _close(lj, lt)


@pytest.mark.parametrize("family", FAMILIES)
def test_cascade_extend_and_trunk_decode_match_jax(family):
    cfg_j, pj, cfg_t, pt = _pair(family)
    rng = np.random.default_rng(1)
    B, Tt, R, new = 3, 64, 5, 2
    total = Tt + R + new
    trunk = rng.integers(3, cfg_j.vocab_size, (1, Tt)).astype(np.int32)
    ones = np.ones((1, Tt), np.int32)
    rem = rng.integers(3, cfg_j.vocab_size, (B, R)).astype(np.int32)
    rem_mask = np.ones((B, R), np.int32)
    rem_mask[1, 3:] = 0
    rem_mask[2, 1:] = 0
    t = torch.from_numpy

    _, tcj, _ = jdec.prefill(pj, cfg_j, jnp.asarray(trunk), jnp.asarray(ones),
                             Tt)
    _, tct, _ = tdec.prefill(pt, cfg_t, t(trunk), t(ones), Tt)
    cj = jdec.cascade_extend(pj, cfg_j, tcj, jnp.asarray(rem),
                             jnp.asarray(rem_mask), Tt, total)
    ct = tdec.cascade_extend(pt, cfg_t, tct, t(rem), t(rem_mask), Tt, total)
    _close(cj[0], ct[0])
    _close(cj[1], ct[1])

    # Decode on the cascade cache: the port's trunk-aware route reads the
    # one full trunk split from row 0.
    cm = np.concatenate([np.ones((B, Tt), np.int32), rem_mask,
                         np.zeros((B, new), np.int32)], 1)
    slot = Tt + R
    cm[:, slot] = 1
    token = rng.integers(3, cfg_j.vocab_size, (B,)).astype(np.int32)
    position = (Tt + rem_mask.sum(-1)).astype(np.int32)
    lj, _ = jdec.decode_step(pj, cfg_j, cj, jnp.asarray(token),
                             jnp.asarray(position), slot, jnp.asarray(cm),
                             trunk_len=Tt)
    lt, _ = tdec.decode_step(pt, cfg_t, ct, t(token), t(position), slot,
                             t(cm), trunk_len=Tt)
    _close(lj, lt)


def _unfused_add_norm(x, d, p, cfg):
    """The route before the fused residual add: the bf16 add, then the
    step's norm of the sum."""
    s = x + d
    return s, tdec._row_norm(s, p, cfg)


@pytest.mark.parametrize("family", ["llama", "bloom"])
def test_fused_add_norm_step_and_window_bitwise_unfused(family, monkeypatch):
    """The decode step and the verify window with each sequential
    block's residual add fused into the norm after it (``row_add_norm``:
    x + attn with ln2, x + mlp with the next ln1 or the final norm) give
    logits bitwise the same forward with the adds apart and
    ``_row_norm``, in bf16 on the CPU, at an RMSNorm and a LayerNorm
    family; and they take the fused op 2 L times a forward."""
    cfg = treg.tiny(family)
    params = tdec.init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    B, S, T = 2, 10, 16
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32))
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, :3] = 0
    calls = []

    def run():
        logits0, cache, pos = tdec.prefill(params, cfg, tokens, mask, T)
        cm = torch.nn.functional.pad(mask, (0, T - S))
        cm[:, S] = 1
        tok = torch.argmax(logits0, -1).to(torch.int32)
        step, cache = tdec.decode_step(params, cfg, cache, tok, pos, S, cm)
        cm[:, S + 1:S + 4] = 1
        win = torch.stack([torch.argmax(step, -1).to(torch.int32)] * 3, 1)
        start = torch.full((B,), S + 1, dtype=torch.int32)
        window, _ = tdec.verify_extend(params, cfg, cache, win, cm, start)
        return step, window

    fused_op = tdec.ops.row_add_norm

    def counted(*a, **k):
        calls.append(a[0].shape)
        return fused_op(*a, **k)

    monkeypatch.setattr(tdec.ops, "row_add_norm", counted)
    got = run()
    assert len(calls) == 2 * 2 * cfg.n_layers
    monkeypatch.setattr(tdec, "_row_add_norm", _unfused_add_norm)
    ref = run()
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r)


@pytest.mark.parametrize("family", ["llama", "mistral", "falcon"])
def test_cascade_extend_quantizes_trunk_keys_once(family, monkeypatch):
    """With int8 QK^T, cascade_extend quantizes every layer's trunk keys
    in ONE ops.quantize_rows call over (L * K * Tt, hd) rows (counted at
    the decoder's own lookup) and hands each layer's trunk leg its slice:
    the cache is bitwise the one each layer's own quantization gives.
    Without int8 QK^T nothing is quantized."""
    _, _, cfg_t, pt = _pair(family)
    rng = np.random.default_rng(2)
    B, Tt, R = 3, 64, 5
    t = torch.from_numpy
    trunk = t(rng.integers(3, cfg_t.vocab_size, (1, Tt)).astype(np.int32))
    rem = t(rng.integers(3, cfg_t.vocab_size, (B, R)).astype(np.int32))
    rem_mask = torch.ones((B, R), dtype=torch.int32)
    rem_mask[1, 2:] = 0
    _, tct, _ = tdec.prefill(pt, cfg_t, trunk, torch.ones((1, Tt), dtype=torch.int32), Tt)
    calls = []
    real_quant = tdec.ops.quantize_rows

    def spy(x):
        calls.append(tuple(x.shape))
        return real_quant(x)

    monkeypatch.setattr(tdec.ops, "quantize_rows", spy)
    hoisted = tdec.cascade_extend(pt, cfg_t, tct, rem, rem_mask, Tt, Tt + R + 2,
                                  int8_qk=True)
    assert calls == [(cfg_t.n_layers * cfg_t.n_kv_heads * Tt, cfg_t.head_dim)]
    real_cascade = tdec.ops.cascade_attention
    monkeypatch.setattr(tdec.ops, "cascade_attention",
                        lambda *a, trunk_k_int8=None, **kw: real_cascade(*a, **kw))
    own = tdec.cascade_extend(pt, cfg_t, tct, rem, rem_mask, Tt, Tt + R + 2, int8_qk=True)
    for a, b in zip(hoisted, own):
        assert torch.equal(a, b)
    calls.clear()
    tdec.cascade_extend(pt, cfg_t, tct, rem, rem_mask, Tt, Tt + R + 2)
    assert calls == []
