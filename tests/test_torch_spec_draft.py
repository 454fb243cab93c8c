"""Fleet draft models in the port's speculative verify, against the JAX
package (the port's counterpart of ``tests/test_spec_decode.py``'s
fleet-draft tests).

The same numpy-seeded verifier and draft weights go to a JAX engine and
to the port's CPU engine, each armed with ``set_spec_draft``; the JAX
side's decode kernels run in the Pallas interpreter (armed per test).

- A fleet draft (a 1-layer model of other weights): the consumed
  outputs are the JAX engine's with the same draft (ids exact, floats
  1e-5, the weighted confidence, a 0-100 value, to 1e-6 relative:
  float32's resolution there) and, ids and position-0 readouts, bitwise
  the port's own sequential route; both packages count the drafts in
  the fleet lane (``draft_fleet`` > 0, no n-gram drafts).
- A perfect drafter (the verifier's own weights): every draft accepted,
  ``accepted_fleet == draft_fleet > 0``, and the verify forwards at
  most half the sequential ones. The port's draft cache follows its
  compacted windows: a misaligned draft would only show here.
- A draft model of another vocabulary is refused.
- The fleet-draft x paged exclusion and the governor's ``no_spec`` rung
  each count one fallback and give the speculative route's consumed
  outputs bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import FTOL, WEIGHT_SCALE, _dispatch

CFG = dict(name="draft-tiny", vocab_size=1000, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, intermediate_size=128, max_seq_len=512)
SPEC_K = 4


@pytest.fixture(autouse=True)
def _interpret():
    from lir_tpu.models import decoder as jdec

    old = (jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU)
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    jdec.CASCADE_INTERPRET_ON_CPU = True
    yield
    jdec.FUSED_DECODE_INTERPRET_ON_CPU, jdec.CASCADE_INTERPRET_ON_CPU = old


def _tree(cfg_j, seed, scale):
    from lir_tpu.models import decoder as jdec

    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * scale
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * scale
    return tree


@pytest.fixture(scope="module")
def models():
    """(verifier, draft), each as (JAX cfg, JAX params, port cfg, port
    params): the verifier's weights scaled up so no two candidate tokens
    sit within float noise; the draft a 1-layer model of other weights."""
    from lir_tpu.models.registry import ModelConfig as JaxModelConfig
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.models.convert import params_from_jax
    from lir_tpu_torch.models.registry import ModelConfig

    assert CFG["vocab_size"] == FakeTokenizer.VOCAB
    out = []
    for name, layers, seed in (("draft-tiny", 2, 0), ("drafty", 1, 23)):
        cfg = dict(CFG, name=name, n_layers=layers)
        cfg_j, cfg_t = JaxModelConfig(**cfg), ModelConfig(**cfg)
        tree = _tree(cfg_j, seed, WEIGHT_SCALE)
        out.append((cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
                    params_from_jax(tree, cfg_t, device="cpu")))
    return out


def _engines(verifier, **rt):
    from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
    from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
    from lir_tpu.engine.runner import ScoringEngine as JaxEngine
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine

    cfg_j, pj, cfg_t, pt = verifier
    base = dict(dict(batch_size=4, max_new_tokens=12, spec_k=SPEC_K,
                     prefix_cache=False), **rt)
    jeng = JaxEngine(pj, cfg_j, JaxFakeTokenizer(), JaxRuntimeConfig(
        piggyback_prefill=False, **base))
    teng = ScoringEngine(pt, cfg_t, FakeTokenizer(), RuntimeConfig(**base),
                         device="cpu")
    return jeng, teng


def _compare_fused(a, b):
    """JAX FusedDecodeOut vs the port's: ids exact, probabilities and
    log-probs within FTOL, the weighted confidence within 1e-6
    relative; top-k ids exact wherever their values are separated."""
    for name in ("generated", "top2_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=name)
    for name in ("p_yes", "p_no", "topk_logprobs"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   getattr(b, name).numpy(), atol=FTOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(np.asarray(a.weighted_confidence),
                               b.weighted_confidence.numpy(), rtol=1e-6,
                               atol=0)
    vals = np.asarray(a.topk_logprobs)
    gap = np.abs(np.diff(vals, axis=-1)) > FTOL
    sep = np.ones_like(vals, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(np.asarray(a.topk_ids)[sep],
                                  b.topk_ids.numpy()[sep])


def _rows(seed):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(3, 900, 40 + r)] for r in range(4)]


def _consumed_bitwise(a, b):
    for f in ("generated", "top2_ids", "topk_logprobs", "topk_ids",
              "weighted_confidence"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("p_yes", "p_no"):
        assert torch.equal(getattr(a, f)[:, 0], getattr(b, f)[:, 0]), f


def _seq(models, rows, bucket=64, **rt):
    _, teng = _engines(models[0], spec_decode=False, **rt)
    return _dispatch(teng, rows, bucket)


def test_fleet_draft_matches_jax_and_sequential(models):
    verifier, (dcfg_j, dpj, dcfg_t, dpt) = models
    jeng, teng = _engines(verifier, spec_draft_model="drafty")
    jeng.set_spec_draft(dpj, dcfg_j, "drafty")
    teng.set_spec_draft(dpt, dcfg_t, "drafty")
    assert "spec_draft:drafty" in teng.governor.ledger()
    rows = _rows(19)
    out_j = _dispatch(jeng, rows, 64)
    out_t = _dispatch(teng, rows, 64)
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)
    for a, b in zip(out_t, _seq(models, rows)):
        _consumed_bitwise(a, b)
    jeng.spec_flush()
    teng.spec_flush()
    assert teng.spec_stats["draft_fleet"] > 0
    assert jeng.spec_stats.draft_fleet > 0
    assert teng.spec_stats["draft_ngram"] == jeng.spec_stats.draft_ngram == 0
    assert teng.spec_stats["draft_tree"] == 0
    teng.clear_spec_draft()
    assert "spec_draft:drafty" not in teng.governor.ledger()


@pytest.mark.parametrize("trunk", [False, True])
def test_perfect_drafter_accepts_every_draft(models, trunk):
    """The verifier's own weights draft: every draft is the verifier's
    argmax at its slot, on the flat route and with a decode trunk
    (cascade prefill off, so the window runs the trunk-aware kernel)."""
    verifier = models[0]
    rt = dict(cascade_prefill=False) if trunk else {}
    jeng, teng = _engines(verifier, spec_draft_model="self", **rt)
    jeng.set_spec_draft(verifier[1], verifier[0], "self")
    teng.set_spec_draft(verifier[3], verifier[2], "self")
    rng = np.random.default_rng(5)
    if trunk:
        head = [int(x) for x in rng.integers(3, 900, 80)]
        rows = [head + [int(x) for x in rng.integers(3, 900, 6 - r % 3)]
                for r in range(4)]
        bucket = 96
    else:
        rows, bucket = _rows(7), 64
    out_t = _dispatch(teng, rows, bucket)
    out_j = _dispatch(jeng, rows, bucket)
    for a, b in zip(out_j, out_t):
        _compare_fused(a, b)
    for a, b in zip(out_t, _seq(models, rows, bucket, **rt)):
        _consumed_bitwise(a, b)
    teng.spec_flush()
    jeng.spec_flush()
    s = teng.spec_stats
    assert s["accepted_fleet"] == s["draft_fleet"] > 0
    assert jeng.spec_stats.accepted_fleet == jeng.spec_stats.draft_fleet > 0
    assert s["seq_forwards"] >= 2 * s["decode_forwards"]
    if trunk:
        assert teng.cascade_stats["cascade_decode_dispatches"] == 1


def test_draft_model_vocab_mismatch_refused(models):
    from lir_tpu_torch.models import decoder

    verifier = models[0]
    _, teng = _engines(verifier)
    bad = dataclasses.replace(verifier[2], vocab_size=512)
    with pytest.raises(ValueError, match="vocab"):
        teng.set_spec_draft(decoder.init_params(bad, device="cpu"), bad,
                            "bad")
    assert teng._spec_draft is None
    assert not any(k.startswith("spec_draft") for k in teng.governor.ledger())


def test_paged_exclusion_and_no_spec_rung_fall_back(models):
    """A warm dispatch with a fleet draft armed leaves the paged front's
    speculation for its sequential paged route; under the no_spec rung
    a fleet-draft dispatch takes the sequential route. Each counts one
    fallback, and each gives the speculative route's consumed outputs."""
    from lir_tpu_torch.engine import hbm

    verifier, (_, _, dcfg_t, dpt) = models
    rows = _rows(11)
    paged = dict(prefix_cache=True, prefix_cache_pages=64)
    _, plain = _engines(verifier, **paged)
    _, fleet = _engines(verifier, spec_draft_model="drafty", **paged)
    fleet.set_spec_draft(dpt, dcfg_t, "drafty")
    for eng in (plain, fleet):
        _dispatch(eng, rows, 64)                # cold: inserts the pages
    warm_spec = _dispatch(plain, rows, 64)
    warm_fleet = _dispatch(fleet, rows, 64)
    assert plain.paged_dispatches["shared_paged_spec"] == 1
    assert fleet.paged_dispatches["shared_paged"] == 1
    assert fleet.paged_dispatches["shared_paged_spec"] == 0
    assert fleet.spec_stats["fallbacks"] == 1
    assert plain.spec_stats["fallbacks"] == 0
    for a, b in zip(warm_fleet, warm_spec):
        _consumed_bitwise(a, b)

    _, eng = _engines(verifier, spec_draft_model="drafty")
    eng.set_spec_draft(dpt, dcfg_t, "drafty")
    spec_out = _dispatch(eng, rows, 64)
    gov = eng.governor
    gov.squeeze(0.5, calls=64)
    while gov.allows("spec"):
        gov.tick()
    assert gov.engaged_rungs() == list(hbm.RUNGS[:4])
    before = eng.spec_stats["spec_dispatches"]
    seq_out = _dispatch(eng, rows, 64)
    assert eng.spec_stats["fallbacks"] == 1
    assert eng.spec_stats["spec_dispatches"] == before
    assert eng.cascade_stats["dense_shared_dispatches"] == 1
    for a, b in zip(seq_out, spec_out):
        _consumed_bitwise(a, b)
