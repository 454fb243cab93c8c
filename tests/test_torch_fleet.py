"""The port's weight cache, weight streaming and model fleet
(``lir_tpu_torch/models/weights.py``, ``engine/fleet.py``,
``engine/multi.py``) against the JAX package's.

- ``WeightCache``: the same seeded operation sequences (inserts under a
  budget, acquires, releases, pins, ``evict_idle``, ``drop``) go to the
  port's and the JAX cache; after every operation the outcome (a
  ``WeightCacheOOM``, a ``KeyError``), the resident models in LRU order,
  the refcounts (never below zero), the listener events and the eviction
  hook's order are equal. Pinned and in-flight models are never evicted,
  ``drop`` is refused in flight, a double release is refused.
- Streaming: ``host_stage`` then ``stream_params`` gives every leaf
  bitwise (QuantTensor payload and scales too), in chunks that cut
  leaves, and refuses a mesh; a worker's exception surfaces at
  ``take``.
- The fleet sweep (``run_model_comparison_sweep``) on tiny-llama,
  tiny-mistral and tiny-gpt2, trees carried across by
  ``params_from_jax``: its rows are bitwise the port's standalone
  engines' rows; its D1/D2 are within the parity bar of the JAX fleet
  sweep's (text exact, floats 1e-5); ``FleetStats`` loads, hits,
  prefetches, evictions and swaps equal JAX's, with prefetch on, under
  a budget that holds one model (every switch evicts), and with
  prefetch off. Without a budget on a card the sweep keeps one model
  cached (faked device budget), and a prefetch that runs out of memory
  is loaded inline.
- ``ModelFleet``: evict then reacquire streams the staged tree back
  bitwise; ``acquire_spec_draft`` arms and ``release_spec_draft``
  disarms a co-resident drafter, refcounted; a governor's
  ``evict_weights`` rung drops an idle model and the ledger follows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lir_tpu.engine import multi as jmulti
from lir_tpu.models import weights as jweights
from lir_tpu_torch.engine import fleet, hbm, multi
from lir_tpu_torch.models import quant, weights
from lir_tpu_torch.utils.profiling import FleetStats

from test_torch_engine import WEIGHT_SCALE
from test_torch_multi import assert_frames_match

QUESTIONS = ["Is a cat an animal", "Is a rock an animal",
             "Is rain considered weather", "Is a tomato a fruit"]
RT = dict(batch_size=4, max_new_tokens=12, max_seq_len=256)


# ---------------------------------------------------------------------------
# WeightCache against the JAX cache
# ---------------------------------------------------------------------------

def _cache_ops(seed, n=200):
    rng = np.random.default_rng(seed)
    models = [f"m{i}" for i in range(6)]
    ops = []
    for _ in range(n):
        r = rng.random()
        mid = str(rng.choice(models))
        if r < 0.3:
            ops.append(("insert", mid, int(rng.integers(1, 5)) * 100))
        elif r < 0.5:
            ops.append(("acquire", mid))
        elif r < 0.65:
            ops.append(("release", mid))
        elif r < 0.72:
            ops.append(("pin", mid))
        elif r < 0.8:
            ops.append(("unpin", mid))
        elif r < 0.9:
            ops.append(("evict_idle",))
        else:
            ops.append(("drop", mid))
    return ops


def _run_op(cache, op):
    name, *args = op
    if name == "insert":
        mid, nb = args
        return cache.insert(mid, f"params-{mid}", nb)
    if name == "release" and cache.refcount(args[0]) == 0:
        return "skipped: nothing to release"
    return getattr(cache, name)(*args)


def _cache_state(cache):
    return (cache.resident_models, cache.resident_bytes,
            [cache.refcount(m) for m in cache.resident_models])


@pytest.mark.parametrize("budget", [500, 900, None])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_weight_cache_matches_jax_cache(seed, budget):
    events = {"jax": [], "torch": []}
    caches = {}
    for key, mod in (("jax", jweights), ("torch", weights)):
        ev = events[key]
        caches[key] = mod.WeightCache(
            budget, on_evict=lambda mid, ev=ev: ev.append(("hook", mid)))
        caches[key].add_listener(lambda e, mid, ev=ev: ev.append((e, mid)))
    jc, tc = caches["jax"], caches["torch"]
    for i, op in enumerate(_cache_ops(seed)):
        outcome = {}
        for key, cache in caches.items():
            try:
                outcome[key] = ("ok", _run_op(cache, op))
            except Exception as exc:  # noqa: BLE001 — compared below
                outcome[key] = (type(exc).__name__, None)
        assert outcome["torch"] == outcome["jax"], (i, op, outcome)
        assert _cache_state(tc) == _cache_state(jc), (i, op)
        assert events["torch"] == events["jax"], (i, op)
        assert all(tc.refcount(m) >= 0 for m in tc.resident_models)
    assert any(e == "evict" for e, _ in events["torch"])


def test_weight_cache_refuses_as_jax():
    for mod in (jweights, weights):
        c = mod.WeightCache(300)
        c.insert("a", "pa", 200)
        c.acquire("a")
        with pytest.raises(mod.WeightCacheOOM):
            c.insert("b", "pb", 200)             # "a" is in flight
        with pytest.raises(mod.WeightCacheOOM):
            c.drop("a")
        c.release("a")
        with pytest.raises(AssertionError, match="negative"):
            c.release("a")
        c2 = mod.WeightCache(300)
        c2.insert("a", "pa", 200)
        c2.pin("a")
        with pytest.raises(mod.WeightCacheOOM):
            c2.insert("b", "pb", 200)            # "a" is pinned
        assert c2.evict_idle() is None
        c2.unpin("a")
        assert c2.evict_idle() == "a"


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

def _assert_trees_bitwise(a, b):
    la, lb = weights.tree_leaves(a), weights.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        if isinstance(x, quant.QuantTensor):
            assert isinstance(y, quant.QuantTensor) and x.dynamic == y.dynamic
            pairs = ((x.q, y.q), (x.scale, y.scale))
        else:
            pairs = ((x, y),)
        for p, q in pairs:
            assert p.dtype == q.dtype and p.shape == q.shape
            assert torch.equal(p.cpu(), q.cpu())


def test_stream_params_is_bitwise_the_staged_tree():
    from lir_tpu_torch.models import decoder, registry

    cfg = registry.tiny("mistral")
    params = decoder.init_params(cfg, seed=1, device="cpu",
                                 dtype=torch.bfloat16)
    q8 = quant.quantize_decoder_params(
        decoder.init_params(cfg, seed=2, device="cpu"), dynamic=True)
    stats = FleetStats()
    for tree in (params, q8):
        staged = weights.host_stage(tree)
        _assert_trees_bitwise(staged, tree)
        # A 1 KiB chunk cuts every matrix into many row slices.
        streamed = weights.stream_params(staged, device="cpu",
                                         chunk_bytes=1024, stats=stats)
        _assert_trees_bitwise(streamed, tree)
        assert weights.tree_bytes(streamed) == quant.param_bytes(tree)
    assert stats.weight_bytes_streamed == (quant.param_bytes(params)
                                           + quant.param_bytes(q8))
    with pytest.raises(NotImplementedError):
        weights.stream_params(weights.host_stage(params), device="cpu",
                              mesh=object())


def test_streamer_surfaces_worker_errors_at_take():
    s = weights.AsyncWeightStreamer()
    try:
        s.prefetch("ok", lambda: "params")
        s.prefetch("bad", lambda: (_ for _ in ()).throw(OSError("disk")))
        assert s.pending("ok") and s.pending("bad")
        params, load_s, waited = s.take("ok")
        assert params == "params" and load_s >= 0 and waited >= 0
        with pytest.raises(OSError, match="disk"):
            s.take("bad")
        assert s.take("never") is None
    finally:
        s.shutdown()


# ---------------------------------------------------------------------------
# The fleet sweep against the JAX fleet sweep
# ---------------------------------------------------------------------------

FAMILIES = {"org/tiny-llama": ("llama", 0), "org/tiny-mistral": ("mistral", 1),
            "org/tiny-gpt2": ("gpt2", 2)}


@pytest.fixture(scope="module")
def trees():
    """Each family's config (JAX, port) and JAX-initialised tree, scaled up
    so no two candidate tokens sit within float noise."""
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models import registry as jreg
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.models import registry as treg

    out = {}
    for name, (family, seed) in FAMILIES.items():
        kw = dict(vocab_size=FakeTokenizer.VOCAB, max_seq_len=256)
        cfg_j = dataclasses.replace(jreg.tiny(family), **kw)
        cfg_t = dataclasses.replace(treg.tiny(family), **kw)
        tree = jax.tree.map(np.asarray, jdec.init_params(
            cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32))
        for k, a in tree["layers"].items():
            if k.startswith("w"):
                tree["layers"][k] = a * WEIGHT_SCALE
        for k in ("tok_embed", "lm_head"):
            if k in tree:
                tree[k] = tree[k] * WEIGHT_SCALE
        out[name] = (cfg_j, cfg_t, tree)
    return out


def _port_factory(trees):
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models.convert import params_from_jax

    def factory(name):
        _, cfg_t, tree = trees[name]
        return ScoringEngine(params_from_jax(tree, cfg_t, device="cpu"),
                             cfg_t, FakeTokenizer(), RuntimeConfig(**RT),
                             device="cpu")
    return factory


def _jax_factory(trees):
    from lir_tpu.backends.fake import FakeTokenizer
    from lir_tpu.config import RuntimeConfig
    from lir_tpu.engine.runner import ScoringEngine

    def factory(name):
        cfg_j, _, tree = trees[name]
        return ScoringEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                             FakeTokenizer(), RuntimeConfig(**RT))
    return factory


SPECS = [(name, "instruct") for name in FAMILIES]
FLEET_KEYS = ("loads", "cache_hits", "prefetch_hits", "prefetch_misses",
              "evictions", "model_swaps", "resident_models")


def _budget(trees):
    """A budget that holds the largest model alone: every switch
    evicts."""
    sizes = sorted(jweights.tree_bytes(t) for _, _, t in trees.values())
    assert sizes[0] + sizes[1] > sizes[-1]
    return sizes[-1]


@pytest.fixture(scope="module")
def sweeps(trees, tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    runs = {}
    for mode, kw in (("prefetch", {}),
                     ("tight", dict(weight_cache_bytes=_budget(trees))),
                     ("no_prefetch", dict(weight_prefetch=False))):
        runs[mode] = {}
        for where, mod, factory in (
                ("jax", jmulti, _jax_factory(trees)),
                ("torch", multi, _port_factory(trees))):
            runs[mode][where] = mod.run_model_comparison_sweep(
                [mod.ModelSpec(*s) for s in SPECS], factory,
                out / mode / where, questions=QUESTIONS,
                sweep_kind="instruct_only", **kw)
    return out, runs


@pytest.mark.parametrize("mode", ["prefetch", "tight", "no_prefetch"])
def test_fleet_sweep_matches_jax(sweeps, mode):
    out, runs = sweeps
    for name in ("model_comparison_results.csv",
                 "instruct_model_comparison_results.csv"):
        assert_frames_match(pd.read_csv(out / mode / "torch" / name),
                            pd.read_csv(out / mode / "jax" / name))
    port, ref = runs[mode]["torch"], runs[mode]["jax"]
    assert all(v["status"] == "ok" for v in port["per_model"].values())
    for key in FLEET_KEYS:
        assert port["fleet"][key] == ref["fleet"][key], key
    assert port["fleet"]["loads"] == len(SPECS)
    if mode == "prefetch":
        assert port["fleet"]["prefetch_hits"] == len(SPECS) - 1
        assert port["fleet"]["resident_models"] == len(SPECS)
    elif mode == "tight":
        assert port["fleet"]["evictions"] == len(SPECS) - 1
        assert port["fleet"]["resident_models"] == 1
    else:
        assert port["fleet"]["prefetch_hits"] == 0
        assert port["fleet"]["swap_s_hidden"] == 0.0
        assert port["fleet"]["swap_s_exposed"] > 0.0


@pytest.mark.parametrize("mode", ["prefetch", "tight", "no_prefetch"])
def test_fleet_rows_are_bitwise_standalone_engines(sweeps, trees, mode):
    from lir_tpu_torch.engine.sweep import run_word_meaning_sweep

    _, runs = sweeps
    recs = runs[mode]["torch"]["model_comparison_csv"]
    factory = _port_factory(trees)
    for name, kind in SPECS:
        spec = multi.ModelSpec(name, kind)
        ref = run_word_meaning_sweep(factory(name), name, kind, QUESTIONS,
                                     multi.format_for(spec, "instruct_only"))
        got = [r for r in recs if r["model"] == name]
        assert [r["prompt"] for r in got] == [r.prompt for r in ref]
        assert [r["model_output"] for r in got] == [r.model_output
                                                    for r in ref]
        assert [r["yes_prob"] for r in got] == [r.yes_prob for r in ref]
        assert [r["no_prob"] for r in got] == [r.no_prob for r in ref]


def _port_sweep(trees, out, factory=None, **kw):
    return multi.run_model_comparison_sweep(
        [multi.ModelSpec(*s) for s in SPECS],
        factory or _port_factory(trees), out, questions=QUESTIONS,
        sweep_kind="instruct_only", **kw)


def _same_rows(art, ref):
    got, want = art["model_comparison_csv"], ref["model_comparison_csv"]
    assert [r["model"] for r in got] == [r["model"] for r in want]
    for key in ("model_output", "yes_prob", "no_prob"):
        assert [r[key] for r in got] == [r[key] for r in want], key


def test_unbudgeted_sweep_on_a_card_keeps_one_model(sweeps, trees,
                                                    tmp_path, monkeypatch):
    """No weight budget on a governed device (the card): the sweep's own
    fleet drops each model once its rows are in, so no more than one
    model is cached (the next one loading beside it), every row is
    ``ok`` and bitwise the unbounded sweep's."""
    monkeypatch.setattr(hbm, "device_budget_bytes",
                        lambda reserve_frac=0.08, device=None: 1 << 40)
    most = []
    real = fleet.ModelFleet.from_factory

    def watched(*a, **kw):
        f = real(*a, **kw)
        f.cache.add_listener(
            lambda event, mid: most.append(len(f.cache.resident_models)))
        return f

    monkeypatch.setattr(multi.ModelFleet, "from_factory", watched)
    art = _port_sweep(trees, tmp_path)
    assert all(v["status"] == "ok" for v in art["per_model"].values())
    _same_rows(art, sweeps[1]["prefetch"]["torch"])
    st = art["fleet"]
    assert st["loads"] == len(SPECS)
    assert st["prefetch_hits"] == len(SPECS) - 1
    assert st["evictions"] == len(SPECS)
    assert st["resident_models"] == 0
    assert most and max(most) == 1


def test_prefetch_out_of_memory_loads_inline(sweeps, trees, tmp_path):
    """A prefetched load that runs out of device memory beside the
    scoring model is loaded again inline at ``acquire`` (a prefetch
    miss), and the rows are the same."""
    names = list(FAMILIES)
    base = _port_factory(trees)
    calls = {name: 0 for name in names}

    def factory(name):
        calls[name] += 1
        if name == names[1] and calls[name] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return base(name)

    art = _port_sweep(trees, tmp_path, factory=factory)
    assert all(v["status"] == "ok" for v in art["per_model"].values())
    _same_rows(art, sweeps[1]["prefetch"]["torch"])
    st = art["fleet"]
    assert calls[names[1]] == 2
    assert (st["loads"], st["prefetch_hits"], st["prefetch_misses"]) == (
        len(SPECS), len(SPECS) - 2, 2)


# ---------------------------------------------------------------------------
# ModelFleet: reload, fleet drafting, the governor's rung
# ---------------------------------------------------------------------------

def test_evict_then_reacquire_streams_back_bitwise(trees):
    factory = _port_factory(trees)
    names = list(FAMILIES)
    engines = [(n, factory(n)) for n in names[:2]]
    originals = {n: weights.host_stage(e.params) for n, e in engines}
    f = fleet.ModelFleet.from_engines(
        engines, cache_budget_bytes=_budget(trees), prefetch=False)
    try:
        assert f.resident(names[1]) and not f.resident(names[0])
        e0 = f.acquire(names[0])                 # evicts names[1]
        _assert_trees_bitwise(e0.params, originals[names[0]])
        f.release(names[0])
        f.prefetch(names[1])                     # prefetch off: a no-op
        e1 = f.acquire(names[1])
        _assert_trees_bitwise(e1.params, originals[names[1]])
        _assert_trees_bitwise(e1.params, f.staged(names[1]))
        f.release(names[1])
        assert f.stats.loads == 2 and f.stats.evictions == 3
        assert f.stats.weight_bytes_streamed == sum(
            weights.tree_bytes(o) for o in originals.values())
        assert f.engine(names[0]).params is None
    finally:
        f.shutdown()


def test_fleet_spec_draft_and_governor_rung(trees):
    from lir_tpu_torch.config import RuntimeConfig

    factory = _port_factory(trees)
    llama, mistral = list(FAMILIES)[:2]
    ver = factory(llama)
    ver.rt = dataclasses.replace(RuntimeConfig(**RT),
                                 spec_draft_model=mistral)
    gov = hbm.HbmGovernor(budget_bytes=None, device="cpu")
    f = fleet.ModelFleet.from_engines([(llama, ver), (mistral,
                                                      factory(mistral))],
                                      governor=gov, stage_reloads=True)
    try:
        assert gov.ledger()["weights"] == f.cache.resident_bytes
        v = f.acquire(llama)
        draft = f.acquire_spec_draft(v, llama)
        assert draft == mistral and v._spec_draft[2] == mistral
        assert f.cache.refcount(mistral) == 1
        assert f"spec_draft:{mistral}" in v.governor.ledger()
        assert f.acquire_spec_draft(f.engine(mistral), mistral) is None
        f.release_spec_draft(v, draft)
        f.release(llama)
        assert v._spec_draft is None and f.cache.refcount(mistral) == 0
        # The evict_weights rung drops the idle LRU model; the ledger
        # follows; a re-acquire streams it back.
        gov.squeeze(0.5, calls=4)
        gov.tick()
        gov.tick()
        assert gov.engaged_rungs() == ["evict_weights"]
        assert len(f.cache.resident_models) == 1
        assert gov.ledger()["weights"] == f.cache.resident_bytes
        gone = [m for m in (llama, mistral) if not f.resident(m)][0]
        e = f.acquire(gone)
        _assert_trees_bitwise(e.params, f.staged(gone))
        f.release(gone)
    finally:
        f.shutdown()
