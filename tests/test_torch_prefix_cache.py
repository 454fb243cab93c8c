"""The port's cross-request radix prefix cache against the JAX package's.

- The page pool and the radix tree: every case runs one operation
  sequence (alloc / incref / decref, insert, pinned lookup, release, LRU
  eviction with parent cascade, per-bucket namespaces, tail records and
  continuations) through both packages' pools and trees; every returned
  value, the refcounts, the free list, the tree (every node's page,
  clock and tails) and the counters must be equal. The JAX test file's
  own assertions hold in both.
- The slot gather and the page scatter: pages written from a cache come
  back bitwise, and the pool holds what the JAX pool holds.
- The planner: ``bucket_cost(cached_tokens=)`` and a plan priced against
  a warm tree equal the JAX ones.
- The engine, on a tiny llama (``registry.tiny("llama")``, the JAX init
  scaled by 4 so that no two candidate tokens sit within float noise),
  bucket 96, ``batch_size=4``, a tokenizer with per-token strings so that
  the confidence early stop is armed: the paged shared dispatch on the
  speculative route (cold, warm with tree drafts, cross-length trunk
  reuse), the cascade (fused, and the two-leg route), the grouped
  dispatch, and a tight pool that evicts. Each output is held to the JAX
  engine's COLD UNPAGED output (caveat R1: discrete outputs exact,
  floats within 1e-5) and to the JAX engine's warm output; the pool, the
  tree, the counters and the tree drafts are exact against the JAX
  engine on the same dispatches.
- A perturbation sweep with the cache on, run twice (cold, then warm):
  its D6 rows match the JAX sweep's.

The JAX side arms both interpreter hooks (caveat R2). Every JAX dispatch
of this file runs one of eight compiled shapes (the warm dispatches all
take the 16-token window; the sweep's dispatches are the speculative
engine's shape), which keeps the file near a minute on one CPU worker.
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
from lir_tpu.engine import prefix_tree as jtree
from lir_tpu.engine import scheduler as jsched
from lir_tpu.engine import spec as jspec
from lir_tpu.engine import sweep as jsweep
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models import paged as jpaged
from lir_tpu.models.registry import tiny as jax_tiny
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LegalPrompt
from lir_tpu_torch.engine import prefix_tree as ttree
from lir_tpu_torch.engine import scheduler as tsched
from lir_tpu_torch.engine import spec as tspec
from lir_tpu_torch.engine import sweep as tsweep
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import paged as tpaged
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import tiny

from test_torch_engine import FTOL, WEIGHT_SCALE
from test_torch_sweep import _compare_rows

BUCKET, SFX, NEW, CONF = 96, (8, 8), 4, 6
PACKAGES = {"jax": (jpaged, jtree), "torch": (tpaged, ttree)}


# ---------------------------------------------------------------------------
# Pool and tree state, comparable across the packages
# ---------------------------------------------------------------------------

def tree_state(tree):
    """Every node of every namespace in key order: (bucket, token path,
    page, clock, tails), plus the clock and node count."""
    out = []
    for b in sorted(tree._roots):
        stack = [((), tree._roots[b])]
        while stack:
            path, node = stack.pop()
            out.append((b, path, node.page, node.clock,
                        tuple(node.tails.items())))
            for key in sorted(node.children, reverse=True):
                stack.append((path + key, node.children[key]))
    return out, tree._clock, len(tree)


def pool_state(pool):
    return (pool.refcount.tolist(), list(pool._free), pool.pages_in_use,
            pool.free_pages)


def assert_same_cache_state(jtr, ttr):
    assert tree_state(ttr) == tree_state(jtr)
    assert pool_state(ttr.pool) == pool_state(jtr.pool)
    assert ttr.stats.summary() == jtr.stats.summary()


# ---------------------------------------------------------------------------
# Allocator and radix tree: one operation sequence through both packages
# (the cases of tests/test_prefix_cache.py, with their assertions)
# ---------------------------------------------------------------------------

def _case_pool_alloc_refcount(P, T):
    pool = P.KVPagePool(8, page_size=4)
    assert pool.free_pages == 7          # page 0 reserved
    pages = [pool.alloc() for _ in range(7)]
    assert 0 not in pages and pool.alloc() is None
    pool.incref(pages)
    pool.decref(pages[:3])
    assert pool.free_pages == 3 and pool.pages_in_use == 4
    again = [pool.alloc() for _ in range(3)]
    assert sorted(again) == sorted(pages[:3])
    return T.RadixPrefixCache(pool), [pages, again]


def _case_pool_decref_below_zero(P, T):
    pool = P.KVPagePool(4, page_size=4)
    p = pool.alloc()
    pool.incref([p])
    pool.decref([p])
    with pytest.raises(AssertionError):
        pool.decref([p])
    pool.refcount[p] = 0                 # undo the failed decref's count
    return T.RadixPrefixCache(pool), [p]


def _case_radix_roundtrip(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(16, 4))
    ids = list(range(11))                 # 2 full pages + a 3-token tail
    start, pages = t.plan_insert(64, ids)
    assert start == 0 and len(pages) == 2
    assert t.match_len(64, ids) == 8      # the tail never caches
    m = t.lookup(64, ids)
    assert m.tokens == 8 and m.pages == tuple(pages)
    t.release(m)
    start2, pages2 = t.plan_insert(64, list(range(14)))
    assert start2 == 8 and len(pages2) == 1
    assert t.match_len(64, [99, 98, 97, 96]) == 0
    return t, [start, pages, m.pages, start2, pages2]


def _case_partial_match(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(16, 4))
    a = list(range(12))
    b = list(range(8)) + [77, 78, 79, 80]
    t.plan_insert(64, a)
    assert t.match_len(64, b) == 8
    start, fresh = t.plan_insert(64, b)
    assert start == 8 and len(fresh) == 1
    return t, [start, fresh]


def _case_namespaces(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(16, 4))
    ids = list(range(8))
    t.plan_insert(64, ids)
    assert t.match_len(64, ids) == 8
    assert t.match_len(128, ids) == 0     # other bucket: other namespace
    t.plan_insert(128, ids)
    assert t.pool.pages_in_use == 4
    return t, []


def _case_lru_eviction(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(16, 4))
    old = list(range(8))
    t.plan_insert(64, old)
    new = [50 + i for i in range(8)]
    t.plan_insert(64, new)
    t.release(t.lookup(64, new))          # touch `new`: `old` is stalest
    freed = t.evict(1)
    assert freed >= 1
    assert t.match_len(64, old) < 8
    assert t.match_len(64, new) == 8
    freed_all = t.evict(100)              # leaf -> parent cascade
    assert t.match_len(64, old) == 0
    return t, [freed, freed_all]


def _case_pinned_survive(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(6, 4))   # 5 usable pages
    ids = list(range(8))
    t.plan_insert(64, ids)
    m = t.lookup(64, ids)
    assert t.evict(100) == 0
    assert t.match_len(64, ids) == 8
    start, fresh = t.plan_insert(64, [90 + i for i in range(12)])
    assert t.match_len(64, ids) == 8
    t.release(m)
    freed = t.evict(100)
    assert freed >= 1
    return t, [start, fresh, freed]


def _case_release_then_evict(P, T):
    t = T.RadixPrefixCache(P.KVPagePool(4, 4))   # 3 usable pages
    ids = list(range(4))
    t.plan_insert(64, ids)
    m = t.lookup(64, ids)
    assert t.evict(100) == 0
    free_before = t.pool.free_pages
    t.release(m)
    assert t.pool.free_pages == free_before
    assert t.evict(100) == 1
    assert t.pool.free_pages == free_before + 1
    assert (t.pool.refcount >= 0).all()
    return t, [free_before]


def _case_tails_and_continuation(P, T):
    """The token history the drafts read: tails on the deepest covering
    node (and on the namespace root), LRU capping, the max_tokens
    refusal, page-key descent before the tails."""
    t = T.RadixPrefixCache(P.KVPagePool(16, 4))
    a = list(range(10))
    t.plan_insert(64, a + [40, 41, 42])   # 3 pages: 0..3, 4..7, 8 9 40 41
    out = [t.record_tail(64, a, [7, 7, 7]),
           t.record_tail(64, [5, 5], [1, 2]),           # root tail
           t.record_tail(64, a, []),                    # empty: refused
           t.record_tail(64, a, list(range(600))),      # too long
           t.continuation(64, a, 2), t.continuation(64, a[:8], 6),
           t.continuation(64, [5, 5], 4), t.continuation(128, a, 3)]
    for i in range(5):                    # cap 3: the two oldest drop
        t.record_tail(64, list(range(4)) + [i], [i, i], max_tails=3)
    out.append(t.continuation(64, list(range(4)) + [0], 2))
    out.append(t.continuation(64, list(range(4)) + [4], 2))
    return t, out


TREE_CASES = {f.__name__[6:]: f for f in (
    _case_pool_alloc_refcount, _case_pool_decref_below_zero,
    _case_radix_roundtrip, _case_partial_match, _case_namespaces,
    _case_lru_eviction, _case_pinned_survive, _case_release_then_evict,
    _case_tails_and_continuation)}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_pool_and_tree_match_jax(case):
    jt, jout = TREE_CASES[case](*PACKAGES["jax"])
    tt, tout = TREE_CASES[case](*PACKAGES["torch"])
    assert tout == jout
    assert_same_cache_state(jt, tt)


def test_window_edges_and_pick_match_jax():
    for bucket in (16, 64, 96, 128, 256, 1024):
        for ps in (8, 16, 32):
            assert tpaged.window_edges(bucket, ps) == \
                jpaged.window_edges(bucket, ps)
            for needed in (1, 10, 16, 17, 100, 200, 1000):
                assert tpaged.pick_window(needed, bucket, ps) == \
                    jpaged.pick_window(needed, bucket, ps)
    assert tpaged.window_edges(256, 16) == (16, 32, 64, 128)
    assert tpaged.pick_window(200, 256, 16) is None
    cfg, jcfg = tiny("llama"), jax_tiny("llama")
    assert tpaged.kv_page_bytes(cfg) == jpaged.kv_page_bytes(jcfg)


def test_pool_refuses_a_cache_that_is_not_the_float_pair():
    pool = tpaged.KVPagePool(4, 4)
    with pytest.raises(TypeError):
        pool.ensure((torch.zeros((2, 2, 4, 1, 8), dtype=torch.int8),) * 2)
    with pytest.raises(TypeError):
        pool.ensure(torch.zeros((2, 2, 4, 1, 8)))
    assert pool.leaves is None


# ---------------------------------------------------------------------------
# Gather / scatter
# ---------------------------------------------------------------------------

def test_scatter_then_gather_roundtrip_bitwise_and_as_jax():
    cfg = tiny("llama")
    rng = np.random.default_rng(0)
    shape = (cfg.n_layers, cfg.n_kv_heads, 32, 2, cfg.head_dim)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    writes = [(None, 0, 0), (None, 1, 8), (None, 1, 16)]
    pools = {}
    for name, (P, _) in PACKAGES.items():
        cache = (tuple(jnp.asarray(a) for a in arrays) if name == "jax"
                 else tuple(torch.from_numpy(a) for a in arrays))
        pool = P.KVPagePool(8, page_size=8)
        pool.ensure(cache)
        pages = [pool.alloc() for _ in writes]
        pool.incref(pages)
        pool.scatter(cache, [(p, r, s) for p, (_, r, s) in zip(pages,
                                                               writes)])
        pools[name] = (pool, pages)
    (jp, jpages), (tp, tpages) = pools["jax"], pools["torch"]
    assert jpages == tpages
    for a, b in zip(jp.leaves, tp.leaves):       # page 0 included
        assert np.array_equal(np.asarray(a), b.numpy())
    # Row 0 <- row 0 slots [0, 8), row 1 slots [8, 24): bitwise back.
    p1, p2, p3 = tpages
    slot_src = np.zeros((2, 24), np.int32)
    slot_src[0, :8] = p1 * 8 + np.arange(8)
    slot_src[1, 8:16] = p2 * 8 + np.arange(8)
    slot_src[1, 16:24] = p3 * 8 + np.arange(8)
    out = tpaged.gather_slots(tp.leaves, torch.from_numpy(slot_src),
                              total_len=30)
    jout = jpaged.gather_slots(jp.leaves, jnp.asarray(slot_src))
    for o, c, j in zip(out, arrays, jout):
        assert o.shape == (cfg.n_layers, cfg.n_kv_heads, 30, 2, cfg.head_dim)
        assert np.array_equal(o[:, :, :8, 0].numpy(), c[:, :, :8, 0])
        assert np.array_equal(o[:, :, 8:24, 1].numpy(), c[:, :, 8:24, 1])
        assert not o[:, :, 24:].any()
        assert np.array_equal(o[:, :, :24].numpy(), np.asarray(j))
    assert tp.nbytes == jp.nbytes and tp.page_nbytes() == jp.page_nbytes()


# ---------------------------------------------------------------------------
# Price model and the warm-tree plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (4, 128, 4, 10, dict(cached_tokens=0)),
    (4, 128, 4, 10, dict(cached_tokens=100)),
    (4, 128, 4, 10, dict(cached_tokens=10_000)),
    (16, 384, 32, 12, dict(cached_tokens=500, cascade=True,
                           trunk_tokens=80)),
])
def test_bucket_cost_cached_tokens_matches_jax(args):
    n, edge, batch, cost, kw = args
    assert tsched.bucket_cost(n, edge, batch, cost, **kw) == \
        jsched.bucket_cost(n, edge, batch, cost, **kw)
    if kw == dict(cached_tokens=10_000):
        assert tsched.bucket_cost(n, edge, batch, cost, **kw) == 4 * 10


def test_warm_tree_plan_matches_jax():
    """A tail of 3 cells warm in bucket 96's namespace is kept there when
    its cached pages make it cheaper than promoting; the same tail on a
    cold tree is promoted. Both packages plan the same dispatches."""
    rng = np.random.default_rng(4)
    bins, confs = [], []
    for n in [70] * 8 + [90] * 3:
        ids = [int(x) for x in rng.integers(3, 250, n)]
        bins.append(ids + [7, 8])
        confs.append(ids + [9, 10, 11])
    plans = {}
    for name, (P, T), sched in (("jax", PACKAGES["jax"], jsched),
                                ("torch", PACKAGES["torch"], tsched)):
        tree = T.RadixPrefixCache(P.KVPagePool(64, 16))
        for ids in bins[8:]:
            tree.plan_insert(96, ids[:90])
        items = sched.build_items(bins, confs, list(range(len(bins))))
        for probe in (None, lambda it, b, tree=tree: tree.match_len(
                b, it.bin_ids[:it.lcp])):
            planner = sched.RaggedScheduler(
                (64, 96, 128), 4, new_budget=6, decode_cost=10,
                group_cells=False, cached_probe=probe)
            plans[name, probe is None] = [
                (d.kind, d.bucket, [it.cell for it in d.items], d.refilled,
                 d.sfx_bucket_a, d.sfx_bucket_b)
                for d in planner.schedule(items)]
    assert plans["torch", True] == plans["jax", True]
    assert plans["torch", False] == plans["jax", False]
    assert plans["torch", True] != plans["torch", False]


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _stop_tokenizer(base):
    """The fake tokenizer with per-token strings (every fifth id a number),
    so that the engines arm the confidence early stop."""

    class StopTokenizer(base):
        def convert_ids_to_tokens(self, ids):
            return [f"▁{i % 100}" if i % 5 == 0 else f"▁w{i}"
                    for i in ids]

    return StopTokenizer(vocab=256)


JAX_TOKZ = _stop_tokenizer(JaxFakeTokenizer)
TOKZ = _stop_tokenizer(FakeTokenizer)

# The engines' flags beyond the defaults: the speculative engine (the
# cascade off, so a shared dispatch takes the speculative route), the
# sequential engine (the cascade and the grouped dispatch), the two-leg
# cascade (port only: the JAX package's fused and two-leg cascades are
# bitwise one another, pinned by its own tests), and the tight pool.
ENGINES = {
    "spec": dict(cascade_prefill=False, sweep_group_min_cells=0),
    "seq": dict(spec_decode=False),
    "two_leg": dict(spec_decode=False, cascade_fused_suffix=False),
    "tight": dict(spec_decode=False, cascade_prefill=False,
                  prefix_cache_pages=6),
}


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_tiny("llama")
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(1), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    cfg_t = tiny("llama")
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"))


@pytest.fixture(autouse=True)
def _hooks():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _rt(kind):
    kw = dict(batch_size=4, max_seq_len=128, prefix_cache=True,
              prefix_cache_pages=64, sweep_decode_tokens=NEW,
              sweep_confidence_tokens=CONF, streaming_stats=False)
    kw.update(ENGINES[kind])
    return kw


def _jax_engine(models, kind, **kw):
    cfg_j, pj, _, _ = models
    return JaxEngine(pj, cfg_j, JAX_TOKZ, JaxRuntimeConfig(
        aot_precompile=False, piggyback_prefill=False, **{**_rt(kind), **kw}))


def _engines(models, kind):
    """(JAX cold unpaged engine, JAX engine, port engine): the last two
    with the prefix cache on and the same flags (the two-leg port engine
    beside fused JAX ones); the JAX ones without the features the port
    lacks."""
    _, _, cfg_t, pt = models
    jkind = "seq" if kind == "two_leg" else kind
    jref = _jax_engine(models, jkind, prefix_cache=False)
    jeng = _jax_engine(models, jkind)
    teng = ScoringEngine(pt, cfg_t, TOKZ, RuntimeConfig(**_rt(kind)),
                         device="cpu")
    assert teng.digit_stop_mask is not None
    assert np.array_equal(teng.digit_stop_mask.numpy(),
                          np.asarray(jeng.digit_stop_mask))
    return jref, jeng, teng


@pytest.fixture(scope="module")
def engines(models):
    return {kind: _engines(models, kind) for kind in ENGINES}


def _legal_rows(n=4, trunk_words=70, seed=0):
    words = ("coverage policy flood water damage claim insurer premium "
             "exclusion endorsement peril deductible adjuster settle").split()
    rng = np.random.default_rng(seed)
    base = " ".join(rng.choice(words) for _ in range(trunk_words))
    return ([f"{base} case {i} Answer Yes or No ." for i in range(n)],
            [f"{base} case {i} Give a number 0 to 100 ." for i in range(n)])


def _shared(eng, bps, cps, use=True):
    if hasattr(eng, "fresh_handoff"):
        eng.fresh_handoff()
    n = len(bps)
    yes = np.full((n,), JaxFakeTokenizer.YES, np.int32)
    no = np.full((n,), JaxFakeTokenizer.NO, np.int32)
    return eng.decode_fused_shared(
        bps, cps, yes, no, new_tokens=NEW, conf_tokens=CONF, early_stop=True,
        bucket=BUCKET, sfx_buckets_ab=SFX, reuse_cache=True,
        use_prefix_cache=use, n_real=n)


def _compare_fused(a, b):
    """A JAX FusedDecodeOut against the port's: ids exact (top-k ids where
    the neighbouring values are separated), probabilities and log-probs
    within FTOL, the weighted confidence (a 0-100 value) within FTOL
    relative, as the sweep's D6 comparison holds it."""
    for name in ("generated", "top2_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=name)
    for name in ("p_yes", "p_no", "topk_logprobs"):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)), atol=FTOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(b.weighted_confidence.numpy(),
                               np.asarray(a.weighted_confidence), rtol=FTOL,
                               atol=0)
    vals = np.asarray(a.topk_logprobs)
    gap = np.abs(np.diff(vals, axis=-1)) > FTOL
    sep = np.ones_like(vals, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(np.asarray(a.topk_ids)[sep],
                                  b.topk_ids.numpy()[sep])


def _check_pair(jout, tout):
    for a, b in zip(jout, tout):
        _compare_fused(a, b)


def _cold_warm(engs, bps, cps, record=False):
    """The JAX cold unpaged reference, then the same dispatch cold and
    warm through both engines' caches (``record``: the cold dispatch's
    completions recorded into the trees between them, as the sweep
    does). Every port output is held to the JAX cold one and to its JAX
    twin; the caches must stay equal."""
    jref, jeng, teng = engs
    ref = _shared(jref, bps, cps)
    outs = []
    for visit in range(2):
        j, t = _shared(jeng, bps, cps), _shared(teng, bps, cps)
        _check_pair(ref, t)
        _check_pair(j, t)
        assert_same_cache_state(jeng.prefix_cache, teng.prefix_cache)
        if record and visit == 0:
            ids = _ids(teng, bps), _ids(teng, cps)
            for eng, out in ((jeng, j), (teng, t)):
                for rows, o in zip(ids, out):
                    eng.spec_record(BUCKET, rows, np.asarray(o.generated),
                                    len(rows))
            assert_same_cache_state(jeng.prefix_cache, teng.prefix_cache)
        outs.append(t)
    pool = teng.prefix_cache.pool
    assert pool.refcount[1:].sum() == pool.pages_in_use   # pins released
    return ref, outs


def _ids(eng, prompts):
    return [eng.tokenizer(p).input_ids for p in prompts]


SPEC_FIELDS = ("drafted_tokens", "accepted_tokens", "draft_tree",
               "accepted_tree", "draft_ngram", "accepted_ngram",
               "decode_forwards", "seq_forwards")


def test_shared_spec_cold_then_warm_with_tree_drafts(engines):
    """The speculative route: cold (unpaged, pages inserted), then warm
    (paged front, drafts from the tails the cold visit recorded)."""
    jref, jeng, teng = engines["spec"]
    bps, cps = _legal_rows()
    hits0 = teng.prefix_stats.hit_tokens
    warm0 = teng.paged_dispatches["shared_paged_spec"]
    _cold_warm(engines["spec"], bps, cps, record=True)
    assert teng.prefix_stats.inserted_pages > 0
    assert teng.prefix_stats.hit_tokens > hits0
    assert teng.paged_dispatches["shared_paged_spec"] == warm0 + 1
    # The tree drafts of a third visit: the arrays the JAX planner makes.
    for rows in (_ids(teng, bps), _ids(teng, cps)):
        for budget in (NEW, CONF):
            got = tspec._tree_drafts(teng.prefix_cache, BUCKET, rows, budget)
            ref = jspec._tree_drafts(jeng.prefix_cache, BUCKET, rows, budget)
            assert got[2] == ref[2] > 0
            assert np.array_equal(got[0], ref[0])
            assert np.array_equal(got[1], ref[1])
    jeng.spec_flush()
    teng.spec_flush()
    for f in SPEC_FIELDS:
        assert teng.spec_stats[f] == getattr(jeng.spec_stats, f), f
    assert teng.spec_stats["draft_tree"] > 0


def test_shared_spec_cross_length_trunk_reuse(engines):
    """Rows of other prefix lengths sharing the warm rows' trunk resume
    its pages within the bucket namespace: longer rows that extend the
    trunk, and rows that are a pure truncation of it."""
    jref, jeng, teng = engines["spec"]
    bps, cps = _legal_rows(seed=1)
    _shared(jeng, bps, cps)
    _shared(teng, bps, cps)
    tail = "under the flood exclusion endorsement riders"
    variants = (
        ([b.replace(" case", f" {tail} case") for b in bps],
         [c.replace(" case", f" {tail} case") for c in cps]),
        ([" ".join(bps[0].split()[:66]) + " Answer Yes or No ."] * 4,
         [" ".join(bps[0].split()[:66]) + " Give a number 0 to 100 ."] * 4))
    for lb, lc in variants:
        hits = teng.prefix_stats.hit_tokens
        ref = _shared(jref, lb, lc)
        j, t = _shared(jeng, lb, lc), _shared(teng, lb, lc)
        assert teng.prefix_stats.hit_tokens > hits
        _check_pair(ref, t)
        _check_pair(j, t)
        assert_same_cache_state(jeng.prefix_cache, teng.prefix_cache)


@pytest.mark.parametrize("kind", ["seq", "two_leg"])
def test_cascade_cold_then_warm_trunk(engines, kind):
    """The cascade: the trunk pages in the trunk-extent namespace, the
    warm dispatch resuming its trunk from them (fused kernel, and the
    two-leg route held to the JAX fused cascade)."""
    teng = engines[kind][2]
    bps, cps = _legal_rows(seed=2)
    trunk = teng.cascade_trunk_for(_ids(teng, bps), 4, BUCKET)
    assert trunk == 64
    _cold_warm(engines[kind], bps, cps)
    assert teng.paged_dispatches["cascade_paged"] == 1
    assert teng.cascade_stats["cascade_dispatches"] == 2
    assert trunk in teng.prefix_cache._roots


def test_grouped_cold_then_warm(engines):
    jref, jeng, teng = engines["seq"]
    groups = {}
    for name, sched in (("jax", jsched), ("torch", tsched)):
        rng = np.random.default_rng(5)
        gs = []
        for _ in range(2):
            base = [int(x) for x in rng.integers(3, 250, 40)]
            items = tuple(sched.SweepItem(
                cell=None, bin_ids=tuple(base + s + [7]),
                conf_ids=tuple(base + s + [9, 11]), lcp=44)
                for s in ([int(x) for x in rng.integers(3, 250, 4)]
                          for _ in range(2)))
            gs.append(sched.PrefixGroup(items=items, plen=40))
        groups[name] = gs
    yes = np.full((4,), JaxFakeTokenizer.YES, np.int32)
    no = np.full((4,), JaxFakeTokenizer.NO, np.int32)

    def call(eng, gs, use):
        if hasattr(eng, "fresh_handoff"):
            eng.fresh_handoff()
        return eng.decode_fused_grouped(gs, yes, no, NEW, CONF, True, 64, 8,
                                        reuse_cache=True,
                                        use_prefix_cache=use)[0]

    ref = call(jref, groups["jax"], None)
    hits = teng.prefix_stats.hit_tokens
    for _ in range(2):
        j, t = call(jeng, groups["jax"], True), call(teng, groups["torch"],
                                                     True)
        _compare_fused(ref, t)
        _compare_fused(j, t)
        assert_same_cache_state(jeng.prefix_cache, teng.prefix_cache)
    assert teng.prefix_stats.hit_tokens > hits
    assert teng.paged_dispatches["grouped_paged"] == 1


def test_tight_pool_evicts_and_matches_cold(engines):
    """A pool of 5 usable pages under rows that need more: every
    dispatch still matches the JAX cold output, pages are evicted, and
    the refcounts balance."""
    teng = engines["tight"][2]
    for seed in range(3):
        bps, cps = _legal_rows(seed=10 + seed)
        _cold_warm(engines["tight"], bps, cps)
    assert teng.prefix_stats.evicted_pages > 0
    assert teng.paged_dispatches["shared_paged"] > 0
    assert teng.prefix_stats.pages_total == 5


# ---------------------------------------------------------------------------
# The perturbation sweep with the cache on: a cold pass, then a warm one
# ---------------------------------------------------------------------------

RF, CF = "Answer Yes or No .", "Give a number 0 to 100 ."


def _sweep_grid():
    """Two prompts whose four cells each (the original and three
    rephrasings) share a 66-word preamble and end in 6 to 10 words of
    their own: each prompt's cells fill one dispatch at bucket 96 with
    the speculative engine's shape, and a warm visit takes the 16-token
    window."""
    rng = np.random.default_rng(7)

    def words(n, tag):
        return " ".join(f"{tag}{int(x)}" for x in rng.integers(0, 10**6, n))

    prompts, perts = [], []
    for p in range(2):
        pre = words(66, f"p{p}_")
        prompts.append(LegalPrompt(main=f"{pre} {words(8, 'm')}",
                                   response_format=RF,
                                   target_tokens=("Yes", "No"),
                                   confidence_format=CF))
        perts.append([f"{pre} {words(6 + 2 * i, 'r')}" for i in range(3)])
    return prompts, perts


def test_sweep_with_the_cache_matches_jax(engines, models, tmp_path,
                                          monkeypatch):
    _, _, cfg_t, pt = models
    prompts, perts = _sweep_grid()
    jprompts = [JaxLegalPrompt(**dataclasses.asdict(p)) for p in prompts]
    jeng = _jax_engine(models, "spec")
    # The JAX engine hands each dispatch the last one's cache as a donated
    # scratch buffer (memory reuse only, never read): a second executable
    # signature per shape. Without it the sweep runs the executables the
    # direct dispatches above compiled.
    monkeypatch.setattr(jpaged.CacheHandoff, "put",
                        lambda self, key, cache: None)
    teng = ScoringEngine(pt, cfg_t, TOKZ, RuntimeConfig(**_rt("spec")),
                         device="cpu")
    for visit in ("cold", "warm"):
        jrows = jsweep.run_perturbation_sweep(
            jeng, "m", jprompts, perts, tmp_path / f"j_{visit}.csv")
        trows = tsweep.run_perturbation_sweep(
            teng, "m", prompts, perts, tmp_path / f"t_{visit}.csv")
        assert len(trows) == 8
        _compare_rows(jrows, trows)
        assert_same_cache_state(jeng.prefix_cache, teng.prefix_cache)
        if visit == "cold":
            assert teng.prefix_stats.hit_tokens == 0
            cold_rows = trows
    _compare_rows(cold_rows, trows)
    assert teng.prefix_stats.hit_tokens > 0
    assert teng.paged_dispatches["shared_paged_spec"] == 2
    jeng.spec_flush()
    teng.spec_flush()
    for f in SPEC_FIELDS:
        assert teng.spec_stats[f] == getattr(jeng.spec_stats, f), f
    assert teng.spec_stats["accepted_tree"] > 0
