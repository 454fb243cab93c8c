"""The port's KV-page migration (``lir_tpu_torch.serve.migrate``, the
pool's extract and insert, the tree's ``forget_tail``, the prefill-only
dispatch, the servers' page ops) against the JAX package's, on the CPU.
The cases of ``tests/test_migrate.py``:

- Device legs: pages extracted from one pool and inserted into a pool of
  another size come back bitwise; the port's extract of a pool built from
  numpy equals the JAX ``extract_pages`` of the same pool exactly, for a
  bf16 pair and an int8 cache with its float32 scales. ``chunk_checksum``
  equals JAX's on the same bytes, and ``corrupt_export_chunks`` flips the
  same offsets under the same seed.
- ``prefill_insert``: its pages are bitwise the port's own scoring
  dispatch's at the same bucket and row count, within the parity bar of
  the JAX ``prefill_insert``'s, and a repeat skips the cached rows with
  the JAX counts.
- Export and import: bitwise into another pool, idempotent, partial pulls
  aligned, ``ImportResult.pages`` as JAX's; a corrupt chunk is refused
  and rolled back (tree, refcounts, ``pages_in_use`` as before); a
  cancelled transfer keeps the refcounts sane; ``forget_tail`` rolls back
  and notifies, the ``ClusterPrefixIndex`` event streams equal to JAX's.
- Migrated decode: held to the JAX engine's COLD UNPAGED output within
  the parity bar (ROADMAP R1: not bitwise), cold, a warm repeat and with
  the early stop; on an int8 KV cache within R8's paged bars.
- Page ops run on the supervisor and propagate errors; an op waits for a
  held dispatch lock and fails with ``EnginePoisoned`` when an abandoned
  call holds it past its grace; transfer buffers ride the governor's
  ledger for each leg; ``MigrationStats`` has the JAX schema.
- The router's chain (``tests/test_torch_router.py``'s harness:
  scripted fake replicas, each with a real radix tree and page pool of
  its package, under one injected clock) through ``lir_tpu``'s router
  and the port's: the same
  placements, ``RouterStats`` and ``MigrationStats`` counters, trees and
  winning payloads in each scenario (a pure pull; a prefill then a pull;
  a cluster-tree hit; a short prefix scored colocated; a stall falling
  back, by the transfer and by the chain's deadline; a corrupt chunk
  falling back; a kill mid-migration; no survivor; ``enabled=False``).
- Real tiny engines behind the port's router, one prefill-role and two
  decode-role replicas: every payload within the bars of a colocated
  server's.

The JAX engines are built once for the module; their dispatches run the
interpreter hooks (caveat R2).
"""

import dataclasses
import functools
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lir_tpu.config as jconfig
import lir_tpu.faults as jfaults
import lir_tpu.serve as jserve
import lir_tpu.serve.migrate as jmig
from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.engine import prefix_tree as jtree
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models import paged as jpaged
from lir_tpu.models.registry import tiny as jax_tiny
from lir_tpu.utils.profiling import MigrationStats as JaxMigrationStats
import lir_tpu_torch.config as tconfig
import lir_tpu_torch.faults as tfaults
import lir_tpu_torch.serve as tserve
import lir_tpu_torch.serve.migrate as tmig
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import (GovernorConfig, MigrationConfig,
                                  RouterConfig, RuntimeConfig, ServeConfig)
from lir_tpu_torch.engine import prefix_tree as ttree
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.guard.watchdog import EnginePoisoned
from lir_tpu_torch.models import decoder, paged
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig, tiny
from lir_tpu_torch.utils.profiling import MigrationStats

from test_torch_engine import WEIGHT_SCALE
from test_torch_kv_int8 import (PAGED_LOGP_TOL, PAGED_PROB_TOL,
                                PAGED_WCONF_RTOL)
from test_torch_prefix_cache import JAX_TOKZ, TOKZ, _compare_fused

BUCKET, SFX, NEW, CONF = 128, (16, 16), 4, 6
# The pages' floats against the JAX package's (k/v of a tiny float32
# model whose weights are scaled by WEIGHT_SCALE).
PAGE_TOL = 1e-5


# ---------------------------------------------------------------------------
# Models and engines
# ---------------------------------------------------------------------------

def _scaled_tree(cfg_j, key, kv_int8=False):
    cfg_j = dataclasses.replace(cfg_j, kv_cache_int8=kv_int8)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        cfg_j, jax.random.PRNGKey(key), dtype=jnp.float32))
    for name, a in tree["layers"].items():
        if name.startswith("w"):
            tree["layers"][name] = a * WEIGHT_SCALE
    for name in ("tok_embed", "lm_head"):
        tree[name] = tree[name] * WEIGHT_SCALE
    cfg_t = dataclasses.replace(tiny("llama"), kv_cache_int8=kv_int8)
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
            params_from_jax(tree, cfg_t, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {"float": _scaled_tree(jax_tiny("llama"), 1),
            "int8": _scaled_tree(jax_tiny("llama"), 7, kv_int8=True)}


@pytest.fixture(autouse=True)
def _hooks():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    yield
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _rt(prefix, pages):
    # The JAX engine takes the cascade only on a TPU: the port's is off
    # so that both run the dense shared prefill and the speculative loop.
    return dict(batch_size=4, max_seq_len=128, prefix_cache=prefix,
                prefix_cache_pages=pages, cascade_prefill=False,
                streaming_stats=False)


def _engine(models, kind="float", prefix=True, pages=64, **kw):
    _, _, cfg_t, pt = models[kind]
    return ScoringEngine(pt, cfg_t, TOKZ,
                         RuntimeConfig(**_rt(prefix, pages), **kw),
                         device="cpu")


def _jax_engine(models, kind="float", prefix=True, pages=64):
    cfg_j, pj, _, _ = models[kind]
    return JaxEngine(pj, cfg_j, JAX_TOKZ, JaxRuntimeConfig(
        aot_precompile=False, piggyback_prefill=False,
        **_rt(prefix, pages)))


def _prompts(n, trunk_words=70, seed=0):
    words = ("coverage policy flood water damage claim insurer premium "
             "exclusion endorsement peril deductible adjuster").split()
    rng = np.random.default_rng(seed)
    base = " ".join(rng.choice(words) for _ in range(trunk_words))
    return ([f"{base} case {i} Answer Yes or No ." for i in range(n)],
            [f"{base} case {i} Give a number 0 to 100 ." for i in range(n)])


def _prefixes(bps, cps):
    out = []
    for a, b in zip(bps, cps):
        x, y = TOKZ(a).input_ids, TOKZ(b).input_ids
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        out.append(list(x[:n]))
    return out


def _shared(eng, bps, cps, use, early_stop=False):
    if hasattr(eng, "fresh_handoff"):
        eng.fresh_handoff()
    n = len(bps)
    yes = np.full((n,), JaxFakeTokenizer.YES, np.int32)
    no = np.full((n,), JaxFakeTokenizer.NO, np.int32)
    return eng.decode_fused_shared(
        bps, cps, yes, no, new_tokens=NEW, conf_tokens=CONF,
        early_stop=early_stop, bucket=BUCKET, sfx_buckets_ab=SFX,
        reuse_cache=True, use_prefix_cache=use, n_real=n)


def _blocks_np(blocks):
    """A block tree's leaves as numpy arrays of raw bits (bf16 as
    int16), either package."""
    leaves = (decoder.cache_leaves(blocks)
              if isinstance(decoder.cache_leaves(blocks)[0], torch.Tensor)
              else jax.tree.leaves(blocks))
    out = []
    for a in leaves:
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
            out.append(a.numpy())
        else:
            a = np.asarray(a)
            out.append(a.view(np.int16) if a.dtype.name == "bfloat16"
                       else a)
    return out


def _pages(eng, ids, bucket=BUCKET):
    tree = eng.prefix_cache
    m = tree.lookup(bucket, ids, record=False)
    try:
        return m.tokens, _blocks_np(tree.pool.extract(m.pages))
    finally:
        tree.release(m)


def _assert_pins_released(engine):
    pool = engine.prefix_cache.pool
    assert (pool.refcount >= 0).all()
    assert pool.refcount[1:].sum() == pool.pages_in_use


def _tree_snapshot(tree):
    pool = tree.pool
    return (len(tree), pool.free_pages, pool.pages_in_use,
            pool.refcount.tolist(), sorted(pool._free))


@pytest.fixture(scope="module")
def jax_ref(models):
    """The JAX side, once: prefill_insert pages (and the repeat's
    counts), an export/import roundtrip's pages landed, the forget_tail
    event stream, and the cold unpaged dispatches (float: with and
    without the early stop; int8)."""
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    try:
        out = {}
        bps, cps = _prompts(4, seed=3)
        prefixes = _prefixes(bps, cps)
        src = _jax_engine(models)
        covered = src.prefill_insert(BUCKET, prefixes)
        inserted = src.prefix_stats.inserted_pages
        covered2 = src.prefill_insert(BUCKET, prefixes)
        out["prefill"] = dict(
            covered=(covered, covered2),
            inserted=(inserted, src.prefix_stats.inserted_pages),
            pages=[_pages(src, ids) for ids in prefixes])
        cfg = jconfig.MigrationConfig(chunk_pages=2)
        dst = _jax_engine(models, pages=24)
        e = jmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
        r = jmig.import_prefix(dst, e, config=cfg)
        out["roundtrip"] = dict(n_pages=e.n_pages, chunks=len(e.chunks),
                                nbytes=e.nbytes, pages=r.pages,
                                nbytes_in=r.nbytes)
        # Partial pull: the destination holds the first two pages.
        ps = src.prefix_cache.page_size
        dst2 = _jax_engine(models)
        dst2.prefill_insert(BUCKET, [prefixes[0][:2 * ps]])
        have = dst2.prefix_cache.match_len(BUCKET, prefixes[0])
        e2 = jmig.export_prefix(src, BUCKET, prefixes[0], from_token=have,
                                config=cfg)
        r2 = jmig.import_prefix(dst2, e2, config=cfg)
        e3 = jmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
        r3 = jmig.import_prefix(dst2, e3, config=cfg)
        out["partial"] = dict(have=have, start=e2.start_tokens,
                              pages=(r2.pages, r3.pages),
                              match=dst2.prefix_cache.match_len(
                                  BUCKET, prefixes[0]))
        # forget_tail on a tree whose events feed a cluster index.
        eng = _jax_engine(models)
        idx = jtree.ClusterPrefixIndex(eng.prefix_cache.page_size)
        events = []
        eng.prefix_cache.add_listener(functools.partial(idx.on_event, "r0"))
        eng.prefix_cache.add_listener(
            lambda ev, b, ids: events.append((ev, b, tuple(ids))))
        eng.prefill_insert(BUCKET, prefixes[:1])
        removed = eng.prefix_cache.forget_tail(BUCKET, prefixes[0], 2)
        out["forget"] = dict(removed=removed, events=events,
                             nodes=len(eng.prefix_cache),
                             match=idx.match_pages(BUCKET, prefixes[0]))
        ref = _jax_engine(models, prefix=False)
        out["cold"] = {stop: _shared(ref, bps, cps, False, early_stop=stop)
                       for stop in (False, True)}
        ref8 = _jax_engine(models, "int8", prefix=False)
        out["cold_int8"] = _shared(ref8, bps, cps, False)
        out["prompts"] = (bps, cps, prefixes)
        return out
    finally:
        jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


# ---------------------------------------------------------------------------
# Device legs, checksums and corruption
# ---------------------------------------------------------------------------

def _np_cache(kind, rng, L=2, K=2, T=32, B=4, hd=8):
    """A cache of numpy leaves: a float pair (rounded to bf16) or the
    int8 cache's ((kq, ks), (vq, vs))."""
    if kind == "bf16":
        import ml_dtypes

        return tuple(rng.standard_normal((L, K, T, B, hd)).astype(
            np.float32).astype(ml_dtypes.bfloat16) for _ in range(2))
    return tuple((rng.integers(-127, 128, (L, K, T, B, hd), dtype=np.int8),
                  rng.random((L, K, T, B), dtype=np.float32) + 0.01)
                 for _ in range(2))


def _to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_to_torch(t) for t in tree)
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(_to_jax(t) for t in tree)
    return jnp.asarray(tree)


WRITES = [(1, 0, 0), (2, 0, 4), (3, 1, 8), (4, 3, 20), (5, 2, 28)]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_extract_insert_roundtrip_bitwise_and_as_jax(kind):
    """Pages written into one pool come back bitwise after extract ->
    insert into a pool of another size; the extract equals the JAX
    ``extract_pages`` of the same pool, every leaf, scales included."""
    cache = _np_cache(kind, np.random.default_rng(3))
    tc, jc = _to_torch(cache), _to_jax(cache)
    src = paged.KVPagePool(16, page_size=4)
    src.ensure(tc)
    src.scatter(tc, WRITES)
    jsrc = jpaged.KVPagePool(16, page_size=4)
    jsrc.ensure(jc)
    jsrc.scatter(jc, WRITES)
    ids = [1, 2, 3, 4, 5]
    blocks = src.extract(ids, pad_to=8)
    got, want = _blocks_np(blocks), _blocks_np(jsrc.extract(ids, pad_to=8))
    assert len(got) == len(want) == (2 if kind == "bf16" else 4)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dst = paged.KVPagePool(8, page_size=4)
    dst.ensure(tc)
    dst.insert(blocks, [5, 6, 7, 3, 2])
    back = _blocks_np(dst.extract([5, 6, 7, 3, 2]))
    for a, b in zip(back, got):
        np.testing.assert_array_equal(a[:, :, :5], b[:, :, :5])
    # The blocks really are the cache's slices (page 4 <- row 3, slot 20).
    first = _blocks_np(tc)[0]
    np.testing.assert_array_equal(back[0][:, :, 3],
                                  first[:, :, 20:24, 3])


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_chunk_checksum_and_corruption_match_jax(kind):
    """CRC32 over the same bytes equals JAX's; the corruption flips the
    same byte offsets under the same seed, and the checksums then
    disagree in both packages."""
    cache = _np_cache(kind, np.random.default_rng(5))
    tc, jc = _to_torch(cache), _to_jax(cache)
    assert tmig.chunk_checksum(tc) == jmig.chunk_checksum(
        jax.device_get(jc))

    def export(mig_mod, tree):
        return mig_mod.PageExport(
            bucket=64, ids=(), start_tokens=0, page_size=4, n_pages=2,
            chunk_pages=2, chunks=[(tree, 2), (tree, 2)],
            checksums=[0, 0], nbytes=0)

    t_host = _to_torch(cache)
    j_host = jax.tree.map(lambda a: np.array(a), cache)
    te, je = export(tmig, t_host), export(jmig, j_host)
    sums = (tmig.chunk_checksum(t_host), jmig.chunk_checksum(j_host))
    assert sums[0] == sums[1]
    n_t = tfaults.corrupt_export_chunks(te, seed="7:migrate:0")
    n_j = jfaults.corrupt_export_chunks(je, seed="7:migrate:0")
    assert n_t == n_j == 8 * len(_blocks_np(t_host))
    for a, b in zip(_blocks_np(t_host), _blocks_np(j_host)):
        np.testing.assert_array_equal(a, b)
    assert tmig.chunk_checksum(t_host) == jmig.chunk_checksum(j_host) \
        != sums[0]


# ---------------------------------------------------------------------------
# The prefill-only dispatch
# ---------------------------------------------------------------------------

def test_prefill_insert_pages_bitwise_vs_dispatch_and_near_jax(models,
                                                              jax_ref):
    """prefill_insert's pages are bitwise the pages the port's scoring
    dispatch inserts at the same bucket and row count, and within
    PAGE_TOL of the JAX prefill_insert's; its covered tokens are JAX's."""
    bps, cps, prefixes = jax_ref["prompts"]
    eng_a = _engine(models)
    _shared(eng_a, bps, cps, True)          # the dispatch's pages
    eng_b = _engine(models)
    covered = eng_b.prefill_insert(BUCKET, prefixes)
    assert covered == jax_ref["prefill"]["covered"][0]
    ps = eng_b.prefix_cache.page_size
    assert covered == (len(prefixes[0]) // ps) * ps
    for ids, (jtokens, jblocks) in zip(prefixes,
                                       jax_ref["prefill"]["pages"]):
        ta, ba = _pages(eng_a, ids)
        tb, bb = _pages(eng_b, ids)
        assert ta == tb == jtokens > 0
        for x, y, z in zip(ba, bb, jblocks):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose(y, z, atol=PAGE_TOL, rtol=PAGE_TOL)
    _assert_pins_released(eng_b)


def test_prefill_insert_skips_already_cached_rows(models, jax_ref):
    _, _, prefixes = jax_ref["prompts"]
    eng = _engine(models)
    c1 = eng.prefill_insert(BUCKET, prefixes)
    n1 = eng.prefix_stats.inserted_pages
    c2 = eng.prefill_insert(BUCKET, prefixes)     # a repeat: no new page
    assert (c1, c2) == jax_ref["prefill"]["covered"]
    assert (n1, eng.prefix_stats.inserted_pages) == \
        jax_ref["prefill"]["inserted"]
    assert n1 > 0


# ---------------------------------------------------------------------------
# Export and import
# ---------------------------------------------------------------------------

def test_export_import_roundtrip_bitwise_different_pool(models, jax_ref):
    _, _, prefixes = jax_ref["prompts"]
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes)
    dst = _engine(models, pages=24)
    cfg = MigrationConfig(chunk_pages=2)
    e = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    assert e is not None and len(e.checksums) == len(e.chunks) >= 2
    assert e.nbytes == src.prefix_cache.pool.page_nbytes() * e.n_pages
    r = tmig.import_prefix(dst, e, config=cfg)
    ref = jax_ref["roundtrip"]
    assert (e.n_pages, len(e.chunks), e.nbytes, r.pages, r.nbytes) == \
        (ref["n_pages"], ref["chunks"], ref["nbytes"], ref["pages"],
         ref["nbytes_in"])
    ts, bs = _pages(src, prefixes[0])
    td, bd = _pages(dst, prefixes[0])
    assert ts == td
    for x, y in zip(bs, bd):
        np.testing.assert_array_equal(x, y)
    _assert_pins_released(src)
    _assert_pins_released(dst)
    assert "migrate_buf:tiny-llama" not in src.governor.ledger()
    assert "migrate_buf:tiny-llama" not in dst.governor.ledger()


def test_import_is_idempotent_and_partial_pulls_align(models, jax_ref):
    _, _, prefixes = jax_ref["prompts"]
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes)
    dst = _engine(models)
    cfg = MigrationConfig(chunk_pages=2)
    ps = src.prefix_cache.page_size
    dst.prefill_insert(BUCKET, [prefixes[0][:2 * ps]])
    have = dst.prefix_cache.match_len(BUCKET, prefixes[0])
    e = tmig.export_prefix(src, BUCKET, prefixes[0], from_token=have,
                           config=cfg)
    r = tmig.import_prefix(dst, e, config=cfg)
    e2 = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    r2 = tmig.import_prefix(dst, e2, config=cfg)
    want = (len(prefixes[0]) // ps) * ps
    got = dict(have=have, start=e.start_tokens, pages=(r.pages, r2.pages),
               match=dst.prefix_cache.match_len(BUCKET, prefixes[0]))
    assert got == jax_ref["partial"]
    assert got["have"] == 2 * ps and got["match"] == want
    assert r.pages == (want - have) // ps and r2.pages == 0
    _assert_pins_released(dst)


def test_corrupt_chunk_refused_and_rolled_back(models, jax_ref):
    """A chunk corrupted in flight fails the verify: no page lands, the
    tree, the refcounts, the free list and pages_in_use are as before;
    a clean export then lands."""
    _, _, prefixes = jax_ref["prompts"]
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes[:2])
    dst = _engine(models, pages=24)
    other = _prefixes(*_prompts(1, seed=11))
    dst.prefill_insert(BUCKET, other)             # unrelated residents
    cfg = MigrationConfig(chunk_pages=2)
    e = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    assert tfaults.corrupt_export_chunks(e, seed="t") > 0
    before = _tree_snapshot(dst.prefix_cache)
    with pytest.raises(tmig.MigrationError, match="checksum"):
        tmig.import_prefix(dst, e, config=cfg)
    assert _tree_snapshot(dst.prefix_cache) == before
    e2 = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    assert tmig.import_prefix(dst, e2, config=cfg).pages == e2.n_pages
    _assert_pins_released(dst)


def test_cancelled_transfer_keeps_refcounts_sane(models, jax_ref):
    """A transfer dying mid-import (its second chunk unusable, after the
    first landed) rolls back: nodes removed, pages freed, no pin left."""
    _, _, prefixes = jax_ref["prompts"]
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes[:1])
    dst = _engine(models)
    cfg = MigrationConfig(chunk_pages=1, verify=False)
    e = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    e.chunks[1] = (None, e.chunks[1][1])
    before = _tree_snapshot(dst.prefix_cache)
    with pytest.raises(Exception):
        tmig.import_prefix(dst, e, config=cfg)
    assert _tree_snapshot(dst.prefix_cache) == before
    assert len(dst.prefix_cache) == 0


def test_forget_tail_rolls_back_and_notifies_as_jax(models, jax_ref):
    _, _, prefixes = jax_ref["prompts"]
    eng = _engine(models)
    idx = ttree.ClusterPrefixIndex(eng.prefix_cache.page_size)
    events = []
    eng.prefix_cache.add_listener(functools.partial(idx.on_event, "r0"))
    eng.prefix_cache.add_listener(
        lambda ev, b, ids: events.append((ev, b, tuple(ids))))
    eng.prefill_insert(BUCKET, prefixes[:1])
    n = len(eng.prefix_cache)
    removed = eng.prefix_cache.forget_tail(BUCKET, prefixes[0], 2)
    got = dict(removed=removed, events=events, nodes=len(eng.prefix_cache),
               match=idx.match_pages(BUCKET, prefixes[0]))
    assert got == jax_ref["forget"]
    assert removed == 2 and got["nodes"] == n - 2
    assert [e[0] for e in events] == ["insert", "evict", "evict"]
    _assert_pins_released(eng)


# ---------------------------------------------------------------------------
# Migrated decode
# ---------------------------------------------------------------------------

def _migrate_all(src, dst, prefixes, config=None):
    cfg = config or MigrationConfig(chunk_pages=2)
    moved = 0
    for ids in prefixes:
        e = tmig.export_prefix(src, BUCKET, ids, config=cfg)
        if e is not None:
            moved += tmig.import_prefix(dst, e, config=cfg).pages
    return moved


@pytest.mark.parametrize("case", ["cold", "warm_repeat", "early_stop"])
def test_migrated_decode_matches_jax_cold_unpaged(models, jax_ref, case):
    """Decode resuming from migrated pages, held to the JAX engine's cold
    unpaged output within the parity bar (ROADMAP R1: the migrated
    pages hold the prefill's dispatch shape, so not bitwise)."""
    bps, cps, prefixes = jax_ref["prompts"]
    stop = case == "early_stop"
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes)
    dst = _engine(models, pages=32)
    assert _migrate_all(src, dst, prefixes) > 0
    outs = [_shared(dst, bps, cps, True, early_stop=stop)]
    assert dst.prefix_stats.hit_tokens > 0, "decode did not resume warm"
    if case == "warm_repeat":
        outs.append(_shared(dst, bps, cps, True))
    for got in outs:
        for a, b in zip(jax_ref["cold"][stop], got):
            _compare_fused(a, b)
    _assert_pins_released(dst)


def test_migrated_decode_int8_kv_within_paged_bars(models, jax_ref):
    """The int8 KV cache: payloads and float32 scales migrate, the
    destination's pages are byte-equal to the source's, and its decode
    is within R8's paged bars of the JAX int8 cold unpaged output."""
    bps, cps, prefixes = jax_ref["prompts"]
    src = _engine(models, "int8")
    src.prefill_insert(BUCKET, prefixes)
    dst = _engine(models, "int8", pages=32)
    assert _migrate_all(src, dst, prefixes) > 0
    for ids in prefixes:
        ts, bs = _pages(src, ids)
        td, bd = _pages(dst, ids)
        assert ts == td and len(bd) == 4
        for x, y in zip(bs, bd):
            np.testing.assert_array_equal(x, y)
    got = _shared(dst, bps, cps, True)
    assert dst.prefix_stats.hit_tokens > 0
    for a, b in zip(jax_ref["cold_int8"], got):
        np.testing.assert_array_equal(np.asarray(a.generated),
                                      b.generated.numpy())
        for name in ("p_yes", "p_no"):
            np.testing.assert_allclose(getattr(b, name).numpy(),
                                       np.asarray(getattr(a, name)),
                                       atol=PAGED_PROB_TOL, rtol=0)
        np.testing.assert_allclose(b.topk_logprobs.numpy(),
                                   np.asarray(a.topk_logprobs),
                                   atol=PAGED_LOGP_TOL, rtol=0)
        np.testing.assert_allclose(b.weighted_confidence.numpy(),
                                   np.asarray(a.weighted_confidence),
                                   rtol=PAGED_WCONF_RTOL, atol=0)
    _assert_pins_released(dst)


# ---------------------------------------------------------------------------
# Page ops, the ledger, the stats
# ---------------------------------------------------------------------------

_SERVE = ServeConfig(classes=(("t", 600.0),), default_class="t",
                     linger_s=0.002, cache_entries=0)


def _tiny_server(seed=2, batch=4, **rt):
    cfg = ModelConfig(name="migrate-t", vocab_size=FakeTokenizer.VOCAB,
                      hidden_size=32, n_layers=1, n_heads=2,
                      intermediate_size=64, max_seq_len=256)
    params = decoder.init_params(cfg, seed=seed, device="cpu")
    eng = ScoringEngine(params, cfg, FakeTokenizer(),
                        RuntimeConfig(batch_size=batch, max_seq_len=256,
                                      **rt), device="cpu")
    return tserve.ScoringServer(eng, "migrate-t", _SERVE)


def test_page_ops_run_on_the_supervisor_and_propagate_errors():
    server = _tiny_server().start()
    try:
        seen = {}

        def probe(eng):
            seen["thread"] = threading.current_thread().name
            seen["locked"] = eng.watchdog.dispatch_lock._is_owned()
            return eng.prefix_cache.page_size

        fut = server.submit_page_op(probe)
        assert fut.result(30) == server.engine.prefix_cache.page_size
        assert seen == {"thread": "serve-supervisor", "locked": True}
        threads = []
        fut.add_done_callback(
            lambda f: threads.append(threading.current_thread().name))
        assert threads == [threading.current_thread().name]  # already done

        def boom(eng):
            raise ValueError("page op boom")

        fut2 = server.submit_page_op(boom)
        fired = threading.Event()
        on = []
        fut2.add_done_callback(
            lambda f: (on.append(threading.current_thread().name),
                       fired.set()))
        with pytest.raises(ValueError, match="page op boom"):
            fut2.result(30)
        assert fired.wait(5) and on == ["serve-supervisor"]
        # A prefill-only dispatch through the same queue.
        ids = list(range(1, 40))
        assert server.submit_prefill(64, ids).result(60) == 32
        assert server.engine.prefix_cache.match_len(64, ids) == 32
    finally:
        server.stop()


def test_a_page_op_waits_for_the_dispatch_lock_and_fails_when_poisoned():
    """A page op waits while a dispatch holds the engine's lock; once an
    abandoned call holds it past its grace the op fails with
    EnginePoisoned instead of blocking (the chain then falls back)."""
    server = _tiny_server().start()
    wd = server.engine.watchdog
    try:
        held, release = threading.Event(), threading.Event()

        def holder():
            with wd.dispatch_lock:
                held.set()
                release.wait(10)

        t = threading.Thread(target=holder)
        t.start()
        held.wait(5)
        fut = server.submit_page_op(lambda eng: time.monotonic())
        time.sleep(0.2)
        assert not fut.done()
        t_release = time.monotonic()
        release.set()
        assert fut.result(30) >= t_release
        t.join()
        # An abandoned call still inside past its grace.
        held.clear()
        release.clear()
        t = threading.Thread(target=holder)
        t.start()
        held.wait(5)
        wd.grace_s = 0.1
        wd._stalled(1.0, 1.0)
        fut = server.submit_page_op(lambda eng: "ran")
        with pytest.raises(EnginePoisoned):
            fut.result(30)
        release.set()
        t.join()
        assert server.submit_page_op(lambda eng: "ran").result(30) == "ran"
    finally:
        release.set()
        server.stop()


def test_transfer_buffers_ride_the_governor_ledger(models, jax_ref):
    _, _, prefixes = jax_ref["prompts"]
    src = _engine(models)
    src.prefill_insert(BUCKET, prefixes[:1])
    dst = ScoringEngine(src.params, src.cfg, TOKZ,
                        RuntimeConfig(**_rt(True, 64)),
                        governor_config=GovernorConfig(), device="cpu")
    key = f"migrate_buf:{src.cfg.name}"
    for eng in (src, dst):
        seen = []
        real = eng.governor.register
        eng.governor.register = (lambda n, b, real=real, seen=seen:
                                 (seen.append((n, b)), real(n, b)))
        eng.seen = seen
    cfg = MigrationConfig(chunk_pages=2)
    e = tmig.export_prefix(src, BUCKET, prefixes[0], config=cfg)
    tmig.import_prefix(dst, e, config=cfg)
    page = src.prefix_cache.pool.page_nbytes()
    assert (key, page * e.n_pages) in src.seen
    assert (key, page * e.n_pages) in dst.seen
    for eng in (src, dst):
        assert key not in eng.governor.ledger()


def test_migration_stats_schema_mirrors_jax():
    names = [f.name for f in dataclasses.fields(MigrationStats)]
    assert names == [f.name for f in dataclasses.fields(JaxMigrationStats)]
    summaries = []
    for cls in (MigrationStats, JaxMigrationStats):
        s = cls()
        s.add_transfer(pages=3, nbytes=100, chunks=2, exposed_s=0.51234,
                       hidden_s=0.23456)
        s.count("refetch_fallbacks")
        s.count("stalls", 2)
        summaries.append(s.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["pages_migrated"] == 3
    assert tconfig.MigrationConfig() .__dict__ == \
        jconfig.MigrationConfig().__dict__


# ---------------------------------------------------------------------------
# The router's chain: scripted replicas with real trees, both routers
# ---------------------------------------------------------------------------

PS = 4


def _ns(serve, config, migrate, faults, paged_mod, tree_mod, tokz, zeros):
    return types.SimpleNamespace(
        Router=serve.ReplicaRouter, RouterConfig=config.RouterConfig,
        MigrationConfig=config.MigrationConfig,
        ServeConfig=config.ServeConfig, Future=serve.ServeFuture,
        Request=serve.ServeRequest, Result=serve.ServeResult,
        migrate=migrate, faults=faults, paged=paged_mod, tree=tree_mod,
        Tokenizer=tokz, zeros=zeros)


NS = {
    "jax": _ns(jserve, jconfig, jmig, jfaults, jpaged, jtree,
               JaxFakeTokenizer,
               lambda shape: jnp.zeros(shape, jnp.float32)),
    "torch": _ns(tserve, tconfig, tmig, tfaults, paged, ttree,
                 FakeTokenizer, lambda shape: torch.zeros(shape)),
}
MARKERS = {"pre": 0.125, "d0": 0.25, "d1": 0.375}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class MigReplica:
    """A scripted replica server with a real radix tree over a real page
    pool of its package (tiny leaves): its page ops run ``fn(engine)``
    at once, or wait for :meth:`release` while ``hold``; its prefill
    plans the prefix's pages into the tree; a scoring submit resolves
    with the replica's marker (or stays pending with ``hang``)."""

    def __init__(self, ns, name, placements, depth=0):
        self.ns = ns
        self.name = name
        self.placements = placements
        self.config = ns.ServeConfig(classes=(("t", 600.0),),
                                     default_class="t")
        self.queue_depth = depth
        pool = ns.paged.KVPagePool(64, page_size=PS)
        pool.ensure((ns.zeros((1, 1, 8, 1, 2)), ns.zeros((1, 1, 8, 1, 2))))
        self.engine = types.SimpleNamespace(
            prefix_cache=ns.tree.RadixPrefixCache(pool),
            tokenizer=ns.Tokenizer(), _tok_lock=threading.Lock(),
            buckets=[16, 32, 64, 128, 256])
        self.hold = False
        self.hang = False
        self.held = []
        self.submitted = []

    def oldest_wait(self, now):
        return 0.0

    def submit(self, request):
        fut = self.ns.Future()
        self.submitted.append((request, fut))
        self.placements.append((self.name, request.request_id))
        if not self.hang:
            fut.resolve(self.ns.Result(
                request_id=request.request_id, status="ok",
                model_response="Yes", model_confidence_response="80",
                token_1_prob=MARKERS[self.name],
                token_2_prob=1 - MARKERS[self.name],
                log_probabilities="{}", confidence_value=80,
                weighted_confidence=80.0))
        return fut

    def submit_page_op(self, fn):
        op = self.ns.migrate.PageOp(fn)
        self.placements.append((self.name, "page_op"))
        if self.hold:
            self.held.append(op)
        else:
            op.run(self.engine)
        return op.future

    def submit_prefill(self, bucket, prefix_ids):
        ids = tuple(int(t) for t in prefix_ids)
        self.placements.append((self.name, "prefill"))

        def prefill(eng):
            eng.prefix_cache.plan_insert(bucket, ids)
            return eng.prefix_cache.match_len(bucket, ids)

        op = self.ns.migrate.PageOp(prefill)
        if self.hold:
            self.held.append(op)
        else:
            op.run(self.engine)
        return op.future

    def release(self):
        self.hold = False
        while self.held:
            self.held.pop(0).run(self.engine)

    def warm(self, request):
        """Plan the request's prefix pages into this tree (a replica
        that scored the prefix before)."""
        bucket, ids = _prefix_key(self, request)
        self.engine.prefix_cache.plan_insert(bucket, ids)


def _prefix_key(rep, request):
    from lir_tpu_torch.engine import tokens as tok

    a = rep.engine.tokenizer(request.binary_prompt).input_ids
    b = rep.engine.tokenizer(request.confidence_prompt).input_ids
    lcp = tok.shared_prefix_len(a, b)
    return tok.assign_bucket(max(lcp, 1), rep.engine.buckets), \
        tuple(int(t) for t in a[:lcp])


def _chain_req(ns, words, rid="q0"):
    rng = np.random.default_rng(words)
    vocab = "coverage policy flood water damage claim insurer".split()
    body = " ".join(rng.choice(vocab) for _ in range(words))
    return ns.Request(binary_prompt=f"{body} Answer Yes or No .",
                      confidence_prompt=f"{body} Give a number 0 to 100 .",
                      klass="t", request_id=rid)


def _chain_world(ns, names, roles, depths=None, **migrate):
    placements, clock = [], Clock()
    reps = {n: MigReplica(ns, n, placements, (depths or {}).get(n, 0))
            for n in names}
    migrate.setdefault("chunk_pages", 2)
    migrate.setdefault("min_prefix_tokens", 16)
    router = ns.Router(list(reps.items()),
                       config=ns.RouterConfig(cache_entries=0),
                       clock=clock, roles=roles,
                       migrate=ns.MigrationConfig(**migrate))
    return router, reps, placements, clock


def _chain_trace(router, reps, placements, results):
    return {"placements": list(placements),
            "stats": router.stats.summary(),
            "summary": router.stats_summary(),
            "trees": {n: (len(r.engine.prefix_cache),
                          r.engine.prefix_cache.pool.pages_in_use,
                          r.engine.prefix_cache.pool.refcount.tolist())
                      for n, r in reps.items()},
            "results": [(r.request_id, r.status, r.token_1_prob, r.note
                         if r.status != "ok" else "") for r in results]}


ROLES3 = {"pre": "prefill", "d0": "decode", "d1": "decode"}
ROLES2 = {"pre": "prefill", "d0": "decode"}


def ch_pure_pull(ns):
    """d1 holds the prefix; d0 wins placement (d1 is deep): the pages
    are pulled from d1 with no prefill."""
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0", "d1"], ROLES3,
                                       depths={"d1": 50})
    req = _chain_req(ns, 40)
    reps["d1"].warm(req)
    res = router.submit(req).result(1)
    st = router.migrate_stats
    assert (st.migrations, st.prefill_ops) == (1, 0) and res.status == "ok"
    assert res.token_1_prob == MARKERS["d0"]
    return _chain_trace(router, reps, pl, [res])


def ch_prefill_then_pull(ns):
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0", "d1"], ROLES3)
    reqs = [_chain_req(ns, 40, "q0"), _chain_req(ns, 44, "q1")]
    res = [router.submit(r).result(1) for r in reqs]
    st = router.migrate_stats
    assert (st.migrations, st.prefill_ops) == (2, 2)
    assert router.stats.per_replica.get("pre", 0) == 0
    return _chain_trace(router, reps, pl, res)


def ch_cluster_tree_hit(ns):
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2)
    req = _chain_req(ns, 40)
    reps["d0"].warm(req)
    res = router.submit(req).result(1)
    assert router.migrate_stats.cluster_tree_hits == 1
    assert router.migrate_stats.migrations == 0
    return _chain_trace(router, reps, pl, [res])


def ch_short_prefix_colocated(ns):
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2,
                                       min_prefix_tokens=10_000)
    res = router.submit(_chain_req(ns, 40)).result(1)
    st = router.migrate_stats
    assert (st.migrations, st.prefill_ops, st.refetch_fallbacks) == (0, 0, 0)
    assert res.token_1_prob == MARKERS["d0"]
    return _chain_trace(router, reps, pl, [res])


def ch_stall_transfer(ns):
    """migration_stall at the wire hop: the transfer raises, the chain
    falls back, the request scores locally on d0."""
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2)
    plan = ns.faults.FaultPlan(seed=5, schedules={
        "migrate": ns.faults.SiteSchedule.migration_stall_at(0, 0.0)})
    ns.faults.wrap_migrator(router.migrator, plan)
    res = router.submit(_chain_req(ns, 40)).result(1)
    st = router.migrate_stats
    assert plan.injected("migrate") == 1
    assert (st.stalls, st.refetch_fallbacks, st.migrations) == (1, 1, 0)
    return _chain_trace(router, reps, pl, [res])


def ch_stall_deadline(ns):
    """The import is held past the chain's deadline: the tick falls back
    (the request scores on d0 by a local re-prefill); the late import
    then lands harmlessly, the claim already taken."""
    router, reps, pl, clock = _chain_world(ns, ["pre", "d0"], ROLES2,
                                           timeout_s=5.0)
    reps["d0"].hold = True
    fut = router.submit(_chain_req(ns, 40))
    assert not fut.done()
    clock.t = 4.0
    router._tick()
    assert not fut.done()
    clock.t = 6.0
    router._tick()
    res = fut.result(1)
    reps["d0"].release()
    st = router.migrate_stats
    assert (st.stalls, st.refetch_fallbacks, st.migrations) == (1, 1, 0)
    return _chain_trace(router, reps, pl, [res])


def ch_corrupt(ns):
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2)
    plan = ns.faults.FaultPlan(seed=6, schedules={
        "migrate": ns.faults.SiteSchedule.migration_corrupt_at(0)})
    ns.faults.wrap_migrator(router.migrator, plan)
    tree = reps["d0"].engine.prefix_cache
    before = (len(tree), tree.pool.pages_in_use, tree.pool.refcount.tolist())
    res = router.submit(_chain_req(ns, 40)).result(1)
    st = router.migrate_stats
    assert (st.corrupt_chunks, st.refetch_fallbacks) == (1, 1)
    assert (len(tree), tree.pool.pages_in_use,
            tree.pool.refcount.tolist()) == before
    return _chain_trace(router, reps, pl, [res])


def ch_kill_mid_migration(ns):
    """The prefill replica dies with the chain's prefill queued: the
    request re-prefills on d0 at once; the late prefill and export are
    no-ops."""
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0", "d1"], ROLES3)
    reps["pre"].hold = True
    fut = router.submit(_chain_req(ns, 40))
    assert not fut.done()
    router.kill_replica("pre")
    res = fut.result(1)
    reps["pre"].release()
    st = router.migrate_stats
    assert (st.refetch_fallbacks, st.migrations, st.prefill_ops) == (1, 0, 1)
    return _chain_trace(router, reps, pl, [res])


def ch_no_survivor(ns):
    """The decode replica dies mid-chain and the only other replica's
    breaker is open: the request resolves once, with an error."""
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2)
    reps["pre"].hold = True
    fut = router.submit(_chain_req(ns, 40))
    router.breaker_of("pre").trip()
    router.kill_replica("d0")
    res = fut.result(1)
    reps["pre"].release()
    assert res.status == "error" and router.stats.errors == 1
    return _chain_trace(router, reps, pl, [res])


def ch_disabled(ns):
    router, reps, pl, _ = _chain_world(ns, ["pre", "d0"], ROLES2,
                                       enabled=False)
    res = [router.submit(_chain_req(ns, 40 + i, f"q{i}")).result(1)
           for i in range(3)]
    st = router.migrate_stats.summary()
    assert set(st.values()) == {0}
    assert router.stats.per_replica == {"d0": 3}
    return _chain_trace(router, reps, pl, res)


CHAINS = {f.__name__[3:]: f for f in (
    ch_pure_pull, ch_prefill_then_pull, ch_cluster_tree_hit,
    ch_short_prefix_colocated, ch_stall_transfer, ch_stall_deadline,
    ch_corrupt, ch_kill_mid_migration, ch_no_survivor, ch_disabled)}


@pytest.mark.parametrize("name", list(CHAINS))
def test_router_chain_matches_jax(name):
    want = CHAINS[name](NS["jax"])
    got = CHAINS[name](NS["torch"])
    assert got == want


# ---------------------------------------------------------------------------
# Real tiny engines behind the port's router
# ---------------------------------------------------------------------------

PAYLOAD_FIELDS = ("model_response", "model_confidence_response",
                  "token_1_prob", "token_2_prob", "log_probabilities",
                  "confidence_value", "weighted_confidence")


def _serve_req(body, rid):
    return tserve.ServeRequest(
        binary_prompt=f"{body} Answer Yes or No .",
        confidence_prompt=f"{body} Give a number from 0 to 100 .",
        klass="t", request_id=rid)


def _trunk(seed, words=55):
    rng = np.random.default_rng(seed)
    vocab = "coverage policy flood water damage claim insurer premium".split()
    return " ".join(rng.choice(vocab) for _ in range(words))


def _close(got, want):
    assert got.status == want.status == "ok"
    for f in ("model_response", "model_confidence_response",
              "confidence_value", "log_probabilities"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("token_1_prob", "token_2_prob", "weighted_confidence"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_router_disagg_end_to_end_on_decode_replicas_only():
    """One prefill-role and two decode-role replicas: every request ok,
    scoring only on decode replicas, pages migrated, payloads within the
    bars of a colocated server's (here equal: one shape a dispatch); the
    ``"migrate"`` block counts the chains; no ledger entry left."""
    reqs = [_serve_req(f"{_trunk(9)} case {i}", str(i)) for i in range(5)]
    colo = _tiny_server().start()
    base = [colo.submit(r).result(120) for r in reqs]
    colo.stop()
    servers = [_tiny_server().start() for _ in range(3)]
    router = tserve.ReplicaRouter(
        [("pre", servers[0]), ("d0", servers[1]), ("d1", servers[2])],
        config=RouterConfig(cache_entries=0, tick_s=0.01),
        roles=ROLES3,
        migrate=MigrationConfig(min_prefix_tokens=16, chunk_pages=2)).start()
    try:
        res = [router.submit(r).result(120) for r in reqs]
        for got, want in zip(res, base):
            _close(got, want)
        st = router.stats_summary()["migrate"]
        assert st["migrations"] >= 1 and st["prefill_ops"] >= 1
        assert st["pages_migrated"] > 0 and st["refetch_fallbacks"] == 0
        assert router.stats.per_replica.get("pre", 0) == 0
        for s in servers:
            assert not any(k.startswith("migrate_buf:")
                           for k in s.engine.governor.ledger())
            _assert_pins_released(s.engine)
    finally:
        router.stop()
        for s in servers:
            s.stop()
