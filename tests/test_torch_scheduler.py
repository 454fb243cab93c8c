"""The port's ragged scheduler, grid and grouped decode against the JAX
package's.

Planning is host code: the port's ``RaggedScheduler`` must plan exactly
the JAX one's dispatches (kinds, buckets, item order, suffix buckets,
refilled counts, groups) and fill the same ``OccupancyStats``, on seeded
token-id lists. The grouped decode (one prefill per prefix group,
gathered out to the member rows, one extension, the fused loop with
per-row stop tables) runs on both packages from the same parameters:
generated ids and top-2 ids exact, floats within 1e-5 (the weighted
confidence, a 0-100 value, within 1e-5 relative), top-k ids exact where
the neighbouring values are separated.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import generate as jgen
from lir_tpu.engine import grid as jgrid
from lir_tpu.engine import scheduler as jsched
from lir_tpu.engine import tokens as jtok
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import cache as jcache
from lir_tpu.models import decoder as jdec
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
from lir_tpu.utils.profiling import OccupancyStats as JaxOccupancy
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import LEGAL_PROMPTS
from lir_tpu_torch.engine import generate as tgen
from lir_tpu_torch.engine import grid as tgrid
from lir_tpu_torch.engine import scheduler as tsched
from lir_tpu_torch.engine import tokens as ttok
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder as tdec
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.utils.manifest import SweepManifest
from lir_tpu_torch.utils.profiling import OccupancyStats

from test_torch_engine import CFG, WEIGHT_SCALE, _compare_fused

FTOL = 1e-5


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def _token_items(module, seed: int, n: int, shared_heads: int):
    """Seeded SweepItems of ``module``: ``shared_heads`` families of cells
    whose prompts open with a family head (some long enough to group),
    the rest with random openings, lengths spread over several buckets."""
    rng = np.random.default_rng(seed)
    heads = [[int(x) for x in rng.integers(3, 900, int(rng.integers(12, 60)))]
             for _ in range(shared_heads)]
    bins, confs = [], []
    for i in range(n):
        if heads and i % 3 == 0:
            body = heads[i % len(heads)] + [
                int(x) for x in rng.integers(3, 900, int(rng.integers(1, 40)))]
        else:
            body = [int(x) for x in rng.integers(3, 900,
                                                 int(rng.integers(5, 400)))]
        fa = [int(x) for x in rng.integers(3, 900, int(rng.integers(1, 12)))]
        fb = [int(x) for x in rng.integers(3, 900, int(rng.integers(1, 30)))]
        bins.append(body + [1] + fa)
        confs.append(body + [2] + fb)
    return module.build_items(bins, confs, [("cell", i) for i in range(n)])


def _plan_key(dispatches):
    return [(d.kind, d.bucket, d.cells, d.refilled, d.sfx_bucket_a,
             d.sfx_bucket_b,
             None if d.groups is None else
             [(g.plen, [it.cell for it in g.items]) for g in d.groups])
            for d in dispatches]


PLAN_CASES = {
    "grouping_on": dict(batch=8, kw={}),
    "grouping_off": dict(batch=8, kw=dict(group_cells=False)),
    "min_cells_2_prefix_8": dict(batch=4, kw=dict(min_group_cells=2,
                                                  min_group_prefix=8)),
    "learned_max_extent": dict(batch=8, kw=dict(max_extent=300)),
    "refill_batch_4": dict(batch=4, kw=dict(new_budget=4, decode_cost=12)),
    "unfused_refill": dict(batch=16, kw=dict(fused_decode=False)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_matches_jax(case, seed):
    spec = PLAN_CASES[case]
    ladder = ttok.bucket_ladder(512)
    assert ladder == jtok.bucket_ladder(512)
    j_stats, t_stats = JaxOccupancy(), OccupancyStats()
    j_plan = jsched.RaggedScheduler(
        ladder, spec["batch"], stats=j_stats, **spec["kw"]).schedule(
            _token_items(jsched, seed, 57, 4))
    t_plan = tsched.RaggedScheduler(
        ladder, spec["batch"], stats=t_stats, **spec["kw"]).schedule(
            _token_items(tsched, seed, 57, 4))
    assert _plan_key(t_plan) == _plan_key(j_plan)
    assert dataclasses.asdict(t_stats) == dataclasses.asdict(j_stats)
    assert t_stats.summary() == j_stats.summary()
    assert [d.padded_rows(spec["batch"]) for d in t_plan] == \
        [d.padded_rows(spec["batch"]) for d in j_plan]
    kinds = {d.kind for d in t_plan}
    if case == "grouping_off":
        assert kinds == {"shared"}
    if case in ("grouping_on", "min_cells_2_prefix_8"):
        assert kinds == {"shared", "grouped"}
    if case == "refill_batch_4":
        assert sum(d.refilled for d in t_plan) > 0


@pytest.mark.parametrize("args", [
    (1, 64, 4, 12, {}), (3, 96, 4, 12, {}), (5, 128, 8, 12, {}),
    (8, 256, 8, 12, dict(fused_decode=False)),
    (7, 512, 8, 12, dict(spec_decode=True)),
    (16, 384, 32, 12, dict(cascade=True, trunk_tokens=80)),
    (32, 512, 32, 12, dict(decode_trunk_frac=0.6)),
])
def test_cost_model_matches_jax(args):
    n, edge, batch, cost, kw = args
    assert tsched.bucket_cost(n, edge, batch, cost, **kw) == \
        jsched.bucket_cost(n, edge, batch, cost, **kw)
    dkw = {k: v for k, v in kw.items()
           if k in ("fused_decode", "spec_decode", "decode_trunk_frac")}
    assert tsched.decode_floor(n, batch, cost, **dkw) == \
        jsched.decode_floor(n, batch, cost, **dkw)


@pytest.mark.parametrize("length", [1, 63, 64, 65, 200, 700, 5000])
def test_assign_bucket_matches_jax(length):
    ladder = ttok.bucket_ladder(1024)
    assert ttok.assign_bucket(length, ladder) == \
        jtok.assign_bucket(length, ladder)


def test_target_token_ids_match_jax():
    for p in LEGAL_PROMPTS:
        assert ttok.target_token_ids(FakeTokenizer(32000), p.target_tokens) \
            == jtok.target_token_ids(JaxFakeTokenizer(32000), p.target_tokens)


# ---------------------------------------------------------------------------
# Grid
# ---------------------------------------------------------------------------

def _jax_prompts(prompts):
    return [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                           target_tokens=p.target_tokens,
                           confidence_format=p.confidence_format)
            for p in prompts]


def _cell_key(c):
    return (c.model, c.prompt_idx, c.rephrase_idx, c.original_main,
            c.rephrased_main, c.response_format, c.confidence_format,
            tuple(c.target_tokens), c.binary_prompt, c.confidence_prompt,
            c.resume_record())


PERTS = [[f"{p.main.split('.')[0]} variant {i} ." for i in range(r)]
         for p, r in zip(LEGAL_PROMPTS, (3, 0, 5, 1, 2))]


@pytest.mark.parametrize("include_original", [True, False])
@pytest.mark.parametrize("size", [None, 4, 9, 100])
def test_grid_subset_pending_match_jax(tmp_path, include_original, size):
    t_cells = tgrid.build_grid("m", LEGAL_PROMPTS, PERTS, include_original)
    j_cells = jgrid.build_grid("m", _jax_prompts(LEGAL_PROMPTS), PERTS,
                               include_original)
    assert [_cell_key(c) for c in t_cells] == [_cell_key(c) for c in j_cells]
    t_sub = tgrid.random_subset(t_cells, size, seed=7)
    j_sub = jgrid.random_subset(j_cells, size, seed=7)
    assert [_cell_key(c) for c in t_sub] == [_cell_key(c) for c in j_sub]
    man = SweepManifest(tmp_path / "m.jsonl", tgrid.RESUME_KEY_FIELDS)
    man.mark_done_many(c.resume_record()
                       for c in random.Random(3).sample(t_cells, 3))
    assert [_cell_key(c) for c in tgrid.pending_cells(t_sub, man)] == \
        [_cell_key(c) for c in jgrid.pending_cells(j_sub, man)]
    assert tgrid.RESUME_KEY_FIELDS == jgrid.RESUME_KEY_FIELDS
    assert tgrid.RESUME_COLUMN_MAP == jgrid.RESUME_COLUMN_MAP


# ---------------------------------------------------------------------------
# The grouped decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
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
                         piggyback_prefill=False, prefix_cache=False,
                         aot_precompile=False))
    teng = ScoringEngine(
        params_from_jax(tree, ModelConfig(**CFG), device="cpu"),
        ModelConfig(**CFG), FakeTokenizer(),
        RuntimeConfig(batch_size=4, max_new_tokens=12, spec_decode=False),
        device="cpu")
    yield jeng, teng
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _compare(a, b):
    """_compare_fused, with the weighted confidence held relatively (it
    is then passed on as the JAX value)."""
    wc = np.array(a.weighted_confidence)
    np.testing.assert_allclose(wc, b.weighted_confidence.numpy(), rtol=FTOL,
                               atol=0, err_msg="weighted_confidence")
    _compare_fused(a, dataclasses.replace(
        b, weighted_confidence=torch.from_numpy(wc)))


def _grouped_inputs(seed=4):
    """Two prefix groups (3 and 2 cells): each cell's [binary, confidence]
    member suffixes after its group's shared prefix, right-padded."""
    rng = np.random.default_rng(seed)
    heads = [[int(x) for x in rng.integers(3, 900, n)] for n in (24, 30)]
    sizes = (3, 2)
    prefix, sfx, gidx = [], [], []
    for gi, (head, n) in enumerate(zip(heads, sizes)):
        prefix.append(head)
        for c in range(n):
            tail = [int(x) for x in rng.integers(3, 900, 1 + c)]
            sfx.append(tail + [5, 6])
            sfx.append(tail + [7, 8, 9])
            gidx += [gi, gi]
    p, pm = ttok.right_pad_ids(prefix, 32, 0)
    s, sm = ttok.right_pad_ids(sfx, 8, 0)
    m = len(sfx)
    ids = (np.full((m,), 1, np.int32), np.full((m,), 2, np.int32))
    dig = (np.asarray([10, 11, 12], np.int32),
           np.asarray([1.0, 2.0, 3.0], np.float32))
    return (p, pm, s, sm, np.asarray(gidx, np.int32)) + ids + dig


@pytest.mark.parametrize("stops", ["unarmed", "eos_then_digit",
                                   "digit_everywhere"])
def test_grouped_decode_matches_jax(engines, stops):
    """generate.greedy_decode_fused_grouped on both packages: unarmed, and
    with explicit per-row stop tables (binary rows EOS-only, confidence
    rows a table whose every token is a prefixed pure digit, so those rows
    stop at step 2; or the digit table on every row)."""
    jeng, teng = engines
    args = _grouped_inputs()
    m = args[2].shape[0]
    V = CFG["vocab_size"]
    kw_np = {}
    if stops != "unarmed":
        digit = np.full((V,), jtok.STOP_PURE | jtok.STOP_PREFIX, np.int32)
        first = (jtok.eos_only_stop_classes(V) if stops == "eos_then_digit"
                 else digit)
        kw_np = dict(stop_mask=first, stop_mask2=digit,
                     stop_sel=np.arange(m) % 2 == 1)
    eos = 7
    out_j = jgen.greedy_decode_fused_grouped(
        jeng.params, jeng.cfg, *(jnp.asarray(a) for a in args), max_new=6,
        **{k: jnp.asarray(v) for k, v in kw_np.items()},
        **({"eos_id": jnp.int32(eos)} if kw_np else {}))
    out_t = tgen.greedy_decode_fused_grouped(
        teng.params, teng.cfg, *(torch.from_numpy(a) for a in args),
        max_new=6, **{k: torch.from_numpy(v) for k, v in kw_np.items()},
        **({"eos_id": eos} if kw_np else {}))
    _compare(out_j, out_t)
    if stops != "unarmed":
        assert bool((out_t.generated[1::2, 2:] == eos).all())


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 2, 5, 3, 4)).astype(np.float32)
    v = rng.standard_normal((2, 2, 5, 3, 4)).astype(np.float32)
    idx = np.asarray([2, 0, 0, 1, 2, 2], np.int32)
    got = tdec.gather_rows((torch.from_numpy(k), torch.from_numpy(v)),
                           torch.from_numpy(idx))
    want = jcache.gather_rows((jnp.asarray(k), jnp.asarray(v)),
                              jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _groups(module, eng, mains, bins, confs, one_cell_groups):
    tok_ids = [eng.tokenizer(p).input_ids for p in bins]
    conf_ids = [eng.tokenizer(p).input_ids for p in confs]
    items = module.build_items(tok_ids, conf_ids, list(range(len(mains))))
    if one_cell_groups:
        return [module.PrefixGroup(items=(it,), plen=it.lcp) for it in items]
    plen = min(it.lcp for it in items) - 2
    return [module.PrefixGroup(items=tuple(items[:3]), plen=plen),
            module.PrefixGroup(items=tuple(items[3:]), plen=plen)]


MAINS = [f"the quick brown fox {i} jumps over the lazy dog word {i * 7} "
         f"extra filler text here" for i in range(4)]
BINS = [m + " Respond with either Yes or No only" for m in MAINS]
CONFS = [m + " Give a confidence number from 0 to 100" for m in MAINS]


@pytest.mark.parametrize("one_cell_groups", [True, False])
def test_runner_grouped_dispatch_matches_jax(engines, one_cell_groups):
    """ScoringEngine.decode_fused_grouped on both packages: the member
    layout, padding and targets as the JAX runner lays them out."""
    jeng, teng = engines
    t1 = np.full((4,), FakeTokenizer.YES, np.int32)
    t2 = np.full((4,), FakeTokenizer.NO, np.int32)
    outs = []
    for module, eng in ((jsched, jeng), (tsched, teng)):
        groups = _groups(module, eng, MAINS, BINS, CONFS, one_cell_groups)
        outs.append(eng.decode_fused_grouped(groups, t1, t2, 4, 6, False,
                                             bucket=32, sfx_bucket=16))
    (out_j, m_j), (out_t, m_t) = outs
    assert m_j == m_t == 8
    _compare(out_j, out_t)


def test_grouped_decode_pairwise_equals_shared(engines):
    """decode_fused_grouped on one-cell groups ([bin, conf] members,
    group_idx = [0, 0, 1, 1, ...]) == decode_fused_shared on the same
    prompts — the pairwise special case the grouped path generalizes
    (the JAX package pins the same in tests/test_scheduler.py)."""
    _, eng = engines
    t1 = np.full((4,), FakeTokenizer.YES, np.int32)
    t2 = np.full((4,), FakeTokenizer.NO, np.int32)
    groups = _groups(tsched, eng, MAINS, BINS, CONFS, True)
    items = [g.items[0] for g in groups]
    bucket = ttok.pick_bucket([it.prefix_len for it in items], eng.buckets)
    sfx = ttok.pick_bucket(
        [max(len(it.bin_ids), len(it.conf_ids)) - it.lcp for it in items],
        tsched.SUFFIX_BUCKETS)
    out, m = eng.decode_fused_grouped(groups, t1, t2, 4, 4, False,
                                      bucket=bucket, sfx_bucket=sfx)
    assert m == 8
    ref_a, ref_b = eng.decode_fused_shared(BINS, CONFS, t1, t2, new_tokens=4,
                                           conf_tokens=4)
    for start, ref in ((0, ref_a), (1, ref_b)):
        rows = slice(start, m, 2)
        np.testing.assert_array_equal(out.generated[rows].numpy(),
                                      ref.generated.numpy())
        np.testing.assert_array_equal(out.topk_ids[rows].numpy(),
                                      ref.topk_ids.numpy())
        for name in ("p_yes", "p_no", "topk_logprobs"):
            np.testing.assert_allclose(getattr(out, name)[rows].numpy(),
                                       getattr(ref, name).numpy(),
                                       rtol=FTOL, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(out.weighted_confidence[1:m:2].numpy(),
                               ref_b.weighted_confidence.numpy(), rtol=FTOL)


def test_grouped_dispatch_planning_guards(engines):
    """The runner's two planning guards raise rather than truncate."""
    _, eng = engines
    groups = _groups(tsched, eng, MAINS, BINS, CONFS, True)
    t = np.full((4,), 1, np.int32)
    with pytest.raises(ValueError, match="longer than its bucket"):
        eng.decode_fused_grouped(groups, t, t, 4, 4, False, bucket=8,
                                 sfx_bucket=16)
    learned = ScoringEngine(
        tdec.init_params(ModelConfig(**dict(CFG, pos_embedding="learned",
                                            max_seq_len=64)), device="cpu"),
        ModelConfig(**dict(CFG, pos_embedding="learned", max_seq_len=64)),
        FakeTokenizer(), RuntimeConfig(batch_size=4, max_new_tokens=8,
                                       max_seq_len=48), device="cpu")
    with pytest.raises(ValueError, match="learned-position table"):
        learned.decode_fused_grouped(groups, t, t, 4, 4, False, bucket=48,
                                     sfx_bucket=16)
