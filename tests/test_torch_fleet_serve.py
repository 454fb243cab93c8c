"""The port's fleet serving (``FleetScoringServer``, ``FleetBatcher``,
``fleet_decision``, ``aggregate_fleet``) and the governor's two serving
rungs on the CPU, against the JAX package's.

- ``fleet_decision`` and ``aggregate_fleet`` on the same results give
  JAX's answers exactly (decisions, statuses, kappa, disagreement),
  partial, error, NaN, missing and zero-total rows included, on fixed
  cases and on hypothesis-drawn fan-outs.
- A two-model fleet of tiny llamas, trees carried across from JAX's by
  ``params_from_jax``, answers the same ``fleet_score`` requests as the
  JAX fleet server over the same trees: statuses, decisions, confidence
  values and counts exact; probabilities and weighted confidence within
  the parity bar (``FTOL``); kappa and disagreement exactly JAX's
  wherever the decision vectors agree (they are then a pure function of
  the same integers).
- Each per-model payload is bitwise what a single-model port
  ``ScoringServer`` (prefix cache off, as the fleet batchers run) gives
  for the same request on the same engine, with the fleet unbudgeted
  and under a one-model weight budget (every switch evicts and
  re-streams the staged tree).
- ``batch_down`` halves each dispatch's rows and ``shed`` refuses at
  submit, in both packages alike (the governors' ladder levels set, their
  ticks stopped): the same dispatch sizes, the same statuses, payloads
  within ``FTOL`` of JAX's.
- An enabled ``tiers=`` and ``attach_observatory`` are refused.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.config import ServeConfig as JaxServeConfig
from lir_tpu.engine import hbm as jhbm
from lir_tpu.engine.fleet import ModelFleet as JaxFleet
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.models import registry as jreg
from lir_tpu.serve import FleetScoringServer as JaxFleetServer
from lir_tpu.serve import ScoringServer as JaxServer
from lir_tpu.serve import ServeRequest as JaxRequest
from lir_tpu.serve import ServeResult as JaxResult
from lir_tpu.serve import aggregate_fleet as jax_aggregate
from lir_tpu.serve import fleet_decision as jax_decision
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig, ServeConfig
from lir_tpu_torch.engine import hbm
from lir_tpu_torch.engine.fleet import ModelFleet
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import registry, weights
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.serve import (FleetScoringServer, ScoringServer,
                                 ServeRequest, ServeResult, aggregate_fleet,
                                 fleet_decision)

from test_torch_sweep import FTOL

WEIGHT_SCALE = 4.0
MODELS = {"m0": 0, "m1": 1}
RT = dict(batch_size=4, max_seq_len=128)
N_REQ = 6


def _serve_cfg(cls, **kw):
    base = dict(queue_depth=64, classes=(("t", 600.0),), default_class="t",
                linger_s=0.0, cache_entries=0)
    base.update(kw)
    return cls(**base)


def _bodies():
    rng = np.random.default_rng(11)
    words = "the policy covers flood damage under endorsement claim".split()
    return [" ".join(rng.choice(words) for _ in range(5 + i % 4))
            for i in range(N_REQ)]


BODIES = _bodies()


def _req(cls, i, rid=None):
    body = BODIES[i % N_REQ]
    return cls(binary_prompt=f"{body} Answer Yes or No .",
               confidence_prompt=f"{body} Give a number from 0 to 100 .",
               klass="t", request_id=rid or f"q{i}")


@pytest.fixture(scope="module")
def trees():
    """Each model's (JAX config, port config, JAX-initialised tree),
    scaled so no two candidate tokens sit within float noise."""
    kw = dict(vocab_size=FakeTokenizer.VOCAB, max_seq_len=128)
    out = {}
    for mid, seed in MODELS.items():
        cfg_j = dataclasses.replace(jreg.tiny("llama"), name=mid, **kw)
        cfg_t = dataclasses.replace(registry.tiny("llama"), name=mid, **kw)
        tree = jax.tree.map(np.asarray, jdec.init_params(
            cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32))
        for k, a in tree["layers"].items():
            if k.startswith("w"):
                tree["layers"][k] = a * WEIGHT_SCALE
        for k in ("tok_embed", "lm_head"):
            tree[k] = tree[k] * WEIGHT_SCALE
        out[mid] = (cfg_j, cfg_t, tree)
    return out


def _port_engine(trees, mid, **rt):
    _, cfg_t, tree = trees[mid]
    return ScoringEngine(params_from_jax(tree, cfg_t, device="cpu"), cfg_t,
                         FakeTokenizer(), RuntimeConfig(**{**RT, **rt}),
                         device="cpu")


def _jax_engine(trees, mid, **rt):
    cfg_j, _, tree = trees[mid]
    return JaxEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                     JaxFakeTokenizer(),
                     JaxRuntimeConfig(aot_precompile=False, spec_decode=False,
                                      **{**RT, **rt}))


def _fan_out(server, cls, single=None):
    """Every request fanned across the fleet, plus (``single``) one
    request routed to one model, submitted before the supervisor
    starts."""
    futs = [server.submit_fleet(_req(cls, i)) for i in range(N_REQ)]
    solo = (server.submit(_req(cls, 0, "solo"), single)
            if single is not None else None)
    server.start()
    try:
        out = [f.result(timeout=300) for f in futs]
        return out, (solo.result(timeout=300) if solo is not None else None)
    finally:
        server.stop()


@pytest.fixture(scope="module")
def jax_fleet(trees):
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    fleet = JaxFleet.from_engines([(m, _jax_engine(trees, m))
                                   for m in MODELS])
    server = JaxFleetServer(fleet, _serve_cfg(JaxServeConfig),
                            fleet_deadline_s=600.0)
    try:
        yield _fan_out(server, JaxRequest, single="m1")
    finally:
        fleet.shutdown()
        jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _port_fleet(trees, budget=None):
    engines = [(m, _port_engine(trees, m)) for m in MODELS]
    return ModelFleet.from_engines(engines, cache_budget_bytes=budget)


@pytest.fixture(scope="module")
def port_fleet(trees):
    """(fleet, fleet_score results, the single-model result) of the
    port's unbudgeted fleet; the fleet is left open for the per-model
    checks."""
    fleet = _port_fleet(trees)
    server = FleetScoringServer(fleet, _serve_cfg(ServeConfig),
                                fleet_deadline_s=600.0)
    results, solo = _fan_out(server, ServeRequest, single="m1")
    yield fleet, results, solo
    fleet.shutdown()


# ---------------------------------------------------------------------------
# fleet_decision and aggregate_fleet against JAX's, exactly
# ---------------------------------------------------------------------------

def _same(a, b):
    """Equal, NaN equal to NaN, through nested dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b and type(a) is type(b)


DECISION_CASES = [(0.6, 0.2), (0.2, 0.6), (0.5, 0.5), (None, 0.5),
                  (0.5, None), (0.0, 0.0), (float("nan"), 0.5),
                  (float("inf"), 0.1), (-0.2, 0.1), (1e-30, 1e-30),
                  (0.3, 0.0)]


@pytest.mark.parametrize("t1,t2", DECISION_CASES)
def test_fleet_decision_matches_jax(t1, t2):
    assert fleet_decision(t1, t2) == jax_decision(t1, t2)


def _results(cls, rows):
    return {f"m{i}": cls(request_id=f"a#m{i}", status=status,
                         token_1_prob=t1, token_2_prob=t2,
                         weighted_confidence=wc, confidence_value=cv,
                         cached=cached, note=note)
            for i, (status, t1, t2, wc, cv, cached, note) in enumerate(rows)}


def _aggregates(rows, latency=0.25):
    return (aggregate_fleet("a", _results(ServeResult, rows), latency),
            jax_aggregate("a", _results(JaxResult, rows), latency))


AGG_CASES = {
    "all_ok": [("ok", 0.7, 0.1, 60.0, 70, False, ""),
               ("ok", 0.2, 0.6, 40.0, 30, True, ""),
               ("ok", 0.8, 0.1, 80.0, 90, False, "")],
    "partial_error": [("ok", 0.7, 0.1, 60.0, 70, False, ""),
                      ("error", None, None, None, None, False, "boom")],
    "all_error": [("error", None, None, None, None, False, "boom")],
    "nan_row": [("ok", float("nan"), 0.1, 50.0, 50, False, ""),
                ("ok", 0.6, 0.3, 55.0, 60, False, ""),
                ("ok", 0.1, 0.6, 20.0, 10, False, "")],
    "zero_total": [("ok", 0.0, 0.0, 50.0, 50, False, ""),
                   ("ok", 0.6, 0.3, 55.0, 60, False, "")],
    "expired": [("deadline_exceeded", None, None, None, None, False,
                 "late"), ("ok", 0.6, 0.3, 55.0, 60, False, "")],
    "agree": [("ok", 0.9, 0.05, 90.0, 95, False, "")] * 4,
    "empty": [],
}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_aggregate_fleet_matches_jax(case):
    got, want = _aggregates(AGG_CASES[case])
    assert _same(got, want), (got, want)


_prob = st.one_of(st.none(), st.just(float("nan")), st.just(0.0),
                  st.floats(0.0, 1.0))
_row = st.tuples(st.sampled_from(["ok", "ok", "ok", "error", "shed",
                                  "deadline_exceeded"]),
                 _prob, _prob, st.one_of(st.none(), st.floats(0, 100)),
                 st.one_of(st.none(), st.integers(0, 100)), st.booleans(),
                 st.sampled_from(["", "note"]))


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.lists(_row, min_size=0, max_size=7))
def test_aggregate_fleet_matches_jax_drawn(rows):
    got, want = _aggregates(rows)
    assert _same(got, want), (got, want)


# ---------------------------------------------------------------------------
# The fleet server against JAX's and against single-model servers
# ---------------------------------------------------------------------------

def _check_against_jax(got, want):
    assert got["request_id"] == want["request_id"]
    for k in ("status", "n_models", "n_valid"):
        assert got[k] == want[k], k
    assert got["per_model"].keys() == want["per_model"].keys()
    for mid, w in want["per_model"].items():
        g = got["per_model"][mid]
        for k in ("status", "decision", "confidence_value", "cached"):
            assert g[k] == w[k], (mid, k)
        for k in ("token_1_prob", "token_2_prob"):
            np.testing.assert_allclose(g[k], w[k], atol=FTOL, rtol=0)
        np.testing.assert_allclose(g["weighted_confidence"],
                                   w["weighted_confidence"], rtol=FTOL)
    decs = [m["decision"] for m in got["per_model"].values()]
    if decs == [m["decision"] for m in want["per_model"].values()]:
        assert _same(got["kappa"], want["kappa"])
        assert _same(got["disagreement"], want["disagreement"])


def test_fleet_score_matches_jax(jax_fleet, port_fleet):
    want, want_solo = jax_fleet
    fleet, got, got_solo = port_fleet
    assert len(got) == len(want) == N_REQ
    for g, w in zip(got, want):
        _check_against_jax(g, w)
    assert got_solo.request_id == want_solo.request_id == "solo"
    assert got_solo.status == want_solo.status == "ok"
    assert got_solo.model_response == want_solo.model_response
    np.testing.assert_allclose(got_solo.token_1_prob, want_solo.token_1_prob,
                               atol=FTOL, rtol=0)
    assert fleet.stats.fleet_requests == N_REQ
    assert fleet.stats.fleet_rows == N_REQ * len(MODELS)


def _single_server_payloads(engine, model):
    """The fan-out's sub-requests for ``model`` served by a single-model
    ScoringServer on ``engine`` (prefix cache off)."""
    server = ScoringServer(engine, model,
                           _serve_cfg(ServeConfig, prefix_cache=False))
    futs = [server.submit(_req(ServeRequest, i, f"q{i}#{model}"))
            for i in range(N_REQ)]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


def _fleet_payloads_bitwise(fleet, results):
    for mid in MODELS:
        engine = fleet.acquire(mid)
        try:
            ref = _single_server_payloads(engine, mid)
        finally:
            fleet.release(mid)
        for agg, r in zip(results, ref):
            m = agg["per_model"][mid]
            assert r.status == m["status"] == "ok"
            for k in ("token_1_prob", "token_2_prob", "weighted_confidence",
                      "confidence_value"):
                assert m[k] == getattr(r, k), (mid, k)
            assert m["decision"] == fleet_decision(r.token_1_prob,
                                                   r.token_2_prob)


def test_fleet_payloads_bitwise_single_model_server(port_fleet):
    fleet, results, _ = port_fleet
    _fleet_payloads_bitwise(fleet, results)


def test_fleet_under_a_one_model_budget_is_bitwise(trees, port_fleet):
    """A budget of one model: every switch evicts and re-streams, and
    every payload is still the unbudgeted fleet's, bitwise."""
    _, ref, _ = port_fleet
    _, cfg_t, tree = trees["m0"]
    nb = weights.tree_bytes(params_from_jax(tree, cfg_t, device="cpu"))
    fleet = _port_fleet(trees, budget=nb + nb // 2)
    try:
        server = FleetScoringServer(fleet, _serve_cfg(ServeConfig),
                                    fleet_deadline_s=600.0)
        got, _ = _fan_out(server, ServeRequest)
        for g, r in zip(got, ref):
            assert g["status"] == "ok" and g["n_valid"] == len(MODELS)
            assert _same(g["per_model"], r["per_model"])
            assert _same(g["kappa"], r["kappa"])
        assert fleet.stats.evictions >= 1 and fleet.stats.loads >= 1
        assert fleet.stats.resident_models == 1
        _fleet_payloads_bitwise(fleet, got)
    finally:
        fleet.shutdown()


def test_fleet_server_shares_one_governor(trees):
    fleet = _port_fleet(trees)
    try:
        server = FleetScoringServer(fleet, _serve_cfg(ServeConfig))
        govs = {id(fleet.engine(m).governor) for m in MODELS}
        assert govs == {id(fleet.governor)}
        assert "weights" in fleet.governor.ledger()
        assert server.hbm_pressure == 0.0        # unbounded on the CPU
        assert server.resident_models() == list(MODELS)
        assert server.queue_depth == 0 and server.oldest_wait() == 0.0
    finally:
        fleet.shutdown()


def test_fleet_refuses_what_waits_for_later_items(trees):
    fleet = _port_fleet(trees)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A8d"):
            FleetScoringServer(fleet, tiers=types.SimpleNamespace(
                enabled=True))
        with pytest.raises(NotImplementedError, match="ROADMAP A8d"):
            ScoringServer(fleet.engine("m0"), "m0",
                          tiers=types.SimpleNamespace(enabled=True))
        server = FleetScoringServer(
            fleet, tiers=types.SimpleNamespace(enabled=False))
        with pytest.raises(NotImplementedError, match="Also open"):
            server.attach_observatory(object())
    finally:
        fleet.shutdown()


# ---------------------------------------------------------------------------
# The governor's serving rungs: batch_down and shed
# ---------------------------------------------------------------------------

def _at_level(gov, rungs, rung):
    """Hold ``gov`` with every rung through ``rung`` engaged: its ladder
    level set, its ticks stopped (so no dispatch moves it)."""
    gov._level = rungs.index(rung) + 1
    gov.tick = lambda: None


def _rung_run(engine, server_cls, serve_cls, req_cls, rungs, rung):
    _at_level(engine.governor, rungs, rung)
    server = server_cls(engine, "m0", _serve_cfg(serve_cls,
                                                 prefix_cache=False))
    sizes = []
    inner = server.batcher.score

    def score(bucket, rows):
        sizes.append(len(rows))
        return inner(bucket, rows)

    server.batcher.score = score
    futs = [server.submit(_req(req_cls, i)) for i in range(5)]
    server.start()
    try:
        res = [f.result(timeout=300) for f in futs]
    finally:
        server.stop()
    st_ = server.stats.summary()
    return sizes, res, {k: st_[k] for k in ("shed", "completed",
                                            "dispatches")}


@pytest.mark.parametrize("rung", ["batch_down", "shed"])
def test_serving_rungs_match_jax(trees, jax_fleet, rung):
    """``jax_fleet`` arms the JAX interpreter hooks for this test."""
    want = _rung_run(_jax_engine(trees, "m0"), JaxServer, JaxServeConfig,
                     JaxRequest, jhbm.RUNGS, rung)
    got = _rung_run(_port_engine(trees, "m0"), ScoringServer, ServeConfig,
                    ServeRequest, hbm.RUNGS, rung)
    assert got[0] == want[0] and got[2] == want[2]
    assert [r.status for r in got[1]] == [r.status for r in want[1]]
    if rung == "batch_down":
        assert got[0] == [2, 2, 1]          # batch 4 halved
        for g, w in zip(got[1], want[1]):
            assert g.model_response == w.model_response
            np.testing.assert_allclose(g.token_1_prob, w.token_1_prob,
                                       atol=FTOL, rtol=0)
    else:
        assert got[0] == [] and all(r.status == "shed" for r in got[1])
        assert all(r.note.startswith("memory pressure") for r in got[1])
