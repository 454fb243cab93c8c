"""The port's single-model serving (``lir_tpu_torch.serve``) on the CPU.

- ``ScoringServer`` payloads against the JAX package's cold unpaged
  output for the same requests (the JAX ``ScoringServer`` with its
  prefix cache off; interpreter hooks armed): every discrete field
  exact, floats within the parity bar, with the port's prefix cache off
  and on (a warm second pass through the page pool included).
- The breaker opens after ``max_consecutive_failures``, sheds, and a
  half-open probe closes it (the server's and breaker's clock injected).
- The degradation ladder isolates a poison row; NaN payloads are
  quarantined; an out-of-memory dispatch is reclaimed and retried once,
  a second one errors its rows without moving the breaker.
- A shutdown checkpoint resumes to the same results, and the live ring
  folds each row once (its summary equals the JAX ``ServeStreamSink``'s
  on the same resolved stream).
- An injected hang is stalled by the watchdog and the request served
  (the assertions of the JAX package's own serve watchdog test).

The ``serve`` command's JSONL round trip is in ``tests/test_torch_cli.py``.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.config import ServeConfig as JaxServeConfig
from lir_tpu.engine import stream_stats as jstream
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models import decoder as jdec
from lir_tpu.serve import ScoringServer as JaxServer
from lir_tpu.serve import ServeRequest as JaxRequest
from lir_tpu_torch import faults
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RetryConfig, RuntimeConfig, ServeConfig
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig
from lir_tpu_torch.serve import ScoringServer, ServeRequest

from test_torch_guard import CFG, _tree
from test_torch_sweep import FTOL

RT = dict(batch_size=4, max_seq_len=128)
N_REQ = 12
FAST_RETRY = RetryConfig(max_retries=1, initial_delay=0.001,
                         max_delay=0.002, full_jitter=True, max_elapsed=5.0)


def _bodies():
    rng = np.random.default_rng(6)
    words = "clause covers hail damage under policy flood claim".split()
    return [" ".join(rng.choice(words) for _ in range(6 + i % 5))
            for i in range(N_REQ)]


BODIES = _bodies()


def _req(cls, i, rid=None):
    body = BODIES[i % N_REQ]
    return cls(binary_prompt=f"{body} Answer Yes or No .",
               confidence_prompt=f"{body} Number 0 to 100 .",
               klass="t", request_id=rid or str(i))


def _cfg(cls, **kw):
    base = dict(queue_depth=64, classes=(("t", 600.0),), default_class="t",
                linger_s=0.0, cache_entries=0)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def jax_payloads():
    """The JAX server's results for the N_REQ requests, prefix cache off
    (the cold unpaged engine output)."""
    old = (jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU)
    jdec.CASCADE_INTERPRET_ON_CPU = True
    jdec.FUSED_DECODE_INTERPRET_ON_CPU = True
    cfg_j, tree = _tree()
    jeng = JaxEngine(jax.tree.map(jnp.asarray, tree), cfg_j,
                     JaxFakeTokenizer(),
                     JaxRuntimeConfig(aot_precompile=False, spec_decode=False,
                                      **RT))
    server = JaxServer(jeng, "g", _cfg(JaxServeConfig, prefix_cache=False))
    futs = [server.submit(_req(JaxRequest, i)) for i in range(N_REQ)]
    server.start()
    try:
        results = [f.result(timeout=300) for f in futs]
    finally:
        server.stop()
    yield tree, results
    jdec.CASCADE_INTERPRET_ON_CPU, jdec.FUSED_DECODE_INTERPRET_ON_CPU = old


def _engine(tree, **rt):
    cfg = ModelConfig(**CFG)
    return ScoringEngine(params_from_jax(tree, cfg, device="cpu"), cfg,
                         FakeTokenizer(), RuntimeConfig(**{**RT, **rt}),
                         device="cpu")


def _serve(server, reqs):
    futs = [server.submit(r) for r in reqs]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


def _compare(want, got):
    assert want.request_id == got.request_id
    assert want.status == got.status == "ok"
    for f in ("model_response", "model_confidence_response",
              "confidence_value"):
        assert getattr(want, f) == getattr(got, f), f
    for f in ("token_1_prob", "token_2_prob"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=FTOL, rtol=0)
    np.testing.assert_allclose(got.weighted_confidence,
                               want.weighted_confidence, rtol=FTOL)
    la, lb = (json.loads(want.log_probabilities),
              json.loads(got.log_probabilities))
    np.testing.assert_allclose(list(lb.values()), list(la.values()),
                               atol=FTOL)


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["unpaged", "prefix-cache"])
def test_served_payloads_match_jax_cold_unpaged(jax_payloads, prefix_cache):
    tree, want = jax_payloads
    eng = _engine(tree)
    server = ScoringServer(eng, "g", _cfg(ServeConfig,
                                          prefix_cache=prefix_cache))
    got = _serve(server, [_req(ServeRequest, i) for i in range(N_REQ)])
    for w, g in zip(want, got):
        _compare(w, g)
    assert server.stats.dispatches == N_REQ // RT["batch_size"]
    if prefix_cache:
        # A second pass on the same server: the rows resume their
        # prefixes from the page pool.
        server = ScoringServer(eng, "g", _cfg(ServeConfig))
        again = _serve(server, [_req(ServeRequest, i, f"w{i}")
                                for i in range(N_REQ)])
        assert eng.paged_dispatches
        for w, g in zip(want, again):
            g.request_id = w.request_id
            _compare(w, g)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_breaker_opens_sheds_and_a_probe_closes_it(jax_payloads):
    clock = _Clock()
    server = ScoringServer(
        _engine(jax_payloads[0]), "g",
        _cfg(ServeConfig, prefix_cache=False, degrade_ladder=False,
             max_consecutive_failures=2, breaker_cooldown_s=5.0,
             retry=FAST_RETRY), clock=clock)
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.outage(0, 4)})
    faults.wrap_server(server, plan)
    server.start()
    try:
        first = server.submit(_req(ServeRequest, 0)).result(timeout=60)
        assert first.status == "error" and server.healthy
        second = server.submit(_req(ServeRequest, 1)).result(timeout=60)
        assert second.status == "error"
        # The rows resolve before the supervisor tells the breaker and
        # drains the queue: wait for the dispatch to end.
        _until(lambda: not server.healthy and not server._inflight)
        shed = server.submit(_req(ServeRequest, 2)).result(timeout=5)
        assert shed.status == "shed" and "unhealthy" in shed.note
        clock.t += 5.0                        # cooldown -> half-open
        probe = server.submit(_req(ServeRequest, 3)).result(timeout=60)
        assert probe.status == "ok" and server.healthy
    finally:
        server.stop()
    assert server.faults.transitions == [("closed", "open"),
                                         ("open", "half_open"),
                                         ("half_open", "closed")]
    assert plan.stats.injected == {"dispatch": 4}


def _until(cond, timeout=60.0):
    """Wait for the supervisor thread to reach a state (no bar on the
    time it takes)."""
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "the server never got there"
        time.sleep(0.005)


def test_ladder_isolates_poison_and_nan_rows_are_quarantined(jax_payloads):
    server = ScoringServer(_engine(jax_payloads[0]), "g",
                           _cfg(ServeConfig, prefix_cache=False,
                                retry=FAST_RETRY))
    real = server.batcher.score

    def poisoned(bucket, rows):
        if any(p.request.request_id == "poison" for p in rows):
            raise RuntimeError("poison row crash")
        return real(bucket, rows)

    server.batcher.score = poisoned
    # Score calls: 0 and 1 the batch and its retry (poisoned), 2 the
    # ladder's full retry, 3 its half holding rows 0-1 (NaN into row 1).
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.nan_at(
        3, rows=(1,))})
    faults.wrap_server(server, plan)
    reqs = [_req(ServeRequest, i) for i in range(3)]
    reqs.append(_req(ServeRequest, 7, "poison"))
    got = _serve(server, reqs)
    assert [r.status for r in got] == ["ok", "error", "ok", "error"]
    assert "numerics" in got[1].note
    assert "degradation ladder" in got[3].note
    assert server.faults.degraded_rows == 1
    assert server.engine.guard_stats.quarantined == {"serve": 1}
    assert server.healthy


def test_oom_is_reclaimed_then_a_second_one_errors_its_rows(jax_payloads):
    import torch

    from lir_tpu_torch.config import GovernorConfig

    eng = ScoringEngine(
        params_from_jax(jax_payloads[0], ModelConfig(**CFG), device="cpu"),
        ModelConfig(**CFG), FakeTokenizer(), RuntimeConfig(**RT),
        device="cpu", governor_config=GovernorConfig(sustain_ticks=1))
    eng.governor.set_action("evict_weights", engage=lambda: True)
    server = ScoringServer(eng, "g", _cfg(ServeConfig, prefix_cache=False,
                                          retry=FAST_RETRY))
    real = server.batcher.score
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    # Score calls: an OOM and its retry; three clean dispatches (their
    # ticks release the three reclaim rungs); an OOM, reclaimed, whose
    # one retry OOMs again.
    errors = [oom, None, None, None, None, oom, oom]

    def score(bucket, rows):
        err = errors.pop(0) if errors else None
        if err is not None:
            raise err
        return real(bucket, rows)

    server.batcher.score = score
    server.start()
    try:
        ok = server.submit(_req(ServeRequest, 0)).result(timeout=60)
        for i in range(1, 4):
            assert server.submit(_req(ServeRequest, i)).result(60).status \
                == "ok"
        assert eng.governor.level == 0
        bad = server.submit(_req(ServeRequest, 5)).result(timeout=60)
    finally:
        server.stop()
    assert ok.status == "ok"
    assert bad.status == "error" and "survived governor reclaim" in bad.note
    st = eng.governor.stats
    assert st.oom_events == {"serve": 2} and st.oom_reclaims == 2
    assert st.oom_exhausted == 1
    assert server.faults.recovered_dispatches == 1
    assert server.breaker.consecutive_failures == 0 and server.healthy


def test_checkpoint_resume_and_the_ring_folds_once(jax_payloads, tmp_path):
    tree = jax_payloads[0]
    ckpt = tmp_path / "state.json"
    first = ScoringServer(_engine(tree), "g",
                          _cfg(ServeConfig, prefix_cache=False))
    done = _serve(first, [_req(ServeRequest, i) for i in range(4)])
    futs = [first.submit(_req(ServeRequest, i)) for i in range(4, 9)]
    assert first.shutdown_checkpoint(ckpt) == 5
    assert not any(f.done() for f in futs)
    fresh = ScoringServer(_engine(tree), "g",
                          _cfg(ServeConfig, prefix_cache=False))
    fresh.start()
    try:
        resumed = [f.result(timeout=60)
                   for f in fresh.resume_from_checkpoint(ckpt)]
        # A row the first server already folded is not folded again.
        repeat = fresh.submit(_req(ServeRequest, 0, "again")).result(60)
    finally:
        fresh.stop()
    assert [r.request_id for r in resumed] == [str(i) for i in range(4, 9)]
    assert all(r.status == "ok" for r in done + resumed + [repeat])
    clean = ScoringServer(_engine(tree), "g",
                          _cfg(ServeConfig, prefix_cache=False))
    ref = _serve(clean, [_req(ServeRequest, i) for i in range(4, 9)])
    for a, b in zip(ref, resumed):
        assert (a.token_1_prob, a.model_response, a.log_probabilities) == \
            (b.token_1_prob, b.model_response, b.log_probabilities)
    summary = fresh.stream_summary()
    assert summary["rows_folded"] == 9
    sink = jstream.ServeStreamSink(window=ServeConfig().stream_window)
    for r, i in zip(done + resumed + [repeat], list(range(9)) + [0]):
        sink.fold_payload(_key(fresh, i), ("Yes", "No"), dict(
            token_1_prob=r.token_1_prob, token_2_prob=r.token_2_prob,
            weighted_confidence=r.weighted_confidence))
    assert sink.summary() == summary


def _key(server, i):
    from lir_tpu_torch.serve import content_key

    return content_key(server._engine_key, _req(ServeRequest, i))


def test_serve_watchdog_stalls_a_hang_and_serves(jax_payloads):
    from lir_tpu_torch.engine import scheduler as sched

    eng = _engine(jax_payloads[0], watchdog_multiple=1.0,
                  watchdog_floor_s=0.05)
    server = ScoringServer(eng, "g", _cfg(ServeConfig, prefix_cache=False))
    server.start()
    try:
        # Clean dispatches calibrate the watchdog past its cold first
        # sample (inflated by the seed headroom); the hang then lasts
        # three times the largest deadline of a one-row dispatch, and at
        # least 0.5 s.
        for i in range(N_REQ):
            assert server.submit(_req(ServeRequest, i)).result(60).status \
                == "ok"
        hang_s = max(0.5, 3 * max(eng.watchdog.deadline_for(
            sched.bucket_cost(1, b, RT["batch_size"],
                              server.batcher.decode_cost))
            for b in eng.buckets))
        stalls0 = eng.guard_stats.stalls.get("serve", 0)
        plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.hang_at(
            0, seconds=hang_s)})
        faults.wrap_server(server, plan)     # between dispatches
        r = server.submit(_req(ServeRequest, 0, "hung")).result(timeout=60)
    finally:
        server.stop()
    assert r.status == "ok"
    assert eng.guard_stats.stalls.get("serve", 0) - stalls0 >= 1
    assert server.faults.recovered_dispatches >= 1
    assert server.healthy


@pytest.mark.parametrize("grace_s", [60.0, 0.05],
                         ids=["waited-out", "poisoned"])
def test_a_slow_dispatch_past_its_deadline_never_runs_beside_its_retry(
        jax_payloads, grace_s):
    """The serving default (prefix cache on): a real dispatch that passes
    its deadline keeps running on its abandoned worker, inserting pages
    and recording drafts. The retry waits for it (never two dispatches
    in the engine at once) and serves JAX's payload under the parity
    bar; with a short grace the engine is poisoned: the request errors,
    the breaker opens at once, and once the slow call has left a probe
    closes it."""
    import threading

    from lir_tpu_torch.engine import scheduler as sched

    eng = _engine(jax_payloads[0], watchdog_multiple=1.0,
                  watchdog_floor_s=0.05)
    server = ScoringServer(eng, "g", _cfg(ServeConfig, retry=FAST_RETRY,
                                          breaker_cooldown_s=0.0))
    assert server.batcher.prefix_cache
    inner = server.batcher.score
    lock = threading.Lock()
    box = {"n": 0, "inside": 0, "most": 0, "slow": None}
    left = threading.Event()

    def score(bucket, rows):
        with lock:
            k = box["n"]
            box["n"] += 1
            box["inside"] += 1
            box["most"] = max(box["most"], box["inside"])
        try:
            if k == box["slow"]:
                time.sleep(slow_s)
            return inner(bucket, rows)
        finally:
            with lock:
                box["inside"] -= 1
            if k == box["slow"]:
                left.set()

    server.batcher.score = score
    server.start()
    try:
        for i in range(N_REQ):
            assert server.submit(_req(ServeRequest, i)).result(60).status \
                == "ok"
        slow_s = max(0.5, 3 * max(eng.watchdog.deadline_for(
            sched.bucket_cost(1, b, RT["batch_size"],
                              server.batcher.decode_cost))
            for b in eng.buckets))
        eng.watchdog.grace_s = grace_s
        box["slow"] = box["n"]
        r = server.submit(_req(ServeRequest, 0)).result(timeout=60)
        if grace_s < slow_s:
            assert r.status == "error" and "poisoned" in r.note
            assert not server.healthy
            assert left.wait(60)
            probe = server.submit(_req(ServeRequest, 1)).result(timeout=60)
            _compare(jax_payloads[1][1], probe)
            assert server.healthy
            assert [f"{a}->{b}" for a, b in server.faults.transitions] == [
                "closed->open", "open->half_open", "half_open->closed"]
        else:
            _compare(jax_payloads[1][0], r)
            assert eng.guard_stats.poisoned == 0 and server.healthy
    finally:
        server.stop()
    assert eng.guard_stats.stalls.get("serve", 0) >= 1
    assert box["most"] == 1
