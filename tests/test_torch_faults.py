"""The port's guard, fault and serve host machinery against the JAX
package's, on the same inputs (no model: milliseconds a test).

- ``watch_call``: results, exceptions and BaseExceptions propagate; the
  deadline raises ``DispatchStalled``; the worker runs under the
  caller's inference mode; a kernel build during the call neither
  trips the deadline nor calibrates.
- ``DispatchWatchdog``: observe-only until calibrated, then enforcing;
  off with a non-positive multiple; stalls counted per site; the same
  ``deadline_for`` as JAX's after the same observations, and the same
  ``watchdog_seed_headroom``.
- ``FaultPlan``: the same seed and schedules fire the same kinds at the
  same calls of each site as JAX's (``check``, ``wrap``,
  ``corrupt_draft``, ``wrap_governor``, ``wrap_replica``: a replica
  kill marks the router's replica dead and raises, a lag sleeps and
  completes); a tier schedule is refused (ROADMAP A8d);
  ``corrupt_result_nan`` gives JAX's values.
- ``CircuitBreaker``, ``degrade_dispatch`` and the retry loop make
  JAX's transitions, calls and waits under the same clock and draws.
- ``RequestQueue``, ``ResultCache`` / ``content_key``,
  ``ContinuousBatcher.next_dispatch`` and ``ServeStreamSink`` make
  JAX's decisions and summaries on the same arrival trace and clock.
"""

import dataclasses
import random
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lir_tpu import faults as jfaults
from lir_tpu.config import RetryConfig as JaxRetryConfig
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.engine import generate as jgen
from lir_tpu.engine import scheduler as jsched
from lir_tpu.engine import stream_stats as jstream
from lir_tpu.guard import watchdog as jwatchdog
from lir_tpu.serve import batcher as jbatcher
from lir_tpu.serve import cache as jcache
from lir_tpu.serve import queue as jqueue
from lir_tpu.utils import retry as jretry
from lir_tpu.utils.profiling import ServeStats as JaxServeStats
from lir_tpu_torch import faults
from lir_tpu_torch.config import RetryConfig, RuntimeConfig
from lir_tpu_torch.engine import generate
from lir_tpu_torch.engine import scheduler as sched
from lir_tpu_torch.engine import stream_stats
from lir_tpu_torch.guard import watchdog
from lir_tpu_torch.ops import _build
from lir_tpu_torch.serve import batcher, cache, queue
from lir_tpu_torch.utils import retry
from lir_tpu_torch.utils.profiling import ServeStats


# ---------------------------------------------------------------------------
# watch_call and the watchdog
# ---------------------------------------------------------------------------

def test_watch_call_results_exceptions_and_deadline():
    ticks = []
    assert watchdog.watch_call(lambda: 7, 5.0, on_tick=lambda: ticks.append(1),
                               tick_s=0.01) == 7
    with pytest.raises(ValueError, match="boom"):
        watchdog.watch_call(lambda: (_ for _ in ()).throw(ValueError("boom")),
                            5.0)

    def preempt():
        raise faults.InjectedPreemption("kill")

    with pytest.raises(faults.InjectedPreemption):
        watchdog.watch_call(preempt, 5.0)
    seen = []
    with pytest.raises(watchdog.DispatchStalled):
        watchdog.watch_call(lambda: time.sleep(0.5), 0.05, tick_s=0.01,
                            stalled=lambda d, e: seen.append((d, e)))
    assert seen and seen[0][0] == 0.05 and seen[0][1] >= 0.05
    assert "test_watch_call" in watchdog.dump_thread_stacks()


def test_watch_call_carries_the_callers_inference_mode():
    def modes():
        return torch.is_inference_mode_enabled(), torch.is_grad_enabled()

    with torch.inference_mode():
        assert watchdog.watch_call(modes, 5.0) == (True, False)
    with torch.no_grad():
        assert watchdog.watch_call(modes, 5.0) == (False, False)
    assert watchdog.watch_call(modes, 5.0) == (False, True)


def _fake_build(seconds):
    """What ``_build.build`` does around a compile round, for ``seconds``."""
    me = threading.get_ident()
    with _build._BUILD_LOCK:
        _build._BUILD_ACTIVE[me] = time.monotonic()
    time.sleep(seconds)
    with _build._BUILD_LOCK:
        _build._BUILD_DONE_S += time.monotonic() - _build._BUILD_ACTIVE.pop(me)


def test_a_kernel_build_neither_trips_nor_calibrates_the_watchdog():
    wd = watchdog.DispatchWatchdog(multiple=1.0, floor_s=0.05,
                                   seed_headroom=1.0, tick_s=0.01)
    wd.watch(lambda: _fake_build(0.3), cost=1.0, site="sweep")
    assert not wd.calibrated                 # a build does not calibrate
    wd.watch(lambda: time.sleep(0.01), cost=1.0, site="sweep")
    assert wd.calibrated
    assert wd.deadline_for(1.0) < 0.3
    # Enforcing now: a 0.3 s build inside a dispatch is not its time.
    wd.watch(lambda: _fake_build(0.3), cost=1.0, site="sweep")
    assert wd.stats.stalls == {}
    with pytest.raises(watchdog.DispatchStalled):
        wd.watch(lambda: time.sleep(0.5), cost=1.0, site="sweep")
    assert wd.stats.stalls == {"sweep": 1}


def test_watchdog_calibration_deadlines_and_counters_match_jax():
    assert watchdog.DispatchWatchdog(multiple=0.0).enabled is False
    off = watchdog.DispatchWatchdog(multiple=0.0)
    assert off.watch(lambda: 3) == 3 and off.stats.watched == {}
    for spec in (False, True):
        for casc in (False, True):
            assert sched.watchdog_seed_headroom(spec, casc) == \
                jsched.watchdog_seed_headroom(spec, casc)
    port = watchdog.DispatchWatchdog(multiple=4.0, floor_s=0.05,
                                     seed_headroom=6.0)
    ref = jwatchdog.DispatchWatchdog(multiple=4.0, floor_s=0.05,
                                     seed_headroom=6.0)
    assert port.deadline_for(10.0) is None and ref.deadline_for(10.0) is None
    for cost, elapsed in ((12.0, 0.2), (None, 0.3), (40.0, 0.05),
                          (0.5, 0.01), (7.0, 1.5)):
        port.observe(cost, elapsed)
        ref.observe(cost, elapsed)
        for probe in (None, 0.2, 1.0, 33.0):
            assert port.deadline_for(probe) == ref.deadline_for(probe)
    # Observe-only until calibrated, enforcing after; stalls per site.
    # Each stalled sleeper holds the engine's dispatch lock until it
    # wakes; the grace lets the next watch wait it out (not poisoned).
    wd = watchdog.DispatchWatchdog(multiple=1.0, floor_s=0.05,
                                   seed_headroom=1.0, tick_s=0.01,
                                   grace_s=5.0)
    assert wd.watch(lambda: time.sleep(0.02) or 1, cost=1.0,
                    site="serve") == 1
    assert wd.stats.watched == {}            # inline, observe-only
    for site in ("serve", "serve", "sweep"):
        with pytest.raises(watchdog.DispatchStalled):
            wd.watch(lambda: time.sleep(0.5), cost=1.0, site=site)
    assert wd.stats.stalls == {"serve": 2, "sweep": 1}
    assert wd.stats.stall_dumps == 3
    assert wd.stats.watched == {"serve": 2, "sweep": 1}
    deadline, fired = wd.last_stall
    assert deadline <= fired < deadline + 0.4
    assert wd.stats.poisoned == 0


def test_an_abandoned_call_in_the_engine_poisons_and_a_hang_does_not():
    """A slow call past its deadline holds the dispatch lock: the next
    watch waits one grace for it and, with the call still inside, raises
    EnginePoisoned without running; once the call has left, watches run
    again. The injected hang wakes when abandoned, so it never holds the
    engine past its deadline."""
    wd = watchdog.DispatchWatchdog(multiple=1.0, floor_s=0.05,
                                   seed_headroom=1.0, tick_s=0.01,
                                   grace_s=0.05)
    wd.observe(1.0, 0.01)                    # calibrated
    left = threading.Event()

    def slow():
        time.sleep(1.0)
        left.set()

    with pytest.raises(watchdog.DispatchStalled):
        wd.watch(slow, cost=1.0, site="sweep")
    ran = []
    with pytest.raises(watchdog.EnginePoisoned):
        wd.watch(lambda: ran.append(1), cost=1.0, site="sweep")
    with pytest.raises(watchdog.EnginePoisoned):
        with wd.exclusive():
            ran.append(2)
    assert ran == [] and wd.stats.poisoned == 2 and not left.is_set()
    assert left.wait(10.0)
    wd.settle()
    assert wd.watch(lambda: 7, cost=1.0, site="sweep") == 7
    # An injected hang of 30 s: abandoned at the deadline, it releases
    # the lock at once and the next watch settles within the grace.
    plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.hang_at(
        0, seconds=30.0)})
    with pytest.raises(watchdog.DispatchStalled):
        wd.watch(lambda: plan.check("dispatch"), cost=1.0, site="sweep")
    assert wd.watch(lambda: 8, cost=1.0, site="sweep") == 8
    assert wd.stats.poisoned == 2 and wd.stats.stalls == {"sweep": 2}


class _DeviceWork:
    """An event stand-in: device work that ends ``seconds`` after its
    first wait (or is done already)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def query(self):
        return self.seconds == 0.0

    def synchronize(self):
        time.sleep(self.seconds)


def test_watch_device_counts_the_deadline_from_the_dispatch_start():
    wd = watchdog.DispatchWatchdog(multiple=1.0, floor_s=0.05,
                                   seed_headroom=1.0, tick_s=0.01)
    built = _build.build_seconds()
    # A call that only enqueues never calibrates; the device wait does,
    # on the dispatch's start-to-finish seconds.
    wd.watch(lambda: None, cost=1.0, site="sweep", calibrate=False)
    assert not wd.calibrated
    wd.watch_device(_DeviceWork(0.02), time.monotonic() - 0.1, built, 1.0,
                    site="sweep")
    assert wd.calibrated and 0.12 <= wd.deadline_for(1.0) - 0.05
    # Started a deadline ago and still running: a stall at once.
    with pytest.raises(watchdog.DispatchStalled):
        wd.watch_device(_DeviceWork(0.5),
                        time.monotonic() - wd.deadline_for(1.0), built, 1.0,
                        site="sweep")
    assert wd.stats.stalls == {"sweep": 1} and wd.stats.watched == {}
    # Finished work never stalls, however late the wait comes.
    wd.watch_device(_DeviceWork(0.0), time.monotonic() - 60.0, built, 1.0,
                    site="sweep")
    assert wd.stats.stalls == {"sweep": 1}


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("dispatch", dict(fail_calls=(1, 4))),
    ("dispatch", dict(rate=0.3)),
    ("dispatch", dict(rate=0.5, max_failures=3)),
    ("manifest_write", dict(fail_calls=(2,), kind="preempt")),
    ("tokenize", dict(fail_calls=(0, 3), rate=0.2, max_failures=2)),
]


def _outcomes(plan, site, fault_cls, preempt_cls, n=20):
    out = []
    for _ in range(n):
        try:
            plan.check(site)
            out.append("ok")
        except preempt_cls:
            out.append("preempt")
        except fault_cls as err:
            out.append(f"fault:{err}")
    return out


@pytest.mark.parametrize("site,kw", SCHEDULES,
                         ids=[f"{s}-{i}" for i, (s, _) in
                              enumerate(SCHEDULES)])
def test_fault_plan_fires_where_jax_fires(site, kw):
    for seed in (0, 7):
        port = faults.FaultPlan(seed, {site: faults.SiteSchedule(**kw)})
        ref = jfaults.FaultPlan(seed, {site: jfaults.SiteSchedule(**kw)})
        got = _outcomes(port, site, faults.InjectedFault,
                        faults.InjectedPreemption)
        want = _outcomes(ref, site, jfaults.InjectedFault,
                         jfaults.InjectedPreemption)
        assert got == want
        assert port.stats.summary() == ref.stats.summary()
        assert port.calls(site) == ref.calls(site) == 20


def test_fault_plan_wrap_nan_squeeze_and_refusals():
    payloads = [dict(token_1_prob=0.3, token_2_prob=0.6,
                     weighted_confidence=40.0, log_probabilities="{}")
                for _ in range(3)]
    sched_kw = dict(fail_calls=(1,), kind="nan", nan_rows=(0, 2))
    port = faults.FaultPlan(3, {"dispatch": faults.SiteSchedule(**sched_kw)})
    ref = jfaults.FaultPlan(3, {"dispatch": jfaults.SiteSchedule(**sched_kw)})
    pw = port.wrap("dispatch", lambda: list(payloads))
    rw = ref.wrap("dispatch", lambda: list(payloads))
    for _ in range(3):
        a, b = pw(), rw()
        assert [np.isnan(p["token_1_prob"]) for p in a] == \
            [np.isnan(p["token_1_prob"]) for p in b]
    assert port.stats.summary() == ref.stats.summary()

    class Gov:
        def __init__(self):
            self.calls = []

        def tick(self):
            self.calls.append("tick")

        def squeeze(self, frac, calls=8):
            self.calls.append(("squeeze", frac, calls))

    gp, gr = Gov(), Gov()
    squeeze = dict(fail_calls=(2,), kind="hbm_squeeze", squeeze_frac=0.25,
                   squeeze_calls=3)
    faults.wrap_governor(gp, faults.FaultPlan(
        0, {"hbm": faults.SiteSchedule(**squeeze)}))
    jfaults.wrap_governor(gr, jfaults.FaultPlan(
        0, {"hbm": jfaults.SiteSchedule(**squeeze)}))
    for _ in range(5):
        gp.tick()
        gr.tick()
    assert gp.calls == gr.calls
    assert ("squeeze", 0.25, 3) in gp.calls
    for site, kind in (("tiers", "fault"), ("dispatch", "tier_corrupt"),
                       ("tiers", "disk_stall")):
        with pytest.raises(ValueError, match="A8d"):
            faults.FaultPlan(0, {site: faults.SiteSchedule(kind=kind)})
    for site, kind in (("replica", "fault"), ("dispatch", "replica_kill"),
                       ("replica", "replica_lag"), ("migrate", "fault"),
                       ("migrate", "migration_stall"),
                       ("migrate", "migration_corrupt")):
        faults.FaultPlan(0, {site: faults.SiteSchedule(kind=kind)})
    assert faults.SITES == jfaults.SITES and faults.KINDS == jfaults.KINDS


class _FakeRouter:
    """A router with one replica whose batcher's score returns payloads;
    ``kill_replica`` is recorded."""

    def __init__(self, log):
        self.log = log
        batcher = type("B", (), {})()
        batcher.score = lambda bucket, rows: [
            dict(token_1_prob=0.3, token_2_prob=0.6,
                 weighted_confidence=40.0) for _ in rows]
        server = type("S", (), {})()
        server.batcher = batcher
        self._handle = type("H", (), {})()
        self._handle.server = server

    def handle(self, replica_id):
        return self._handle

    def kill_replica(self, replica_id):
        self.log.append(f"kill:{replica_id}")
        return 0


def _replica_outcomes(mod, sched_kw, n=12):
    log = []
    router = _FakeRouter(log)
    plan = mod.FaultPlan(5, {"replica": mod.SiteSchedule(**sched_kw)})
    mod.wrap_replica(router, "r0", plan)
    score = router.handle("r0").server.batcher.score
    for _ in range(n):
        try:
            out = score(64, [0, 1, 2])
            log.append("nan" if any(np.isnan(p["token_1_prob"])
                                    for p in out) else "ok")
        except mod.InjectedReplicaKill as err:
            log.append(f"killed:{err.replica_id}")
        except mod.InjectedFault as err:
            log.append(f"fault:{err}")
    return log, plan.stats.summary(), plan.calls("replica")


REPLICA_SCHEDULES = [
    dict(fail_calls=(3,), kind="replica_kill"),
    dict(fail_calls=(1, 4), kind="replica_lag", lag_s=0.01),
    dict(fail_calls=(2,), kind="nan", nan_rows=(1,)),
    dict(fail_calls=(0, 1, 2)),
    dict(rate=0.4, max_failures=3, kind="replica_kill"),
]


@pytest.mark.parametrize("sched_kw", REPLICA_SCHEDULES,
                         ids=["kill", "lag", "nan", "outage", "kill-rate"])
def test_wrap_replica_fires_where_jax_fires(sched_kw):
    """One seeded replica schedule through ``wrap_replica`` in both
    packages: the same calls kill (the router's ``kill_replica`` first,
    then InjectedReplicaKill), lag then complete, corrupt or fault."""
    got = _replica_outcomes(faults, sched_kw)
    want = _replica_outcomes(jfaults, sched_kw)
    assert got == want
    assert got[2] == 12


def test_replica_kinds_through_check_and_wrap_match_jax():
    for kind, extra in (("replica_kill", dict(replica_id="r1")),
                        ("replica_lag", dict(lag_s=0.01))):
        outs = []
        for mod in (faults, jfaults):
            plan = mod.FaultPlan(0, {"replica": mod.SiteSchedule(
                fail_calls=(1,), kind=kind, **extra)})
            wrapped = plan.wrap("replica", lambda: "done")
            seen = []
            for _ in range(3):
                try:
                    seen.append(wrapped())
                except mod.InjectedReplicaKill as err:
                    seen.append(f"killed:{err.replica_id}:{err}")
            plan2 = mod.FaultPlan(0, {"replica": mod.SiteSchedule(
                fail_calls=(0,), kind=kind, **extra)})
            try:
                plan2.check("replica")
                seen.append("check:ok")
            except mod.InjectedReplicaKill as err:
                seen.append(f"check:killed:{err.replica_id}")
            outs.append((seen, plan.stats.summary(), plan2.stats.summary()))
        assert outs[0] == outs[1]
    assert (faults.SiteSchedule.replica_kill_at(2, "r0") ==
            faults.SiteSchedule(fail_calls=(2,), kind="replica_kill",
                                replica_id="r0"))
    assert faults.SiteSchedule.replica_lag_at(1, 0.5).lag_s == 0.5


def _migrator_outcomes(mod, mig_mod, sched_kw, chunk):
    """Four transfers of one export through a migrator wrapped with
    ``sched_kw`` at site "migrate": what each returned or raised, the
    chunk's bytes after each, the plan's counters; then what
    ``FaultPlan.check`` does with the same schedule."""
    migrator = types.SimpleNamespace(transfer=lambda e: e)
    plan = mod.FaultPlan(9, {"migrate": mod.SiteSchedule(**sched_kw)})
    mod.wrap_migrator(migrator, plan)
    export = mig_mod.PageExport(
        bucket=64, ids=(), start_tokens=0, page_size=4, n_pages=2,
        chunk_pages=2, chunks=[(chunk, 2)], checksums=[0], nbytes=0)
    seen = []
    for _ in range(4):
        try:
            out = migrator.transfer(export)
            seen.append(("ok", out is export))
        except mod.InjectedFault as err:
            seen.append(("raised", type(err).__name__, str(err)))
        leaves = chunk if isinstance(chunk, tuple) else (chunk,)
        seen.append([bytes(np.asarray(a).view(np.uint8).reshape(-1))
                     if not isinstance(a, torch.Tensor) else
                     bytes(a.reshape(-1).view(torch.uint8).numpy())
                     for a in leaves])
    check = mod.FaultPlan(9, {"migrate": mod.SiteSchedule(**sched_kw)})
    for _ in range(3):
        try:
            check.check("migrate")
            seen.append("check:ok")
        except mod.InjectedFault as err:
            seen.append(f"check:{err}")
    return seen, plan.stats.summary(), plan.injected("migrate"), \
        check.stats.summary()


@pytest.mark.parametrize("sched_kw", [
    dict(fail_calls=(1,), kind="migration_stall", hang_s=0.0),
    dict(fail_calls=(0, 2), kind="migration_corrupt"),
    dict(fail_calls=(1,), kind="fault"),
    dict(rate=0.5, kind="migration_corrupt"),
], ids=["stall", "corrupt", "fault", "corrupt-rate"])
def test_wrap_migrator_fires_where_jax_fires(sched_kw):
    """One seeded schedule at the migrator's wire hop in both packages:
    the same transfers stall (raise), corrupt the same bytes, or fault;
    ``check`` leaves the migration kinds to the hop."""
    import lir_tpu.serve.migrate as jmig
    import lir_tpu_torch.serve.migrate as tmig

    rng = np.random.default_rng(12)
    payload = rng.integers(-127, 128, (2, 2, 2, 4, 8), dtype=np.int8)
    scales = rng.random((2, 2, 2, 4), dtype=np.float32)
    got = _migrator_outcomes(faults, tmig, sched_kw, (
        torch.from_numpy(payload.copy()), torch.from_numpy(scales.copy())))
    want = _migrator_outcomes(jfaults, jmig, sched_kw,
                              (payload.copy(), scales.copy()))
    assert got == want
    assert faults.SiteSchedule.migration_stall_at(3, 0.5) == \
        faults.SiteSchedule(fail_calls=(3,), kind="migration_stall",
                            hang_s=0.5)
    assert faults.SiteSchedule.migration_corrupt_at(1).kind == \
        jfaults.SiteSchedule.migration_corrupt_at(1).kind


def test_corrupt_draft_matches_jax():
    rng = np.random.default_rng(4)
    for seed in (0, 11):
        base = [(rng.integers(0, 500, (4, 6)).astype(np.int32),
                 np.asarray([0, 3, 6, 1], np.int32)) for _ in range(2)]
        pa = [(t.copy(), l.copy()) for t, l in base]
        ra = [(t.copy(), l.copy()) for t, l in base]
        kw = dict(fail_calls=(0, 2), kind="draft_corrupt", nan_rows=(0, 2, 9))
        port = faults.FaultPlan(seed, {"draft": faults.SiteSchedule(**kw)})
        ref = jfaults.FaultPlan(seed, {"draft": jfaults.SiteSchedule(**kw)})
        for _ in range(3):
            assert port.corrupt_draft(pa, 500) == ref.corrupt_draft(ra, 500)
        for (a, la), (b, lb) in zip(pa, ra):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
        assert any(not np.array_equal(a, t) for (a, _), (t, _) in
                   zip(pa, base))


def test_corrupt_result_nan_matches_jax():
    rng = np.random.default_rng(5)
    arrs = dict(generated=rng.integers(0, 9, (4, 3)).astype(np.int32),
                p_yes=rng.random((4, 3)).astype(np.float32),
                p_no=rng.random((4, 3)).astype(np.float32),
                top2_ids=rng.integers(0, 9, (4, 3, 2)).astype(np.int32),
                topk_logprobs=-rng.random((4, 20)).astype(np.float32),
                topk_ids=rng.integers(0, 99, (4, 20)).astype(np.int32),
                weighted_confidence=rng.random(4).astype(np.float32) * 100)
    port = generate.FusedDecodeOut(**{k: torch.from_numpy(v)
                                      for k, v in arrs.items()})
    ref = jgen.FusedDecodeOut(**{k: jnp.asarray(v) for k, v in arrs.items()})
    got = faults.corrupt_result_nan((port, port, 5), (1, 3, 7))
    want = jfaults.corrupt_result_nan((ref, ref, 5), (1, 3, 7))
    assert got[2] == want[2] == 5
    for g, w in zip(got[:2], want[:2]):
        for f in arrs:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
    assert torch.equal(port.p_yes, torch.from_numpy(arrs["p_yes"]))


# ---------------------------------------------------------------------------
# Breaker, ladder, retry
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_transitions_match_jax():
    script = ["f", "s", "f", "f", "f", "allow", "adv:0.5", "allow",
              "adv:1.0", "state", "f", "allow", "adv:1.5", "state", "s",
              "state", "f", "f", "f", "state", "adv:2.0", "s", "f"]
    runs = []
    for mod in (faults, jfaults):
        clock = _Clock()
        br = mod.CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                                clock=clock)
        trace = []
        for op in script:
            if op == "f":
                trace.append(br.record_failure())
            elif op == "s":
                br.record_success()
            elif op == "allow":
                trace.append(br.allow())
            elif op == "state":
                trace.append(br.state)
            else:
                clock.t += float(op.split(":")[1])
            trace.append(br.consecutive_failures)
        runs.append((trace, br.stats.summary()))
    assert runs[0] == runs[1]
    assert "half_open->closed" in runs[0][1]["breaker_transitions"]


def test_degrade_dispatch_calls_and_culprits_match_jax():
    for n, poison in ((8, {3}), (8, {0, 5, 6}), (5, set()), (7, {6}),
                      (1, {0})):
        runs = []
        for mod in (faults, jfaults):
            calls = []

            def score(rows):
                calls.append(tuple(rows))
                if poison & set(rows):
                    raise RuntimeError("poison")
                return [{"r": r} for r in rows]

            out = mod.degrade_dispatch(score, list(range(n)))
            runs.append((calls, out))
        assert runs[0] == runs[1]
        assert [o is None for o in runs[0][1]] == \
            [i in poison for i in range(n)]
    with pytest.raises(KeyboardInterrupt):
        faults.degrade_dispatch(
            lambda rows: (_ for _ in ()).throw(KeyboardInterrupt()), [1, 2])


@pytest.mark.parametrize("jitter", [True, False])
def test_retry_waits_replay_jax(jitter):
    cfg_kw = dict(max_retries=6, initial_delay=0.5, max_delay=3.0,
                  backoff_factor=2.0, full_jitter=jitter, max_elapsed=9.0)
    runs = []
    for run in ("port", "jax"):
        waits, clock = [], _Clock()
        attempts = {"n": 0}

        def flaky():
            attempts["n"] += 1
            if attempts["n"] < 6:
                raise OSError("transient")
            return "done"

        def sleep(s):
            waits.append(s)
            clock.t += s

        try:
            if run == "port":
                out = retry.retry_with_exponential_backoff(
                    flaky, config=RetryConfig(**cfg_kw), sleep=sleep,
                    log=lambda m: None, clock=clock,
                    rng=random.Random(17))
            else:
                random.seed(17)
                out = jretry.retry_with_exponential_backoff(
                    flaky, config=JaxRetryConfig(**cfg_kw), sleep=sleep,
                    log=lambda m: None, clock=clock)
        except OSError:
            out = "gave up"
        runs.append((out, waits, attempts["n"]))
    assert runs[0] == runs[1]
    with pytest.raises(SystemExit):
        retry.retry_with_exponential_backoff(
            lambda: (_ for _ in ()).throw(SystemExit()),
            retry_on=(BaseException,), sleep=lambda s: None)


# ---------------------------------------------------------------------------
# Serve host machinery
# ---------------------------------------------------------------------------

def _pend(mod, rid, deadline, t_submit=0.0, bucket=0, ids=(), lcp=0,
          hint=0):
    return mod.Pending(
        request=mod.ServeRequest(binary_prompt=f"b{rid}",
                                 confidence_prompt=f"c{rid}",
                                 request_id=rid),
        future=mod.ServeFuture(), t_submit=t_submit, t_deadline=deadline,
        bin_ids=tuple(ids), conf_ids=tuple(ids), lcp=lcp, bucket=bucket,
        cached_hint=hint)


def test_request_queue_admission_and_shedding_match_jax():
    rng = np.random.default_rng(8)
    deadlines = rng.uniform(1, 50, 40).round(3)
    runs = []
    for mod, stats in ((queue, ServeStats()), (jqueue, JaxServeStats())):
        q = mod.RequestQueue(6, stats, clock=lambda: 0.0)
        pend = [_pend(mod, str(i), d) for i, d in enumerate(deadlines)]
        admitted = [q.offer(p) for p in pend[:25]]
        drained = [p.request.request_id for p in q.drain()]
        admitted += [q.offer(p) for p in pend[25:]]
        flushed = q.flush(mod.STATUS_ERROR, "x")
        status = [p.future.result(0).status if p.future.done() else None
                  for p in pend]
        runs.append((admitted, drained, flushed, status,
                     {k: v for k, v in stats.summary().items()}))
    assert runs[0] == runs[1]


def test_result_cache_and_content_key_match_jax():
    reqs = [queue.ServeRequest(f"b{i % 5}", f"c{i % 5}",
                               targets=("Yes", "No") if i % 2 else
                               ("Covered", "Not"), request_id=str(i))
            for i in range(12)]
    jreqs = [jqueue.ServeRequest(r.binary_prompt, r.confidence_prompt,
                                 targets=r.targets, request_id=r.request_id)
             for r in reqs]
    assert [cache.content_key("ek", r) for r in reqs] == \
        [jcache.content_key("ek", r) for r in jreqs]
    runs = []
    for mod, stats, rs in ((cache, ServeStats(), reqs),
                           (jcache, JaxServeStats(), jreqs)):
        rc = mod.ResultCache(3, stats)
        hits = []
        for i, r in enumerate(rs):
            key = mod.content_key("ek", r)
            hits.append(rc.get(key))
            rc.put(key, {"v": i})
        runs.append((hits, len(rc), stats.summary()))
    assert runs[0] == runs[1]


class _StubEngine:
    """What the batcher reads of an engine: its ladder, runtime and the
    two trunk rules (a shared prefix snapped down to 16, from 32 on)."""

    def __init__(self, rt, buckets):
        self.rt = rt
        self.buckets = list(buckets)
        self.prefix_cache = None

    def spec_supported(self):
        return True

    @staticmethod
    def _trunk(prefix_ids, n, bucket):
        if n < 2:
            return 0
        k = 0
        while all(len(p) > k and p[k] == prefix_ids[0][k]
                  for p in prefix_ids):
            k += 1
        k -= k % 16
        return k if k >= 32 else 0

    cascade_trunk_for = _trunk
    decode_trunk_for = _trunk


def test_batcher_decisions_match_jax_on_an_arrival_trace():
    buckets = [32, 48, 64, 96, 128]
    rng = np.random.default_rng(12)
    trace = []
    t = 0.0
    for i in range(90):
        t += float(rng.exponential(0.004))
        bucket = int(rng.choice(buckets))
        shared = rng.random() < 0.5
        ids = ([7] * 40 if shared else []) + \
            rng.integers(0, 99, bucket).tolist()
        trace.append((str(i), t, t + float(rng.uniform(0.002, 0.2)), bucket,
                      ids[:bucket], int(rng.integers(0, 20))))
    runs = []
    for mod, bmod, rt, stats in (
            (queue, batcher, RuntimeConfig(batch_size=4), ServeStats()),
            (jqueue, jbatcher, JaxRuntimeConfig(batch_size=4),
             JaxServeStats())):
        b = bmod.ContinuousBatcher(_StubEngine(rt, buckets), stats,
                                   linger_s=0.01, clock=lambda: 0.0)
        decisions, k = [], 0
        for step in np.arange(0.0, t + 0.3, 0.003):
            while k < len(trace) and trace[k][1] <= step:
                rid, ts, dl, bucket, ids, hint = trace[k]
                b.admit(_pend(mod, rid, dl, ts, bucket, ids, len(ids), hint))
                k += 1
            d = b.next_dispatch(float(step))
            if d is not None:
                decisions.append((round(float(step), 6), d[0],
                                  [p.request.request_id for p in d[1]]))
        d = b.next_dispatch(t + 1.0, flush=True)
        while d is not None:
            decisions.append(("flush", d[0],
                              [p.request.request_id for p in d[1]]))
            d = b.next_dispatch(t + 1.0, flush=True)
        runs.append((decisions, stats.summary()))
    assert runs[0] == runs[1]
    assert runs[0][1]["promoted"] > 0 and runs[0][1]["expired"] > 0


def test_serve_stream_sink_folds_once_like_jax():
    rng = np.random.default_rng(3)
    stream = []
    for i in range(60):
        key = f"k{int(rng.integers(0, 40))}"
        t1 = float(rng.random())
        t2 = float(rng.random()) * (1 - t1)
        if i % 13 == 0:
            t1 = float("nan")
        stream.append((key, ("Yes", "No") if i % 3 else ("Covered", "Not"),
                       dict(token_1_prob=t1, token_2_prob=t2,
                            weighted_confidence=float(rng.random() * 100))))
    port = stream_stats.ServeStreamSink(window=16)
    ref = jstream.ServeStreamSink(window=16)
    got = [port.fold_payload(*s) for s in stream]
    want = [ref.fold_payload(*s) for s in stream]
    assert got == want and not all(got)
    assert port.summary() == ref.summary()
    assert port.state() == ref.state()
    again = stream_stats.ServeStreamSink(window=16)
    again.restore(port.state())
    assert again.state() == port.state()
    assert not again.fold_payload(*stream[-1])
    assert dataclasses.asdict(port.stats)["rows_folded"] == \
        ref.stats.rows_folded


def test_request_queue_under_concurrent_offers_keeps_the_most_urgent():
    """64 threads offer 8 requests each into a queue of 16 with a short
    switch interval: every request is admitted or shed exactly once, and
    the queue ends holding the 16 most urgent deadlines."""
    import sys

    rng = np.random.default_rng(2)
    deadlines = rng.permutation(64 * 8).astype(float)
    stats = ServeStats()
    q = queue.RequestQueue(16, stats, clock=lambda: 0.0)
    pend = [_pend(queue, str(i), d) for i, d in enumerate(deadlines)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            q.offer(p) for p in pend[8 * k: 8 * k + 8]]) for k in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    kept = sorted(p.t_deadline for p in q.snapshot())
    assert kept == sorted(deadlines)[:16]
    assert sum(p.future.done() for p in pend) == len(pend) - 16
    assert stats.shed == len(pend) - 16
