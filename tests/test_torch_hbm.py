"""The port's device-memory governor (``lir_tpu_torch/engine/hbm.py``)
against the JAX package's (``lir_tpu/engine/hbm.py``).

- The same seeded sequences of ``register``, ``unregister``, ``admit``,
  ``tick``, ``handle_oom`` and ``squeeze`` (with reclaim actions that
  answer the same way in both) go to both governors under a fixed
  budget and unbounded; after EVERY call the engaged rungs, ``level``,
  ``allows``, ``batch_cap``, ``headroom``, ``pressure`` and the whole
  ``summary()`` (counters, gauges, ledger) are equal.
- ``validate_fleet_budget`` refuses and admits the same models with the
  same counters; ``is_oom_error`` gives the JAX answers and also takes
  ``torch.cuda.OutOfMemoryError``; the ``MemStats`` / ``FleetStats``
  summary keys are the JAX ones.
- An engine's ``_piggyback_fits`` gives the JAX engine's answer for the
  same ledger (a budget, the params, a parked carry) across chain sizes
  on both sides of the headroom, and both refuse under ``no_piggyback``.
- An engine registers its params and its page pool as the JAX engine
  does, and no rung ever engages on the CPU's unbounded governor.
"""


import numpy as np
import pytest
import torch

from lir_tpu.config import GovernorConfig as JaxGovernorConfig
from lir_tpu.engine import hbm as jhbm
from lir_tpu.utils import profiling as jprof
from lir_tpu_torch.config import GovernorConfig
from lir_tpu_torch.engine import hbm
from lir_tpu_torch.utils import profiling

GIB = 2**30


def _pair(budget, **cfg):
    return (jhbm.HbmGovernor(JaxGovernorConfig(**cfg), budget_bytes=budget),
            hbm.HbmGovernor(GovernorConfig(**cfg), budget_bytes=budget,
                            device="cpu"))


def _state(g):
    return dict(level=g.level, engaged=g.engaged_rungs(),
                spec=g.allows("spec"), piggy=g.allows("piggyback"),
                cap=g.batch_cap(32), headroom=g.headroom(),
                pressure=g.pressure(), budget=g.budget_bytes,
                ledger_bytes=g.ledger_bytes, summary=g.summary())


class _Actions:
    """Rung actions that answer from one seeded script, the same in both
    packages: each call of a rung's engage returns the next scripted
    bool; releases are counted."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.answers = [bool(x) for x in self.rng.integers(0, 2, 64)]
        self.calls = {"engage": [], "release": []}

    def attach(self, gov):
        for rung in hbm.RUNGS[:2]:
            gov.set_action(rung, engage=self._engage(rung),
                           release=self._release(rung))

    def _engage(self, rung):
        def fn():
            self.calls["engage"].append(rung)
            return self.answers[len(self.calls["engage"]) % 64]
        return fn

    def _release(self, rung):
        def fn():
            self.calls["release"].append(rung)
        return fn


def _ops(seed, n=160):
    """A seeded operation script over a 10 GiB budget: consumers come
    and go at sizes that cross the engage and release pressures, with
    admissions, OOMs and squeezes between the ticks."""
    rng = np.random.default_rng(seed)
    names = ["params:a", "params:b", "kv_pages:a", "handoff:a",
             "spec_draft:d", "weights"]
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.3:
            ops.append(("register", str(rng.choice(names)),
                        int(rng.integers(0, 6 * GIB))))
        elif r < 0.4:
            ops.append(("unregister", str(rng.choice(names))))
        elif r < 0.5:
            ops.append(("admit", str(rng.choice(names)),
                        int(rng.integers(0, 8 * GIB))))
        elif r < 0.55:
            ops.append(("handle_oom", str(rng.choice(["sweep", "serve"]))))
        elif r < 0.6:
            ops.append(("squeeze", float(rng.choice([0.05, 0.3, 0.6])),
                        int(rng.integers(1, 9))))
        else:
            ops.append(("tick",))
    return ops


def _apply(gov, op):
    name, *args = op
    return getattr(gov, name)(*args)


@pytest.mark.parametrize("budget", [10 * GIB, None], ids=["10GiB", "unbounded"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequences_give_the_same_state(seed, budget):
    jg, tg = _pair(budget, sustain_ticks=1 + seed % 3)
    ja, ta = _Actions(seed), _Actions(seed)
    ja.attach(jg)
    ta.attach(tg)
    assert _state(tg) == _state(jg)
    walked = set()
    for i, op in enumerate(_ops(seed)):
        assert _apply(tg, op) == _apply(jg, op), (i, op)
        assert _state(tg) == _state(jg), (i, op)
        walked.add(tg.level)
    assert ta.calls == ja.calls
    # The scripts walk the ladder down and back up.
    assert max(walked) >= 3
    assert tg.stats.rung_downs and tg.stats.rung_ups


def test_squeeze_walks_every_rung_in_order_and_back():
    jg, tg = _pair(None)
    for g in (jg, tg):
        g.register("params:m", 4 * GIB)
        g.squeeze(0.5, calls=2 * len(hbm.RUNGS) + 1)
    downs = []
    for _ in range(2 * len(hbm.RUNGS)):
        jg.tick()
        tg.tick()
        assert _state(tg) == _state(jg)
        downs.append(tg.engaged_rungs())
    assert downs[-1] == list(hbm.RUNGS) == list(jhbm.RUNGS)
    assert not tg.allows("spec") and not tg.allows("piggyback")
    assert tg.batch_cap(32) == 16 and tg.should_shed() == jg.should_shed()
    for _ in range(2 * len(hbm.RUNGS) + 2):
        jg.tick()
        tg.tick()
        assert _state(tg) == _state(jg)
    assert tg.level == 0 and tg.budget_bytes is None
    assert tg.stats.rung_ups == {r: 1 for r in hbm.RUNGS}


def test_disabled_governor_never_walks():
    jg, tg = _pair(GIB, enabled=False)
    for g in (jg, tg):
        g.register("params:m", 2 * GIB)
        for _ in range(8):
            g.tick()
        assert g.handle_oom("sweep") is False
    assert _state(tg) == _state(jg)
    assert tg.level == 0


def test_oom_message_names_the_holders():
    jg, tg = _pair(8 * GIB)
    for g in (jg, tg):
        g.register("params:m", 3 * GIB)
        g.register("kv_pages:m", GIB)
        g.handle_oom("sweep")
    err = RuntimeError("boom")
    msg = tg.oom_message("sweep", err)
    assert msg == jg.oom_message("sweep", err)
    assert "params:m=3.00 GiB" in msg and "no_piggyback" in msg


@pytest.mark.parametrize("nbytes,budget", [
    (GIB, None), (GIB, 2 * GIB), (2 * GIB, 2 * GIB), (3 * GIB, 2 * GIB),
    (5 * GIB, GIB)])
def test_validate_fleet_budget_refuses_as_jax(nbytes, budget):
    jg, tg = _pair(16 * GIB)
    for g in (jg, tg):
        g.register("kv_pages:m", GIB)
    outcomes = []
    for mod, g in ((jhbm, jg), (hbm, tg)):
        try:
            mod.validate_fleet_budget("m", nbytes, budget, governor=g)
            outcomes.append("ok")
        except ValueError as exc:
            outcomes.append("refused")
            assert "cannot hold model 'm'" in str(exc)
            assert "kv_pages:m=1.00 GiB" in str(exc)
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] == ("refused" if budget is not None and nbytes > budget
                           else "ok")
    assert _state(tg) == _state(jg)


def test_oom_test_and_stats_keys():
    for text in ("RESOURCE_EXHAUSTED: x", "CUDA out of memory", "Out Of Memory",
                 "shape mismatch", ""):
        assert profiling.is_oom_error(text) == jprof.is_oom_error(text)
        assert (profiling.is_oom_error(RuntimeError(text))
                == jprof.is_oom_error(RuntimeError(text)))
    assert profiling.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert (list(profiling.MemStats().summary())
            == list(jprof.MemStats().summary()))
    assert (list(profiling.FleetStats().summary())
            == list(jprof.FleetStats().summary()))
    assert hbm.device_budget_bytes(0.08, "cpu") is None


@pytest.fixture(scope="module")
def engine_pair():
    import jax
    import jax.numpy as jnp

    from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
    from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
    from lir_tpu.engine.runner import ScoringEngine as JaxEngine
    from lir_tpu.models import decoder as jdec
    from lir_tpu.models.registry import ModelConfig as JaxModelConfig
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models.convert import params_from_jax
    from lir_tpu_torch.models.registry import ModelConfig

    cfg = dict(name="hbm-tiny", vocab_size=FakeTokenizer.VOCAB,
               hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
               intermediate_size=128, max_seq_len=512)
    tree = jax.tree.map(np.asarray, jdec.init_params(
        JaxModelConfig(**cfg), jax.random.PRNGKey(0), dtype=jnp.float32))
    rt = dict(batch_size=4, prefix_cache=True, prefix_cache_pages=8)
    jg, tg = _pair(None)
    jeng = JaxEngine(jax.tree.map(jnp.asarray, tree), JaxModelConfig(**cfg),
                     JaxFakeTokenizer(), JaxRuntimeConfig(**rt), governor=jg)
    teng = ScoringEngine(params_from_jax(tree, ModelConfig(**cfg),
                                        device="cpu"),
                         ModelConfig(**cfg), FakeTokenizer(),
                         RuntimeConfig(**rt), device="cpu", governor=tg)
    return jeng, teng


def test_engines_register_the_same_ledger(engine_pair):
    jeng, teng = engine_pair
    assert teng.governor.ledger() == jeng.governor.ledger()
    assert set(teng.governor.ledger()) == {"params:hbm-tiny",
                                           "kv_pages:hbm-tiny"}
    assert teng.governor.budget_bytes is None and teng.governor.level == 0
    teng.release_params_ledger()
    jeng.release_params_ledger()
    assert teng.governor.ledger() == jeng.governor.ledger()


def test_piggyback_fits_answers_as_jax(engine_pair):
    jeng, teng = engine_pair
    for g in (jeng.governor, teng.governor):
        g._base_budget = 64 << 20          # a fixed budget: 64 MiB
        g.register("params:hbm-tiny", 8 << 20)
        g.register("handoff:hbm-tiny", 4 << 20)
    answers = []
    for bsz in (4, 32, 128):
        for total in (64, 256, 1024, 2048):
            t = teng._piggyback_fits(bsz, total)
            assert t == jeng._piggyback_fits(bsz, total), (bsz, total)
            answers.append(t)
    assert True in answers and False in answers
    for g in (jeng.governor, teng.governor):
        g._level = hbm.RUNGS.index("no_piggyback") + 1
    assert not teng._piggyback_fits(4, 64) and not jeng._piggyback_fits(4, 64)
    for g in (jeng.governor, teng.governor):
        g._level = 0
        g._base_budget = None


def test_shared_state_under_thread_stress():
    """More threads than cores hammer one governor, one weight cache and
    one FleetStats with a short switch interval: no update is lost (the
    ledger, the counters and every refcount come out exact)."""
    import sys
    import threading

    from lir_tpu_torch.models import weights

    gov = hbm.HbmGovernor(budget_bytes=10 * GIB, device="cpu")
    cache = weights.WeightCache(None)
    stats = profiling.FleetStats()
    for m in range(4):
        cache.insert(f"m{m}", f"p{m}", 100)
    n_threads, n_ops = 32, 300
    errors = []

    def work(t):
        try:
            for i in range(n_ops):
                gov.register(f"w{t}", i + 1)
                gov.tick()
                stats.count("loads")
                stats.count("load_s", 0.5)
                mid = f"m{(t + i) % 4}"
                cache.acquire(mid)
                cache.release(mid)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    assert gov.ledger_bytes == n_threads * n_ops
    assert gov.stats.ledger_bytes == n_threads * n_ops and gov.level == 0
    assert stats.loads == n_threads * n_ops
    assert stats.load_s == 0.5 * n_threads * n_ops
    assert [cache.refcount(f"m{m}") for m in range(4)] == [0] * 4
