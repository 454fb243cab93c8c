"""The port's replica router (``lir_tpu_torch.serve.router``) and cluster
prefix index on the CPU, against the JAX package's.

- Host logic: each scenario of ``tests/test_router.py`` (least-loaded
  placement; weight residency; page residency and pressure; the SLO
  term; shedding with no live replica; failover exactly once; the
  breaker opening and recovering; every replica erroring; a kill with
  re-admission and a dropped zombie; revive and probe; hedge first-wins;
  dedup; concurrent submits) runs through both routers, each over the
  same scripted fake replicas under one injected clock. Both must place
  the same requests on the same replicas in the same order, end with
  the same ``RouterStats`` counters and breaker states, and resolve
  every request with the same winning payload. Exact: no float is
  computed by the router. The compared summaries include the
  ``"migrate"`` block.
- ``ClusterPrefixIndex`` against JAX's on the same seeded event streams,
  and the radix tree's page listeners against JAX's on the same
  insert / evict sequence (events exact).
- A prefill-role replica, or the roles ``MigrationConfig(
  prefill_replicas=1)`` gives (the CLI's: the first replicas prefill),
  route a long prompt through a migration chain (the chain's scenarios
  against JAX's are in ``tests/test_torch_migrate.py``).
- With real engines: two tiny replica servers behind the port's router
  (prefix cache off, ``pad_full``), every payload bitwise a direct
  single-server dispatch; a kill mid-run re-admits and every request
  resolves once; with the prefix cache on, a repeated trunk lands on its
  holder through the page listeners.
"""

import random
import threading
import types

import numpy as np
import pytest

import lir_tpu.config as jconfig
import lir_tpu.engine.prefix_tree as jtree
import lir_tpu.models.paged as jpaged
import lir_tpu.serve as jserve
import lir_tpu_torch.config as tconfig
import lir_tpu_torch.engine.prefix_tree as ttree
import lir_tpu_torch.models.paged as tpaged
import lir_tpu_torch.serve as tserve
from lir_tpu_torch.serve.queue import STATUS_ERROR, STATUS_OK, STATUS_SHED


def _ns(serve, config):
    return types.SimpleNamespace(
        Router=serve.ReplicaRouter, RouterConfig=config.RouterConfig,
        MigrationConfig=config.MigrationConfig, ServeConfig=config.ServeConfig,
        Future=serve.ServeFuture, Request=serve.ServeRequest,
        Result=serve.ServeResult)


PKGS = {"jax": _ns(jserve, jconfig), "torch": _ns(tserve, tconfig)}


def _req(ns, i, rid=None, deadline_s=None):
    body = f"clause {i} covers wind damage under policy {i * 7}"
    return ns.Request(binary_prompt=f"{body} Answer Yes or No .",
                      confidence_prompt=f"{body} Give a number from 0 to "
                                        f"100 .",
                      klass="t", deadline_s=deadline_s,
                      request_id=rid or str(i))


def _ok(ns, request, marker=0.5):
    return ns.Result(request_id=request.request_id, status=STATUS_OK,
                     model_response="Yes", model_confidence_response="80",
                     token_1_prob=marker, token_2_prob=1 - marker,
                     log_probabilities="{}", confidence_value=80,
                     weighted_confidence=80.0)


def _err(ns, request):
    return ns.Result(request_id=request.request_id, status=STATUS_ERROR,
                     note="device error")


class FakeReplica:
    """A scripted replica server: a depth signal, an oldest-wait signal,
    a pressure gauge, and a submit behaviour (a ServeResult to resolve
    with, or None to leave the future pending). Every submit is logged
    in the shared placement log."""

    def __init__(self, ns, name, placements, depth=0, behavior=None):
        self.ns = ns
        self.name = name
        self.placements = placements
        self.config = ns.ServeConfig(classes=(("t", 600.0),),
                                     default_class="t")
        self.queue_depth = depth
        self.wait = 0.0
        self.behavior = behavior or (lambda r: _ok(ns, r))
        self.submitted = []
        self._lock = threading.Lock()

    def oldest_wait(self, now):
        return self.wait

    def submit(self, request):
        fut = self.ns.Future()
        with self._lock:
            self.submitted.append((request, fut))
            self.placements.append((self.name, request.request_id))
        res = self.behavior(request)
        if res is not None:
            fut.resolve(res)
        return fut


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _world(ns, specs, **cfg):
    """(router, {name: replica}, placements, clock) over fake replicas
    ``specs`` = [(name, depth, behavior or None), ...]."""
    placements, clock = [], Clock()
    reps = {name: FakeReplica(ns, name, placements, depth,
                              None if beh is None else
                              (lambda r, b=beh: b(ns, r)))
            for name, depth, beh in specs}
    migrate = cfg.pop("migrate", None)
    kw = {} if migrate is None else {"migrate": ns.MigrationConfig(**migrate)}
    router = ns.Router(list(reps.items()), config=ns.RouterConfig(**cfg),
                       clock=clock, **kw)
    return router, reps, placements, clock


def _payload(res):
    return (res.request_id, res.status, res.token_1_prob, res.cached)


def _trace(router, placements, results):
    summary = router.stats_summary()
    return {"placements": list(placements),
            "stats": router.stats.summary(),
            "summary": summary,
            "breakers": {rid: router.breaker_of(rid).state
                         for rid in router.replica_ids},
            "results": [_payload(r) for r in results]}


# -- the scenarios of tests/test_router.py -----------------------------------

def sc_least_loaded(ns):
    router, reps, pl, _ = _world(ns, [("shallow", 1, None),
                                      ("deep", 50, None)])
    res = [router.submit(_req(ns, i)).result(1) for i in range(4)]
    assert router.stats.per_replica == {"shallow": 4}
    return _trace(router, pl, res)


def sc_weight_residency(ns):
    router, reps, pl, _ = _world(ns, [("a", 1, None), ("b", 5, None)],
                                 residency_bonus=8.0)
    router.handle("b").seed_resident(["m1"])
    res = [router.submit(_req(ns, 0, "r0"), model_id="m1").result(1),
           router.submit(_req(ns, 1, "r1")).result(1)]
    assert router.stats.routed_resident == 1
    return _trace(router, pl, res)


def sc_page_residency_and_pressure(ns):
    router, reps, pl, _ = _world(ns, [("a", 3, None), ("b", 3, None)],
                                 migrate={"page_bonus": 1.0})
    picks = [router._pick("", set(), page_match={"b": 4}).replica_id]
    reps["b"].hbm_pressure = 1.0
    picks.append(router._pick("", set(), page_match={"b": 4}).replica_id)
    assert picks == ["b", "a"]
    return {"picks": picks, **_trace(router, pl, [])}


def sc_slo_term(ns):
    router, reps, pl, _ = _world(ns, [("a", 3, None), ("b", 3, None)],
                                 slo_wait_weight=4.0)
    reps["a"].wait = 30.0
    res = [router.submit(_req(ns, 0, deadline_s=1.0)).result(1)]
    assert [p[0] for p in pl] == ["b"]
    return _trace(router, pl, res)


def sc_no_replica_sheds(ns):
    router, reps, pl, _ = _world(ns, [("a", 0, None)])
    router.kill_replica("a")
    res = [router.submit(_req(ns, 0)).result(1)]
    assert res[0].status == STATUS_SHED
    return _trace(router, pl, res)


def sc_failover_once(ns):
    router, reps, pl, _ = _world(ns, [("bad", 0, _err), ("good", 10, None)])
    res = [router.submit(_req(ns, 0)).result(1)]
    assert res[0].status == STATUS_OK and router.stats.failovers == 1
    return _trace(router, pl, res)


def sc_breaker_recovers(ns):
    router, reps, pl, clock = _world(
        ns, [("flaky", 0, _err), ("good", 10, None)],
        replica_failure_threshold=1, replica_cooldown_s=5.0)
    res = [router.submit(_req(ns, 0)).result(1),
           router.submit(_req(ns, 1)).result(1)]
    states = [router.breaker_of("flaky").state]
    clock.t = 6.0
    reps["flaky"].behavior = lambda r: _ok(ns, r)
    states.append(router.breaker_of("flaky").state)
    res.append(router.submit(_req(ns, 2)).result(1))
    states.append(router.breaker_of("flaky").state)
    assert states == ["open", "half_open", "closed"]
    return {"states": states, **_trace(router, pl, res)}


def sc_all_error(ns):
    router, reps, pl, _ = _world(ns, [("a", 0, _err), ("b", 0, _err)])
    res = [router.submit(_req(ns, 0)).result(1)]
    assert res[0].status == STATUS_ERROR and len(pl) == 2
    return _trace(router, pl, res)


def sc_kill_zombie(ns):
    router, reps, pl, _ = _world(ns, [("hang", 0, lambda ns, r: None),
                                      ("good", 10, None)])
    fut = router.submit(_req(ns, 0, "x"))
    n = router.kill_replica("hang")
    res = fut.result(1)
    _, zombie = reps["hang"].submitted[0]
    zombie.resolve(_ok(ns, _req(ns, 0, "x"), marker=0.999))
    assert n == 1 and router.stats.zombie_payloads == 1
    assert fut.result(0).token_1_prob == res.token_1_prob == 0.5
    return {"re_admitted": n, **_trace(router, pl, [res])}


def sc_revive_probe(ns):
    router, reps, pl, clock = _world(
        ns, [("a", 0, lambda ns, r: None), ("b", 10, None)],
        replica_cooldown_s=2.0)
    router.submit(_req(ns, 0))
    router.kill_replica("a")
    router.revive_replica("a")
    reps["a"].behavior = lambda r: _ok(ns, r)
    res = [router.submit(_req(ns, 1)).result(1)]
    clock.t = 3.0
    res.append(router.submit(_req(ns, 2)).result(1))
    assert router.breaker_of("a").state == "closed"
    return _trace(router, pl, res)


def sc_hedge_first_wins(ns):
    router, reps, pl, _ = _world(ns, [("slow", 0, lambda ns, r: None),
                                      ("fast", 10, None)], hedge_s=100.0)
    fut = router.submit(_req(ns, 0, "h", deadline_s=1.0))
    router._tick()
    res = fut.result(1)
    _, late = reps["slow"].submitted[0]
    late.resolve(_ok(ns, _req(ns, 0, "h"), marker=0.123))
    router._tick()
    assert (router.stats.hedged, router.stats.hedge_wins,
            router.stats.hedge_losses) == (1, 1, 1)
    return _trace(router, pl, [res, fut.result(0)])


def sc_dedup(ns):
    router, reps, pl, _ = _world(ns, [("a", 0, None)])
    res = [router.submit(_req(ns, 0, "d0")).result(1),
           router.submit(_req(ns, 0, "d0-again")).result(1)]
    assert res[1].cached and router.stats.dedup_hits == 1 and len(pl) == 1
    return _trace(router, pl, res)


def sc_concurrent(ns):
    router, reps, pl, _ = _world(ns, [(f"r{i}", i, None) for i in range(3)])
    futs, lock = {}, threading.Lock()

    def client(tid):
        for j in range(20):
            rid = f"c{tid}-{j}"
            f = router.submit(_req(ns, 1000 + tid * 100 + j, rid))
            with lock:
                futs[rid] = f

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = [futs[rid].result(1) for rid in sorted(futs)]
    assert [r.request_id for r in res] == sorted(futs)
    trace = _trace(router, sorted(pl), res)
    return trace


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_least_loaded, sc_weight_residency, sc_page_residency_and_pressure,
    sc_slo_term, sc_no_replica_sheds, sc_failover_once, sc_breaker_recovers,
    sc_all_error, sc_kill_zombie, sc_revive_probe, sc_hedge_first_wins,
    sc_dedup, sc_concurrent)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_host_logic_matches_jax(name):
    want = SCENARIOS[name](PKGS["jax"])
    got = SCENARIOS[name](PKGS["torch"])
    assert got == want


def test_summary_matches_jax_with_migrate_block():
    """The port's summary is JAX's, its "migrate" block (the
    MigrationStats counters) included."""
    summaries = {}
    for k, ns in PKGS.items():
        router, *_ = _world(ns, [("a", 0, None), ("b", 2, None)])
        summaries[k] = router.stats_summary()
    assert "migrate" in summaries["jax"] and "migrate" in summaries["torch"]
    assert summaries["torch"] == summaries["jax"]
    assert set(summaries["torch"]["migrate"].values()) == {0}


def test_future_callbacks_fire_once_first_resolution_wins():
    for ns in PKGS.values():
        fut, got = ns.Future(), []
        fut.add_done_callback(lambda r: got.append(r.status))
        fut.resolve(ns.Result(request_id="a", status=STATUS_OK))
        fut.resolve(ns.Result(request_id="a", status=STATUS_ERROR))
        fut.add_done_callback(lambda r: got.append(r.status))
        assert got == ["ok", "ok"] and fut.result(0).status == STATUS_OK


class _PageReplica(FakeReplica):
    """A fake replica with a real radix tree and pool of the port (tiny
    leaves) and page ops run at once: enough for the chain."""

    def __init__(self, ns, name, placements):
        import torch
        from lir_tpu_torch.backends.fake import FakeTokenizer
        from lir_tpu_torch.serve import migrate

        super().__init__(ns, name, placements)
        pool = tpaged.KVPagePool(64, page_size=4)
        pool.ensure((torch.zeros(1, 1, 8, 1, 2), torch.zeros(1, 1, 8, 1, 2)))
        self.engine = types.SimpleNamespace(
            prefix_cache=ttree.RadixPrefixCache(pool),
            tokenizer=FakeTokenizer(), _tok_lock=threading.Lock(),
            buckets=[16, 32, 64, 128, 256])
        self._migrate = migrate

    def submit_page_op(self, fn):
        op = self._migrate.PageOp(fn)
        op.run(self.engine)
        return op.future

    def submit_prefill(self, bucket, ids):
        def prefill(eng):
            eng.prefix_cache.plan_insert(bucket, ids)
            return eng.prefix_cache.match_len(bucket, ids)

        return self.submit_page_op(prefill)


@pytest.mark.parametrize("how", ["prefill-role", "prefill-replicas"])
def test_migration_routes_through_a_chain(how):
    """A prefill-role replica, or ``MigrationConfig(prefill_replicas=1)``
    with the roles the CLI gives it, route a long prompt through a
    migration chain: a prefill on the prefill replica, its pages pulled
    to the decode replica, the request scored there."""
    ns = PKGS["torch"]
    placements = []
    reps = [(n, _PageReplica(ns, n, placements)) for n in ("a", "b")]
    if how == "prefill-role":
        kw = dict(roles={"a": "prefill", "b": "decode"},
                  migrate=ns.MigrationConfig(min_prefix_tokens=8))
    else:
        cfg = ns.MigrationConfig(prefill_replicas=1, min_prefix_tokens=8)
        kw = dict(roles={rid: ("prefill" if i < cfg.prefill_replicas
                               else "decode")
                         for i, (rid, _) in enumerate(reps)},
                  migrate=cfg)
    router = ns.Router(reps, config=ns.RouterConfig(cache_entries=0), **kw)
    res = router.submit(_req(ns, 0)).result(1)
    st = router.stats_summary()
    assert res.status == STATUS_OK
    assert placements == [("b", res.request_id)]
    assert st["replicas"]["a"]["role"] == "prefill"
    assert st["migrate"]["prefill_ops"] == st["migrate"]["migrations"] == 1
    assert st["migrate"]["pages_migrated"] > 0


# ---------------------------------------------------------------------------
# The cluster prefix index and the tree's page listeners
# ---------------------------------------------------------------------------

def _event_stream(seed, n=200, ps=4):
    """Seeded insert / evict events over a few replicas, buckets, tiers
    and shared token trunks."""
    rng = random.Random(seed)
    trunks = [[rng.randrange(50) for _ in range(6 * ps)] for _ in range(3)]
    out = []
    for _ in range(n):
        trunk = rng.choice(trunks)
        ids = trunk[:rng.randrange(0, len(trunk) + 1)] + [
            rng.randrange(50) for _ in range(rng.randrange(0, 2 * ps))]
        out.append((rng.choice("abc"), rng.choice(["insert", "insert",
                                                   "evict"]),
                    rng.choice([64, 128]), ids,
                    rng.choice(["hbm", "hbm", "host", "disk"])))
    return trunks, out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_index_matches_jax(seed):
    trunks, events = _event_stream(seed)
    idx = {"jax": jtree.ClusterPrefixIndex(4),
           "torch": ttree.ClusterPrefixIndex(4)}
    rng = random.Random(seed + 100)
    for k, (rid, ev, bucket, ids, tier) in enumerate(events):
        for ix in idx.values():
            if tier == "hbm":
                ix.on_event(rid, ev, bucket, ids)
            else:
                ix.on_tier_event(rid, ev, tier, bucket, ids)
        if k % 50 == 49:
            drop = rng.choice("abc")
            for ix in idx.values():
                ix.drop_replica(drop)
        probe = rng.choice(trunks)[:rng.randrange(0, 25)]
        for bucket in (64, 128):
            got = [(ix.match_pages(bucket, probe),
                    ix.match_tiers(bucket, probe),
                    ix.best_holder(bucket, probe),
                    ix.best_holder(bucket, probe, exclude=("a",)))
                   for ix in idx.values()]
            assert got[0] == got[1]


def _tree_events(P, T, seed):
    events = []
    tree = T.RadixPrefixCache(P.KVPagePool(12, page_size=4))
    tree.add_listener(lambda ev, b, ids: events.append((ev, b, ids)))
    rng = random.Random(seed)
    trunk = [rng.randrange(30) for _ in range(24)]
    for step in range(40):
        ids = trunk[:rng.randrange(4, 25)] + [rng.randrange(30)
                                              for _ in range(rng.randrange(8))]
        bucket = rng.choice([32, 64])
        if step % 7 == 6:
            tree.evict(rng.randrange(1, 4))
        else:
            tree.plan_insert(bucket, ids)
    return events


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_listener_events_match_jax(seed):
    want = _tree_events(jpaged, jtree, seed)
    got = _tree_events(tpaged, ttree, seed)
    assert got == want
    assert {e[0] for e in got} == {"insert", "evict"}


def test_listener_fault_never_breaks_the_tree():
    tree = ttree.RadixPrefixCache(tpaged.KVPagePool(8, page_size=4))
    seen = []

    def bad(ev, b, ids):
        raise RuntimeError("listener down")

    tree.add_listener(bad)
    tree.add_listener(lambda ev, b, ids: seen.append(ev))
    start, pages = tree.plan_insert(16, list(range(8)))
    assert (start, len(pages)) == (0, 2) and seen == ["insert"]


# ---------------------------------------------------------------------------
# Real engines behind the port's router
# ---------------------------------------------------------------------------

def _tiny_servers(n, prefix_cache):
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig, ServeConfig
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models import decoder
    from lir_tpu_torch.models.registry import ModelConfig

    cfg = ModelConfig(name="router-t", vocab_size=FakeTokenizer.VOCAB,
                      hidden_size=32, n_layers=1, n_heads=2,
                      intermediate_size=64, max_seq_len=256)
    params = decoder.init_params(cfg, seed=2, device="cpu")
    scfg = ServeConfig(queue_depth=64, classes=(("t", 600.0),),
                       default_class="t", linger_s=0.0,
                       prefix_cache=prefix_cache, cache_entries=0)
    out = []
    for _ in range(n):
        eng = ScoringEngine(params, cfg, FakeTokenizer(),
                            RuntimeConfig(batch_size=4, max_seq_len=256),
                            device="cpu")
        out.append(tserve.ScoringServer(eng, "router-t", scfg))
    return out


_FIELDS = ("model_response", "model_confidence_response", "token_1_prob",
           "token_2_prob", "log_probabilities", "confidence_value",
           "weighted_confidence")


def test_router_end_to_end_bitwise_and_kill():
    """Every routed payload is bitwise what a direct single-server
    dispatch of the same request gives (prefix off, ``pad_full``: the
    same row count on every replica), and a kill with traffic in flight
    re-admits with every request resolved once."""
    ns = PKGS["torch"]
    servers = _tiny_servers(3, prefix_cache=False)
    for s in servers:
        s.start()
    router = ns.Router([(f"r{i}", s) for i, s in enumerate(servers)],
                       config=ns.RouterConfig(replica_cooldown_s=0.2,
                                              cache_entries=0))
    ref, = _tiny_servers(1, prefix_cache=False)
    ref.start()
    try:
        reqs = [_req(ns, i, f"a{i}") for i in range(8)]
        res = [router.submit(r) for r in reqs]
        res = [f.result(60) for f in res]
        direct = [ref.submit(r).result(60) for r in reqs]
        assert all(r.status == STATUS_OK for r in res)
        for a, b in zip(res, direct):
            assert [getattr(a, f) for f in _FIELDS] == \
                [getattr(b, f) for f in _FIELDS]
        assert len(router.stats.per_replica) >= 2
        futs = [router.submit(_req(ns, 200 + i, f"b{i}")) for i in range(8)]
        router.kill_replica("r1")
        res2 = [f.result(60) for f in futs]
        assert all(r.status == STATUS_OK for r in res2)
        assert len({r.request_id for r in res2}) == 8
        assert sorted(router.alive_replicas()) == ["r0", "r2"]
    finally:
        router.stop()
        ref.stop()
        for s in servers:
            s.stop()


def test_page_residency_routes_a_trunk_to_its_holder():
    """After one request warms a replica's radix tree, requests sharing
    its trunk go to that replica (tree listener -> cluster index ->
    ``_pick``'s page bonus), not round-robin."""
    ns = PKGS["torch"]
    servers = _tiny_servers(2, prefix_cache=True)
    for s in servers:
        s.start()
    router = ns.Router([("a", servers[0]), ("b", servers[1])],
                       config=ns.RouterConfig(cache_entries=0),
                       migrate=ns.MigrationConfig(page_bonus=2.0))
    try:
        rng = np.random.default_rng(3)
        words = "coverage policy flood water damage claim".split()
        trunk = " ".join(rng.choice(words) for _ in range(50))

        def req(i):
            body = f"{trunk} case {i}"
            return ns.Request(binary_prompt=f"{body} Answer Yes or No .",
                              confidence_prompt=f"{body} Give a number from "
                                                f"0 to 100 .",
                              klass="t", request_id=str(i))

        assert router.submit(req(0)).result(120).status == STATUS_OK
        holder = next(iter(router.stats.per_replica))
        for i in range(1, 4):
            assert router.submit(req(i)).result(120).status == STATUS_OK
        assert router.stats.per_replica == {holder: 4}
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_replica_kill_drill_then_revive_and_probe():
    """``wrap_replica``'s kill on r0's first dispatch: the router
    re-admits its requests to r1 (each resolves once, payloads bitwise a
    direct dispatch), the killed server's watchdog and breaker read the
    kill as a failed dispatch that its retry recovers (its late payloads
    are counted as zombies) and its engine is not poisoned: after
    ``revive_replica`` and the cooldown a probe lands on r0 and closes
    the router's breaker."""
    import time

    from lir_tpu_torch import faults

    ns = PKGS["torch"]
    servers = _tiny_servers(2, prefix_cache=False)
    ref, = _tiny_servers(1, prefix_cache=False)
    for s in servers + [ref]:
        s.start()
    router = ns.Router([("r0", servers[0]), ("r1", servers[1])],
                       config=ns.RouterConfig(replica_cooldown_s=0.2,
                                              cache_entries=0))
    plan = faults.FaultPlan(0, {"replica": faults.SiteSchedule.replica_kill_at(
        0, "r0")})
    faults.wrap_replica(router, "r0", plan)
    try:
        reqs = [_req(ns, 300 + i, f"k{i}") for i in range(6)]
        res = [f.result(60) for f in [router.submit(r) for r in reqs]]
        assert [r.status for r in res] == ["ok"] * 6
        assert len({r.request_id for r in res}) == 6
        direct = [ref.submit(r).result(60) for r in reqs]
        for a, b in zip(res, direct):
            assert [getattr(a, f) for f in _FIELDS] == \
                [getattr(b, f) for f in _FIELDS]
        st = router.stats
        assert st.kills == 1 and st.re_admitted >= 1
        assert plan.injected("replica") == 1
        # The killed server recovered its dispatch by the retry.
        t0 = time.monotonic()
        while servers[0].queue_depth and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert servers[0].healthy
        assert servers[0].faults.summary()["recovered_dispatches"] >= 1
        assert st.zombie_payloads >= 1
        assert router.breaker_of("r0").state != "closed"   # tripped
        router.revive_replica("r0")
        time.sleep(0.25)
        for i in range(4):
            assert router.submit(_req(ns, 400 + i)).result(60).status == "ok"
        assert router.breaker_of("r0").state == "closed"
        assert st.revives == 1 and st.per_replica["r0"] >= 2
    finally:
        router.stop()
        for s in servers + [ref]:
            s.stop()


def test_replica_lag_is_hedged_and_the_straggler_dropped():
    """A lagging replica (``replica_lag`` through ``wrap_replica``) under
    a hedge whisker wider than every deadline: its requests are hedged
    onto the other replica, the hedge wins, the straggler's late payload
    is a hedge loss, and every request resolves once."""
    import time

    from lir_tpu_torch import faults

    ns = PKGS["torch"]
    servers = _tiny_servers(2, prefix_cache=False)
    for i, s in enumerate(servers):
        s.start()
        # A first dispatch each, so the hedge's is not the slow first.
        assert s.submit(_req(ns, 900 + i)).result(60).status == "ok"
    router = ns.Router([("r0", servers[0]), ("r1", servers[1])],
                       config=ns.RouterConfig(hedge_s=1000.0, tick_s=0.01,
                                              cache_entries=0))
    faults.wrap_replica(router, "r1", faults.FaultPlan(0, {
        "replica": faults.SiteSchedule.replica_lag_at(0, 4.0)}))
    router.start()
    try:
        # Both replicas idle: the first pick's round-robin turn is r1.
        first = router.submit(_req(ns, 500, "h0")).result(60)
        second = router.submit(_req(ns, 501, "h1")).result(60)
        assert [first.status, second.status] == ["ok", "ok"]
        st = router.stats
        assert st.per_replica["r1"] >= 1
        assert st.hedged >= 1 and st.hedge_wins >= 1
        t0 = time.monotonic()
        while st.hedge_losses < 1 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert st.hedge_losses >= 1 and st.completed == 2
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_router_stress_resolves_every_request_once():
    """More client threads than cores, a shortened switch interval,
    replicas resolving on their own threads at random delays, every
    request hedged, and a thread killing and reviving replicas: every
    request resolves exactly once with its own id, and the counters lose
    no update (attempts placed == attempts the replicas saw; completed +
    errors + sheds == requests)."""
    import os
    import sys
    import time

    ns = PKGS["torch"]
    lock = threading.Lock()
    seen = {"attempts": 0}
    rng = random.Random(5)
    timers = []

    class AsyncReplica(FakeReplica):
        def submit(self, request):
            fut = self.ns.Future()
            with lock:
                seen["attempts"] += 1
                delay = rng.uniform(0.0, 0.003)
            t = threading.Timer(delay, fut.resolve, args=(_ok(ns, request),))
            with lock:
                timers.append(t)
            t.start()
            return fut

    reps = [(f"r{i}", AsyncReplica(ns, f"r{i}", [])) for i in range(3)]
    router = ns.Router(reps, config=ns.RouterConfig(
        hedge_s=1e6, tick_s=0.001, cache_entries=0,
        replica_cooldown_s=0.001)).start()
    n_threads, per_thread = (os.cpu_count() or 4) + 4, 25
    futs, errors = {}, []
    stop = threading.Event()

    def client(tid):
        try:
            for j in range(per_thread):
                rid = f"s{tid}-{j}"
                f = router.submit(_req(ns, tid * 1000 + j, rid))
                with lock:
                    futs[rid] = f
        except Exception as err:  # noqa: BLE001 — reported below
            errors.append(err)

    def chaos():
        while not stop.is_set():
            victim = f"r{rng.randrange(3)}"
            router.kill_replica(victim)
            time.sleep(0.001)
            router.revive_replica(victim)
            time.sleep(0.002)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        killer = threading.Thread(target=chaos)
        killer.start()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stop.set()
        killer.join(60)
        assert not killer.is_alive()
        assert not any(t.is_alive() for t in threads) and not errors
        results = {rid: f.result(30) for rid, f in futs.items()}
    finally:
        sys.setswitchinterval(old)
        router.stop()
        for t in timers:
            t.join(30)
    assert len(results) == n_threads * per_thread
    assert all(r.request_id == rid for rid, r in results.items())
    st = router.stats.summary()
    assert sum(st["per_replica"].values()) == seen["attempts"]
    statuses = [r.status for r in results.values()]
    assert st["completed"] == statuses.count("ok")
    assert (st["completed"] + st["errors"] + st["no_replica_sheds"]
            == len(results))
