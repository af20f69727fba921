"""The port's batch-query consistency protocol and its replica fleet
(``core/batch_query.py``, ``core/publish.py``, ``core/cluster_sim.py``)
against the JAX package's, on the CPU.

Every scenario runs once per package, each over its own modules and built
from the same seeded numpy data: the eight of
``tests/test_consistency_protocol.py``; ``TestBatchQueryService``,
``TestConsistency`` and ``TestClusterSim`` of
``tests/test_store_subsystem.py``; ``TestDeltaPublisher`` of
``tests/test_publish_and_launchers.py``;
``test_fused_matches_three_independent_services`` of
``tests/test_engine.py``; and the two ``ClusterSim`` cases of
``tests/test_feature_api.py`` (``ClusterBackend`` unchanged over the
port's fleet).  Beside them, the two packages are held to each other:
``run_update_experiment``'s ``ClusterMetrics`` field by field for three
seeds and both protocols (the sim draws its randomness in the same order),
and the data plane's answers and versions bitwise, batch by batch.
"""
import dataclasses
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as japi
from repro.core import batch_query as jbq
from repro.core import cluster_sim as jcs
from repro.core import engine as jeng
from repro.core import hybrid_store as jhs
from repro.core import publish as jpub
from repro.core import sharding as jsh
from repro.core import versioning as jver
from repro.data.synthetic import zipf_ids
import repro_torch.api as tapi
from repro_torch.core import batch_query as tbq
from repro_torch.core import cluster_sim as tcs
from repro_torch.core import engine as teng
from repro_torch.core import hybrid_store as ths
from repro_torch.core import publish as tpub
from repro_torch.core import sharding as tsh
from repro_torch.core import versioning as tver
from repro_torch.kernels import neighbor_lookup as nl

CPU = {"device": "cpu"}
PKGS = {
    "jax": types.SimpleNamespace(name="jax", api=japi, bq=jbq, cs=jcs,
                                 eng=jeng, hs=jhs, pub=jpub, sh=jsh,
                                 ver=jver, kw={}),
    "torch": types.SimpleNamespace(name="torch", api=tapi, bq=tbq, cs=tcs,
                                   eng=teng, hs=ths, pub=tpub, sh=tsh,
                                   ver=tver, kw=CPU),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def sim_of(pkg, cfg, **kw):
    return pkg.cs.ClusterSim(cfg, **kw, **pkg.kw)


# ---------------------------------------------------------------------------
# tests/test_consistency_protocol.py, once per package
# ---------------------------------------------------------------------------
def test_version_window_retention_and_nack(pkg):
    w = pkg.ver.VersionWindow(retain=2)
    assert w.get(None) == (False, -1, None)
    w.publish(1, "a")
    w.publish(2, "b")
    w.publish(3, "c")
    assert w.versions == [2, 3]
    ok, v, st_ = w.get(1)
    assert not ok and v == 3 and st_ is None
    ok, v, st_ = w.get(None)
    assert ok and v == 3 and st_ == "c"
    ok, v, st_ = w.get(2)
    assert ok and st_ == "b"


def _fleet(pkg, n_rows=400, retain=2):
    plan = pkg.sh.plan_shards(pkg.sh.TableSpec("t", n_rows, 16), 1024)
    reps = [[pkg.ver.ShardReplica(s, r, retain=retain) for r in range(2)]
            for s in range(plan.n_shards)]
    keys = np.arange(1, n_rows + 1, dtype=np.uint64)
    parts = plan.partition(keys)
    vals = np.full((n_rows, 1), 1.0, np.float32)
    for s, rows in enumerate(parts):
        for rep in reps[s]:
            rep.publish(pkg.ver.Generation(1, keys[rows], vals[rows]))
    return plan, reps, keys, parts


def test_rolling_publish_never_mixes_and_repins_converge(pkg):
    plan, reps, keys, parts = _fleet(pkg)
    client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of, enforce=True)
    rng = np.random.default_rng(0)
    for target_v in range(2, 6):
        gens = [pkg.ver.Generation(target_v, keys[rows],
                                   np.full((len(rows), 1), float(target_v),
                                           np.float32))
                for rows in parts]
        upd = pkg.ver.rolling_update(reps, gens)
        done = False
        while not done:
            try:
                next(upd)
            except StopIteration:
                done = True
            q = keys[rng.choice(len(keys), 48)]
            found, vals, versions = client.query(q)
            assert found.all()
            assert len(set(versions)) == 1
            assert (vals[:, 0] == versions[0]).all()
    assert client.report.mixed_version_batches == 0
    assert client.report.failures == 0
    _, vals, versions = client.query(keys[:16])
    assert set(versions) == {5}
    assert client.report.repins <= client.report.attempts


def test_cluster_sim_paper_protocol_zero_mixed(pkg):
    m = pkg.cs.run_update_experiment(update_interval_s=5.0, protocol="paper",
                                     duration_s=60.0, qps=40.0, seed=3)
    assert m.queries > 1000
    assert m.mixed_version_batches == 0
    assert m.failures == 0


def test_cluster_sim_naming_baseline_mixes(pkg):
    m = pkg.cs.run_update_experiment(update_interval_s=5.0,
                                     protocol="naming", duration_s=60.0,
                                     qps=40.0, seed=3)
    assert m.mixed_rate > 0.0


def _drive_data_plane(pkg, protocol):
    """The data-plane scenario of test_consistency_protocol.py: a publish
    every 3 s against 2.5 s reloads and a 4 s naming lag.  Returns the
    mixed batches and each batch's (ok, versions, payloads)."""
    n = 512
    keys = np.arange(1, n + 1, dtype=np.uint64)

    def tables(version):
        payloads = np.full(n, version, dtype=np.uint64)
        return [pkg.eng.ScalarTable("t", keys, payloads)], []

    cfg = pkg.cs.SimConfig(n_shards=4, n_replicas=2, seed=7,
                           naming_propagation_us=4_000_000,
                           load_seconds_us=2_500_000)
    sim = sim_of(pkg, cfg, protocol=protocol, tables_for_version=tables)
    mixed_batches, trace = 0, []
    v = 1

    def publish():
        nonlocal v
        sim.start_rolling_update(v)
        v += 1

    for step in range(60):
        if step % 3 == 1:
            sim.sim.after(1, publish)
        sim.sim.run_until(sim.sim.now + 1_000_000)
        ok, versions, _lat, data = sim.query_batch(
            {"t": keys[np.random.default_rng(step).integers(0, n, 64)]})
        if not ok:
            trace.append((False, versions, None))
            continue
        found, payloads = data["t"]
        assert found.all()
        served = set(int(p) for p in payloads)
        if len(served) > 1:
            mixed_batches += 1
        if protocol == "paper":
            assert len(served) == 1
        trace.append((True, list(versions), payloads.copy()))
    return mixed_batches, trace


def test_cluster_sim_data_plane_versions_match_protocol(pkg):
    assert _drive_data_plane(pkg, "paper")[0] == 0
    assert _drive_data_plane(pkg, "naming")[0] > 0


@pytest.mark.parametrize("protocol", ["paper", "naming"])
def test_data_plane_answers_equal_across_packages(protocol):
    """The same sim in both packages answers every batch from the same
    versions with the same payloads, bitwise."""
    (jm, jt), (tm, tt) = (_drive_data_plane(PKGS[p], protocol)
                          for p in ("jax", "torch"))
    assert jm == tm and len(jt) == len(tt)
    for (jok, jv, jp), (tok, tv, tp) in zip(jt, tt):
        assert jok == tok and jv == tv
        if jok:
            np.testing.assert_array_equal(tp, jp)


def test_client_failure_returns_consistent_found_and_values(pkg):
    n_rows = 400
    plan = pkg.sh.plan_shards(pkg.sh.TableSpec("t", n_rows, 16), 1024)
    assert plan.n_shards >= 2
    reps = [[pkg.ver.ShardReplica(s, r) for r in range(2)]
            for s in range(plan.n_shards)]
    keys = np.arange(1, n_rows + 1, dtype=np.uint64)
    vals = np.tile(np.arange(n_rows, dtype=np.float32)[:, None], (1, 4))
    for s, rows in enumerate(plan.partition(keys)):
        for rep in reps[s]:
            rep.publish(pkg.ver.Generation(1, keys[rows], vals[rows]))
    client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                           enforce=False)
    f, v, _ = client.query(keys[:32])
    assert f.all() and v.shape == (32, 4) and v.dtype == np.float32
    for rep in reps[plan.n_shards - 1]:
        rep.serving = False
    q = keys[:64]
    assert len(set(plan.shard_of(int(k)) for k in q)) == plan.n_shards
    attempts_before = client.report.attempts
    f, v, versions = client.query(q)
    assert not f.any()
    assert v.shape == (len(q), 4) and v.dtype == np.float32
    assert (v == 0).all()
    assert client.report.failures == 1
    assert len(client.report.versions_used) == client.report.attempts \
        == attempts_before + 1
    assert client.report.versions_used[-1] == []
    assert client.report.mixed_version_batches == 0
    for s in range(plan.n_shards):
        for rep in reps[s]:
            rep.serving = s == plan.n_shards - 1
    f, v, _ = client.query(q)
    assert not f.any()
    assert v.shape == (len(q), 4) and v.dtype == np.float32
    strict = pkg.ver.ConsistentBatchClient(reps, plan.shard_of, enforce=True)
    f, v, _ = strict.query(q)
    assert not f.any() and (np.asarray(v) == 0).all()
    assert strict.report.failures == 1
    assert len(strict.report.versions_used) == strict.report.attempts == 1


def test_cluster_sim_delta_generations_during_rolling_update(pkg):
    n = 256
    keys = np.arange(1, n + 1, dtype=np.uint64)

    def tables(version):
        return [pkg.eng.ScalarTable("t", keys,
                                    np.zeros(n, dtype=np.uint64))], []

    def deltas(version):
        sel = keys[(version * 13) % (n - n // 4):][:n // 4]
        return ({"t": (sel, np.full(len(sel), version, dtype=np.uint64))},
                {})

    cfg = pkg.cs.SimConfig(n_shards=4, n_replicas=2, seed=7)
    with pytest.raises(ValueError):
        sim_of(pkg, cfg, deltas_for_version=deltas)
    sim = sim_of(pkg, cfg, protocol="paper", tables_for_version=tables,
                 deltas_for_version=deltas)
    v = 1
    for step in range(30):
        if step % 5 == 1:
            sim.start_rolling_update(v)
            v += 1
        sim.sim.run_until(sim.sim.now + 1_000_000)
        ok, versions, _lat, data = sim.query_batch({"t": keys[:64]})
        if not ok:
            continue
        found, payloads = data["t"]
        assert found.all()
        assert len(set(versions)) == 1
        assert set(int(p) for p in payloads) <= set(range(versions[0] + 1))
    assert sim.engine.stats.delta_publishes > 0
    assert sim.metrics.mixed_version_batches == 0
    want = np.zeros(n, dtype=np.uint64)
    for vv in range(1, sim.current_version + 1):
        upserts, _ = deltas(vv)
        sel, pays = upserts["t"]
        want[sel.astype(np.int64) - 1] = pays
    res = sim.engine.query({"t": keys}, version=sim.current_version,
                           strict=True)
    assert (res["t"].payloads == want).all()


def test_cluster_sim_data_plane_serves_embedding_tables(pkg):
    n = 128
    keys = np.arange(1, n + 1, dtype=np.uint64)
    rows = np.tile(np.arange(n, dtype=np.uint8)[:, None], (1, 8))

    def tables(version):
        return ([pkg.eng.ScalarTable("s", keys,
                                     np.full(n, version, dtype=np.uint64))],
                [pkg.eng.EmbeddingTable("e", keys,
                                        (rows + version).astype(np.uint8))])

    sim = sim_of(pkg, pkg.cs.SimConfig(n_shards=2, n_replicas=2, seed=1),
                 tables_for_version=tables)
    ok, versions, _lat, data = sim.query_batch(
        {"s": keys[:32], "e": keys[:32]})
    assert ok
    f_s, payloads = data["s"]
    f_e, values = data["e"]
    assert f_s.all() and f_e.all()
    assert payloads.dtype == np.uint64 and payloads.shape == (32,)
    assert values.dtype == np.uint8 and values.shape == (32, 8)
    assert (values == rows[:32] + versions[0]).all()


# ---------------------------------------------------------------------------
# run_update_experiment: equal ClusterMetrics across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("protocol", ["paper", "naming"])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_update_experiment_metrics_equal_across_packages(seed, protocol):
    cfg_kw = dict(straggler_prob=0.05, fail_prob_per_update=0.1,
                  repair_us=20_000_000)
    got = {}
    for name, pkg in PKGS.items():
        got[name] = dataclasses.asdict(pkg.cs.run_update_experiment(
            8.0, protocol, duration_s=120.0, qps=25.0, seed=seed,
            cfg=pkg.cs.SimConfig(**cfg_kw)))
    assert got["jax"] == got["torch"]
    assert got["torch"]["queries"] > 0 and got["torch"]["hedges"] > 0


# ---------------------------------------------------------------------------
# tests/test_store_subsystem.py: TestBatchQueryService, TestConsistency,
# TestClusterSim, once per package
# ---------------------------------------------------------------------------
class TestBatchQueryService:
    def test_route_and_merge(self, pkg):
        keys = np.arange(1, 3001, dtype=np.uint64)
        payloads = (keys * np.uint64(3)) & np.uint64((1 << 52) - 1)
        svc = pkg.bq.BatchQueryService(keys, payloads, max_shard_bytes=8192,
                                       **pkg.kw)
        assert svc.n_shards > 1
        rng = np.random.default_rng(0)
        q = keys[rng.choice(len(keys), 500)]
        f, p = svc.query(q)
        assert f.all() and (p == (q * np.uint64(3))).all()

    @pytest.mark.parametrize("variant", ["neighborhash", "coalesced",
                                         "linear"])
    def test_answers_and_stats_equal_across_packages(self, variant):
        """Both packages' services on the same rows answer hits, misses and
        an empty batch bitwise alike, with equal stats; the port packs each
        shard once, at its first batch."""
        from repro.core import neighborhash as jnh
        rng = np.random.default_rng(5)
        keys, payloads = jnh.random_kv(3000, seed=5)
        j = jbq.BatchQueryService(keys, payloads, max_shard_bytes=1 << 14,
                                  variant=variant)
        t = tbq.BatchQueryService(keys, payloads, max_shard_bytes=1 << 14,
                                  variant=variant, device="cpu")
        packed = []
        device_table = nl.device_table
        nl.device_table = lambda a, **kw: packed.append(1) or \
            device_table(a, **kw)
        try:
            for b in range(4):
                q = np.concatenate([
                    keys[rng.integers(0, len(keys), 400)],
                    rng.integers(2**62, 2**63, 100, dtype=np.uint64)])
                for (jf, jp), (tf, tp) in [(j.query(q), t.query(q)),
                                           (j.query(q[:0]), t.query(q[:0]))]:
                    np.testing.assert_array_equal(tf, jf)
                    np.testing.assert_array_equal(tp, jp)
        finally:
            nl.device_table = device_table
        assert len(packed) == t.n_shards
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)


def _make_cluster(pkg, n_shards=4, n_replicas=3, n_keys=500):
    keys = np.arange(1, n_keys + 1, dtype=np.uint64)
    payloads = keys.astype(np.uint64)[:, None]
    plan = pkg.sh.plan_shards(pkg.sh.TableSpec("t", n_keys, 16),
                              n_keys * 16 // n_shards)
    reps = [[pkg.ver.ShardReplica(s, r) for r in range(n_replicas)]
            for s in range(plan.n_shards)]
    parts = plan.partition(keys)
    for s, rows in enumerate(parts):
        g = pkg.ver.Generation(1, keys[rows], payloads[rows])
        for r in reps[s]:
            r.publish(g)
    return keys, payloads, plan, reps, parts


class TestConsistency:
    def test_strong_version_through_rolling_update(self, pkg):
        keys, payloads, plan, reps, parts = _make_cluster(pkg)
        client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                               enforce=True)
        new_gens = [pkg.ver.Generation(2, keys[rows], payloads[rows] + 100)
                    for rows in parts]
        for ev in pkg.ver.rolling_update(reps, new_gens):
            f, vals, versions = client.query(keys[:64])
            assert f.all()
            assert len(set(versions)) == 1, ev
        _, vals, versions = client.query(keys[:64])
        assert set(versions) == {2}
        assert (vals[:, 0] == payloads[:64, 0] + 100).all()

    def test_replica_loss_tolerated(self, pkg):
        keys, payloads, plan, reps, parts = _make_cluster(pkg)
        for s in range(plan.n_shards):
            reps[s][0].serving = False
        client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                               enforce=True)
        f, _, versions = client.query(keys[:32])
        assert f.all() and len(set(versions)) == 1

    @pytest.mark.parametrize("name", sorted(PKGS))
    @given(st.integers(0, 10000))
    @settings(max_examples=20, deadline=None)
    def test_property_never_mixed(self, name, seed):
        pkg = PKGS[name]
        rng = np.random.default_rng(seed)
        keys, payloads, plan, reps, parts = _make_cluster(pkg)
        client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                               enforce=True)
        version = 2
        updates = []
        for _ in range(3):
            gens = [pkg.ver.Generation(version, keys[rows],
                                       payloads[rows] + version)
                    for rows in parts]
            updates.append(pkg.ver.rolling_update(reps, gens))
            version += 1
        live = list(updates)
        answered = 0
        while live:
            g = live[rng.integers(0, len(live))]
            try:
                next(g)
            except StopIteration:
                live.remove(g)
            q = keys[rng.choice(len(keys), 16)]
            f, _, versions = client.query(q)
            if not f.any():
                continue
            answered += 1
            assert f.all()
            assert len(set(versions)) == 1
        assert answered > 0


class TestClusterSim:
    def test_fig10_trend(self, pkg):
        rates = []
        for interval in (120, 30):
            m = pkg.cs.run_update_experiment(interval, "naming",
                                             duration_s=400, qps=20, seed=2)
            rates.append(m.mixed_rate)
        assert rates[1] > rates[0] > 0
        m_paper = pkg.cs.run_update_experiment(30, "paper", duration_s=400,
                                               qps=20, seed=2)
        assert m_paper.mixed_rate == 0.0

    def test_paper_updates_faster(self, pkg):
        m_p = pkg.cs.run_update_experiment(300, "paper", duration_s=400,
                                           qps=5, seed=3)
        m_n = pkg.cs.run_update_experiment(300, "naming", duration_s=400,
                                           qps=5, seed=3)
        assert m_p.update_wall_us < m_n.update_wall_us

    def test_hedging_caps_stragglers(self, pkg):
        cfg = pkg.cs.SimConfig(straggler_prob=0.05, seed=4)
        hedged = pkg.cs.run_update_experiment(1000, "paper", duration_s=200,
                                              qps=50, seed=4, cfg=cfg)
        no_hedge = pkg.cs.run_update_experiment(
            1000, "paper", duration_s=200, qps=50, seed=4,
            cfg=pkg.cs.SimConfig(straggler_prob=0.05, seed=4,
                                 hedge_deadline_us=10**9))
        assert hedged.hedges > 0
        assert hedged.latency_quantile(0.90) < 2 * cfg.hedge_deadline_us
        assert no_hedge.latency_quantile(0.90) > cfg.straggler_latency_us \
            or hedged.latency_quantile(0.99) <= \
            no_hedge.latency_quantile(0.99)

    def test_crash_during_update_survives(self, pkg):
        cfg = pkg.cs.SimConfig(fail_prob_per_update=0.2, seed=5)
        m = pkg.cs.run_update_experiment(60, "paper", duration_s=400, qps=10,
                                         seed=5, cfg=cfg)
        assert m.queries > 0
        assert m.failures < m.queries * 0.025
        assert m.mixed_version_batches == 0


# ---------------------------------------------------------------------------
# tests/test_publish_and_launchers.py::TestDeltaPublisher, once per package
# ---------------------------------------------------------------------------
class TestDeltaPublisher:
    def _fleet(self, pkg, n_rows=500, n_shards_bytes=2048):
        plan = pkg.sh.plan_shards(pkg.sh.TableSpec("emb", n_rows, 16),
                                  n_shards_bytes)
        reps = [[pkg.ver.ShardReplica(s, r) for r in range(2)]
                for s in range(plan.n_shards)]
        keys = np.arange(n_rows, dtype=np.uint64)
        table = np.arange(n_rows, dtype=np.float32)[:, None] * np.ones(4)
        parts = plan.partition(keys)
        for s, rows in enumerate(parts):
            for rep in reps[s]:
                rep.publish(pkg.ver.Generation(1, keys[rows], table[rows]))
        return plan, reps, keys, table

    def test_touched_rows_reach_serving(self, pkg):
        plan, reps, keys, table = self._fleet(pkg)
        pub = pkg.pub.DeltaPublisher(plan, reps)
        client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                               enforce=True)
        table[10:40] += 1000.0
        pub.touch(np.arange(10, 40))
        v = pub.publish(lambda rows: table[rows])
        assert v == 2 and pub.stats.rows_published == 30
        f, vals, versions = client.query(keys[10:40])
        assert f.all() and set(versions) == {2}
        assert (vals[:, 0] >= 1000).all()

    def test_consistency_during_publish(self, pkg):
        plan, reps, keys, table = self._fleet(pkg)
        pub = pkg.pub.DeltaPublisher(plan, reps)
        client = pkg.ver.ConsistentBatchClient(reps, plan.shard_of,
                                               enforce=True)
        pub.touch(np.arange(0, 200))

        def interleave(ev):
            f, _, versions = client.query(keys[:64])
            assert f.all()
            assert len(set(versions)) == 1, ev

        pub.publish(lambda rows: table[rows], interleave=interleave)
        assert pub.stats.rolling_steps > 0

    def test_empty_publish_is_noop(self, pkg):
        plan, reps, keys, table = self._fleet(pkg)
        pub = pkg.pub.DeltaPublisher(plan, reps)
        assert pub.publish(lambda rows: table[rows]) == 1
        assert pub.stats.publishes == 0

    def test_stats_and_generations_equal_across_packages(self):
        """The same touches and publishes give both packages equal stats,
        versions, and every replica's generations bitwise."""
        out = {}
        for name, pkg in PKGS.items():
            plan, reps, keys, table = self._fleet(pkg)
            pub = pkg.pub.DeltaPublisher(plan, reps)
            rng = np.random.default_rng(8)
            versions = []
            for _ in range(3):
                pub.touch(rng.integers(-5, 500, 60))
                table[:] += 1.0
                versions.append(pub.publish(lambda rows: table[rows]))
            gens = [[(v, g.keys.copy(), np.asarray(g.values).copy())
                     for v in rep.versions
                     for g in [rep.window.get(v)[2]]]
                    for shard in reps for rep in shard]
            out[name] = (dataclasses.asdict(pub.stats), versions, gens)
        (js, jv, jg), (ts, tv, tg) = out["jax"], out["torch"]
        assert js == ts and jv == tv and len(jg) == len(tg)
        for a, b in zip(jg, tg):
            assert [x[0] for x in a] == [x[0] for x in b]
            for (_, ka, va), (_, kb, vb) in zip(a, b):
                np.testing.assert_array_equal(kb, ka)
                np.testing.assert_array_equal(vb, va)


# ---------------------------------------------------------------------------
# tests/test_engine.py::test_fused_matches_three_independent_services
# ---------------------------------------------------------------------------
SHARD_BYTES = 1 << 17


@pytest.fixture(scope="module")
def engine_dataset():
    from repro.core import neighborhash as jnh
    rng = np.random.default_rng(0)
    item_keys, item_payloads = jnh.random_kv(20_000, seed=1)
    cat_keys, cat_payloads = jnh.random_kv(3_000, seed=2)
    emb_keys = np.arange(1, 5_001, dtype=np.uint64)
    emb_values = rng.integers(0, 255, size=(5_000, 32), dtype=np.uint8)
    return item_keys, item_payloads, cat_keys, cat_payloads, emb_keys, \
        emb_values


def test_fused_matches_three_independent_services(pkg, engine_dataset):
    ik, ip, ck, cp, ek, ev = engine_dataset
    engine = pkg.eng.MultiTableEngine(
        scalars=[pkg.eng.ScalarTable("item_attr", ik, ip),
                 pkg.eng.ScalarTable("cat_attr", ck, cp)],
        embeddings=[pkg.eng.EmbeddingTable("item_emb", ek, ev,
                                           hot_fraction=0.2)],
        max_shard_bytes=SHARD_BYTES, **pkg.kw)
    rng = np.random.default_rng(7)
    req = {"item_attr": ik[zipf_ids(rng, len(ik), 4096).astype(np.int64)],
           "cat_attr": ck[zipf_ids(rng, 300, 4096).astype(np.int64)],
           "item_emb": ek[zipf_ids(rng, len(ek), 2048).astype(np.int64)]}
    req["item_attr"] = np.concatenate(
        [req["item_attr"],
         rng.integers(2**62, 2**63, 64).astype(np.uint64)])
    res = engine.query(req)
    svc_item = pkg.bq.BatchQueryService(ik, ip, max_shard_bytes=SHARD_BYTES,
                                        **pkg.kw)
    svc_cat = pkg.bq.BatchQueryService(ck, cp, max_shard_bytes=SHARD_BYTES,
                                       **pkg.kw)
    store = pkg.hs.HybridKVStore(ek, ev.copy(), hot_fraction=0.2)
    f1, p1 = svc_item.query(req["item_attr"])
    f2, p2 = svc_cat.query(req["cat_attr"])
    f3, v3 = store.get_batch(req["item_emb"])
    assert (res["item_attr"].found == f1).all()
    assert (res["item_attr"].payloads == p1).all()
    assert (res["cat_attr"].found == f2).all()
    assert (res["cat_attr"].payloads == p2).all()
    assert (res["item_emb"].found == f3).all()
    assert (res["item_emb"].values == v3).all()
    assert engine.stats.keys_deviceside < engine.stats.keys_requested
    assert engine.stats.dedup_rate > 0.2
    build = engine.window.get(None)[2]
    assert engine.stats.launches <= build.n_shards


# ---------------------------------------------------------------------------
# tests/test_feature_api.py's ClusterSim cases, once per package
# ---------------------------------------------------------------------------
N_KEYS = 2_000


@pytest.fixture(scope="module")
def api_dataset():
    rng = np.random.default_rng(0)
    keys = np.arange(1, N_KEYS + 1, dtype=np.uint64)
    payloads = rng.integers(0, 1 << 50, N_KEYS).astype(np.uint64)
    values = rng.integers(0, 255, (N_KEYS, 16), dtype=np.uint8)
    return keys, payloads, values


def test_same_request_round_trips_all_three(pkg, api_dataset):
    keys, _, values = api_dataset
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.choice(keys, 64), keys[:8],
                        rng.integers(2**62, 2**63, 5, dtype=np.uint64)])
    eng = pkg.eng.MultiTableEngine(
        embeddings=[pkg.eng.EmbeddingTable("e", keys, values,
                                           hot_fraction=0.3)],
        max_shard_bytes=1 << 15, version=1, **pkg.kw)
    store = pkg.api.StoreBackend(
        {"e": pkg.hs.HybridKVStore(keys, values, hot_fraction=0.3)})
    sim = sim_of(pkg, pkg.cs.SimConfig(n_shards=2, n_replicas=2, seed=0),
                 protocol="paper", tables_for_version=lambda v: (
                     [], [pkg.eng.EmbeddingTable("e", keys, values,
                                                 hot_fraction=0.3)]))
    oracle = set(keys.tolist())
    try:
        responses = {}
        for name, target in (("engine", eng), ("store", store),
                             ("cluster", sim)):
            res = pkg.api.FeatureClient(target).query({"e": q})
            assert isinstance(res, pkg.api.QueryResponse)
            for k, f, v in zip(q.tolist(), res["e"].found, res["e"].values):
                assert (k in oracle) == bool(f)
                if f:
                    assert (values[k - 1] == v).all()
            responses[name] = res
        a, b, c = responses.values()
        assert (a["e"].found == b["e"].found).all()
        assert (a["e"].values == b["e"].values).all()
        assert (a["e"].found == c["e"].found).all()
        assert (a["e"].values == c["e"].values).all()
    finally:
        sim.close()


def test_cluster_backend_update_and_pin(pkg, api_dataset):
    keys, _, _ = api_dataset

    def tables(v):
        return ([pkg.eng.ScalarTable("s", keys,
                                     np.full(N_KEYS, v + 1,
                                             dtype=np.uint64))], [])

    sim = sim_of(pkg, pkg.cs.SimConfig(n_shards=2, n_replicas=2, seed=1),
                 protocol="paper", tables_for_version=tables)
    try:
        client = pkg.api.FeatureClient(pkg.api.ClusterBackend(sim))
        assert client.query({"s": keys[:16]}).version == 0
        s1, e1 = tables(1)
        client.update(1, scalars=s1, embeddings=e1)
        res = client.query({"s": keys[:16]})
        assert res.version == 1 and (res["s"].payloads == 2).all()
        old = client.query({"s": keys[:16]},
                           consistency=pkg.api.Consistency.pinned(0))
        assert old.version == 0 and (old["s"].payloads == 1).all()
    finally:
        sim.close()


def test_cluster_sim_device_reaches_the_engine():
    keys = np.arange(1, 65, dtype=np.uint64)
    sim = tcs.ClusterSim(
        tcs.SimConfig(n_shards=2, n_replicas=2), device="cpu",
        tables_for_version=lambda v: (
            [teng.ScalarTable("s", keys, keys + np.uint64(v))], []))
    assert sim.engine.device.type == "cpu"
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcs.ClusterSim(tcs.SimConfig(), tables_for_version=lambda v: (
                [teng.ScalarTable("s", keys, keys)], []))
