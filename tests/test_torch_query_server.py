"""The port's ``QueryServer`` (``serve/server.py``, ``serve/scheduler.py``)
and tracer (``obs/trace.py``) against the JAX package's, on the CPU.

Every scenario runs twice, once per package: the JAX ``QueryServer`` over
the JAX ``MultiTableEngine``, and the port's over the port's engine on the
CPU, each built from the same seeded numpy data.  They are the non-slow
scenarios of ``tests/test_query_server.py`` (scatter-back against a dict
oracle under concurrent clients, coalescing, the one-version-per-micro-batch
invariant under ``publish_delta``, the strict pin, typed shedding and
deadlines, close and drain, a bad table among co-batched requests, delta
failure recovery), the ``QueryServer`` scenarios of
``tests/test_feature_api.py`` (constructor and policy validation, stats
edge cases, a ``StoreBackend`` behind a server, the QoS lanes, a
``min_version`` read) and the tracer tests and server span chain of
``tests/test_observability.py``.  Integer answers are compared bitwise, with
the dict oracle in each package and between the two packages where the
answers do not depend on timing; a timing-driven case asserts the same
contract in both, not equal timings.

``tests/test_query_server.py::TestClusterSimIntegration`` runs here too,
over each package's own ``ClusterSim`` (``core/cluster_sim.py``) with a
``QueryServer`` in front of its engine data plane; the two packages' sims,
from the same seed, answer every batch alike, bitwise.
"""
import math
import sys
import threading
import time
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as japi
from repro.core import cluster_sim as jcs
from repro.core import engine as jeng
from repro.core.hybrid_store import HybridKVStore as JStore
from repro.obs import trace as jtrace
from repro.serve import scheduler as jsched
from repro.serve import server as jserver
import repro_torch.api as tapi
from repro_torch.core import cluster_sim as tcs
from repro_torch.core import engine as teng
from repro_torch.core.hybrid_store import HybridKVStore as TStore
from repro_torch.obs import trace as ttrace
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import server as tserver

SHARD_BYTES = 1 << 15
N_KEYS = 2_000
VALUE_BYTES = 16

PKGS = {
    "jax": types.SimpleNamespace(name="jax", api=japi, eng=jeng, Store=JStore,
                                 trace=jtrace, sched=jsched, server=jserver,
                                 cs=jcs, engine_kw={}),
    "torch": types.SimpleNamespace(name="torch", api=tapi, eng=teng,
                                   Store=TStore, trace=ttrace, sched=tsched,
                                   server=tserver, cs=tcs,
                                   engine_kw={"device": "cpu"}),
}


def make_engine(pkg, scalars=(), embeddings=(), **kw):
    return pkg.eng.MultiTableEngine(list(scalars), list(embeddings),
                                    **pkg.engine_kw, **kw)


def server_of(pkg, backend, policy=None, **kw):
    return pkg.server.QueryServer(backend, policy, **kw)


def policy(pkg, **kw):
    return pkg.sched.BatchPolicy(**kw)


def submit(pkg, server, tables, **kw):
    return pkg.api.FeatureClient(server).submit(tables, **kw)


def query(pkg, server, tables, *, timeout=None, **kw):
    return pkg.api.FeatureClient(server).query(tables, timeout=timeout, **kw)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    keys = np.arange(1, N_KEYS + 1, dtype=np.uint64)
    payloads = rng.integers(0, 1 << 50, N_KEYS).astype(np.uint64)
    values = rng.integers(0, 255, (N_KEYS, VALUE_BYTES), dtype=np.uint8)
    return keys, payloads, values


@pytest.fixture(scope="module", params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _dataset_engine(pkg, dataset):
    keys, payloads, values = dataset
    eng = make_engine(
        pkg, [pkg.eng.ScalarTable("s", keys, payloads)],
        [pkg.eng.EmbeddingTable("e", keys, values, hot_fraction=0.3)],
        max_shard_bytes=SHARD_BYTES, version=1)
    # warm the JAX engine's fused-launch pad shapes (its jit compiles), so
    # the deadline cases do not read a first compile as slow service
    for n in (8, 64, 256, 1024):
        eng.query({"s": keys[:n], "e": keys[:max(n // 2, 1)]})
    return eng


@pytest.fixture(scope="module")
def engine(pkg, dataset):
    return _dataset_engine(pkg, dataset)


@pytest.fixture(scope="module")
def both_engines(dataset):
    return {name: _dataset_engine(p, dataset) for name, p in PKGS.items()}


def _mixed_request(rng, keys, n=64):
    """Hits + guaranteed misses, with duplicates."""
    q = rng.choice(keys, n)
    q = np.concatenate([q, q[:8],
                        rng.integers(2**62, 2**63, 6, dtype=np.uint64)])
    return {"s": q, "e": q[: n // 2]}


def _answer(res):
    """A response's integer answers, for bitwise comparison."""
    return {name: (np.asarray(tr.found).copy(),
                   None if tr.payloads is None else np.asarray(tr.payloads),
                   None if tr.values is None else np.asarray(tr.values))
            for name, tr in res.tables.items()}


def _assert_same_answers(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        for x, y in zip(a[name], b[name]):
            if x is None or y is None:
                assert x is None and y is None
            else:
                np.testing.assert_array_equal(x, y)


def _join_all(threads, timeout=120):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


class _SlowBackend:
    """Protocol-satisfying backend whose begin() stalls: stages a request
    in flight so close-timeout behaviour is observable."""

    name = "slow"

    def __init__(self, pkg, delay_s: float):
        self.pkg = pkg
        self.delay_s = delay_s
        self.began = False

    @property
    def latest_version(self) -> int:
        return 1

    @property
    def table_names(self):
        return ["s"]

    def begin(self, tables, *, version=None, strict=False):
        self.began = True
        time.sleep(self.delay_s)
        n = sum(len(k) for k in tables.values())
        return types.SimpleNamespace(tables=tables, keys_requested=n,
                                     keys_deviceside=n, launches=1)

    def finish(self, inflight):
        tables = {name: self.pkg.eng.TableResult(
            found=np.ones(len(keys), dtype=bool),
            payloads=np.asarray(keys, dtype=np.uint64))
            for name, keys in inflight.tables.items()}
        return self.pkg.eng.QueryResult(version=1, tables=tables)

    def apply_update(self, update):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# scatter-back and coalescing (tests/test_query_server.py::TestScatterBack)
# ---------------------------------------------------------------------------
def _concurrent_answers(pkg, engine, dataset, clients=8, per_client=6):
    """The dict-oracle scenario: ``clients`` threads, each ``per_client``
    mixed requests; every slice held against the oracle.  -> answers by
    (client, request) and the server's snapshot."""
    keys, payloads, values = dataset
    oracle = dict(zip(keys.tolist(), payloads.tolist()))
    errors, answers = [], {}

    with server_of(pkg, engine, policy(pkg, max_wait_s=0.003)) as server:
        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                for i in range(per_client):
                    req = _mixed_request(rng, keys)
                    res = query(pkg, server, req)
                    for k, f, p in zip(req["s"].tolist(), res["s"].found,
                                       res["s"].payloads):
                        assert (k in oracle) == bool(f)
                        if f:
                            assert oracle[k] == int(p)
                    for k, f, v in zip(req["e"].tolist(), res["e"].found,
                                       res["e"].values):
                        assert (k in oracle) == bool(f)
                        if f:
                            assert (values[k - 1] == v).all()
                    answers[(seed, i)] = _answer(res)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert not errors, errors[:3]
        snap = server.stats_snapshot()
    return answers, snap


def test_dict_oracle_under_concurrent_clients(pkg, dataset, engine):
    """Every per-request slice of every fused micro-batch matches the
    plain-dict oracle, however the requests were coalesced."""
    _, snap = _concurrent_answers(pkg, engine, dataset)
    assert snap.completed == 8 * 6
    assert snap.failed == 0 and snap.shed_rate == 0.0
    assert snap.batches < snap.completed          # requests coalesced


def test_concurrent_answers_equal_across_packages(dataset, both_engines):
    """The same requests from 8 concurrent clients get bitwise the same
    answers from both packages' servers, whatever micro-batches they
    rode."""
    got = {name: _concurrent_answers(PKGS[name], eng, dataset)[0]
           for name, eng in both_engines.items()}
    assert sorted(got["jax"]) == sorted(got["torch"])
    for key in got["jax"]:
        _assert_same_answers(got["jax"][key], got["torch"][key])


def _prequeued(pkg, engine, keys):
    server = server_of(pkg, engine, policy(pkg, max_wait_s=0.01),
                       start=False)
    tickets = [submit(pkg, server, {"s": keys[i * 10:i * 10 + 20]})
               for i in range(10)]
    server.start()
    try:
        return [t.result(timeout=30) for t in tickets], tickets
    finally:
        server.close()


def test_coalescing_deterministic_when_prequeued(pkg, dataset, engine):
    """Requests queued before the scheduler starts fuse into few
    micro-batches (occupancy > 1) and still scatter back correctly."""
    keys, payloads, _ = dataset
    results, tickets = _prequeued(pkg, engine, keys)
    for i, res in enumerate(results):
        assert (res["s"].payloads == payloads[i * 10:i * 10 + 20]).all()
    assert len({t.batch_id for t in tickets}) < len(tickets)


def test_prequeued_batches_and_answers_equal_across_packages(dataset,
                                                             both_engines):
    """Pre-queued requests coalesce into the same micro-batches in both
    packages, with bitwise the same answers and versions."""
    keys = dataset[0]
    runs = {name: _prequeued(PKGS[name], eng, keys)
            for name, eng in both_engines.items()}
    (jres, jt), (tres, tt) = runs["jax"], runs["torch"]
    assert [t.batch_id for t in jt] == [t.batch_id for t in tt]
    for a, b in zip(jres, tres):
        assert a.version == b.version
        _assert_same_answers(_answer(a), _answer(b))


@settings(deadline=None, max_examples=12, database=None)
@given(sizes=st.lists(st.integers(0, 300), min_size=1, max_size=8),
       seed=st.integers(0, 2**16))
def test_prequeued_scatter_back_equal_across_packages(both_engines, dataset,
                                                      sizes, seed):
    """Any pre-queued mix of request sizes (empty ones too, duplicates and
    misses) coalesces into the same micro-batches of at most 512 keys in
    both packages, and each request's slice equals the engine's direct
    answer to it, bitwise, in both."""
    keys = dataset[0]
    rng = np.random.default_rng(seed)
    reqs = [{"s": np.concatenate([rng.choice(keys, n), rng.integers(
        2**62, 2**63, n // 7, dtype=np.uint64)])} for n in sizes]
    got = {}
    for name, eng in both_engines.items():
        pkg = PKGS[name]
        server = server_of(pkg, eng, policy(pkg, max_wait_s=0.005,
                                            max_batch_keys=512), start=False)
        tickets = [submit(pkg, server, r) for r in reqs]
        server.start()
        try:
            res = [t.result(timeout=30) for t in tickets]
        finally:
            server.close()
        for r, a in zip(reqs, res):
            _assert_same_answers(_answer(a), _answer(eng.query(r)))
        got[name] = ([t.batch_id for t in tickets], res)
    assert got["jax"][0] == got["torch"][0]
    for a, b in zip(got["jax"][1], got["torch"][1]):
        _assert_same_answers(_answer(a), _answer(b))


# ---------------------------------------------------------------------------
# version pinning (tests/test_query_server.py::TestVersionPinning)
# ---------------------------------------------------------------------------
def _versions_under_publish(pkg, *, classes, n_keys, per_client, batch_keys,
                            max_v, via_client):
    """Payloads encode the publishing version for every key, so a response
    whose found payloads are not all one value, or not its own version,
    proves a mixed-version micro-batch.  A publisher ships deltas as fast
    as it can while 6 clients query.  -> (batch id, version) pairs."""
    keys = np.arange(1, n_keys + 1, dtype=np.uint64)
    eng = make_engine(pkg, [pkg.eng.ScalarTable(
        "s", keys, np.full(n_keys, 1, dtype=np.uint64))],
        max_shard_bytes=1 << 13, version=1)
    for n in (8, 64, 256, 512):
        eng.query({"s": keys[:n]})
    stop = threading.Event()
    publish_err, errors, observed = [], [], []
    with server_of(pkg, eng, policy(pkg, max_wait_s=0.002)) as server:
        session = pkg.api.FeatureClient(server)

        def publisher():
            v = 2
            try:
                while not stop.is_set() and v < max_v:
                    upserts = {"s": (keys, np.full(n_keys, v,
                                                   dtype=np.uint64))}
                    if via_client:
                        session.update(v, upserts=upserts)
                    else:
                        eng.publish_delta(v, upserts=upserts)
                    v += 1
            except Exception as e:  # noqa: BLE001
                publish_err.append(e)

        pub = threading.Thread(target=publisher)
        pub.start()

        def run(cid):
            rng = np.random.default_rng(cid)
            try:
                for _ in range(per_client):
                    t = session.submit({"s": rng.choice(keys, batch_keys)},
                                       qos=classes[cid % len(classes)])
                    res = t.result(timeout=60)
                    vals = set(res["s"].payloads[res["s"].found].tolist())
                    assert len(vals) == 1, f"mixed batch: {vals}"
                    assert vals == {res.version}
                    assert res.batch_id == t.batch_id
                    observed.append((t.batch_id, res.version))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
        stop.set()
        _join_all([pub])
    assert not errors, errors[:3]
    assert not publish_err, publish_err[:1]
    return observed


def _assert_one_version_a_batch(observed):
    by_batch: dict = {}
    for bid, v in observed:
        by_batch.setdefault(bid, set()).add(v)
    assert all(len(vs) == 1 for vs in by_batch.values())
    assert len({v for _, v in observed}) >= 2     # pinning exercised


def test_no_micro_batch_mixes_versions_under_publish_delta(pkg):
    observed = _versions_under_publish(
        pkg, classes=["RANKING"], n_keys=500, per_client=25, batch_keys=40,
        max_v=200, via_client=False)
    _assert_one_version_a_batch(observed)


def test_no_mixed_version_across_lanes_under_publish_delta(pkg):
    """The single-version invariant holds in every lane while a publisher
    ships deltas through the client."""
    observed = _versions_under_publish(
        pkg, classes=["RANKING", "RETRIEVAL", "PREFETCH"], n_keys=400,
        per_client=20, batch_keys=32, max_v=150, via_client=True)
    _assert_one_version_a_batch(observed)


def test_strict_pin_to_evicted_version_fails_typed(pkg, dataset):
    keys, _, _ = dataset
    eng = make_engine(pkg, [pkg.eng.ScalarTable(
        "s", keys, np.ones(len(keys), dtype=np.uint64))],
        max_shard_bytes=SHARD_BYTES, retain=2, version=1)
    eng.publish_delta(2, upserts={})
    eng.publish_delta(3, upserts={})            # v1 evicted
    with server_of(pkg, eng) as server:
        with pytest.raises(pkg.eng.VersionEvictedError):
            query(pkg, server, {"s": keys[:8]},
                  consistency=pkg.api.Consistency.pinned(1))
        res = query(pkg, server, {"s": keys[:8]},
                    consistency=pkg.api.Consistency.hinted(1))
        assert res.version == 3                 # non-strict re-pins


def test_min_version_read_your_writes(pkg, dataset):
    keys, payloads, _ = dataset
    eng = make_engine(pkg, [pkg.eng.ScalarTable("s", keys, payloads)],
                      max_shard_bytes=SHARD_BYTES, version=1)
    with server_of(pkg, eng, policy(pkg, max_wait_s=0.0)) as server:
        client = pkg.api.FeatureClient(server)
        new_pay = payloads[:16] + np.uint64(1)
        client.update(2, upserts={"s": (keys[:16], new_pay)})
        res = client.query({"s": keys[:16]},
                           consistency=pkg.api.Consistency.min_version(2),
                           timeout=30)
        assert res.version >= 2
        np.testing.assert_array_equal(res["s"].payloads, new_pay)
        with pytest.raises(pkg.api.ConsistencyError):
            client.query({"s": keys[:8]},
                         consistency=pkg.api.Consistency.min_version(99),
                         timeout=30)


# ---------------------------------------------------------------------------
# shedding, deadlines, close (TestSheddingAndDeadlines)
# ---------------------------------------------------------------------------
def test_queue_full_is_typed_backpressure(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, policy(pkg, max_queue_requests=4),
                       start=False)
    try:
        for _ in range(4):
            submit(pkg, server, {"s": keys[:8]})
        with pytest.raises(pkg.sched.QueueFullError):
            submit(pkg, server, {"s": keys[:8]})
        assert server.stats_snapshot().shed_queue_full == 1
    finally:
        server.close()


def test_budget_below_service_estimate_shed_at_admission(pkg, dataset,
                                                         engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, policy(pkg, service_time_init_s=0.05),
                       start=False)
    try:
        with pytest.raises(pkg.sched.DeadlineError):
            submit(pkg, server, {"s": keys[:8]}, budget_s=0.001)
        assert server.stats_snapshot().shed_deadline == 1
    finally:
        server.close()


def test_expired_in_queue_fails_ticket(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, policy(pkg, service_time_init_s=1e-4),
                       start=False)
    try:
        ticket = submit(pkg, server, {"s": keys[:8]}, budget_s=0.01)
        time.sleep(0.05)                     # deadline passes while queued
        server.start()
        with pytest.raises(pkg.sched.DeadlineError):
            ticket.result(timeout=30)
        assert server.stats_snapshot().shed_deadline == 1
    finally:
        server.close()


def test_keys_saturated_batch_closes_immediately(pkg, dataset, engine):
    """A batch that cannot admit the next waiting request (key budget
    full) closes at once, not after max_wait_s."""
    keys, _, _ = dataset
    server = server_of(pkg, engine,
                       policy(pkg, max_batch_keys=500, max_wait_s=3.0),
                       start=False)
    try:
        tickets = [submit(pkg, server, {"s": keys[i * 240:(i + 1) * 240]})
                   for i in range(4)]
        server.start()
        for t in tickets:
            t.result(timeout=30)
        assert tickets[0].batch_id == tickets[1].batch_id
        assert tickets[0].latency_s < 2.0
        assert tickets[1].latency_s < 2.0
    finally:
        server.close()


def test_lone_request_closes_on_max_wait(pkg, dataset, engine):
    keys, payloads, _ = dataset
    with server_of(pkg, engine, policy(pkg, max_wait_s=0.002)) as server:
        t0 = time.perf_counter()
        res = query(pkg, server, {"s": keys[:16]}, timeout=30)
        np.testing.assert_array_equal(res["s"].payloads, payloads[:16])
        assert time.perf_counter() - t0 < 10.0


def test_closed_server_rejects(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine)
    server.close()
    with pytest.raises(pkg.sched.ShedError):
        submit(pkg, server, {"s": keys[:8]})


def test_close_without_start_fails_queued_tickets(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, start=False)
    ticket = submit(pkg, server, {"s": keys[:8]})
    server.close()
    with pytest.raises(pkg.sched.ShedError):
        ticket.result(timeout=5)


def test_close_drains_every_qos_lane_typed(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, start=False)
    tickets = [submit(pkg, server, {"s": keys[:8]}, qos=qos)
               for qos in ("RANKING", "RETRIEVAL", "PREFETCH")
               for _ in range(3)]
    server.close(timeout=5)
    for t in tickets:
        with pytest.raises(pkg.sched.ServerClosedError):
            t.result(timeout=5)


def test_close_honors_timeout_with_request_in_flight(pkg, dataset):
    keys, _, _ = dataset
    backend = _SlowBackend(pkg, delay_s=2.0)
    server = server_of(pkg, backend, policy(pkg, max_wait_s=0.0))
    ticket = submit(pkg, server, {"s": keys[:8]})
    deadline = time.perf_counter() + 2.0
    while not backend.began and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert backend.began
    t0 = time.perf_counter()
    server.close(timeout=0.3)
    assert time.perf_counter() - t0 < 1.5
    with pytest.raises(pkg.sched.ServerClosedError):
        ticket.result(timeout=5)


def test_close_waits_out_inflight_within_timeout(pkg, dataset):
    keys, _, _ = dataset
    backend = _SlowBackend(pkg, delay_s=0.15)
    server = server_of(pkg, backend, policy(pkg, max_wait_s=0.0))
    ticket = submit(pkg, server, {"s": keys[:8]})
    deadline = time.perf_counter() + 2.0
    while not backend.began and time.perf_counter() < deadline:
        time.sleep(0.001)
    server.close(timeout=10)
    res = ticket.result(timeout=5)
    np.testing.assert_array_equal(res["s"].payloads, keys[:8])


def test_close_joins_the_servers_threads(dataset):
    """The port's close joins the scheduler and every finish worker once
    nothing is in flight, so no thread of the server outlives it (on the
    card, none touches CUDA after close returns)."""
    keys, payloads, values = dataset
    pkg = PKGS["torch"]
    eng = _dataset_engine(pkg, dataset)
    server = server_of(pkg, eng, policy(pkg, max_wait_s=0.001), workers=3)
    for i in range(6):
        res = query(pkg, server, {"s": keys[i:i + 40]}, timeout=30)
        np.testing.assert_array_equal(res["s"].payloads, payloads[i:i + 40])
    threads = [server._scheduler] + list(server._pool._threads)
    assert threads[0].is_alive()
    server.close(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_bad_table_does_not_fail_cobatched_requests(pkg, dataset, engine):
    keys, payloads, _ = dataset
    server = server_of(pkg, engine, start=False)
    t_bad = submit(pkg, server, {"nope": keys[:4]})
    t_good = submit(pkg, server, {"s": keys[:16]})
    server.start()
    try:
        with pytest.raises(KeyError):
            t_bad.result(timeout=30)
        res = t_good.result(timeout=30)
        np.testing.assert_array_equal(res["s"].payloads, payloads[:16])
    finally:
        server.close()


def test_failed_embedding_delta_leaves_engine_retryable(pkg):
    """A publish_delta that raises mid-apply (bad row width) leaves the
    base build's stores writable: the corrected retry succeeds."""
    keys = np.arange(1, 101, dtype=np.uint64)
    values = np.full((100, 8), 7, dtype=np.uint8)
    eng = make_engine(pkg, embeddings=[pkg.eng.EmbeddingTable(
        "e", keys, values)], version=1)
    with pytest.raises(ValueError):
        eng.publish_delta(2, upserts={"e": (keys[:4], np.zeros(
            (4, 4), dtype=np.uint8))})
    assert eng.latest_version == 1
    eng.publish_delta(2, upserts={"e": (keys[:4], np.full(
        (4, 8), 9, dtype=np.uint8))})
    res = eng.query({"e": keys[:8]}, version=2)
    assert (res["e"].values[:4] == 9).all()
    assert (res["e"].values[4:] == 7).all()


def _sim_through_query_server(pkg):
    """``TestClusterSimIntegration``'s scenario: sim replicas serve real
    rows through a ``QueryServer`` while a rolling update publishes a new
    build.  Returns each batch's (versions, attr payloads, emb rows)."""
    cs = pkg.cs
    n = 600
    keys = np.arange(1, n + 1, dtype=np.uint64)

    def tables(v):
        return ([pkg.eng.ScalarTable("attr", keys,
                                     np.full(n, v + 10, dtype=np.uint64))],
                [pkg.eng.EmbeddingTable("emb", keys,
                                        np.full((n, 8), (v + 1) % 251,
                                                dtype=np.uint8))])

    sim = cs.ClusterSim(cs.SimConfig(n_shards=4, n_replicas=2, seed=3),
                        protocol="paper", tables_for_version=tables,
                        use_query_server=True, **pkg.engine_kw)
    batches = []
    try:
        assert sim.query_server is not None
        sim.start_rolling_update(1)

        def q():
            ok, versions, _lat, data = sim.query_batch(
                {"attr": keys[:64], "emb": keys[:32]})
            assert ok
            f, p = data["attr"]
            assert f.all()
            assert len(set(p.tolist())) == 1     # one version per batch
            fe, ve = data["emb"]
            assert fe.all()
            assert len(set(ve[:, 0].tolist())) == 1
            # cross-table: the embedding generation of the same version
            assert int(ve[0, 0]) == (int(p[0]) - 10 + 1) % 251
            batches.append((list(versions), p.copy(), ve.copy()))

        for t in range(0, 10_000_000, 600_000):
            sim.sim.at(t, q)
        sim.sim.run_until(10_000_000)
    finally:
        sim.close()
    assert sim.query_server is None
    return batches


def test_sim_data_plane_through_query_server(pkg):
    batches = _sim_through_query_server(pkg)
    seen = {int(p[0]) - 10 for _, p, _ in batches}
    assert seen == {0, 1}, seen              # both generations served


def test_sim_through_query_server_equal_across_packages():
    got = {name: _sim_through_query_server(p) for name, p in PKGS.items()}
    assert len(got["jax"]) == len(got["torch"]) > 0
    for (jv, jp, je), (tv, tp, te) in zip(got["jax"], got["torch"]):
        assert jv == tv
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(te, je)


def test_stress_many_threads_counts_reconcile(dataset):
    """More client threads than cores, a shortened switch interval: the
    server's and the engine's counts reconcile exactly (a lost update in
    either breaks an equality), and every answer is the oracle's."""
    keys, payloads, _ = dataset
    pkg = PKGS["torch"]
    eng = _dataset_engine(pkg, dataset)
    base = eng.stats.batches
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with server_of(pkg, eng, policy(pkg, max_wait_s=0.001)) as server:
            def client(seed):
                rng = np.random.default_rng(seed)
                try:
                    for _ in range(10):
                        i = rng.integers(0, N_KEYS, 24)
                        res = query(pkg, server, {"s": keys[i]}, timeout=60)
                        assert (res["s"].payloads == payloads[i]).all()
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(16)]
            for t in threads:
                t.start()
            _join_all(threads)
            snap = server.stats_snapshot()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert snap.submitted == snap.completed == 160
    assert sum(c.completed for c in snap.per_class.values()) == 160
    assert eng.stats.batches - base == snap.batches


# ---------------------------------------------------------------------------
# tests/test_feature_api.py: validation, stats, backends, QoS lanes
# ---------------------------------------------------------------------------
def test_batch_policy_validation(pkg):
    for bad in (dict(max_batch_keys=0), dict(max_batch_requests=0),
                dict(max_queue_requests=-1), dict(max_wait_s=-1e-3),
                dict(service_time_init_s=0.0), dict(service_time_alpha=0.0),
                dict(service_time_alpha_down=1.5),
                dict(latency_reservoir=0)):
        with pytest.raises(ValueError):
            policy(pkg, **bad)
    policy(pkg, max_wait_s=0.0)


def test_server_constructor_validation(pkg, engine):
    Q = pkg.server.QueryServer
    with pytest.raises(ValueError):
        Q(engine, pipeline_depth=0, start=False)
    with pytest.raises(ValueError):
        Q(engine, workers=0, start=False)
    with pytest.raises(ValueError, match="unknown QoS class"):
        Q(engine, class_policies={"bulk": policy(pkg)}, start=False)
    with pytest.raises(ValueError, match="unknown QoS class"):
        Q(engine, lane_weights={"bulk": 1.0}, start=False)
    with pytest.raises(ValueError, match="weight"):
        Q(engine, lane_weights={"RANKING": 0.0}, start=False)
    with pytest.raises(ValueError, match="BatchPolicy"):
        Q(engine, class_policies={"PREFETCH": 0.5}, start=False)
    srv = Q(engine,
            class_policies={"prefetch": policy(pkg, max_wait_s=0.01)},
            lane_weights={pkg.api.QoSClass.RANKING: 8}, start=False)
    srv.close()


def test_submit_takes_query_requests_only(pkg, dataset, engine):
    keys, _, _ = dataset
    with server_of(pkg, engine, start=False) as server:
        with pytest.raises(TypeError, match="FeatureClient"):
            server.submit({"s": keys[:4]})
        ticket = server.submit(pkg.api.QueryRequest(tables={"s": keys[:4]}))
        assert not ticket.done()


def test_empty_snapshot_reports_nan_cleanly(pkg, engine):
    server = server_of(pkg, engine, start=False)
    try:
        snap = server.stats_snapshot()
        assert math.isnan(snap.p50_ms) and math.isnan(snap.p99_ms)
        assert snap.mean_occupancy == 0.0 and snap.shed_rate == 0.0
        for c in snap.per_class.values():
            assert math.isnan(c.p99_ms) and c.shed_rate == 0.0
        assert isinstance(snap.summary(), str)
    finally:
        server.close()


def test_single_request_snapshot(pkg, dataset, engine):
    keys, _, _ = dataset
    with server_of(pkg, engine, policy(pkg, max_wait_s=0.0)) as server:
        query(pkg, server, {"s": keys[:4]}, timeout=30)
        snap = server.stats_snapshot()
    assert snap.completed == 1
    assert snap.p50_ms > 0 and snap.p99_ms > 0
    assert snap.per_class["RANKING"].completed == 1
    assert math.isnan(snap.per_class["PREFETCH"].p99_ms)
    assert isinstance(snap.summary(), str)


def test_store_backend_behind_query_server(pkg, dataset):
    """A backend with no engine at all: coalescing, ticketing and version
    NACKs work unchanged."""
    keys, _, values = dataset
    backend = pkg.api.StoreBackend(
        {"e": pkg.Store(keys, values, hot_fraction=0.3)}, version=5)
    with server_of(pkg, backend, policy(pkg, max_wait_s=0.002)) as server:
        client = pkg.api.FeatureClient(server)
        res = client.query({"e": keys[:32]}, timeout=30)
        assert res.version == 5
        np.testing.assert_array_equal(res["e"].values, values[:32])
        with pytest.raises(pkg.eng.VersionEvictedError):
            client.query({"e": keys[:8]},
                         consistency=pkg.api.Consistency.pinned(4),
                         timeout=30)
        res = client.query({"e": keys[:8]},
                           consistency=pkg.api.Consistency.hinted(4),
                           timeout=30)
        assert res.version == 5


def test_dict_oracle_under_mixed_class_clients(pkg, dataset, engine):
    keys, payloads, values = dataset
    oracle = dict(zip(keys.tolist(), payloads.tolist()))
    classes = [pkg.api.QoSClass.RANKING, pkg.api.QoSClass.RETRIEVAL,
               pkg.api.QoSClass.PREFETCH]
    errors = []
    with server_of(pkg, engine, policy(pkg, max_wait_s=0.003)) as server:
        client = pkg.api.FeatureClient(server)

        def run(cid):
            rng = np.random.default_rng(cid)
            qos = classes[cid % 3]
            try:
                for _ in range(6):
                    q = rng.choice(keys, 48)
                    q = np.concatenate([q, q[:6], rng.integers(
                        2**62, 2**63, 4, dtype=np.uint64)])
                    res = client.query({"s": q, "e": q[:24]}, qos=qos)
                    assert res.qos is qos
                    for k, f, p in zip(q.tolist(), res["s"].found,
                                       res["s"].payloads):
                        assert (k in oracle) == bool(f)
                        if f:
                            assert oracle[k] == int(p)
                    for k, f, v in zip(q[:24].tolist(), res["e"].found,
                                       res["e"].values):
                        if f:
                            assert (values[k - 1] == v).all()
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert not errors, errors[:3]
        snap = server.stats_snapshot()
    assert snap.completed == 6 * 6 and snap.failed == 0
    per = snap.per_class
    assert {per[c.name].completed for c in classes} == {12}
    assert sum(c.completed for c in per.values()) == snap.completed


def test_shed_order_prefetch_first(pkg, dataset, engine):
    """A full queue sheds PREFETCH to admit RANKING, RETRIEVAL sheds
    PREFETCH, PREFETCH sheds itself, and RANKING is never the victim."""
    keys, _, _ = dataset
    QF = pkg.sched.QueueFullError
    server = server_of(pkg, engine, policy(pkg, max_queue_requests=4),
                       start=False)
    try:
        prefetch = [submit(pkg, server, {"s": keys[:8]}, qos="PREFETCH")
                    for _ in range(4)]
        ranking = submit(pkg, server, {"s": keys[:8]}, qos="RANKING")
        with pytest.raises(QF, match="evicted"):
            prefetch[3].result(timeout=5)
        with pytest.raises(QF, match="no lane below"):
            submit(pkg, server, {"s": keys[:8]}, qos="PREFETCH")
        retrieval = submit(pkg, server, {"s": keys[:8]}, qos="RETRIEVAL")
        with pytest.raises(QF):
            prefetch[2].result(timeout=5)
        for _ in range(2):
            submit(pkg, server, {"s": keys[:8]}, qos="RANKING")
        assert server.lane_depths == {"RANKING": 3, "RETRIEVAL": 1,
                                      "PREFETCH": 0}
        submit(pkg, server, {"s": keys[:8]}, qos="RANKING")
        with pytest.raises(QF):
            retrieval.result(timeout=5)
        with pytest.raises(QF, match="no lane below"):
            submit(pkg, server, {"s": keys[:8]}, qos="RANKING")
        per = server.stats_snapshot().per_class
        assert per["PREFETCH"].shed_queue_full == 5
        assert per["RETRIEVAL"].shed_queue_full == 1
        assert per["RANKING"].shed_queue_full == 1
        assert not ranking.done()
    finally:
        server.close()
    with pytest.raises(pkg.sched.ServerClosedError):
        ranking.result(timeout=5)


def test_doomed_arrival_does_not_evict(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(pkg, engine, policy(pkg, max_queue_requests=2,
                                           service_time_init_s=0.05),
                       start=False)
    try:
        prefetch = [submit(pkg, server, {"s": keys[:8]}, qos="PREFETCH")
                    for _ in range(2)]
        with pytest.raises(pkg.sched.DeadlineError):
            submit(pkg, server, {"s": keys[:8]}, qos="RANKING",
                   budget_s=0.001)
        assert not any(t.done() for t in prefetch)
        assert server.stats_snapshot().per_class[
            "PREFETCH"].shed_queue_full == 0
    finally:
        server.close()


def _weighted_order(pkg, engine, keys):
    server = server_of(pkg, engine, policy(pkg, max_batch_requests=1,
                                           max_wait_s=0.0), start=False)
    r = [submit(pkg, server, {"s": keys[i * 8:(i + 1) * 8]}, qos="RANKING")
         for i in range(6)]
    p = [submit(pkg, server, {"s": keys[i * 8:(i + 1) * 8]}, qos="PREFETCH")
         for i in range(6)]
    server.start()
    try:
        for t in r + p:
            t.result(timeout=60)
        return [t.batch_id for t in r], [t.batch_id for t in p]
    finally:
        server.close()


def test_weighted_service_order(pkg, dataset, engine):
    """Prequeued lanes drain by smooth weighted round robin: RANKING first
    on average, yet PREFETCH served before RANKING empties."""
    r_ids, p_ids = _weighted_order(pkg, engine, dataset[0])
    assert sorted(r_ids + p_ids) == list(range(12))
    assert np.mean(r_ids) < np.mean(p_ids)
    assert min(p_ids) < max(r_ids)


def test_weighted_service_order_equal_across_packages(dataset,
                                                      both_engines):
    """The same prequeued lanes drain in the same batch order in both."""
    orders = {name: _weighted_order(PKGS[name], eng, dataset[0])
              for name, eng in both_engines.items()}
    assert orders["jax"] == orders["torch"]


def test_per_class_policy_override(pkg, dataset, engine):
    keys, _, _ = dataset
    server = server_of(
        pkg, engine, policy(pkg, max_batch_requests=8, max_wait_s=0.0),
        class_policies={"PREFETCH": policy(pkg, max_batch_requests=1,
                                           max_wait_s=0.0)},
        start=False)
    r = [submit(pkg, server, {"s": keys[:8]}, qos="RANKING")
         for _ in range(4)]
    p = [submit(pkg, server, {"s": keys[:8]}, qos="PREFETCH")
         for _ in range(4)]
    server.start()
    try:
        for t in r + p:
            t.result(timeout=60)
        assert len({t.batch_id for t in r}) == 1
        assert len({t.batch_id for t in p}) == 4
    finally:
        server.close()


# ---------------------------------------------------------------------------
# tests/test_observability.py: the tracer and the server's span chain
# ---------------------------------------------------------------------------
def test_tracer_rate_zero_never_samples(pkg):
    t = pkg.trace.Tracer(sample_rate=0.0)
    assert all(t.sample() is None for _ in range(1000))


def test_tracer_rate_one_always_samples_unique(pkg):
    t = pkg.trace.Tracer(sample_rate=1.0)
    ids = {t.sample() for _ in range(100)}
    assert None not in ids and len(ids) == 100
    with pytest.raises(ValueError):
        pkg.trace.Tracer(sample_rate=1.5)


def test_tracer_record_take_and_capacity_eviction(pkg):
    t = pkg.trace.Tracer(sample_rate=1.0, capacity=2)
    tids = [t.sample() for _ in range(3)]
    for tid in tids:
        t.record([pkg.trace.Span(tid, "serve", 0.0, 1.0)])
    assert t.take(tids[0]) == []
    assert len(t.take(tids[2])) == 1
    assert t.take(tids[2]) == []
    assert t.trace_ids() == [tids[1]] and t.sampled_total == 3


def test_span_wire_round_trip_across_packages():
    """A span's wire form reads back the same in either package."""
    for make, read in ((jtrace.Span, ttrace.Span), (ttrace.Span, jtrace.Span)):
        s = make("tid", "device", 1.5, 2.5, parent_id="pid",
                 proc="shard0/r1", tags={"version": 3})
        assert s.to_wire() == read.from_wire(s.to_wire()).to_wire()
        back = read.from_wire(s.to_wire())
        assert (back.trace_id, back.name, back.t0, back.t1, back.parent_id,
                back.proc, back.tags) == \
            ("tid", "device", 1.5, 2.5, "pid", "shard0/r1", {"version": 3})
        assert back.duration_s == pytest.approx(1.0)


def test_sort_timeline_orders_by_start(pkg):
    spans = [pkg.trace.Span("t", "b", 2.0, 3.0),
             pkg.trace.Span("t", "a", 1.0, 4.0)]
    assert [s.name for s in pkg.trace.sort_timeline(spans)] == ["a", "b"]


SPAN_CHAIN = ("serve", "admission", "lane_wait", "coalesce", "version_pin",
              "begin", "device", "finish", "scatter")


def _small_engine(pkg, n=2000):
    keys = np.arange(1, n + 1, dtype=np.uint64)
    vals = np.arange(1, n + 1, dtype=np.uint64) * 3
    return make_engine(pkg, [pkg.eng.ScalarTable("item_attr", keys,
                                                 vals)]), keys


def test_sampled_request_yields_full_span_chain(pkg):
    engine, keys = _small_engine(pkg)
    tracer = pkg.trace.Tracer(sample_rate=1.0, proc="server")
    with server_of(pkg, engine, policy(pkg, max_wait_s=0.001),
                   tracer=tracer) as server:
        resp = server.query(pkg.api.QueryRequest(
            tables={"item_attr": keys[:64]}))
    assert resp.trace, "sampled request returned no trace"
    names = [d["name"] for d in resp.trace]
    assert sorted(names) == sorted(SPAN_CHAIN)
    root = next(d for d in resp.trace if d["name"] == "serve")
    assert root["tags"]["version"] == resp.version == 1
    assert root["tags"]["batch_id"] == resp.batch_id
    assert all(d["parent_id"] == root["span_id"]
               for d in resp.trace if d is not root)
    spans = pkg.trace.sort_timeline(
        [pkg.trace.Span.from_wire(d) for d in resp.trace])
    assert all(s.t1 >= s.t0 for s in spans)
    tids = {d["trace_id"] for d in resp.trace}
    assert len(tids) == 1
    assert tracer.take(tids.pop())


def test_unsampled_request_has_no_trace(pkg):
    engine, keys = _small_engine(pkg)
    with server_of(pkg, engine, policy(pkg, max_wait_s=0.001),
                   tracer=pkg.trace.Tracer(sample_rate=0.0)) as server:
        resp = server.query(pkg.api.QueryRequest(
            tables={"item_attr": keys[:64]}))
    assert resp.trace is None
