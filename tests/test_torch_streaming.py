"""The port's streaming online-learning loop (``stream/``,
``launch/realtime.py``) against the JAX package's, on the CPU.

* The ``TestEventLog`` and ``TestPipeline`` scenarios of
  ``tests/test_streaming.py`` run once per package: the JAX log, source and
  stages over the JAX ``MultiTableEngine`` and ``QueryServer``, and the
  port's over the port's engine on the CPU, with the same numpy step
  function.
* Across the packages, on the same inputs: partitions and offsets of the
  same appends, and the sessions, events and payloads of the same seed,
  are equal.
* The realtime launcher: ``make_step_fn`` from the same parameters
  (carried across by ``core/convert.py``) on the same event lists gives the
  same delta keys, bitwise, and the same rows within
  ``tests/test_torch_train.py``'s tolerance for a step; every row the batch
  layer publishes is one step's parameters; ``main`` runs the loop on the
  CPU and refuses without a card; and (slow) both launchers' ``--smoke``
  runs exit 0 with reports of the same keys.
"""
import dataclasses
import json
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import engine as jeng
from repro.configs import registry as jregistry
from repro.launch import mesh as mesh_mod
from repro.launch import realtime as jrealtime
from repro.models import common as jcm
from repro.models import recsys as jrec
from repro.serve import server as jserver
import repro.stream as jstream
import repro_torch.api as tapi
from repro_torch.configs import din
from repro_torch.core import convert
from repro_torch.core import engine as teng
from repro_torch.launch import realtime as trealtime
from repro_torch.serve import server as tserver
import repro_torch.stream as tstream

from conftest import subprocess_env

TOL = 1e-5          # a step's rows: fp32 sums in other orders (test_torch_train)

PKGS = {
    "jax": types.SimpleNamespace(name="jax", api=japi, eng=jeng,
                                 server=jserver, stream=jstream,
                                 engine_kw={}),
    "torch": types.SimpleNamespace(name="torch", api=tapi, eng=teng,
                                   server=tserver, stream=tstream,
                                   engine_kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _event_tuple(ev):
    """An event's fields but its append time."""
    return (ev.topic, ev.partition, ev.offset, ev.key, ev.kind, ev.payload)


# ---------------------------------------------------------------------------
# 1. event log
# ---------------------------------------------------------------------------
class TestEventLog:
    def test_offsets_dense_and_replay_deterministic(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t", partitions=1)
        for i in range(20):
            log.append("t", key=i, kind="imp", payload={"i": i})

        first = log.poll("t", "g", max_records=8)
        again = log.poll("t", "g", max_records=8)
        # poll does NOT advance the commit: replay is byte-identical
        assert [e.offset for e in first] == [e.offset for e in again]
        assert [e.payload for e in first] == [e.payload for e in again]
        assert [e.offset for e in first] == list(range(8))

        log.commit("t", "g", first)
        nxt = log.poll("t", "g", max_records=8)
        assert [e.offset for e in nxt] == list(range(8, 16))

        # an explicit seek back replays the exact same prefix
        log.commit("t", "g", nxt)
        log.seek("t", "g", 0)
        replay = log.poll("t", "g", max_records=20)
        assert [e.offset for e in replay] == list(range(20))
        assert [e.payload["i"] for e in replay] == list(range(20))

    def test_consumer_groups_are_independent(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t")
        for i in range(10):
            log.append("t", key=i, kind="imp")
        a = log.poll("t", "a", max_records=10)
        log.commit("t", "a", a)
        assert log.backlog("t", "a") == 0
        # group b starts from the earliest retained offset, unaffected
        assert log.backlog("t", "b") == 10
        b = log.poll("t", "b", max_records=10)
        assert [e.offset for e in b] == [e.offset for e in a]

    def test_retention_truncates_lagging_consumer_with_typed_error(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t", partitions=1, retention=10)
        log.append("t", key=0, kind="imp")
        head = log.poll("t", "lag", max_records=1)   # pins position 0
        log.commit("t", "lag", head)                 # committed at 1
        for i in range(1, 40):
            log.append("t", key=i, kind="imp")
        assert log.earliest("t", 0) == 30            # 40 appended, keep 10

        with pytest.raises(pkg.stream.OffsetTruncatedError) as ei:
            log.poll("t", "lag")
        e = ei.value
        assert (e.topic, e.partition) == ("t", 0)
        assert e.requested == 1
        assert e.earliest == 30
        # recovery contract: seek to the error's earliest and keep going —
        # the gap is explicit, never silently skipped
        log.seek("t", "lag", e.earliest, e.partition)
        evs = log.poll("t", "lag", max_records=100)
        assert [ev.offset for ev in evs] == list(range(30, 40))

    def test_backlog_is_bounded_by_retention(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t", partitions=1, retention=16)
        for i in range(1000):
            log.append("t", key=i, kind="imp")
        # a consumer group that never polled sees at most the retained tail
        assert log.backlog("t", "fresh") == 16

    def test_multi_producer_thread_interleaving(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t", partitions=2)
        n_threads, per = 4, 250

        def produce(tid):
            for i in range(per):
                log.append("t", key=tid * per + i, kind="imp",
                           payload={"tid": tid, "i": i})

        ts = [threading.Thread(target=produce, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

        # per-partition offsets are dense 0..end-1 and every record
        # arrives exactly once
        total = sum(log.end_offset("t", p) for p in range(2))
        assert total == n_threads * per
        seen = []
        while True:
            evs = log.poll("t", "g", max_records=128)
            if not evs:
                break
            seen.extend(evs)
            log.commit("t", "g", evs)
        assert len(seen) == n_threads * per
        ids = sorted((e.payload["tid"], e.payload["i"]) for e in seen)
        assert ids == [(t, i) for t in range(n_threads) for i in range(per)]
        for p in range(2):
            offs = sorted(e.offset for e in seen if e.partition == p)
            assert offs == list(range(len(offs)))

    def test_unknown_topic_and_duplicate_create(self, pkg):
        log = pkg.stream.EventLog()
        with pytest.raises(pkg.stream.UnknownTopicError):
            log.append("nope", key=1, kind="imp")
        with pytest.raises(pkg.stream.UnknownTopicError):
            log.poll("nope", "g")
        log.create_topic("t")
        with pytest.raises(ValueError):
            log.create_topic("t")

    def test_same_key_routes_to_same_partition(self, pkg):
        log = pkg.stream.EventLog()
        log.create_topic("t", partitions=4)
        evs = [log.append("t", key=77, kind="imp") for _ in range(5)]
        assert len({e.partition for e in evs}) == 1
        assert [e.offset for e in evs] == list(range(5))


class TestAcrossPackages:
    @pytest.mark.parametrize("partitions", [1, 3, 4])
    def test_same_appends_same_partitions_and_offsets(self, partitions):
        rng = np.random.default_rng(partitions)
        keys = [int(k) for k in rng.integers(-2**40, 2**40, 300)] + \
            [0, 1, -1, 2**63 - 1, 12345] * 3
        logs = []
        for p in (PKGS["jax"], PKGS["torch"]):
            log = p.stream.EventLog()
            log.create_topic("t", partitions=partitions, retention=200)
            got = [_event_tuple(log.append("t", k, "imp", {"k": k}))
                   for k in keys]
            polled = [_event_tuple(e) for e in
                      log.poll("t", "g", max_records=1000)]
            logs.append((got, polled, [(log.earliest("t", i),
                                        log.end_offset("t", i))
                                       for i in range(partitions)]))
        assert logs[0] == logs[1]

    @pytest.mark.parametrize("seed", [0, 9, 500])
    def test_same_seed_same_sessions(self, seed):
        out = []
        for p in (PKGS["jax"], PKGS["torch"]):
            log = p.stream.EventLog()
            log.create_topic("events", partitions=4)
            src = p.stream.SessionizedSource(log, "events", n_users=64,
                                             n_items=500, seed=seed)
            sessions = [(u, [_event_tuple(e) for e in src.emit_session(u)])
                        for u in (src.pick_user() for _ in range(40))]
            out.append((sessions, src.sessions_emitted,
                        src.events_emitted))
        assert out[0] == out[1]
        assert out[0][2] > 40

    def test_stream_stats_snapshot_equal(self):
        snaps = []
        for p in (PKGS["jax"], PKGS["torch"]):
            stats = p.stream.StreamStats(slo_budget_s=0.5)
            for i, s in enumerate(np.linspace(0.001, 0.9, 97)):
                stats.observe_freshness(float(s))
                stats.inc("deltas_published")
                stats.inc("rows_upserted", i)
            snap = dataclasses.asdict(stats.snapshot())
            snap.pop("updates_per_s")             # divides by wall time
            snaps.append(snap)
        assert snaps[0] == snaps[1]
        assert snaps[0]["staleness_violations"] > 0

    def test_trending_row_packing_equal(self):
        row = np.asarray([5, 0, 2**40, 7], dtype=np.uint64).view(np.uint8)
        assert tstream.TrendingAggregator.decode_row(row) == \
            jstream.TrendingAggregator.decode_row(row) == [5, 0, 2**40, 7]


# ---------------------------------------------------------------------------
# 2. pipeline integration (numpy step_fn), once per package
# ---------------------------------------------------------------------------
N_ITEMS = 64
N_USERS = 16
DIM = 8


def _engine(pkg):
    item_keys = np.arange(1, N_ITEMS + 1, dtype=np.uint64)
    item_vals = np.zeros((N_ITEMS, DIM * 4), dtype=np.uint8)
    user_keys = np.arange(1, N_USERS + 1, dtype=np.uint64)
    user_vals = np.zeros((N_USERS, DIM * 4), dtype=np.uint8)
    trend_vals = np.zeros((1, 4 * 8), dtype=np.uint8)
    E = pkg.eng.EmbeddingTable
    return pkg.eng.MultiTableEngine(embeddings=[
        E("item_table", item_keys, item_vals),
        E("user_profile", user_keys, user_vals),
        E("trending", np.asarray([1], dtype=np.uint64), trend_vals),
    ], max_shard_bytes=1 << 16, version=1, **pkg.engine_kw)


def _numpy_step_fn(table=None):
    """Stand-in trainer step: bump each touched item row."""
    tab = table if table is not None else np.zeros((N_ITEMS, DIM),
                                                   dtype=np.float32)

    def step_fn(events):
        items = np.asarray([(ev.payload or {}).get("item", 0)
                            for ev in events], dtype=np.int64)
        rows = np.unique(items[(items >= 0) & (items < N_ITEMS)])
        if not len(rows):
            return None
        tab[rows] += 1.0
        return {"item_table": (
            rows.astype(np.uint64) + np.uint64(1),
            np.ascontiguousarray(tab[rows]).view(np.uint8))}

    return step_fn


class TestPipeline:
    def test_end_to_end_consistency_and_freshness(self, pkg):
        """The acceptance loop in miniature: concurrent sessionized
        queries against streaming updates — zero mixed-version batches,
        zero min_version violations, freshness actually measured."""
        S = pkg.stream
        engine = _engine(pkg)
        with pkg.server.QueryServer(engine) as server:
            client = pkg.api.FeatureClient(server, default_budget_s=5.0)
            log = S.EventLog()
            log.create_topic("events", partitions=2, retention=10_000)
            log.create_topic("trending", partitions=1, retention=16)
            stats = S.StreamStats(slo_budget_s=30.0)
            publisher = S.VersionedPublisher(client, engine.latest_version,
                                             stats)
            stages = [
                S.StreamingTrainer(log, "events", publisher, stats,
                                   _numpy_step_fn(), batch_events=16,
                                   period_s=0.002),
                S.ProfileEMAUpdater(log, "events", publisher, stats,
                                    dim=DIM, period_s=0.002),
                S.TrendingAggregator(log, "events", publisher, stats,
                                     out_topic="trending", top_k=4,
                                     period_s=0.005),
            ]
            for s in stages:
                s.start()
            src = S.SessionizedSource(log, "events", n_users=N_USERS,
                                      n_items=N_ITEMS, seed=9)
            violations = 0
            versions = []
            try:
                for i in range(40):
                    user = src.pick_user()
                    src.emit_session(user)
                    cons = (pkg.api.Consistency.min_version(
                        publisher.version) if i % 2 == 0 else None)
                    try:
                        res = client.query(
                            {"user_profile":
                             np.asarray([user + 1], dtype=np.uint64),
                             "trending":
                             np.asarray([1], dtype=np.uint64)},
                            consistency=cons, timeout=10)
                    except pkg.api.ConsistencyError:
                        violations += 1
                        continue
                    # one build per response: `version` is a single int
                    # that never regresses within this thread
                    assert isinstance(res.version, int)
                    if cons is not None:
                        assert res.version >= cons.version
                    versions.append(res.version)
                    time.sleep(0.002)
                deadline = time.monotonic() + 10.0
                while (time.monotonic() < deadline
                       and log.backlog("events", "trainer") > 0
                       and all(s.error is None for s in stages)):
                    time.sleep(0.01)
            finally:
                for s in stages:
                    s.stop()
            assert all(s.error is None for s in stages), \
                [repr(s.error) for s in stages]
            snap = stats.snapshot()
            assert violations == 0
            assert snap.min_version_violations == 0
            assert versions == sorted(versions), \
                "served version regressed within a single thread"
            assert snap.deltas_published > 0
            assert snap.freshness_samples > 0
            assert snap.freshness_p99_ms > 0.0
            assert snap.staleness_violations == 0
            # the trending fallback row is decodable
            trow = client.query(
                {"trending": np.asarray([1], dtype=np.uint64)},
                timeout=10).tables["trending"]
            assert trow.found[0]
            items = S.TrendingAggregator.decode_row(trow.values[0])
            assert len(items) == 4

    def test_lagging_trainer_sheds_backlog_gracefully(self, pkg):
        """Flood the topic past max_backlog before the trainer starts:
        it must shed down to the cap and keep consuming."""
        S = pkg.stream
        engine = _engine(pkg)
        client = pkg.api.FeatureClient(engine)     # direct backend
        log = S.EventLog()
        log.create_topic("events", partitions=2, retention=50_000)
        stats = S.StreamStats()
        publisher = S.VersionedPublisher(client, engine.latest_version,
                                         stats)
        src = S.SessionizedSource(log, "events", n_users=N_USERS,
                                  n_items=N_ITEMS, seed=3, session_len=16)
        while log.backlog("events", "flood") < 2000:
            src.emit_session()
        trainer = S.StreamingTrainer(log, "events", publisher, stats,
                                     _numpy_step_fn(), batch_events=64,
                                     max_backlog=256, period_s=0.001)
        trainer.start()
        try:
            deadline = time.monotonic() + 20.0
            while (time.monotonic() < deadline
                   and log.backlog("events", "trainer") > 0
                   and trainer.error is None):
                time.sleep(0.01)
        finally:
            trainer.stop()
        assert trainer.error is None, repr(trainer.error)
        snap = stats.snapshot()
        assert snap.events_shed > 0, "flood should have forced shedding"
        assert snap.events_consumed > 0
        assert snap.events_consumed <= 2 * 256 + 128, \
            "shed-to-cap should have skipped most of the flood"
        assert log.backlog("events", "trainer") == 0

    def test_truncated_consumer_recovers_via_seek(self, pkg):
        S = pkg.stream
        engine = _engine(pkg)
        client = pkg.api.FeatureClient(engine)
        log = S.EventLog()
        log.create_topic("events", partitions=1, retention=32)
        stats = S.StreamStats()
        publisher = S.VersionedPublisher(client, engine.latest_version,
                                         stats)
        trainer = S.StreamingTrainer(log, "events", publisher, stats,
                                     _numpy_step_fn(), batch_events=8)
        # pin the group's committed position at 0, then blow past retention
        log.poll("events", "trainer", max_records=1)
        for i in range(200):
            log.append("events", key=i, kind="imp", payload={"item": 1})
        got = trainer._poll(log, "events", "trainer", stats, 8)
        assert got == []
        assert stats.snapshot().truncations_recovered == 1
        nxt = trainer._poll(log, "events", "trainer", stats, 8)
        assert nxt and nxt[0].offset == log.earliest("events", 0)

    def test_publisher_versions_are_serialized_and_monotonic(self, pkg):
        engine = _engine(pkg)
        client = pkg.api.FeatureClient(engine)
        stats = pkg.stream.StreamStats()
        publisher = pkg.stream.VersionedPublisher(
            client, engine.latest_version, stats)
        versions = []
        lock = threading.Lock()

        def push(i):
            v = publisher.publish({"item_table": (
                np.asarray([i + 1], dtype=np.uint64),
                np.zeros((1, DIM * 4), dtype=np.uint8))})
            with lock:
                versions.append(v)

        ts = [threading.Thread(target=push, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sorted(versions) == list(
            range(min(versions), min(versions) + 16))
        assert engine.latest_version == max(versions)


def test_sequential_pipeline_serves_equal_rows_in_both_packages():
    """One thread, the same events through each package's trainer and
    profile stages (``tick`` called directly), each publishing to its own
    engine: the same versions, and every served row equal bitwise."""
    served = []
    for p in (PKGS["jax"], PKGS["torch"]):
        S = p.stream
        engine = _engine(p)
        client = p.api.FeatureClient(engine)
        log = S.EventLog()
        log.create_topic("events", partitions=2)
        stats = S.StreamStats()
        publisher = S.VersionedPublisher(client, engine.latest_version,
                                         stats)
        trainer = S.StreamingTrainer(log, "events", publisher, stats,
                                     _numpy_step_fn(), batch_events=16)
        profiles = S.ProfileEMAUpdater(log, "events", publisher, stats,
                                       dim=DIM)
        src = S.SessionizedSource(log, "events", n_users=N_USERS,
                                  n_items=N_ITEMS, seed=4)
        for _ in range(6):
            for _ in range(5):
                src.emit_session()
            trainer.tick()
            profiles.tick()
        res = client.query({
            "item_table": np.arange(1, N_ITEMS + 1, dtype=np.uint64),
            "user_profile": np.arange(1, N_USERS + 1, dtype=np.uint64)})
        served.append((publisher.version, res.version, {
            t: (r.found.copy(), r.values.copy())
            for t, r in res.tables.items()}))
    (jv, jrv, jt), (tv, trv, tt) = served
    assert (jv, jrv) == (tv, trv) and jv > 1
    for t in jt:
        np.testing.assert_array_equal(tt[t][0], jt[t][0])
        np.testing.assert_array_equal(tt[t][1], jt[t][1])


# ---------------------------------------------------------------------------
# 3. the realtime launcher
# ---------------------------------------------------------------------------
N_LOOP_ITEMS = 300


def _jax_make_step_fn(args, params):
    jcfg = dataclasses.replace(jregistry.get("din").smoke,
                               item_vocab=args.n_items, seq_len=10)
    mesh = mesh_mod.make_local_mesh()
    mi = jcm.MeshInfo.from_mesh(mesh)
    return jrealtime.make_step_fn(args, jcfg, mesh, mi, params)


def _events(seed, sessions):
    log = tstream.EventLog()
    log.create_topic("events", partitions=4)
    src = tstream.SessionizedSource(log, "events", n_users=32,
                                    n_items=N_LOOP_ITEMS, seed=seed)
    out = []
    for _ in range(sessions):
        out += src.emit_session()
    return out


def test_make_step_fn_matches_jax():
    """From the same parameters, the two warm-up calls and then 3 calls on
    fixed event lists: each call from the JAX step's parameters and state
    of the call before (as tests/test_torch_train.py's whole steps), the
    delta keys bitwise, the rows within TOL, the whole item table too."""
    args = trealtime.parse_args(["--smoke", "--device", "cpu",
                                 "--n-items", str(N_LOOP_ITEMS)])
    assert args.n_items == N_LOOP_ITEMS and args.train_batch == 32
    jcfg = dataclasses.replace(jregistry.get("din").smoke,
                               item_vocab=args.n_items, seq_len=10)
    jparams, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), jcfg))
    jstep, jholder = _jax_make_step_fn(args, jparams)
    cfg = dataclasses.replace(din.SMOKE, item_vocab=args.n_items,
                              seq_len=10)
    params = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    tstep, tholder = trealtime.make_step_fn(args, cfg, params)
    calls = [[], [], _events(1, 4), _events(2, 9), _events(3, 1)]
    assert [len(e) for e in calls[2:]] != [0, 0, 0]
    for i, events in enumerate(calls):
        tholder["params"] = convert.params_from_reference(
            jax.tree.map(np.asarray, jholder["params"]), "cpu")
        tholder["state"] = convert.opt_state_from_reference(
            jax.tree.map(np.asarray, jholder["state"]), "cpu")
        want = jstep(events)
        got = tstep(events)
        assert tholder["step"] == int(jholder["step"]) == i + 1
        (wk, wv), = want.values()
        (gk, gv), = got.values()
        assert list(got) == list(want) == ["item_table"]
        assert gk.dtype == wk.dtype == np.uint64
        np.testing.assert_array_equal(gk, wk)
        assert gv.dtype == wv.dtype == np.uint8 and gv.shape == wv.shape
        np.testing.assert_allclose(gv.view(np.float32), wv.view(np.float32),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            tholder["params"]["item_table"].numpy(),
            np.asarray(jholder["params"]["item_table"]), rtol=TOL, atol=TOL)


class _ShadowClient(trealtime.FeatureClient):
    """The launcher's client, recording every full publish's item rows."""
    fulls: list = []

    def update(self, version, *, upserts=None, deletes=None, scalars=(),
               embeddings=()):
        for t in embeddings:
            if t.name == "item_table":
                self.fulls.append(np.array(t.values, copy=True))
        super().update(version, upserts=upserts, deletes=deletes,
                       scalars=scalars, embeddings=embeddings)


def test_batch_layer_publishes_one_steps_parameters(monkeypatch):
    """Every item row the batch layer publishes, while the trainer steps
    in another thread, is the bytes of one step's item table (the initial
    one or one a step returned), never a mix."""
    steps = []
    real = trealtime.make_step_fn

    def recording(args, cfg, params):
        step_fn, holder = real(args, cfg, params)
        steps.append(trealtime._leading_rows_as_bytes(
            params["item_table"], args.n_items))

        def wrapped(events):
            out = step_fn(events)
            steps.append(trealtime._leading_rows_as_bytes(
                holder["params"]["item_table"], args.n_items))
            return out

        return wrapped, holder

    _ShadowClient.fulls = []
    monkeypatch.setattr(trealtime, "make_step_fn", recording)
    monkeypatch.setattr(trealtime, "FeatureClient", _ShadowClient)
    args = trealtime.parse_args(["--smoke", "--device", "cpu",
                                 "--batch-publish-s", "0.05",
                                 "--requests", "60", "--drain-s", "10"])
    rc, report = trealtime.drive(args, trealtime.Registry(),
                                 trealtime.Tracer())
    assert rc == 0, report
    fulls = _ShadowClient.fulls               # the seed is no update
    assert len(fulls) >= 2, len(fulls)
    assert report["trainer_steps"] >= 1
    tables = {s.tobytes(): i for i, s in enumerate(steps)}
    assert len(tables) > 2                    # the steps moved the table
    for f in fulls:
        assert f.tobytes() in tables


def test_realtime_main_on_the_cpu(capsys):
    with pytest.raises(SystemExit) as ei:
        trealtime.main(["--smoke", "--device", "cpu", "--drain-s", "10",
                        "--metrics-port", "0", "--trace-sample", "0.5"])
    text = capsys.readouterr().out
    assert ei.value.code == 0, text[-2000:]
    assert "metrics: serving http://127.0.0.1:" in text
    report = json.loads(text.split("realtime SLO report: ", 1)[1]
                        .splitlines()[0])
    assert report["min_version_violations"] == 0
    assert report["version_regressions"] == 0
    assert report["stage_errors"] == {}
    assert report["deltas_published"] > 0 and report["queries"] > 0
    assert report["final_version"] > 1


def test_realtime_record_holds_the_freshness_histogram(tmp_path, capsys):
    path = tmp_path / "rt.json"
    with pytest.raises(SystemExit) as ei:
        trealtime.main(["--smoke", "--device", "cpu", "--drain-s", "10",
                        "--record", str(path)])
    assert ei.value.code == 0
    record = json.loads(path.read_text())
    assert record["ok"] is True and record["alias"] == "realtime"
    assert record["metrics"]["repro_stream_freshness_seconds_count"] == \
        record["report"]["freshness_samples"] > 0
    assert record["metrics"]["repro_stream_deltas_published_total"] == \
        record["report"]["deltas_published"]


def test_realtime_launcher_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trealtime.main(["--smoke"])
    assert trealtime.parse_args([]).device == "cuda"


def test_realtime_defaults_match_the_jax_launcher(monkeypatch):
    """The same options, defaults and --smoke cuts as the JAX launcher's
    (whose parser lives in its main)."""
    seen = {}

    def capture(args, registry_obj, tracer):
        seen["args"] = vars(args)
        raise SystemExit(0)

    for argv in ([], ["--smoke"]):
        monkeypatch.setattr(sys, "argv", ["realtime"] + argv)
        monkeypatch.setattr(jrealtime, "drive", capture)
        with pytest.raises(SystemExit):
            jrealtime.main()
        want = seen.pop("args")
        got = vars(trealtime.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want


@pytest.mark.slow
def test_realtime_launcher_smoke_reports_the_jax_keys():
    reports = []
    for mod, extra in (("repro.launch.realtime", []),
                       ("repro_torch.launch.realtime", ["--device", "cpu"])):
        r = subprocess.run(
            [sys.executable, "-m", mod, "--smoke", "--drain-s", "10"]
            + extra, capture_output=True, text=True, timeout=900,
            env=subprocess_env())
        assert r.returncode == 0, (mod, r.stdout[-2000:], r.stderr[-2000:])
        line = next(ln for ln in r.stdout.splitlines()
                    if ln.startswith("realtime SLO report: "))
        reports.append(json.loads(line.split(": ", 1)[1]))
    assert list(reports[1]) == list(reports[0])
