"""The port's multi-process serving fabric (``serve/fabric.py``,
``launch/fabric.py``) against the JAX package's, on the CPU.

- the key partition, bitwise across both packages and ``hashcore``;
- one script of queries (``latest``, ``pinned``, ``hinted``,
  ``min_version``; duplicate and absent keys, an empty table) and updates
  (one with an empty partition, one with deletes) through a JAX ``Router``
  and a port ``Router`` built from the same tables: equal responses, equal
  typed errors, equal counters;
- shard snapshots written by either package restore and serve in the
  other, and ``tests/test_snapshot.py``'s ``StoreBackend`` directory cases
  over each package;
- ``tests/test_fabric.py``'s router and failure-injection scenarios and the
  fabric scenarios of ``tests/test_observability.py`` over the port;
- a shard server boots without torch: the modules import with ``torch``
  blocked, and the launcher brings a fabric up with ``import torch`` made
  to fail in every process.

Everything compared is integers or bytes, so every comparison is bitwise.
``test_fabric_qps_scaling_acceptance`` is not ported as a gate: it is a
timing, and ``chip_smoke.py``'s phase R prints it.
"""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from conftest import subprocess_env
import repro.api as japi
from repro.api import backends as jbackends
from repro.core import hashcore as jhc
from repro.core import query_types as jqt
from repro.core.hybrid_store import HybridKVStore as JStore
from repro.serve import fabric as jfabric
import repro_torch.api as tapi
from repro_torch.api import backends as tbackends
from repro_torch.api import wire as twire
from repro_torch.core import hashcore as thc
from repro_torch.core import query_types as tqt
from repro_torch.core.hybrid_store import HybridKVStore as TStore
from repro_torch.obs import exporter
from repro_torch.obs.bridge import bridge_router
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import sort_timeline
from repro_torch.serve import fabric as tfabric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(api=japi, qt=jqt, fabric=jfabric,
                                 backends=jbackends, Store=JStore),
    "torch": types.SimpleNamespace(api=tapi, qt=tqt, fabric=tfabric,
                                   backends=tbackends, Store=TStore),
}
N = 2000
VB = 8
WAIT_S = 30.0                  # every join and poll in this file


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 1 << 62, n * 2, dtype=np.uint64))[:n]


@pytest.fixture(scope="module")
def dataset():
    keys = _keys(N)
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 255, (N, VB), dtype=np.uint8)
    return keys, vals


def _build(pkg, root, keys, vals, *, n_shards=2, n_replicas=1, **kw):
    cfg = pkg.fabric.FabricConfig(n_shards=n_shards, n_replicas=n_replicas,
                                  snapshot_root=str(root),
                                  health_period_s=0.1, **kw)
    table = pkg.qt.EmbeddingTable("emb", keys, vals, hot_fraction=0.5,
                                  variant="neighborhash")
    return pkg.fabric.Router.build([table], cfg)


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 8])
def test_shard_of_keys_matches_jax_and_hashcore(n_shards):
    keys = np.concatenate([
        np.array([0, 1, (1 << 32) - 1, 1 << 32, (1 << 64) - 1],
                 dtype=np.uint64),
        np.random.default_rng(n_shards).integers(
            0, np.iinfo(np.uint64).max, 5000, dtype=np.uint64,
            endpoint=True)])
    got = tfabric.shard_of_keys(keys, n_shards)
    assert got.dtype == np.int32
    assert (got == jfabric.shard_of_keys(keys, n_shards)).all()
    hi, lo = thc.key_split_np(keys)
    expect = (thc.hash64_np(hi, lo) % np.uint32(n_shards)).astype(np.int32)
    assert (got == expect).all()
    jhi, jlo = jhc.key_split_np(keys)
    assert (expect == (jhc.hash64_np(jhi, jlo)
                       % np.uint32(n_shards)).astype(np.int32)).all()


# ---------------------------------------------------------------------------
# the router against the JAX router: one script, both packages
# ---------------------------------------------------------------------------
def _tables(pkg, seed=5):
    rng = np.random.default_rng(seed)
    keys = _keys(N, seed)
    emb = rng.integers(0, 256, (N, 16), dtype=np.uint8)
    attr_keys = keys[::3]
    attr = rng.integers(0, 256, (len(attr_keys), 8), dtype=np.uint8)
    return [pkg.qt.EmbeddingTable("emb", keys, emb, hot_fraction=0.25,
                                  variant="neighborhash"),
            pkg.qt.EmbeddingTable("attr", attr_keys, attr, hot_fraction=1.0,
                                  variant="coalesced")]


def _script(keys):
    """``(label, op)`` steps; an op is ``("query", tables, consistency)``
    (``consistency`` as ``(mode, version)``) or ``("update", version,
    upserts, deletes)`` or ``("snapshot",)``."""
    rng = np.random.default_rng(9)
    absent = np.arange(1, 9, dtype=np.uint64) << np.uint64(62)
    owners = jfabric.shard_of_keys(keys, 2)
    on0 = keys[owners == 0]
    q = keys[rng.integers(0, N, 300)]
    q = np.concatenate([q, q[:25], absent])
    attr_q = np.concatenate([keys[::3][:50], keys[1::3][:20], absent[:2]])
    both = np.concatenate([on0[:40], keys[owners == 1][:40]])
    up2 = (on0[:60], np.full((60, 16), 77, np.uint8))
    up3 = (keys[rng.integers(0, N, 200)],
           rng.integers(0, 256, (200, 16), dtype=np.uint8))
    return [
        ("latest", ("query", {"emb": q, "attr": attr_q}, ("latest", None))),
        ("pinned", ("query", {"emb": q}, ("pinned", 1))),
        ("hinted", ("query", {"attr": attr_q}, ("hinted", 1))),
        ("min_version", ("query", {"emb": q[:64]}, ("min_version", 1))),
        ("empty table", ("query", {"emb": q[:32],
                                   "attr": np.zeros(0, np.uint64)},
                         ("latest", None))),
        ("only absent", ("query", {"emb": absent}, ("latest", None))),
        ("update one shard", ("update", 2, {"emb": up2}, {})),
        ("both shards at v2", ("query", {"emb": both}, ("latest", None))),
        ("evicted pin", ("query", {"emb": both[:8]}, ("pinned", 1))),
        ("min_version above", ("query", {"emb": both[:8]},
                               ("min_version", 3))),
        ("update with deletes", ("update", 3, {"emb": up3},
                                 {"attr": keys[::3][:30]})),
        ("after deletes", ("query", {"emb": up3[0], "attr": attr_q},
                           ("latest", None))),
        ("hinted stale", ("query", {"emb": q}, ("hinted", 2))),
        ("snapshot", ("snapshot",)),
        ("pinned current", ("query", {"emb": q, "attr": attr_q},
                            ("pinned", 3))),
    ]


def _run_step(pkg, router, op):
    """One step: ``("ok", response or fleet version)`` or ``("error",
    type name, message)``."""
    try:
        if op[0] == "query":
            mode, v = op[2]
            cons = getattr(pkg.api.Consistency, mode)
            cons = cons() if v is None else cons(v)
            resp, info = router.query_ex(pkg.api.QueryRequest(
                tables=op[1], consistency=cons))
            return ("ok", resp, info)
        if op[0] == "update":
            router.apply_update(pkg.api.UpdateRequest(
                version=op[1], upserts=op[2], deletes=op[3]))
            return ("ok", router.fleet_version, None)
        router.snapshot_now()
        return ("ok", router.fleet_version, None)
    except Exception as e:  # noqa: BLE001  (compared by type name)
        return ("error", type(e).__name__, str(e))


def _same_response(a, b):
    assert a.version == b.version
    assert int(a.qos) == int(b.qos)
    assert sorted(a.tables) == sorted(b.tables)
    for name in a.tables:
        ta, tb = a.tables[name], b.tables[name]
        assert ta.found.dtype == tb.found.dtype == bool
        assert np.array_equal(ta.found, tb.found)
        assert ta.values.dtype == tb.values.dtype == np.uint8
        assert np.array_equal(ta.values, tb.values)


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """A JAX and a port router (2 shards x 1 replica, no respawner) from
    the same tables, each under its own snapshot root."""
    built = {}
    try:
        for name, pkg in PKGS.items():
            root = tmp_path_factory.mktemp(f"fabric-{name}")
            cfg = pkg.fabric.FabricConfig(n_shards=2, n_replicas=1,
                                          snapshot_root=str(root),
                                          respawn=False)
            built[name] = pkg.fabric.Router.build(_tables(pkg), cfg)
        yield built
    finally:
        for router in built.values():
            router.close()


def test_router_answers_the_script_like_the_jax_router(routers):
    keys = _keys(N, 5)
    ref = {int(k): row for k, row in zip(keys, _tables(PKGS["jax"])[0]
                                         .values)}
    errors = {}
    for label, op in _script(keys):
        got = {name: _run_step(PKGS[name], routers[name], op)
               for name in PKGS}
        j, t = got["jax"], got["torch"]
        assert j[0] == t[0], (label, j, t)
        if j[0] == "error":
            assert j[1:] == t[1:], (label, j, t)
            errors[label] = t[1]
            continue
        if op[0] != "query":
            assert j[1] == t[1], label
            continue
        _same_response(j[1], t[1])
        assert j[2] == t[2], label            # keys_deviceside, launches
        if label == "latest":                 # and right, not only equal
            emb = t[1].tables["emb"]
            assert not emb.found[-8:].any()
            for k, f, row in zip(op[1]["emb"][:-8], emb.found[:-8],
                                 emb.values[:-8]):
                assert f and np.array_equal(ref[int(k)], row)
    assert errors == {"evicted pin": "VersionEvictedError",
                      "min_version above": "ConsistencyError"}
    jm = routers["jax"].metrics.snapshot()
    tm = routers["torch"].metrics.snapshot()
    for field in ("queries", "sub_queries", "updates", "consistent_batches",
                  "snapshots", "version_retries", "failovers",
                  "replica_failures", "respawns"):
        assert getattr(jm, field) == getattr(tm, field), field
    assert jm.mixed_version_averted == tm.mixed_version_averted == 0
    assert tm.snapshots == 1 and tm.updates == 2


@pytest.mark.parametrize("pkg_name", sorted(PKGS))
def test_typed_errors_of_the_script(tmp_path, dataset, pkg_name):
    """The script's two refusals raise their own packages' classes."""
    pkg = PKGS[pkg_name]
    keys, vals = dataset
    router = _build(pkg, tmp_path / "snaps", keys, vals, respawn=False)
    try:
        with pytest.raises(pkg.qt.VersionEvictedError):
            router.query(pkg.api.QueryRequest(
                tables={"emb": keys[:8]},
                consistency=pkg.api.Consistency.pinned(0)))
        with pytest.raises(pkg.api.ConsistencyError):
            router.query(pkg.api.QueryRequest(
                tables={"emb": keys[:8]},
                consistency=pkg.api.Consistency.min_version(2)))
    finally:
        router.close()


# ---------------------------------------------------------------------------
# snapshots cross packages
# ---------------------------------------------------------------------------
def _serve_all(backend, keys, version):
    out = {}
    for name in backend.table_names:
        h = backend.begin({name: keys}, version=version, strict=True)
        res = backend.finish(h)
        out[name] = (res[name].found.copy(), res[name].values.copy())
    return out


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_router_snapshots_restore_in_the_other_package(tmp_path, dataset,
                                                       direction):
    src_name, dst_name = direction.split("->")
    src, dst = PKGS[src_name], PKGS[dst_name]
    keys, vals = dataset
    root = tmp_path / "snaps"
    router = _build(src, root, keys, vals, respawn=False)
    try:
        up = keys[::7]
        rows = np.full((len(up), VB), 201, np.uint8)
        router.apply_update(src.api.UpdateRequest(
            version=2, upserts={"emb": (up, rows)}, deletes={
                "emb": keys[1::50]}))
        router.snapshot_now()
        assert router.fleet_version == 2
    finally:
        router.close()
    absent = np.arange(1, 5, dtype=np.uint64) << np.uint64(62)
    probe = np.concatenate([keys, absent])
    owners = src.fabric.shard_of_keys(probe, 2)
    for s in range(2):
        path = str(root / f"shard{s}" / "v2")
        mine = src.backends.StoreBackend.load_snapshot(path)
        theirs = dst.backends.StoreBackend.load_snapshot(path)
        assert mine.latest_version == theirs.latest_version == 2
        assert mine.table_names == theirs.table_names == ["emb"]
        shard_keys = probe[owners == s]
        a = _serve_all(mine, shard_keys, 2)
        b = _serve_all(theirs, shard_keys, 2)
        assert np.array_equal(a["emb"][0], b["emb"][0])
        assert np.array_equal(a["emb"][1], b["emb"][1])
        found, got = b["emb"]
        deleted = np.isin(shard_keys, keys[1::50])
        assert not found[np.isin(shard_keys, absent) | deleted].any()
        assert found[~np.isin(shard_keys, absent) & ~deleted].all()
        updated = np.isin(shard_keys, up) & ~deleted
        assert (got[updated] == 201).all()
        rest = ~np.isin(shard_keys, up) & found
        assert np.array_equal(got[rest], vals[np.searchsorted(
            keys, shard_keys[rest])])


class TestStoreBackendSnapshot:
    """``tests/test_snapshot.py``'s ``StoreBackend`` directory cases (the
    respawn path) over each package, and the two packages' snapshots of
    one backend, byte for byte."""

    @staticmethod
    def _backend(pkg, seed=2):
        rng = np.random.default_rng(seed)
        stores = {}
        for name, vb in (("emb_a", 8), ("emb_b", 32)):
            keys = np.arange(1, 301, dtype=np.uint64)
            vals = rng.integers(0, 255, (300, vb), dtype=np.uint8)
            stores[name] = pkg.Store(keys, vals, hot_fraction=0.25)
        return pkg.backends.StoreBackend(stores, version=5)

    @pytest.mark.parametrize("pkg_name", sorted(PKGS))
    def test_directory_round_trip(self, tmp_path, pkg_name):
        pkg = PKGS[pkg_name]
        backend = self._backend(pkg)
        path = str(tmp_path / "snap")
        assert backend.snapshot_to(path) == 5
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        assert meta["version"] == 5
        assert meta["tables"] == ["emb_a", "emb_b"]
        back = pkg.backends.StoreBackend.load_snapshot(path)
        assert back.latest_version == 5
        assert back.table_names == backend.table_names
        keys = np.arange(1, 301, dtype=np.uint64)
        a, b = _serve_all(backend, keys, 5), _serve_all(back, keys, 5)
        for name in backend.table_names:
            assert np.array_equal(a[name][0], b[name][0])
            assert np.array_equal(a[name][1], b[name][1])

    @pytest.mark.parametrize("pkg_name", sorted(PKGS))
    def test_snapshot_then_update_then_resnapshot(self, tmp_path, pkg_name):
        pkg = PKGS[pkg_name]
        backend = self._backend(pkg)
        p5 = str(tmp_path / "v5")
        backend.snapshot_to(p5)
        keys = np.arange(1, 51, dtype=np.uint64)
        rows = np.full((50, 8), 9, np.uint8)
        backend.apply_update(pkg.api.UpdateRequest(
            version=6, upserts={"emb_a": (keys, rows)}))
        p6 = str(tmp_path / "v6")
        assert backend.snapshot_to(p6) == 6
        old = pkg.backends.StoreBackend.load_snapshot(p5)
        new = pkg.backends.StoreBackend.load_snapshot(p6)
        assert (old.latest_version, new.latest_version) == (5, 6)
        h = new.begin({"emb_a": keys}, version=6, strict=True)
        assert (new.finish(h)["emb_a"].values == 9).all()
        h = old.begin({"emb_a": keys}, version=5, strict=True)
        assert not (old.finish(h)["emb_a"].values == 9).all()

    @pytest.mark.parametrize("pkg_name", sorted(PKGS))
    def test_snapshot_replace_is_atomic_name(self, tmp_path, pkg_name):
        pkg = PKGS[pkg_name]
        backend = self._backend(pkg)
        path = str(tmp_path / "snap")
        backend.snapshot_to(path)
        first = sorted(os.listdir(path))
        backend.snapshot_to(path)
        assert sorted(os.listdir(path)) == first
        assert pkg.backends.StoreBackend.load_snapshot(path) \
            .latest_version == 5

    def test_both_packages_write_the_same_contents(self, tmp_path):
        """Equal file names, equal bytes, and for the ``.npz`` archives
        (whose zip headers carry a write time) equal arrays, bitwise, but
        for the index's build time in its JSON metadata."""
        paths = {}
        for name, pkg in PKGS.items():
            backend = self._backend(pkg)
            paths[name] = str(tmp_path / name)
            backend.snapshot_to(paths[name])
        files = sorted(os.listdir(paths["jax"]))
        assert files == sorted(os.listdir(paths["torch"]))
        for f in files:
            a, b = (os.path.join(paths[p], f) for p in ("jax", "torch"))
            if os.path.isdir(a):
                assert sorted(os.listdir(a)) == sorted(os.listdir(b)), f
                continue
            if f.endswith(".npz"):
                with np.load(a) as za, np.load(b) as zb:
                    assert sorted(za.files) == sorted(zb.files), f
                    for k in za.files:
                        assert za[k].dtype == zb[k].dtype, (f, k)
                        if k.endswith("_json"):
                            ja, jb = (json.loads(bytes(z[k]))
                                      for z in (za, zb))
                            for m in (ja, jb):
                                m.get("stats", {}).pop("build_seconds", None)
                            assert ja == jb, (f, k)
                            continue
                        assert np.array_equal(za[k], zb[k]), (f, k)
                continue
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


# ---------------------------------------------------------------------------
# test_fabric.py's router scenarios, over the port
# ---------------------------------------------------------------------------
T = PKGS["torch"]


class TestRouter:
    def test_oracle_merge_and_misses(self, tmp_path, dataset):
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, respawn=False)
        try:
            rng = np.random.default_rng(2)
            ref = {int(k): v for k, v in zip(keys, vals)}
            for _ in range(5):
                q = keys[rng.integers(0, N, 300)]
                q = np.concatenate([q, q[:20],           # dupes
                                    np.arange(1, 7, dtype=np.uint64) << 62])
                resp, info = router.query_ex(tapi.QueryRequest(
                    tables={"emb": q}))
                tr = resp.tables["emb"]
                assert resp.version == 1
                assert not tr.found[-6:].any()           # guaranteed misses
                for k, f, row in zip(q[:-6], tr.found[:-6], tr.values[:-6]):
                    assert f and (ref[int(k)] == row).all()
                assert info["launches"] <= 2
                assert info["keys_deviceside"] < len(q)  # dedup happened
            assert router.metrics.mixed_version_averted == 0
        finally:
            router.close()

    def test_update_fanout_and_empty_partition_bump(self, tmp_path,
                                                    dataset):
        """A delta whose keys all land on one shard must still advance the
        OTHER shard's version (bare bump), or pinned fan-outs would NACK
        on it forever."""
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, respawn=False)
        try:
            owners = tfabric.shard_of_keys(keys, 2)
            shard0 = keys[owners == 0][:40]
            rows = np.full((len(shard0), VB), 77, np.uint8)
            router.apply_update(tapi.UpdateRequest(
                version=2, upserts={"emb": (shard0, rows)}))
            assert router.fleet_version == 2
            q = np.concatenate([shard0, keys[owners == 1][:40]])
            resp = router.query(tapi.QueryRequest(tables={"emb": q}))
            assert resp.version == 2
            assert (resp.tables["emb"].values[:len(shard0)] == 77).all()
            # the shard that got no rows serves v2 too, asked directly
            _, data = router.replicas[1][0].call(
                twire.KIND_HEALTH, twire.encode_tree({}), timeout=WAIT_S)
            assert twire.decode_tree(data)["version"] == 2
            with pytest.raises(tqt.VersionEvictedError):
                router.query(tapi.QueryRequest(
                    tables={"emb": q[:8]},
                    consistency=tapi.Consistency.pinned(1)))
            with pytest.raises(ValueError):
                router.apply_update(tapi.UpdateRequest(
                    version=2, upserts={"emb": (shard0, rows)}))
        finally:
            router.close()

    def test_unknown_table_raises_keyerror(self, tmp_path, dataset):
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, n_shards=1,
                        respawn=False)
        try:
            with pytest.raises(KeyError):
                router.apply_update(tapi.UpdateRequest(
                    version=2, upserts={"nope": (keys[:4], vals[:4])}))
        finally:
            router.close()

    def test_feature_client_through_fabric_backend(self, tmp_path, dataset):
        """as_backend(Router) -> FabricBackend -> FeatureClient: the same
        session API the in-process servers speak."""
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, n_shards=1,
                        respawn=False)
        try:
            backend = tapi.as_backend(router)
            assert isinstance(backend, tbackends.FabricBackend)
            client = tapi.FeatureClient(backend)
            res = client.query({"emb": keys[:100]})
            assert res.version == 1
            assert (res["emb"].values == vals[:100]).all()
        finally:
            router.close()


# ---------------------------------------------------------------------------
# test_fabric.py's failure injection, over the port
# ---------------------------------------------------------------------------
def _replica_rows(handle, keys, version):
    """One replica asked directly: a pinned query at ``version``."""
    _, data = handle.call(twire.KIND_QUERY, twire.encode_request(
        tapi.QueryRequest(tables={"emb": keys},
                          consistency=tapi.Consistency.pinned(version))),
        timeout=WAIT_S)
    res = twire.decode_response(data)
    return res.version, res.tables["emb"].found, res.tables["emb"].values


class TestFailureInjection:
    def test_kill_one_replica_of_two_mid_load(self, tmp_path, dataset):
        """2 shards x 2 replicas, constant query load, an update every
        ~80 ms (each rewrites every row to its version), one replica
        killed mid-stream: no batch mixes versions, no request is lost (a
        response or a typed error), at least one failover or version
        retry, and the victim respawns from snapshot + update-log replay
        at the fleet version with rows bitwise its survivor's."""
        keys, _ = dataset
        v1 = np.full((N, VB), 1, np.uint8)
        router = _build(T, tmp_path / "snaps", keys, v1, n_replicas=2,
                        snapshot_every=3)
        mixed, lost, completed, typed_errors = [], [], [0], [0]
        stop = threading.Event()
        lock = threading.Lock()

        def worker(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                q = keys[rng.integers(0, N, 128)]
                try:
                    resp = router.query(tapi.QueryRequest(
                        tables={"emb": q}))
                except (tfabric.FabricError, tqt.VersionEvictedError):
                    with lock:
                        typed_errors[0] += 1
                    continue
                except BaseException as e:  # noqa: BLE001
                    with lock:
                        lost.append(repr(e))
                    continue
                tr = resp.tables["emb"]
                consts = np.unique(tr.values[tr.found])
                if len(consts) > 1 or (len(consts) == 1 and
                                       consts[0] != resp.version % 256):
                    with lock:
                        mixed.append((resp.version, consts.tolist()))
                with lock:
                    completed[0] += 1

        workers = [threading.Thread(target=worker, args=(10 + i,))
                   for i in range(3)]
        try:
            for t in workers:
                t.start()
            version = 1
            for step in range(12):
                version += 1
                rows = np.full((N, VB), version % 256, np.uint8)
                router.apply_update(tapi.UpdateRequest(
                    version=version, upserts={"emb": (keys, rows)}))
                if step == 4:
                    router.replicas[0][0].kill()
                time.sleep(0.08)
        finally:
            stop.set()
            for t in workers:
                t.join(timeout=WAIT_S)
        try:
            assert not any(t.is_alive() for t in workers)
            assert completed[0] > 20, (completed, typed_errors, lost)
            assert mixed == [], mixed
            assert lost == [], lost
            assert router.metrics.mixed_version_averted == 0
            assert router.metrics.replica_failures >= 1
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline:
                h = router.replicas[0][0]
                if h is not None and h.alive:
                    _, data = h.call(twire.KIND_HEALTH,
                                     twire.encode_tree({}), timeout=5)
                    if twire.decode_tree(data)["version"] \
                            == router.fleet_version:
                        break
                time.sleep(0.1)
            else:
                pytest.fail("killed replica never rejoined at fleet "
                            "version")
            assert router.metrics.respawns >= 1
            v = router.fleet_version
            mine = tfabric.shard_of_keys(keys, 2) == 0
            respawned = _replica_rows(router.replicas[0][0], keys[mine], v)
            survivor = _replica_rows(router.replicas[0][1], keys[mine], v)
            assert respawned[0] == survivor[0] == v
            assert respawned[1].all() and survivor[1].all()
            assert np.array_equal(respawned[2], survivor[2])
            assert (respawned[2] == v % 256).all()
            resp = router.query(tapi.QueryRequest(tables={"emb": keys[:64]}))
            assert resp.version == router.fleet_version
        finally:
            router.close()

    def test_failover_moves_in_flight_work_to_the_survivor(self, tmp_path,
                                                           dataset):
        """A sub-query in flight on a replica that dies is re-dispatched to
        its survivor: the replica is stopped (SIGSTOP) so that it cannot
        answer, a query is sent to it (round robin starts at replica 0),
        then it is killed.  The query completes from the survivor with
        exactly one failover, and so does every query after it."""
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, n_shards=1,
                        n_replicas=2, respawn=False)
        try:
            victim = router.replicas[0][0]
            os.kill(victim.process.pid, signal.SIGSTOP)
            done = {}

            def ask():
                try:
                    done["resp"] = router.query(tapi.QueryRequest(
                        tables={"emb": keys[:64]}))
                except BaseException as e:  # noqa: BLE001
                    done["error"] = e

            t = threading.Thread(target=ask)
            t.start()
            deadline = time.monotonic() + WAIT_S
            while router.metrics.sub_queries < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)
            assert "resp" not in done        # the stopped replica holds it
            victim.process.kill()
            t.join(WAIT_S)
            assert not t.is_alive()
            assert "error" not in done, done.get("error")
            assert np.array_equal(done["resp"].tables["emb"].values,
                                  vals[:64])
            assert router.metrics.failovers == 1
            for i in range(1, 6):
                q = keys[64 * i:64 * (i + 1)]
                resp = router.query(tapi.QueryRequest(tables={"emb": q}))
                assert np.array_equal(resp.tables["emb"].values,
                                      vals[64 * i:64 * (i + 1)])
            stats = router.collect_shard_stats()
            assert set(stats) == {"shard0/r1"}
            assert stats["shard0/r1"]["server"]["submitted"] == 6
            assert router.metrics.respawns == 0
        finally:
            router.close()

    def test_whole_group_down_is_typed_not_hang(self, tmp_path, dataset):
        keys, vals = dataset
        router = _build(T, tmp_path / "snaps", keys, vals, n_shards=1,
                        n_replicas=1, respawn=False)
        try:
            router.replicas[0][0].kill()
            router.replicas[0][0].process.join(WAIT_S)
            deadline = time.monotonic() + WAIT_S
            while router.replicas[0][0].alive \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            t0 = time.monotonic()
            with pytest.raises(tfabric.NoReplicaError):
                router.query(tapi.QueryRequest(tables={"emb": keys[:16]}))
            assert time.monotonic() - t0 < WAIT_S
            # and the error crosses the port's wire typed
            got = twire.decode_error(twire.encode_error(
                tfabric.NoReplicaError("shard 0 has no live replica")))
            assert type(got) is tfabric.NoReplicaError
        finally:
            router.close()


# ---------------------------------------------------------------------------
# test_observability.py's fabric scenarios, over the port
# ---------------------------------------------------------------------------
def _build_fabric(tmp_path, *, trace_rate=0.0):
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 62, 4000,
                                  dtype=np.uint64))[:2000]
    vals = rng.integers(0, 256, size=(len(keys), 16), dtype=np.uint8)
    cfg = tfabric.FabricConfig(n_shards=2, n_replicas=1,
                               snapshot_root=str(tmp_path / "snaps"),
                               respawn=False, trace_sample_rate=trace_rate)
    table = tqt.EmbeddingTable("emb", keys, vals, hot_fraction=0.5,
                               variant="neighborhash")
    return tfabric.Router.build([table], cfg), keys


class TestFabricObservability:
    def test_sampled_query_merges_one_cross_process_trace(self, tmp_path):
        router, keys = _build_fabric(tmp_path, trace_rate=1.0)
        try:
            resp, _ = router.query_ex(tapi.QueryRequest(
                tables={"emb": keys[:256]}))
            assert resp.trace, "sampled fabric query returned no trace"
            names = [d["name"] for d in resp.trace]
            procs = {d["proc"] for d in resp.trace}
            tids = {d["trace_id"] for d in resp.trace}
            assert len(tids) == 1, f"trace ids fragmented: {tids}"
            for want in ("route", "shard_rpc", "serve", "admission",
                         "lane_wait", "coalesce", "version_pin", "begin",
                         "device", "finish", "scatter"):
                assert want in names, f"missing span {want!r}"
            assert {p for p in procs if p.startswith("shard")} \
                == {"shard0/r0", "shard1/r0"}
            assert "router" in procs
            spans = router.tracer.take(resp.trace[0]["trace_id"])
            assert spans
            assert sort_timeline(spans)[0].name == "route"
        finally:
            router.close()

    def test_unsampled_fabric_query_carries_no_trace(self, tmp_path):
        router, keys = _build_fabric(tmp_path, trace_rate=0.0)
        try:
            resp, _ = router.query_ex(tapi.QueryRequest(
                tables={"emb": keys[:64]}))
            assert resp.trace is None
        finally:
            router.close()

    def test_stats_rpc_and_router_bridge(self, tmp_path):
        router, keys = _build_fabric(tmp_path)
        try:
            for i in range(4):
                router.query_ex(tapi.QueryRequest(
                    tables={"emb": keys[64 * i:64 * (i + 1)]}))
            shards = router.collect_shard_stats()
            assert set(shards) == {"shard0/r0", "shard1/r0"}
            for silo in shards.values():
                assert silo["server"]["submitted"] >= 1
                assert silo["tiers"]["emb"]["lookups"] >= 1
            reg = Registry()
            bridge_router(reg, router)
            parsed = exporter.parse_text(exporter.render_text(reg))
            assert parsed[("repro_fabric_queries_total", ())] == 4.0
            key = (("shard", "shard0/r0"),)
            assert parsed[("repro_server_requests_submitted_total",
                           key)] >= 1.0
            assert ("repro_tier_hot_hit_rate",
                    (("shard", "shard0/r0"), ("table", "emb"))) in parsed
        finally:
            router.close()


def _lines_of(proc):
    """The child's output lines, read on a thread into a queue (None at
    EOF), so that no read blocks a test past its timeout."""
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return lines


def test_launcher_serves_metrics_and_emits_record(tmp_path):
    """``python -m repro_torch.launch.fabric --smoke --metrics-port 0``
    prints the bound ``/metrics`` URL, a mid-run scrape reads the fabric,
    server and tier families, and the exit record carries the final
    snapshot in the JAX launcher's format."""
    record = tmp_path / "fabric_smoke.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fabric", "--smoke",
         "--batch-keys", "2048", "--metrics-port", "0",
         "--trace-sample", "0.2", "--record", str(record),
         "--snapshot-root", str(tmp_path / "snaps")],
        cwd=REPO, env=subprocess_env(inherit=True), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, out = _lines_of(proc), []
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            out.append(line)
            if line.startswith("metrics: serving "):
                url = line.split()[-1]
        assert url and url.startswith("http://127.0.0.1:"), "".join(out)
        parsed = None
        while parsed is None and time.monotonic() < deadline \
                and proc.poll() is None:
            try:
                body = urllib.request.urlopen(url, timeout=5).read().decode()
                got = exporter.parse_text(body)
                if any(k[0] == "repro_fabric_queries_total" and v > 0
                       for k, v in got.items()):
                    parsed = got
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.05)
        assert parsed is not None, "never scraped /metrics with traffic"
        names = {k[0] for k in parsed}
        for want in ("repro_tier_hot_hit_rate",
                     "repro_server_class_latency_p99_ms",
                     "repro_server_shed_queue_full_total",
                     "repro_fabric_version_retries_total",
                     "repro_fabric_failovers_total"):
            assert want in names, want
        assert sum(v for k, v in parsed.items()
                   if k[0] == "repro_tier_hot_hits_total") > 0
        proc.wait(timeout=150)
        while (line := lines.get(timeout=WAIT_S)) is not None:
            out.append(line)
        assert proc.returncode == 0, "".join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    rec = json.loads(record.read_text())
    assert set(rec) == {"alias", "unix_time", "duration_s", "ok", "shards",
                        "replicas", "metrics"}
    assert rec["ok"] is True and rec["alias"] == "fabric_smoke"
    assert (rec["shards"], rec["replicas"]) == (2, 2)
    assert any(k.startswith("repro_fabric_queries_total")
               for k in rec["metrics"])


def test_launcher_main_runs_in_process(tmp_path, capsys):
    from repro_torch.launch import fabric as launch_fabric
    record = tmp_path / "rec.json"
    with pytest.raises(SystemExit) as e:
        launch_fabric.main(["--smoke", "--requests", "3", "--clients", "2",
                            "--shards", "3", "--replicas", "1",
                            "--snapshot-root", str(tmp_path / "snaps"),
                            "--record", str(record)])
    assert e.value.code == 0, capsys.readouterr().out
    out = capsys.readouterr().out
    assert "fabric: 3 shards x 1 replicas up" in out
    assert "mixed_averted=0" in out
    rec = json.loads(record.read_text())
    assert rec["ok"] is True and rec["shards"] == 3
    assert rec["metrics"]["repro_fabric_queries_total"] == 6.0


# ---------------------------------------------------------------------------
# a shard server boots without torch
# ---------------------------------------------------------------------------
def test_fabric_imports_with_torch_blocked():
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serve.fabric, repro_torch.launch.fabric\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and\n"
            "       m.split('.')[0] in ('torch', 'jax', 'repro')]\n"
            "sys.exit(f'imported {bad}' if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=subprocess_env())
    assert r.returncode == 0, r.stderr[-3000:]


def test_fabric_comes_up_where_torch_cannot_import(tmp_path):
    """``import torch`` raises in the launcher and, through the inherited
    ``PYTHONPATH``, in every spawned shard server: the fabric still comes
    up, serves and survives chaos."""
    shim = tmp_path / "shim" / "torch"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('torch is blocked for this fabric')\n")
    env = subprocess_env(pythonpath=f"{shim.parent}{os.pathsep}src")
    blocked = subprocess.run([sys.executable, "-c", "import torch"],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
    assert blocked.returncode != 0
    assert "torch is blocked" in blocked.stderr
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fabric", "--smoke",
         "--requests", "8", "--chaos", "--snapshot-root",
         str(tmp_path / "snaps")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert "2 shards x 2 replicas up" in r.stdout
    assert "mixed_averted=0" in r.stdout


def test_chip_smoke_phase_r_rehearses_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase R at a small size: its child interpreter
    (the source of ``R_CHILD`` through ``python -c``) and the launcher run
    with ``import torch`` blocked, hold every answer and every replica to
    the rows as written, see a respawn, and write a record."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    r1 = {**chip_smoke.R1, "rows": 20_000, "batches": 10,
          "batch_keys": 1024, "publish_s": 0.05, "chaos_s": 0.3}
    r3 = {**chip_smoke.R3, "rows": 5000, "clients": 4, "queries": 5}
    m = chip_smoke.run_phase_r(r1=r1, r3=r3)
    out = capsys.readouterr().out
    assert "[R] R.1: 2 shards x 2 replicas over 20000 rows" in out
    c = m["r1"]["counts"]
    assert c["respawns"] >= 1 and c["mixed_version_averted"] == 0
    assert m["r1"]["answers_checked"] + m["r1"]["fabric_errors"] == 40
    assert m["r1"]["readback_keys"] == 2 * m["r1"]["keys_written"]
    assert m["r1"]["kill_to_first_answer_s"]
    assert m["r2"]["alias"] == "fabric_chaos" and m["r2"]["queries"] > 0
    assert set(m["r3"]["qps"]) == {"1", "4"}
    assert not os.path.exists(os.path.join(REPO, "build",
                                           "chip_smoke_fabric"))
