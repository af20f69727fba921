"""The port's MultiTableEngine (``device="cpu"``: the plain probe) against
the JAX package's, driven through the same sequences: every QueryResult and
EngineStats (``launches`` included) must be equal, across publish,
publish_delta, retention eviction, NACK/re-pin and strict pins — directly
and through FeatureClient(EngineBackend)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Consistency as RefConsistency
from repro.api import EngineBackend as RefBackend
from repro.api import FeatureClient as RefClient
from repro.core import engine as ref_eng
from repro.core import neighborhash as ref_nh
from repro_torch import api
from repro_torch.core import engine as eng

SHARD_BYTES = 1 << 15


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    item_keys, item_payloads = ref_nh.random_kv(4_000, seed=1)
    cat_keys, cat_payloads = ref_nh.random_kv(1_000, seed=2)
    emb_keys = np.arange(1, 1_001, dtype=np.uint64)
    emb_values = rng.integers(0, 255, size=(1_000, 16), dtype=np.uint8)
    return item_keys, item_payloads, cat_keys, cat_payloads, emb_keys, \
        emb_values


def _tables(mod, ds, bump=0, cat_variant="coalesced"):
    ik, ip, ck, cp, ek, ev = ds
    return ([mod.ScalarTable("item_attr", ik, ip + np.uint64(bump)),
             mod.ScalarTable("cat_attr", ck, cp, variant=cat_variant)],
            [mod.EmbeddingTable("item_emb", ek, ev, hot_fraction=0.2)])


class Twin:
    """The reference engine and the port's, fed the same calls."""

    def __init__(self, ds, **kw):
        self.ref = ref_eng.MultiTableEngine(
            *_tables(ref_eng, ds), max_shard_bytes=SHARD_BYTES, **kw)
        self.port = eng.MultiTableEngine(
            *_tables(eng, ds), max_shard_bytes=SHARD_BYTES, device="cpu",
            **kw)

    def call(self, method, *args, **kw):
        """Same call on both; same result or same exception type."""
        out = []
        for e in (self.ref, self.port):
            try:
                out.append(("ok", getattr(e, method)(*args, **kw)))
            except Exception as exc:                # noqa: BLE001
                out.append(("raised", type(exc).__name__))
        (rk, rv), (pk, pv) = out
        assert rk == pk, (method, out)
        if rk == "raised":
            assert rv == pv
            return None
        return rv, pv

    def query(self, *args, **kw):
        got = self.call("query", *args, **kw)
        if got is not None:
            same_result(*got)
        self.same_stats()
        return got

    def same_stats(self):
        assert dataclasses.asdict(self.port.stats) == \
            dataclasses.asdict(self.ref.stats)
        assert self.port.versions == self.ref.versions


def same_result(want, got):
    assert got.version == want.version
    assert sorted(got.tables) == sorted(want.tables)
    for name, w in want.tables.items():
        g = got.tables[name]
        np.testing.assert_array_equal(g.found, w.found, err_msg=name)
        for field in ("payloads", "values"):
            wv, gv = getattr(w, field), getattr(g, field)
            assert (wv is None) == (gv is None), (name, field)
            if wv is not None:
                assert gv.dtype == wv.dtype
                np.testing.assert_array_equal(gv, wv, err_msg=name)


def _request(ds, rng, n=2048):
    ik, _, ck, _, ek, _ = ds
    z = lambda vocab, size: ((rng.zipf(1.1, size) - 1) % vocab)  # noqa: E731
    return {
        "item_attr": np.concatenate([
            ik[z(len(ik), n)], rng.integers(2**62, 2**63, 64)
            .astype(np.uint64)]),
        "cat_attr": ck[z(300, n)],
        "item_emb": np.concatenate([ek[z(len(ek), n // 2)],
                                    np.arange(3000, 3016, dtype=np.uint64)]),
    }


@pytest.fixture(scope="module")
def twin(dataset):
    return Twin(dataset)


def test_fused_query_and_stats_match(dataset, twin):
    rng = np.random.default_rng(7)
    for _ in range(3):
        twin.query(_request(dataset, rng))
    assert twin.port.stats.launches >= 1
    assert twin.port.stats.dedup_rate > 0.2


def test_query_stream_matches(dataset, twin):
    rng = np.random.default_rng(11)
    reqs = [_request(dataset, rng, n=512) for _ in range(4)]
    for want, got in zip(twin.ref.query_stream(reqs),
                         twin.port.query_stream(reqs)):
        same_result(want, got)
    twin.same_stats()


def test_subset_reordered_and_unknown_tables(dataset, twin):
    ik, _, ck, _, _, _ = dataset
    twin.query({"cat_attr": ck[:200]})
    twin.query({"item_attr": ik[:200]})
    twin.query({"cat_attr": ck[:50], "item_attr": ik[:50]})
    twin.query({"nope": ik[:3]})                    # KeyError on both


def test_publish_retention_nack_and_strict(dataset):
    t = Twin(dataset, retain=2)
    ik, _, ck, _, _, _ = dataset
    req = {"item_attr": ik[:64], "cat_attr": ck[:64]}
    for v, bump in ((2, 1), (3, 2)):
        t.ref.publish(v, *_tables(ref_eng, dataset, bump=bump))
        t.port.publish(v, *_tables(eng, dataset, bump=bump))
        t.query(req, version=v - 1)                 # retained previous
        t.query(req)                                # latest
    t.query(req, version=1)                         # evicted: NACK, re-pin
    assert t.port.stats.repins == 1
    t.query(req, version=1, strict=True)            # evicted: raises
    t.query(req, version=99, strict=True)


def test_publish_delta_copy_on_write(dataset):
    t = Twin(dataset)
    ik, ip, ck, _, ek, ev = dataset
    rng = np.random.default_rng(3)
    # a scalar delta confined to shard 0: updates, new keys, a delete
    plan = t.port.window.get(None)[2].plan
    fresh = rng.integers(2**62, 2**63, 64).astype(np.uint64)
    uk = np.concatenate([ik[plan.shard_of_np(ik) == 0][:3],
                         fresh[plan.shard_of_np(fresh) == 0][:2]])
    up = rng.integers(0, 2**52 - 1, len(uk)).astype(np.uint64)
    rows = rng.integers(0, 255, (8, ev.shape[1]), dtype=np.uint8)
    upserts = {"item_attr": (uk, up), "item_emb": (ek[:8], rows)}
    deletes = {"cat_attr": ck[plan.shard_of_np(ck) == 0][:1],
               "item_emb": ek[8:10]}
    t.call("publish_delta", 2, upserts=upserts, deletes=deletes)
    t.same_stats()
    assert t.port.stats.shards_shared > 0           # untouched shards shared
    req = {"item_attr": np.concatenate([uk, ik[:100]]),
           "cat_attr": ck[:20], "item_emb": ek[:16]}
    t.query(req, version=1, strict=True)            # old rows, bitwise
    t.query(req, version=2, strict=True)
    t.call("publish_delta", 3, upserts={"nope": (uk, up)})   # KeyError
    # untouched shards keep the previous build's device tensors
    old = t.port.window.get(1)[2]
    new_b = t.port.window.get(2)[2]
    shared = [s for s in range(new_b.n_shards)
              if new_b.groups[s] is old.groups[s]]
    assert len(shared) == t.port.stats.shards_shared


def test_interleaved_deltas_never_mix_versions(dataset):
    ik, ip, _, _, _, _ = dataset
    t = Twin(dataset, retain=3)
    for v in range(2, 6):
        upd = ik[(v * 37) % 1000:(v * 37) % 1000 + 50]
        pay = np.full(len(upd), v, dtype=np.uint64)
        t.call("publish_delta", v, upserts={"item_attr": (upd, pay)})
        t.query({"item_attr": ik[:200]}, version=v - 1, strict=True)
        t.query({"item_attr": ik[:200]}, version=v - 3, strict=True)
        t.query({"item_attr": ik[:200]}, version=v - 3)


def test_feature_client_through_engine_backend(dataset):
    t = Twin(dataset)
    ik, ip, ck, _, ek, ev = dataset
    ref_c = RefClient(RefBackend(t.ref))
    port_c = api.FeatureClient(api.EngineBackend(t.port))
    assert isinstance(api.as_backend(t.port), api.EngineBackend)
    req = {"item_attr": ik[:500], "item_emb": ek[:300]}
    same_result(ref_c.query(req), port_c.query(req))
    upserts = {"item_attr": (ik[:64], ip[:64] ^ np.uint64(1)),
               "item_emb": (ek[:64], ev[:64] ^ np.uint8(1))}
    ref_c.update(2, upserts=upserts)
    port_c.update(2, upserts=upserts)
    for rc, pc in ((RefConsistency.min_version(2),
                    api.Consistency.min_version(2)),
                   (RefConsistency.pinned(1), api.Consistency.pinned(1)),
                   (RefConsistency.hinted(7), api.Consistency.hinted(7))):
        same_result(ref_c.query(req, consistency=rc),
                    port_c.query(req, consistency=pc))
    t.same_stats()
    with pytest.raises(api.ConsistencyError):
        port_c.query(req, consistency=api.Consistency.min_version(3))


def test_empty_engine_and_default_device():
    t_ref, t_port = ref_eng.MultiTableEngine(), \
        eng.MultiTableEngine(device="cpu")
    for e in (t_ref, t_port):
        with pytest.raises(RuntimeError):
            e.query({"nope": np.arange(3, dtype=np.uint64)})
        with pytest.raises(RuntimeError):
            e.publish_delta(1, upserts={"t": (np.arange(3, dtype=np.uint64),
                                              np.arange(3,
                                                        dtype=np.uint64))})
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.MultiTableEngine()
