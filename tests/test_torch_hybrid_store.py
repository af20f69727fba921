"""The port's ``core/hybrid_store.HybridKVStore`` against the JAX package's,
on the CPU.  Both are host code over the same NeighborHash builder, so
the comparison is exact: a seeded sequence of operations (builds at
several hot fractions and index variants, ``get_batch`` with and without
admission over present and absent keys, ``update_value``,
``upsert_batch`` in place and copy-on-write, ``delete_batch``,
``clone``, ``set_hot_fraction``, ``set_compaction_threshold``,
``maintain``, ``compact``) runs through one store of each package, and
after every step the rows must be equal bit for bit and the stats
(``stats_snapshot``, ``memory_bytes``, ``garbage_fraction``,
``hot_fraction``, each operation's own return) equal.  A store saved by
either package loads in the other."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import hybrid_store as jhs
from repro_torch.core import hybrid_store as ths

VALUE_BYTES = 24


def _stores(tmp_path, n, hot_fraction, variant, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, n, replace=False).astype(np.uint64) + 1
    values = rng.integers(0, 256, (n, VALUE_BYTES), dtype=np.uint8)
    out = []
    for mod, sub in ((jhs, "jax"), (ths, "torch")):
        d = tmp_path / sub
        d.mkdir()
        out.append(mod.HybridKVStore(keys, values, hot_fraction=hot_fraction,
                                     variant=variant, cold_dir=str(d)))
    return keys, out


def _read(store, name):
    """``store.<name>``, or the name of the error reading it raises (a
    clone carries no compaction threshold in either package)."""
    try:
        return getattr(store, name)
    except AttributeError as e:
        return type(e).__name__


def _state(store):
    return (dataclasses.asdict(store.stats_snapshot()), store.memory_bytes(),
            store.garbage_fraction, store.hot_fraction,
            _read(store, "compaction_threshold"), store.n)


def _plain(ret):
    """An operation's return with file paths dropped (each package names
    its own cold-file generations)."""
    if isinstance(ret, dict):
        return {k: v for k, v in ret.items() if "path" not in k
                and "file" not in k}
    return ret


def _same_rows(a, b, keys):
    for admit in (False, True):
        fa, va = a.get_batch(keys, admit=admit)
        fb, vb = b.get_batch(keys, admit=admit)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va, vb)


def _run(stores, keys, seed, steps):
    """``steps`` seeded operations on both stores; each compared."""
    rng = np.random.default_rng(seed + 100)
    live = list(keys)
    fresh = iter(range(1 << 41, (1 << 41) + 10**6))
    ops = ("get", "get", "get", "update", "upsert", "upsert_cow", "delete",
           "hot", "threshold", "maintain", "compact", "clone")
    for step in range(steps):
        op = ops[int(rng.integers(len(ops)))]
        ja, tb = stores
        if op == "get":
            n = int(rng.integers(1, 300))
            q = np.asarray(live, dtype=np.uint64)[rng.integers(
                0, len(live), n)]
            absent = rng.random(n) < 0.1
            q[absent] = rng.integers(1 << 42, 1 << 43, int(absent.sum()))
            admit = bool(rng.random() < 0.7)
            rets = [s.get_batch(q, admit=admit) for s in stores]
            np.testing.assert_array_equal(rets[0][0], rets[1][0])
            np.testing.assert_array_equal(rets[0][1], rets[1][1])
        elif op == "update":
            k = live[int(rng.integers(len(live)))]
            v = rng.integers(0, 256, VALUE_BYTES, dtype=np.uint8)
            for s in stores:
                s.update_value(int(k), v)
        elif op in ("upsert", "upsert_cow"):
            n_old, n_new = int(rng.integers(0, 40)), int(rng.integers(0, 20))
            ks = [live[int(i)] for i in rng.integers(0, len(live), n_old)]
            ks += [next(fresh) for _ in range(n_new)]
            if not ks:
                continue
            vals = rng.integers(0, 256, (len(ks), VALUE_BYTES),
                                dtype=np.uint8)
            rets = [s.upsert_batch(np.asarray(ks, dtype=np.uint64), vals,
                                   copy_on_write=op == "upsert_cow")
                    for s in stores]
            assert _plain(rets[0]) == _plain(rets[1])
            live += [k for k in ks if k not in set(live)]
        elif op == "delete":
            if len(live) < 50:
                continue
            idx = rng.choice(len(live), int(rng.integers(1, 10)),
                             replace=False)
            ks = np.asarray([live[i] for i in idx], dtype=np.uint64)
            assert ja.delete_batch(ks) == tb.delete_batch(ks)
            gone = set(ks.tolist())
            live = [k for k in live if int(k) not in gone]
        elif op == "hot":
            frac = float(rng.choice([0.0, 0.02, 0.1, 0.3, 0.75, 1.0]))
            assert _plain(ja.set_hot_fraction(frac)) == \
                _plain(tb.set_hot_fraction(frac))
        elif op == "threshold":
            t = float(rng.choice([0.05, 0.25, 0.6, 1.0]))
            for s in stores:
                s.set_compaction_threshold(t)
        elif op == "maintain":
            f = float(rng.choice([0.0, 0.05, 0.5]))
            assert ja.maintain(f) == tb.maintain(f)
        elif op == "compact":
            g = float(rng.choice([0.0, 0.01, 0.2]))
            assert _plain(ja.compact(min_garbage_fraction=g)) == \
                _plain(tb.compact(min_garbage_fraction=g))
        elif op == "clone":
            stores = [s.clone() for s in stores]
            _same_rows(stores[0], ja, np.asarray(live, dtype=np.uint64))
            _same_rows(stores[1], tb, np.asarray(live, dtype=np.uint64))
        assert _state(stores[0]) == _state(stores[1]), (step, op)
    _same_rows(*stores, np.asarray(live, dtype=np.uint64))
    assert _state(stores[0]) == _state(stores[1])
    return stores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hot_fraction", [0.0, 0.1, 0.5, 1.0])
def test_operation_sequences_match_reference(tmp_path, hot_fraction, seed):
    keys, stores = _stores(tmp_path, 2000, hot_fraction, "neighborhash",
                           seed)
    assert _state(stores[0]) == _state(stores[1])
    _same_rows(*stores, keys)
    for s in _run(stores, keys, seed, steps=80):
        s.close()


@pytest.mark.parametrize("variant", ["linear", "coalesced",
                                     "neighbor_probing"])
def test_index_variants_match_reference(tmp_path, variant):
    keys, stores = _stores(tmp_path, 1500, 0.2, variant, 5)
    for s in _run(stores, keys, 5, steps=40):
        s.close()


def test_hot_keys_and_tier_moves_match_reference(tmp_path):
    """A requested hot set, then a skewed read stream that admits and
    evicts: the same tier of every key and the same counters."""
    rng = np.random.default_rng(11)
    keys = np.arange(1, 3001, dtype=np.uint64) * 7
    values = rng.integers(0, 256, (3000, VALUE_BYTES), dtype=np.uint8)
    stores = []
    for mod, sub in ((jhs, "jax"), (ths, "torch")):
        d = tmp_path / sub
        d.mkdir()
        stores.append(mod.HybridKVStore(keys, values, hot_fraction=0.05,
                                        hot_keys=keys[::97],
                                        cold_dir=str(d)))
    for _ in range(30):
        q = keys[(rng.zipf(1.2, 500) - 1) % len(keys)]
        rets = [s.get_batch(q) for s in stores]
        np.testing.assert_array_equal(rets[0][1], rets[1][1])
        assert _state(stores[0]) == _state(stores[1])
        assert stores[0].maintain(0.2) == stores[1].maintain(0.2)
    snap = stores[1].stats_snapshot()
    assert snap.admissions > 0 and snap.evictions > 0 and snap.hot_hits > 0
    for s in stores:
        s.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_store_loads_in_the_other_package(tmp_path, writer):
    keys, stores = _stores(tmp_path, 1000, 0.2, "neighborhash", 9)
    stores = _run(stores, keys, 9, steps=30)
    src, dst_mod = ((stores[0], ths) if writer == "jax"
                    else (stores[1], jhs))
    prefix = str(tmp_path / "saved")
    src.save(prefix)
    loaded = dst_mod.HybridKVStore.load(prefix)
    q = np.concatenate([keys, np.arange(1, 50, dtype=np.uint64)])
    _same_rows(src, loaded, q)
    for s in (*stores, loaded):
        s.close()
