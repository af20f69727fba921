"""The port's host builders, snapshots and line packing against the JAX
package's, bitwise: same keys in, same bucket arrays out."""
import dataclasses

import numpy as np
import pytest

from repro.core import neighborhash as ref_nh
from repro.kernels import neighbor_lookup as ref_nl
from repro_torch.core import convert
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl


def _same_table(got, want, counters=True):
    assert (got.variant, got.capacity, got.home_capacity,
            got.buckets_per_line, got.inline) == \
        (want.variant, want.capacity, want.home_capacity,
         want.buckets_per_line, want.inline)
    g, w = got.device_arrays(), want.device_arrays()
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    gs, ws = dataclasses.asdict(got.stats), dataclasses.asdict(want.stats)
    fields = (("n", "capacity", "load_factor", "max_chain_len")
              + (("relocations", "inserts", "updates", "deletes")
                 if counters else ()))
    assert {f: gs[f] for f in fields} == {f: ws[f] for f in fields}


@pytest.mark.parametrize("bpl", [4, 8])
@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_build_and_build_grow_bitwise(variant, bpl):
    keys, payloads = ref_nh.random_kv(700, seed=bpl)
    _same_table(
        nh.build(keys, payloads, variant=variant, buckets_per_line=bpl),
        ref_nh.build(keys, payloads, variant=variant, buckets_per_line=bpl))
    # near-full: the inline variant may need build_grow's retries
    _same_table(
        nh.build_grow(keys, payloads, variant=variant, load_factor=0.97,
                      buckets_per_line=bpl),
        ref_nh.build_grow(keys, payloads, variant=variant, load_factor=0.97,
                          buckets_per_line=bpl))


@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_apply_delta_bitwise(variant):
    keys, payloads = ref_nh.random_kv(800, seed=3)
    rng = np.random.default_rng(3)
    upd = keys[rng.integers(0, 600, 40)]
    new = rng.integers(2**62, 2**63, 30).astype(np.uint64)
    uk = np.concatenate([upd, new])
    up = rng.integers(0, 2**52 - 1, len(uk)).astype(np.uint64)
    dk = keys[600:620]
    got = nh.apply_delta(nh.build(keys[:600], payloads[:600],
                                  variant=variant), uk, up, dk, copy=True)
    want = ref_nh.apply_delta(ref_nh.build(keys[:600], payloads[:600],
                                           variant=variant), uk, up, dk,
                              copy=True)
    _same_table(got, want)


def test_reads_reference_snapshot(tmp_path):
    keys, payloads = ref_nh.random_kv(500, seed=5)
    for variant in ("neighborhash", "coalesced"):
        want = ref_nh.build(keys, payloads, variant=variant)
        path = want.save(str(tmp_path / variant))
        _same_table(nh.HashTable.load(path), want)


@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_table_from_reference(variant):
    keys, payloads = ref_nh.random_kv(600, seed=11)
    want = ref_nh.build(keys, payloads, variant=variant)
    got = convert.table_from_reference(
        want.device_arrays(), variant=variant, capacity=want.capacity,
        home_capacity=want.home_capacity,
        buckets_per_line=want.buckets_per_line)
    # the arrays carry no build history: counters restart at zero
    _same_table(got, want, counters=False)
    q = np.concatenate([keys[:200], keys[:50] ^ np.uint64(1 << 62)])
    for g, w in zip(got.lookup_host_batch(q), want.lookup_host_batch(q)):
        np.testing.assert_array_equal(g, w)


def test_table_from_reference_rejects_mismatched_arrays():
    keys, payloads = ref_nh.random_kv(100, seed=2)
    t = ref_nh.build(keys, payloads)
    with pytest.raises(ValueError):
        convert.table_from_reference(
            t.device_arrays(), variant="neighborhash",
            capacity=t.capacity + 1, home_capacity=t.home_capacity,
            buckets_per_line=t.buckets_per_line)
    with pytest.raises(ValueError):
        convert.table_from_reference(
            t.device_arrays(), variant="coalesced", capacity=t.capacity,
            home_capacity=t.home_capacity,
            buckets_per_line=t.buckets_per_line)


@pytest.mark.parametrize("bpl", [8, 32])
@pytest.mark.parametrize("n", [1, 7, 8, 999])
def test_pack_lines_bitwise(bpl, n):
    keys, payloads = ref_nh.random_kv(n, seed=n)
    t = ref_nh.build(keys, payloads)
    arrs = (t.key_hi, t.key_lo, t.val_hi, t.val_lo)
    got = nl.pack_lines(*arrs, bpl)
    want = ref_nl.pack_lines(*arrs, bpl)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
