"""The host arithmetic of ``probe_smem``'s split (no card needed): a
``TableGroup``'s staged image cut into ``CLUSTER`` slices of
``slice_words`` words, slice r staged by cluster rank r.  Over the groups
the smem tests build (every variant, mixed variants, sparse and dense
tables, a one-line table, the smoke deployment's shards and a group near
the limit) it checks that every staged word lies in exactly one slice, no
128 B line crosses a slice, every slice fits ``SMEM_LIMIT / CLUSTER`` bytes
in a multiple of 16 B, and that the pieces the kernel copies into each
slice (``for_each_piece`` in csrc/probe.cu, mirrored below) put back the
whole image: bulk copies of whole 16 B at 16 B aligned source and
destination, plain loads only for a next_idx array's last < 16 B."""
import numpy as np
import pytest
import torch

from repro_torch.configs.bili_feature_store import SMOKE
from repro_torch.core import engine as eng
from repro_torch.core import hashcore as hc
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl

CPU = torch.device("cpu")
LINE_WORDS = 4 * nl.BUCKETS_PER_LINE          # 32 words, 128 B


def _table(variant, n, seed, lf=0.8):
    keys, payloads = nh.random_kv(n, seed=seed)
    return eng._device_table(
        nh.build(keys, payloads, variant=variant, load_factor=lf), CPU)


def _smoke_groups():
    """The shards of the bili-feature-store-smoke deployment (chip_smoke
    phase B), built on the CPU."""
    keys, payloads = nh.random_kv(SMOKE.n_items, seed=1)
    engine = eng.MultiTableEngine(
        [eng.ScalarTable("item_attr", keys, payloads,
                         load_factor=SMOKE.load_factor)],
        max_shard_bytes=SMOKE.max_shard_bytes,
        buckets_per_line=hc.GPU_BUCKETS_PER_LINE, device="cpu")
    return engine.window.get(None)[2].groups


GROUPS = {
    **{f"variant-{v}": lambda v=v: nl.TableGroup([_table(v, 3000, 17)])
       for v in nh.VARIANTS},
    "mixed": lambda: nl.TableGroup([
        _table(v, 2000 + 500 * i, i)
        for i, v in enumerate(("neighborhash", "coalesced", "linear"))]),
    "mixed-side-arrays": lambda: nl.TableGroup([
        _table(v, 700 + 300 * i, 5 + i)
        for i, v in enumerate(("coalesced", "linear", "linear_lodger",
                               "perfect_cellar", "neighbor_probing"))]),
    "sparse": lambda: nl.TableGroup([_table("neighborhash", 400, 23,
                                            lf=0.25)]),
    "dense": lambda: nl.TableGroup([_table("neighborhash", 1500, 31,
                                           lf=0.95)]),
    "one-line": lambda: nl.TableGroup([_table("coalesced", 4, 1)]),
    "near-limit": lambda: nl.TableGroup([_table("neighborhash", 11000, 1)]),
}


def _arrays(group):
    """(image word offset, words, source words) of every staged array."""
    out = []
    for t, row in zip(group.tables, group.desc.tolist()):
        d = dict(zip(nl.DESC_FIELDS, row))
        out.append((d["smem_lines"], t.lines.numel(),
                    t.lines.view(torch.int32).reshape(-1).numpy()))
        if t.next_idx is not None:
            out.append((d["smem_next"], t.capacity,
                        t.next_idx[:t.capacity].numpy()))
    return out


def _pieces(group, rank):
    """for_each_piece of probe.cu: (dst in the slice, source array, source
    offset, words) of every array's part in rank's slice."""
    lo, sw = rank * group.slice_words, group.slice_words
    for off, words, src in _arrays(group):
        a, b = max(off, lo), min(off + words, lo + sw)
        if a < b:
            yield a - lo, src, a - off, b - a


def _check_split(group):
    words, sw = group.smem_bytes // 4, group.slice_words
    assert group.smem_bytes <= nl.SMEM_LIMIT
    assert sw % LINE_WORDS == 0 and (4 * sw) % 16 == 0
    assert 4 * sw <= -(-nl.SMEM_LIMIT // nl.CLUSTER)
    assert nl.CLUSTER * sw >= words               # every word has a slice
    owner = np.full(words, -1)
    for r in range(nl.CLUSTER):
        lo, hi = r * sw, min((r + 1) * sw, words)
        assert (owner[lo:hi] == -1).all()         # and only one
        owner[lo:hi] = r
    assert (owner >= 0).all()
    for off, n, _ in _arrays(group):
        assert off % LINE_WORDS == 0 and off + n <= words
    for t, row in zip(group.tables, group.desc.tolist()):
        start = dict(zip(nl.DESC_FIELDS, row))["smem_lines"]
        first = start + LINE_WORDS * np.arange(t.lines.shape[0])
        assert np.array_equal(owner[first], owner[first + LINE_WORDS - 1])


def _check_staging(group):
    """The slices as the kernel fills them, laid end to end, are the
    image."""
    words, sw = group.smem_bytes // 4, group.slice_words
    image = np.zeros(words, np.int32)
    for off, n, src in _arrays(group):
        image[off:off + n] = src
    staged = np.zeros(nl.CLUSTER * sw, np.int32)
    for r in range(nl.CLUSTER):
        for dst, src, at, n in _pieces(group, r):
            whole = n // 4 * 4
            assert dst % 4 == 0 and at % 4 == 0     # 16 B aligned
            assert dst + n <= sw
            if n > whole:                           # a tail of plain loads
                assert at + n == len(src)           # only at an array's end
            staged[r * sw + dst:r * sw + dst + n] = src[at:at + n]
    arrays = _arrays(group)
    covered = np.zeros(words, bool)
    for off, n, _ in arrays:
        covered[off:off + n] = True
    assert np.array_equal(staged[:words][covered], image[covered])


@pytest.mark.parametrize("name", list(GROUPS))
def test_slices_split_the_image_on_line_boundaries(name):
    _check_split(GROUPS[name]())


@pytest.mark.parametrize("name", list(GROUPS))
def test_slices_staged_piecewise_rebuild_the_image(name):
    _check_staging(GROUPS[name]())


def test_smoke_shards_split_into_cluster_slices():
    groups = _smoke_groups()
    assert len(groups) == 2            # the smoke's two ~200 KB shards
    for g in groups:
        _check_split(g)
        _check_staging(g)


def test_one_line_table_leaves_ranks_empty():
    g = GROUPS["one-line"]()
    t = g.tables[0]
    assert t.lines.shape[0] == 1 and t.next_idx is not None
    assert g.slice_words == LINE_WORDS
    assert [r for r in range(nl.CLUSTER) if any(_pieces(g, r))] == [0, 1]


def test_lines_and_side_arrays_straddle_slices():
    """The group the cuda tests probe has a lines array and a next_idx
    array each split across ranks, so probes read other blocks' slices."""
    g = GROUPS["mixed-side-arrays"]()
    sw = g.slice_words
    cross = {"lines": False, "next": False}
    for t, row in zip(g.tables, g.desc.tolist()):
        d = dict(zip(nl.DESC_FIELDS, row))
        end = d["smem_lines"] + t.lines.numel() - 1
        cross["lines"] |= d["smem_lines"] // sw != end // sw
        if t.next_idx is not None:
            end = d["smem_next"] + t.capacity - 1
            cross["next"] |= d["smem_next"] // sw != end // sw
    assert cross == {"lines": True, "next": True}


def test_near_limit_group_fills_the_cluster():
    g = GROUPS["near-limit"]()
    assert g.smem_bytes > nl.SMEM_LIMIT * 7 // 8
    assert 4 * g.slice_words <= -(-nl.SMEM_LIMIT // nl.CLUSTER)


def test_unaligned_next_idx_is_copied_aligned():
    keys, payloads = nh.random_kv(500, seed=3)
    t = nh.build(keys, payloads, variant="coalesced")
    arrays = dict(t.device_arrays())
    buf = np.zeros(t.capacity + 1, np.int32)
    buf[1:] = t.next_idx
    arrays["next_idx"] = torch.from_numpy(buf)[1:]    # 4 B off
    assert arrays["next_idx"].data_ptr() % 16 == 4
    d = nl.device_table(arrays, capacity=t.capacity,
                        home_capacity=t.home_capacity, host_check=True,
                        max_probes=4, device=CPU)
    assert d.next_idx.data_ptr() % 16 == 0
    assert np.array_equal(d.next_idx.numpy(), t.next_idx)
    bad = nl.DeviceTable(d.lines, arrays["next_idx"], t.capacity,
                         t.home_capacity, True, 4)
    with pytest.raises(ValueError, match="16 B aligned"):
        nl.TableGroup([bad])
