"""The hand-written probe kernels on the card, each held bitwise against its
plain PyTorch version (kernels/ref.py) on the same inputs.  No JAX here:
the parity with the JAX package is pinned on the CPU by test_torch_lookup.py
and test_torch_engine.py.  Run on a CUDA machine with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng
from repro_torch.core import hashcore as hc
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops, ref

pytestmark = [
    pytest.mark.cuda,
    # a string condition: evaluated when the test runs, not at import
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device"),
]


def _table(variant, n, seed, lf=0.8):
    keys, payloads = nh.random_kv(n, seed=seed)
    t = nh.build(keys, payloads, variant=variant, load_factor=lf)
    return keys, t


def _queries(keys, n_q, hit_rate, seed):
    rng = np.random.default_rng(seed)
    n_hit = int(round(n_q * hit_rate))
    q = np.concatenate([
        keys[rng.integers(0, len(keys), n_hit)],
        rng.integers(2**62, 2**63, n_q - n_hit).astype(np.uint64)])
    rng.shuffle(q)
    return q


def _device_table(t, device):
    return eng._device_table(t, torch.device(device))


KERNELS = {"lines": nl.probe_lines, "smem": nl.probe_smem}


def _check(group, q, impl):
    qh, ql = (nl.to_device(x, group.device) for x in hc.key_split_np(q))
    seg = [0, len(q)]
    if len(group.tables) > 1:
        cut = sorted(np.random.default_rng(len(q)).integers(
            0, len(q) + 1, len(group.tables) - 1).tolist())
        seg = [0, *cut, len(q)]
    kernel = KERNELS[impl]
    before = dict(nl.launches)
    got = kernel(group, ops.pad_to(qh, ops.BLOCK_Q),
                 ops.pad_to(ql, ops.BLOCK_Q), seg)[:, :len(q)]
    assert nl.launches[kernel.__name__] == before[kernel.__name__] + 1
    want = ref.probe_group(group, qh, ql, seg)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("impl", ["lines", "smem"])
@pytest.mark.parametrize("variant", nh.VARIANTS)
@pytest.mark.parametrize("n_q", [1, 255, 256, 257, 4096])
def test_kernel_matches_plain_every_variant(impl, variant, n_q):
    keys, t = _table(variant, 3000, seed=17)
    group = nl.TableGroup([_device_table(t, "cuda")])
    _check(group, _queries(keys, n_q, 0.7, seed=n_q), impl)


@pytest.mark.parametrize("impl", ["lines", "smem"])
def test_grouped_launch_over_mixed_variants(impl):
    """One launch over three tables of different variants, with uneven
    segments (possibly empty) and padding lanes past the last one."""
    built = [_table(v, 2000 + 500 * i, seed=i)
             for i, v in enumerate(("neighborhash", "coalesced", "linear"))]
    group = nl.TableGroup([_device_table(t, "cuda") for _, t in built])
    keys = np.concatenate([k for k, _ in built])
    _check(group, _queries(keys, 3000, 0.8, seed=3), impl)


@pytest.mark.parametrize("impl", ["lines", "smem"])
def test_sparse_and_lodger_edges(impl):
    keys, t = _table("neighborhash", 400, seed=23, lf=0.25)
    _check(nl.TableGroup([_device_table(t, "cuda")]),
           _queries(keys, 256, 0.3, seed=5), impl)
    keys, t = _table("neighborhash", 1500, seed=31, lf=0.95)
    _check(nl.TableGroup([_device_table(t, "cuda")]),
           _queries(keys, 1024, 0.5, seed=6), impl)


def test_hbm_resident_table_through_probe_lines():
    """A table above the shared-memory limit goes to probe_lines."""
    keys, t = _table("neighborhash", 200_000, seed=41)
    group = nl.TableGroup([_device_table(t, "cuda")])
    assert group.smem_bytes > nl.SMEM_LIMIT
    _check(group, _queries(keys, 50_000, 0.9, seed=2), "lines")


@pytest.mark.parametrize("n_keys,kernel", [(3000, "probe_smem"),
                                           (200_000, "probe_lines")])
def test_dispatch_picks_the_kernel_by_bytes(n_keys, kernel):
    keys, t = _table("neighborhash", n_keys, seed=43)
    group = nl.TableGroup([_device_table(t, "cuda")])
    q = _queries(keys, 777, 0.9, seed=4)
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    before = dict(nl.launches)
    got = ops.probe_group(group, qh, ql, [0, len(q)])
    assert {k: v - before[k] for k, v in nl.launches.items()} == {
        k: int(k == kernel) for k in nl.launches}
    want = ref.probe_group(group, qh, ql, [0, len(q)])
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_lookup_fn_packs_a_device_table_once(monkeypatch):
    """make_lookup_fn over tensors already on the card: the table is packed
    there at the first call and reused, never copied through the host."""
    keys, t = _table("neighborhash", 5000, seed=47)
    arrs = {k: nl.int32_words(v).cuda() for k, v in t.device_arrays().items()}
    packed = []
    device_table = nl.device_table

    def counted(arrays, **kw):
        assert all(a.is_cuda for a in arrays.values())
        packed.append(1)
        return device_table(arrays, **kw)

    monkeypatch.setattr(nl, "device_table", counted)
    fn = lk.make_lookup_fn(t)
    q = _queries(keys, 1000, 0.8, seed=8)
    want = t.lookup_host_batch(q)
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    for _ in range(3):
        f, p_hi, p_lo = fn(arrs, qh, ql)
        payload = (ref.u32(p_hi) << 32 | ref.u32(p_lo)).cpu().numpy()
        np.testing.assert_array_equal(f.cpu().numpy(), want[0])
        np.testing.assert_array_equal(payload.astype(np.uint64), want[1])
    assert len(packed) == 1


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    keys, t = _table("neighborhash", 1000, seed=9)
    group = nl.TableGroup([_device_table(t, "cuda")])

    def boom(*a, **k):
        raise AssertionError("plain version reached on CUDA tensors")

    monkeypatch.setattr(ref, "probe_group", boom)
    monkeypatch.setattr(ref, "probe_table", boom)
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(keys))
    ops.probe_group(group, qh, ql, [0, len(keys)])
    f, _, _ = ops.neighbor_lookup(t.key_hi, t.key_lo, t.val_hi, t.val_lo,
                                  qh, ql, max_probes=t.max_probe_len() + 1,
                                  device="cuda")
    torch.cuda.synchronize()
    assert bool((f.view(torch.int32) == 1).all())


def test_engine_on_card_matches_engine_on_cpu():
    item_keys, item_payloads = nh.random_kv(20_000, seed=1)
    cat_keys, cat_payloads = nh.random_kv(3_000, seed=2)
    tables = [eng.ScalarTable("item_attr", item_keys, item_payloads),
              eng.ScalarTable("cat_attr", cat_keys, cat_payloads,
                              variant="coalesced")]
    on_card = eng.MultiTableEngine(tables, max_shard_bytes=1 << 17)
    on_cpu = eng.MultiTableEngine(tables, max_shard_bytes=1 << 17,
                                  device="cpu")
    rng = np.random.default_rng(0)
    reqs = [{"item_attr": _queries(item_keys, 4096, 0.9, seed=i),
             "cat_attr": _queries(cat_keys, 512, 0.9, seed=i)}
            for i in range(4)]
    for got, want in zip(on_card.query_stream(reqs),
                         (on_cpu.query(r) for r in reqs)):
        for name in ("item_attr", "cat_attr"):
            np.testing.assert_array_equal(got[name].found, want[name].found)
            np.testing.assert_array_equal(got[name].payloads,
                                          want[name].payloads)
    upd = item_keys[rng.integers(0, len(item_keys), 64)]
    pay = np.arange(64, dtype=np.uint64)
    for e in (on_card, on_cpu):
        e.publish_delta(2, upserts={"item_attr": (upd, pay)})
    a, b = on_card.query({"item_attr": upd}), on_cpu.query({"item_attr": upd})
    np.testing.assert_array_equal(a["item_attr"].payloads,
                                  b["item_attr"].payloads)
    assert on_card.stats.launches == on_cpu.stats.launches
