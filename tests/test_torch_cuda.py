"""The hand-written kernels on the card, each held against its plain PyTorch
version (kernels/ref.py) on the same inputs: the probe kernels bitwise, the
FM and bag kernels at the JAX package's kernel-test tolerances; and DeepFM,
two-tower, DIN and BST serving and retrieval on the card against the same
models on the CPU; the QueryServer over an engine on the card against the
engine on the CPU; the FM term's and the bag's gradient kernels against
their plain versions, the train steps of all four archs on the card
against the CPU, the realtime loop's smoke on the card, and GraphSAGE's
neighbour-sum kernel (``csr_sum``) against its plain version, its
``NeighborMean`` gradient and the three regimes' steps against the CPU.
No JAX
here: the parity with the JAX package is pinned on the CPU by
test_torch_lookup.py, test_torch_engine.py, test_torch_fused_fm.py,
test_torch_embedding_bag.py, test_torch_recsys.py, test_torch_two_tower.py,
test_torch_retrieval.py, test_torch_seq_recsys.py,
test_torch_query_server.py, test_torch_train.py and
test_torch_streaming.py and test_torch_gnn.py.  Run on a CUDA machine with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import contextlib
import dataclasses
import importlib.util
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import engine as eng
from repro_torch.core import hashcore as hc
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.configs import bst, deepfm, din, two_tower_retrieval
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.kernels import build
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import fused_fm as fm
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_sum as seg
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step
from repro_torch.serve.scheduler import BatchPolicy
from repro_torch.serve.server import QueryServer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

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


@contextlib.contextmanager
def _forced_lanes(lanes):
    """probe_lines with ``lanes`` lanes a query whatever the batch (the
    wrapper's pick, ``lines_lanes``, forced); every launch in the block
    takes that form."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nl, "lines_lanes", lambda n, n_sm, threads: lanes)
        before = dict(nl.lanes_launches)
        yield
    grown = {k: v - before[k] for k, v in nl.lanes_launches.items()}
    assert grown[lanes] > 0 and sum(grown.values()) == grown[lanes]


def _check(group, q, impl, lanes=None):
    """``lanes``: probe_lines with that many lanes a query, not the
    wrapper's pick."""
    if lanes is not None:
        assert impl == "lines"
        with _forced_lanes(lanes):
            return _check(group, q, impl)
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


def _side_array_group():
    """Five side-array tables whose lines and next_idx arrays straddle the
    cluster's slices (tests/test_torch_probe_smem.py checks the split)."""
    built = [_table(v, 700 + 300 * i, seed=5 + i)
             for i, v in enumerate(("coalesced", "linear", "linear_lodger",
                                    "perfect_cellar", "neighbor_probing"))]
    group = nl.TableGroup([_device_table(t, "cuda") for _, t in built])
    return group, np.concatenate([k for k, _ in built])


@pytest.mark.parametrize("impl", ["lines", "smem"])
def test_tables_straddling_cluster_slices(impl):
    group, keys = _side_array_group()
    assert group.smem_bytes > nl.CLUSTER * 32 * 4
    _check(group, _queries(keys, 3000, 0.8, seed=7), impl)


def test_probe_smem_one_line_table_leaves_ranks_empty():
    keys, t = _table("coalesced", 4, seed=1)
    group = nl.TableGroup([_device_table(t, "cuda")])
    assert group.tables[0].lines.shape[0] == 1
    assert group.slice_words * 2 >= group.smem_bytes // 4   # ranks 2-7 idle
    _check(group, _queries(keys, 300, 0.5, seed=2), "smem")


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("n_q", [1, 2047, 2048, 2049, 4096])
def test_probe_smem_one_and_two_clusters(n_q, padded):
    """A cluster of 8 x 256 threads takes 2048 queries: around that, and
    unpadded lengths straight into the kernel."""
    group, keys = _side_array_group()
    q = _queries(keys, n_q, 0.8, seed=n_q)
    if padded:
        _check(group, q, "smem")
        return
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    seg = sorted([0, 0, 1, n_q // 2, n_q - 1, n_q])
    got = nl.probe_smem(group, qh, ql, seg)
    want = ref.probe_group(group, qh, ql, seg)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_probe_smem_200_launches_in_a_row():
    """Every block must outlive its peers' reads of its slice; a block that
    left early shows as a rare wrong answer, so every launch is checked."""
    group, keys = _side_array_group()
    q = _queries(keys, 16384, 0.8, seed=11)           # 8 clusters
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    seg = [0, 3000, 6000, 9000, 12000, 16384]
    want = ref.probe_group(group, qh, ql, seg).view(torch.int32)
    outs = [nl.probe_smem(group, qh, ql, seg) for _ in range(200)]
    torch.cuda.synchronize()
    bad = [i for i, o in enumerate(outs)
           if not torch.equal(o.view(torch.int32), want)]
    assert not bad, f"launches {bad[:10]} differ from the plain probe"


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


# ---------------------------------------------------------------------------
# probe_lines: 8 lanes a query, one coalesced line read a step, for
# batches that fit the card's threads; one thread a query past that
# ---------------------------------------------------------------------------
LANES = [1, nl.LINE_LANES]


def _line_steps(t, q):
    """(chain steps, chain steps to a bucket of the line the step left)
    of the host trace of q on built table t."""
    steps = in_line = 0
    for k in q.tolist():
        line = [v // nl.BUCKETS_PER_LINE for v in t.probe_trace(k)[2]]
        steps += len(line) - 1
        in_line += sum(a == b for a, b in zip(line, line[1:]))
    return steps, in_line


def _lodger_misses(t, n, seed):
    """Absent keys whose home bucket holds a resident homed elsewhere."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2**62, 2**63, 50 * n).astype(np.uint64)
    hi, lo = hc.key_split_np(q)
    home = hc.bucket_of_np(hi, lo, t.home_capacity)
    r_hi, r_lo = t.key_hi[home], t.key_lo[home]
    occupied = ~((r_hi == hc.EMPTY_HI) & (r_lo == hc.EMPTY_LO))
    lodger = occupied & (hc.bucket_of_np(r_hi, r_lo, t.home_capacity) != home)
    return q[lodger][:n]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", ["neighborhash", "neighbor_probing",
                                     "linear_lodger", "coalesced"])
def test_probe_lines_chains_in_line_and_across_lines(variant, lanes):
    """A dense table's chains: steps that stay in the line held (no load)
    and steps to another line, both in one batch."""
    keys, t = _table(variant, 6000, seed=51, lf=0.95)
    q = _queries(keys, 3000, 0.9, seed=9)
    steps, in_line = _line_steps(t, q)
    assert steps > in_line > 0 or variant == "coalesced" and steps > 0
    _check(nl.TableGroup([_device_table(t, "cuda")]), q, "lines", lanes)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_probe_lines_last_line_and_lodger_misses(variant, lanes):
    """Keys whose probe reads the table's last line (a partial line past
    the capacity reads empty buckets) and absent keys whose home holds a
    lodger (a resident homed elsewhere)."""
    keys, t = _table(variant, 2000, seed=4)
    n_lines = -(-t.capacity // nl.BUCKETS_PER_LINE)
    last = np.array([k for k in keys.tolist()
                     if any(v // nl.BUCKETS_PER_LINE == n_lines - 1
                            for v in t.probe_trace(k)[2])], np.uint64)
    lodgers = _lodger_misses(t, 200, seed=3)
    assert len(last) > 0 and len(lodgers) > 0
    _check(nl.TableGroup([_device_table(t, "cuda")]),
           np.concatenate([last, lodgers, keys[:100]]), "lines", lanes)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("max_probes", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", ["neighborhash", "coalesced"])
def test_probe_lines_max_probes_cuts_chains_mid_line(variant, max_probes,
                                                     lanes):
    """max_probes below the chains' lengths ends chains inside a line and
    across lines; the kernel stops exactly where the plain probe does."""
    keys, t = _table(variant, 6000, seed=52, lf=0.95)
    full = _device_table(t, "cuda")
    cut = nl.DeviceTable(full.lines, full.next_idx, full.capacity,
                         full.home_capacity, full.host_check, max_probes)
    _check(nl.TableGroup([cut]), _queries(keys, 4096, 0.9, seed=5), "lines",
           lanes)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", nh.VARIANTS)
@pytest.mark.parametrize("n_q", [1, 7, 8, 9, 31, 33, 1000])
def test_probe_lines_unpadded_batches(variant, n_q, lanes):
    """Batches straight into the kernel, not padded to a block (at 8 lanes
    32 queries a block, the last block partly empty); segments that end
    before the batch, so the last queries come back zero."""
    keys, t = _table(variant, 3000, seed=17)
    group = nl.TableGroup([_device_table(t, "cuda")])
    q = _queries(keys, n_q, 0.7, seed=n_q)
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    for seg in ([0, n_q], [0, n_q - 1 if n_q > 1 else 0]):
        with _forced_lanes(lanes):
            got = nl.probe_lines(group, qh, ql, seg)
        want = ref.probe_group(group, qh, ql, seg)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_probe_lines_lanes_by_the_batch():
    """The wrapper probes a batch whose 8-lane groups fill at most 5/8 of
    the card's resident threads with 8 lanes a query, one a block larger
    (and a far larger one) with one thread a query; all bitwise equal to
    the plain probe."""
    keys, t = _table("neighborhash", 200_000, seed=41)
    group = nl.TableGroup([_device_table(t, "cuda")])
    n_sm, threads = nl._card_of(nl._library(), torch.device("cuda", 0))
    most = 5 * n_sm * threads // (8 * nl.LINE_LANES)
    last = most // ops.BLOCK_Q * ops.BLOCK_Q    # padded to a block: itself
    for n_q, lanes in ((last, nl.LINE_LANES), (last + 1, 1),
                       (4 * most, 1)):
        before = dict(nl.lanes_launches)
        _check(group, _queries(keys, n_q, 0.9, seed=n_q), "lines")
        assert {k: v - before[k] for k, v in nl.lanes_launches.items()} == {
            k: int(k == lanes) for k in nl.lanes_launches}


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


def test_query_server_on_card_matches_cpu_across_a_delta():
    """The port's QueryServer over an engine on the card, 8 client threads
    and a delta published while they run: every response bitwise the CPU
    engine's answer at the version it names, one version a micro-batch,
    both versions served, and the probe launched from the scheduler
    thread alone (one launch a shard a micro-batch)."""
    keys, payloads = nh.random_kv(200_000, seed=3)
    values = np.random.default_rng(4).integers(0, 255, (50_000, 32),
                                               dtype=np.uint8)
    scalars = [eng.ScalarTable("item_attr", keys, payloads)]
    embeddings = [eng.EmbeddingTable("item_emb", keys[:50_000], values,
                                     hot_fraction=0.25)]
    kw = dict(max_shard_bytes=1 << 22,
              buckets_per_line=hc.GPU_BUCKETS_PER_LINE)
    on_card = eng.MultiTableEngine(scalars, embeddings, **kw)
    on_cpu = eng.MultiTableEngine(scalars, embeddings, device="cpu", **kw)
    upd = keys[np.random.default_rng(5).choice(50_000, 64, replace=False)]
    delta = {"item_attr": (upd, np.arange(64, dtype=np.uint64)),
             "item_emb": (upd, np.full((64, 32), 7, dtype=np.uint8))}
    on_cpu.publish_delta(2, upserts=delta)
    launchers, answers, errors = set(), [], []
    probe = ops.probe_group

    def spy(*args):
        launchers.add(threading.get_ident())
        return probe(*args)
    started = threading.Barrier(9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "probe_group", spy)
        before = nl.launches["probe_lines"] + nl.launches["probe_smem"]
        server = QueryServer(on_card, BatchPolicy(max_batch_keys=4096,
                                                  max_wait_s=0.002))
        client = api.FeatureClient(server)

        def run(c):
            rng = np.random.default_rng(100 + c)
            try:
                started.wait(30)
                for _ in range(24):
                    q = _queries(keys, 300, 0.9, seed=int(rng.integers(2**31)))
                    q[:8] = upd[:8]
                    req = {"item_attr": q, "item_emb": q[:100]}
                    answers.append((req, client.query(req, timeout=60)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(c,)) for c in range(8)]
        try:
            for t in threads:
                t.start()
            started.wait(30)
            while len(answers) < 16 and not errors:
                time.sleep(0.001)
            on_card.publish_delta(2, upserts=delta)
            for t in threads:
                t.join(120)
        finally:
            server.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(answers) == 8 * 24
    by_batch = {}
    for req, res in answers:
        by_batch.setdefault(res.batch_id, set()).add(res.version)
        want = on_cpu.query(req, version=res.version, strict=True)
        for name in req:
            got, exp = res[name], want[name]
            np.testing.assert_array_equal(got.found, exp.found)
            if name == "item_attr":
                np.testing.assert_array_equal(got.payloads, exp.payloads)
            else:
                np.testing.assert_array_equal(got.values, exp.values)
    assert all(len(v) == 1 for v in by_batch.values())
    assert {res.version for _, res in answers} == {1, 2}
    launched = nl.launches["probe_lines"] + nl.launches["probe_smem"]
    assert launched - before == server.stats_snapshot().launches > 0
    assert len(launchers) == 1 and threading.get_ident() not in launchers


# ---------------------------------------------------------------------------
# fused_fm
# ---------------------------------------------------------------------------
FM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fm_bound(x):
    """Per sample, how far an fp32 FM term summed in any order may stray
    from the exact one: the terms that cancel are each column's (sum_f x)^2
    and sum_f x^2, M = sum_d[(sum_f x)^2 + sum_f x^2] in all; a column's
    sums of F values lose up to ~F u of that (u = 2^-24), and the D column
    terms, met in a tree (kernel) or pairwise (plain), ~sqrt(D) u; with a
    factor 4 of room.  A misread element moves a term by ~|x| |sum_f x|,
    far more at these shapes; one fixed tolerance cannot follow M."""
    x64 = x.double()
    m = (x64.sum(dim=1) ** 2 + (x64 * x64).sum(dim=1)).sum(dim=-1)
    return 4 * (x.shape[1] + x.shape[2] ** 0.5) * 2.0 ** -24 * m


def _fm_check(shape, dtype, tol, seed=0, branch=None, x=None):
    """``tol`` None: the kernel and the plain FM each within _fm_bound of
    the FM term in float64."""
    if x is None:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(shape, generator=g, device="cuda").to(
            FM_DTYPES[dtype])
    before, paths = fm.launches["fused_fm"], dict(fm.paths)
    got = ops.fm_interaction(x)
    assert fm.launches["fused_fm"] == before + 1
    if branch is not None:
        assert {k: v - paths[k] for k, v in fm.paths.items()} == {
            k: int(k == branch) for k in fm.paths}
    want = ref.fused_fm(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    if tol is None:
        x64 = x.double()
        exact = 0.5 * (x64.sum(dim=1) ** 2 - (x64 * x64).sum(dim=1)).sum(-1)
        bound = _fm_bound(x)
        assert bool(((got.double() - exact).abs() <= bound).all())
        assert bool(((want.double() - exact).abs() <= bound).all())
        return
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("shape", [(64, 39, 10), (130, 7, 16), (8, 2, 4),
                                   (512, 39, 10), (33, 3, 256)])
def test_fused_fm_kernel_matches_plain(dtype, shape):
    """test_kernels.py's shapes and tolerances, DeepFM's request and a
    width of 256, past one lane per d."""
    _fm_check(shape, dtype, 1e-4 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("n_b", [1, 127, 128, 129])
def test_fused_fm_kernel_any_batch(dtype, n_b):
    """B around the TPU kernel's block of 128; no padding on the card."""
    _fm_check((n_b, 13, 8), dtype, 1e-5, seed=n_b)


def test_fused_fm_kernel_degenerate_shapes():
    assert fm.fused_fm(torch.zeros(0, 39, 10, device="cuda")).shape == (0,)
    out = fm.fused_fm(torch.ones(5, 0, 10, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(5, device="cuda"))


def test_fused_fm_rejects_what_it_does_not_take():
    x = torch.randn(39, 64, 10, device="cuda").transpose(0, 1)
    assert not x.is_contiguous()
    before = fm.launches["fused_fm"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.fm_interaction(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fm.fused_fm(torch.zeros(4, 3, 2, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError):
        fm.fused_fm(torch.zeros(4, 3, device="cuda"))
    assert fm.launches["fused_fm"] == before
    _fm_check((64, 39, 10), "float32", 1e-4)        # contiguous: launches


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("where", ["tile", "stage_tile", "all_sms",
                                   "one_wave", "two_waves"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_fused_fm_bulk_around_tiles_and_waves(dtype, where, delta):
    """DeepFM's [B, 39, 10] on the bulk branch, B one below, at and one
    above: the least tile (S), a stage's tile, a tile for every SM, one
    persistent wave of tiles and two.  B % S != 0 leaves a partial last
    tile, whose span ends off 16 B and is finished by plain loads."""
    elt = 4 if dtype == "float32" else 2
    n_sm = _sm_count()
    least = fm.plan(1, 39, 10, elt, n_sm, True).tile
    stage = fm.plan(10**7, 39, 10, elt, n_sm, True).tile
    wave = stage * fm.BLOCKS_PER_SM * n_sm
    b = {"tile": least, "stage_tile": stage, "all_sms": least * n_sm,
         "one_wave": wave, "two_waves": 2 * wave}[where] + delta
    assert fm.plan(b, 39, 10, elt, n_sm, True).branch == "bulk"
    _fm_check((b, 39, 10), dtype, None, seed=b, branch="bulk")


@pytest.mark.parametrize("shape,dtype", [
    ((77, 39, 10), "bfloat16"),        # 780 B a sample
    ((1, 39, 10), "bfloat16"),         # one sample, 12 B past 16 B
    ((1000, 13, 9), "float32"),        # odd F * D: 468 B a sample
    ((333, 3, 7), "float32"),          # 84 B a sample
    ((129, 3, 7), "bfloat16"),         # 42 B a sample
    ((17, 1, 1), "float32")])          # 4 B a sample
def test_fused_fm_spans_off_16_bytes(shape, dtype):
    """Samples whose span is not a multiple of 16 B: tiles of a multiple of
    the least count that is, by bulk copy; the last tile's ragged end by
    plain loads."""
    elt = 4 if dtype == "float32" else 2
    b, f, d = shape
    assert (f * d * elt) % 16 != 0
    p = fm.plan(b, f, d, elt, _sm_count(), True)
    assert p.branch == "bulk" and (p.tile * f * d * elt) % 16 == 0
    _fm_check(shape, dtype, None, seed=b, branch="bulk")


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("shape", [(64, 39, 256), (5, 100, 200),
                                   (3, 4, 20000), (9, 300, 33)])
def test_fused_fm_sample_larger_than_a_stage(dtype, shape):
    """F = 39, D = 256 fp32 is 39,936 B a sample, past a 16 KB stage: the
    loads branch, whole samples in its buffer; larger still (80 KB, 320 KB
    with a row of 20,000), one sample a tile summed where it lies."""
    elt = 4 if dtype == "float32" else 2
    b, f, d = shape
    assert f * d * elt > fm.STAGE_BYTES
    assert fm.plan(b, f, d, elt, _sm_count(), True).branch == "loads"
    _fm_check(shape, dtype, None, seed=f, branch="loads")


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("shape", [(512, 39, 10), (130, 7, 16), (5, 1, 3)])
def test_fused_fm_branch_by_alignment(dtype, shape):
    """The same values from a 16 B aligned tensor (bulk) and from a view
    off a 16 B boundary (loads: scalar head and tail, 16 B between)."""
    g = torch.Generator(device="cuda").manual_seed(shape[0])
    n = shape[0] * shape[1] * shape[2]
    flat = torch.randn(n + 1, generator=g, device="cuda").to(FM_DTYPES[dtype])
    off = flat[1:].view(shape)
    assert off.data_ptr() % 16 != 0
    _fm_check(shape, dtype, None, branch="loads", x=off)
    _fm_check(shape, dtype, None, branch="bulk", x=off.clone())


def test_fused_fm_no_dim():
    out = fm.fused_fm(torch.ones(5, 3, 0, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(5, device="cuda"))


def test_fm_interaction_raises_when_the_library_cannot_load(monkeypatch):
    def no_library(name, bind):
        raise OSError(f"cannot load lib{name}")

    def boom(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(ref, "fused_fm", boom)
    with pytest.raises(OSError, match="libfused_fm"):
        ops.fm_interaction(torch.zeros(8, 39, 10, device="cuda"))


# ---------------------------------------------------------------------------
# DeepFM serving on the card
# ---------------------------------------------------------------------------
def test_deepfm_on_card_matches_deepfm_on_cpu():
    on_cpu = rec.recsys_init(deepfm.SMOKE, seed=0, device="cpu")
    on_card = rec.recsys_init(deepfm.SMOKE, seed=0, device="cpu").to("cuda")
    assert on_card.device.type == "cuda"
    batch = synthetic.recsys_batch(np.random.default_rng(0), deepfm.SMOKE,
                                   512)
    before = fm.launches["fused_fm"]
    got = rec.recsys_score(on_card, batch)
    assert fm.launches["fused_fm"] == before + 1
    want = rec.recsys_score(on_cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_serve_launcher_on_card():
    before = fm.launches["fused_fm"]
    out = launch_serve.main(["--arch", "deepfm", "--smoke", "--requests",
                             "3", "--batch", "256"])
    assert out["device"].startswith("cuda") and out["finite"]
    assert fm.launches["fused_fm"] == before + 4     # warm-up + 3


def test_feature_server_launcher_on_card():
    """--feature-server on the card: 8 scoring threads, 2 PREFETCH threads,
    a delta mid-traffic; one fused_fm launch a scored request, counted
    exactly across the threads."""
    before = fm.launches["fused_fm"]
    out = launch_serve.main(["--arch", "deepfm", "--smoke", "--feature-server",
                             "--clients", "8", "--prefetch-clients", "2",
                             "--requests", "4", "--batch", "256"])
    assert out["device"].startswith("cuda") and out["finite"]
    assert out["scored"] + out["shed"] == 32 and out["server"].failed == 0
    assert fm.launches["fused_fm"] == before + 1 + out["scored"]


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------
BAG_TOL = 1e-5          # rtol, and atol for N(0,1) rows summed in two
BAG_L = 50              # orders over up to seq_len's 50 entries a bag


def _bag_atol(ids):
    """Two fp32 sums of the same L rows in other orders drift apart about
    linearly in L (each add rounds at the size of its partial sum), so past
    the served length the absolute tolerance grows with L."""
    return BAG_TOL * max(1.0, ids.shape[1] / BAG_L)


def _bag_inputs(b, n, v, d, dtype, seed, weighted):
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn(v, d, generator=g, device="cuda").to(dtype)
    ids = torch.randint(-1, v, (b, n), generator=g, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(b, n, generator=g, device="cuda") if weighted else None
    return table, ids, w


def _bag_check(table, ids, w, mode):
    before = bag.launches["embedding_bag"]
    got = ops.embedding_bag(table, ids, w, mode=mode)
    launched = int(ids.shape[0] > 0 and table.shape[1] > 0)
    assert bag.launches["embedding_bag"] == before + launched
    want = ref.embedding_bag(table, ids, w, mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert got.shape == (ids.shape[0], table.shape[1])
    torch.testing.assert_close(got, want, rtol=BAG_TOL, atol=_bag_atol(ids),
                               equal_nan=True)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [10, 18, 32, 256])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_kernel_matches_plain(dtype, d, mode, weighted):
    """test_kernels.py's widths (10/18/32) and two-tower's 256, with vector
    loads (D % 4 == 0) and without; B = 37 is a multiple of nothing."""
    table, ids, w = _bag_inputs(37, 50, 5000, d, dtype, seed=d,
                                weighted=weighted)
    ids[0] = -1                                     # a fully padded bag
    ids[1, :3] = torch.tensor([0, 4999, -1], dtype=torch.int32)
    out = _bag_check(table, ids, w, mode)
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("b,n", [(0, 50), (1, 1), (7, 5), (513, 50),
                                 (5, 0), (3, 1000)])
def test_embedding_bag_kernel_any_batch_and_length(b, n):
    """No padding on the card: any B (0 launches nothing), any L (0 gives
    zeros, 1000 runs past the unrolled loads many times)."""
    table, ids, w = _bag_inputs(b, n, 3000, 256, torch.float32, seed=b,
                                weighted=True)
    for mode in ("sum", "mean"):
        out = _bag_check(table, ids, w, mode)
    if n == 0:
        assert bool((out == 0).all())


def _paths_of(fn):
    before = dict(bag.paths)
    fn()
    return {k: v - before[k] for k, v in bag.paths.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [31, 32, 33, 64, 65, 1000])
def test_embedding_bag_staged_stage_edges_and_ring(dtype, n):
    """Bags around a stage of 32 entries and across the ring of 2 stages
    (1000 entries reuse each stage 16 times), on the staged branch."""
    table, ids, w = _bag_inputs(19, n, 4000, 256, dtype, seed=n,
                                weighted=True)
    ids[2, ::3] = -1
    for mode in ("sum", "mean"):
        paths = _paths_of(lambda: _bag_check(table, ids, w, mode))
        assert paths == {"staged": 1, "registers": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_bag_with_no_valid_row(dtype):
    """A bag of only -1 and one of only -1 and ids >= V, inside a batch of
    valid bags: no row is copied for them."""
    table, ids, w = _bag_inputs(8, 50, 1000, 256, dtype, seed=9,
                                weighted=True)
    ids[3] = -1
    ids[5] = -1
    ids[5, ::2] = 1000
    ids[5, 7] = 2**31 - 1
    for mode in ("sum", "mean"):
        out = _bag_check(table, ids, w, mode)
        assert bool((out[3] == 0).all()) and bool(out[5].isnan().all())
        rest = out[[0, 1, 2, 4, 6, 7]]
        assert not bool(rest.isnan().any())


def test_embedding_bag_batch_past_one_wave_takes_registers():
    """The staged branch runs when every bag of the batch is resident at
    once; a batch past that (132 SMs x 4 blocks at L = 50, D = 256 fp32)
    keeps more bytes in flight on the register branch."""
    table, ids, w = _bag_inputs(4000, 50, 5000, 256, torch.float32, seed=8,
                                weighted=True)
    small = ids[:512].contiguous()
    assert _paths_of(lambda: _bag_check(table, small, w[:512].contiguous(),
                                        "sum")) == {"staged": 1,
                                                    "registers": 0}
    assert _paths_of(lambda: _bag_check(table, ids, w, "sum")) == {
        "staged": 0, "registers": 1}


def _unaligned(v, d, dtype):
    flat = torch.randn(v * d + 1, device="cuda").to(dtype)
    return flat[1:].view(v, d)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,branch", [(256, "staged"), (10, "registers"),
                                      (18, "registers"),
                                      ("unaligned", "registers")])
def test_embedding_bag_branch_by_shape_and_alignment(d, branch, dtype,
                                                     weighted):
    """Rows of a multiple of 16 B in an aligned table are staged by
    async copies; D = 10, 18 and a table view off a 16 B boundary take the
    register loads.  Both agree with the plain bag."""
    table, ids, w = _bag_inputs(37, 50, 3000, 256 if d == "unaligned" else d,
                                dtype, seed=3, weighted=weighted)
    if d == "unaligned":
        table = _unaligned(3000, 256, dtype)
        assert table.data_ptr() % 16 != 0
    paths = _paths_of(lambda: _bag_check(table, ids, w, "mean"))
    assert paths == {k: int(k == branch) for k in paths}


def test_embedding_bag_id_past_the_table_gives_nan():
    table, ids, _ = _bag_inputs(6, 8, 100, 32, torch.float32, seed=1,
                                weighted=False)
    ids[2, 5] = 100
    ids[4, 0] = 2**31 - 1
    out = _bag_check(table, ids, None, "mean")
    assert bool(out[[2, 4]].isnan().all())
    assert not bool(out[[0, 1, 3, 5]].isnan().any())


def test_embedding_bag_unaligned_table_takes_scalar_loads():
    """A table view 4 bytes off a 16-byte boundary: D % 4 == 0, but the
    kernel must not issue 16-byte loads on it."""
    v, d = 500, 32
    flat = torch.randn(v * d + 1, device="cuda")
    table = flat[1:].view(v, d)
    assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    _, ids, w = _bag_inputs(9, 20, v, d, torch.float32, seed=2,
                            weighted=True)
    _bag_check(table, ids, w, "sum")


def test_embedding_bag_addresses_rows_past_2_pow_31_elements():
    """8,400,000 x 256 fp32 (2.15e9 elements, 8.6 GB): every bag reads rows
    whose element offset row * D passes 2^31 - 1, where a 32-bit index
    reads the wrong place."""
    v, d = 8_400_000, 256
    assert v * d > 2**31 - 1
    g = torch.Generator(device="cuda").manual_seed(5)
    table = torch.rand(v, d, generator=g, device="cuda")
    first_past = (2**31 - 1) // d + 1                     # 8,388,608
    ids = torch.randint(first_past, v, (64, 50), generator=g, device="cuda",
                        dtype=torch.int32)
    ids[:, 0] = v - 1
    ids[:, 1] = first_past
    for mode in ("sum", "mean"):
        _bag_check(table, ids, None, mode)
    del table
    torch.cuda.empty_cache()


def test_embedding_bag_rejects_what_it_does_not_take():
    table, ids, w = _bag_inputs(8, 6, 100, 16, torch.float32, seed=3,
                                weighted=True)
    before = bag.launches["embedding_bag"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table, ids.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table[:, :8], ids, w)
    with pytest.raises(TypeError, match="int32 indices"):
        ops.embedding_bag(table, ids.long(), w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.embedding_bag(table.half(), ids, w)
    with pytest.raises(TypeError, match="float32 weights"):
        ops.embedding_bag(table, ids, w.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        bag.embedding_bag(table, ids.cpu(), w)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(table, ids, w, mode="max")
    assert bag.launches["embedding_bag"] == before


def test_embedding_bag_raises_when_the_library_cannot_load(monkeypatch):
    def no_library(name, bind):
        raise OSError(f"cannot load lib{name}")

    def boom(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(ref, "embedding_bag", boom)
    table, ids, _ = _bag_inputs(8, 6, 100, 16, torch.float32, seed=4,
                                weighted=False)
    with pytest.raises(OSError, match="libembedding_bag"):
        ops.embedding_bag(table, ids, mode="mean")


# ---------------------------------------------------------------------------
# two-tower serving on the card
# ---------------------------------------------------------------------------
def test_two_tower_on_card_matches_two_tower_on_cpu():
    cfg = two_tower_retrieval.SMOKE
    on_cpu = rec.recsys_init(cfg, seed=0, device="cpu")
    on_card = rec.recsys_init(cfg, seed=0, device="cpu").to("cuda")
    assert on_card.device.type == "cuda"
    batch = synthetic.recsys_batch(np.random.default_rng(0), cfg, 512)
    before = bag.launches["embedding_bag"]
    got = rec.recsys_score(on_card, batch)
    assert bag.launches["embedding_bag"] == before + 1
    want = rec.recsys_score(on_cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.norm(dim=-1).cpu(), torch.ones(512),
                               rtol=1e-5, atol=1e-5)


def test_two_tower_serve_launcher_on_card():
    before = bag.launches["embedding_bag"]
    out = launch_serve.main(["--arch", "two-tower-retrieval", "--smoke",
                             "--requests", "3", "--batch", "300"])
    assert out["device"].startswith("cuda") and out["finite"]
    assert bag.launches["embedding_bag"] == before + 4     # warm-up + 3


# ---------------------------------------------------------------------------
# retrieval_cand: the kernels at its shapes, the steps and the tie rule
# ---------------------------------------------------------------------------
TOP_K_TOL = 1e-5        # the card's and the CPU's products differ ~1e-7


@pytest.mark.parametrize("rows,dtype", [(1_000_000, "float32"),
                                        (999_999, "float32"),
                                        (999_999, "bfloat16")])
def test_fused_fm_retrieval_cand_batch_on_the_bulk_branch(rows, dtype):
    """DeepFM's retrieval_cand batch, [1,000,000, 39, 10] fp32 (1.56 GB,
    100,000 tiles); 999,999 rows, whose last tile is partial and ends off
    16 B; and the same in bf16, whose tile (20) does not divide the rows.
    Each sample within the rounding bound of the float64 FM term."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = fm.plan(rows, 39, 10, FM_DTYPES[dtype].itemsize, n_sm, True)
    assert p.branch == "bulk"
    assert (rows % p.tile == 0) == (rows == 1_000_000)
    _fm_check((rows, 39, 10), dtype, None, seed=rows, branch="bulk")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("padding", ["none", "tail", "all"])
def test_embedding_bag_one_bag_of_fifty(padding, mode):
    """The user tower's bag in retrieval_cand: one bag of 50 over rows of
    256 fp32, one block on the staged branch; a history padded at its
    tail, and one of only padding, which gives zeros."""
    table, ids, _ = _bag_inputs(1, BAG_L, 100_000, 256, torch.float32,
                                seed=50, weighted=False)
    ids = ids.abs()
    if padding == "tail":
        ids[0, 17:] = -1
    elif padding == "all":
        ids[:] = -1
    paths = _paths_of(lambda: _bag_check(table, ids, None, mode))
    assert paths == {"staged": 1, "registers": 0}
    if padding == "all":
        assert bool((ops.embedding_bag(table, ids, mode=mode) == 0).all())


def _same_top_k(got, want, want_next):
    """The card's (values, indices) against the CPU's: values within
    TOP_K_TOL; indices equal wherever the CPU list's neighbouring scores
    (``want_next``, its (k+1)-th, included) lie more than TOP_K_TOL apart;
    equal values on the card in ascending index order."""
    gv, gi = (t.cpu().reshape(-1, t.shape[-1]) for t in got)
    wv, wi = (t.reshape(-1, t.shape[-1]) for t in want)
    torch.testing.assert_close(gv, wv, rtol=0, atol=TOP_K_TOL)
    nxt = want_next.reshape(-1)
    for r in range(len(wv)):
        s = torch.cat([torch.tensor([float("inf")]), wv[r], nxt[r:r + 1]])
        apart = (s[1:-1] - s[2:] > TOP_K_TOL) & (s[:-2] - s[1:-1] > TOP_K_TOL)
        assert torch.equal(gi[r][apart], wi[r][apart])
        tied = gv[r][1:] == gv[r][:-1]
        assert bool((gi[r][1:][tied] > gi[r][:-1][tied]).all())


@pytest.mark.parametrize("n", [64, 4096])
def test_retrieval_fn_on_card_matches_cpu(n):
    """Two-tower retrieval at SMOKE: 8 users against n zipf candidates,
    one embedding_bag launch a request, the top 100 (at most n) as the
    same model gives it on the CPU."""
    cfg = two_tower_retrieval.SMOKE
    on_cpu = rec.recsys_init(cfg, seed=0, device="cpu")
    on_card = rec.recsys_init(cfg, seed=0, device="cpu").to("cuda")
    rng = np.random.default_rng(n)
    user = synthetic.recsys_batch(rng, cfg, 8)
    ids = synthetic.zipf_ids(rng, cfg.item_vocab, n)
    cats = synthetic.zipf_ids(rng, cfg.cat_vocab, n)
    k = min(100, n)
    before = bag.launches["embedding_bag"]
    got = serve_step.retrieval_fn(cfg, on_card, top_k=k)(user, ids, cats)
    assert bag.launches["embedding_bag"] == before + 1
    assert got[0].device.type == "cuda" and got[0].shape == (8, k)
    wv, wi = serve_step.retrieval_fn(cfg, on_cpu, top_k=min(k + 1, n))(
        user, ids, cats)
    nxt = wv[:, k] if k < n else torch.full((8,), float("-inf"))
    _same_top_k(got, (wv[:, :k], wi[:, :k]), nxt)


@pytest.mark.parametrize("n", [64, 4096])
def test_bulk_rank_fn_on_card_matches_cpu(n):
    """DeepFM bulk ranking at SMOKE: n candidate rows, one fused_fm launch,
    the top 100 (at most n) logits as the same model gives them on the
    CPU."""
    cfg = deepfm.SMOKE
    on_cpu = rec.recsys_init(cfg, seed=0, device="cpu")
    on_card = rec.recsys_init(cfg, seed=0, device="cpu").to("cuda")
    batch = synthetic.recsys_batch(np.random.default_rng(n), cfg, n)
    k = min(100, n)
    before = fm.launches["fused_fm"]
    got = serve_step.bulk_rank_fn(cfg, on_card, top_k=k)(batch)
    assert fm.launches["fused_fm"] == before + 1
    wv, wi = serve_step.bulk_rank_fn(cfg, on_cpu, top_k=min(k + 1, n))(batch)
    nxt = wv[k:k + 1] if k < n else torch.tensor([float("-inf")])
    _same_top_k(got, (wv[:k], wi[:k]), nxt)


@pytest.mark.parametrize("n,levels,k", [(300, 5, 50), (4096, 9, 100),
                                        (1_000_000, 40, 100),
                                        (1_000_000, 3, 1000)])
def test_lax_top_k_breaks_ties_by_index_on_the_card(n, levels, k):
    """Bitwise-equal scores on the card (a few levels, so the top k is a
    handful of values repeated, ties across the cut): exactly the values
    and indices of a (value descending, index ascending) order."""
    rng = np.random.default_rng(n + levels)
    scores = (rng.integers(0, levels, n) * 0.5 - 3).astype(np.float32)
    order = np.lexsort((np.arange(n), -scores))[:k]
    gv, gi = rec.lax_top_k(torch.from_numpy(scores).cuda(), k)
    np.testing.assert_array_equal(gv.cpu().numpy(), scores[order])
    np.testing.assert_array_equal(gi.cpu().numpy(), order)


NEG_NAN = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("row", [
    [0., -0., 0., -0., 1.], [-0., 0., -1.], [1., NEG_NAN, 3., 2.],
    [np.nan, np.inf, -np.inf, NEG_NAN, 0., -0., np.nan, -np.inf]])
def test_lax_top_k_signed_zeros_and_nan_on_the_card(row):
    """The float total order on the card as on the CPU: the same indices,
    the same value bits, for every k, also with the row repeated past a
    block of the sort (4099 entries)."""
    for scores in (np.array(row, dtype=np.float32),
                   np.tile(np.array(row, dtype=np.float32), 4099)):
        for k in sorted({0, 1, len(row), min(len(scores), 300)}):
            gv, gi = rec.lax_top_k(torch.from_numpy(scores).cuda(), k)
            wv, wi = rec.lax_top_k(torch.from_numpy(scores), k)
            np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())
            np.testing.assert_array_equal(
                gv.cpu().numpy().view(np.uint32), wv.numpy().view(np.uint32))


@pytest.mark.parametrize("arch,kernel", [("deepfm", "fused_fm"),
                                         ("two-tower-retrieval",
                                          "embedding_bag"),
                                         ("din", None), ("bst", None)])
def test_retrieval_cand_launcher_on_card(arch, kernel):
    """DeepFM's and two-tower's retrieval_cand launch their kernel once a
    request (warm-up + 2); DIN's and BST's launch none of the four."""
    before = _kernel_launches()
    out = launch_serve.main(["--arch", arch, "--shape", "retrieval_cand",
                             "--smoke", "--requests", "2"])
    assert out["device"].startswith("cuda") and out["finite"]
    want = dict(before)
    if kernel is not None:
        want[kernel] += 3
    assert _kernel_launches() == want


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, imported for its float64
    recomputes of DIN's and BST's logits."""
    if "chip_smoke" not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod      # its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("cfg", [din.SMOKE, bst.SMOKE], ids=["din", "bst"])
def test_bulk_rank_chunked_on_card(cfg, monkeypatch):
    """32,768 candidate rows through ``bulk_rank_fn`` in slices of 4,096
    against one slice: the top 100 values within 1e-5, the indices by the
    tie rule; every logit of the sliced run within 1e-5 of the float64
    recompute on the card; no kernel launched."""
    smoke = _chip_smoke()
    model = rec.recsys_init(cfg, seed=0, device="cuda")
    batch = synthetic.recsys_batch(np.random.default_rng(7), cfg, 32_768)
    batch.pop("label")
    ranked, top_k = [], rec.lax_top_k

    def record(scores, k):
        ranked.append(scores)
        return top_k(scores, k)

    monkeypatch.setattr(rec, "lax_top_k", record)
    before = _kernel_launches()
    got = serve_step.bulk_rank_fn(cfg, model, chunk_rows=4096)(batch)
    whole = serve_step.bulk_rank_fn(cfg, model, top_k=101)(batch)
    torch.cuda.synchronize()
    assert _kernel_launches() == before
    sliced, _ = ranked
    _same_top_k(got, (whole[0][:100].cpu(), whole[1][:100].cpu()),
                whole[0][100:].cpu())
    cols = {k: torch.from_numpy(batch[k]).cuda() for k in model.inputs}
    want = {"din": smoke.din_logits64, "bst": smoke.bst_logits64}[
        cfg.arch](model, cols)
    assert float((sliced.double() - want).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# DIN and BST serving on the card: no kernel, fp32 products without TF32
# ---------------------------------------------------------------------------
def _kernel_launches():
    return {**nl.launches, **fm.launches, **bag.launches}


@pytest.mark.parametrize("cfg", [din.SMOKE, bst.SMOKE], ids=["din", "bst"])
@pytest.mark.parametrize("rows", [1, 512, 4099])
def test_seq_recsys_on_card_matches_cpu(cfg, rows):
    """The scoring step on the card against the same weights on the CPU,
    TF32 off while it runs; none of the four kernels launches."""
    on_cpu = rec.recsys_init(cfg, seed=0, device="cpu")
    on_card = rec.recsys_init(cfg, seed=0, device="cpu").to("cuda")
    assert on_card.device.type == "cuda"
    batch = synthetic.recsys_batch(np.random.default_rng(rows), cfg, rows)
    batch["hist_items"][0] = -1                   # a row of padding only
    before = _kernel_launches()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    got = serve_step.recsys_score_fn(cfg, on_card)(batch)
    torch.cuda.synchronize()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert _kernel_launches() == before
    want = rec.recsys_score(on_cpu, batch)
    assert got.shape == (rows,) and bool(got.isfinite().all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [din.SMOKE, bst.SMOKE], ids=["din", "bst"])
def test_seq_recsys_id_past_the_table_on_card(cfg):
    """An id past the table gives NaN on the card as on the CPU (the
    gather is clamped, never out of range); the other rows stay finite."""
    model = rec.recsys_init(cfg, seed=1, device="cuda")
    batch = synthetic.recsys_batch(np.random.default_rng(2), cfg, 64)
    batch["target_item"][3] = cfg.item_vocab
    got = rec.recsys_score(model, batch).cpu()
    assert torch.isnan(got[3])
    assert bool(got[torch.arange(64) != 3].isfinite().all())


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
@pytest.mark.parametrize("arch", ["din", "bst"])
def test_seq_recsys_serve_launcher_on_card(arch, shape):
    before = _kernel_launches()
    out = launch_serve.main(["--arch", arch, "--shape", shape, "--smoke",
                             "--requests", "3", "--batch", "300"])
    assert out["device"].startswith("cuda") and out["finite"]
    assert _kernel_launches() == before


# ---------------------------------------------------------------------------
# fused_fm_backward and training on the card
# ---------------------------------------------------------------------------
def _fm_grad_check(x, g):
    """The gradient kernel against the plain gradient on the same tensors:
    per element within the bound of the column sums' order (|g| times 4 F
    u sum_f |x|, u = 2^-24) and the output's rounding (2 u of the value in
    fp32, one bf16 ulp, 2^-8, in bf16)."""
    before = dict(fm.launches)
    got = fm.fused_fm_backward(x, g)
    assert fm.launches["fused_fm_backward"] == \
        before["fused_fm_backward"] + 1
    assert fm.launches["fused_fm"] == before["fused_fm"]
    want = ref.fused_fm_backward(x, g)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    x64 = x.double()
    exact = g.double()[:, None, None] * (x64.sum(1, keepdim=True) - x64)
    rel = 2.0 ** -23 if x.dtype == torch.float32 else 2.0 ** -8
    bound = (g.double().abs()[:, None, None] * 4 * x.shape[1] * 2.0 ** -24
             * x64.abs().sum(1, keepdim=True) + rel * exact.abs())
    for out in (got, want):
        assert bool(((out.double() - exact).abs() <= 2 * bound).all())
    assert bool(((got.double() - want.double()).abs() <= 2 * bound).all())


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 3, 5), (33, 13, 9),
                                   (77, 3, 7), (5000, 1, 4), (7, 39, 256),
                                   (3, 2, 5000), (65536, 39, 10)])
def test_fused_fm_backward_kernel_matches_plain(dtype, shape):
    gen = torch.Generator(device="cuda").manual_seed(shape[0])
    x = torch.randn(shape, generator=gen, device="cuda").to(FM_DTYPES[dtype])
    g = torch.randn(shape[0], generator=gen, device="cuda")
    _fm_grad_check(x, g)


@pytest.mark.parametrize("dtype", list(FM_DTYPES))
def test_fused_fm_backward_unaligned_view_reads_in_place(dtype):
    shape = (130, 7, 16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    flat = torch.randn(130 * 7 * 16 + 1, generator=gen, device="cuda")
    x = flat.to(FM_DTYPES[dtype])[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    assert not fm.backward_plan(*shape, x.element_size(), _sm_count(),
                                False).staged
    _fm_grad_check(x, torch.randn(130, generator=gen, device="cuda"))


def test_fused_fm_backward_rejects_what_it_does_not_take():
    before = fm.launches["fused_fm_backward"]
    x = torch.zeros(4, 3, 2, device="cuda")
    with pytest.raises(ValueError):
        fm.fused_fm_backward(x.cpu(), torch.zeros(4))
    with pytest.raises(ValueError):
        fm.fused_fm_backward(x, torch.zeros(4, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        fm.fused_fm_backward(x, torch.zeros(5, device="cuda"))
    with pytest.raises(TypeError):
        fm.fused_fm_backward(x.half(), torch.zeros(4, device="cuda"))
    assert fm.launches["fused_fm_backward"] == before


def test_fm_interaction_under_grad_launches_both_kernels():
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(512, 39, 10, generator=gen, device="cuda",
                    requires_grad=True)
    before = dict(fm.launches)
    out = ops.fm_interaction(x)
    (gx,) = torch.autograd.grad(out, [x], torch.ones_like(out) * 0.5)
    assert fm.launches["fused_fm"] == before["fused_fm"] + 1
    assert fm.launches["fused_fm_backward"] == \
        before["fused_fm_backward"] + 1
    want = ref.fused_fm_backward(x.detach(), torch.full_like(out, 0.5))
    torch.testing.assert_close(gx, want, rtol=1e-5, atol=1e-5)


def test_embedding_bag_weights_requiring_grad_on_the_card_raise():
    """The bag's gradient kernel differentiates the table alone: weights
    that require grad raise the narrowed message under grad, and serving
    (no grad) launches the forward once, as before."""
    table = torch.randn(100, 8, device="cuda", requires_grad=True)
    ids = torch.zeros(4, 5, dtype=torch.int32, device="cuda")
    w = torch.rand(4, 5, device="cuda", requires_grad=True)
    before = dict(bag.launches)
    with pytest.raises(NotImplementedError, match="with respect to its "
                                                  "weights"):
        ops.embedding_bag(table, ids, w, mode="mean")
    with pytest.raises(NotImplementedError, match="trains bag weights"):
        ops.embedding_bag(table.detach(), ids, w, mode="sum")
    assert bag.launches == before
    with torch.no_grad():                       # serving stays as it was
        ops.embedding_bag(table, ids, w, mode="mean")
    with torch.inference_mode():
        ops.embedding_bag(table, ids, mode="mean")
    assert bag.launches == {"embedding_bag": before["embedding_bag"] + 2,
                            "embedding_bag_backward":
                                before["embedding_bag_backward"]}


def _bag_grad_check(g, ids, w, mode, n_rows):
    """The gradient kernel against the plain gradient on the same tensors,
    element by element: |got - want| <= 2 n 2^-24 S + 1e-30, with n the
    terms a row adds and S the sum of their magnitudes (both sums add the
    same n terms, in two orders: recursive summation's bound, Higham).
    Returns the kernel's gradient."""
    before = dict(bag.launches)
    got = bag.embedding_bag_backward(g, ids, w, mode, n_rows)
    assert bag.launches == {**before, "embedding_bag_backward":
                            before["embedding_bag_backward"] + int(
                                g.numel() > 0 and n_rows > 0)}
    want = ref.embedding_bag_backward(g, ids, w, mode, n_rows)
    s, n = ref.embedding_bag_backward_terms(g, ids, w, mode, n_rows)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n_rows, g.shape[1])
    bound = 2 * n[:, None] * 2.0 ** -24 * s + 1e-30
    assert bool(((got - want).abs() <= bound).all())
    return got


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [1, 10, 256, 300])
def test_embedding_bag_backward_kernel_matches_plain(mode, weighted, d):
    """Padding, an all-padding bag, ids repeated in a bag and across bags,
    an id past the table (counted in the mean, adding nothing); D from 1 to
    past one block's 256 threads."""
    _, ids, w = _bag_inputs(37, 50, 400, 1, torch.float32, seed=d,
                            weighted=weighted)
    ids[0] = -1                                     # a fully padded bag
    ids[1, :4] = torch.tensor([7, 7, 400, -1], dtype=torch.int32)
    ids[2:, 0] = 3                                  # a hot row
    g = torch.randn(37, d, device="cuda")
    got = _bag_grad_check(g, ids, w, mode, 400)
    assert bool(got.isfinite().all())


@pytest.mark.parametrize("b,n", [(0, 50), (1, 1), (5, 0), (513, 50),
                                 (3, 1000)])
def test_embedding_bag_backward_any_batch_and_length(b, n):
    _, ids, w = _bag_inputs(b, n, 3000, 1, torch.float32, seed=b,
                            weighted=True)
    g = torch.randn(b, 256, device="cuda")
    for mode in ("sum", "mean"):
        got = _bag_grad_check(g, ids, w, mode, 3000)
    if b == 0 or n == 0:
        assert bool((got == 0).all())


def test_embedding_bag_backward_zipf_hot_rows_at_two_tower_width():
    """A two-tower history batch ([4096, 50], zipf over 100,000 items,
    D = 256): the hottest rows take thousands of adds each."""
    cfg = two_tower_retrieval.CONFIG
    b = synthetic.recsys_batch(np.random.default_rng(3), cfg, 4096)
    ids = torch.from_numpy(b["hist_items"] % 100_000).cuda()
    ids[torch.from_numpy(b["hist_items"] < 0).cuda()] = -1
    g = torch.randn(4096, 256, device="cuda") / 4096
    _bag_grad_check(g, ids, None, "mean", 100_000)
    assert int(torch.bincount(ids[ids >= 0].long()).max()) > 1000


def test_embedding_bag_backward_addresses_rows_past_2_pow_31_elements():
    """An [8,400,000, 256] fp32 gradient (8.6 GB): rows whose element
    offset row * D passes 2^31 - 1."""
    v, d = 8_400_000, 256
    first_past = (2**31 - 1) // d + 1
    gen = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(first_past, v, (64, 50), generator=gen,
                        device="cuda", dtype=torch.int32)
    ids[:, 0] = v - 1
    g = torch.randn(64, d, generator=gen, device="cuda")
    got = bag.embedding_bag_backward(g, ids, None, "sum", v)
    want = torch.zeros(v, d, device="cuda")
    want.index_add_(0, ids.reshape(-1).long(),
                    g.repeat_interleave(50, dim=0))
    s, n = ref.embedding_bag_backward_terms(g, ids, None, "sum", v)
    assert bool(((got - want).abs()
                 <= 2 * n[:, None] * 2.0 ** -24 * s + 1e-30).all())
    assert bool((got[:first_past] == 0).all())
    del got, want, s
    torch.cuda.empty_cache()


def test_embedding_bag_backward_rejects_what_it_does_not_take():
    _, ids, w = _bag_inputs(8, 6, 100, 1, torch.float32, seed=3,
                            weighted=True)
    g = torch.randn(8, 16, device="cuda")
    before = dict(bag.launches)
    with pytest.raises(TypeError, match="float32 g"):
        bag.embedding_bag_backward(g.double(), ids, w, "sum", 100)
    with pytest.raises(TypeError, match="float32 g"):
        bag.embedding_bag_backward(g.half(), ids, w, "sum", 100)
    with pytest.raises(TypeError, match="int32 indices"):
        bag.embedding_bag_backward(g, ids.long(), w, "sum", 100)
    with pytest.raises(TypeError, match="float32 weights"):
        bag.embedding_bag_backward(g, ids, w.double(), "sum", 100)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bag.embedding_bag_backward(g.cpu(), ids.cpu(), None, "sum", 100)
    with pytest.raises(ValueError, match="contiguous"):
        bag.embedding_bag_backward(g.t().contiguous().t(), ids, w, "sum",
                                   100)
    with pytest.raises(ValueError, match="mode"):
        bag.embedding_bag_backward(g, ids, w, "max", 100)
    with pytest.raises(TypeError, match="float32 tables only"):
        ops.embedding_bag(torch.zeros(100, 16, device="cuda",
                                      dtype=torch.bfloat16,
                                      requires_grad=True), ids, mode="sum")
    assert bag.launches == before


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_under_grad_launches_both_kernels(weighted):
    """Under grad the bag lookup is ``EmbeddingBag``: one forward and one
    backward launch, and the table's gradient (which autograd would drop
    through a bare ctypes call) is the plain backward's within the bound."""
    table, ids, w = _bag_inputs(512, 50, 10_000, 256, torch.float32,
                                seed=5, weighted=weighted)
    table.requires_grad_()
    before = dict(bag.launches)
    out = ops.embedding_bag(table, ids, w, mode="mean")
    assert out.requires_grad
    g = torch.randn_like(out)
    (gt,) = torch.autograd.grad(out, [table], g)
    assert bag.launches == {
        "embedding_bag": before["embedding_bag"] + 1,
        "embedding_bag_backward": before["embedding_bag_backward"] + 1}
    want = ref.embedding_bag_backward(g, ids, w, "mean", 10_000)
    s, n = ref.embedding_bag_backward_terms(g, ids, w, "mean", 10_000)
    assert bool(gt.abs().sum() > 0)
    assert bool(((gt - want).abs()
                 <= 2 * n[:, None] * 2.0 ** -24 * s + 1e-30).all())


# (B, L, V, D) of the CPU tests of the ordered gradient
# (test_torch_embedding_bag.py): one bag; D = 10 and 18 (scalar loads), 300
# and 256 (16 B loads, 300 past a warp's 128 columns of them), 1; and a row
# named by 1,200 entries, past C^2, so that it passes through three levels
BWD_CASES = [(1, 7, 20, 10), (9, 6, 30, 18), (37, 50, 400, 300),
             (37, 50, 400, 256), (37, 50, 400, 1), (40, 50, 60, 10)]


def _bwd_inputs(b, n, v, d, seed):
    """g [B, D], ids [B, L] (padding, ids past the table, an all-padding
    bag where B > 1, 1,200 entries of row 3 in the (40, 50) case) and
    weights [B, L], on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(-1, v + 3, (b, n), generator=gen, device="cuda",
                        dtype=torch.int32)
    if b > 1:
        ids[1] = -1
    if b == 40:
        ids[:, :30] = 3
    g = torch.randn(b, d, generator=gen, device="cuda")
    w = torch.rand(b, n, generator=gen, device="cuda")
    return g, ids, w


def _bits(x):
    return x.view(torch.int32)


def _bwd_bitwise(g, ids, w, mode, v):
    """The kernel, twice, against ``ref.embedding_bag_backward_ordered`` on
    the same tensors: all three bit for bit, one launch each."""
    before = bag.launches["embedding_bag_backward"]
    got = bag.embedding_bag_backward(g, ids, w, mode, v)
    again = bag.embedding_bag_backward(g, ids, w, mode, v)
    assert bag.launches["embedding_bag_backward"] == before + 2
    want = ref.embedding_bag_backward_ordered(g, ids, w, mode, v)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))
    return got


@pytest.mark.parametrize("b,n,v,d", BWD_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_backward_kernel_equals_ordered_bitwise(b, n, v, d,
                                                             mode, weighted):
    g, ids, w = _bwd_inputs(b, n, v, d, seed=b * 1000 + d)
    got = _bwd_bitwise(g, ids, w if weighted else None, mode, v)
    if b == 40:
        assert len(bag.embedding_bag_backward_plan(
            *bag.embedding_bag_backward_sort(ids, v), v).levels) == 3
    assert bool(got.isfinite().all())


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_bitwise_at_two_tower_width(mode):
    """A two-tower history batch ([4096, 50], zipf over 100,000 items,
    D = 256, rows with thousands of terms): bitwise the ordered version and
    itself; on g of ones in sum mode each row exactly its count."""
    cfg = two_tower_retrieval.CONFIG
    b = synthetic.recsys_batch(np.random.default_rng(4), cfg, 4096)
    ids = torch.from_numpy(b["hist_items"] % 100_000).cuda()
    ids[torch.from_numpy(b["hist_items"] < 0).cuda()] = -1
    g = torch.randn(4096, 256, device="cuda") / 4096
    _bwd_bitwise(g, ids, None, mode, 100_000)
    counts = bag.embedding_bag_backward(torch.ones_like(g), ids, None, "sum",
                                        100_000)
    n = torch.bincount(ids[ids >= 0].long(), minlength=100_000)
    assert bool((counts == n[:, None].float()).all())
    assert int(n.max()) > 1000


def test_embedding_bag_backward_unaligned_g_equals_ordered_bitwise():
    """g a view off 16 B (D % 4 == 0 all the same): the scalar loads, the
    same bits."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    flat = torch.randn(37 * 256 + 1, generator=gen, device="cuda")
    g = flat[1:].view(37, 256)
    ids = torch.randint(-1, 500, (37, 50), generator=gen, device="cuda",
                        dtype=torch.int32)
    assert g.data_ptr() % 16 and g.is_contiguous()
    _bwd_bitwise(g, ids, None, "mean", 500)


def test_embedding_bag_backward_counts_on_g_of_ones():
    """On g of ones in sum mode every row's gradient is exactly its count of
    entries (an integer fp32 adds exactly), past C^2 terms on one row."""
    _, ids, _ = _bwd_inputs(40, 50, 60, 16, seed=9)
    got = bag.embedding_bag_backward(torch.ones(40, 16, device="cuda"), ids,
                                     None, "sum", 60)
    n = torch.bincount(ids[(ids >= 0) & (ids < 60)].long(), minlength=60)
    assert bool((got == n[:, None].float()).all())


# ---------------------------------------------------------------------------
# random_access: the paper's RA yardstick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["neighborhash", "coalesced"])
@pytest.mark.parametrize("n_q", [1, 255, 256, 257, 4096, 5000])
def test_random_access_kernel_equals_core_lookup(variant, n_q):
    """The RA kernel on a built table's lines against
    ``core/lookup.random_access`` on its value arrays, bitwise, hashed
    modulo the table's capacity; through ``ops.random_access`` too."""
    keys, t = _table(variant, 3000, seed=n_q)
    table = _device_table(t, "cuda")
    qh, ql = (nl.to_device(x, "cuda")
              for x in hc.key_split_np(_queries(keys, n_q, 0.5, seed=n_q)))
    vh, vl = (nl.to_device(x, "cuda") for x in (t.val_hi, t.val_lo))
    before = nl.launches["random_access"]
    got = nl.random_access(table, qh, ql)
    via_ops = ops.random_access(table, qh, ql)
    assert nl.launches["random_access"] == before + 2
    want = lk.random_access(vh, vl, qh, ql, capacity=t.capacity)
    torch.cuda.synchronize()
    for a, b_, w in zip(got, via_ops, want):
        assert a.dtype == torch.uint32 and a.shape == (n_q,)
        assert torch.equal(_bits(a), _bits(w))
        assert torch.equal(_bits(b_), _bits(w))


def test_random_access_rejects_what_it_does_not_take():
    keys, t = _table("neighborhash", 500, seed=3)
    table = _device_table(t, "cuda")
    qh, ql = (nl.to_device(x, "cuda")
              for x in hc.key_split_np(_queries(keys, 64, 0.5, seed=3)))
    before = dict(nl.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nl.random_access(_device_table(t, "cpu"), qh.cpu(), ql.cpu())
    with pytest.raises(ValueError, match="uint32"):
        nl.random_access(table, qh.view(torch.int32), ql)
    with pytest.raises(ValueError, match="uint32"):
        nl.random_access(table, qh.cpu(), ql)
    two = torch.stack([qh.view(torch.int32)] * 2, 1).view(torch.uint32)
    with pytest.raises(ValueError, match="contiguous"):
        nl.random_access(table, two[:, 0], ql)
    with pytest.raises(ValueError, match="lengths"):
        nl.random_access(table, qh[:10], ql)
    assert nl.launches == before


@pytest.mark.parametrize("sparse", [False, True])
def test_deepfm_train_steps_on_card_match_cpu(sparse):
    """Two DeepFM SMOKE steps on the card (FusedFM's kernels) against the
    same steps on the CPU: loss and grad_norm within 1e-5; parameters
    within 1e-5 except where Adam's step is ill-conditioned (sqrt(v̂) <
    1e-6, a gradient near its eps of 1e-8: there within lr)."""
    cfg = deepfm.SMOKE
    ocfg = opt.OptConfig(lr=0.01)
    make = (lambda: ts.make_sparse_recsys_train_step(cfg, ocfg)) if sparse \
        else (lambda: ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = convert.params_of(rec.recsys_init(cfg, seed=0, device="cpu"))
        p = {k: v.to(dev) for k, v in p.items()}
        s, step, fn = opt.init_opt_state(p, ocfg), 0, make()
        before = dict(fm.launches)
        losses = []
        for i in range(2):
            b = synthetic.recsys_batch(np.random.default_rng(i), cfg, 512)
            p, s, step, m = fn(p, s, step, {
                k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        launched = {k: fm.launches[k] - before[k] for k in fm.launches}
        assert launched == ({"fused_fm": 2, "fused_fm_backward": 2}
                            if dev == "cuda" else
                            {"fused_fm": 0, "fused_fm_backward": 0})
        runs[dev] = (losses, p, s)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    _, p_cpu, s_cpu = runs["cpu"]
    for k, v in runs["cuda"][1].items():
        err = (v.cpu() - p_cpu[k]).abs()
        bound = torch.full_like(err, 1e-5) + 1e-5 * p_cpu[k].abs()
        if "v" in s_cpu[k]:
            vhat = s_cpu[k]["v"] / (1 - 0.999 ** 2)
            bound = torch.where(vhat.sqrt() < 1e-6, 0.01, bound)
        assert bool((err <= bound).all()), (k, float(err.max()))


def _launch_counts():
    return {**nl.launches, **fm.launches, **bag.launches}


def test_din_dense_steps_on_card_match_cpu():
    """Two DIN SMOKE dense steps (the realtime loop's trainer) on the card
    against the same steps on the CPU, no kernel launched: loss and
    grad_norm within 1e-5; parameters within 1e-5 except where Adam's step
    is ill-conditioned (there within lr)."""
    cfg = din.SMOKE
    ocfg = opt.OptConfig(lr=0.01)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = convert.params_of(rec.recsys_init(cfg, seed=0, device="cpu"))
        p = {k: v.to(dev) for k, v in p.items()}
        s, step = opt.init_opt_state(p, ocfg), 0
        fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
        before = _launch_counts()
        losses = []
        for i in range(2):
            b = synthetic.recsys_batch(np.random.default_rng(i), cfg, 512)
            p, s, step, m = fn(p, s, step, {
                k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        assert _launch_counts() == before
        runs[dev] = (losses, p, s)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    _, p_cpu, s_cpu = runs["cpu"]
    for k, v in runs["cuda"][1].items():
        err = (v.cpu() - p_cpu[k]).abs()
        bound = torch.full_like(err, 1e-5) + 1e-5 * p_cpu[k].abs()
        if "v" in s_cpu[k]:
            vhat = s_cpu[k]["v"] / (1 - 0.999 ** 2)
            bound = torch.where(vhat.sqrt() < 1e-6, 0.01, bound)
        assert bool((err <= bound).all()), (k, float(err.max()))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("cfg", [bst.SMOKE, two_tower_retrieval.SMOKE],
                         ids=["bst", "two-tower"])
def test_bst_and_two_tower_train_steps_on_card_match_cpu(cfg, sparse):
    """Two SMOKE steps of BST and two-tower on the card against the same
    steps on the CPU: loss and grad_norm within 1e-5.  Parameters within
    1e-5 + 1e-5 |p| plus twice the CPU's own fp32 error against the same
    steps in float64: where two Adam gradients of a weight nearly cancel in
    its momentum (two-tower's first user layer has one at SMOKE, whose
    fp32 step is 2.4e-5 from float64 on the CPU), the update amplifies the
    sums' rounding, wherever they run.  Two-tower's dense step runs both
    bag kernels once a step (its sparse step none); BST's none."""
    ocfg = opt.OptConfig(lr=0.01)
    make = (lambda: ts.make_sparse_recsys_train_step(cfg, ocfg)) if sparse \
        else (lambda: ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg))
    bagged = cfg.arch == "two_tower" and not sparse
    runs = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                       ("cpu", torch.float64)):
        p = convert.params_of(rec.recsys_init(cfg, seed=0, device="cpu"))
        p = {k: v.to(dev, dtype) for k, v in p.items()}
        s, step, fn = opt.init_opt_state(p, ocfg), 0, make()
        before = _launch_counts()
        losses = []
        for i in range(2):
            b = synthetic.recsys_batch(np.random.default_rng(i), cfg, 512)
            if cfg.arch == "two_tower":       # as the launcher drops it
                b.pop("label", None)
            b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            p, s, step, m = fn(p, s, step, {
                k: v.to(dtype) if v.is_floating_point() else v
                for k, v in b.items()})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        launched = {k: v - before[k] for k, v in _launch_counts().items()
                    if v != before[k]}
        assert launched == ({"embedding_bag": 2, "embedding_bag_backward": 2}
                            if dev == "cuda" and bagged else {})
        runs[dev, dtype] = (losses, {k: v.cpu() for k, v in p.items()})
    card, cpu = runs["cuda", torch.float32], runs["cpu", torch.float32]
    exact = runs["cpu", torch.float64][1]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    for k, v in card[1].items():
        err = (v - cpu[1][k]).abs()
        bound = 1e-5 + 1e-5 * cpu[1][k].abs() + 2 * (
            cpu[1][k].double() - exact[k]).abs().float()
        assert bool((err <= bound).all()), (k, float(err.max()))


def test_realtime_loop_smoke_on_card(capsys):
    """``python -m repro_torch.launch.realtime --smoke`` on the card: DIN's
    step there, exit 0, no kernel launched."""
    from repro_torch.launch import realtime
    before = _launch_counts()
    with pytest.raises(SystemExit) as ei:
        realtime.main(["--smoke", "--drain-s", "10"])
    text = capsys.readouterr().out
    assert ei.value.code == 0, text[-2000:]
    assert "realtime SLO report: " in text
    assert _launch_counts() == before


def test_train_launcher_on_card(capsys):
    before = dict(fm.launches)
    out = launch_train.main(["--arch", "deepfm", "--smoke", "--steps", "3"])
    assert out["device"].startswith("cuda") and out["step"] == 3
    assert np.isfinite(out["losses"]).all()
    assert fm.launches["fused_fm"] == before["fused_fm"] + 3
    assert fm.launches["fused_fm_backward"] == \
        before["fused_fm_backward"] + 3
    assert capsys.readouterr().out.rstrip().endswith("done")


@pytest.mark.parametrize("arch", ["bst", "two-tower-retrieval"])
def test_bst_and_two_tower_train_launchers_on_card(arch, capsys):
    before = _launch_counts()
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "3"])
    assert out["device"].startswith("cuda") and out["step"] == 3
    assert np.isfinite(out["losses"]).all()
    launched = {k: v - before[k] for k, v in _launch_counts().items()
                if v != before[k]}
    assert launched == ({"embedding_bag": 3, "embedding_bag_backward": 3}
                        if arch == "two-tower-retrieval" else {})
    assert capsys.readouterr().out.rstrip().endswith("done")


# ---------------------------------------------------------------------------
# probe_linear and probe_sequential: the T1 and Fig. 9 baselines
# ---------------------------------------------------------------------------
def _linear_table(device, t, max_probes=None):
    """A built linear table's lines (no next_idx) on ``device``, as
    ``ops.linear_lookup`` makes them."""
    a = t.device_arrays()
    return ops.one_table(
        a["key_hi"], a["key_lo"], a["val_hi"], a["val_lo"],
        capacity=t.capacity, host_check=False, device=device,
        max_probes=max(t.max_probe_len() + 1, 2) if max_probes is None
        else max_probes)


def _baseline_both(kernel, plain, table_of, t, q):
    """``kernel`` on the card against ``plain`` on the same table on the
    card, bitwise; and the card's answer against the CPU's."""
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    table = table_of("cuda", t)
    name = kernel.__name__
    before = nl.launches[name]
    got = kernel(table, qh, ql)
    assert nl.launches[name] == before + int(len(q) > 0)
    want = plain(table, qh, ql)
    cpu = plain(table_of("cpu", t), qh.cpu(), ql.cpu())
    torch.cuda.synchronize()
    assert got.shape == (3, len(q)) and got.dtype == torch.uint32
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got).cpu(), _bits(cpu))
    return got.cpu()


def _device_table_of(device, t):
    return _device_table(t, device)


def _plain_linear(table, qh, ql):
    return ref.probe_linear(table.lines, qh, ql, capacity=table.capacity,
                            max_probes=table.max_probes)


def _plain_sequential(table, qh, ql):
    return ref.probe_sequential(
        table.lines, table.next_idx, qh, ql, capacity=table.capacity,
        home_capacity=table.home_capacity, host_check=table.host_check,
        max_probes=table.max_probes)


@pytest.mark.parametrize("lf", [0.5, 0.8, 0.95])
@pytest.mark.parametrize("n_q", [0, 1, 255, 256, 257, 4096, 70_000])
def test_probe_linear_matches_plain(n_q, lf):
    keys, t = _table("linear", 5000, seed=n_q + 1, lf=lf)
    q = _queries(keys, n_q, 0.9, seed=n_q)
    got = _baseline_both(nl.probe_linear, _plain_linear, _linear_table, t, q)
    hf, hp = t.lookup_host_batch(q)
    np.testing.assert_array_equal(got[0].numpy().astype(bool), hf)
    np.testing.assert_array_equal(
        (got[1].numpy().astype(np.uint64) << np.uint64(32))
        | got[2].numpy().astype(np.uint64), hp)


def _wrapping_linear(n_tail=10, capacity=64):
    cand = np.arange(2**41, 2**41 + 200_000, dtype=np.uint64)
    homes = hc.bucket_of_np(*hc.key_split_np(cand), capacity)
    tail = cand[homes >= capacity - 4][:n_tail]
    rest = cand[(homes > 8) & (homes < capacity - 8)][:12]
    keys = np.concatenate([tail, rest])
    t = nh.build(keys, keys & np.uint64(0xFFFFFFFFFF), variant="linear",
                 capacity=capacity)
    misses = cand[homes >= capacity - 2]
    return keys, misses[~np.isin(misses, keys)][:16], t


def test_probe_linear_wraps_past_the_end():
    keys, misses, t = _wrapping_linear()
    q = np.concatenate([keys, misses])
    got = _baseline_both(nl.probe_linear, _plain_linear, _linear_table, t, q)
    assert got[0, :len(keys)].bool().all() and not got[0, len(keys):].any()


@pytest.mark.parametrize("max_probes", [0, 1, 2, 4])
def test_probe_linear_max_probes_cut_off(max_probes):
    keys, misses, t = _wrapping_linear(n_tail=14)
    q = np.concatenate([keys, misses])
    got = _baseline_both(
        nl.probe_linear, _plain_linear,
        lambda d, t: _linear_table(d, t, max_probes=max_probes), t, q)
    assert 0 < int(got[0].sum()) < len(keys)


@pytest.mark.parametrize("variant", nh.VARIANTS)
@pytest.mark.parametrize("n_q", [0, 1, 255, 257, 600])
def test_probe_sequential_matches_plain(variant, n_q):
    """Every variant, inline offsets and next_idx chains (``coalesced``'s
    cellar chains among them), with lodgers at LF 0.95."""
    keys, t = _table(variant, 3000, seed=n_q + 2, lf=0.95)
    q = _queries(keys, n_q, 0.8, seed=n_q)
    got = _baseline_both(nl.probe_sequential, _plain_sequential,
                         _device_table_of, t, q)
    qh, ql = (nl.to_device(x, "cuda") for x in hc.key_split_np(q))
    batch = nl.probe_lines(nl.TableGroup([_device_table_of("cuda", t)]),
                           qh, ql, [0, n_q]) if n_q else got
    assert torch.equal(_bits(got), _bits(batch).cpu())


@pytest.mark.parametrize("max_probes", [0, 1, 2])
def test_probe_sequential_max_probes_cut_off(max_probes):
    keys, t = _table("coalesced", 3000, seed=5, lf=0.95)
    q = _queries(keys, 300, 1.0, seed=5)

    def table_of(device, t):
        return dataclasses.replace(_device_table(t, device),
                                   max_probes=max_probes)
    got = _baseline_both(nl.probe_sequential, _plain_sequential, table_of,
                         t, q)
    assert 0 < int(got[0].sum()) < len(q)


def test_baseline_lookups_through_core_lookup_on_card():
    """``core/lookup``'s two baselines on the card (the kernels) equal the
    same calls on the CPU (the plain versions)."""
    keys, t = _table("linear", 4000, seed=8)
    q = _queries(keys, 1000, 0.9, seed=8)
    qh, ql = hc.key_split_np(q)
    a = t.device_arrays()
    for device in ("cuda", "cpu"):
        got = lk.lookup_linear(a["key_hi"], a["key_lo"], a["val_hi"],
                               a["val_lo"], qh, ql, capacity=t.capacity,
                               max_probes=t.max_probe_len() + 1,
                               device=device)
        if device == "cuda":
            card = [x.cpu() for x in got]
        else:
            for g, c in zip(got, card):
                assert torch.equal(g.view(torch.uint8), c.view(torch.uint8))
    keys, t = _table("neighborhash", 4000, seed=9)
    q = _queries(keys, 300, 0.9, seed=9)
    qh, ql = hc.key_split_np(q)
    a = t.device_arrays()
    out = [lk.lookup_sequential(a["key_hi"], a["key_lo"], a["val_hi"],
                                a["val_lo"], None, qh, ql, device=d,
                                **lk.probe_statics(t))
           for d in ("cuda", "cpu")]
    for g, c in zip(*out):
        assert torch.equal(g.cpu().view(torch.uint8), c.view(torch.uint8))


def test_baselines_reject_what_they_do_not_take():
    keys, t = _table("linear", 500, seed=3)
    table = _linear_table("cuda", t)
    qh, ql = (nl.to_device(x, "cuda")
              for x in hc.key_split_np(_queries(keys, 64, 0.5, seed=3)))
    before = dict(nl.launches)
    for kernel in (nl.probe_linear, nl.probe_sequential):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(_linear_table("cpu", t), qh.cpu(), ql.cpu())
        with pytest.raises(ValueError, match="uint32"):
            kernel(table, qh.view(torch.int32), ql)
        with pytest.raises(ValueError, match="lengths"):
            kernel(table, qh[:10], ql)
    assert nl.launches == before


def _chain(n_lines, length, seed):
    """int32 [n_lines, 32] whose word 0 links ``length`` + 1 distinct
    random lines into a chain, and the chain's lines in order."""
    order = np.random.default_rng(seed).choice(n_lines, length + 1,
                                               replace=False)
    words = torch.zeros((n_lines, 32), dtype=torch.int32)
    words[torch.from_numpy(order[:-1]), 0] = torch.from_numpy(
        order[1:].astype(np.int32))
    return words, order


@pytest.mark.parametrize("steps", [0, 1, 7, 4096])
def test_load_chain_follows_the_chain(steps):
    """The load-latency yardstick ends where its plain version does, at
    the chain's ``steps``-th line."""
    words, order = _chain(20_000, 4096, seed=steps)
    before = nl.launches["load_chain"]
    got = nl.load_chain(words.cuda(), int(order[0]), steps)
    assert nl.launches["load_chain"] == before + 1
    want = ref.load_chain(words, int(order[0]), steps)
    assert got.dtype == torch.int64 and got.shape == (1,)
    assert int(got) == int(want) == int(order[steps])


def test_load_chain_clips_and_rejects():
    """A word past the last line is read as the last line, as the plain
    version reads it; CPU tensors, other dtypes and a start out of range
    are refused without a launch."""
    words = torch.zeros((64, 32), dtype=torch.int32)
    words[0, 0], words[63, 0] = 1_000_000, -5
    want = ref.load_chain(words, 0, 3)
    assert int(nl.load_chain(words.cuda(), 0, 3)) == int(want) == 63
    before = dict(nl.launches)
    with pytest.raises(ValueError, match="CUDA"):
        nl.load_chain(words, 0, 3)
    with pytest.raises(ValueError, match="int32"):
        nl.load_chain(words.cuda().float(), 0, 3)
    with pytest.raises(ValueError, match="out of range"):
        nl.load_chain(words.cuda(), 64, 3)
    assert nl.launches == before


def test_cluster_sim_data_plane_on_card_matches_cpu():
    """A small ClusterSim whose data plane is an engine on the card answers
    every batch as the same sim on the CPU, bitwise, through a rolling
    delta update, with the probe kernels launched."""
    from repro_torch.core import cluster_sim as cs
    keys, payloads = nh.random_kv(3000, seed=12)
    rows = np.random.default_rng(12).integers(0, 256, (3000, 16),
                                              dtype=np.uint8)

    def tables(v):
        return ([eng.ScalarTable("s", keys, payloads)],
                [eng.EmbeddingTable("e", keys, rows, hot_fraction=0.2)])

    def deltas(v):
        sel = keys[v * 50:v * 50 + 64]
        return ({"s": (sel, np.full(64, v, dtype=np.uint64)),
                 "e": (sel, np.full((64, 16), v, dtype=np.uint8))}, {})

    out = {}
    for device in ("cuda", "cpu"):
        before = sum(nl.launches.values())
        sim = cs.ClusterSim(cs.SimConfig(n_shards=4, n_replicas=2, seed=2),
                            protocol="naming", tables_for_version=tables,
                            deltas_for_version=deltas, device=device)
        got = []
        for step in range(12):
            if step % 4 == 1:
                sim.start_rolling_update(step // 4 + 1)
            sim.sim.run_until(sim.sim.now + 1_500_000)
            q = _queries(keys, 512, 0.9, seed=step)
            ok, versions, _lat, data = sim.query_batch({"s": q, "e": q})
            got.append((ok, versions, {} if data is None else
                        {k: (f.copy(), d.copy())
                         for k, (f, d) in data.items()}))
        sim.close()
        out[device] = got
        if device == "cuda":
            assert sum(nl.launches.values()) > before
    for (ok_a, v_a, d_a), (ok_b, v_b, d_b) in zip(out["cuda"], out["cpu"]):
        assert ok_a == ok_b and v_a == v_b
        for name in d_a:
            for x, y in zip(d_a[name], d_b[name]):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# GraphSAGE's neighbour sum (csr_sum) and mean
# ---------------------------------------------------------------------------
def _graph_csr(n, e, seed, device="cuda"):
    """A CSR over ``n`` nodes whose destinations skip every third node
    (empty segments) and whose sources have a hub (node 1, a tenth of the
    edges), with self-loops and duplicate edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    src[::10] = 1
    dst = rng.integers(0, n, e)
    dst = dst - dst % 3 + 1
    dst = np.minimum(dst, n - 1)
    src[:50], dst[:50] = np.arange(50) % n, np.arange(50) % n
    src[50:100], dst[50:100] = src[100:150], dst[100:150]
    return seg.adjacency(torch.as_tensor(src, device=device),
                         torch.as_tensor(dst, device=device), n)


@pytest.mark.parametrize("d", [16, 32, 100, 128, 1433])
def test_csr_sum_matches_plain_bitwise(d):
    """The kernel adds each segment's rows in j order from +0.0, as the
    plain version does: the same bits, both over the CSR and over its
    transpose; two launches the same bits; an empty segment 0."""
    adj = _graph_csr(3000, 40_000, d)
    x = torch.randn(3000, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(d))
    for indptr, idx in ((adj.indptr_dst, adj.src_by_dst),
                        (adj.indptr_src, adj.dst_by_src)):
        before = seg.launches["csr_sum"]
        got = seg.csr_sum(x, indptr, idx)
        again = seg.csr_sum(x, indptr, idx)
        torch.cuda.synchronize()
        assert seg.launches["csr_sum"] == before + 2
        want = ref.csr_sum(x, indptr, idx)
        assert torch.equal(got, want)
        assert torch.equal(got, again)
    empty = (adj.indptr_dst[1:] == adj.indptr_dst[:-1])
    assert bool(empty.any())
    got = seg.csr_sum(x, adj.indptr_dst, adj.src_by_dst)
    assert bool((got[empty] == 0).all())


def test_csr_sum_branches_and_edges():
    """A row offset off 16 B takes the scalar branch, the same bits; no
    edges at all gives zeros; a single row."""
    adj = _graph_csr(500, 4000, 1)
    buf = torch.randn(500 * 128 + 1, device="cuda")
    x = buf[1:].view(500, 128)                     # 4 B past 16 B
    before = dict(seg.paths)
    got = seg.csr_sum(x, adj.indptr_dst, adj.src_by_dst)
    assert seg.paths["scalar"] == before["scalar"] + 1
    assert torch.equal(got, ref.csr_sum(x, adj.indptr_dst, adj.src_by_dst))
    got = seg.csr_sum(x.contiguous().clone(), adj.indptr_dst,
                      adj.src_by_dst)
    assert seg.paths["vec"] == before["vec"] + 1
    none = seg.adjacency(torch.zeros(0, dtype=torch.long, device="cuda"),
                         torch.zeros(0, dtype=torch.long, device="cuda"), 7)
    assert torch.equal(seg.csr_sum(x, none.indptr_dst, none.src_by_dst),
                       torch.zeros(7, 128, device="cuda"))
    one = torch.tensor([0, 3], dtype=torch.int64, device="cuda")
    ids = torch.tensor([4, 4, 2], dtype=torch.int32, device="cuda")
    assert torch.equal(seg.csr_sum(x.clone(), one, ids)[0],
                       (x[4] + x[4]) + x[2])


def test_csr_sum_rejects_what_it_does_not_take():
    adj = _graph_csr(100, 500, 2)
    x = torch.randn(100, 8, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        seg.csr_sum(x.cpu(), adj.indptr_dst, adj.src_by_dst)
    with pytest.raises(TypeError, match="float32"):
        seg.csr_sum(x.double(), adj.indptr_dst, adj.src_by_dst)
    with pytest.raises(TypeError, match="int64 indptr"):
        seg.csr_sum(x, adj.indptr_dst.int(), adj.src_by_dst)
    with pytest.raises(ValueError, match="contiguous"):
        seg.csr_sum(x.t(), adj.indptr_dst, adj.src_by_dst)


def test_neighbor_mean_gradient_on_card_is_the_plain_one():
    """``NeighborMean`` on the card (the kernel forward and, over the
    transposed CSR, backward) against the same Function on the CPU (the
    plain version both ways): the same bits."""
    adj = _graph_csr(2000, 30_000, 3)
    adj_cpu = seg.Adjacency(adj.n_nodes, *(
        t.cpu() for t in (adj.indptr_dst, adj.src_by_dst, adj.indptr_src,
                          adj.dst_by_src, adj.deg)))
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2000, 100)).astype(np.float32)
    g = rng.normal(size=(2000, 100)).astype(np.float32)
    out = {}
    for device, a in (("cuda", adj), ("cpu", adj_cpu)):
        x = torch.tensor(h, device=device, requires_grad=True)
        before = seg.launches["csr_sum"]
        y = ops.neighbor_mean(x, a)
        y.backward(torch.as_tensor(g, device=device))
        if device == "cuda":
            torch.cuda.synchronize()
            assert seg.launches["csr_sum"] == before + 2
        out[device] = (y.detach().cpu(), x.grad.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "molecule"])
def test_gnn_steps_on_card_match_cpu(shape):
    """Two steps of the GNN cell at smoke size on the card and on the CPU
    from the same parameters and batches: losses and parameters within
    1e-5 (products and norms in other orders); three neighbour sums a
    step where the regime has them."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn
    runs = {}
    for device in ("cuda", "cpu"):
        cell, cfg, params, fn = launch_train.gnn_setup(
            "graphsage-reddit", shape, True, "cpu")
        params = {k: v.to(device) for k, v in params.items()}
        state = opt.init_opt_state(params, opt.OptConfig())
        rng = np.random.default_rng(0)
        before = seg.launches["csr_sum"]
        losses, step = [], 0
        for _ in range(2):
            batch = gnn.gnn_batch(launch_train.gnn_arrays(rng, cell),
                                  cell.kind, device)
            params, state, step, m = fn(params, state, step, batch)
            losses.append(float(m["loss"]))
        if device == "cuda":
            want = 0 if cell.kind == "gnn_minibatch" else 6
            assert seg.launches["csr_sum"] == before + want
        runs[device] = (losses, {k: v.cpu() for k, v in params.items()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for k, v in runs["cpu"][1].items():
        np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_graphsage_launchers_on_card(capsys):
    out = launch_train.main(["--arch", "graphsage-reddit", "--smoke",
                             "--steps", "2"])
    assert out["device"].startswith("cuda") and out["step"] == 2
    res = launch_serve.main(["--arch", "graphsage-reddit", "--smoke",
                             "--requests", "2"])
    assert res["device"].startswith("cuda") and res["finite"]
