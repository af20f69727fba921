"""The port's plain probe (what ``ops`` runs for CPU tensors, and what the
CUDA kernels are held against on the card) against the JAX package's probe:
``ops.neighbor_lookup`` with the Pallas kernels in interpret mode
(``vec``, ``amac``) and the jnp oracle (``ref``), over the cases of
tests/test_kernel_parity.py; and ``core/lookup`` for every variant."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashcore as ref_hc
from repro.core import lookup as ref_lookup
from repro.core import neighborhash as ref_nh
from repro.kernels import ops as ref_ops
from repro_torch.core import engine as eng
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops
from repro_torch.kernels import ref as plain


def _build(n, seed, lf=0.8):
    keys, payloads = ref_nh.random_kv(n, seed=seed)
    return keys, payloads, ref_nh.build(keys, payloads,
                                        variant="neighborhash",
                                        load_factor=lf)


def _queries(keys, n_q, hit_rate, seed):
    rng = np.random.default_rng(seed)
    n_hit = int(round(n_q * hit_rate))
    q = np.concatenate([
        keys[rng.integers(0, len(keys), n_hit)],
        rng.integers(2**62, 2**63, n_q - n_hit).astype(np.uint64)])
    rng.shuffle(q)
    return q


def _against_pallas(t, q, block_q=256):
    """Port (single-table and grouped) vs reference vec / amac / ref."""
    qh, ql = ref_hc.key_split_np(q)
    arrs = (t.key_hi, t.key_lo, t.val_hi, t.val_lo)
    mp = t.max_probe_len() + 1
    want = [np.asarray(x) for x in ref_ops.neighbor_lookup(
        *map(jnp.asarray, arrs), jnp.asarray(qh), jnp.asarray(ql),
        max_probes=mp, impl="ref")]
    for impl in ("vec", "amac"):
        got = ref_ops.neighbor_lookup(
            *map(jnp.asarray, arrs), jnp.asarray(qh), jnp.asarray(ql),
            max_probes=mp, impl=impl, block_q=block_q)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w, impl)
    single = ops.neighbor_lookup(*arrs, qh, ql, max_probes=mp, device="cpu")
    table = nl.DeviceTable(
        lines=torch.from_numpy(nl.pack_lines(*arrs)), next_idx=None,
        capacity=t.capacity, home_capacity=t.capacity, host_check=True,
        max_probes=mp)
    grouped = ops.probe_group(nl.TableGroup([table]),
                              torch.from_numpy(qh), torch.from_numpy(ql),
                              [0, len(q)])
    for what, got in (("single", single), ("grouped", grouped)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w, what)


@pytest.mark.parametrize("hit_rate", [0.0, 0.5, 1.0])
def test_hit_miss_mixes(hit_rate):
    keys, _, t = _build(3000, seed=17)
    _against_pallas(t, _queries(keys, 512, hit_rate, seed=3))


@pytest.mark.parametrize("n_q", [1, 100, 255, 257, 777])
def test_batch_not_multiple_of_tile(n_q):
    keys, _, t = _build(2000, seed=n_q)
    _against_pallas(t, _queries(keys, n_q, 0.7, seed=n_q))


def test_sparse_table_empty_buckets():
    keys, _, t = _build(400, seed=23, lf=0.25)
    _against_pallas(t, _queries(keys, 256, 0.3, seed=5), block_q=64)


def test_lodger_resident_is_a_miss():
    keys, _, t = _build(1500, seed=31, lf=0.95)
    occ = np.flatnonzero(t.key_hi != np.uint32(ref_hc.EMPTY_HI))
    targets = {int(i) for i in occ
               if ref_hc.bucket_of_int(int(t.key_hi[i]), int(t.key_lo[i]),
                                       t.home_capacity) != int(i)}
    assert targets, "LF 0.95 build produced no lodgers?"
    targets = set(sorted(targets)[:8])
    cand = np.arange(2**40, 2**40 + 2_000_000, dtype=np.uint64)
    homes = ref_hc.bucket_of_np(*ref_hc.key_split_np(cand), t.home_capacity)
    q = cand[np.isin(homes, list(targets))]
    q = q[~np.isin(q, keys)][:64]
    assert len(q) == 64 and not t.lookup_host(q)[0].any()
    _against_pallas(t, q, block_q=64)


def test_single_entry_table():
    t = ref_nh.build(np.array([12345], dtype=np.uint64),
                     np.array([777], dtype=np.uint64), variant="neighborhash")
    _against_pallas(t, np.array([12345, 54321, 12345], dtype=np.uint64),
                    block_q=64)


# ---------------------------------------------------------------------------
# core/lookup: every variant (inline offsets and next_idx side arrays)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_lookup_every_variant(variant):
    keys, payloads = ref_nh.random_kv(1500, seed=7)
    want_t = ref_nh.build(keys, payloads, variant=variant, load_factor=0.9)
    got_t = nh.build(keys, payloads, variant=variant, load_factor=0.9)
    q = _queries(keys, 600, 0.8, seed=1)
    wf, wp = ref_lookup.lookup_table(want_t, q)
    gf, gp = lk.lookup_table(got_t, q, device="cpu")
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gp, wp)
    # make_lookup_fn with the arrays placed by the caller
    qh, ql = ref_hc.key_split_np(q)
    arrs = {k: torch.from_numpy(v) for k, v in got_t.device_arrays().items()}
    f, ph, pl = lk.make_lookup_fn(got_t)(arrs, torch.from_numpy(qh),
                                         torch.from_numpy(ql))
    rf, rph, rpl = ref_lookup.make_lookup_fn(want_t)(
        {k: jnp.asarray(v) for k, v in want_t.device_arrays().items()},
        jnp.asarray(qh), jnp.asarray(ql))
    assert f.dtype == torch.bool
    for g, w in ((f, rf), (ph, rph), (pl, rpl)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lookup_fn_packs_once_per_unmodified_tensors(monkeypatch):
    """make_lookup_fn packs the table at its first call and reuses it while
    the same tensors come back; an in-place write or other tensors are
    packed anew."""
    keys, payloads = ref_nh.random_kv(1200, seed=9)
    want_t = ref_nh.build(keys, payloads, variant="neighborhash")
    got_t = nh.build(keys, payloads, variant="neighborhash")
    packed = []
    device_table = nl.device_table
    monkeypatch.setattr(nl, "device_table",
                        lambda arrays, **kw: packed.append(1)
                        or device_table(arrays, **kw))
    fn = lk.make_lookup_fn(got_t)
    arrs = {k: torch.from_numpy(v.copy())
            for k, v in got_t.device_arrays().items()}
    q = np.concatenate([keys[:1], _queries(keys, 400, 0.8, seed=6)])
    qh, ql = ref_hc.key_split_np(q)

    def check(arrays):
        f, p_hi, p_lo = fn(arrays, qh, ql)
        wf, wp = ref_lookup.lookup_table(want_t, q)
        np.testing.assert_array_equal(f.numpy(), wf)
        np.testing.assert_array_equal(
            (p_hi.numpy().astype(np.uint64) << np.uint64(32))
            | p_lo.numpy().astype(np.uint64), wp)

    for _ in range(3):
        check(arrs)
    assert len(packed) == 1
    # a payload written in place is seen at the next call
    bucket = int(np.flatnonzero((want_t.key_hi == qh[0])
                                & (want_t.key_lo == ql[0]))[0])
    arrs["val_lo"][bucket] = 12345
    want_t.val_lo[bucket] = 12345
    check(arrs)
    check(arrs)
    assert len(packed) == 2
    check({k: v.clone() for k, v in arrs.items()})
    assert len(packed) == 3


def test_device_table_from_tensors_equals_from_arrays():
    for variant in ("neighborhash", "coalesced"):
        keys, payloads = ref_nh.random_kv(700, seed=11)
        t = nh.build(keys, payloads, variant=variant)
        kw = dict(capacity=t.capacity, home_capacity=t.home_capacity,
                  host_check=True, max_probes=4, device=torch.device("cpu"))
        arrs = t.device_arrays()
        a = nl.device_table(arrs, **kw)
        b = nl.device_table({k: torch.from_numpy(v) for k, v in arrs.items()},
                            **kw)
        assert torch.equal(a.lines.view(torch.int32),
                           b.lines.view(torch.int32))
        assert (a.next_idx is None) == (b.next_idx is None) \
            == ("next_idx" not in arrs)
        if a.next_idx is not None:
            assert torch.equal(a.next_idx, b.next_idx)


def test_grouped_probe_over_mixed_variants():
    """One grouped call over three tables == three reference lookups."""
    built, qs = [], []
    for i, variant in enumerate(("neighborhash", "coalesced", "linear")):
        keys, payloads = ref_nh.random_kv(900 + 300 * i, seed=40 + i)
        built.append((ref_nh.build(keys, payloads, variant=variant),
                      nh.build(keys, payloads, variant=variant)))
        qs.append(_queries(keys, 200 + 50 * i, 0.75, seed=i))
    cpu = torch.device("cpu")
    group = nl.TableGroup([eng._device_table(p, cpu) for _, p in built])
    q = np.concatenate(qs)
    seg = np.concatenate([[0], np.cumsum([len(x) for x in qs])]).tolist()
    qh, ql = ref_hc.key_split_np(q)
    out = ops.probe_group(group, torch.from_numpy(qh), torch.from_numpy(ql),
                          seg).numpy()
    for (ref_t, _), x, a in zip(built, qs, seg):
        wf, wp = ref_lookup.lookup_table(ref_t, x)
        b = a + len(x)
        np.testing.assert_array_equal(out[0, a:b].astype(bool), wf)
        np.testing.assert_array_equal(
            (out[1, a:b].astype(np.uint64) << np.uint64(32))
            | out[2, a:b].astype(np.uint64), wp)


def test_random_access_matches_reference():
    keys, _, t = _build(1000, seed=2)
    qh, ql = ref_hc.key_split_np(_queries(keys, 300, 0.5, seed=2))
    want = ref_lookup.random_access(jnp.asarray(t.val_hi),
                                    jnp.asarray(t.val_lo), jnp.asarray(qh),
                                    jnp.asarray(ql), capacity=t.capacity)
    got = lk.random_access(torch.from_numpy(t.val_hi),
                           torch.from_numpy(t.val_lo), torch.from_numpy(qh),
                           torch.from_numpy(ql), capacity=t.capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    keys, payloads = ref_nh.random_kv(50, seed=1)
    t = nh.build(keys, payloads)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lk.lookup_table(t, keys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.neighbor_lookup(t.key_hi, t.key_lo, t.val_hi, t.val_lo,
                            *ref_hc.key_split_np(keys), max_probes=3)


def test_kernel_wrapper_refuses_cpu_tensors():
    keys, _, t = _build(100, seed=4)
    table = eng._device_table(nh.build(keys, keys & np.uint64(0xFFFF)),
                              torch.device("cpu"))
    qh, ql = (torch.from_numpy(x) for x in ref_hc.key_split_np(keys))
    before = dict(nl.launches)
    for kernel in (nl.probe_lines, nl.probe_smem):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(nl.TableGroup([table]), qh, ql, [0, len(keys)])
    assert nl.launches == before


@pytest.mark.parametrize("variant", ["neighborhash", "coalesced"])
def test_random_access_through_ops_on_a_cpu_table(variant):
    """``ops.random_access`` on a CPU table's line-packed words (what the
    RA kernel reads on the card) against the JAX package's
    ``random_access`` on the table's value arrays, bitwise, hashed modulo
    the table's capacity; no kernel launches, and the kernel's wrapper
    refuses the CPU table."""
    keys, payloads = ref_nh.random_kv(1000, seed=9)
    t = nh.build(keys, payloads, variant=variant)
    table = eng._device_table(t, torch.device("cpu"))
    qh, ql = ref_hc.key_split_np(_queries(keys, 777, 0.5, seed=9))
    before = dict(nl.launches)
    got = ops.random_access(table, torch.from_numpy(qh), torch.from_numpy(ql))
    want = ref_lookup.random_access(
        jnp.asarray(t.val_hi), jnp.asarray(t.val_lo), jnp.asarray(qh),
        jnp.asarray(ql), capacity=t.capacity)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="CUDA tensors"):
        nl.random_access(table, torch.from_numpy(qh), torch.from_numpy(ql))
    assert nl.launches == before


@pytest.mark.parametrize("steps", [0, 1, 5, 300])
def test_load_chain_plain_version(steps):
    """The load-latency yardstick's plain version (``ref.load_chain``, what
    its kernel is held against) ends at the chain's ``steps``-th line; a
    word past the last line reads as the last line; the kernel's wrapper
    refuses the CPU tensor without a launch."""
    order = np.random.default_rng(steps).choice(1000, 301, replace=False)
    words = torch.zeros((1000, 32), dtype=torch.int32)
    words[torch.from_numpy(order[:-1]), 0] = torch.from_numpy(
        order[1:].astype(np.int32))
    before = dict(nl.launches)
    got = plain.load_chain(words, int(order[0]), steps)
    assert got.dtype == torch.int64 and int(got) == int(order[steps])
    words[int(order[0]), 0] = 5000
    assert int(plain.load_chain(words, int(order[0]), 2)) == \
        int(words[999, 0])
    with pytest.raises(ValueError, match="CUDA"):
        nl.load_chain(words, int(order[0]), steps)
    assert nl.launches == before


# ---------------------------------------------------------------------------
# core/lookup: the T1 linear-probing and Fig. 9 sequential baselines
# ---------------------------------------------------------------------------
def _linear_both(t_ref, t_port, q, max_probes=None):
    """lookup_linear of both packages on the same table and queries,
    bitwise; returns the port's (found, payload uint64)."""
    mp = max(t_ref.max_probe_len() + 1, 2) if max_probes is None \
        else max_probes
    qh, ql = ref_hc.key_split_np(q)
    want = ref_lookup.lookup_linear(
        *(jnp.asarray(getattr(t_ref, k))
          for k in ("key_hi", "key_lo", "val_hi", "val_lo")),
        jnp.asarray(qh), jnp.asarray(ql), capacity=t_ref.capacity,
        max_probes=mp)
    arrs = t_port.device_arrays()
    before = dict(nl.launches)
    got = lk.lookup_linear(arrs["key_hi"], arrs["key_lo"], arrs["val_hi"],
                           arrs["val_lo"], qh, ql, capacity=t_port.capacity,
                           max_probes=mp, device="cpu")
    assert nl.launches == before
    assert got[0].dtype == torch.bool and got[1].dtype == torch.uint32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got[0].numpy(), (got[1].numpy().astype(np.uint64)
                            << np.uint64(32)) | got[2].numpy()


@pytest.mark.parametrize("hit_rate", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("lf", [0.5, 0.8, 0.95])
def test_lookup_linear_hit_miss_mixes(hit_rate, lf):
    keys, payloads = ref_nh.random_kv(2500, seed=61)
    t_ref = ref_nh.build(keys, payloads, variant="linear", load_factor=lf)
    t_port = nh.build(keys, payloads, variant="linear", load_factor=lf)
    q = _queries(keys, 700, hit_rate, seed=62)
    found, payload = _linear_both(t_ref, t_port, q)
    hf, hp = t_ref.lookup_host_batch(q)
    np.testing.assert_array_equal(found, hf)
    np.testing.assert_array_equal(payload, hp)


def _wrapping_linear_table(capacity=64, n_tail=10, seed=5):
    """A linear table whose last buckets are full and whose runs wrap past
    the end to bucket 0: ``n_tail`` keys homed in its last four buckets,
    plus a few homed elsewhere; and misses homed in the last two buckets."""
    cand = np.arange(2**41, 2**41 + 200_000, dtype=np.uint64)
    homes = ref_hc.bucket_of_np(*ref_hc.key_split_np(cand), capacity)
    tail = cand[homes >= capacity - 4][:n_tail]
    rest = cand[(homes > 8) & (homes < capacity - 8)][:12]
    keys = np.concatenate([tail, rest])
    payloads = (keys * np.uint64(2654435761)) & np.uint64(ref_hc.PAYLOAD_MASK)
    misses = cand[homes >= capacity - 2]
    misses = misses[~np.isin(misses, keys)][:16]
    kw = dict(variant="linear", capacity=capacity)
    t_ref = ref_nh.build(keys, payloads, **kw)
    t_port = nh.build(keys, payloads, **kw)
    return keys, misses, t_ref, t_port


def test_lookup_linear_wraps_past_the_end():
    keys, misses, t_ref, t_port = _wrapping_linear_table()
    # the tail run really wraps: bucket 0 holds a key homed at the end
    home0 = ref_hc.bucket_of_int(int(t_ref.key_hi[0]), int(t_ref.key_lo[0]),
                                 t_ref.capacity)
    assert home0 >= t_ref.capacity - 4
    q = np.concatenate([keys, misses, keys[::-1]])
    found, payload = _linear_both(t_ref, t_port, q)
    hf, hp = t_ref.lookup_host_batch(q)
    np.testing.assert_array_equal(found, hf)
    np.testing.assert_array_equal(payload, hp)
    assert found[:len(keys)].all() and not found[len(keys):-len(keys)].any()


@pytest.mark.parametrize("max_probes", [0, 1, 2, 4])
def test_lookup_linear_max_probes_below_the_runs(max_probes):
    """A bound below what the table needs: a query still going at the
    bound reports not found, in both packages alike."""
    keys, misses, t_ref, t_port = _wrapping_linear_table(n_tail=14)
    assert t_ref.max_probe_len() > max_probes + 1
    q = np.concatenate([keys, misses])
    found, _ = _linear_both(t_ref, t_port, q, max_probes=max_probes)
    assert 0 < found.sum() < len(keys)


def test_lookup_linear_empty_batch_and_empty_home():
    keys, payloads = ref_nh.random_kv(300, seed=3)
    t_ref = ref_nh.build(keys, payloads, variant="linear", load_factor=0.3)
    t_port = nh.build(keys, payloads, variant="linear", load_factor=0.3)
    found, _ = _linear_both(t_ref, t_port, np.zeros(0, np.uint64))
    assert found.shape == (0,)
    # misses whose home bucket is empty end at once
    cand = np.arange(2**50, 2**50 + 5000, dtype=np.uint64)
    homes = ref_hc.bucket_of_np(*ref_hc.key_split_np(cand), t_ref.capacity)
    empty = t_ref.key_hi[homes] == np.uint32(ref_hc.EMPTY_HI)
    found, _ = _linear_both(t_ref, t_port, cand[empty][:64], max_probes=0)
    assert not found.any()


def _sequential_both(t_ref, t_port, q):
    """lookup_sequential of both packages, bitwise, and equal to the batch
    lookup; returns the port's found."""
    qh, ql = ref_hc.key_split_np(q)
    st = lk.probe_statics(t_port)
    ref_arrs = t_ref.device_arrays()
    want = ref_lookup.lookup_sequential(
        *(jnp.asarray(ref_arrs[k])
          for k in ("key_hi", "key_lo", "val_hi", "val_lo")),
        jnp.asarray(ref_arrs["next_idx"]) if "next_idx" in ref_arrs
        else None, jnp.asarray(qh), jnp.asarray(ql), **st)
    arrs = t_port.device_arrays()
    before = dict(nl.launches)
    got = lk.lookup_sequential(arrs["key_hi"], arrs["key_lo"],
                               arrs["val_hi"], arrs["val_lo"],
                               arrs.get("next_idx"), qh, ql, device="cpu",
                               **st)
    assert nl.launches == before
    batch = lk.lookup(arrs["key_hi"], arrs["key_lo"], arrs["val_hi"],
                      arrs["val_lo"], arrs.get("next_idx"), qh, ql,
                      device="cpu", **st)
    assert got[0].dtype == torch.bool
    for g, w, b in zip(got, want, batch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, b)
    return got[0].numpy()


@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_lookup_sequential_every_variant(variant):
    keys, payloads = ref_nh.random_kv(1200, seed=71)
    t_ref = ref_nh.build(keys, payloads, variant=variant, load_factor=0.9)
    t_port = nh.build(keys, payloads, variant=variant, load_factor=0.9)
    q = _queries(keys, 150, 0.8, seed=72)
    found = _sequential_both(t_ref, t_port, q)
    if variant != "linear":       # the chain probe does not walk runs
        np.testing.assert_array_equal(found, t_ref.lookup_host_batch(q)[0])


@pytest.mark.parametrize("hit_rate", [0.0, 1.0])
def test_lookup_sequential_hit_miss_mixes(hit_rate):
    keys, payloads = ref_nh.random_kv(1500, seed=73)
    t_ref = ref_nh.build(keys, payloads, variant="neighborhash")
    t_port = nh.build(keys, payloads, variant="neighborhash")
    found = _sequential_both(t_ref, t_port, _queries(keys, 120, hit_rate, 74))
    assert found.all() if hit_rate else not found.any()


def test_lookup_sequential_empty_batch():
    keys, payloads = ref_nh.random_kv(100, seed=75)
    t_ref = ref_nh.build(keys, payloads, variant="coalesced")
    t_port = nh.build(keys, payloads, variant="coalesced")
    assert _sequential_both(t_ref, t_port,
                            np.zeros(0, np.uint64)).shape == (0,)


def test_baseline_wrappers_refuse_cpu_tensors():
    keys, payloads = ref_nh.random_kv(200, seed=76)
    for variant, kernel in (("linear", nl.probe_linear),
                            ("coalesced", nl.probe_sequential)):
        table = eng._device_table(nh.build(keys, payloads, variant=variant),
                                  torch.device("cpu"))
        qh, ql = (torch.from_numpy(x) for x in ref_hc.key_split_np(keys))
        before = dict(nl.launches)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(table, qh, ql)
        assert nl.launches == before
