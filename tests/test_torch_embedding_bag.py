"""The port's plain bag lookup (``repro_torch.kernels.ref.embedding_bag``,
what a CPU tensor runs through ``ops.embedding_bag``) against the JAX
package's Pallas kernel (in interpret mode) and its oracle, on the same
inputs, at ``tests/test_kernel_parity.py``'s tolerance; and the plain
version of the gradient kernel's fixed order
(``ref.embedding_bag_backward_ordered`` and its plan) against the JAX
package's gradient and the port's ``index_add_`` gradient.  The CUDA
kernels themselves are held against the plain versions on the card
(``test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops, ref

TOL = 1e-6                 # test_kernel_parity.py's, fp32 sums of <= 50 rows
V, D = 100, 32
SCALE = 0.05               # table_init's: the scale of the tables served
# B around the TPU kernel's 8 bags per block, which the port does not pad
# to, and L from one id to two-tower's 50
SHAPES = [(1, 5), (7, 5), (8, 5), (9, 5), (33, 5), (9, 1), (9, 50), (33, 50)]


def _inputs(b, n, seed, dtype="float32"):
    """Table, ids with ~1/4 padding and one id V - 1, weights: numpy, the
    table at the scale of the model's tables (a sum of 50 rows stays well
    inside the range where fp32's rounding is below TOL) and rounded once to
    ``dtype`` so both packages hold the same bits."""
    rng = np.random.default_rng(seed)
    table = (SCALE * rng.normal(size=(V, D))).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(ml_dtypes.bfloat16)
    ids = rng.integers(0, V, (b, n)).astype(np.int32)
    ids[rng.random((b, n)) < 0.25] = -1
    ids[0, 0] = V - 1
    weights = rng.random((b, n)).astype(np.float32)
    return table, ids, weights


def _torch(table: np.ndarray) -> torch.Tensor:
    if table.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(table.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(table)


def _both(table, ids, weights, mode):
    """(port plain, port ops) on torch tensors."""
    t, i = _torch(table), torch.from_numpy(ids)
    w = None if weights is None else torch.from_numpy(weights)
    return (ref.embedding_bag(t, i, w, mode),
            ops.embedding_bag(t, i, w, mode=mode))


@pytest.mark.parametrize("b,n", SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_bag_matches_pallas_and_oracle(b, n, mode, weighted):
    table, ids, weights = _inputs(b, n, seed=b * 100 + n)
    weights = weights if weighted else None
    plain, via_ops = _both(table, ids, weights, mode)
    assert plain.dtype == torch.float32 and plain.shape == (b, D)
    assert torch.equal(plain, via_ops)
    jw = None if weights is None else jnp.asarray(weights)
    pallas = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jw,
                                mode=mode, impl="pallas")
    oracle = jref.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jw,
                                mode)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_bag_bf16_table_matches_pallas(mode, weighted):
    """A bf16 table: fp32 accumulation and fp32 output, as the Pallas
    kernel gives (the JAX oracle sums in bf16 and is not the yardstick)."""
    table, ids, weights = _inputs(33, 50, seed=7, dtype="bfloat16")
    weights = weights if weighted else None
    plain, via_ops = _both(table, ids, weights, mode)
    assert plain.dtype == torch.float32
    assert torch.equal(plain, via_ops)
    jw = None if weights is None else jnp.asarray(weights)
    pallas = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jw,
                                mode=mode, impl="pallas")
    assert pallas.dtype == jnp.float32
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_bag_edges_match_the_oracle(mode):
    """Fully padded bags give zeros, id V - 1 its row, mean divides by the
    count of valid entries (not the weights' sum), and an id >= V makes its
    whole bag NaN as jnp.take's fill mode does in the oracle."""
    table, ids, weights = _inputs(6, 4, seed=3)
    ids[1] = -1
    ids[2] = [V - 1, -1, -1, -1]
    ids[3, 1] = V
    ids[4, 3] = V + 1000
    plain, via_ops = _both(table, ids, weights, mode)
    assert torch.equal(plain.isnan(), via_ops.isnan())
    oracle = np.asarray(jref.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(weights), mode))
    np.testing.assert_allclose(plain.numpy(), oracle, rtol=TOL, atol=TOL)
    got = plain.numpy()
    assert (got[1] == 0).all()
    assert np.isnan(got[[3, 4]]).all()
    assert not np.isnan(got[[0, 1, 2, 5]]).any()
    np.testing.assert_allclose(got[2], weights[2, 0] * table[V - 1],
                               rtol=TOL, atol=TOL)
    if mode == "mean":
        valid = ids[5] >= 0
        want = (weights[5, valid, None] * table[ids[5, valid]]).sum(0) \
            / valid.sum()
        np.testing.assert_allclose(got[5], want, rtol=TOL, atol=TOL)


def test_plain_bag_of_empty_bags():
    """L = 0 gives zeros in both modes; B = 0 gives [0, D]."""
    table = torch.randn(10, 4)
    for mode in ("sum", "mean"):
        out = ref.embedding_bag(table, torch.zeros(3, 0, dtype=torch.int32),
                                None, mode)
        assert torch.equal(out, torch.zeros(3, 4))
        out = ops.embedding_bag(table, torch.zeros(0, 5, dtype=torch.int32),
                                mode=mode)
        assert out.shape == (0, 4)


def test_bag_rejects_an_unknown_mode():
    table, ids = torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="sum|mean"):
        ops.embedding_bag(table, ids, mode="max")
    with pytest.raises(ValueError, match="sum|mean"):
        bag.embedding_bag(table, ids, mode="max")


def test_kernel_wrapper_takes_only_cuda_tensors():
    table, ids = torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bag.embedding_bag(table, ids)
    before = bag.launches["embedding_bag"]
    ops.embedding_bag(table, ids, mode="mean")
    assert bag.launches["embedding_bag"] == before


# ---------------------------------------------------------------------------
# the gradient in the kernel's order: ref.embedding_bag_backward_ordered and
# its plan, against the JAX package's gradient and the index_add_ version
# ---------------------------------------------------------------------------
CHUNK = bag.BAG_CHUNK
GRAD_U = 2.0 ** -24        # fp32's unit roundoff
GRAD_REL = 1e-4            # the bound's cap, as chip_smoke.py holds the card
# (B, L, V, D): one bag; D = 10 and 18 (no 16 B loads on the card) and 300
# (past a warp's 128 columns of them); and a row named by more than C^2
# terms, so that it passes through all three levels
GRAD_CASES = [(1, 7, 20, 10), (9, 6, 30, 18), (37, 50, 400, 300),
              (40, 50, 60, 10)]


def _grad_inputs(b, n, v, d, seed, integer=False):
    """g [B, D], ids [B, L] (~1/4 padding, ids past the table, an
    all-padding bag where B > 1, and in the (40, 50) case 1,200 entries of
    row 3), weights [B, L] and a table [V, D], all numpy.  ``integer``: g
    and the weights integer-valued, g a multiple of each bag's mean
    denominator, so that every term and every sum is exact in fp32."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v + 3, (b, n)).astype(np.int32)
    ids[rng.random((b, n)) < 0.25] = -1
    if b > 1:
        ids[1] = -1
    if b == 40:
        ids[:, :30] = 3
    g = rng.normal(size=(b, d)).astype(np.float32)
    w = rng.random((b, n)).astype(np.float32)
    if integer:
        denom = np.maximum((ids >= 0).sum(1), 1)[:, None]
        g = (rng.integers(-8, 9, (b, d)) * denom).astype(np.float32)
        w = rng.integers(1, 4, (b, n)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    return g, ids, w, table


def _jax_grad(g, ids, w, table, mode):
    """``jax.grad`` of <embedding_bag(table), g> through the JAX package's
    oracle: its table's gradient on g."""
    jw = None if w is None else jnp.asarray(w)
    return np.asarray(jax.grad(lambda t: jnp.sum(jref.embedding_bag(
        t, jnp.asarray(ids), jw, mode) * jnp.asarray(g)))(
            jnp.asarray(table)))


def _ordered(g, ids, w, mode, v, chunk=CHUNK):
    return ref.embedding_bag_backward_ordered(
        torch.from_numpy(g), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), mode, v, chunk=chunk)


def _assert_within_order_bound(got, want, g, ids, w, mode, v):
    """|got - want| <= min(2 n 2^-24, 1e-4) S + 1e-30 element by element:
    n the terms a row adds and S their magnitudes' sum, so the two are the
    same terms summed in two orders (recursive summation's bound,
    Higham)."""
    s, n = ref.embedding_bag_backward_terms(
        torch.from_numpy(g), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), mode, v)
    share = (n.to(s.dtype) * (2 * GRAD_U)).clamp(max=GRAD_REL)
    bound = s * share[:, None] + 1e-30
    err = (torch.from_numpy(np.array(got)) - torch.from_numpy(
        np.array(want))).abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("b,n,v,d", GRAD_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ordered_backward_matches_jax_grad(b, n, v, d, mode, weighted):
    """The gradient in the kernel's order against ``jax.grad`` through the
    JAX package's oracle, within the bound of two orders of the same terms;
    padding and ids past the table add to no row."""
    g, ids, w, table = _grad_inputs(b, n, v, d, seed=b * 1000 + d)
    w = w if weighted else None
    got = _ordered(g, ids, w, mode, v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    want = _jax_grad(g, ids, w, table, mode)
    _assert_within_order_bound(got, want, g, ids, w, mode, v)
    named = np.zeros(v, bool)
    named[ids[(ids >= 0) & (ids < v)]] = True
    assert not bool(got[torch.from_numpy(~named)].any())
    if b == 40:
        assert len(bag.embedding_bag_backward_plan(
            *bag.embedding_bag_backward_sort(torch.from_numpy(ids), v),
            v).levels) == 3


@pytest.mark.parametrize("b,n,v,d", GRAD_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ordered_backward_matches_index_add(b, n, v, d, mode, weighted):
    """The same against the port's ``index_add_`` version, the plain
    gradient the card's kernel is also held to, at the same bound."""
    g, ids, w, _ = _grad_inputs(b, n, v, d, seed=b * 1000 + d + 1)
    w = w if weighted else None
    got = _ordered(g, ids, w, mode, v)
    want = ref.embedding_bag_backward(
        torch.from_numpy(g), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), mode, v)
    _assert_within_order_bound(got, want, g, ids, w, mode, v)


@pytest.mark.parametrize("b,n,v,d", GRAD_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ordered_backward_exact_on_integer_inputs(b, n, v, d, mode):
    """Integer-valued terms add exactly in any order: the kernel's order,
    the JAX package's gradient and ``index_add_`` agree exactly."""
    g, ids, w, table = _grad_inputs(b, n, v, d, seed=b + d, integer=True)
    got = _ordered(g, ids, w, mode, v).numpy()
    np.testing.assert_array_equal(got, _jax_grad(g, ids, w, table, mode))
    np.testing.assert_array_equal(got, ref.embedding_bag_backward(
        torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(w),
        mode, v).numpy())


def _scalar_order(g, ids, w, mode, v, chunk):
    """The order ``csrc/embedding_bag.cu``'s header states, one term at a
    time in numpy fp32: each row's terms (g[b] / denom[b]) * w[b, j] in
    ascending (b, j), summed in chunks of ``chunk`` from +0.0, the chunk
    sums again in chunks of ``chunk``, until one value is left."""
    b, n = ids.shape
    terms = {}
    for i in range(b):
        denom = np.float32(max(int((ids[i] >= 0).sum()), 1))
        for j in range(n):
            if 0 <= ids[i, j] < v:
                t = g[i] / denom if mode == "mean" else g[i]
                if w is not None:
                    t = t * w[i, j]
                terms.setdefault(int(ids[i, j]), []).append(t)
    out = np.zeros((v, g.shape[1]), np.float32)
    for row, items in terms.items():
        while True:
            sums = []
            for k in range(0, len(items), chunk):
                acc = np.zeros(g.shape[1], np.float32)
                for x in items[k:k + chunk]:
                    acc = acc + x
                sums.append(acc)
            if len(sums) == 1:
                break
            items = sums
        out[row] = sums[0]
    return out


@pytest.mark.parametrize("chunk", [2, 3, CHUNK])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ordered_backward_is_the_stated_order(chunk, mode, weighted):
    """The vectorised plain version against a scalar loop of the order the
    kernel's source states, bit for bit (small chunks: many levels)."""
    g, ids, w, _ = _grad_inputs(40, 50, 60, 10, seed=chunk)
    w = w if weighted else None
    got = _ordered(g, ids, w, mode, 60, chunk=chunk).numpy()
    want = _scalar_order(g, ids, w, mode, 60, chunk)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _levels_for(max_count, chunk):
    levels, reach = 1, chunk
    while max_count > reach:
        levels, reach = levels + 1, reach * chunk
    return levels


@settings(deadline=None, max_examples=80)
@given(b=st.integers(0, 12), n=st.integers(0, 12), v=st.integers(1, 20),
       chunk=st.integers(2, 5), hot=st.floats(0, 0.9),
       seed=st.integers(0, 2**32 - 1))
def test_plan_covers_every_valid_entry_once(b, n, v, chunk, hot, seed):
    """The plan of any batch: ``perm`` is every entry's place in a stable
    sort by id (padding first, ids past the table last); at every level
    each chunk is 1 to ``chunk`` items of one row, the chunks cover the
    level's items of in-table ids once, the non-final chunks fill the next
    level's items once; each touched row ends in exactly one chunk; and the
    levels are as few as the hottest row allows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, v + 2, (b, n)).astype(np.int32)
    ids[rng.random((b, n)) < hot] = v - 1
    plan = bag.embedding_bag_backward_plan(*bag.embedding_bag_backward_sort(
        torch.from_numpy(ids), v), v, chunk)
    flat = ids.reshape(-1)
    valid = np.flatnonzero((flat >= 0) & (flat < v))
    perm = plan.perm.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(flat.size))
    keys = np.clip(flat, -1, v)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    # level 0's items are perm's positions, the row of each the id there
    item_row, finished = np.where((keys[perm] >= 0) & (keys[perm] < v),
                                  keys[perm], -1), []
    for level in plan.levels:
        start, length, dest = (x.numpy() for x in bag.level_chunks(
            plan, level, chunk))
        covered = np.zeros(len(item_row), int)
        next_row = np.full(level.n_partials, -1)
        for lo, n_items, to in zip(start, length, dest):
            assert 1 <= n_items <= chunk
            row = item_row[lo]
            assert row >= 0 and (item_row[lo:lo + n_items] == row).all()
            covered[lo:lo + n_items] += 1
            if to >= 0:
                assert to == row
                finished.append(to)
            else:
                assert next_row[-1 - to] == -1
                next_row[-1 - to] = row
        assert (covered == (item_row >= 0)).all()
        assert (next_row >= 0).all()
        assert (np.diff(next_row) >= 0).all()    # a row's partials adjoin
        item_row = next_row
    assert (item_row < 0).all()              # nothing left unsummed
    np.testing.assert_array_equal(np.sort(finished), np.unique(flat[valid]))
    counts = np.bincount(flat[valid], minlength=v)
    assert len(plan.levels) == (
        _levels_for(counts.max(), chunk) if len(valid) else 0)


def test_backward_wrapper_takes_only_cuda_tensors():
    g, ids = torch.zeros(2, 4), torch.zeros(2, 3, dtype=torch.int32)
    before = dict(bag.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bag.embedding_bag_backward(g, ids, None, "sum", 5)
    assert bag.launches == before
