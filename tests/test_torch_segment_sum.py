"""The hot-row plan of the ``csr_sum`` kernel and the neighbour mean's
fused division, on the CPU (no card needed): which sources the forward
holds in L2 (``segment_sum.hot_sources``), their marks in a copy of the
indices (``mark_hot``, ``decode``, ``Adjacency.hot_marked``), and the plain
version's ``deg`` and marks (``ref.csr_sum``), with the mean through marked
indices against the JAX package's ``take`` + ``segment_sum`` / deg.

Tolerances: the plan and the marks are integers, bitwise; ``ref.csr_sum``
with ``deg`` is bitwise ``ref.csr_sum`` then ``/ deg`` (the same fp32 adds
in the same order, then one division); the mean against JAX within 1e-5
(rtol and atol), ``tests/test_torch_gnn.py``'s tolerance for fp32 sums
taken in other orders."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ops as jops

from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_sum as seg

TOL = 1e-5


def _graph(n, e, seed):
    """Pareto-skewed sources and uniform destinations, as
    ``data/synthetic.random_graph`` draws them, with ties in out-degree."""
    rng = np.random.default_rng(seed)
    src = np.minimum((rng.pareto(1.2, e) * 3).astype(np.int64), n - 1)
    src = rng.permutation(n)[src]
    dst = rng.integers(0, n, e)
    return src, dst, seg.adjacency(torch.as_tensor(src),
                                   torch.as_tensor(dst), n)


def _by_hand(out_deg, dim, budget):
    """The rule, written out: ids sorted by (out-degree descending, id
    ascending), the first ``budget // row_bytes`` of them, those of two
    terms or more; none when every row fits."""
    n, row = len(out_deg), -(-dim * 4 // 128) * 128
    if n * row <= budget:
        return np.zeros(0, np.int64)
    order = np.lexsort((np.arange(n), -out_deg))[:budget // row]
    return order[out_deg[order] >= 2]


@pytest.mark.parametrize("dim", [3, 32, 100, 128])
@pytest.mark.parametrize("rows_budget", [0, 1, 7, 64, 500, 1999])
def test_hot_sources_by_out_degree_then_id(dim, rows_budget):
    _, _, adj = _graph(2000, 20_000, seed=dim)
    budget = rows_budget * seg.row_bytes(dim)
    got = seg.hot_sources(adj.indptr_src, dim, budget)
    out_deg = np.diff(adj.indptr_src.numpy())
    want = _by_hand(out_deg, dim, budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numel() * seg.row_bytes(dim) <= budget
    assert torch.equal(got, seg.hot_sources(adj.indptr_src, dim, budget))
    if 0 < rows_budget < 500:                 # ties broken by ascending id
        d = out_deg[got.numpy()]
        assert (np.diff(d) <= 0).all()
        same = np.diff(d) == 0
        assert (np.diff(got.numpy())[same] > 0).all()


def test_hot_sources_none_when_every_row_fits():
    _, _, adj = _graph(300, 3000, seed=1)
    assert seg.hot_sources(adj.indptr_src, 100, 300 * 512).numel() == 0
    assert seg.hot_sources(adj.indptr_src, 100, 299 * 512).numel() > 0
    assert seg.row_bytes(100) == 512 and seg.row_bytes(128) == 512 \
        and seg.row_bytes(1) == 128 and seg.row_bytes(33) == 256


def test_marks_decode_to_src_by_dst():
    _, _, adj = _graph(2000, 20_000, seed=2)
    hot = seg.hot_sources(adj.indptr_src, 128, 300 * 512)
    marked = seg.mark_hot(adj.src_by_dst, hot, adj.n_nodes)
    assert marked.dtype == torch.int32
    assert torch.equal(seg.decode(marked), adj.src_by_dst)
    is_hot = np.isin(adj.src_by_dst.numpy(), hot.numpy())
    np.testing.assert_array_equal(marked.numpy() < 0, is_hot)
    assert is_hot.any() and not is_hot.all()


def test_hot_marked_is_kept_once_a_width():
    _, _, adj = _graph(2000, 20_000, seed=3)
    a = adj.hot_marked(100, 100 * 512)
    assert adj.hot_marked(100, 100 * 512)[0] is a[0] and a[1] is True
    # widths of one row size (100 and 128 fp32: 512 B) share the copy
    assert adj.hot_marked(128, 100 * 512)[0] is a[0]
    assert adj.hot_marked(129, 100 * 512)[0] is not a[0]
    assert torch.equal(seg.decode(a[0]), adj.src_by_dst)
    hot = seg.hot_sources(adj.indptr_src, 100, 100 * 512)
    assert torch.equal(a[0], seg.mark_hot(adj.src_by_dst, hot, adj.n_nodes))
    none = adj.hot_marked(100, 10**9)        # every row fits: no marks
    assert none[0] is adj.src_by_dst and none[1] is False
    other = dataclasses.replace(adj, deg=adj.deg.double())
    assert other.hot_marked(100, 100 * 512)[0] is not a[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_divides_after_the_sum(dtype):
    _, _, adj = _graph(1500, 12_000, seed=4)
    x = torch.randn(1500, 37, dtype=dtype,
                    generator=torch.Generator().manual_seed(4))
    deg = adj.deg.to(dtype)
    summed = ref.csr_sum(x, adj.indptr_dst, adj.src_by_dst)
    got = ref.csr_sum(x, adj.indptr_dst, adj.src_by_dst, deg)
    assert torch.equal(got, summed / deg)
    assert torch.equal(ref.csr_sum(x, adj.indptr_dst, adj.src_by_dst,
                                   deg[:, 0]), got)
    marked, any_hot = adj.hot_marked(37, 200 * 256)
    assert any_hot and bool((marked < 0).any())
    assert torch.equal(ref.csr_sum(x, adj.indptr_dst, marked, deg, True),
                       got)
    assert torch.equal(ops.csr_sum(x, adj.indptr_dst, marked, deg, True),
                       got)


def test_plain_empty_rows_and_graph():
    none = seg.adjacency(torch.zeros(0, dtype=torch.long),
                         torch.zeros(0, dtype=torch.long), 5)
    x = torch.randn(5, 4)
    got = ref.csr_sum(x, none.indptr_dst, none.src_by_dst, none.deg)
    assert torch.equal(got, torch.zeros(5, 4))


def test_marked_mean_matches_jax():
    """The forward through the marked copy, divided in the sum's call,
    against ``segment_sum(take(h, src), dst) / deg`` in JAX."""
    src, dst, adj = _graph(1200, 9000, seed=5)
    h = np.random.default_rng(5).normal(size=(1200, 64)).astype(np.float32)
    marked, any_hot = adj.hot_marked(64, 150 * 256)
    assert any_hot
    got = ops.csr_sum(torch.as_tensor(h), adj.indptr_dst, marked, adj.deg,
                      any_hot)
    deg = jnp.maximum(jops.segment_sum(jnp.ones(len(dst)), jnp.asarray(dst),
                                       1200), 1.0)[:, None]
    want = jops.segment_sum(jnp.take(jnp.asarray(h), jnp.asarray(src),
                                     axis=0), jnp.asarray(dst), 1200) / deg
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
