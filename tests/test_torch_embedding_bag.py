"""The port's plain bag lookup (``repro_torch.kernels.ref.embedding_bag``,
what a CPU tensor runs through ``ops.embedding_bag``) against the JAX
package's Pallas kernel (in interpret mode) and its oracle, on the same
inputs, at ``tests/test_kernel_parity.py``'s tolerance.  The CUDA kernel
itself is held against the plain version on the card
(``test_torch_cuda.py``)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

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
