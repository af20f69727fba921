"""The port's hash and value-word math against the JAX package's, bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import hashcore as ref_hc
from repro_torch.core import hashcore as hc

BOUNDARY = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1,
                     2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def _keys(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([BOUNDARY, rng.integers(0, 2**64 - 1, n,
                                                  dtype=np.uint64)])


def _torch_u32(a):
    return torch.from_numpy(a.astype(np.int64))


def test_hash_matches_numpy_and_jnp_flavours():
    hi, lo = ref_hc.key_split_np(_keys())
    got = hc.hash64_torch(_torch_u32(hi), _torch_u32(lo)).numpy()
    np.testing.assert_array_equal(got, ref_hc.hash64_np(hi, lo))
    np.testing.assert_array_equal(
        got, np.asarray(ref_hc.hash64_jnp(jnp.asarray(hi), jnp.asarray(lo))))
    np.testing.assert_array_equal(hc.hash64_np(hi, lo),
                                  ref_hc.hash64_np(hi, lo))


@pytest.mark.parametrize("capacity", [1, 7, 8, 1000, 12_500, 5_000_000,
                                      2**31 - 1])
def test_bucket_matches_reference(capacity):
    hi, lo = ref_hc.key_split_np(_keys(seed=capacity % 97))
    got = hc.bucket_of_torch(_torch_u32(hi), _torch_u32(lo), capacity)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_hc.bucket_of_np(hi, lo, capacity))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_hc.bucket_of_jnp(
            jnp.asarray(hi), jnp.asarray(lo), capacity)))


def test_offset_decode_every_code():
    codes = np.arange(1 << 12, dtype=np.uint32)
    val_hi = (codes << np.uint32(20)) | np.uint32(0xABCDE)
    want = np.asarray(ref_hc.decode_offset_jnp(jnp.asarray(val_hi)))
    np.testing.assert_array_equal(
        hc.decode_offset_torch(_torch_u32(val_hi)).numpy(), want)
    np.testing.assert_array_equal(hc.decode_offset_np(val_hi), want)
    for c in (0, 1, 0x7FF, 0x800, 0xFFF):
        assert hc.decode_offset_int(c) == ref_hc.decode_offset_int(c)


def test_constants_and_gpu_line():
    for name in ("MASK32", "EMPTY_KEY", "EMPTY_HI", "EMPTY_LO", "OFFSET_MIN",
                 "OFFSET_MAX", "PAYLOAD_MASK", "PAYLOAD_HI_BITS",
                 "PAYLOAD_HI_MASK", "CPU_BUCKETS_PER_LINE",
                 "TPU_BUCKETS_PER_LINE"):
        assert getattr(hc, name) == getattr(ref_hc, name), name
    assert hc.GPU_BUCKETS_PER_LINE * 16 == 128    # one L2 line of buckets


@settings(deadline=None, max_examples=200)
@given(st.integers(0, 2**64 - 1), st.integers(1, 2**32 - 1))
def test_int_flavour_matches_reference(key, capacity):
    hi, lo = hc.key_split_int(key)
    assert (hi, lo) == ref_hc.key_split_int(key)
    assert hc.hash64_int(hi, lo) == ref_hc.hash64_int(hi, lo)
    assert hc.bucket_of_int(hi, lo, capacity) == \
        ref_hc.bucket_of_int(hi, lo, capacity)
    t = torch.tensor([hi]), torch.tensor([lo])
    assert int(hc.bucket_of_torch(*t, capacity)) == \
        ref_hc.bucket_of_int(hi, lo, capacity)
