"""Linear probing where a run meets the end of the table (no card needed):
the port's ``core/lookup.lookup_linear`` and ``kernels/ref.probe_linear``
(the plain version the ``probe_linear`` kernel is held to bitwise on the
card, over the line-packed layout) against the JAX package's
``lookup_linear``, bitwise.

The kernel resolves a run a 128 B line of 8 buckets at a time, so the
cases here are the ones a line walk can get wrong: a capacity that is not
a multiple of 8 (the last line part-filled, the run wrapping to bucket 0
at ``capacity``, not at the line's end), ``max_probes`` cuts that fall
inside a line, on its last bucket and past it, and buckets of the last
line past ``capacity`` that hold the query's key (never part of a run).
test_torch_lookup.py holds the same functions at full-line capacities."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lookup as ref_lookup
from repro.core import neighborhash as ref_nh
from repro_torch.core import hashcore as hc
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops, ref

BPL = nl.BUCKETS_PER_LINE
LINE_WORDS = 4 * BPL


def _linear(n, lf, seed, capacity, max_probes=None):
    """(keys, the JAX package's table, the port's table's arrays, its
    line-packed table) of one build; ``max_probes`` defaults to the
    table's longest run + 1."""
    keys, payloads = nh.random_kv(n, seed=seed)
    kw = dict(variant="linear", load_factor=lf, capacity=capacity)
    t_ref, t = ref_nh.build(keys, payloads, **kw), nh.build(keys, payloads,
                                                            **kw)
    assert t.capacity == capacity and t.capacity % BPL != 0
    a = t.device_arrays()
    table = ops.one_table(
        a["key_hi"], a["key_lo"], a["val_hi"], a["val_lo"],
        capacity=t.capacity, host_check=False, device="cpu",
        max_probes=max(t.max_probe_len() + 1, 2) if max_probes is None
        else max_probes)
    return keys, t_ref, a, table


def _queries(keys, n_q, seed):
    rng = np.random.default_rng(seed)
    q = np.concatenate([keys[rng.integers(0, len(keys), n_q - n_q // 5)],
                        rng.integers(2**62, 2**63, n_q // 5)
                        .astype(np.uint64)])
    rng.shuffle(q)
    return hc.key_split_np(q)


def _u32(a):
    return torch.from_numpy(a.view(np.int32)).view(torch.uint32)


def _plain(table, qh, ql):
    """``ref.probe_linear`` over ``table``'s lines -> uint32 [3, N]."""
    return ref.u32(ref.probe_linear(
        table.lines, _u32(qh), _u32(ql), capacity=table.capacity,
        max_probes=table.max_probes)).numpy()


def _jax(t_ref, qh, ql, max_probes):
    got = ref_lookup.lookup_linear(
        *(jnp.asarray(getattr(t_ref, k))
          for k in ("key_hi", "key_lo", "val_hi", "val_lo")),
        jnp.asarray(qh), jnp.asarray(ql), capacity=t_ref.capacity,
        max_probes=max_probes)
    return np.stack([np.asarray(g).astype(np.uint32) for g in got])


def _both_match_jax(t_ref, arrs, table, qh, ql):
    """The plain version and the port's ``lookup_linear`` (CPU, no
    launch) each bitwise JAX's answers; returns them as uint32 [3, N]."""
    want = _jax(t_ref, qh, ql, table.max_probes)
    np.testing.assert_array_equal(_plain(table, qh, ql), want)
    before = dict(nl.launches)
    found, p_hi, p_lo = lk.lookup_linear(
        arrs["key_hi"], arrs["key_lo"], arrs["val_hi"], arrs["val_lo"], qh,
        ql, capacity=table.capacity, max_probes=table.max_probes,
        device="cpu")
    assert nl.launches == before
    np.testing.assert_array_equal(
        np.stack([found.numpy().astype(np.uint32), p_hi.numpy(),
                  p_lo.numpy()]), want)
    return want


@pytest.mark.parametrize("lf,capacity", [(0.8, 45), (0.95, 197),
                                         (0.97, 203), (0.9, 1001)])
def test_line_walk_matches_jax_past_a_part_filled_line(lf, capacity):
    """Runs that cross lines and wrap past ``capacity`` (not a multiple of
    8, so the last line is part-filled), hits and misses."""
    keys, t_ref, arrs, table = _linear(int(capacity * lf), lf, seed=3,
                                       capacity=capacity)
    qh, ql = _queries(keys, 400, seed=4)
    got = _both_match_jax(t_ref, arrs, table, qh, ql)
    assert got[0].any() and not got[0].all()


@pytest.mark.parametrize("max_probes", [0, 1, 3, 7, 8, 9])
def test_line_walk_cut_at_max_probes_matches_jax(max_probes):
    """A query still going after ``max_probes`` steps reports not found,
    also where the cut falls inside a line, on its last bucket or one
    past it."""
    keys, t_ref, arrs, table = _linear(190, 0.97, seed=5, capacity=197,
                                       max_probes=max_probes)
    qh, ql = _queries(keys, 300, seed=6)
    got = _both_match_jax(t_ref, arrs, table, qh, ql)
    if max_probes < 8:
        assert 0 < int(got[0].sum()) < len(qh)


def test_line_walk_reads_no_bucket_past_capacity():
    """Buckets of the last line past ``capacity`` are never part of a run,
    even where they hold the query's key: the plain version's answers on
    such poisoned lines are JAX's on the table itself."""
    keys, t_ref, _, table = _linear(40, 0.9, seed=7, capacity=45)
    n_lines = table.lines.shape[0]
    assert n_lines * BPL > table.capacity
    qh, ql = _queries(keys, 60, seed=8)
    last = n_lines - 1
    poisoned = table.lines.clone()
    pw = poisoned.view(torch.int32).numpy().view(np.uint32) \
        .reshape(-1, LINE_WORDS)
    for b in range(table.capacity - last * BPL, BPL):     # past capacity
        pw[last, b], pw[last, BPL + b] = qh[0], ql[0]
        pw[last, 2 * BPL + b] = pw[last, 3 * BPL + b] = 7
    bad = dataclasses.replace(table, lines=poisoned)
    np.testing.assert_array_equal(_plain(bad, qh, ql),
                                  _jax(t_ref, qh, ql, table.max_probes))
