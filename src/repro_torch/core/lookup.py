"""Device-side batch lookup for the NeighborHash family (PyTorch).

The paper's §2.1.1 "Lookup Acceleration": many independent probe state
machines in flight at once.  On the card that is the hand-written probe
kernel (one thread per query, many warps per SM; kernels/neighbor_lookup.py);
on the CPU it is the plain masked advance of kernels/ref.py, where the whole
batch moves one chain step per iteration.  Both are reached through
kernels/ops.py, which picks by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashcore as hc
from repro_torch.core.neighborhash import HashTable
from repro_torch.kernels import ops
from repro_torch.kernels.ref import u32


def lookup(key_hi_t, key_lo_t, val_hi_t, val_lo_t,
           next_idx_t: Optional[torch.Tensor], q_hi, q_lo, *,
           home_capacity: int, inline: bool, host_check: bool,
           max_probes: int, device=None):
    """Batched probe over a built table.

    Returns (found bool[N], payload_hi uint32[N] (20 bits), payload_lo
    uint32[N]).  ``max_probes`` bounds the chain steps after the home bucket
    (the builder's max chain length).  Tensors stay on their device; arrays
    go to ``device`` (default ``"cuda"``)."""
    found, p_hi, p_lo = ops.neighbor_lookup(
        key_hi_t, key_lo_t, val_hi_t, val_lo_t, q_hi, q_lo,
        max_probes=max_probes, home_capacity=home_capacity,
        host_check=host_check, next_idx=None if inline else next_idx_t,
        device=device)
    return found.view(torch.int32) != 0, p_hi, p_lo


def probe_statics(table: HashTable) -> dict:
    """What the probe needs besides the arrays, as the JAX package sets it:
    the lodger check for the home-pure variants, and the builder's max
    chain length (at least 2) as the bound on chain steps."""
    return dict(home_capacity=table.home_capacity, inline=table.inline,
                host_check=table.variant not in ("linear", "coalesced"),
                max_probes=max(table.max_probe_len() + 1, 2))


def lookup_table(table: HashTable, queries: np.ndarray, *, device=None):
    """Convenience host API: uint64 queries -> (found, payload uint64), the
    probe run on ``device`` (default ``"cuda"``)."""
    device = ops.resolve_device(device)
    q_hi, q_lo = hc.key_split_np(np.asarray(queries, dtype=np.uint64))
    arrs = table.device_arrays()
    found, p_hi, p_lo = lookup(
        arrs["key_hi"], arrs["key_lo"], arrs["val_hi"], arrs["val_lo"],
        arrs.get("next_idx"), q_hi, q_lo, device=device, **probe_statics(table))
    found = found.cpu().numpy()
    payload = (p_hi.cpu().numpy().astype(np.uint64) << np.uint64(32)) | \
        p_lo.cpu().numpy().astype(np.uint64)
    return found, payload


def _stamp(arrays: dict):
    """The identity and in-place version of each tensor in ``arrays``, or
    None when a value is not a tensor (numpy arrays carry no version)."""
    if not all(isinstance(a, torch.Tensor) for a in arrays.values()):
        return None
    return sorted((k, id(a), a._version) for k, a in arrays.items())


def make_lookup_fn(table: HashTable):
    """Returns fn(arrays dict, q_hi, q_lo) -> (found, p_hi, p_lo) with the
    table's statics baked in; the caller places the arrays (tensors) on the
    device it wants the probe to run on.  The table is line-packed there
    once and reused while the same, unmodified tensors come back, so a call
    moves only its queries."""
    st = probe_statics(table)
    made = {"stamp": None}

    def fn(arrays: dict, q_hi, q_lo):
        stamp = _stamp(arrays)
        if stamp is None or stamp != made["stamp"]:
            key_hi = arrays["key_hi"]
            group = ops.table_group(
                key_hi, arrays["key_lo"], arrays["val_hi"], arrays["val_lo"],
                max_probes=st["max_probes"],
                home_capacity=st["home_capacity"],
                host_check=st["host_check"],
                next_idx=None if st["inline"] else arrays.get("next_idx"),
                device=key_hi.device if isinstance(key_hi, torch.Tensor)
                else None)
            # holding the arrays keeps the ids in the stamp theirs
            made.update(stamp=stamp, arrays=dict(arrays), group=group)
        found, p_hi, p_lo = ops.probe_table_group(made["group"], q_hi, q_lo)
        return found.view(torch.int32) != 0, p_hi, p_lo

    return fn


# ---------------------------------------------------------------------------
# linear-probing lookup (T1 baseline — probe sequence, not chains)
# ---------------------------------------------------------------------------
def lookup_linear(key_hi_t, key_lo_t, val_hi_t, val_lo_t, q_hi, q_lo, *,
                  capacity: int, max_probes: int, device=None):
    """Linear probing over a built ``linear`` table: home ``hash64 %
    capacity``, then the buckets that follow it (wrapping at ``capacity``)
    until a hit or an empty bucket, at most ``max_probes`` steps past home.
    Returns (found bool[N], payload_hi uint32[N], payload_lo uint32[N]) on
    ``device`` (default: the queries' device when they are tensors, else
    ``"cuda"``).  The table's ``next_idx`` plays no part, so none is
    taken."""
    found, p_hi, p_lo = ops.linear_lookup(
        key_hi_t, key_lo_t, val_hi_t, val_lo_t, q_hi, q_lo,
        capacity=capacity, max_probes=max_probes, device=device)
    return found.view(torch.int32) != 0, p_hi, p_lo


# ---------------------------------------------------------------------------
# RA — the paper's "random access" throughput ceiling: hash + one gather.
# ---------------------------------------------------------------------------
def random_access(val_hi_t: torch.Tensor, val_lo_t: torch.Tensor,
                  q_hi: torch.Tensor, q_lo: torch.Tensor, *, capacity: int):
    idx = hc.bucket_of_torch(u32(q_hi), u32(q_lo), capacity) \
        .clamp(0, val_hi_t.shape[0] - 1)
    return tuple(t.view(torch.int32)[idx].view(torch.uint32)
                 for t in (val_hi_t, val_lo_t))


# ---------------------------------------------------------------------------
# sequential (scalar-emulation) lookup — the "no IMV" baseline for Fig 9:
# one query resolved at a time, no inter-query parallelism.
# ---------------------------------------------------------------------------
def lookup_sequential(key_hi_t, key_lo_t, val_hi_t, val_lo_t,
                      next_idx_t: Optional[torch.Tensor], q_hi, q_lo, *,
                      home_capacity: int, inline: bool, host_check: bool,
                      max_probes: int, device=None):
    """``lookup``'s answers with no inter-query parallelism: on the card one
    thread resolves the queries one after another (the kernel
    ``probe_sequential``), on the CPU the plain probe runs on one query at
    a time.  Same arguments and returns as ``lookup``."""
    found, p_hi, p_lo = ops.sequential_lookup(
        key_hi_t, key_lo_t, val_hi_t, val_lo_t, q_hi, q_lo,
        max_probes=max_probes, home_capacity=home_capacity,
        host_check=host_check, next_idx=None if inline else next_idx_t,
        device=device)
    return found.view(torch.int32) != 0, p_hi, p_lo
