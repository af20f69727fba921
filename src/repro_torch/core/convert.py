"""Carry built tables over from the JAX package.

A table is this system's state: its bucket arrays are bit-exact across the
two packages (same hash, same layout), so a reference ``HashTable`` crosses
as numpy arrays plus its statics.  ``HashTable.load`` reads the reference's
``save`` snapshots directly (same ``.npz`` format).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import neighborhash as nh


def table_from_reference(arrays: dict[str, np.ndarray], *, variant: str,
                         capacity: int, home_capacity: int,
                         buckets_per_line: int) -> nh.HashTable:
    """A reference table's ``device_arrays()`` and statics -> the port's
    ``HashTable`` (arrays copied).  Occupancy and the max chain length that
    bounds the device probe are recomputed from the arrays, exactly as the
    builder computes them when it finishes a table."""
    if variant not in nh.VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {nh.VARIANTS}")
    for name in ("key_hi", "key_lo", "val_hi", "val_lo"):
        if arrays[name].shape != (capacity,):
            raise ValueError(f"{name} has shape {arrays[name].shape}, "
                             f"expected ({capacity},)")
    nxt = arrays.get("next_idx")
    if (nxt is None) != (variant == "neighborhash"):
        raise ValueError("next_idx is present exactly for the side-array "
                         "variants")
    table = nh.HashTable(
        variant=variant, capacity=capacity,
        buckets_per_line=buckets_per_line,
        key_hi=np.array(arrays["key_hi"], dtype=np.uint32),
        key_lo=np.array(arrays["key_lo"], dtype=np.uint32),
        val_hi=np.array(arrays["val_hi"], dtype=np.uint32),
        val_lo=np.array(arrays["val_lo"], dtype=np.uint32),
        next_idx=None if nxt is None else np.array(nxt, dtype=np.int32),
        home_capacity=home_capacity,
        stats=nh.BuildStats(capacity=capacity))
    return nh._Builder.wrap(table).finish()
