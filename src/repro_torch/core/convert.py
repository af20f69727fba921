"""Carry built tables and model weights over from the JAX package.

A table is this system's state: its bucket arrays are bit-exact across the
two packages (same hash, same layout), so a reference ``HashTable`` crosses
as numpy arrays plus its statics.  ``HashTable.load`` reads the reference's
``save`` snapshots directly (same ``.npz`` format).  A model's weights cross
as the reference's unboxed parameter tree with numpy leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import neighborhash as nh
from repro_torch.models import recsys


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


def deepfm_from_reference(params: dict, cfg, device):
    """The JAX package's unboxed DeepFM parameters (``field_table``,
    ``w1_table``, ``dense_w1``, ``mlp`` as a list of ``{"w", "b"}`` and
    ``bias``, every leaf a numpy array) -> the port's ``DeepFM`` of ``cfg``
    on ``device``.  Raises on any shape that ``cfg`` does not give."""
    if cfg.arch != "deepfm":
        raise ValueError(f"{cfg.name} is a {cfg.arch} config, not deepfm")
    rows = cfg.field_vocab * cfg.n_sparse_fields
    dims = (cfg.n_sparse_fields * cfg.embed_dim + cfg.n_dense,) \
        + tuple(cfg.mlp) + (1,)
    want = {"field_table": (rows, cfg.embed_dim), "w1_table": (rows, 1),
            "dense_w1": (cfg.n_dense, 1), "bias": ()}
    if len(params["mlp"]) != len(dims) - 1:
        raise ValueError(f"mlp has {len(params['mlp'])} layers, "
                         f"{cfg.name} has {len(dims) - 1}")
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        want[f"mlp.{i}.w"], want[f"mlp.{i}.b"] = (a, b), (b,)
    got = {k: params[k] for k in ("field_table", "w1_table", "dense_w1",
                                  "bias")}
    for i, layer in enumerate(params["mlp"]):
        got[f"mlp.{i}.w"], got[f"mlp.{i}.b"] = layer["w"], layer["b"]
    for k, shape in want.items():
        if tuple(np.shape(got[k])) != shape:
            raise ValueError(f"{k} has shape {tuple(np.shape(got[k]))}, "
                             f"{cfg.name} needs {shape}")

    def tensor(k):
        return torch.from_numpy(np.array(got[k], dtype=np.float32)).to(
            device=device, dtype=cfg.torch_dtype)

    return recsys.DeepFM(
        cfg, field_table=tensor("field_table"), w1_table=tensor("w1_table"),
        dense_w1=tensor("dense_w1"), bias=tensor("bias"),
        mlp=[(tensor(f"mlp.{i}.w"), tensor(f"mlp.{i}.b"))
             for i in range(len(dims) - 1)])
