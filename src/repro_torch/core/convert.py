"""Carry built tables and model weights over from the JAX package.

A table is this system's state: its bucket arrays are bit-exact across the
two packages (same hash, same layout), so a reference ``HashTable`` crosses
as numpy arrays plus its statics.  ``HashTable.load`` reads the reference's
``save`` snapshots directly (same ``.npz`` format).  A model's weights cross
as the reference's unboxed parameter tree with numpy leaves.

The trainer (``train/``) holds parameters as one flat dict of tensors keyed
by the JAX pytree paths (``field_table``, ``mlp/0/w``, ``blocks/0/wq``), in
``jax.tree_util``'s leaf order, and its optimizer state as ``{path: {name:
tensor}}``: ``params_of`` maps a port model to that dict,
``model_from_params`` maps it back (``model_view`` without a copy), and
``params_from_reference`` / ``opt_state_from_reference`` carry the JAX
package's trees across.
GraphSAGE has no model object: its parameters are that dict
(``models/gnn.sage_init``), and ``gnn_from_reference`` carries the JAX
package's ``sage_init`` tree over with every name and shape checked.
``two_tower_row_blocks`` cuts a whole two-tower model into one rank's row
blocks of its user and item tables, for the sharded user tower.
An LM's parameters are such a dict too (``models/lm.py``), and
``lm_from_reference`` carries the JAX package's ``lm_init`` tree over with
every name, shape and dtype checked, bf16 bit for bit, and
``lm_rank_share`` cuts it and its decode caches to one rank's share of a
``launch/mesh.make_mesh`` mesh.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core import neighborhash as nh
from repro_torch.models import gnn, lm, recsys


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


def _mlp_shapes(name: str, dims) -> dict:
    """Shapes of a list of ``{"w", "b"}`` layers from ``dims[0]`` to
    ``dims[-1]``, by flattened name (``mlp.0.w``)."""
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{name}.{i}.w"], out[f"{name}.{i}.b"] = (a, b), (b,)
    return out


def _checked(params: dict, want: dict, cfg, device) -> dict:
    """The reference's parameter tree (numpy leaves; MLPs as lists of
    ``{"w", "b"}`` layers, BST's ``blocks`` as a list of dicts) flattened
    by name (``mlp.0.w``, ``blocks.0.wq``) and checked against ``want``'s
    names and shapes -> tensors of ``cfg``'s dtype on ``device``."""
    got = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            for i, layer in enumerate(v):
                for name, leaf in layer.items():
                    got[f"{k}.{i}.{name}"] = leaf
        else:
            got[k] = v
    if set(got) != set(want):
        raise ValueError(f"{cfg.name} needs parameters {sorted(want)}, got "
                         f"{sorted(got)}")
    for k, shape in want.items():
        if tuple(np.shape(got[k])) != shape:
            raise ValueError(f"{k} has shape {tuple(np.shape(got[k]))}, "
                             f"{cfg.name} needs {shape}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        device=device, dtype=cfg.torch_dtype) for k, v in got.items()}


def _layers(t: dict, name: str, n: int) -> list:
    return [(t[f"{name}.{i}.w"], t[f"{name}.{i}.b"]) for i in range(n)]


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
    t = _checked(params, {"field_table": (rows, cfg.embed_dim),
                          "w1_table": (rows, 1),
                          "dense_w1": (cfg.n_dense, 1), "bias": (),
                          **_mlp_shapes("mlp", dims)}, cfg, device)
    return recsys.DeepFM(
        cfg, field_table=t["field_table"], w1_table=t["w1_table"],
        dense_w1=t["dense_w1"], bias=t["bias"],
        mlp=_layers(t, "mlp", len(dims) - 1))


def two_tower_from_reference(params: dict, cfg, device):
    """The JAX package's unboxed two-tower parameters (``user_table``,
    ``item_table``, ``cat_table``, ``user_mlp`` and ``item_mlp`` as lists
    of ``{"w", "b"}``, every leaf a numpy array) -> the port's ``TwoTower``
    of ``cfg`` on ``device``.  Raises on any shape that ``cfg`` does not
    give."""
    if cfg.arch != "two_tower":
        raise ValueError(f"{cfg.name} is a {cfg.arch} config, not two_tower")
    d, tower = cfg.embed_dim, tuple(cfg.tower_mlp)
    t = _checked(params, {"user_table": (cfg.user_vocab, d),
                          "item_table": (cfg.item_vocab, d),
                          "cat_table": (cfg.cat_vocab, d),
                          **_mlp_shapes("user_mlp",
                                        (2 * d + cfg.n_dense,) + tower),
                          **_mlp_shapes("item_mlp", (2 * d,) + tower)},
                 cfg, device)
    return recsys.TwoTower(
        cfg, user_table=t["user_table"], item_table=t["item_table"],
        cat_table=t["cat_table"],
        user_mlp=_layers(t, "user_mlp", len(tower)),
        item_mlp=_layers(t, "item_mlp", len(tower)))


def two_tower_row_blocks(params, cfg, rank: int, world: int):
    """A whole two-tower parameter set (a ``TwoTower``, from
    ``two_tower_from_reference`` or ``recsys.two_tower_init``, or its
    path-keyed dict from ``params_of``) -> rank ``rank`` of ``world``'s
    ``TwoTower``: ``user_table`` and ``item_table`` cut to the rank's row
    blocks ``[rank V/world, (rank+1) V/world)``, every other parameter
    whole, all of them views of the given tensors (nothing is copied), its
    user tower served ``a2a`` over the default group
    (``TwoTower.with_lookup`` picks another).  Every name and shape is
    checked; raises when ``world`` does not divide a vocabulary."""
    if cfg.arch != "two_tower":
        raise ValueError(f"{cfg.name} is a {cfg.arch} config, not two_tower")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if isinstance(params, torch.nn.Module):
        params = params_of(params)
    d, tower = cfg.embed_dim, tuple(cfg.tower_mlp)
    want = {"user_table": (cfg.user_vocab, d),
            "item_table": (cfg.item_vocab, d),
            "cat_table": (cfg.cat_vocab, d),
            **_mlp_shapes("user_mlp", (2 * d + cfg.n_dense,) + tower),
            **_mlp_shapes("item_mlp", (2 * d,) + tower)}
    got = {k.replace("/", "."): v for k, v in params.items()}
    if set(got) != set(want):
        raise ValueError(f"{cfg.name} needs parameters {sorted(want)}, got "
                         f"{sorted(got)}")
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(got[k].shape)}, "
                             f"{cfg.name} needs {shape}")

    def block(name: str) -> torch.Tensor:
        rows = got[name].shape[0]
        if rows % world:
            raise ValueError(f"{name}'s {rows} rows do not split over "
                             f"{world} ranks")
        n = rows // world
        return got[name][rank * n:(rank + 1) * n]

    return recsys.TwoTower(
        cfg, user_table=block("user_table"), item_table=block("item_table"),
        cat_table=got["cat_table"],
        user_mlp=_layers(got, "user_mlp", len(tower)),
        item_mlp=_layers(got, "item_mlp", len(tower)), lookup_impl="a2a")


def din_from_reference(params: dict, cfg, device):
    """The JAX package's unboxed DIN parameters (``item_table``,
    ``cat_table``, ``attn_mlp`` and ``mlp`` as lists of ``{"w", "b"}``,
    every leaf a numpy array) -> the port's ``DIN`` of ``cfg`` on
    ``device``.  Raises on any name or shape that ``cfg`` does not give."""
    if cfg.arch != "din":
        raise ValueError(f"{cfg.name} is a {cfg.arch} config, not din")
    d = cfg.embed_dim
    attn = (8 * d,) + tuple(cfg.attn_mlp) + (1,)
    head = (4 * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,)
    t = _checked(params, {"item_table": (cfg.item_vocab, d),
                          "cat_table": (cfg.cat_vocab, d),
                          **_mlp_shapes("attn_mlp", attn),
                          **_mlp_shapes("mlp", head)}, cfg, device)
    return recsys.DIN(cfg, item_table=t["item_table"],
                      cat_table=t["cat_table"],
                      attn_mlp=_layers(t, "attn_mlp", len(attn) - 1),
                      mlp=_layers(t, "mlp", len(head) - 1))


def bst_from_reference(params: dict, cfg, device):
    """The JAX package's unboxed BST parameters (``item_table``,
    ``pos_table``, ``blocks`` as a list of dicts of ``recsys.BST_BLOCK``'s
    names, ``mlp`` as a list of ``{"w", "b"}``, every leaf a numpy array)
    -> the port's ``BST`` of ``cfg`` on ``device``.  Raises on any name or
    shape that ``cfg`` does not give."""
    if cfg.arch != "bst":
        raise ValueError(f"{cfg.name} is a {cfg.arch} config, not bst")
    d, s = cfg.embed_dim, cfg.seq_len + 1
    block = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
             "ln1_g": (d,), "ln1_b": (d,), "ffn1": (d, 4 * d),
             "ffn2": (4 * d, d), "ln2_g": (d,), "ln2_b": (d,)}
    head = (s * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,)
    t = _checked(params, {"item_table": (cfg.item_vocab, d),
                          "pos_table": (s, d),
                          **{f"blocks.{i}.{k}": shape
                             for i in range(cfg.n_blocks)
                             for k, shape in block.items()},
                          **_mlp_shapes("mlp", head)}, cfg, device)
    return recsys.BST(
        cfg, item_table=t["item_table"], pos_table=t["pos_table"],
        blocks=[{k: t[f"blocks.{i}.{k}"] for k in recsys.BST_BLOCK}
                for i in range(cfg.n_blocks)],
        mlp=_layers(t, "mlp", len(head) - 1))


def gnn_from_reference(params: dict, cfg, device) -> dict:
    """The JAX package's unboxed GraphSAGE parameters (``layers`` as a list
    of ``{"w_self", "w_neigh", "b"}``, ``cls``, every leaf a numpy array)
    -> the port's path-keyed parameters of ``cfg`` (``layers/0/w_self``,
    ..., ``cls``) as tensors of its dtype on ``device``.  Raises on any
    name or shape that ``cfg`` does not give."""
    want = gnn.param_shapes(cfg)
    got = flatten_tree(params)
    if set(got) != set(want):
        raise ValueError(f"{cfg.name} needs parameters {sorted(want)}, got "
                         f"{sorted(got)}")
    for k, shape in want.items():
        if tuple(np.shape(got[k])) != shape:
            raise ValueError(f"{k} has shape {tuple(np.shape(got[k]))}, "
                             f"{cfg.name} needs {shape}")
    return {k: torch.from_numpy(np.array(got[k], dtype=np.float32)).to(
        device=device, dtype=cfg.torch_dtype) for k in want}


def lm_from_reference(params: dict, cfg, device) -> dict:
    """The JAX package's unboxed ``lm_init`` tree (nested dicts, stacked
    layers, every leaf a numpy array; bf16 as ml_dtypes' ``bfloat16``) ->
    the port's path-keyed LM parameters of ``cfg`` on ``device``
    (``models/lm.param_specs``' paths and order), each leaf's bytes as
    they are.  Raises on any path, shape or dtype that ``cfg`` does not
    give."""
    want = lm.param_specs(cfg)
    got = flatten_tree(params)
    if set(got) != set(want):
        raise ValueError(f"{cfg.name} needs parameters {sorted(want)}, got "
                         f"{sorted(got)}")
    out = {}
    for k, spec in want.items():
        leaf = got[k]
        if tuple(np.shape(leaf)) != tuple(spec.shape):
            raise ValueError(f"{k} has shape {tuple(np.shape(leaf))}, "
                             f"{cfg.name} needs {tuple(spec.shape)}")
        dtype = spec.dtype or cfg.torch_dtype
        if str(np.asarray(leaf).dtype) != str(dtype).removeprefix("torch."):
            raise ValueError(f"{k} is {np.asarray(leaf).dtype}, {cfg.name} "
                             f"needs {dtype}")
        out[k] = _from_numpy(leaf, device)
    return out


def lm_rank_share(params: dict, cfg, mesh, device, caches=None):
    """The JAX package's LM parameters (``lm_init``'s unboxed tree, numpy
    leaves) and, where given, its decode caches (``{'dense' / 'moe':
    {name: [L, B, Smax, ...]}}``, numpy) -> this rank of ``mesh``'s share
    on ``device``: the experts of each MoE stack cut to the rank's ``E /
    n`` (``lm.expert_cuts``), each cache cut to its ``[:, B / data rows,
    Smax / n positions]`` slice (``lm.decode_cache_specs(..., mesh)``'s
    shapes), everything else whole -> (params, caches or None).  Every
    parameter's name, shape and dtype is checked as
    ``lm_from_reference`` checks it."""
    out = lm_from_reference(params, cfg, "cpu")
    for k, (dim, start, stop) in lm.expert_cuts(cfg, mesh).items():
        out[k] = out[k].narrow(dim, start, stop - start)
    out = {k: v.to(device, copy=True).contiguous() for k, v in out.items()}
    if caches is None:
        return out, None
    whole = {kind: {name: _from_numpy(arr, "cpu")
                    for name, arr in entry.items()}
             for kind, entry in caches.items()}
    return out, {kind: {name: t.to(device) for name, t in entry.items()}
                 for kind, entry in lm.cache_share(whole, mesh).items()}


FROM_REFERENCE = {"deepfm": deepfm_from_reference,
                  "two_tower": two_tower_from_reference,
                  "din": din_from_reference, "bst": bst_from_reference}


def _path_order(path: str) -> tuple:
    """``jax.tree_util``'s leaf order: dict keys sorted, lists by index."""
    return tuple(int(x) if x.isdigit() else x for x in path.split("/"))


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested tree of dicts and lists -> {path: leaf}, paths joined by
    ``/``, in ``jax.tree_util``'s leaf order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _from_numpy(arr, device) -> torch.Tensor:
    """A numpy array (bf16 and fp8 of ml_dtypes included, by their bytes)
    -> a tensor of the same dtype on ``device``."""
    arr = np.array(arr, order="C")            # a copy; 0-d stays 0-d
    if arr.dtype.kind in "biufc":
        return torch.from_numpy(arr).to(device)
    raw = arr.view({1: np.uint8, 2: np.uint16}[arr.dtype.itemsize])
    return torch.from_numpy(raw).view(
        getattr(torch, str(arr.dtype))).to(device)


def params_of(model) -> dict:
    """A port model's parameters as the trainer's path-keyed dict
    (``mlp_w.0`` -> ``mlp/0/w``, ``blocks.0.wq`` -> ``blocks/0/wq``):
    detached tensors that share the model's storage."""
    out = {}
    for name, p in model.named_parameters():
        m = re.fullmatch(r"(\w+)_([wb])\.(\d+)", name)
        out[f"{m[1]}/{m[3]}/{m[2]}" if m else name.replace(".", "/")] = \
            p.detach()
    return dict(sorted(out.items(), key=lambda kv: _path_order(kv[0])))


def params_from_reference(tree, device) -> dict:
    """The JAX package's unboxed parameter tree (numpy leaves) -> the
    trainer's path-keyed dict on ``device``, dtypes kept."""
    return {k: _from_numpy(v, device) for k, v in flatten_tree(tree).items()}


def opt_state_from_reference(tree, device) -> dict:
    """The JAX package's optimizer state (``init_opt_state``'s tree, numpy
    leaves) -> ``{path: {name: tensor}}`` on ``device``, dtypes kept (the
    bf16 momentum of ``adafactor`` too)."""
    out: dict = {}
    for k, v in flatten_tree(tree).items():
        path, name = k.rsplit("/", 1)
        out.setdefault(path, {})[name] = _from_numpy(v, device)
    return out


def model_from_params(cfg, params: dict, device):
    """The trainer's path-keyed dict -> the port's serving model of ``cfg``
    on ``device`` (the values copied; every name and shape checked)."""
    tree: dict = {}
    for k, v in params.items():
        *head, leaf = k.split("/")
        node = tree
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().float().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return FROM_REFERENCE[cfg.arch](lists(tree), cfg, device)


def model_view(cfg, params: dict):
    """The trainer's path-keyed dict -> the port's serving model of ``cfg``
    whose parameters ARE the given tensors (nothing copied, on their
    device, meta tensors included): what a cell bundle's serving step
    scores with (``launch/cells.py``)."""
    t = {k.replace("/", "."): v for k, v in params.items()}

    def mlp(name: str) -> list:
        n = sum(1 for k in t if k.startswith(name + ".") and
                k.endswith(".w"))
        return _layers(t, name, n)

    if cfg.arch == "deepfm":
        return recsys.DeepFM(cfg, field_table=t["field_table"],
                             w1_table=t["w1_table"],
                             dense_w1=t["dense_w1"], mlp=mlp("mlp"),
                             bias=t["bias"])
    if cfg.arch == "two_tower":
        return recsys.TwoTower(cfg, user_table=t["user_table"],
                               item_table=t["item_table"],
                               cat_table=t["cat_table"],
                               user_mlp=mlp("user_mlp"),
                               item_mlp=mlp("item_mlp"))
    if cfg.arch == "din":
        return recsys.DIN(cfg, item_table=t["item_table"],
                          cat_table=t["cat_table"],
                          attn_mlp=mlp("attn_mlp"), mlp=mlp("mlp"))
    if cfg.arch == "bst":
        return recsys.BST(
            cfg, item_table=t["item_table"], pos_table=t["pos_table"],
            blocks=[{k: t[f"blocks.{i}.{k}"] for k in recsys.BST_BLOCK}
                    for i in range(cfg.n_blocks)],
            mlp=mlp("mlp"))
    raise NotImplementedError(recsys.NOT_PORTED.format(arch=cfg.arch))
