"""Random arrays of given shapes and dtypes, from the JAX package's
``launch/materialize.py``: what the serve launcher's requests are made of.

``materialize(tree, seed, scale, int_high)`` draws the leaves of a tree of
``models/common.ShapeDtype`` (nested dicts, lists and tuples) from ONE
``np.random.default_rng(seed)``, one leaf at a time in ``jax.tree_util``'s
order (dict keys sorted): integers uniform in [0, int_high or 8), floats
from N(0, scale).  The draws are the JAX package's bit for bit, and so is
the cast: a float leaf is rounded to fp32 first and then to its dtype, as
``jnp.asarray`` rounds a float64 array (``tests/test_torch_lm.py``).
Leaves come back as CPU tensors, or on ``device``.  ``nested`` and
``at`` turn the port's path-keyed dicts (``dense_layers/attn/wq``) into
the JAX package's nested trees and back; a path-keyed dict also draws in
the JAX package's leaf order as it stands (its keys sorted component by
component, list indices by number).  ``materialize_bundle`` gives a cell
bundle (``launch/cells.py``) its arguments.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.common import ShapeDtype

HOST_DRAW_PARAMS = 1 << 26    # larger leaves are made on the card


def _key_order(key: str) -> tuple:
    """A dict key's place: a path-keyed dict's ``mlp/10/w`` sorts as the
    reference's nested tree does (component by component, list indices
    by number)."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in str(key).split("/"))


def _leaves(tree, path=()):
    """(path, ShapeDtype) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, ShapeDtype):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=_key_order):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        raise TypeError(f"materialize takes ShapeDtype leaves, got "
                        f"{type(tree).__name__} at {path}")


def _rebuild(tree, drawn: dict, path=()):
    if isinstance(tree, ShapeDtype):
        return drawn[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, drawn, path + (k,)) for k, v in tree.items()}
    return type(tree)(_rebuild(v, drawn, path + (i,))
                      for i, v in enumerate(tree))


def materialize_bundle(bundle, seed: int = 0, device=None) -> tuple:
    """The arguments of a ``launch/cells.CellBundle``, role-aware as the
    reference's ``materialize_bundle``: every leaf drawn by ``materialize``
    (integers below ``meta["int_high"]``), then, for a train cell, the
    optimizer state zeros and the step 0.  On the CPU (``device`` None or
    ``cpu``) the draws are the JAX package's bit for bit.  On the card a
    leaf of more than ``HOST_DRAW_PARAMS`` values is made on the device
    and takes nothing from the host stream: zeros for the optimizer state,
    else drawn there from ``seed`` (normal at ``scale`` 0.02, integers
    uniform below ``int_high`` or 8); those leaves are printed."""
    device = None if device is None else torch.device(device)
    on_card = device is not None and device.type == "cuda"
    has_opt = bundle.meta.get("has_opt")
    int_high = bundle.meta.get("int_high")
    rng = np.random.default_rng(seed)
    gen, big = None, []
    drawn = {}
    for path, leaf in _leaves(tuple(bundle.args)):
        zero = has_opt and path[0] in (1, 2)
        if on_card and math.prod(leaf.shape) > HOST_DRAW_PARAMS:
            big.append("/".join(str(p) for p in path))
            if gen is None:
                gen = torch.Generator(device=device).manual_seed(seed)
            t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
            if zero:
                t.zero_()
            elif leaf.dtype.is_floating_point:
                t.normal_(0, 0.02, generator=gen)
            else:
                t.random_(0, int_high or 8, generator=gen)
            drawn[path] = t
            continue
        t = draw_leaf(rng, leaf, 0.02, int_high)
        if zero:
            t = torch.zeros_like(t)
        drawn[path] = t if device is None else t.to(device)
    if big:
        print(f"drawn on the device from seed {seed}: {', '.join(big)}",
              flush=True)
    return _rebuild(tuple(bundle.args), drawn)


def draw_leaf(rng: np.random.Generator, leaf: ShapeDtype, scale: float,
              int_high) -> torch.Tensor:
    if not leaf.dtype.is_floating_point:
        vals = rng.integers(0, int_high or 8, size=leaf.shape)
        return torch.from_numpy(vals).to(leaf.dtype)
    vals = rng.normal(0, scale, size=leaf.shape).astype(np.float32)
    return torch.from_numpy(vals).to(leaf.dtype)


def materialize(tree, seed: int = 0, scale: float = 0.02,
                int_high: int | None = None, device=None):
    """A tree of ``ShapeDtype`` -> the same tree of tensors (module
    docstring), on ``device`` where given."""
    rng = np.random.default_rng(seed)
    drawn = {}
    for path, leaf in _leaves(tree):
        t = draw_leaf(rng, leaf, scale, int_high)
        drawn[path] = t if device is None else t.to(device)
    return _rebuild(tree, drawn)


def nested(flat_dict: dict) -> dict:
    """``{"a/b": x, "a/c": y}`` -> ``{"a": {"b": x, "c": y}}``; a value that
    is itself a dict (an optimizer state's ``{name: tensor}``) nests
    below its path."""
    out: dict = {}
    for path, v in flat_dict.items():
        *head, last = path.split("/")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def at(tree: dict, path: str):
    """The node of a ``nested`` tree at ``path`` (``"a/b"``)."""
    for part in path.split("/"):
        tree = tree[part]
    return tree
