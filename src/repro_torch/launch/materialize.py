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
the JAX package's nested trees and back, so that a parameter dict or an
optimizer state draws in the JAX package's leaf order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ShapeDtype


def _leaves(tree, path=()):
    """(path, ShapeDtype) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, ShapeDtype):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
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
