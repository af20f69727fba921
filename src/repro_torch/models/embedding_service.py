"""Embedding tables and their lookups, from the JAX package's
``models/embedding_service.py``.

The port holds a table whole on one card, so a lookup is a local gather
(the JAX package's 'xla' path without the sharding constraint), and a bag
lookup runs on the ``embedding_bag`` CUDA kernel there.
``embed_bag_psum`` and ``embed_lookup_a2a`` come with the port's sharding
(ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hashcore as hc
from repro_torch.kernels import ops
from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class TableCfg:
    name: str
    vocab: int
    dim: int


def table_init(t: TableCfg, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    return cm.normal_init((t.vocab, t.dim), 0.05, generator=generator,
                          device=device, dtype=dtype)


def hash_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """64-bit-safe fold of raw ids into [0, vocab) as int32 (negative ids =
    padding, kept as -1); bitwise the JAX package's ``hash_ids``."""
    x = ids.long()
    lo = x & hc.MASK32
    hi = (x >> 31) & hc.MASK32               # the JAX package's 'high' part
    h = hc.hash64_torch(hi, lo) % vocab
    return torch.where(x < 0, -1, h).to(torch.int32)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-id lookup: ids [...] -> [..., D], as ``jnp.take``'s default
    mode reads it: a negative id gives a row of zeros, an id past the table
    a row of NaN.  The gather's index is clamped into the table first, so
    the card is never indexed out of range."""
    ids = ids.long()                          # int64 indices on the card
    out = table[ids.clamp(0, table.shape[0] - 1)]
    out = out.masked_fill((ids >= table.shape[0])[..., None], float("nan"))
    return out.masked_fill((ids < 0)[..., None], 0)


def embed_bag(table: torch.Tensor, ids: torch.Tensor,
              weights: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """Multi-hot bag lookup: ids int32 [B, L] (-1 pad) -> fp32 [B, D]
    (``ops.embedding_bag``: the kernel on the card)."""
    return ops.embedding_bag(table, ids, weights, mode=mode)
