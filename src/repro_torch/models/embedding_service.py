"""Embedding tables and their lookups, from the JAX package's
``models/embedding_service.py``.

A table held whole on one card is looked up by a local gather (the JAX
package's 'xla' path without the sharding constraint), and a bag lookup
runs on the ``embedding_bag`` CUDA kernel there.

A table row-sharded over a process group (rank r of S holds the rows
``[r V/S, (r+1) V/S)``) is served by the JAX package's two serving paths,
each rank passing its block, the global vocabulary, the group and its own
slice of the batch:

  * ``embed_lookup_a2a`` — the batch-query protocol of
    ``core/distributed.py``: ids bucketed by owning rank, one
    ``all_to_all`` of the local row ids, a local gather, one
    ``all_to_all`` of the rows back.
  * ``embed_bag_psum`` — each rank sums the rows it owns for every bag (the
    ``embedding_bag`` kernel on the card), and one all-reduce of the
    partials in bf16 combines them.

Both keep the reference's short-cut: with one rank, or a vocabulary the
group does not divide, the local path runs, and the block must then be the
whole table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import distributed as dist
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


def _local_path(block: torch.Tensor, vocab: int, group) -> bool:
    """The reference's short-cut: one rank, or ``vocab`` not a multiple of
    the group's size.  The local path needs the whole table."""
    n = dist.group_size(group)
    if n > 1 and vocab % n == 0:
        return False
    if block.shape[0] != vocab:
        raise ValueError(f"a group of {n} does not split {vocab} rows, so "
                         f"the local path needs the whole table, got "
                         f"{block.shape[0]} rows")
    return True


def embed_lookup_a2a(block: torch.Tensor, ids: torch.Tensor, vocab: int,
                     group, capacity_factor: float = 1.5) -> torch.Tensor:
    """Single-id lookup of this rank's ``ids`` [...] -> [..., D] through
    the batch-query protocol over ``group``, this rank holding ``block``,
    its rows of the [vocab, D] table.  A negative id, and one dropped past
    a destination's capacity, gives a row of zeros; an id at or past
    ``vocab`` the row the reference gives it (its owner is past the last
    rank, and the reference's clamped gather reads the last rank's first
    slot)."""
    if _local_path(block, vocab, group):
        return embed_lookup(block, ids)
    n_shards = dist.group_size(group)
    rows_per_shard = vocab // n_shards
    d = block.shape[1]
    flat = ids.reshape(-1).long()
    safe = flat.clamp(min=0)
    cap = dist.a2a_capacity(flat.numel(), n_shards, capacity_factor)
    r = dist.route_by_owner((safe // rows_per_shard).to(torch.int32),
                            n_shards, cap)
    (send_ids,) = dist.scatter_to_buffers(
        r, [(safe % rows_per_shard).to(torch.int32)], n_shards, cap)
    recv_ids = dist.all_to_all(send_ids, group)
    rows = block[recv_ids.reshape(-1).long()].reshape(n_shards, cap, d)
    (out,) = dist.gather_from_buffers(r, [dist.all_to_all(rows, group)])
    valid = (flat >= 0) & r.kept
    out = torch.where(valid[:, None], out, 0)
    return out.reshape(tuple(ids.shape) + (d,))


def embed_bag_psum(block: torch.Tensor, ids: torch.Tensor, vocab: int,
                   mode: str, group) -> torch.Tensor:
    """Bag lookup of this rank's ``ids`` [B, L] (-1 pad) -> [B, D] over
    ``group``, this rank holding ``block``: the bag of the rows it owns
    (every other id -1, ``ops.embedding_bag`` in mode ``sum``: the kernel
    on the card), cast to bf16, summed over the group and cast back; for
    ``mean`` over the count of ids the group owns, summed in fp32 and at
    least 1."""
    if _local_path(block, vocab, group):
        return embed_bag(block, ids, None, mode)
    rows_per_shard = vocab // dist.group_size(group)
    local = ids.long() - torch.distributed.get_rank(group) * rows_per_shard
    mine = (ids >= 0) & (local >= 0) & (local < rows_per_shard)
    part = ops.embedding_bag(block, torch.where(mine, local, -1).to(
        torch.int32), None, mode="sum")
    out = dist.all_reduce_sum(part.to(torch.bfloat16), group).to(block.dtype)
    if mode == "mean":
        cnt = dist.all_reduce_sum(mine.sum(dim=1).to(torch.float32), group)
        out = out / cnt.clamp(min=1.0)[:, None]
    return out
