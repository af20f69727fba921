"""The sharded batch query: the paper's client->shard routing protocol over
``torch.distributed``, from the JAX package's ``core/distributed.py``.

Every rank of a process group holds one NeighborHash shard of a table.  Two
schemes answer a batch of uint64 keys (carried as uint32 ``q_hi`` /
``q_lo``):

  * ``replicated`` — every rank gets the whole batch, probes its own shard,
    masks the keys it does not own, and one ``all_reduce(SUM)`` each merges
    ``found``, ``p_hi`` and ``p_lo``.  No routing, but the batch is probed
    once a rank.
  * ``a2a`` — every rank gets its own slice of the batch, buckets it by
    owning shard into [S, capacity] send buffers, exchanges them with
    ``all_to_all_single``, probes what it received and sends the answers
    back the same way: the paper's batch-query fan-out.  Each destination
    takes at most ``capacity`` queries of a rank; the rest are dropped,
    counted and returned as ``n_dropped``, and answer "not found".

The routing primitives (``route_by_owner``, ``scatter_to_buffers``,
``gather_from_buffers``) also serve the model's row-sharded embedding
lookups (``models/embedding_service.py``).

One departure from the JAX package: ``scatter_to_buffers`` writes the kept
queries only.  The reference also writes a zero for every dropped query at
its ``(owner, 0)`` slot, which a kept query holds whenever the destination
overflows; XLA leaves the order of those duplicate writes to the
implementation, and on the CPU the zero wins, so the kept query loses its
key (a "not found", or the owner's row 0 in an embedding lookup).  Here the
kept query keeps its slot.  Everything else is the reference's bit for bit,
``Routing``'s fields included, and so is every answer that slot does not
touch.

Collectives run on the backend the caller gave the group.  NCCL exchanges
the card's tensors; gloo exchanges host copies, so with gloo a CUDA
tensor is copied to the host before each collective and back after it
(``host_staged``): that is how several ranks share one card, which NCCL
refuses.  uint32 words and flags travel as int32, and a bf16 tensor that
is only moved (``all_to_all``, ``all_gather``) as its bytes.  The
LM's sequence-sharded decode and expert-parallel MoE
(``models/attention.py``, ``models/moe.py``) use ``all_to_all``,
``all_gather``, ``all_reduce_sum`` and ``all_reduce_max``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import hashcore as hc
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as _nl
from repro_torch.kernels import ops
from repro_torch.kernels.ref import u32
from repro_torch.roofline import analysis

WORDS = ("key_hi", "key_lo", "val_hi", "val_lo")
INT32_MIN = -(1 << 31)


# ---------------------------------------------------------------------------
# sharded table container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedTables:
    """S NeighborHash shards padded to one capacity, stacked on a leading
    shard axis: ``arrays`` holds key_hi / key_lo / val_hi / val_lo as uint32
    [S, capacity] host arrays.  ``max_probes`` bounds every shard's chain
    steps."""
    n_shards: int
    capacity: int            # per-shard bucket count (uniform)
    max_probes: int
    arrays: dict

    def shard_group(self, rank: int, device) -> _nl.TableGroup:
        """Shard ``rank`` line-packed once as a one-table group on
        ``device``, as each rank probes it (inline offsets, the lodger
        check, home capacity = capacity)."""
        return ops.table_group(
            *(self.arrays[k][rank] for k in WORDS), max_probes=self.max_probes,
            home_capacity=self.capacity, host_check=True, device=device)

    def host_table(self, rank: int) -> nh.HashTable:
        """Shard ``rank`` as a host ``HashTable`` (its arrays copied), for
        ``lookup_host_batch``; its stats hold the occupancy only."""
        words = {k: np.array(self.arrays[k][rank], dtype=np.uint32)
                 for k in WORDS}
        n = int((~((words["key_hi"] == np.uint32(hc.EMPTY_HI))
                   & (words["key_lo"] == np.uint32(hc.EMPTY_LO)))).sum())
        return nh.HashTable(
            variant="neighborhash", capacity=self.capacity,
            buckets_per_line=hc.CPU_BUCKETS_PER_LINE, **words,
            next_idx=None, home_capacity=self.capacity,
            stats=nh.BuildStats(n=n, capacity=self.capacity,
                                load_factor=n / self.capacity))


def build_sharded(keys: np.ndarray, payloads: np.ndarray, n_shards: int, *,
                  load_factor: float = 0.8,
                  variant: str = "neighborhash") -> ShardedTables:
    """Each key to shard ``hash64 % n_shards``; every shard built at the
    capacity the fullest one needs (``counts.max() / load_factor``, at least
    8) and ``max_probes`` the longest chain plus one (at least 2): the JAX
    package's ``build_sharded``, bit for bit."""
    keys = np.asarray(keys, dtype=np.uint64)
    payloads = np.asarray(payloads, dtype=np.uint64)
    hi, lo = hc.key_split_np(keys)
    owner = (hc.hash64_np(hi, lo) % np.uint32(n_shards)).astype(np.int32)
    counts = np.bincount(owner, minlength=n_shards)
    cap = max(int(math.ceil(counts.max() / load_factor)), 8)
    stacks = {k: np.zeros((n_shards, cap), dtype=np.uint32) for k in WORDS}
    max_probes = 2
    for s in range(n_shards):
        rows = np.flatnonzero(owner == s)
        t = nh.build(keys[rows], payloads[rows], variant=variant,
                     capacity=cap)
        for k in WORDS:
            stacks[k][s] = getattr(t, k)
        max_probes = max(max_probes, t.max_probe_len() + 1)
    return ShardedTables(n_shards=n_shards, capacity=cap,
                         max_probes=max_probes, arrays=stacks)


def owner_of(q_hi: torch.Tensor, q_lo: torch.Tensor,
             n_shards: int) -> torch.Tensor:
    """uint32 key words -> int32 [N], each key's shard."""
    return (hc.hash64_torch(u32(q_hi), u32(q_lo)) % n_shards).to(torch.int32)


# ---------------------------------------------------------------------------
# routing primitives
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Routing:
    """Index bookkeeping for bucketing N local queries to S destinations
    with per-destination capacity C."""
    dest: torch.Tensor        # int32[N] owner of each query
    slot_row: torch.Tensor    # int32[N] destination row (== dest)
    slot_col: torch.Tensor    # int32[N] position within the destination
    kept: torch.Tensor        # bool[N]  False -> overflowed capacity
    n_dropped: torch.Tensor   # int32[]  overflow count (reported)


def route_by_owner(owner: torch.Tensor, n_dest: int,
                   capacity: int) -> Routing:
    """Stable bucket-by-owner: queries keep their relative order within a
    destination.  An owner at or past ``n_dest`` (an embedding id past the
    table) is routed as the reference routes it: kept, at a negative
    column, so no buffer holds it."""
    owner = owner.to(torch.int32)
    n = owner.shape[0]
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order].long()
    counts = _counts(owner.long(), n_dest)[:n_dest]
    # the reference's take of a start past n_dest gives the int32 minimum
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=owner.device),
                        torch.cumsum(counts, 0)[:-1],
                        torch.tensor([INT32_MIN], device=owner.device)])
    pos_sorted = (torch.arange(n, device=owner.device)
                  - starts[sorted_owner.clamp(max=n_dest)])
    pos_sorted = _wrap_int32(pos_sorted)
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    kept = pos < capacity
    return Routing(dest=owner, slot_row=owner,
                   slot_col=torch.where(kept, pos, 0).to(torch.int32),
                   kept=kept,
                   n_dropped=(n - kept.sum()).to(torch.int32))


def _counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(keys, minlength=n)``; on the meta device (the dry-run),
    which has no data and no ``bincount``, a tensor of its static shape
    [n]."""
    if keys.device.type == "meta":
        return torch.empty(n, dtype=torch.int64, device=keys.device)
    return torch.bincount(keys, minlength=n)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 as the reference's int32 arithmetic
    wraps them."""
    return ((x - INT32_MIN) % (1 << 32) + INT32_MIN).to(torch.int32)


def scatter_to_buffers(r: Routing, xs: list, n_dest: int, capacity: int,
                       fill=0) -> list:
    """Each kept query's fields into [n_dest, capacity] send buffers; every
    other entry is ``fill``.  (The reference also writes zeros for the
    dropped queries at ``(owner, 0)``; see the module docstring.)  A kept
    query whose owner is past ``n_dest`` goes nowhere, as the reference's
    out-of-bounds write drops it."""
    meta = r.kept.device.type == "meta"
    if meta:          # no data to select by: every query's write is counted
        rows, cols = r.slot_row.long(), r.slot_col.long()
    else:
        keep = r.kept & (r.slot_row < n_dest)
        rows, cols = r.slot_row[keep].long(), r.slot_col[keep].long()
    out = []
    for x in xs:
        buf = torch.full((n_dest, capacity) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        buf[rows, cols] = x if meta else x[keep]
        out.append(buf)
    return out


def gather_from_buffers(r: Routing, bufs: list) -> list:
    """Inverse of ``scatter_to_buffers``: each query's entry read back, its
    row and column clamped into the buffer as the reference's gather
    clamps them."""
    out = []
    for b in bufs:
        rows = r.slot_row.long().clamp(0, b.shape[0] - 1)
        cols = r.slot_col.long().clamp(0, b.shape[1] - 1)
        out.append(b[rows, cols])
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def host_staged(group, device) -> bool:
    """True when the group's backend is gloo and the tensors lie on the
    card: each collective then moves host copies."""
    return torch.device(device).type == "cuda" \
        and dist.get_backend(group) == dist.Backend.GLOO


def exchange_route(group, device) -> str:
    """How this group's collectives move ``device`` tensors: ``nccl``,
    ``gloo`` or ``gloo staged through the host``."""
    backend = str(dist.get_backend(group))
    return f"{backend} staged through the host" \
        if host_staged(group, device) else backend


def _int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 and bool as int32 words for the collectives."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def _raw(x: torch.Tensor) -> torch.Tensor:
    """A tensor that a collective only moves, as words gloo carries: bf16
    as its bytes (uint8, two a value along the last axis: never rounded
    through fp32, and gloo takes no int16), uint32 as int32."""
    if x.dtype == torch.bfloat16:
        return x.contiguous().view(torch.uint8)
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row j of the result = row ``rank`` of what rank j sent (``x`` is
    [S, ...]): the reference's tiled ``all_to_all`` on axis 0.  Its bytes
    go to every open ``roofline.analysis.Tally``; under a dry one it is
    not run and returns an empty tensor of its result's shape."""
    if analysis.note_collective("all-to-all", x.numel() * x.element_size()):
        return torch.empty_like(x)
    staged = host_staged(group, x.device)
    send = _raw(x.cpu() if staged else x).contiguous()  # to the host
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.view(x.dtype)
    return recv.to(x.device) if staged else recv        # back to the card


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``all_gather``), moved as raw words; counted as
    ``all_to_all`` is (its result's bytes)."""
    n = group_size(group)
    shape = list(x.shape)
    shape[dim] *= n
    if analysis.note_collective("all-gather",
                                x.numel() * n * x.element_size()):
        return x.new_empty(shape)
    staged = host_staged(group, x.device)
    send = _raw(x.cpu() if staged else x).contiguous()  # to the host
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim).view(x.dtype)
    return out.to(x.device) if staged else out          # back to the card


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    staged = host_staged(group, x.device)
    out = x.cpu() if staged else x.clone()              # to the host
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device) if staged else out          # back to the card


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (counted as
    ``all_to_all`` is)."""
    if analysis.note_collective("all-reduce", x.numel() * x.element_size()):
        return torch.empty_like(x)
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``x``: the reference's
    ``pmax`` (counted as an all-reduce)."""
    if analysis.note_collective("all-reduce", x.numel() * x.element_size()):
        return torch.empty_like(x)
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def group_size(group) -> int:
    """The number of ranks in ``group`` (None: the default group, and 1 in
    a process outside any group: a world of one)."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# the two schemes, one rank's part
# ---------------------------------------------------------------------------
def _probe(table: _nl.TableGroup, q_hi, q_lo):
    found, p_hi, p_lo = ops.probe_table_group(table, q_hi, q_lo)
    return found.view(torch.int32) != 0, p_hi, p_lo


def lookup_replicated_body(group, table: _nl.TableGroup, q_hi: torch.Tensor,
                           q_lo: torch.Tensor, *, n_shards: int):
    """The whole batch on every rank: each answers the keys its shard owns,
    one all-reduce each merges the answers.  -> (found bool[N], p_hi,
    p_lo uint32[N]), the same on every rank."""
    mine = owner_of(q_hi, q_lo, n_shards) == dist.get_rank(group)
    found, p_hi, p_lo = _probe(table, q_hi, q_lo)
    found = found & mine
    # only the owner contributes a non-zero word, so the int32 sums are
    # exact and their bits the owner's uint32 words
    words = [torch.where(found, _int32(p), 0) for p in (p_hi, p_lo)]
    found = all_reduce_sum(found.to(torch.int32), group) > 0
    p_hi, p_lo = (all_reduce_sum(w, group).view(torch.uint32) for w in words)
    return found, p_hi, p_lo


def a2a_capacity(n_loc: int, n_shards: int, capacity_factor: float) -> int:
    """Per-destination capacity of a rank's send buffers."""
    return max(int(math.ceil(n_loc / n_shards * capacity_factor)), 1)


def lookup_a2a_body(group, table: _nl.TableGroup, q_hi: torch.Tensor,
                    q_lo: torch.Tensor, *, n_shards: int,
                    capacity_factor: float = 2.0):
    """The paper's routed batch query over this rank's slice of the batch
    [n_loc] -> (found bool, p_hi, p_lo uint32 [n_loc], n_dropped int32
    [1]).  A dropped query answers not found with zero payload."""
    n_loc = q_hi.shape[0]
    cap = a2a_capacity(n_loc, n_shards, capacity_factor)
    r = route_by_owner(owner_of(q_hi, q_lo, n_shards), n_shards, cap)
    sends = scatter_to_buffers(
        r, [_int32(q_hi), _int32(q_lo), r.kept.to(torch.int32)], n_shards,
        cap)
    # row j of recv = what rank j sent me
    recv_hi, recv_lo, recv_valid = (all_to_all(b, group) for b in sends)
    found, p_hi, p_lo = _probe(table, recv_hi.reshape(-1).view(torch.uint32),
                               recv_lo.reshape(-1).view(torch.uint32))
    found = found & (recv_valid.reshape(-1) > 0)
    answers = [all_to_all(x.reshape(n_shards, cap), group)
               for x in (found.to(torch.int32), _int32(p_hi), _int32(p_lo))]
    f, ph, pl = gather_from_buffers(r, answers)
    f = (f > 0) & r.kept
    return (f, torch.where(f, ph, 0).view(torch.uint32),
            torch.where(f, pl, 0).view(torch.uint32), r.n_dropped[None])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
SCHEMES = ("replicated", "a2a")


def make_distributed_lookup(group, st: ShardedTables, *, scheme: str = "a2a",
                            capacity_factor: float = 2.0,
                            device: Optional[torch.device] = None):
    """``fn(q_hi, q_lo)`` over this rank's shard of ``st`` (line-packed
    here, once) on ``device`` (default ``"cuda"``).  ``group`` (None: the
    default group) holds one shard a rank, so ``st.n_shards`` must equal
    its size.  ``replicated`` takes the whole batch and returns (found,
    p_hi, p_lo); ``a2a`` takes this rank's slice and also returns
    n_dropped [1].  Queries are uint32 tensors or arrays, moved to
    ``device``."""
    size = group_size(group)
    if st.n_shards != size:
        raise ValueError(f"n_shards={st.n_shards} != the group's size "
                         f"{size}")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    device = ops.resolve_device(device)
    table = st.shard_group(dist.get_rank(group), device)

    def fn(q_hi, q_lo):
        q_hi, q_lo = (_words_on(q, device) for q in (q_hi, q_lo))
        if scheme == "replicated":
            return lookup_replicated_body(group, table, q_hi, q_lo,
                                          n_shards=st.n_shards)
        return lookup_a2a_body(group, table, q_hi, q_lo,
                               n_shards=st.n_shards,
                               capacity_factor=capacity_factor)
    return fn


def _words_on(q, device) -> torch.Tensor:
    """uint32 words (array or tensor) as a contiguous uint32 tensor on
    ``device``."""
    if not isinstance(q, torch.Tensor):
        q = np.asarray(q).astype(np.uint32, copy=False)
    return _nl.int32_words(q).to(device).contiguous().view(torch.uint32)
