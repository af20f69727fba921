"""Dispatch for the port's kernels: the probe (and the RA gather it is
measured against, and its linear-probing and sequential baselines), the FM
term, the bag lookup and GraphSAGE's neighbour sum.

A CPU tensor takes the plain version (``kernels/ref.py``); a CUDA tensor
launches a kernel (``kernels/neighbor_lookup.py``, ``kernels/fused_fm.py``,
``kernels/embedding_bag.py``, ``kernels/segment_sum.py``) or raises — there
is no fallback from one to the other.  On the card the probe's batch is
padded to the block size and the outputs sliced back; the FM term and the
bag lookup carry their gradient kernels (the bag's with respect to its
table only: trained bag weights raise); the neighbour mean runs the
neighbour sum forward and, over the transposed CSR, backward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import fused_fm as _fm
from repro_torch.kernels import neighbor_lookup as _nl
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_sum as _seg

BLOCK_Q = 256
BAG_NO_GRADIENT = ("embedding_bag has no gradient with respect to its "
                   "weights on the card: its backward kernel differentiates "
                   "the table alone, and nothing in the JAX package trains "
                   "bag weights")


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when it
    names CUDA and no card is present, so nothing silently runs on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


def pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """uint32 [N] -> [N rounded up to mult], zero-filled."""
    rem = (-x.shape[0]) % mult
    if not rem:
        return x
    return torch.nn.functional.pad(x.view(torch.int32), (0, rem)) \
        .view(torch.uint32)


def probe_group(group: _nl.TableGroup, q_hi: torch.Tensor,
                q_lo: torch.Tensor, seg: Sequence[int]) -> torch.Tensor:
    """One grouped probe: table t of ``group`` answers ``q[seg[t]:seg[t+1]]``.
    Returns uint32 [3, N] (found, payload_hi, payload_lo).  On the card the
    group is staged in shared memory when it fits, else read from device
    memory."""
    if group.device.type == "cpu":
        return _ref.probe_group(group, q_hi, q_lo, seg)
    kernel = _nl.probe_smem if group.smem_bytes <= _nl.SMEM_LIMIT \
        else _nl.probe_lines
    n = q_hi.shape[0]
    return kernel(group, pad_to(q_hi, BLOCK_Q), pad_to(q_lo, BLOCK_Q),
                  seg)[:, :n]


def table_group(key_hi, key_lo, val_hi, val_lo, *, max_probes: int,
                home_capacity: Optional[int] = None, host_check: bool = True,
                next_idx=None, device) -> _nl.TableGroup:
    """One SoA table (numpy arrays or tensors) as a one-table group on
    ``device``, line-packed where the arrays lie: tensors already on
    ``device`` never pass through the host.  ``next_idx`` None follows the
    inline offsets."""
    return _nl.TableGroup([one_table(
        key_hi, key_lo, val_hi, val_lo, max_probes=max_probes,
        home_capacity=home_capacity, host_check=host_check,
        next_idx=next_idx, device=device)])


def one_table(key_hi, key_lo, val_hi, val_lo, *, max_probes: int,
              home_capacity: Optional[int] = None, host_check: bool = True,
              next_idx=None, capacity: Optional[int] = None,
              device) -> _nl.DeviceTable:
    """One SoA table (numpy arrays or tensors) line-packed as a
    ``DeviceTable`` on ``device`` (see ``table_group``); ``capacity``
    defaults to the arrays' length."""
    arrays = dict(key_hi=key_hi, key_lo=key_lo, val_hi=val_hi, val_lo=val_lo)
    if next_idx is not None:
        arrays["next_idx"] = next_idx
    capacity = capacity or key_hi.shape[0]
    return _nl.device_table(
        arrays, capacity=capacity, home_capacity=home_capacity or capacity,
        host_check=host_check, max_probes=max_probes,
        device=resolve_device(device))


def probe_table_group(group: _nl.TableGroup, q_hi, q_lo):
    """A one-table group's probe of (numpy or tensor) queries, moved to the
    group's device -> (found u32[N], payload_hi u32[N], payload_lo u32[N])."""
    q_hi, q_lo = (_query_words(q, group.device) for q in (q_hi, q_lo))
    out = probe_group(group, q_hi, q_lo, [0, q_hi.shape[0]])
    return out[0], out[1], out[2]


def _query_words(q, device) -> torch.Tensor:
    """uint32 queries (array or tensor) as a contiguous uint32 tensor on
    ``device``."""
    if not isinstance(q, torch.Tensor):
        q = np.asarray(q).astype(np.uint32, copy=False)
    return _nl.int32_words(q).to(device).contiguous().view(torch.uint32)


def neighbor_lookup(key_hi, key_lo, val_hi, val_lo, q_hi, q_lo, *,
                    max_probes: int, home_capacity: Optional[int] = None,
                    host_check: bool = True, next_idx=None, device=None):
    """Batched NeighborHash probe of one SoA table -> (found u32[N],
    payload_hi u32[N], payload_lo u32[N]) on ``device``: by default the
    device of ``q_hi`` when it is a tensor, else ``"cuda"``.  The table is
    line-packed for this one call; to probe a table many times, make its
    group once with ``table_group`` (``core/lookup.make_lookup_fn`` does).
    ``next_idx`` None follows the inline offsets."""
    group = table_group(key_hi, key_lo, val_hi, val_lo,
                        max_probes=max_probes, home_capacity=home_capacity,
                        host_check=host_check, next_idx=next_idx,
                        device=_query_device(q_hi, device))
    return probe_table_group(group, q_hi, q_lo)


def _query_device(q_hi, device):
    """The device a lookup runs on: ``device``, by default that of
    ``q_hi`` when it is a tensor, else ``"cuda"``."""
    if device is None and isinstance(q_hi, torch.Tensor):
        return q_hi.device
    return device


def probe_linear(table: _nl.DeviceTable, q_hi: torch.Tensor,
                 q_lo: torch.Tensor) -> torch.Tensor:
    """Linear probing of one line-packed table -> uint32 [3, N]: the plain
    version for a CPU table, the ``probe_linear`` kernel for a CUDA one."""
    if table.lines.device.type == "cpu":
        return _ref.probe_linear(table.lines, q_hi, q_lo,
                                 capacity=table.capacity,
                                 max_probes=table.max_probes)
    return _nl.probe_linear(table, q_hi, q_lo)


def probe_sequential(table: _nl.DeviceTable, q_hi: torch.Tensor,
                     q_lo: torch.Tensor) -> torch.Tensor:
    """The probe of one table, one query after another -> uint32 [3, N]:
    the plain version for a CPU table, the ``probe_sequential`` kernel for
    a CUDA one."""
    if table.lines.device.type == "cpu":
        return _ref.probe_sequential(
            table.lines, table.next_idx, q_hi, q_lo, capacity=table.capacity,
            home_capacity=table.home_capacity, host_check=table.host_check,
            max_probes=table.max_probes)
    return _nl.probe_sequential(table, q_hi, q_lo)


def linear_lookup(key_hi, key_lo, val_hi, val_lo, q_hi, q_lo, *,
                  capacity: int, max_probes: int, device=None):
    """Linear probing of one SoA table (no ``next_idx``: the probe sequence
    is the buckets that follow home) -> (found u32[N], payload_hi u32[N],
    payload_lo u32[N]) on ``device``, chosen as ``neighbor_lookup``
    chooses it."""
    device = _query_device(q_hi, device)
    table = one_table(key_hi, key_lo, val_hi, val_lo, max_probes=max_probes,
                      host_check=False, capacity=capacity, device=device)
    q_hi, q_lo = (_query_words(q, table.lines.device) for q in (q_hi, q_lo))
    out = probe_linear(table, q_hi, q_lo)
    return out[0], out[1], out[2]


def sequential_lookup(key_hi, key_lo, val_hi, val_lo, q_hi, q_lo, *,
                      max_probes: int, home_capacity: Optional[int] = None,
                      host_check: bool = True, next_idx=None, device=None):
    """``neighbor_lookup`` with the queries resolved one after another
    (the Fig. 9 baseline) -> (found, payload_hi, payload_lo) u32[N]."""
    device = _query_device(q_hi, device)
    table = one_table(key_hi, key_lo, val_hi, val_lo, max_probes=max_probes,
                      home_capacity=home_capacity, host_check=host_check,
                      next_idx=next_idx, device=device)
    q_hi, q_lo = (_query_words(q, table.lines.device) for q in (q_hi, q_lo))
    out = probe_sequential(table, q_hi, q_lo)
    return out[0], out[1], out[2]


def random_access(table: _nl.DeviceTable, q_hi: torch.Tensor,
                  q_lo: torch.Tensor):
    """The paper's RA gather over one line-packed table: (val_hi, val_lo)
    uint32 [N] of each key's home bucket, ``hash64 % capacity`` (the
    table's).  A CPU table takes ``core/lookup.random_access`` on its value
    words; a CUDA one the ``random_access`` kernel."""
    if table.lines.device.type == "cpu":
        from repro_torch.core import lookup     # it imports this module
        return lookup.random_access(*_nl.value_words(table), q_hi, q_lo,
                                    capacity=table.capacity)
    return _nl.random_access(table, q_hi, q_lo)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """FM second-order term of ``emb`` [B, F, D] -> fp32 [B]: the plain
    version for a CPU tensor (autograd differentiates it as it stands); for
    a CUDA one ``FusedFM``, the ``fused_fm`` kernel with the
    ``fused_fm_backward`` kernel as its gradient."""
    if emb.device.type == "cpu":
        return _ref.fused_fm(emb)
    return _fm.FusedFM.apply(emb)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """Bag lookup of ``indices`` [B, L] (negative = padding) in ``table``
    [V, D] -> fp32 [B, D] (``kernels/ref.embedding_bag`` says what it
    computes): the plain version for a CPU table (autograd differentiates
    it as it stands); for a CUDA one the ``embedding_bag`` kernel, through
    ``EmbeddingBag`` (its gradient the ``embedding_bag_backward`` kernel)
    where grad is enabled and the table requires it.  On the card, with
    grad enabled and weights that require it, this raises rather than
    return a result that autograd would not differentiate."""
    if table.device.type == "cpu":
        return _ref.embedding_bag(table, indices, weights, mode)
    if not torch.is_grad_enabled():
        return _bag.embedding_bag(table, indices, weights, mode=mode)
    if weights is not None and weights.requires_grad:
        raise NotImplementedError(BAG_NO_GRADIENT)
    if table.requires_grad:
        return _bag.EmbeddingBag.apply(table, indices, weights, mode)
    return _bag.embedding_bag(table, indices, weights, mode=mode)


def csr_sum(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
            deg: Optional[torch.Tensor] = None,
            marked: bool = False) -> torch.Tensor:
    """``out[r] = sum_{j in indptr[r]:indptr[r+1]} x[indices[j]]``, summed
    in ``j`` order, then ``/ deg[r]`` where ``deg`` is given
    (``kernels/ref.csr_sum`` says what it computes; the indices' hot marks
    and ``marked`` only tell the kernel which rows to keep in L2): the
    plain version for a CPU ``x``, the ``csr_sum`` kernel for a CUDA one."""
    if x.device.type == "cpu":
        return _ref.csr_sum(x, indptr, indices, deg, marked)
    return _seg.csr_sum(x, indptr, indices, deg, marked)


def neighbor_mean(h: torch.Tensor, adj: _seg.Adjacency) -> torch.Tensor:
    """Each node's mean of ``h`` [n, D] over its in-neighbours in ``adj``
    (``kernels/segment_sum.adjacency``), 0 for none, through
    ``NeighborMean``: ``csr_sum`` forward and, where ``h`` needs a
    gradient, backward over the transposed CSR."""
    return _seg.NeighborMean.apply(h, adj)
