"""Plain PyTorch versions of the probe kernels in ``neighbor_lookup.py``.

They take the same inputs as the kernels (line-packed tables, uint32
queries, query segments) and return the same uint32 ``[3, N]``.  The whole
batch advances one chain step per iteration under an active-lane mask, as
the JAX package's ``core/lookup.lookup`` does.  ``kernels/ops.py`` runs them
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernels against
them on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashcore as hc


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) tensor -> int64 of the same 32-bit values.  Only
    same-size views and int32 kernels: torch has few uint32 kernels (no
    gather on the card, no ``>>`` on the CPU)."""
    return x.view(torch.int32).long() & hc.MASK32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit values -> uint32 (wrapping through int32)."""
    return x.to(torch.int32).view(torch.uint32)


def probe_table(lines: torch.Tensor, next_idx: Optional[torch.Tensor],
                q_hi: torch.Tensor, q_lo: torch.Tensor, *, capacity: int,
                home_capacity: int, host_check: bool,
                max_probes: int) -> torch.Tensor:
    """Batched probe of one line-packed table (uint32 [n_lines, 4, BPL]) ->
    uint32 [3, N]: found, payload_hi (20 bits), payload_lo.  ``next_idx``
    None follows the inline offsets.  Reads clamp the bucket index into
    ``[0, capacity)``; the chain position itself is carried unclamped."""
    bpl = lines.shape[-1]
    flat = lines.reshape(-1).view(torch.int32)     # gathers move int32 words

    def read(idx: torch.Tensor, field: int) -> torch.Tensor:
        b = idx.clamp(0, capacity - 1)
        return u32(flat[(b // bpl) * (4 * bpl) + field * bpl + b % bpl])

    qh, ql = u32(q_hi), u32(q_lo)
    idx = hc.bucket_of_torch(qh, ql, home_capacity)
    khi, klo, vhi, vlo = (read(idx, f) for f in range(4))
    empty = (khi == hc.EMPTY_HI) & (klo == hc.EMPTY_LO)
    hit = (khi == qh) & (klo == ql) & ~empty
    active = ~empty & ~hit
    if host_check:
        active &= hc.bucket_of_torch(khi, klo, home_capacity) == idx
    found = hit
    p_hi = torch.where(hit, vhi & hc.PAYLOAD_HI_MASK, 0)
    p_lo = torch.where(hit, vlo, 0)
    for _ in range(max_probes):
        if not bool(active.any()):
            break
        if next_idx is None:
            off = hc.decode_offset_torch(vhi)
            has_next, nxt = off != 0, idx + off
        else:
            nxt = next_idx[idx.clamp(0, capacity - 1)].long()
            has_next = nxt >= 0
        active &= has_next
        idx = torch.where(active, nxt, idx)
        khi, klo, vhi, vlo = (read(idx, f) for f in range(4))
        hit = active & (khi == qh) & (klo == ql)
        found = found | hit
        p_hi = torch.where(hit, vhi & hc.PAYLOAD_HI_MASK, p_hi)
        p_lo = torch.where(hit, vlo, p_lo)
        active &= ~hit
    return as_u32(torch.stack([found.long(), p_hi, p_lo]))


def probe_group(group, q_hi: torch.Tensor, q_lo: torch.Tensor,
                seg: Sequence[int]) -> torch.Tensor:
    """Plain version of ``neighbor_lookup.probe_lines`` / ``probe_smem``:
    table t of ``group`` answers queries ``seg[t]:seg[t+1]``; lanes past
    ``seg[-1]`` come back zero."""
    out = torch.zeros((3, q_hi.shape[0]), dtype=torch.int32,
                      device=q_hi.device)
    for t, a, b in zip(group.tables, seg[:-1], seg[1:]):
        if b > a:
            out[:, a:b] = probe_table(
                t.lines, t.next_idx, q_hi[a:b], q_lo[a:b],
                capacity=t.capacity, home_capacity=t.home_capacity,
                host_check=t.host_check,
                max_probes=t.max_probes).view(torch.int32)
    return out.view(torch.uint32)
