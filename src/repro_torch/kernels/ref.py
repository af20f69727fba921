"""Plain PyTorch versions of the port's kernels.

* ``probe_table`` / ``probe_group``, of the probe kernels in
  ``neighbor_lookup.py``: they take the same inputs as the kernels
  (line-packed tables, uint32 queries, query segments) and return the same
  uint32 ``[3, N]``.  The whole batch advances one chain step per iteration
  under an active-lane mask, as the JAX package's ``core/lookup.lookup``
  does.
* ``fused_fm``, of the FM kernel in ``fused_fm.py``: the JAX package's
  ``kernels/ref.fused_fm``; ``fused_fm_backward``, of its gradient kernel
  (the JAX package has none: it differentiates that oracle).
* ``embedding_bag``, of the bag kernel in ``embedding_bag.py``: what the
  JAX package's Pallas kernel computes (fp32 accumulation and output).

``kernels/ops.py`` runs them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the card.
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


def _acc_dtype(emb: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for a float64 input (the gradient checks)."""
    return torch.promote_types(emb.dtype, torch.float32)


def fused_fm(emb: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_fm.fused_fm``: emb [B, F, D] -> fp32 [B],
    ``0.5 * sum_d[(sum_f x)^2 - sum_f x^2]``, accumulated in fp32 whatever
    the input dtype (a float64 input stays float64)."""
    x = emb.to(_acc_dtype(emb))
    s = x.sum(dim=1)                                   # [B, D]
    ss = (x * x).sum(dim=1)                            # [B, D]
    return 0.5 * (s * s - ss).sum(dim=-1)              # [B]


def fused_fm_backward(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_fm.fused_fm_backward``: the gradient of
    ``fused_fm`` at emb [B, F, D] given g [B], the gradient of its output,
    ``grad[b, f, d] = g[b] * (sum_f' x[b, f', d] - x[b, f, d])``, accumulated
    in fp32 (float64 stays float64) and returned in emb's dtype."""
    x = emb.to(_acc_dtype(emb))
    s = x.sum(dim=1, keepdim=True)                     # [B, 1, D]
    return (g.to(x.dtype)[:, None, None] * (s - x)).to(emb.dtype)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """Plain version of ``embedding_bag.embedding_bag``: table [V, D] (fp32
    or bf16), int indices [B, L] (negative = padding), optional weights
    [B, L] -> fp32 [B, D], accumulated in fp32.  ``sum`` is the weighted
    sum of the valid rows; ``mean`` divides it by the count of valid
    entries (at least 1), never by the sum of the weights.  A fully padded
    bag (or L = 0) gives zeros; an id >= V makes its whole bag NaN, as
    ``jnp.take``'s fill mode does in the JAX package's oracle.  The rows
    are gathered into a [B, L, D] intermediate."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    ids = indices.long()
    valid = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1)].to(torch.float32)
    mask = valid.to(torch.float32)
    if weights is not None:
        mask = mask * weights.to(torch.float32)
    out = (rows * mask[..., None]).sum(dim=1)                  # [B, D]
    if mode == "mean":
        out = out / valid.sum(dim=1).clamp(min=1)[:, None]
    return out.masked_fill((ids >= table.shape[0]).any(dim=1)[:, None],
                           float("nan"))
