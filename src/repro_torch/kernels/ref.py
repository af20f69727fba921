"""Plain PyTorch versions of the port's kernels.

* ``probe_table`` / ``probe_group``, of the probe kernels in
  ``neighbor_lookup.py``: they take the same inputs as the kernels
  (line-packed tables, uint32 queries, query segments) and return the same
  uint32 ``[3, N]``.  The whole batch advances one chain step per iteration
  under an active-lane mask, as the JAX package's ``core/lookup.lookup``
  does.  ``probe_linear``, of the linear-probing kernel (the JAX package's
  ``core/lookup.lookup_linear``), and ``probe_sequential``, of the
  sequential one (``probe_table`` one query at a time, as the JAX
  package's ``lookup_sequential`` maps its one-query lookups).
  ``load_chain``, of the load-latency yardstick: a chain of line indices
  followed one hop at a time.
* ``fused_fm``, of the FM kernel in ``fused_fm.py``: the JAX package's
  ``kernels/ref.fused_fm``; ``fused_fm_backward``, of its gradient kernel
  (the JAX package has none: it differentiates that oracle).
* ``embedding_bag``, of the bag kernel in ``embedding_bag.py``: what the
  JAX package's Pallas kernel computes (fp32 accumulation and output);
  ``embedding_bag_backward``, of its gradient kernel with respect to the
  table (the JAX package differentiates its oracle), and
  ``embedding_bag_backward_terms``, what bounds any order's rounding;
  ``embedding_bag_backward_ordered``, the same gradient summed in exactly
  the kernel's order (the plan that the kernel's wrapper makes, from
  ``kernels/embedding_bag.py``).
* ``csr_sum``, of the neighbour-sum kernel in ``segment_sum.py``: each
  row's CSR segment of rows of x summed in order (the JAX package has no
  kernel: GraphSAGE's ``segment_sum`` is plain jnp).

``kernels/ops.py`` runs them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashcore as hc
from repro_torch.kernels import segment_sum as seg


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) tensor -> int64 of the same 32-bit values.  Only
    same-size views and int32 kernels: torch has few uint32 kernels (no
    gather on the card, no ``>>`` on the CPU)."""
    return x.view(torch.int32).long() & hc.MASK32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit values -> uint32 (wrapping through int32)."""
    return x.to(torch.int32).view(torch.uint32)


def _reader(lines: torch.Tensor, capacity: int):
    """read(idx, field) -> int64 word ``field`` (key_hi, key_lo, val_hi,
    val_lo) of buckets ``idx`` of a line-packed table (uint32 [n_lines, 4,
    BPL]), each index clamped into ``[0, capacity)``."""
    bpl = lines.shape[-1]
    flat = lines.reshape(-1).view(torch.int32)     # gathers move int32 words

    def read(idx: torch.Tensor, field: int) -> torch.Tensor:
        b = idx.clamp(0, capacity - 1)
        return u32(flat[(b // bpl) * (4 * bpl) + field * bpl + b % bpl])
    return read


def probe_table(lines: torch.Tensor, next_idx: Optional[torch.Tensor],
                q_hi: torch.Tensor, q_lo: torch.Tensor, *, capacity: int,
                home_capacity: int, host_check: bool,
                max_probes: int) -> torch.Tensor:
    """Batched probe of one line-packed table (uint32 [n_lines, 4, BPL]) ->
    uint32 [3, N]: found, payload_hi (20 bits), payload_lo.  ``next_idx``
    None follows the inline offsets.  Reads clamp the bucket index into
    ``[0, capacity)``; the chain position itself is carried unclamped."""
    read = _reader(lines, capacity)
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


def probe_linear(lines: torch.Tensor, q_hi: torch.Tensor,
                 q_lo: torch.Tensor, *, capacity: int,
                 max_probes: int) -> torch.Tensor:
    """Plain version of ``neighbor_lookup.probe_linear``: linear probing of
    one line-packed table -> uint32 [3, N] (found, payload_hi, payload_lo).
    Home ``hash64 % capacity``; each active query steps to ``(idx + 1) %
    capacity`` until a hit, an empty bucket, or ``max_probes`` steps past
    home, the whole batch one step per iteration as the JAX package's
    ``lookup_linear`` does."""
    read = _reader(lines, capacity)
    qh, ql = u32(q_hi), u32(q_lo)
    idx = hc.bucket_of_torch(qh, ql, capacity)
    khi, klo, vhi, vlo = (read(idx, f) for f in range(4))
    empty = (khi == hc.EMPTY_HI) & (klo == hc.EMPTY_LO)
    hit = (khi == qh) & (klo == ql) & ~empty
    found = hit
    p_hi = torch.where(hit, vhi & hc.PAYLOAD_HI_MASK, 0)
    p_lo = torch.where(hit, vlo, 0)
    active = ~empty & ~hit
    for _ in range(max_probes):
        if not bool(active.any()):
            break
        idx = torch.where(active, (idx + 1) % capacity, idx)
        khi, klo, vhi, vlo = (read(idx, f) for f in range(4))
        empty = (khi == hc.EMPTY_HI) & (klo == hc.EMPTY_LO)
        hit = active & (khi == qh) & (klo == ql) & ~empty
        found = found | hit
        p_hi = torch.where(hit, vhi & hc.PAYLOAD_HI_MASK, p_hi)
        p_lo = torch.where(hit, vlo, p_lo)
        active &= ~hit & ~empty
    return as_u32(torch.stack([found.long(), p_hi, p_lo]))


def probe_sequential(lines: torch.Tensor, next_idx: Optional[torch.Tensor],
                     q_hi: torch.Tensor, q_lo: torch.Tensor, *,
                     capacity: int, home_capacity: int, host_check: bool,
                     max_probes: int) -> torch.Tensor:
    """Plain version of ``neighbor_lookup.probe_sequential``: ``probe_table``
    called on one query at a time -> uint32 [3, N]."""
    out = torch.zeros((3, q_hi.shape[0]), dtype=torch.int32,
                      device=q_hi.device)
    for i in range(q_hi.shape[0]):
        out[:, i:i + 1] = probe_table(
            lines, next_idx, q_hi[i:i + 1], q_lo[i:i + 1], capacity=capacity,
            home_capacity=home_capacity, host_check=host_check,
            max_probes=max_probes).view(torch.int32)
    return out.view(torch.uint32)


def load_chain(words: torch.Tensor, start: int, steps: int) -> torch.Tensor:
    """Plain version of ``neighbor_lookup.load_chain``: ``steps`` hops from
    line ``start`` of int32 [n_lines, 32], each to the line that word 0 of
    the current one names (read as unsigned, past the last line clipped to
    it) -> int64 [1], the line reached."""
    last = words.shape[0] - 1
    heads = [min(h & 0xFFFFFFFF, last) for h in words[:, 0].tolist()]
    line = start
    for _ in range(steps):
        line = heads[line]
    return torch.tensor([line], dtype=torch.int64, device=words.device)


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
    [B, L] -> fp32 [B, D], accumulated in fp32 (a float64 table stays
    float64).  ``sum`` is the weighted sum of the valid rows; ``mean``
    divides it by the count of valid entries (at least 1), never by the
    sum of the weights.  A fully padded
    bag (or L = 0) gives zeros; an id >= V makes its whole bag NaN, as
    ``jnp.take``'s fill mode does in the JAX package's oracle.  The rows
    are gathered into a [B, L, D] intermediate."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    acc = _acc_dtype(table)              # fp32 (float64 for gradcheck)
    ids = indices.long()
    valid = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1)].to(acc)
    mask = valid.to(acc)
    if weights is not None:
        mask = mask * weights.to(acc)
    out = (rows * mask[..., None]).sum(dim=1)                  # [B, D]
    if mode == "mean":
        out = out / valid.sum(dim=1).clamp(min=1)[:, None]
    return out.masked_fill((ids >= table.shape[0]).any(dim=1)[:, None],
                           float("nan"))


def _bag_terms(g: torch.Tensor, indices: torch.Tensor,
               weights: Optional[torch.Tensor], mode: str, n_rows: int):
    """(rows, terms): the table row and the gradient term ``(g[b] /
    denom[b]) * w[b, j]`` of each entry (b, j) whose id lies in ``[0,
    n_rows)``, in the order the JAX package's transpose rounds them."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    ids = indices.long()
    valid = ids >= 0
    scale = g
    if mode == "mean":
        scale = g / valid.sum(dim=1).clamp(min=1).to(g.dtype)[:, None]
    b, j = torch.nonzero(valid & (ids < n_rows), as_tuple=True)
    terms = scale[b]
    if weights is not None:
        terms = terms * weights.to(g.dtype)[b, j][:, None]
    return ids[b, j], terms


def embedding_bag_backward(g: torch.Tensor, indices: torch.Tensor,
                           weights: Optional[torch.Tensor], mode: str,
                           n_rows: int) -> torch.Tensor:
    """Plain version of ``embedding_bag.embedding_bag_backward``: the
    gradient of ``embedding_bag`` with respect to its [n_rows, D] table,
    given ``g`` [B, D] (the gradient of its output) and constant
    ``weights``, -> [n_rows, D] in g's dtype: ``grad[id] += (g[b] /
    denom[b]) * w[b, j]`` for each entry with ``0 <= id < n_rows`` (denom
    the count of entries with id >= 0, at least 1, for ``mean``; 1 for
    ``sum``).  An id past the table counts in the denominator and adds
    nothing, as the transpose of ``jnp.take`` drops it.  Dense, as the JAX
    gradient is; the terms are added by ``index_add_``."""
    rows, terms = _bag_terms(g, indices, weights, mode, n_rows)
    out = torch.zeros(n_rows, g.shape[1], dtype=g.dtype, device=g.device)
    return out.index_add_(0, rows, terms)


def embedding_bag_backward_terms(g: torch.Tensor, indices: torch.Tensor,
                                 weights: Optional[torch.Tensor], mode: str,
                                 n_rows: int):
    """(S [n_rows, D], n [n_rows]) of ``embedding_bag_backward`` on the same
    inputs: S the sum of its terms' magnitudes (the same function on |g|
    and |w|), n how many terms each row adds.  Two sums of the same n terms
    in any order differ by at most ``2 * n * 2**-24 * S`` in fp32
    (recursive summation's error bound, Higham), so that bounds the
    kernel's order against the plain version's."""
    rows, terms = _bag_terms(g.abs(), indices,
                             None if weights is None else weights.abs(),
                             mode, n_rows)
    s = torch.zeros(n_rows, g.shape[1], dtype=g.dtype, device=g.device)
    return s.index_add_(0, rows, terms), torch.bincount(rows,
                                                        minlength=n_rows)


def embedding_bag_backward_ordered(g: torch.Tensor, indices: torch.Tensor,
                                   weights: Optional[torch.Tensor],
                                   mode: str, n_rows: int,
                                   chunk: Optional[int] = None
                                   ) -> torch.Tensor:
    """``embedding_bag_backward`` summed in the kernel's order, the plan of
    ``kernels/embedding_bag.embedding_bag_backward_plan`` (chunks of
    ``chunk`` terms, by default the kernel's ``BAG_CHUNK``): each chunk's
    items added left to
    right from +0.0 (``chunk`` vectorised adds, a chunk's missing items
    adding +0.0, which leaves a sum from +0.0 as it is), level by level,
    each row's last value written once.  The terms are rounded as
    ``embedding_bag_backward`` rounds them, so on the card the kernel's
    result equals this one bit for bit."""
    from repro_torch.kernels import embedding_bag as bag  # it imports this
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    chunk = bag.BAG_CHUNK if chunk is None else chunk
    plan = bag.embedding_bag_backward_plan(
        *bag.embedding_bag_backward_sort(indices, n_rows), n_rows, chunk)
    scale = g
    if mode == "mean":
        scale = g / (indices >= 0).sum(dim=1).clamp(min=1).to(g.dtype)[:, None]
    bag_len = max(indices.shape[1], 1)

    def terms(pos: torch.Tensor) -> torch.Tensor:    # level 0's items
        e = plan.perm[pos]
        x = scale[e // bag_len]
        if weights is not None:
            x = x * weights.reshape(-1).to(g.dtype)[e][:, None]
        return x

    read = terms
    out = torch.zeros(n_rows, g.shape[1], dtype=g.dtype, device=g.device)
    for level in plan.levels:
        start, length, dest = bag.level_chunks(plan, level, chunk)
        acc = torch.zeros(level.n_chunks, g.shape[1], dtype=g.dtype,
                          device=g.device)
        for t in range(chunk):
            live = length > t
            acc = acc + torch.where(live[:, None],
                                    read(torch.where(live, start + t, 0)),
                                    0.0)
        last = dest >= 0
        out[dest[last]] = acc[last]
        partial = torch.empty(level.n_partials, g.shape[1], dtype=g.dtype,
                              device=g.device)
        partial[-1 - dest[~last]] = acc[~last]
        read = partial.__getitem__
    return out


def csr_sum(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
            deg: Optional[torch.Tensor] = None,
            marked: bool = False) -> torch.Tensor:
    """Plain version of ``segment_sum.csr_sum``: ``out[r] = sum_{j in
    indptr[r]:indptr[r+1]} x[indices[j]]`` -> [R, D] in x's dtype (fp32;
    float64 stays float64 for the gradient checks), R = ``len(indptr) -
    1``, each segment summed from +0.0 in ``j`` order (an empty one gives
    0): the t-th term of every segment still that long is added at step t,
    so the adds are the kernel's, in its order.  Then ``out / deg`` where
    ``deg`` ([R, 1] or [R]) is given, as the kernel divides.  An index's
    sign bit (the kernel's hot mark) is ignored and so is ``marked``: they
    tell the kernel which rows to keep in L2, not what to sum.  No [nnz, D]
    intermediate."""
    n_rows = indptr.shape[0] - 1
    out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    if n_rows > 0:
        start, length = indptr[:-1], indptr[1:] - indptr[:-1]
        # rows by length, descending: the rows still live at step t are a
        # prefix of this order
        length, rows = torch.sort(length, descending=True, stable=True)
        live = torch.searchsorted(-length, -torch.arange(
            int(length[0]), device=x.device)).tolist()
        for t, n in enumerate(live):
            r = rows[:n]
            out[r] = out[r] + x[seg.decode(indices[start[r] + t]).long()]
    if deg is not None:
        out = out / deg.reshape(n_rows, 1)
    return out
