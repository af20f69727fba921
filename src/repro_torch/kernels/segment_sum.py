"""Hopper kernel for GraphSAGE's neighbour sum, its ctypes wrapper, and the
neighbour mean built on it.

``csrc/segment_sum.cu`` replaces no TPU kernel: the JAX package computes
the mean aggregator in plain jnp, ``jnp.take(h, src)`` then
``jax.ops.segment_sum(msgs, dst) / deg`` (``models/gnn.py``), which ported
word for word builds an [E, D] message tensor a layer and sums by float
atomics.  ``csr_sum(x, indptr, indices, deg, marked)`` gathers and sums in
one pass instead: ``out[r] = sum_{j in indptr[r]:indptr[r+1]}
x[indices[j]]`` (``/ deg[r]`` where ``deg`` is given, rounded as torch's
fp32 ``/``), fp32, one warp a row walking its segment in ``j`` order, no
atomics, so two launches give the same bits and ``kernels/ref.csr_sum``
gives them too.

Hot rows.  An index with its sign bit set (``HOT_BIT``; the id is the low
31 bits, ``decode``) names a hot row; in a ``marked`` launch every other
term's row is read evict-first, so the rows of the sources of highest
out-degree, read again and again, stay in the card's L2 while the rest
streams past.  ``hot_sources`` picks the rows that fit the L2 (by
out-degree, then id), ``mark_hot`` sets their terms' sign bits in a copy of
the indices, ``l2_bytes`` is the budget: the card's whole L2, as torch
reports it (no persisting set-aside is reserved: on an H100 one slowed the
kernels that do not use it, ``scripts/l2_set_aside.py``).  The marks move
where a row is read from, never the sum's adds or their order.

``Adjacency`` holds a graph's two CSRs, built once a graph on its device by
a stable sort (``adjacency``): by destination (each node's in-edges in
edge order, the order in which a sequential scatter adds) and by source
(the transpose, for the gradient), with ``deg`` = max(in-degree, 1) from
the first one's ``indptr``; ``Adjacency.hot_marked`` caches the forward's
marked copy of ``src_by_dst`` once a row size (``row_bytes``).  ``NeighborMean`` is the
autograd ``Function`` ``kernels/ops.neighbor_mean`` runs: forward
``csr_sum(h, indptr_dst, src_by_dst marked, deg)`` (one launch), backward
``csr_sum(g / deg, indptr_src, dst_by_src)``, the same kernel over the
transposed CSR (no marks: its terms are the destinations, none hot);
autograd skips the backward where ``h`` needs no gradient (a layer's input
features).

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
``csr_sum`` launches its kernel on CUDA tensors or raises; it never falls
back to the plain version, which ``kernels/ops.csr_sum`` picks for CPU
tensors.  ``launches`` counts the kernel's launches, ``paths`` its
branches (16-byte loads where D % 4 == 0 and the rows are aligned, else
one float a load) and ``hot_launches`` the marked launches.  On the meta
device (the dry-run, ``launch/dryrun.py``) ``csr_sum`` launches nothing:
it returns an empty [R, D] tensor and reports its work (its term floor's
bytes, a row read a term, and an add a term and column) to the open dry
``roofline.analysis.Tally``; ``adjacency`` there gives CSRs of their
static sizes (n + 1 offsets, E terms).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.roofline import analysis

launches = {"csr_sum": 0}
paths = {"vec": 0, "scalar": 0}        # which branch each launch took
hot_launches = {"csr_sum": 0}          # launches with hot rows marked
WARPS = 8                              # kWarps in segment_sum.cu: rows a block
HOT_BIT = -2**31                       # an index's sign bit: its row is hot
LINE_BYTES = 128                       # an L2 line
_GRID_ROWS = (2**31 - 1) * WARPS       # the launch's row limit
_lock = threading.Lock()               # the counts, from many threads


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_csr_sum.argtypes = [vp, i32, vp, vp, i64, vp, i32, vp, vp,
                                  ctypes.POINTER(i32)]
    lib.repro_csr_sum.restype = ctypes.c_int


def l2_bytes(device: torch.device) -> int:
    """The L2's bytes of the card ``device``: the hot rows' budget."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def row_bytes(dim: int) -> int:
    """The L2 bytes a row of ``dim`` fp32 takes: its 128 B lines."""
    return -(-dim * 4 // LINE_BYTES) * LINE_BYTES


def hot_sources(indptr_src: torch.Tensor, dim: int,
                budget: int) -> torch.Tensor:
    """The rows worth holding in ``budget`` bytes of L2 for a sum over
    rows of ``dim`` fp32 whose terms' sources have the out-degrees of the
    CSR ``indptr_src`` (int64 [n + 1]) -> int32 ids: by out-degree,
    descending, ties by ascending id, as many as ``budget`` holds at
    ``row_bytes(dim)`` a row; only sources of two terms or more (a row
    read once gains nothing), and none where all n rows fit the budget
    (the L2 keeps them without marks)."""
    n = indptr_src.shape[0] - 1
    take = min(budget // row_bytes(dim), n)
    if n * row_bytes(dim) <= budget or take <= 0:
        return torch.zeros(0, dtype=torch.int32, device=indptr_src.device)
    out_deg = indptr_src[1:] - indptr_src[:-1]
    order = torch.sort(out_deg, descending=True, stable=True).indices[:take]
    return order[out_deg[order] >= 2].to(torch.int32)


def mark_hot(indices: torch.Tensor, hot: torch.Tensor,
             n: int) -> torch.Tensor:
    """A copy of ``indices`` (int32 ids in [0, n)) with ``HOT_BIT`` set on
    every term whose id is in ``hot``."""
    is_hot = torch.zeros(n, dtype=torch.bool, device=indices.device)
    is_hot[hot.long()] = True
    return torch.where(is_hot[indices.long()], indices | HOT_BIT, indices)


def decode(indices: torch.Tensor) -> torch.Tensor:
    """The ids of (possibly marked) int32 ``indices``: ``HOT_BIT`` off."""
    return indices & 0x7FFFFFFF


def csr_sum(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
            deg: Optional[torch.Tensor] = None,
            marked: bool = False) -> torch.Tensor:
    """``x`` fp32 [N, D], ``indptr`` int64 [R + 1], ``indices`` int32
    [indptr[R]] (each id in [0, N), ``HOT_BIT`` set where its row is hot),
    ``deg`` fp32 [R] or [R, 1] (the sums are divided by it) or None, all
    contiguous on one card; ``marked``: the indices carry hot marks (the
    other rows are read evict-first) -> fp32 [R, D] on the current stream.
    Raises on anything else."""
    given = {"x": x, "indptr": indptr, "indices": indices}
    if deg is not None:
        given["deg"] = deg
    for name, t in given.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"csr_sum takes CUDA tensors ({name} is on "
                             f"{t.device}); CPU tensors go to kernels/ref.py "
                             "through kernels/ops.py")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"csr_sum takes contiguous tensors; {name} has "
                             f"shape {tuple(t.shape)}, strides {t.stride()}")
    if x.dtype != torch.float32:
        raise TypeError(f"csr_sum takes float32 rows, got {x.dtype}")
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
        raise TypeError(f"csr_sum takes int64 indptr and int32 indices, got "
                        f"{indptr.dtype} and {indices.dtype}")
    if deg is not None and deg.dtype != torch.float32:
        raise TypeError(f"csr_sum takes float32 deg, got {deg.dtype}")
    if x.dim() != 2 or indptr.dim() != 1 or indices.dim() != 1 \
            or indptr.shape[0] < 1 \
            or (deg is not None and deg.numel() != indptr.shape[0] - 1):
        raise ValueError(f"csr_sum takes x [N, D], indptr [R + 1], indices "
                         f"[nnz] and deg [R]; got "
                         f"{[tuple(t.shape) for t in given.values()]}")
    n_rows, dim = indptr.shape[0] - 1, x.shape[1]
    if n_rows > _GRID_ROWS or dim > 2**31 - 1:
        raise ValueError(f"{n_rows} rows of width {dim} exceed the launch's "
                         "limits")
    out = torch.empty(n_rows, dim, dtype=torch.float32, device=x.device)
    if x.device.type == "meta":             # the dry-run: the work, no data
        nnz = indices.numel()               # every term's row read (no ids)
        analysis.note_kernel("csr_sum", nnz * dim,
                             nnz * dim * 4 + nnz * 4 + indptr.numel() * 8
                             + n_rows * dim * 4)
        return out
    if n_rows == 0 or dim == 0:
        return out
    lib = _build.library("segment_sum", _bind)
    vec = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_csr_sum(
            x.data_ptr(), dim, indptr.data_ptr(), indices.data_ptr(), n_rows,
            None if deg is None else deg.data_ptr(), int(marked),
            out.data_ptr(), stream, ctypes.byref(vec))
    if err != 0:
        raise RuntimeError(f"csr_sum launch failed: CUDA error {err}")
    with _lock:                       # launches may come from many threads
        launches["csr_sum"] += 1
        paths["vec" if vec.value else "scalar"] += 1
        hot_launches["csr_sum"] += int(marked)
    return out


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """A graph of ``n_nodes`` nodes as two CSRs on one device: its edges by
    destination (``indptr_dst`` int64 [n + 1], ``src_by_dst`` int32 [E])
    and by source (``indptr_src``, ``dst_by_src``), each segment in edge
    order; ``deg`` fp32 [n, 1], each node's in-degree, at least 1."""
    n_nodes: int
    indptr_dst: torch.Tensor
    src_by_dst: torch.Tensor
    indptr_src: torch.Tensor
    dst_by_src: torch.Tensor
    deg: torch.Tensor
    _hot: dict = dataclasses.field(default_factory=dict, init=False,
                                   repr=False, compare=False)

    def hot_marked(self, dim: int, budget: int
                   ) -> tuple[torch.Tensor, bool]:
        """(``src_by_dst`` with the terms of ``hot_sources(indptr_src,
        dim, budget)`` marked, whether any are), made at the first call of
        a row size and budget and kept (0.25 GB at ogbn-products' 61.9M
        edges); widths of one ``row_bytes`` (100 and 128) share it."""
        key = (row_bytes(dim), budget)
        if key not in self._hot:
            hot = hot_sources(self.indptr_src, dim, budget)
            self._hot[key] = (mark_hot(self.src_by_dst, hot, self.n_nodes),
                              True) if hot.numel() else (self.src_by_dst,
                                                         False)
        return self._hot[key]


def _csr(keys: torch.Tensor, values: torch.Tensor,
         n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indptr int64 [n + 1], values int32 [E] grouped by key): a stable
    sort of ``keys``, so each group keeps the edges' order."""
    order = torch.sort(keys, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    counts = torch.empty(n, dtype=torch.int64, device=keys.device) \
        if keys.device.type == "meta" else torch.bincount(keys, minlength=n)
    torch.cumsum(counts, 0, out=indptr[1:])    # meta: no data, no bincount
    return indptr, values[order].to(torch.int32)


def adjacency(src: torch.Tensor, dst: torch.Tensor,
              n_nodes: int) -> Adjacency:
    """The ``Adjacency`` of the edges ``src[e] -> dst[e]`` (int tensors of
    ids in [0, n_nodes), on the device the CSRs go to), built there once a
    graph."""
    src, dst = src.long(), dst.long()
    indptr_dst, src_by_dst = _csr(dst, src, n_nodes)
    indptr_src, dst_by_src = _csr(src, dst, n_nodes)
    deg = (indptr_dst[1:] - indptr_dst[:-1]).clamp(min=1).to(
        torch.float32)[:, None]
    return Adjacency(n_nodes, indptr_dst, src_by_dst, indptr_src, dst_by_src,
                     deg)


class NeighborMean(torch.autograd.Function):
    """``(h [n, D], adj) -> [n, D]``: each node's mean of ``h`` over its
    in-neighbours (0 for none), as the JAX package's ``segment_sum(take(h,
    src), dst) / deg``, the division in the sum's launch; its gradient
    w.r.t. ``h`` is the same sum over the transposed CSR of ``g / deg``.
    Both sums go through ``kernels/ops.csr_sum``: the kernel on a CUDA
    tensor (the forward's hottest sources marked to stay in the card's
    L2), the plain version on a CPU one."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, adj: Adjacency) -> torch.Tensor:
        from repro_torch.kernels import ops     # it imports this module
        ctx.adj = adj
        indices, marked = adj.src_by_dst, False
        if h.device.type == "cuda":
            indices, marked = adj.hot_marked(h.shape[1], l2_bytes(h.device))
        return ops.csr_sum(h.contiguous(), adj.indptr_dst, indices, adj.deg,
                           marked)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from repro_torch.kernels import ops
        adj = ctx.adj
        return ops.csr_sum((g / adj.deg).contiguous(), adj.indptr_src,
                           adj.dst_by_src), None
