"""Hopper kernel for GraphSAGE's neighbour sum, its ctypes wrapper, and the
neighbour mean built on it.

``csrc/segment_sum.cu`` replaces no TPU kernel: the JAX package computes
the mean aggregator in plain jnp, ``jnp.take(h, src)`` then
``jax.ops.segment_sum(msgs, dst) / deg`` (``models/gnn.py``), which ported
word for word builds an [E, D] message tensor a layer and sums by float
atomics.  ``csr_sum(x, indptr, indices)`` gathers and sums in one pass
instead: ``out[r] = sum_{j in indptr[r]:indptr[r+1]} x[indices[j]]``, fp32,
one warp a row walking its segment in ``j`` order, no atomics, so two
launches give the same bits and ``kernels/ref.csr_sum`` gives them too.

``Adjacency`` holds a graph's two CSRs, built once a graph on its device by
a stable sort (``adjacency``): by destination (each node's in-edges in
edge order, the order in which a sequential scatter adds) and by source
(the transpose, for the gradient), with ``deg`` = max(in-degree, 1) from
the first one's ``indptr``.  ``NeighborMean`` is the autograd ``Function``
``kernels/ops.neighbor_mean`` runs: forward ``csr_sum(h, indptr_dst,
src_by_dst) / deg``, backward ``csr_sum(g / deg, indptr_src,
dst_by_src)``, the same kernel over the transposed CSR; autograd skips the
backward where ``h`` needs no gradient (a layer's input features).

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
``csr_sum`` launches its kernel on CUDA tensors or raises; it never falls
back to the plain version, which ``kernels/ops.csr_sum`` picks for CPU
tensors.  ``launches`` counts the kernel's launches, ``paths`` its
branches (16-byte loads where D % 4 == 0 and the rows are aligned, else
one float a load).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from repro_torch.kernels import build as _build

launches = {"csr_sum": 0}
paths = {"vec": 0, "scalar": 0}        # which branch each launch took
WARPS = 8                              # kWarps in segment_sum.cu: rows a block
_GRID_ROWS = (2**31 - 1) * WARPS       # the launch's row limit
_lock = threading.Lock()               # the counts, from many threads


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_csr_sum.argtypes = [vp, i32, vp, vp, i64, vp, vp,
                                  ctypes.POINTER(i32)]
    lib.repro_csr_sum.restype = ctypes.c_int


def csr_sum(x: torch.Tensor, indptr: torch.Tensor,
            indices: torch.Tensor) -> torch.Tensor:
    """``x`` fp32 [N, D], ``indptr`` int64 [R + 1], ``indices`` int32
    [indptr[R]] (each in [0, N)), all contiguous on one card -> fp32
    [R, D] on the current stream.  Raises on anything else."""
    given = {"x": x, "indptr": indptr, "indices": indices}
    for name, t in given.items():
        if t.device.type != "cuda":
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
    if x.dim() != 2 or indptr.dim() != 1 or indices.dim() != 1 \
            or indptr.shape[0] < 1:
        raise ValueError(f"csr_sum takes x [N, D], indptr [R + 1] and "
                         f"indices [nnz]; got "
                         f"{[tuple(t.shape) for t in given.values()]}")
    n_rows, dim = indptr.shape[0] - 1, x.shape[1]
    if n_rows > _GRID_ROWS or dim > 2**31 - 1:
        raise ValueError(f"{n_rows} rows of width {dim} exceed the launch's "
                         "limits")
    out = torch.empty(n_rows, dim, dtype=torch.float32, device=x.device)
    if n_rows == 0 or dim == 0:
        return out
    lib = _build.library("segment_sum", _bind)
    vec = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_csr_sum(x.data_ptr(), dim, indptr.data_ptr(),
                                indices.data_ptr(), n_rows, out.data_ptr(),
                                stream, ctypes.byref(vec))
    if err != 0:
        raise RuntimeError(f"csr_sum launch failed: CUDA error {err}")
    with _lock:                       # launches may come from many threads
        launches["csr_sum"] += 1
        paths["vec" if vec.value else "scalar"] += 1
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


def _csr(keys: torch.Tensor, values: torch.Tensor,
         n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indptr int64 [n + 1], values int32 [E] grouped by key): a stable
    sort of ``keys``, so each group keeps the edges' order."""
    order = torch.sort(keys, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(keys, minlength=n), 0, out=indptr[1:])
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
    src), dst) / deg``; its gradient w.r.t. ``h`` is the same sum over the
    transposed CSR of ``g / deg``.  Both sums go through
    ``kernels/ops.csr_sum``: the kernel on a CUDA tensor, the plain
    version on a CPU one."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, adj: Adjacency) -> torch.Tensor:
        from repro_torch.kernels import ops     # it imports this module
        ctx.adj = adj
        return ops.csr_sum(h.contiguous(), adj.indptr_dst,
                           adj.src_by_dst) / adj.deg

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from repro_torch.kernels import ops
        adj = ctx.adj
        return ops.csr_sum((g / adj.deg).contiguous(), adj.indptr_src,
                           adj.dst_by_src), None
