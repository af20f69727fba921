"""Hopper kernel for EmbeddingBag, and its ctypes wrapper.

``csrc/embedding_bag.cu`` takes the place of the JAX package's Pallas
kernel ``kernels/embedding_bag.py::embedding_bag``: per bag of ``indices
[B, L]`` (int32, negative = padding) it gathers the rows of ``table [V, D]``
(fp32 or bf16), sums them times the optional fp32 ``weights [B, L]`` in
fp32, divides by the count of valid entries for ``mean``, and writes only
the fp32 ``[B, D]`` result: one block per bag, for any B, L and D, with
64-bit row offsets.  Where the rows are a multiple of 16 bytes (up to
3 KB) in a 16 B aligned table and every bag of the batch can be resident
at once, a bag's rows are staged in shared memory by asynchronous copies,
a stage of ``STAGE_ROWS`` entries at once in a ring of ``STAGES``; else
they come by loads into registers (the source's note says why).  ``paths``
counts the launches of each branch.

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
The wrapper launches the kernel on CUDA tensors or raises; it never falls
back to the plain version (``kernels/ref.embedding_bag``) —
``kernels/ops.py`` picks that for CPU tensors.  ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import build as _build

launches = {"embedding_bag": 0}
paths = {"staged": 0, "registers": 0}   # which branch each launch took
STAGE_ROWS = 32                         # kStageRows in embedding_bag.cu
STAGES = 2                              # kStages

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # dtype codes of the .cu
_MODES = {"sum": 0, "mean": 1}
_INT_MAX = 2**31 - 1                                 # the grid's x limit too

_lock = threading.Lock()
_resident: dict = {}          # (device, dtype, D, L) -> bags the staged
                              # branch holds at once there


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_embedding_bag.argtypes = [vp, i32, i64, i32, vp, vp, i64, i32,
                                        i32, vp, i64, vp, ctypes.POINTER(i32)]
    lib.repro_embedding_bag.restype = ctypes.c_int
    lib.repro_embedding_bag_resident.argtypes = [i32, i32, i32,
                                                 ctypes.POINTER(i64)]
    lib.repro_embedding_bag_resident.restype = ctypes.c_int


def _resident_bags(lib: ctypes.CDLL, table: torch.Tensor, n: int) -> int:
    """How many bags of ``n`` ids over ``table``'s rows the staged branch
    holds resident at once on its device; asked once per shape (the first
    ask also raises the branch's shared-memory limit there), so a launch
    queries nothing."""
    key = (table.device.index, table.dtype, table.shape[1], n)
    blocks = _resident.get(key)
    if blocks is None:
        with _lock:
            r = ctypes.c_longlong(0)
            with torch.cuda.device(table.device):
                err = lib.repro_embedding_bag_resident(
                    _DTYPES[table.dtype], table.shape[1], n, ctypes.byref(r))
            if err != 0:
                raise RuntimeError(f"embedding_bag_resident failed: CUDA "
                                   f"error {err}")
            blocks = _resident[key] = r.value
    return blocks


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """``table`` [V, D] (fp32 or bf16), ``indices`` int32 [B, L] and
    ``weights`` fp32 [B, L] or None, all contiguous on one card -> fp32
    [B, D] on the current stream.  Raises on anything else: a
    non-contiguous tensor or another dtype is the caller's to convert."""
    if mode not in _MODES:
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    given = {"table": table, "indices": indices}
    if weights is not None:
        given["weights"] = weights
    for name, t in given.items():
        if t.device.type != "cuda":
            raise ValueError(f"embedding_bag takes CUDA tensors ({name} is "
                             f"on {t.device}); CPU tensors go to "
                             "kernels/ref.py through kernels/ops.py")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"embedding_bag takes contiguous tensors; "
                             f"{name} has shape {tuple(t.shape)}, strides "
                             f"{t.stride()}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag takes a float32 or bfloat16 table, "
                        f"got {table.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag takes int32 indices, got "
                        f"{indices.dtype}")
    if weights is not None and weights.dtype != torch.float32:
        raise TypeError(f"embedding_bag takes float32 weights, got "
                        f"{weights.dtype}")
    if table.dim() != 2 or indices.dim() != 2 or (
            weights is not None and weights.shape != indices.shape):
        raise ValueError(f"embedding_bag takes table [V, D], indices "
                         f"[B, L] and weights [B, L] or None; got "
                         f"{[tuple(t.shape) for t in given.values()]}")
    (v, d), (b, n) = table.shape, indices.shape
    if max(b, n, d) > _INT_MAX:
        raise ValueError(f"indices {tuple(indices.shape)} or table width "
                         f"{d} exceed the launch's limits")
    out = torch.empty(b, d, dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    lib = _build.library("embedding_bag", _bind)
    resident = _resident_bags(lib, table, n)
    staged = ctypes.c_int(0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.repro_embedding_bag(
            table.data_ptr(), _DTYPES[table.dtype], v, d, indices.data_ptr(),
            None if weights is None else weights.data_ptr(), b, n,
            _MODES[mode], out.data_ptr(), resident, stream,
            ctypes.byref(staged))
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    with _lock:                       # launches may come from many threads
        launches["embedding_bag"] += 1
        paths["staged" if staged.value else "registers"] += 1
    return out
