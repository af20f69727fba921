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

``embedding_bag_backward`` launches the same library's gradient kernels:
the table's fp32 [V, D] gradient for constant weights, summed in one
fixed order with no atomics, so every run gives the same bits.  Its plan
(``embedding_bag_backward_sort`` and ``_plan``: a stable sort of the
entries by id, each id's run cut into chunks of ``BAG_CHUNK`` terms,
levels of chunks over the partial sums) is plain torch, made on a
high-priority stream of its own: after the sort, the caller's stream
zeroes the gradient while the plan is made, and the levels then follow
the zeros there, a group of lanes a chunk, writing each touched row's
sum once over its zeros.
``ref.embedding_bag_backward_ordered`` is the plain version of exactly
that order.  ``EmbeddingBag`` is the
autograd ``Function`` that ``kernels/ops.py`` runs on a CUDA table that
requires grad: its forward launches ``embedding_bag``, its backward
``embedding_bag_backward``.

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
The wrappers launch their kernels on CUDA tensors or raise; they never
fall back to the plain versions (``kernels/ref.embedding_bag``,
``ref.embedding_bag_backward``) — ``kernels/ops.py`` picks those for CPU
tensors, and ``EmbeddingBag`` takes them for a CPU table only.
``launches`` counts each kernel's launches.  On the meta device (the
dry-run, ``launch/dryrun.py``) a wrapper launches nothing: it returns an
empty tensor of its output's shape and reports its work to the open dry
``roofline.analysis.Tally`` (its bound's bytes and operations, every
entry taken as valid and its row as read: there are no ids to count).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.roofline import analysis

launches = {"embedding_bag": 0, "embedding_bag_backward": 0}
paths = {"staged": 0, "registers": 0}   # which branch each launch took
STAGE_ROWS = 32                         # kStageRows in embedding_bag.cu
STAGES = 2                              # kStages
BAG_CHUNK = 32                          # the gradient's terms a chunk: kChunk

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # dtype codes of the .cu
_MODES = {"sum": 0, "mean": 1}
_INT_MAX = 2**31 - 1                                 # the grid's x limit too

_lock = threading.Lock()
_resident: dict = {}          # (device, dtype, D, L) -> bags the staged
                              # branch holds at once there
_plan_streams: dict = {}      # device index -> the gradient plan's stream


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_embedding_bag.argtypes = [vp, i32, i64, i32, vp, vp, i64, i32,
                                        i32, vp, i64, vp, ctypes.POINTER(i32)]
    lib.repro_embedding_bag.restype = ctypes.c_int
    lib.repro_embedding_bag_resident.argtypes = [i32, i32, i32,
                                                 ctypes.POINTER(i64)]
    lib.repro_embedding_bag_resident.restype = ctypes.c_int
    lib.repro_embedding_bag_backward_scale.argtypes = [vp, vp, i64, i32, i32,
                                                       vp, vp]
    lib.repro_embedding_bag_backward_level.argtypes = [
        vp, i32, vp, i64, vp, vp, vp, vp, vp, vp, i64, i64, vp, i64, i64, vp,
        vp, vp]
    for step in ("scale", "level"):
        getattr(lib, f"repro_embedding_bag_backward_{step}").restype = \
            ctypes.c_int


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
        if t.device.type not in ("cuda", "meta"):
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
    if table.device.type == "meta":         # the dry-run: the work, no data
        analysis.note_kernel(
            "embedding_bag", 2 * b * n * d,
            b * n * d * table.element_size() + indices.numel() * 4
            + (0 if weights is None else weights.numel() * 4) + b * d * 4)
        return out
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


def embedding_bag_backward(g: torch.Tensor, indices: torch.Tensor,
                           weights: Optional[torch.Tensor], mode: str,
                           n_rows: int) -> torch.Tensor:
    """The gradient of ``embedding_bag`` with respect to its [n_rows, D]
    table, for constant ``weights``: ``g`` fp32 [B, D] (the gradient of its
    output), ``indices`` int32 [B, L] and ``weights`` fp32 [B, L] or None,
    all contiguous on one card -> fp32 [n_rows, D] on the current stream
    (``kernels/ref.embedding_bag_backward`` says what it computes;
    ``ref.embedding_bag_backward_ordered`` gives the same bits).  The sort
    runs on a stream of its own; then the current stream zeroes the
    gradient while the plan is made there (it waits for that stream to
    learn its sizes), and the levels follow the zeros on the current
    stream.  Raises on anything else."""
    if mode not in _MODES:
        raise ValueError(f"mode must be sum|mean, got {mode!r}")
    given = {"g": g, "indices": indices}
    if weights is not None:
        given["weights"] = weights
    for name, t in given.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"embedding_bag_backward takes CUDA tensors "
                             f"({name} is on {t.device}); CPU tensors go "
                             "to kernels/ref.py through EmbeddingBag")
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"embedding_bag_backward takes contiguous "
                             f"tensors; {name} has shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")
        want = torch.int32 if name == "indices" else torch.float32
        if t.dtype != want:
            raise TypeError(f"embedding_bag_backward takes {want} {name}, "
                            f"got {t.dtype}")
    if g.dim() != 2 or indices.dim() != 2 or \
            g.shape[0] != indices.shape[0] or (
                weights is not None and weights.shape != indices.shape):
        raise ValueError(f"embedding_bag_backward takes g [B, D], indices "
                         f"[B, L] and weights [B, L] or None; got "
                         f"{[tuple(t.shape) for t in given.values()]}")
    (b, d), n = g.shape, indices.shape[1]
    if max(b, n, d, n_rows) > _INT_MAX or n_rows < 0:
        raise ValueError(f"g {tuple(g.shape)}, indices "
                         f"{tuple(indices.shape)} or {n_rows} rows exceed "
                         "the launch's limits")
    if g.device.type == "meta":
        analysis.note_kernel(
            "embedding_bag_backward", b * n * d,
            indices.numel() * 4 * (1 if weights is None else 2) + b * d * 4
            + n_rows * d * 4)
        return torch.empty(n_rows, d, dtype=torch.float32, device=g.device)
    if b == 0 or d == 0 or n_rows == 0:
        return torch.zeros(n_rows, d, dtype=torch.float32, device=g.device)
    lib = _build.library("embedding_bag", _bind)
    stream = torch.cuda.current_stream(g.device)
    side = _plan_stream(g.device)
    side.wait_stream(stream)          # g and the ids as the caller left them
    with torch.cuda.device(g.device):
        with torch.cuda.stream(side):
            keys, perm = embedding_bag_backward_sort(indices, n_rows)
        stream.wait_stream(side)      # the sort and the fill contend
        grad = torch.zeros(n_rows, d, dtype=torch.float32, device=g.device)
        with torch.cuda.stream(side):     # while the zeros are written
            plan = embedding_bag_backward_plan(keys, perm, n_rows)
            src = g
            if mode == "mean":        # each bag's g over its count, once
                src = torch.empty_like(g)
                _check(lib.repro_embedding_bag_backward_scale(
                    g.data_ptr(), indices.data_ptr(), b, n, d,
                    src.data_ptr(), side.cuda_stream), "scale")
        for t in (plan.perm, plan.rows, plan.items, plan.item_start,
                  plan.chunks, plan.upto, src,
                  *(level.at for level in plan.levels)):
            t.record_stream(stream)   # read here after the plan's stream
        stream.wait_stream(side)
        perm = plan.perm
        for level in plan.levels:
            partial = torch.empty(level.n_partials, d, dtype=torch.float32,
                                  device=g.device)
            _check(lib.repro_embedding_bag_backward_level(
                src.data_ptr(), d, _ptr(perm), n, _ptr(weights),
                plan.rows.data_ptr(), plan.items.data_ptr(),
                plan.item_start.data_ptr(), plan.chunks.data_ptr(),
                plan.upto.data_ptr(), plan.rows.numel(), plan.items.numel(),
                level.at.data_ptr(), level.k_begin, level.n_chunks,
                grad.data_ptr(), partial.data_ptr(), stream.cuda_stream),
                "level")
            src, perm = partial, None
    with _lock:
        launches["embedding_bag_backward"] += 1
    return grad


@dataclasses.dataclass(frozen=True)
class BagLevel:
    """One level of an ``embedding_bag_backward_plan``: its chunks are
    ``k_begin`` to ``k_begin + n_chunks`` of the plan's running count, and
    ``at[k - k_begin]`` is chunk k's (level, row) in the plan's per-row
    arrays; the level's sums that do not finish a row are the next level's
    ``n_partials`` items."""
    at: torch.Tensor            # int64 [n_chunks]
    k_begin: int
    n_chunks: int
    n_partials: int


@dataclasses.dataclass(frozen=True)
class BagPlan:
    """The order of ``embedding_bag_backward``'s sums.  ``perm`` int64 [N]
    is the flat entries ``b * L + j`` sorted stably by id, so each row's
    entries run in (b, j) order; ``rows`` int64 [R] holds the ids of the
    runs in that order (padding's -1 and the past-the-table id among them,
    with no items).  The per-row arrays, [depth, R] flattened, give row r at
    level l (index ``l * R + r``): ``items`` its items there (its terms at
    level 0, then its partial sums of the level before), ``item_start`` the
    first of them (a position of ``perm`` at level 0, then a slot of the
    level before's partials), ``chunks`` how many chunks of ``chunk``
    consecutive items sum them, and ``upto`` the running count of chunks
    through it.  ``levels`` lists the levels that have chunks."""
    perm: torch.Tensor
    rows: torch.Tensor
    items: torch.Tensor
    item_start: torch.Tensor
    chunks: torch.Tensor
    upto: torch.Tensor
    levels: list


def _depth(n: int, chunk: int) -> int:
    """The levels that sum a row of ``n`` terms: ``chunk ** depth >= n``."""
    depth, reach = 1, chunk
    while reach < n:
        depth, reach = depth + 1, reach * chunk
    return depth


def embedding_bag_backward_sort(indices: torch.Tensor, n_rows: int):
    """(keys, perm) of the bag's gradient for ``indices`` [B, L] into
    ``n_rows`` rows: the flat entries' ids clamped into [-1, n_rows] (so
    padding sorts first and ids past the table last) and sorted stably,
    int32 [N], and their flat places ``b * L + j``, int64 [N], so each
    row's entries run in (b, j) order."""
    return torch.sort(indices.reshape(-1).clamp(-1, n_rows), stable=True)


def embedding_bag_backward_plan(keys: torch.Tensor, perm: torch.Tensor,
                                n_rows: int,
                                chunk: int = BAG_CHUNK) -> BagPlan:
    """The segment and chunk plan of the bag's gradient over the sorted
    entries of ``embedding_bag_backward_sort``, on their device: each row's
    run of terms (padding and ids past the table have none) cut into
    chunks of ``chunk`` consecutive terms, and levels of chunks over each
    row's partial sums, again ``chunk`` at a time, until the row has one
    value.  Row r takes ``ceil(n_r / chunk ** (l + 1))`` chunks at level l
    while ``n_r > chunk ** l``, so every level is computed at once, and the
    plan waits for its device twice (the rows' count, the levels' sizes).
    It orders the sum and computes none of it; ``level_chunks`` reads a
    level's chunks off it."""
    dev = keys.device
    rows, runs = torch.unique_consecutive(keys, return_counts=True)
    rows = rows.long()
    count = torch.where((rows >= 0) & (rows < n_rows), runs, 0)
    depth = _depth(keys.numel(), chunk)
    level = torch.arange(depth, device=dev)[:, None]
    reach = torch.pow(chunk, level + 1)
    chunks = torch.where(count > torch.where(level > 0, reach // chunk, 0),
                         (count + reach - 1) // reach, 0)
    items = torch.cat([count[None], torch.where(chunks[:-1] > 1,
                                                chunks[:-1], 0)])
    # one scan over every level's rows (a scan along each row of a short,
    # wide 2-D tensor is slow on the card), each level's start taken off;
    # level 0's items are positions of perm, padding's run among them
    before = items.reshape(-1).cumsum(0).view(depth, -1) - items
    item_start = torch.cat([(runs.cumsum(0) - runs)[None],
                            before[1:] - before[1:, :1]])
    sizes = torch.cat([chunks.sum(1), items.sum(1)]).tolist()
    n_chunks, n_items = sizes[:depth], sizes[depth:]
    per_row = chunks.reshape(-1)
    upto = per_row.cumsum(0)
    # each chunk's (level, row): the first whose running count passes it
    at = torch.searchsorted(upto, torch.arange(sum(n_chunks), device=dev),
                            right=True)
    levels, k = [], 0
    for n, p in zip(n_chunks, n_items[1:] + [0]):
        if n:
            levels.append(BagLevel(at=at[k:k + n], k_begin=k, n_chunks=n,
                                   n_partials=p))
        k += n
    return BagPlan(perm=perm, rows=rows, items=items.reshape(-1),
                   item_start=item_start.reshape(-1), chunks=per_row,
                   upto=upto, levels=levels)


def level_chunks(plan: BagPlan, level: BagLevel, chunk: int = BAG_CHUNK):
    """(start, length, dest) int64 [n_chunks] of a level's chunks, as the
    gradient kernel works them out: chunk k, the i-th of its row r at level
    l, sums that level's items ``start`` to ``start + length`` (1 to
    ``chunk`` of them, one row's); ``dest`` >= 0 is the row its sum
    finishes (where r has one chunk there), else the sum is item ``-1 -
    dest`` of the next level, the row's i-th there."""
    a = level.at
    k = torch.arange(level.k_begin, level.k_begin + level.n_chunks,
                     device=a.device)
    i = k - (plan.upto[a] - plan.chunks[a])
    start = plan.item_start[a] + i * chunk
    length = (plan.items[a] - i * chunk).clamp(max=chunk)
    later = (a + plan.rows.numel()).clamp(max=plan.items.numel() - 1)
    dest = torch.where(plan.chunks[a] == 1, plan.rows[a % plan.rows.numel()],
                       -1 - (plan.item_start[later] + i))
    return start, length, dest


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(err: int, step: str) -> None:
    if err != 0:
        raise RuntimeError(f"embedding_bag_backward {step} failed: CUDA "
                           f"error {err}")


def _plan_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream ``embedding_bag_backward``'s sort and plan run on, one a
    device: the plan waits for it (the sizes of its levels) while the
    caller's stream zeroes the gradient after the sort.  Its priority is
    high, so the plan's small kernels take SMs ahead of the zero fill's
    waiting blocks."""
    with _lock:
        if device.index not in _plan_streams:
            _plan_streams[device.index] = torch.cuda.Stream(device,
                                                            priority=-1)
        return _plan_streams[device.index]


class EmbeddingBag(torch.autograd.Function):
    """The bag lookup ``(table [V, D], indices [B, L], weights, mode) -> fp32
    [B, D]`` with its gradient with respect to the table (none for the
    indices or the weights).  On a CUDA table the forward launches
    ``embedding_bag`` and the backward ``embedding_bag_backward``, which
    writes fp32: a table of another dtype raises.  On a CPU table both
    take their plain versions (``kernels/ref.py``), so that the Function's
    wiring can be checked without a card."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, indices: torch.Tensor,
                weights: Optional[torch.Tensor], mode: str) -> torch.Tensor:
        ctx.save_for_backward(indices, weights)
        ctx.mode, ctx.n_rows = mode, table.shape[0]
        if table.device.type == "cpu":
            return _ref.embedding_bag(table, indices, weights, mode)
        if table.dtype != torch.float32:
            raise TypeError(f"embedding_bag's gradient kernel writes float32 "
                            f"tables only, got {table.dtype}")
        return embedding_bag(table, indices, weights, mode=mode)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        indices, weights = ctx.saved_tensors
        if g.device.type == "cpu":
            grad = _ref.embedding_bag_backward(g, indices, weights, ctx.mode,
                                               ctx.n_rows)
        else:
            grad = embedding_bag_backward(g.contiguous(), indices, weights,
                                          ctx.mode, ctx.n_rows)
        return grad, None, None, None
