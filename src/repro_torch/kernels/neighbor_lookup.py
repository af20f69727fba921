"""Hopper kernels for the NeighborHash batch probe, and their ctypes wrappers.

Two hand-written CUDA kernels (``csrc/probe.cu``) take the place of the JAX
package's two Pallas kernels:

* ``probe_lines`` — the counterpart of ``lookup_amac``: the tables stay in
  device memory in the line-packed layout below; the many warps resident
  per SM keep many line reads in flight, as AMAC's ring of DMAs did on the
  TPU.  A batch too small to fill 5/8 of the card's thread slots is
  probed by a group of ``LINE_LANES`` lanes a query, reading each line it steps to as
  one coalesced 128 B request (16 B a lane) and taking chain steps within
  that line with no load; a larger one by one thread a query
  (``lines_lanes`` picks).
* ``probe_smem`` — the counterpart of ``lookup_vec``: for a group of tables
  that fits in one block's 227 KB of shared memory, a thread-block cluster
  of ``CLUSTER`` blocks stages the group once, each block one slice of
  ``TableGroup.slice_words`` words by bulk async copies, and probes it
  through distributed shared memory.

Beside them, three kernels that are not TPU kernels read the same
line-packed table: ``random_access``, the paper's RA yardstick (each key
hashed to its home bucket and both value words gathered there, one thread
a key); ``probe_linear``, the linear-probing lookup of the T1 baseline
(``core/lookup.lookup_linear``: one thread a query, a line a load); and
``probe_sequential``, the no-parallelism baseline of Fig. 9
(``core/lookup.lookup_sequential``: one thread resolves the queries one
after another).  ``load_chain``, a yardstick for the last, follows a chain
of dependent line loads with one thread: the card's load latency, measured
apart from any probe.

The probes launch once per ``TableGroup`` (one engine shard): a device
array of table descriptors, uploaded when the group is made, and the ends
of the tables' query segments, passed by value, tell each query which
table it probes, so a batch over several tables is one launch and copies
nothing.

The library is compiled with ``nvcc`` at first use, from the source in this
package, into ``build/repro_torch/`` at the repository root
(``kernels/build.py``).  A wrapper launches its kernel on a CUDA tensor or
raises; it never falls back to the plain version (``kernels/ref.py``) —
``kernels/ops.py`` picks that for CPU tensors.  ``launches`` counts each
kernel's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hashcore as hc
from repro_torch.kernels import build as _build

BUCKETS_PER_LINE = hc.GPU_BUCKETS_PER_LINE      # the kernels' line layout
SMEM_LIMIT = 232_448          # shared memory of one block: 227 KB
MAX_TABLES = 64               # tables per group: kMaxTables in probe.cu
CLUSTER = 8                   # probe_smem's blocks per cluster: kCluster
LINE_LANES = 8                # probe_lines's lanes a query, small batches
LINES_THREADS = 256           # probe_lines's block: kLinesThreads
# one descriptor row per table; the field order of TableDesc in probe.cu
DESC_FIELDS = ("lines", "next_idx", "capacity", "home_capacity",
               "max_probes", "host_check", "smem_lines", "smem_next",
               "n_lines")

launches = {"probe_lines": 0, "probe_smem": 0, "random_access": 0,
            "probe_linear": 0, "probe_sequential": 0, "load_chain": 0}
lanes_launches = {1: 0, LINE_LANES: 0}   # probe_lines's, by lanes

_lock = threading.Lock()
_card: dict = {}              # device index -> (SMs, resident threads an
                              # SM), once probe_init ran


# ---------------------------------------------------------------------------
# the line-packed layout of a built table
# ---------------------------------------------------------------------------
def int32_words(a) -> torch.Tensor:
    """A uint32 / int32 array or tensor as int32 words, where it lies."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        a = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    if a.dtype == torch.uint32:
        return a.view(torch.int32)
    if a.dtype != torch.int32:
        raise TypeError(f"table words are uint32 or int32, got {a.dtype}")
    return a


def _pack(words: Sequence[torch.Tensor], bpl: int) -> torch.Tensor:
    """int32 key_hi, key_lo, val_hi, val_lo [capacity] -> int32
    [n_lines, 4, bpl] on the device of ``key_hi``; buckets past the
    capacity are empty."""
    cap = words[0].shape[0]
    n_lines = -(-cap // bpl)
    stack = torch.zeros((4, n_lines * bpl), dtype=torch.int32,
                        device=words[0].device)
    stack[0] = int(np.uint32(hc.EMPTY_HI).view(np.int32))
    stack[1] = int(np.uint32(hc.EMPTY_LO).view(np.int32))
    stack[:, :cap] = torch.stack([w.to(stack.device) for w in words])
    return stack.view(4, n_lines, bpl).transpose(0, 1).contiguous()


def value_words(table: DeviceTable) -> tuple[torch.Tensor, torch.Tensor]:
    """A line-packed table's val_hi and val_lo, uint32 [capacity] each,
    read back out of its lines where they lie."""
    words = table.lines.view(torch.int32)
    return tuple(words[:, f].reshape(-1)[:table.capacity].view(torch.uint32)
                 for f in (2, 3))


def pack_lines(key_hi: np.ndarray, key_lo: np.ndarray, val_hi: np.ndarray,
               val_lo: np.ndarray, buckets_per_line: int = BUCKETS_PER_LINE
               ) -> np.ndarray:
    """-> uint32 [n_lines, 4, BPL]; one row == one line of buckets."""
    words = [int32_words(a) for a in (key_hi, key_lo, val_hi, val_lo)]
    return _pack(words, buckets_per_line).numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the tables one launch probes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceTable:
    """One built table as the kernels read it."""
    lines: torch.Tensor               # uint32 [n_lines, 4, BUCKETS_PER_LINE]
    next_idx: Optional[torch.Tensor]  # int32 [capacity]; None: inline offsets
    capacity: int
    home_capacity: int
    host_check: bool                  # lodger check at the home bucket
    max_probes: int                   # chain steps after the home bucket


def _check_table(t: DeviceTable, device: torch.device) -> None:
    """What the kernels assume of a table's tensors."""
    if t.lines.device != device or (t.next_idx is not None
                                    and t.next_idx.device != device):
        raise ValueError("a TableGroup's tables share one device")
    if t.lines.dtype != torch.uint32 or not t.lines.is_contiguous() \
            or tuple(t.lines.shape[1:]) != (4, BUCKETS_PER_LINE) \
            or t.lines.data_ptr() % 16:
        raise ValueError("lines must be contiguous, 16 B aligned uint32 "
                         f"[n_lines, 4, {BUCKETS_PER_LINE}]")
    if not 1 <= t.home_capacity <= t.capacity <= \
            t.lines.shape[0] * BUCKETS_PER_LINE or t.capacity >= 2**32:
        raise ValueError("need 1 <= home_capacity <= capacity <= the lines' "
                         "buckets, capacity < 2^32")
    if t.next_idx is not None and (t.next_idx.dtype != torch.int32
                                   or not t.next_idx.is_contiguous()
                                   or t.next_idx.data_ptr() % 16
                                   or t.next_idx.numel() < t.capacity):
        raise ValueError("next_idx must be contiguous, 16 B aligned int32 "
                         "[capacity]")


def _words_128b(n_words: int) -> int:
    return -(-n_words // 32) * 32     # keep every staged array 128 B aligned


class TableGroup:
    """The tables of one grouped launch (one engine shard) and their
    descriptor rows (int64 [n_tables, len(DESC_FIELDS)]) on their device.

    ``smem_bytes`` is the size of the group's staged image, every array
    128 B aligned at its ``smem_lines`` / ``smem_next`` word offset;
    ``probe_smem``'s cluster splits it into ``CLUSTER`` slices of
    ``slice_words`` words (a multiple of one 128 B line, so no line
    straddles two blocks), slice r in block r's shared memory."""

    def __init__(self, tables: Sequence[DeviceTable]):
        if not 1 <= len(tables) <= MAX_TABLES:
            raise ValueError(f"a TableGroup holds 1..{MAX_TABLES} tables, "
                             f"got {len(tables)}")
        self.tables = list(tables)
        self.device = self.tables[0].lines.device
        rows, words = [], 0
        for t in self.tables:
            _check_table(t, self.device)
            row = dict.fromkeys(DESC_FIELDS, 0)
            row.update(capacity=t.capacity, home_capacity=t.home_capacity,
                       max_probes=t.max_probes, host_check=int(t.host_check),
                       n_lines=t.lines.shape[0], smem_lines=words,
                       smem_next=-1, lines=t.lines.data_ptr())
            words += _words_128b(t.lines.numel())
            if t.next_idx is not None:
                row.update(next_idx=t.next_idx.data_ptr(), smem_next=words)
                words += _words_128b(t.capacity)
            rows.append([row[f] for f in DESC_FIELDS])
        self.desc = torch.tensor(rows, dtype=torch.int64, device=self.device)
        # the same rows on the host: probe_smem passes them by value
        self.desc_rows = (ctypes.c_longlong * (len(rows) * len(DESC_FIELDS)))(
            *[x for row in rows for x in row])
        self.smem_bytes = 4 * words
        self.slice_words = _words_128b(-(-words // CLUSTER))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host uint32 / int32 array on ``device``, keeping its dtype; the
    copy moves int32 words (torch has few uint32 kernels on the card)."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.int32)).to(device)
    return t.view(torch.uint32) if a.dtype == np.uint32 else t


def device_table(arrays: dict, *, capacity: int, home_capacity: int,
                 host_check: bool, max_probes: int,
                 device) -> DeviceTable:
    """``HashTable.device_arrays()`` -> a ``DeviceTable`` on ``device`` (only
    side-array variants keep ``next_idx``).  The arrays may be host numpy
    or tensors; each is line-packed where it lies and then moved, so
    tensors already on ``device`` never pass through the host."""
    fields = ("key_hi", "key_lo", "val_hi", "val_lo")
    lines = _pack([int32_words(arrays[k]) for k in fields], BUCKETS_PER_LINE)
    nxt = arrays.get("next_idx")
    if nxt is not None:
        if not isinstance(nxt, torch.Tensor):
            nxt = np.asarray(nxt).astype(np.int32, copy=False)
        nxt = int32_words(nxt).to(device)
        if nxt.data_ptr() % 16:           # bulk copies read it 16 B a time
            nxt = nxt.clone()
    return DeviceTable(
        lines=lines.to(device).view(torch.uint32),
        next_idx=nxt,
        capacity=capacity, home_capacity=home_capacity,
        host_check=host_check, max_probes=max_probes)


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    seg = ctypes.POINTER(ll)
    lib.repro_probe_lines.argtypes = [vp, ctypes.c_int, seg, vp, vp, vp, ll,
                                      ctypes.c_int, vp]
    lib.repro_probe_smem.argtypes = [vp, seg, ctypes.c_int, seg,
                                     ctypes.c_int, ctypes.c_int, vp, vp, vp,
                                     ll, vp]
    lib.repro_random_access.argtypes = [vp, ll, vp, vp, vp, ll, vp]
    lib.repro_random_access.restype = ctypes.c_int
    lib.repro_probe_linear.argtypes = [vp, ll, ll, vp, vp, vp, ll, vp]
    lib.repro_probe_linear.restype = ctypes.c_int
    lib.repro_probe_sequential.argtypes = [vp, vp, ll, ll, ll, ctypes.c_int,
                                           vp, vp, vp, ll, vp]
    lib.repro_probe_sequential.restype = ctypes.c_int
    lib.repro_load_chain.argtypes = [vp, ll, ll, ll, vp, vp]
    lib.repro_load_chain.restype = ctypes.c_int
    lib.repro_probe_init.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.repro_probe_init.restype = ctypes.c_int
    lib.repro_probe_lines.restype = ctypes.c_int
    lib.repro_probe_smem.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.library("probe", _bind)


def _card_of(lib: ctypes.CDLL, device: torch.device) -> tuple[int, int]:
    """(SMs, resident threads an SM) of ``device``: probe_smem's grid bound
    and probe_lines's lanes, queried once per device."""
    index = device.index              # a CUDA tensor's device has one
    with _lock:
        if index not in _card:
            n, threads = ctypes.c_int(0), ctypes.c_int(0)
            with torch.cuda.device(index):
                err = lib.repro_probe_init(ctypes.byref(n),
                                           ctypes.byref(threads))
            if err != 0:
                raise RuntimeError(f"probe_init failed: CUDA error {err}")
            _card[index] = (n.value, threads.value)
        return _card[index]


def lines_lanes(n: int, n_sm: int, threads_per_sm: int) -> int:
    """probe_lines's lanes a query for a batch of ``n``: ``LINE_LANES``
    while the batch's groups fill at most 5/8 of the card's resident
    threads (the SMs would idle with one thread a query), else 1 (each lane
    of a group runs the whole query's arithmetic, so a fuller card issues
    LINE_LANES times the instructions for the same lines).  5/8 is where
    the two forms crossed on an H100: 8 lanes faster at 20,480 queries
    (61% of its 270,336 resident threads), slower at 24,576 (73%)."""
    return LINE_LANES if 8 * n * LINE_LANES <= 5 * n_sm * threads_per_sm \
        else 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(group: TableGroup, q_hi: torch.Tensor, q_lo: torch.Tensor,
           seg: Sequence[int]) -> None:
    if group.device.type != "cuda":
        raise ValueError("the probe kernels take CUDA tensors; CPU tensors "
                         "go to kernels/ref.py through kernels/ops.py")
    for q in (q_hi, q_lo):
        if q.device != group.device or q.dtype != torch.uint32 \
                or q.dim() != 1 or not q.is_contiguous():
            raise ValueError("queries must be contiguous uint32 [N] on the "
                             "tables' device")
    if q_hi.shape != q_lo.shape:
        raise ValueError("q_hi / q_lo lengths differ")
    if len(seg) != len(group.tables) + 1 or seg[0] != 0 \
            or any(b < a for a, b in zip(seg, seg[1:])) \
            or seg[-1] > q_hi.shape[0]:
        raise ValueError(f"bad query segments {list(seg)}")


def _launch(name: str, group: TableGroup, q_hi: torch.Tensor,
            q_lo: torch.Tensor, seg: Sequence[int]) -> torch.Tensor:
    _check(group, q_hi, q_lo, seg)
    n = q_hi.shape[0]
    out = torch.empty((3, n), dtype=torch.int32,
                      device=group.device).view(torch.uint32)
    if n == 0:
        return out
    lib = _library()
    n_tables = len(group.tables)
    desc = ctypes.c_void_p(group.desc.data_ptr())
    ends = (ctypes.c_longlong * n_tables)(*seg[1:])   # copied into the launch
    stream = ctypes.c_void_p(torch.cuda.current_stream(group.device)
                             .cuda_stream)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (q_hi, q_lo, out)]
    if name == "probe_lines":
        lanes = lines_lanes(n, *_card_of(lib, group.device))
        err = lib.repro_probe_lines(desc, n_tables, ends, *ptrs, n, lanes,
                                    stream)
    else:
        if group.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"group needs {group.smem_bytes} B of shared "
                             f"memory; a block has {SMEM_LIMIT}")
        err = lib.repro_probe_smem(desc, group.desc_rows, n_tables, ends,
                                   group.slice_words,
                                   _card_of(lib, group.device)[0], *ptrs, n,
                                   stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _lock:                       # launches may come from many threads
        launches[name] += 1
        if name == "probe_lines":
            lanes_launches[lanes] += 1
    return out


def probe_lines(group: TableGroup, q_hi: torch.Tensor, q_lo: torch.Tensor,
                seg: Sequence[int]) -> torch.Tensor:
    """Grouped probe from device memory -> uint32 [3, N] (found, payload_hi,
    payload_lo) on the current stream; query t's table is the segment of
    ``seg`` holding it, lanes past ``seg[-1]`` come back zero."""
    return _launch("probe_lines", group, q_hi, q_lo, seg)


def probe_smem(group: TableGroup, q_hi: torch.Tensor, q_lo: torch.Tensor,
               seg: Sequence[int]) -> torch.Tensor:
    """``probe_lines`` with the group's tables staged in the shared memory
    of a cluster of ``CLUSTER`` blocks; the group must fit in
    ``SMEM_LIMIT`` bytes."""
    return _launch("probe_smem", group, q_hi, q_lo, seg)


def _one_table_launch(name: str, table: DeviceTable, q_hi: torch.Tensor,
                      q_lo: torch.Tensor, rows: int, launch) -> torch.Tensor:
    """Checks a one-table kernel's operands, makes its uint32 [rows, N]
    output and, for N > 0, calls ``launch(lib, out, n, stream)``, which
    returns the entry point's CUDA error; counts the launch."""
    if table.lines.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors; CPU tensors go to "
                         "its plain version through kernels/ops.py")
    _check_table(table, table.lines.device)
    for q in (q_hi, q_lo):
        if q.device != table.lines.device or q.dtype != torch.uint32 \
                or q.dim() != 1 or not q.is_contiguous():
            raise ValueError("queries must be contiguous uint32 [N] on the "
                             "table's device")
    if q_hi.shape != q_lo.shape:
        raise ValueError("q_hi / q_lo lengths differ")
    n = q_hi.shape[0]
    out = torch.empty((rows, n), dtype=torch.int32,
                      device=q_hi.device).view(torch.uint32)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(q_hi.device).cuda_stream
    err = launch(_library(), out, n, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _lock:
        launches[name] += 1
    return out


def random_access(table: DeviceTable, q_hi: torch.Tensor, q_lo: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's RA gather on the card: each key of ``q_hi`` / ``q_lo``
    (contiguous uint32 [N] on the table's device) hashed to ``hash64 %
    capacity`` (the table's) and both value words of that bucket read from
    its lines -> (val_hi, val_lo) uint32 [N], the function of
    ``core/lookup.random_access``, on the current stream.  Raises on
    anything else."""
    out = _one_table_launch(
        "random_access", table, q_hi, q_lo, 2,
        lambda lib, out, n, stream: lib.repro_random_access(
            table.lines.data_ptr(), table.capacity, q_hi.data_ptr(),
            q_lo.data_ptr(), out.data_ptr(), n, stream))
    return out[0], out[1]


def probe_linear(table: DeviceTable, q_hi: torch.Tensor, q_lo: torch.Tensor
                 ) -> torch.Tensor:
    """Linear probing over a line-packed table on the card -> uint32 [3, N]
    (found, payload_hi, payload_lo), the function of
    ``core/lookup.lookup_linear``: home ``hash64 % capacity``, then
    ``(idx + 1) % capacity`` until a hit, an empty bucket or
    ``table.max_probes`` steps past home, each line's steps resolved from
    one read of its keys.  The table's ``next_idx``, ``home_capacity`` and
    ``host_check`` are not read.  Raises on CPU tensors."""
    return _one_table_launch(
        "probe_linear", table, q_hi, q_lo, 3,
        lambda lib, out, n, stream: lib.repro_probe_linear(
            table.lines.data_ptr(), table.capacity, table.max_probes,
            q_hi.data_ptr(), q_lo.data_ptr(), out.data_ptr(), n, stream))


def probe_sequential(table: DeviceTable, q_hi: torch.Tensor,
                     q_lo: torch.Tensor) -> torch.Tensor:
    """The probe of ``probe_lines`` (one table) with no parallelism: one
    thread resolves the queries one after another -> uint32 [3, N], the
    function of ``core/lookup.lookup_sequential``.  Raises on CPU
    tensors."""
    nxt = table.next_idx
    return _one_table_launch(
        "probe_sequential", table, q_hi, q_lo, 3,
        lambda lib, out, n, stream: lib.repro_probe_sequential(
            table.lines.data_ptr(), None if nxt is None else nxt.data_ptr(),
            table.capacity, table.home_capacity, table.max_probes,
            int(table.host_check), q_hi.data_ptr(), q_lo.data_ptr(),
            out.data_ptr(), n, stream))


def load_chain(words: torch.Tensor, start: int, steps: int
               ) -> torch.Tensor:
    """One thread follows ``steps`` dependent loads through ``words``
    (contiguous int32 [n_lines, 32] on the card: 128 B lines, word 0 of
    each the index of the next line) from line ``start`` -> int64 [1], the
    line reached, the function of ``ref.load_chain``, on the current
    stream.  Each load's address is
    the load before it, so the launch's time over ``steps`` is the card's
    dependent-load latency.  A word 0 past the last line is read as the
    last line.  Raises on CPU tensors."""
    if words.device.type != "cuda":
        raise ValueError("load_chain takes a CUDA tensor; a CPU chain goes "
                         "to ref.load_chain")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != 4 * BUCKETS_PER_LINE \
            or not words.is_contiguous():
        raise ValueError("words must be contiguous int32 [n_lines, 32]")
    n_lines = words.shape[0]
    if not 0 <= start < n_lines or steps < 0:
        raise ValueError("start or steps out of range")
    out = torch.empty(1, dtype=torch.int64, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library().repro_load_chain(words.data_ptr(), n_lines, start, steps,
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"load_chain launch failed: CUDA error {err}")
    with _lock:
        launches["load_chain"] += 1
    return out
