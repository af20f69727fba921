"""Hopper kernels for the NeighborHash batch probe, and their ctypes wrappers.

Two hand-written CUDA kernels (``csrc/probe.cu``) take the place of the JAX
package's two Pallas kernels:

* ``probe_lines`` — the counterpart of ``lookup_amac``: the tables stay in
  device memory in the line-packed layout below and each thread chases one
  query's chain; the many warps resident per SM keep many line reads in
  flight, as AMAC's ring of DMAs did on the TPU.
* ``probe_smem`` — the counterpart of ``lookup_vec``: for a group of tables
  that fits in one block's 227 KB of shared memory, persistent blocks stage
  the tables once and then probe from shared memory.

Both launch once per ``TableGroup`` (one engine shard): a device array of
table descriptors, uploaded when the group is made, and the ends of the
tables' query segments, passed by value, tell each query which table it
probes, so a batch over several tables is one launch and copies nothing.

The library is compiled with ``nvcc`` at first use, from the source in this
package, into ``build/repro_torch/`` at the repository root.  A wrapper
launches its kernel on a CUDA tensor or raises; it never falls back to the
plain version (``kernels/ref.py``) — ``kernels/ops.py`` picks that for CPU
tensors.  ``launches`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hashcore as hc

BUCKETS_PER_LINE = hc.GPU_BUCKETS_PER_LINE      # the kernels' line layout
SMEM_LIMIT = 232_448          # shared memory of one block: kSmemLimit
MAX_TABLES = 64               # tables per group: kMaxTables in probe.cu
# one descriptor row per table; the field order of TableDesc in probe.cu
DESC_FIELDS = ("lines", "next_idx", "capacity", "home_capacity",
               "max_probes", "host_check", "smem_lines", "smem_next",
               "n_lines")

launches = {"probe_lines": 0, "probe_smem": 0}

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "probe.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "build", "repro_torch")
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_n_sm: dict = {}              # device index -> SM count, once probe_init ran


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
                                   or t.next_idx.numel() < t.capacity):
        raise ValueError("next_idx must be contiguous int32 [capacity]")


def _words_128b(n_words: int) -> int:
    return -(-n_words // 32) * 32     # keep every staged array 128 B aligned


class TableGroup:
    """The tables of one grouped launch (one engine shard) and their
    descriptor rows (int64 [n_tables, len(DESC_FIELDS)]) on their device."""

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
        self.smem_bytes = 4 * words


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
    if nxt is not None and not isinstance(nxt, torch.Tensor):
        nxt = np.asarray(nxt).astype(np.int32, copy=False)
    return DeviceTable(
        lines=lines.to(device).view(torch.uint32),
        next_idx=None if nxt is None else int32_words(nxt).to(device),
        capacity=capacity, home_capacity=home_capacity,
        host_check=host_check, max_probes=max_probes)


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the probe "
                           "kernels build from csrc/probe.cu at first use")
    return found


def build_library() -> str:
    """Compile ``csrc/probe.cu`` for sm_90a unless a library built from the
    same source exists; returns the ``.so`` path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libprobe-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    with open(out + ".log", "w") as f:          # ptxas register/smem report
        f.write(r.stderr)
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            seg = ctypes.POINTER(ll)
            lib.repro_probe_lines.argtypes = [vp, ctypes.c_int, seg, vp, vp,
                                              vp, ll, vp]
            lib.repro_probe_smem.argtypes = [vp, ctypes.c_int, seg, ll,
                                             ctypes.c_int, vp, vp, vp, ll,
                                             vp]
            lib.repro_probe_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.repro_probe_init.restype = ctypes.c_int
            lib.repro_probe_lines.restype = ctypes.c_int
            lib.repro_probe_smem.restype = ctypes.c_int
            _lib = lib
        return _lib


def _sm_count(lib: ctypes.CDLL, device: torch.device) -> int:
    """The SM count of ``device`` (probe_smem's grid bound).  The first call
    on a device also raises probe_smem's shared-memory limit there to
    ``SMEM_LIMIT``, so a launch sets no attribute."""
    index = device.index              # a CUDA tensor's device has one
    with _lib_lock:
        if index not in _n_sm:
            n = ctypes.c_int(0)
            with torch.cuda.device(index):
                err = lib.repro_probe_init(ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"probe_init failed: CUDA error {err}")
            _n_sm[index] = n.value
        return _n_sm[index]


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
        err = lib.repro_probe_lines(desc, n_tables, ends, *ptrs, n, stream)
    else:
        if group.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"group needs {group.smem_bytes} B of shared "
                             f"memory; a block has {SMEM_LIMIT}")
        err = lib.repro_probe_smem(desc, n_tables, ends, group.smem_bytes,
                                   _sm_count(lib, group.device), *ptrs, n,
                                   stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def probe_lines(group: TableGroup, q_hi: torch.Tensor, q_lo: torch.Tensor,
                seg: Sequence[int]) -> torch.Tensor:
    """Grouped probe from device memory -> uint32 [3, N] (found, payload_hi,
    payload_lo) on the current stream; query t's table is the segment of
    ``seg`` holding it, lanes past ``seg[-1]`` come back zero."""
    return _launch("probe_lines", group, q_hi, q_lo, seg)


def probe_smem(group: TableGroup, q_hi: torch.Tensor, q_lo: torch.Tensor,
               seg: Sequence[int]) -> torch.Tensor:
    """``probe_lines`` with the group's tables staged in shared memory; the
    group must fit in ``SMEM_LIMIT`` bytes."""
    return _launch("probe_smem", group, q_hi, q_lo, seg)
