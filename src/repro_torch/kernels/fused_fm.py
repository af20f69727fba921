"""Hopper kernel for DeepFM's FM second-order term, and its ctypes wrapper.

``csrc/fused_fm.cu`` takes the place of the JAX package's Pallas kernel
``kernels/fused_fm.py::fused_fm``: per sample of ``emb [B, F, D]`` (fp32 or
bf16) it computes ``0.5 * sum_d[(sum_f x)^2 - sum_f x^2]`` in fp32 and writes
only the ``[B]`` result, for any B, F and D.  It streams tiles of whole
samples through shared memory: by one bulk async copy a tile, in a ring of
``STAGES`` stages of at most ``STAGE_BYTES``, where the tile's span allows
(the ``bulk`` branch), else by coalesced loads into a ``LOADS_BYTES``
buffer (``loads``; a sample larger than that is summed where it lies).  ``plan`` picks
the branch, the tile and the launch's shape from the shape alone; ``paths``
counts the launches of each branch.

``fused_fm_backward`` launches the gradient kernel of the same library:
``grad[b, f, d] = g[b] * (sum_f' x[b, f', d] - x[b, f, d])``, a tile of
whole samples a block, staged by one bulk copy where every tile starts on
16 B, its column sums once in shared memory, the gradient written by
consecutive threads on consecutive elements (``backward_plan``).
``FusedFM`` is the autograd ``Function`` that ``kernels/ops.py`` runs on
a CUDA tensor: its forward launches ``fused_fm`` and saves ``emb``, its
backward launches ``fused_fm_backward``.

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
The wrappers launch their kernels on a CUDA tensor or raise; they never
fall back to the plain versions (``kernels/ref.fused_fm``,
``ref.fused_fm_backward``) — ``kernels/ops.py`` picks those for CPU
tensors, and ``FusedFM`` takes them for a CPU tensor only.  ``launches``
counts each kernel's launches.  On the meta device (the dry-run,
``launch/dryrun.py``) a wrapper launches nothing: it returns an empty
tensor of its output's shape and reports its work to the open dry
``roofline.analysis.Tally`` (the bytes and operations of its bound).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.roofline import analysis

launches = {"fused_fm": 0, "fused_fm_backward": 0}
paths = {"bulk": 0, "loads": 0}          # which branch each launch took
STAGES = 2                               # kStages in fused_fm.cu
STAGE_BYTES = 16 * 1024                  # a bulk tile's span, at most
LOADS_BYTES = 48 * 1024                  # the loads branch's buffer
BLOCKS_PER_SM = 4                        # the persistent grid
MAX_THREADS = 256                        # kMaxThreads
BACKWARD_SMEM = LOADS_BYTES - 16         # the gradient's dynamic shared
#                                          memory, beside its 8 B barrier
WARP = 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # dtype codes of the .cu
_BRANCHES = {"bulk": 0, "loads": 1}
_n_sm: dict = {}                         # device index -> SM count
_lock = threading.Lock()                 # the counts, from many threads


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``repro_fused_fm``: tiles of ``tile`` samples, a
    sample's columns over ``lanes`` threads, ``threads`` a block, ``blocks``
    in the grid and ``smem_bytes`` of dynamic shared memory (``STAGES``
    stages on bulk; on loads the buffer, or 0 when the sample is summed
    where it lies)."""
    branch: str
    tile: int
    lanes: int
    threads: int
    blocks: int
    smem_bytes: int

    @property
    def stages(self) -> int:
        return STAGES if self.branch == "bulk" else 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile(batch: int, step: int, most: int, n_sm: int) -> int:
    """Samples a tile: a multiple of ``step``, at most ``most``, and small
    enough that the batch's tiles cover the SMs where it can."""
    per_sm = batch // n_sm // step * step
    return max(step, min(most, per_sm))


def plan(batch: int, fields: int, dim: int, elt_bytes: int, n_sm: int,
         aligned: bool) -> Plan:
    """The launch for ``[batch, fields, dim]`` of ``elt_bytes`` elements on a
    card of ``n_sm`` SMs; ``aligned``: the tensor starts on 16 bytes.

    Bulk when the tensor is 16 B aligned and a tile whose span is a multiple
    of 16 B fits a stage: then every tile starts on 16 B, and only the
    batch's last may end off it.  Loads otherwise, tiles staged in the
    buffer when a sample fits it, else one sample a tile summed in
    place."""
    sample = fields * dim * elt_bytes
    lanes = 1 << max(0, min(dim, WARP) - 1).bit_length()   # pow2 >= D, <= 32

    def shape(tile: int) -> tuple[int, int]:
        n_tiles = -(-batch // tile)
        return (min(MAX_THREADS, _round_up(tile * lanes, WARP)),
                min(n_tiles, BLOCKS_PER_SM * n_sm))

    if aligned and sample > 0:
        step = 16 // math.gcd(sample, 16)   # least S: S * sample % 16 == 0
        most = STAGE_BYTES // sample // step * step
        if most >= step:
            tile = _tile(batch, step, most, n_sm)
            threads, blocks = shape(tile)
            return Plan("bulk", tile, lanes, threads, blocks,
                        STAGES * _round_up(tile * sample, 16))
    if sample + 16 > LOADS_BYTES:
        threads, blocks = shape(1)
        return Plan("loads", 1, lanes, threads, blocks, 0)
    most = (LOADS_BYTES - 16) // sample if sample else MAX_THREADS
    tile = _tile(batch, 1, most, n_sm)
    threads, blocks = shape(tile)
    return Plan("loads", tile, lanes, threads, blocks,
                _round_up(tile * sample, 16) + 16)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """One launch of ``repro_fused_fm_backward``: tiles of ``tile`` samples,
    one a block, ``blocks`` of them; ``threads`` a block; ``sums_bytes`` of
    column sums and ``smem_bytes`` of dynamic shared memory in all (the
    sums, then the tile's span when ``staged``)."""
    staged: bool
    tile: int
    threads: int
    blocks: int
    sums_bytes: int
    smem_bytes: int


def backward_plan(batch: int, fields: int, dim: int, elt_bytes: int,
                  n_sm: int, aligned: bool) -> BackwardPlan:
    """The gradient's launch for ``[batch, fields, dim]`` (each >= 1) of
    ``elt_bytes`` elements on a card of ``n_sm`` SMs; ``aligned``: the
    tensor starts on 16 bytes.

    Staged, as the forward's bulk branch stages, when the tensor is 16 B
    aligned and a tile whose span is a multiple of 16 B fits a stage
    (``STAGE_BYTES``): then every tile starts on 16 B.  Otherwise the tiles
    are read where they lie, as many samples a tile as a stage's span
    would hold.  Raises where the kernel's 32-bit index arithmetic or its
    shared memory cannot take the shape."""
    sample = fields * dim * elt_bytes

    def launch(staged: bool, tile: int) -> BackwardPlan:
        blocks = -(-batch // tile)
        sums = _round_up(4 * tile * dim, 16)
        span = _round_up(tile * sample, 16) if staged else 0
        return BackwardPlan(staged, tile, min(MAX_THREADS, _round_up(
            tile * fields * dim, WARP)), blocks, sums, sums + span)

    budget = BACKWARD_SMEM - 32             # the sums' and span's rounding
    plan_ = None
    if aligned:
        step = 16 // math.gcd(sample, 16)   # least S: S * sample % 16 == 0
        most = min(STAGE_BYTES // sample,
                   budget // (sample + 4 * dim)) // step * step
        if most >= step:
            plan_ = launch(True, _tile(batch, step, most, n_sm))
    if plan_ is None:
        most = min(STAGE_BYTES // sample, budget // (4 * dim))
        plan_ = launch(False, _tile(batch, 1, max(1, most), n_sm))
    if plan_.tile * fields * dim >= 2**31 or plan_.blocks >= 2**31 \
            or plan_.smem_bytes > BACKWARD_SMEM:
        raise ValueError(f"shape {(batch, fields, dim)} exceeds the "
                         "gradient launch's limits")
    return plan_


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_fm.argtypes = [vp, i32, vp, ctypes.c_longlong, i32, i32,
                                   i32, i32, i32, i32, i32, i32, vp]
    lib.repro_fused_fm.restype = ctypes.c_int
    lib.repro_fused_fm_backward.argtypes = [
        vp, i32, vp, vp, ctypes.c_longlong, i32, i32, i32, i32, i32, i32,
        i32, i32, vp]
    lib.repro_fused_fm_backward.restype = ctypes.c_int


def _sm_count(device: torch.device) -> int:
    if device.index not in _n_sm:
        _n_sm[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _n_sm[device.index]


def fused_fm(emb: torch.Tensor) -> torch.Tensor:
    """``emb`` [B, F, D], contiguous fp32 or bf16 on the card -> fp32 [B] on
    the current stream.  Raises on anything else: a non-contiguous tensor
    is the caller's to copy."""
    if emb.device.type not in ("cuda", "meta"):
        raise ValueError("fused_fm takes a CUDA tensor; CPU tensors go to "
                         "kernels/ref.py through kernels/ops.py")
    if emb.dtype not in _DTYPES:
        raise TypeError(f"fused_fm takes float32 or bfloat16, got "
                        f"{emb.dtype}")
    if emb.dim() != 3 or not emb.is_contiguous():
        raise ValueError(f"fused_fm takes a contiguous [B, F, D] tensor, got "
                         f"shape {tuple(emb.shape)}, strides {emb.stride()}")
    b, f, d = emb.shape
    if f >= 2**31 or d >= 2**31:
        raise ValueError(f"shape {tuple(emb.shape)} exceeds the launch's "
                         "limits")
    out = torch.empty(b, dtype=torch.float32, device=emb.device)
    if emb.device.type == "meta":           # the dry-run: the work, no data
        analysis.note_kernel("fused_fm", 3 * b * f * d + 3 * b * d,
                             emb.numel() * emb.element_size() + 4 * b)
        return out
    if b == 0:
        return out
    lib = _build.library("fused_fm", _bind)
    p = plan(b, f, d, emb.element_size(), _sm_count(emb.device),
             emb.data_ptr() % 16 == 0)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.repro_fused_fm(
            emb.data_ptr(), _DTYPES[emb.dtype], out.data_ptr(), b, f, d,
            _BRANCHES[p.branch], p.tile, p.lanes, p.threads, p.blocks,
            p.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused_fm launch failed: CUDA error {err}")
    with _lock:
        launches["fused_fm"] += 1
        paths[p.branch] += 1
    return out


def fused_fm_backward(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``fused_fm`` at ``emb`` [B, F, D] (contiguous fp32 or
    bf16 on the card) given ``g`` [B] (contiguous fp32, the gradient of its
    output) -> grad [B, F, D] in emb's dtype, on the current stream.
    Raises on anything else."""
    if emb.device.type not in ("cuda", "meta"):
        raise ValueError("fused_fm_backward takes CUDA tensors; CPU tensors "
                         "go to kernels/ref.py through FusedFM")
    if emb.dtype not in _DTYPES:
        raise TypeError(f"fused_fm_backward takes float32 or bfloat16, got "
                        f"{emb.dtype}")
    if emb.dim() != 3 or not emb.is_contiguous():
        raise ValueError(f"fused_fm_backward takes a contiguous [B, F, D] "
                         f"tensor, got shape {tuple(emb.shape)}, strides "
                         f"{emb.stride()}")
    b, f, d = emb.shape
    if g.device != emb.device or g.dtype != torch.float32 \
            or g.shape != (b,) or not g.is_contiguous():
        raise ValueError(f"fused_fm_backward takes g as contiguous float32 "
                         f"[{b}] on {emb.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    grad = torch.empty_like(emb)
    if emb.device.type == "meta":
        analysis.note_kernel("fused_fm_backward", 3 * b * f * d,
                             2 * emb.numel() * emb.element_size() + 4 * b)
        return grad
    if grad.numel() == 0:
        return grad
    p = backward_plan(b, f, d, emb.element_size(), _sm_count(emb.device),
                      emb.data_ptr() % 16 == 0)
    lib = _build.library("fused_fm", _bind)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.repro_fused_fm_backward(
            emb.data_ptr(), _DTYPES[emb.dtype], g.data_ptr(),
            grad.data_ptr(), b, f, d, p.tile, p.threads, p.blocks,
            p.sums_bytes, p.smem_bytes, int(p.staged), stream)
    if err != 0:
        raise RuntimeError(f"fused_fm_backward launch failed: CUDA error "
                           f"{err}")
    with _lock:
        launches["fused_fm_backward"] += 1
    return grad


class FusedFM(torch.autograd.Function):
    """The FM term ``[B, F, D] -> fp32 [B]`` with its gradient.  On a CUDA
    tensor the forward launches ``fused_fm`` and saves ``emb``, and the
    backward launches ``fused_fm_backward``; on a CPU tensor both take their
    plain versions (``kernels/ref.py``), so that the Function's wiring can
    be checked without a card."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(emb)
        if emb.device.type == "cpu":
            return _ref.fused_fm(emb)
        return fused_fm(emb)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (emb,) = ctx.saved_tensors
        if emb.device.type == "cpu":
            return _ref.fused_fm_backward(emb, g)
        return fused_fm_backward(emb, g.contiguous())
