"""Hopper kernel for DeepFM's FM second-order term, and its ctypes wrapper.

``csrc/fused_fm.cu`` takes the place of the JAX package's Pallas kernel
``kernels/fused_fm.py::fused_fm``: per sample of ``emb [B, F, D]`` (fp32 or
bf16) it computes ``0.5 * sum_d[(sum_f x)^2 - sum_f x^2]`` in fp32 and writes
only the ``[B]`` result, one warp per sample, for any B, F and D.

The library is compiled with ``nvcc`` at first use (``kernels/build.py``).
The wrapper launches the kernel on a CUDA tensor or raises; it never falls
back to the plain version (``kernels/ref.fused_fm``) — ``kernels/ops.py``
picks that for CPU tensors.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

launches = {"fused_fm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # dtype codes of the .cu
_WARPS_PER_BLOCK = 8                                # kWarpsPerBlock
_MAX_BATCH = (2**31 - 1) * _WARPS_PER_BLOCK         # the grid's x limit


def _bind(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.repro_fused_fm.argtypes = [vp, ctypes.c_int, vp, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, vp]
    lib.repro_fused_fm.restype = ctypes.c_int


def fused_fm(emb: torch.Tensor) -> torch.Tensor:
    """``emb`` [B, F, D], contiguous fp32 or bf16 on the card -> fp32 [B] on
    the current stream.  Raises on anything else: a non-contiguous tensor
    is the caller's to copy."""
    if emb.device.type != "cuda":
        raise ValueError("fused_fm takes a CUDA tensor; CPU tensors go to "
                         "kernels/ref.py through kernels/ops.py")
    if emb.dtype not in _DTYPES:
        raise TypeError(f"fused_fm takes float32 or bfloat16, got "
                        f"{emb.dtype}")
    if emb.dim() != 3 or not emb.is_contiguous():
        raise ValueError(f"fused_fm takes a contiguous [B, F, D] tensor, got "
                         f"shape {tuple(emb.shape)}, strides {emb.stride()}")
    b, f, d = emb.shape
    if b > _MAX_BATCH or f >= 2**31 or d >= 2**31:
        raise ValueError(f"shape {tuple(emb.shape)} exceeds the launch's "
                         "limits")
    out = torch.empty(b, dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    lib = _build.library("fused_fm", _bind)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.repro_fused_fm(emb.data_ptr(), _DTYPES[emb.dtype],
                                 out.data_ptr(), b, f, d, stream)
    if err != 0:
        raise RuntimeError(f"fused_fm launch failed: CUDA error {err}")
    launches["fused_fm"] += 1
    return out
