"""Bit-exact hash/bucket math shared by the host builder (numpy / python
ints) and the device probe (torch, and the CUDA kernels in ``csrc/``).

64-bit keys and values are carried as uint32 pairs (structure of arrays).
All three implementations of the mix hash below — python-int, numpy-vector
and torch — are bit-identical to each other and to the JAX package's;
tests assert this.

Value encoding (paper §2.1.1 "Inline chaining", Figure 5)
---------------------------------------------------------
A bucket's 64-bit value word packs:

    bits 63..52  (12)  relative offset to the next chain node, two's-complement,
                       0 == END-OF-CHAIN.  Range [-2048, +2047] \\ {0}.
    bits 51..0   (52)  payload.  In the hybrid store, bit 51 is the tier flag
                       (0 = hot / in-memory, 1 = cold / NVMe) and bits 50..0 are
                       the tier-local offset (see core/hybrid_store.py).

As uint32 SoA:

    val_hi bits 31..20 : the 12-bit offset code
    val_hi bits 19..0  : payload bits 51..32
    val_lo             : payload bits 31..0

Empty buckets hold the reserved key EMPTY_KEY (2^64 - 1); that key may not be
inserted through the public API.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import torch

# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------
MASK32 = 0xFFFFFFFF
EMPTY_KEY = (1 << 64) - 1
EMPTY_HI = MASK32
EMPTY_LO = MASK32

OFFSET_BITS = 12
OFFSET_END = 0                      # offset code 0 == end of chain
OFFSET_MIN = -(1 << (OFFSET_BITS - 1))       # -2048
OFFSET_MAX = (1 << (OFFSET_BITS - 1)) - 1    # +2047
PAYLOAD_BITS = 52
PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1
PAYLOAD_HI_BITS = PAYLOAD_BITS - 32           # 20
PAYLOAD_HI_MASK = (1 << PAYLOAD_HI_BITS) - 1  # 0xFFFFF

# murmur3 fmix32 constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED = 0x9E3779B9

# Bucket line granularity.  The paper's x86 cacheline is 64 B = 4 buckets of
# 16 B; the TPU's HBM transaction sector is ~512 B = 32 buckets.  On an
# NVIDIA GPU one 128 B L2 line holds 8 buckets: the device layout
# (kernels/neighbor_lookup.pack_lines) packs that many per line.  Builders
# take the line size as a parameter.
CPU_BUCKETS_PER_LINE = 4
TPU_BUCKETS_PER_LINE = 32
GPU_BUCKETS_PER_LINE = 8


# ---------------------------------------------------------------------------
# mix hash — python-int flavour (host builder inner loop)
# ---------------------------------------------------------------------------
def mix32_int(h: int) -> int:
    h &= MASK32
    h ^= h >> 16
    h = (h * _C1) & MASK32
    h ^= h >> 13
    h = (h * _C2) & MASK32
    h ^= h >> 16
    return h


def hash64_int(hi: int, lo: int) -> int:
    """32-bit hash of a 64-bit key given as two 32-bit halves."""
    h = mix32_int(lo ^ _SEED)
    h = mix32_int(h ^ hi)
    return h


def bucket_of_int(hi: int, lo: int, capacity: int) -> int:
    return hash64_int(hi, lo) % capacity


def key_split_int(key: int) -> tuple[int, int]:
    return (key >> 32) & MASK32, key & MASK32


# ---------------------------------------------------------------------------
# mix hash — numpy flavour (vectorized host paths, builders' bulk passes)
# ---------------------------------------------------------------------------
def mix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_C1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_C2)
    h ^= h >> np.uint32(16)
    return h


def hash64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    h = mix32_np(lo.astype(np.uint32) ^ np.uint32(_SEED))
    h = mix32_np(h ^ hi.astype(np.uint32))
    return h


def bucket_of_np(hi: np.ndarray, lo: np.ndarray, capacity: int) -> np.ndarray:
    return (hash64_np(hi, lo) % np.uint32(capacity)).astype(np.int64)


def key_split_np(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = keys.astype(np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(MASK32)).astype(np.uint32)
    return hi, lo


# ---------------------------------------------------------------------------
# mix hash — torch flavour (the plain device probe).  torch has no full
# uint32 arithmetic (``>>`` and ``%`` raise on UInt32 on the CPU), so every
# function here takes and returns int64 tensors holding 32-bit values, and
# masks each product back to 32 bits.  Operators only: this module (and the
# host builders and the store above it) imports without torch.
# ---------------------------------------------------------------------------
def mix32_torch(h: torch.Tensor) -> torch.Tensor:
    h = h & MASK32
    h = h ^ (h >> 16)
    h = (h * _C1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2) & MASK32
    return h ^ (h >> 16)


def hash64_torch(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    h = mix32_torch(lo ^ _SEED)
    return mix32_torch(h ^ hi)


def bucket_of_torch(hi: torch.Tensor, lo: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    return hash64_torch(hi, lo) % capacity


def decode_offset_torch(val_hi: torch.Tensor) -> torch.Tensor:
    """val_hi (int64 holding 32 bits) -> signed relative offset (0 == END)."""
    code = (val_hi >> PAYLOAD_HI_BITS) & 0xFFF
    return (code ^ 0x800) - 0x800           # sign-extend the 12-bit code


# ---------------------------------------------------------------------------
# offset / payload packing  (int flavour used by the builder; numpy-vector
# decoders used by host lookups)
# ---------------------------------------------------------------------------
def encode_offset_int(offset: int) -> int:
    """Two's-complement 12-bit code for a nonzero relative offset."""
    if offset == 0:
        raise ValueError("relative offset 0 is reserved for END-OF-CHAIN")
    if not (OFFSET_MIN <= offset <= OFFSET_MAX):
        raise ValueError(f"offset {offset} out of 12-bit range")
    return offset & 0xFFF


def decode_offset_int(code: int) -> int:
    """Inverse of encode_offset_int; code 0 decodes to 0 (END)."""
    code &= 0xFFF
    return code - 0x1000 if code >= 0x800 else code


def pack_value_int(payload: int, offset_code: int) -> tuple[int, int]:
    """payload (<=52 bits) + offset code -> (val_hi, val_lo) uint32 pair."""
    if payload & ~PAYLOAD_MASK:
        raise ValueError("payload exceeds 52 bits")
    val_lo = payload & MASK32
    val_hi = ((offset_code & 0xFFF) << PAYLOAD_HI_BITS) | ((payload >> 32) & PAYLOAD_HI_MASK)
    return val_hi, val_lo


def unpack_value_int(val_hi: int, val_lo: int) -> tuple[int, int]:
    """(val_hi, val_lo) -> (payload, offset_code)."""
    offset_code = (val_hi >> PAYLOAD_HI_BITS) & 0xFFF
    payload = ((val_hi & PAYLOAD_HI_MASK) << 32) | val_lo
    return payload, offset_code


def decode_offset_np(val_hi: np.ndarray) -> np.ndarray:
    code = ((val_hi >> np.uint32(PAYLOAD_HI_BITS)) & np.uint32(0xFFF)).astype(np.int32)
    return np.where(code >= 0x800, code - 0x1000, code)


def payload_np(val_hi: np.ndarray, val_lo: np.ndarray) -> np.ndarray:
    """-> full 52-bit payload as uint64 (host-side convenience)."""
    hi = (val_hi.astype(np.uint64) & np.uint64(PAYLOAD_HI_MASK)) << np.uint64(32)
    return hi | val_lo.astype(np.uint64)


def line_of(idx, buckets_per_line: int):
    """Bucket index -> line id (works for int / numpy / torch)."""
    return idx // buckets_per_line
