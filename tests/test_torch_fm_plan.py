"""The host arithmetic of ``fused_fm``'s launch (no card needed): the tile
plan ``kernels/fused_fm.plan`` hands the kernel, and a numpy mirror of how
the kernel walks it.

For every shape below the plan's branch, tile, lanes, block, grid and
shared memory must be what ``csrc/fused_fm.cu`` accepts (its entry point's
checks are mirrored), every bulk tile must start on 16 B and span a
multiple of 16 B (only the batch's last may end off it, by less than 16 B,
which plain loads bring), the tiles must cover the batch once, and the
mirror of the kernel's walk (tiles by block stride, a sample's columns over
``lanes`` threads, fields summed in order, the lanes' terms met by a xor
shuffle) must give the plain FM."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_fm as fm
from repro_torch.kernels import ref

N_SM = 132                                  # an H100 SXM
DEEPFM = (39, 10)                           # fields, embed_dim

# (batch, fields, dim, element bytes, 16 B aligned) -> the branch
SHAPES = {
    "deepfm-request": ((512, 39, 10, 4, True), "bulk"),
    "deepfm-serve-bulk": ((262144, 39, 10, 4, True), "bulk"),
    "deepfm-retrieval-cand": ((1_000_000, 39, 10, 4, True), "bulk"),
    "deepfm-retrieval-partial": ((999_999, 39, 10, 4, True), "bulk"),
    "deepfm-retrieval-partial-bf16": ((999_999, 39, 10, 2, True), "bulk"),
    "deepfm-bf16": ((512, 39, 10, 2, True), "bulk"),
    "bf16-one-sample": ((1, 39, 10, 2, True), "bulk"),
    "odd-fd-fp32": ((1000, 13, 9, 4, True), "bulk"),
    "odd-fd-bf16": ((77, 3, 7, 2, True), "bulk"),
    "tiny-sample": ((8, 2, 4, 2, True), "bulk"),
    "wide-dim": ((33, 3, 256, 4, True), "bulk"),
    "one-per-sm": ((132, 39, 10, 4, True), "bulk"),
    "unaligned": ((512, 39, 10, 4, False), "loads"),
    "unaligned-bf16": ((129, 13, 8, 2, False), "loads"),
    "larger-than-a-stage": ((64, 39, 256, 4, True), "loads"),
    "larger-than-a-stage-bf16": ((64, 39, 256, 2, True), "loads"),
    "larger-than-the-buffer": ((5, 100, 200, 4, True), "loads"),
    "row-larger-than-the-buffer": ((3, 2, 20000, 4, True), "loads"),
    "no-fields": ((5, 0, 10, 4, True), "loads"),
    "no-dim": ((5, 3, 0, 4, True), "loads"),
}
# batches whose last tile is partial and ends off 16 B; the walk is
# mirrored with the full batch's plan over two whole tiles and that tail
PARTIAL = ("deepfm-retrieval-partial", "deepfm-retrieval-partial-bf16")


def _plan(shape):
    b, f, d, elt, aligned = shape
    return fm.plan(b, f, d, elt, N_SM, aligned)


def _entry_accepts(p, b):
    """repro_fused_fm's checks of its parameters."""
    ok = (b >= 1 and p.tile >= 1 and p.blocks >= 1
          and p.lanes in (1, 2, 4, 8, 16, 32)
          and 32 <= p.threads <= fm.MAX_THREADS and p.threads % 32 == 0
          and 0 <= p.smem_bytes <= 48 * 1024)
    if p.branch == "bulk":
        return (ok and p.smem_bytes >= 16 * fm.STAGES
                and p.smem_bytes % (16 * fm.STAGES) == 0)
    return ok and (p.tile == 1 if p.smem_bytes == 0 else p.smem_bytes >= 16)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_branch_and_launch_limits(name):
    shape, branch = SHAPES[name]
    b, f, d, elt, _ = shape
    p = _plan(shape)
    assert p.branch == branch
    assert _entry_accepts(p, b)
    assert p.lanes >= min(max(d, 1), 32)       # every column has a lane
    n_tiles = -(-b // p.tile)
    assert p.blocks == min(n_tiles, fm.BLOCKS_PER_SM * N_SM)
    assert p.stages == (fm.STAGES if branch == "bulk" else 1)


@pytest.mark.parametrize("name", [n for n, (_, br) in SHAPES.items()
                                  if br == "bulk"])
def test_bulk_tiles_start_and_span_on_16_bytes(name):
    """Every tile's span starts on 16 B and is a multiple of 16 B; only the
    batch's last may end off it, and its < 16 B are whole elements that
    plain loads bring.  A tile fits its stage."""
    (b, f, d, elt, _), _ = SHAPES[name]
    p = _plan(SHAPES[name][0])
    sample = f * d * elt
    stage = p.smem_bytes // fm.STAGES
    assert p.tile * sample <= min(stage, fm.STAGE_BYTES) and stage % 16 == 0
    n_tiles = -(-b // p.tile)
    covered = 0
    for t in range(n_tiles):
        n = min(p.tile, b - t * p.tile)
        start, span = t * p.tile * sample, n * sample
        assert start % 16 == 0 and start == covered
        bulk_bytes, tail = span // 16 * 16, span % 16
        if t < n_tiles - 1:
            assert tail == 0 and n == p.tile
        assert tail % elt == 0 and bulk_bytes + tail == span
        covered += span
    assert covered == b * sample
    if name in PARTIAL:      # the last tile partial, its span off 16 B
        assert 0 < n < p.tile and tail and bulk_bytes <= stage


@pytest.mark.parametrize("name", [n for n, (_, br) in SHAPES.items()
                                  if br == "loads"])
def test_loads_buffer_holds_what_it_stages(name):
    (b, f, d, elt, _), _ = SHAPES[name]
    p = _plan(SHAPES[name][0])
    if f * d * elt + 16 <= fm.LOADS_BYTES:
        # the tile's span, shifted by its source's offset in 16 B
        assert p.tile * f * d * elt + 16 <= p.smem_bytes <= fm.LOADS_BYTES
    else:                       # summed where it lies, a sample a tile
        assert p.tile == 1 and p.smem_bytes == 0
        assert p.lanes == min(32, 1 << (d - 1).bit_length())


def test_deepfm_request_covers_the_sms():
    """[512, 39, 10] fp32: 1,560 B a sample is not a multiple of 16 B, so a
    tile takes an even count; 2 samples a tile gives 256 tiles, one block
    each, every SM at work."""
    p = _plan(SHAPES["deepfm-request"][0])
    assert (p.tile, p.lanes, p.threads, p.blocks) == (2, 16, 32, 256)
    assert p.smem_bytes == fm.STAGES * 3120


def test_serve_bulk_tiles_fill_a_stage_in_a_persistent_grid():
    p = _plan(SHAPES["deepfm-serve-bulk"][0])
    assert p.tile == 10 and p.tile * 1560 <= fm.STAGE_BYTES < 12 * 1560
    assert p.blocks == fm.BLOCKS_PER_SM * N_SM
    assert -(-262144 // p.tile) > 40 * p.blocks   # each block walks tiles


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("b", [1, 2, 3, 131, 132, 133, 263, 264, 265, 1319,
                               1320, 1321, 5279, 5280, 5281, 12345])
def test_tile_grows_with_the_batch_and_keeps_its_step(b, elt):
    """Around the batches where a tile grows (2 a tile for every SM, 10 at
    the stage's limit) and past one persistent wave: a tile is a multiple
    of the least count of samples spanning 16 B, at least that, at most a
    stage, and the tiles cover the SMs wherever the batch can."""
    f, d = DEEPFM
    p = fm.plan(b, f, d, elt, N_SM, True)
    sample = f * d * elt
    step = 16 // math.gcd(sample, 16)
    assert p.branch == "bulk" and p.tile % step == 0
    assert p.tile * sample <= fm.STAGE_BYTES
    if b >= step * N_SM:
        assert -(-b // p.tile) >= N_SM


# ---------------------------------------------------------------------------
# the kernel's walk, mirrored
# ---------------------------------------------------------------------------
def _mirror(x: np.ndarray, p) -> np.ndarray:
    """fp32 [B] as the kernel computes it from x [B, F, D] (fp32 values):
    each block's tiles by block stride; per sample, lane g sums columns
    g, g + lanes, ... over the fields in order; the lanes' terms meet by
    xor shuffles."""
    b, f, d = x.shape
    out = np.full(b, np.nan, np.float32)
    n_tiles = -(-b // p.tile)
    seen = np.zeros(b, int)
    for block in range(p.blocks):
        for t in range(block, n_tiles, p.blocks):
            for s in range(t * p.tile, min(b, (t + 1) * p.tile)):
                seen[s] += 1
                lanes = p.lanes
                part = np.zeros(lanes, np.float32)
                for c in range(d):
                    g = c % lanes
                    total, sq = np.float32(0), np.float32(0)
                    for v in x[s, :, c]:
                        total = np.float32(total + v)
                        sq = np.float32(sq + v * v)
                    part[g] = np.float32(part[g] + (total * total - sq))
                off = lanes // 2
                while off:
                    part = (part + part[np.arange(lanes) ^ off]).astype(
                        np.float32)
                    off //= 2
                out[s] = np.float32(0.5) * part[0]
    assert (seen == 1).all()                    # every sample once
    return out


@pytest.mark.parametrize("name", ["deepfm-request", "odd-fd-fp32",
                                  "odd-fd-bf16", "bf16-one-sample",
                                  "tiny-sample", "wide-dim", "unaligned",
                                  "larger-than-the-buffer", "no-fields",
                                  "no-dim", *PARTIAL])
def test_mirror_of_the_walk_gives_the_plain_fm(name):
    (b, f, d, elt, aligned), _ = SHAPES[name]
    if name in PARTIAL:
        p = fm.plan(b, f, d, elt, N_SM, aligned)
        b = 2 * p.tile + b % p.tile
        assert 0 < b % p.tile
    else:
        b = min(b, 64)
        p = fm.plan(b, f, d, elt, N_SM, aligned)
    rng = np.random.default_rng(b + f + d)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    want = ref.fused_fm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_mirror(x, p), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the retrieval_cand batch: 1,000,000 DeepFM rows
# ---------------------------------------------------------------------------
def test_retrieval_cand_tiles_fill_the_batch_in_a_persistent_grid():
    """[1,000,000, 39, 10] fp32 (1.56 GB): tiles of 10 samples, 100,000 of
    them, the last one full; 528 blocks walk 189-190 tiles each; the
    batch's last byte lies past 2^30, inside the int64 offsets the kernel
    computes (``t * tile * sample`` elements)."""
    b, f, d, elt, aligned = SHAPES["deepfm-retrieval-cand"][0]
    p = _plan(SHAPES["deepfm-retrieval-cand"][0])
    assert (p.branch, p.tile, p.lanes, p.threads) == ("bulk", 10, 16, 160)
    assert p.blocks == fm.BLOCKS_PER_SM * N_SM == 528
    n_tiles = -(-b // p.tile)
    assert n_tiles == 100_000 and b % p.tile == 0
    assert {len(range(k, n_tiles, p.blocks)) for k in range(p.blocks)} == \
        {189, 190}
    assert 2**30 < b * f * d * elt < 2**31


# ---------------------------------------------------------------------------
# the gradient's launch: backward_plan and a mirror of its kernel's walk
# ---------------------------------------------------------------------------
# (batch, fields, dim, element bytes, 16 B aligned) -> staged
BACKWARD_SHAPES = {
    "deepfm-train-batch": ((65536, 39, 10, 4, True), True),
    "deepfm-train-batch-bf16": ((65536, 39, 10, 2, True), True),
    "deepfm-train-unaligned": ((65536, 39, 10, 4, False), False),
    "one-element": ((1, 1, 1, 4, True), True),
    "one-element-bf16": ((1, 1, 1, 2, True), True),
    "odd-fp32": ((33, 13, 9, 4, True), True),
    "odd-bf16": ((77, 3, 7, 2, True), True),
    "odd-unaligned-bf16": ((77, 3, 7, 2, False), False),
    "one-field-bf16": ((5000, 1, 4, 2, True), True),
    "larger-than-a-stage": ((7, 39, 256, 4, True), False),
    "row-larger-than-a-stage": ((3, 2, 5000, 4, True), False),
}


def _backward_entry_accepts(p, b, f, d):
    """repro_fused_fm_backward's checks of its parameters."""
    return (p.tile >= 1 and p.blocks >= 1 and p.blocks * p.tile >= b
            and p.tile * f * d < 2**31 and 32 <= p.threads <= 256
            and p.threads % 32 == 0 and p.sums_bytes >= 4 * p.tile * d
            and p.sums_bytes % 16 == 0
            and p.sums_bytes <= p.smem_bytes <= fm.LOADS_BYTES - 16)


@pytest.mark.parametrize("name", list(BACKWARD_SHAPES))
def test_backward_plan_staging_and_limits(name):
    (b, f, d, elt, aligned), staged = BACKWARD_SHAPES[name]
    p = fm.backward_plan(b, f, d, elt, N_SM, aligned)
    assert p.staged == staged
    assert _backward_entry_accepts(p, b, f, d)
    assert p.blocks == -(-b // p.tile) and (p.blocks - 1) * p.tile < b
    span = p.tile * f * d * elt
    if staged:                      # every tile starts on 16 B, fits a stage
        assert span % 16 == 0 and span <= fm.STAGE_BYTES
        assert p.smem_bytes == p.sums_bytes + span
    else:
        assert p.smem_bytes == p.sums_bytes


def test_backward_plan_at_the_train_batch():
    """[65536, 39, 10] fp32: ten 1,560 B samples a tile (a 15,600 B bulk
    copy), 6,554 blocks of 256 threads."""
    p = fm.backward_plan(65536, 39, 10, 4, N_SM, True)
    assert (p.staged, p.tile, p.blocks, p.threads) == (True, 10, 6554, 256)
    assert p.smem_bytes == 400 + 15600


def test_backward_plan_refuses_what_its_indices_cannot_take():
    with pytest.raises(ValueError, match="limits"):
        fm.backward_plan(2, 1 << 16, 1 << 15, 4, N_SM, True)


def _mirror_backward(x, g, p):
    """The kernel's walk in numpy: block t takes samples [t*tile, ...), sums
    column p % D of sample p / D over the fields in order, then writes
    element i as g[s] * (sums[s * D + i % D] - x[i]), s = i / (F * D)."""
    b, f, d = x.shape
    sample = f * d
    flat = x.reshape(-1).astype(np.float32)
    out = np.empty(b * sample, np.float32)
    for t in range(p.blocks):
        first = t * p.tile
        n = min(p.tile, b - first)
        src = flat[first * sample:(first + n) * sample]
        sums = np.zeros(n * d, np.float32)
        for q in range(n * d):
            for k in range(f):
                sums[q] += src[(q // d) * sample + q % d + k * d]
        i = np.arange(n * sample)
        out[first * sample + i] = g[first + i // sample] * (
            sums[(i // sample) * d + i % d] - src[i])
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape", [(1, 1, 1), (33, 13, 9), (77, 3, 7),
                                   (25, 39, 10)])
@pytest.mark.parametrize("aligned", [True, False])
def test_mirror_of_the_backward_walk_gives_the_plain_gradient(shape,
                                                              aligned):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[0]).astype(np.float32)
    p = fm.backward_plan(*shape, 4, N_SM, aligned)
    want = ref.fused_fm_backward(torch.tensor(x), torch.tensor(g)).numpy()
    np.testing.assert_allclose(_mirror_backward(x, g, p), want, rtol=1e-5,
                               atol=1e-5)
