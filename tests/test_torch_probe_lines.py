"""The lane arithmetic of ``probe_lines`` (no card needed), mirrored in
numpy from ``LineGroupTable`` in csrc/probe.cu, and the rule that picks its
lanes a query (``neighbor_lookup.lines_lanes``).

A query's group of 8 lanes reads a 128 B line as 8 x 16 B: lane j holds
words 4j .. 4j+3 of the line's ``[4, 8]`` layout, and bucket c of the line
is assembled from lane 2r + c // 4, word c % 4 for each row r (key_hi,
key_lo, val_hi, val_lo).  Over the line-packed tables of every variant, sparse
and dense, this must give back
every bucket as built (empty past the capacity), and the probe run on that
assembly, loading a line only when a step leaves the line held, must answer
bitwise as the plain probe (``kernels/ref.probe_group``), with the lodger
check, ``max_probes``, the inline offsets or ``next_idx``, and clipped
reads."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng
from repro_torch.core import hashcore as hc
from repro_torch.core import neighborhash as nh
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ref

CPU = torch.device("cpu")
BPL = nl.BUCKETS_PER_LINE
LINE_WORDS = 4 * BPL


def _built(variant, n=3000, seed=17, lf=0.8):
    keys, payloads = nh.random_kv(n, seed=seed)
    return keys, nh.build(keys, payloads, variant=variant, load_factor=lf)


def _lanes(table: nl.DeviceTable, line: int) -> np.ndarray:
    """uint32 [8, 4]: the 16 B each lane of a group loads of ``line``."""
    words = table.lines.view(torch.int32).numpy().view(np.uint32)
    return words[line].reshape(nl.LINE_LANES, LINE_WORDS // nl.LINE_LANES)


def _assemble(held: np.ndarray, c: int) -> tuple[int, int, int, int]:
    """LineGroupTable::bucket: every lane picks its word c % 4, and row r's
    word comes by a shuffle from lane 2r + c // 4."""
    mine = held[:, c % 4]
    return tuple(int(mine[2 * r + c // 4]) for r in range(4))


@pytest.mark.parametrize("lf", [0.5, 0.95])
@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_lane_words_assemble_every_bucket(variant, lf):
    _, t = _built(variant, lf=lf)
    d = eng._device_table(t, CPU)
    cap = t.capacity
    want = np.stack([t.key_hi, t.key_lo, t.val_hi, t.val_lo], axis=1)
    n_lines = d.lines.shape[0]
    assert n_lines * BPL >= cap > (n_lines - 1) * BPL
    for line in range(n_lines):
        held = _lanes(d, line)
        for c in range(BPL):
            b = line * BPL + c
            got = _assemble(held, c)
            if b < cap:
                assert got == tuple(int(x) for x in want[b])
            else:                            # past the capacity: empty
                assert got[:2] == (hc.EMPTY_HI, hc.EMPTY_LO)


def _clip(i, cap):
    return min(max(i, 0), cap - 1)


def _group_probe(d: nl.DeviceTable, qh: int, ql: int):
    """probe_one(LineGroupTable<8>) for one query -> ((found, p_hi, p_lo),
    lines loaded, chain steps, chain steps that stayed in the line)."""
    nxt = None if d.next_idx is None else d.next_idx.numpy()
    held, words, loads = [-1], [None], [0]

    def bucket(b):
        if b // BPL != held[0]:                  # another line: one load
            held[0] = b // BPL
            words[0] = _lanes(d, b // BPL)
            loads[0] += 1
        return _assemble(words[0], b % BPL)

    cap = d.capacity
    home = hc.bucket_of_int(qh, ql, d.home_capacity)
    khi, klo, vhi, vlo = bucket(_clip(home, cap))
    empty = khi == hc.EMPTY_HI and klo == hc.EMPTY_LO
    hit = not empty and (khi, klo) == (qh, ql)
    active = not empty and not hit
    if active and d.host_check:
        active = hc.bucket_of_int(khi, klo, d.home_capacity) == home
    idx, steps, in_line = home, 0, 0
    while active and steps < d.max_probes:
        if nxt is None:
            off = hc.decode_offset_int(vhi >> hc.PAYLOAD_HI_BITS)
            if off == 0:
                break
            new = idx + off
        else:
            new = int(nxt[_clip(idx, cap)])
            if new < 0:
                break
        in_line += _clip(new, cap) // BPL == held[0]
        idx, steps = new, steps + 1
        khi, klo, vhi, vlo = bucket(_clip(idx, cap))
        hit = (khi, klo) == (qh, ql)
        active = not hit
    answer = (1, vhi & hc.PAYLOAD_HI_MASK, vlo) if hit else (0, 0, 0)
    return answer, loads[0], steps, in_line


def _queries(keys, t, n, seed):
    """Present keys, absent keys, and absent keys whose home bucket holds a
    lodger (a resident homed elsewhere)."""
    rng = np.random.default_rng(seed)
    absent = rng.integers(2**62, 2**63, 20 * n).astype(np.uint64)
    hi, lo = hc.key_split_np(absent)
    home = hc.bucket_of_np(hi, lo, t.home_capacity)
    rk_hi, rk_lo = t.key_hi[home], t.key_lo[home]
    occupied = ~((rk_hi == hc.EMPTY_HI) & (rk_lo == hc.EMPTY_LO))
    lodger = occupied & (hc.bucket_of_np(rk_hi, rk_lo, t.home_capacity)
                         != home)
    return np.concatenate([keys[rng.integers(0, len(keys), n)], absent[:n],
                           absent[lodger][:n]])


def _check(d, q):
    qh, ql = hc.key_split_np(q)
    want = ref.probe_group(nl.TableGroup([d]), nl.to_device(qh, CPU),
                           nl.to_device(ql, CPU), [0, len(q)])
    want = ref.u32(want).numpy()
    totals = np.zeros(3, int)
    for i, (h, lo) in enumerate(zip(qh.tolist(), ql.tolist())):
        answer, loads, steps, in_line = _group_probe(d, h, lo)
        assert answer == tuple(int(x) for x in want[:, i]), f"query {i}"
        assert loads == 1 + steps - in_line     # an in-line step loads nothing
        totals += (loads, steps, in_line)
    return totals


@pytest.mark.parametrize("variant", nh.VARIANTS)
def test_group_probe_matches_plain_with_in_line_steps(variant):
    keys, t = _built(variant, lf=0.95)
    d = eng._device_table(t, CPU)
    loads, steps, in_line = _check(d, _queries(keys, t, 300, seed=1))
    if variant == "linear":           # its device next_idx ends every chain
        assert steps == 0 and loads == 900
    else:
        assert 0 <= in_line < steps and loads == 900 + steps - in_line
    if variant == "neighborhash":     # chains kept in the home's line
        assert in_line > 0


@pytest.mark.parametrize("max_probes", [0, 1, 2])
@pytest.mark.parametrize("variant", ["neighborhash", "coalesced", "linear"])
def test_group_probe_max_probes_cuts_chains(variant, max_probes):
    """A chain cut after max_probes steps, in the line or out of it."""
    keys, t = _built(variant, lf=0.95)
    full = eng._device_table(t, CPU)
    d = nl.DeviceTable(full.lines, full.next_idx, full.capacity,
                       full.home_capacity, full.host_check, max_probes)
    _, steps, _ = _check(d, _queries(keys, t, 300, seed=2))
    assert steps <= 900 * max_probes


def test_group_probe_reaches_the_last_line():
    """Keys homed in the table's last line, whose capacity it may not fill:
    reads past the capacity clip into it."""
    keys, t = _built("neighborhash", n=2000, seed=4)
    d = eng._device_table(t, CPU)
    hi, lo = hc.key_split_np(keys)
    last = (d.lines.shape[0] - 1) * BPL
    homed = keys[hc.bucket_of_np(hi, lo, t.home_capacity) >= last]
    assert len(homed) > 0
    _check(d, homed)


@pytest.mark.parametrize("n,lanes", [(1, 8), (2560, 8), (20480, 8),
                                     (21120, 8), (21121, 1), (24576, 1),
                                     (65536, 1), (1 << 20, 1)])
def test_lines_lanes_by_the_batch(n, lanes):
    """8 lanes a query while the batch's groups fill at most 5/8 of an
    H100's resident threads (132 SMs x 2048), one thread a query past
    that: the two forms crossed between 20,480 and 24,576 queries."""
    assert nl.lines_lanes(n, 132, 2048) == lanes
