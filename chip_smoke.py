#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batch query on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the probe kernels (``src/repro_torch/csrc/probe.cu``) with nvcc, then
runs two phases through ``FeatureClient(EngineBackend(MultiTableEngine))``:

* **A** — the paper's deployment (``configs/bili_feature_store.CONFIG``: 1 KB
  rows, hot fraction 0.1, LF 0.8, 4 GB shards), cut in item count only: a
  4M-key NeighborHash (80 MB on the card, above the 50 MB L2, so probes go
  to HBM and ``probe_lines`` runs) and a 200k-row embedding table.
* **B** — the ``bili-feature-store-smoke`` config: 20k keys in 256 KB
  shards, two shards of ~200 KB, so ``probe_smem`` runs.

Each phase sends 64 zipf-skewed batches of 4096 keys (10% absent), one
64-key delta midway, then a read-your-writes query.  Every grouped launch is
held bitwise against the plain PyTorch probe on the card, every answer
against the written data and the host ``HashTable.lookup_host_batch``, and
every batch against the version it reports.  Then each kernel is timed at
the shapes the main path gave it, beside its plain version, the RA gather
(one ``torch.index_select`` of the home line) and its bound.

Exits nonzero, printing no result, without a CUDA device or without the
repository around it.  The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch import api  # noqa: E402
from repro_torch.configs.bili_feature_store import CONFIG, SMOKE  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import hashcore as hc  # noqa: E402
from repro_torch.core import neighborhash as nh  # noqa: E402
from repro_torch.kernels import neighbor_lookup as nl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate, H100 SXM
OPS_PER_PROBE_STEP = 40        # hash / compare / decode: integer ops, rough
N_BATCHES, BATCH_KEYS, ABSENT = 64, 4096, 0.10
DELTA_KEYS = 64
ZIPF_A = 1.1
REPLACES = {"probe_lines": "src/repro/kernels/neighbor_lookup.py:235",
            "probe_smem": "src/repro/kernels/neighbor_lookup.py:106"}
SOURCE = "src/repro_torch/csrc/probe.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ---------------------------------------------------------------------------
# ground truth: the rows as written
# ---------------------------------------------------------------------------
class Truth:
    """Sorted keys -> payloads (scalar) and rows (embedding)."""

    def __init__(self, keys, payloads, emb_keys, emb_rows):
        o = np.argsort(keys)
        self.keys, self.payloads = keys[o].copy(), payloads[o].copy()
        o = np.argsort(emb_keys)
        self.emb_keys, self.emb_rows = emb_keys[o].copy(), emb_rows[o].copy()

    @staticmethod
    def _find(sorted_keys, q):
        i = np.clip(np.searchsorted(sorted_keys, q), 0, len(sorted_keys) - 1)
        return sorted_keys[i] == q, i

    def scalar(self, q):
        found, i = self._find(self.keys, q)
        return found, np.where(found, self.payloads[i], np.uint64(0))

    def emb(self, q):
        found, i = self._find(self.emb_keys, q)
        return found, self.emb_rows[i]

    def updated(self, k, p, rows) -> "Truth":
        t = Truth.__new__(Truth)
        t.keys, t.payloads = self.keys, self.payloads.copy()
        t.emb_keys, t.emb_rows = self.emb_keys, self.emb_rows.copy()
        _, i = self._find(t.keys, k)
        t.payloads[i] = p
        _, i = self._find(t.emb_keys, k)
        t.emb_rows[i] = rows
        return t


# ---------------------------------------------------------------------------
# every grouped launch the engine makes, kept to hold against the plain probe
# ---------------------------------------------------------------------------
class LaunchLog:
    """Wraps ``ops.probe_group`` while the main path runs and keeps each
    launch's inputs and outputs, checked after its batch."""

    def __init__(self):
        self.orig = ops.probe_group
        self.pending = []
        self.last = {}                  # kernel name -> last launch's inputs
        self.max_err = {"probe_lines": 0, "probe_smem": 0}

    def __enter__(self):
        ops.probe_group = self._record
        return self

    def __exit__(self, *exc):
        ops.probe_group = self.orig

    def _record(self, group, q_hi, q_lo, seg):
        before = dict(nl.launches)
        out = self.orig(group, q_hi, q_lo, seg)
        # the kernel this call launched, read off the wrappers' counts (none
        # in a rehearsal on the CPU, where the plain version ran)
        launched = [k for k in nl.launches if nl.launches[k] != before[k]]
        name = launched[0] if launched else "plain"
        self.pending.append((name, group, q_hi, q_lo, list(seg), out))
        return out

    def check_pending(self) -> None:
        """Plain probe on the same inputs, on the card: bitwise equal."""
        for name, group, q_hi, q_lo, seg, out in self.pending:
            want = ref.probe_group(group, q_hi, q_lo, seg)
            err = int((ref.u32(out) - ref.u32(want)).abs().max()) \
                if out.numel() else 0
            self.max_err[name] = max(self.max_err.get(name, 0), err)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                fail(f"{name} differs from the plain probe "
                     f"(max abs err {err})")
            self.last[name] = (group, q_hi, q_lo, seg)
        self.pending.clear()


class LayerClock:
    """Host-clock time spent in each layer below the client, summed over a
    phase: the engine's host half (``_stage``), its device half
    (``_launch``: copies and launches enqueued), the hybrid store's gather,
    and the wait for a batch's device work in ``finish``."""

    SPANS = ((eng.MultiTableEngine, "_stage", "stage"),
             (eng.MultiTableEngine, "_launch", "launch"),
             (eng.HybridKVStore, "get_batch", "store"),
             (torch.cuda.Event, "synchronize", "device_wait"))

    def __init__(self):
        self.seconds = dict.fromkeys([s[2] for s in self.SPANS], 0.0)
        self.orig = [getattr(cls, attr) for cls, attr, _ in self.SPANS]

    def __enter__(self):
        for (cls, attr, name), fn in zip(self.SPANS, self.orig):
            setattr(cls, attr, self._timed(fn, name))
        return self

    def __exit__(self, *exc):
        for (cls, attr, _), fn in zip(self.SPANS, self.orig):
            setattr(cls, attr, fn)

    def _timed(self, fn, name):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed


# ---------------------------------------------------------------------------
def zipf_keys(rng, keys, n):
    idx = (rng.zipf(ZIPF_A, n) - 1) % len(keys)
    q = keys[idx]
    absent = rng.random(n) < ABSENT
    q[absent] = rng.integers(2**63, 2**64 - 2, int(absent.sum()),
                             dtype=np.uint64)
    return q


def check_answer(res, q, truth, engine, version, what):
    if res.version != version:
        fail(f"{what}: answered from version {res.version}, "
             f"expected {version}")
    a, e = res["item_attr"], res["item_emb"]
    f, p = truth.scalar(q)
    if not (np.array_equal(a.found, f) and np.array_equal(a.payloads, p)):
        fail(f"{what}: item_attr differs from the written payloads")
    # the port's host probe over the very tables this version serves
    ok, v, build = engine.window.get(res.version)
    if not ok or v != res.version:
        fail(f"{what}: version {res.version} is not retained")
    owners = build.plan.shard_of_np(q)
    for s, tables in enumerate(build.shard_tables):
        m = owners == s
        hf, hp = tables[0].lookup_host_batch(q[m])
        if not (np.array_equal(a.found[m], hf)
                and np.array_equal(a.payloads[m], hp)):
            fail(f"{what}: item_attr differs from lookup_host_batch")
    f, rows = truth.emb(q)
    if not (np.array_equal(e.found, f)
            and np.array_equal(e.values[f], rows[f])):
        fail(f"{what}: item_emb differs from the rows as written")


def run_phase(name, *, n_items, emb_rows, value_bytes, max_shard_bytes,
              hot_fraction, load_factor, seed, device, log):
    """One phase of traffic through the client; returns its metrics."""
    rng = np.random.default_rng(seed)
    keys, payloads = nh.random_kv(n_items, seed=seed)
    emb_keys = keys[:emb_rows]
    rows = rng.integers(0, 256, (emb_rows, value_bytes), dtype=np.uint8)
    truth = Truth(keys, payloads, emb_keys, rows)

    t0 = time.perf_counter()
    engine = eng.MultiTableEngine(
        scalars=[eng.ScalarTable("item_attr", keys, payloads,
                                 load_factor=load_factor)],
        embeddings=[eng.EmbeddingTable("item_emb", emb_keys, rows,
                                       hot_fraction=hot_fraction)],
        max_shard_bytes=max_shard_bytes,
        buckets_per_line=hc.GPU_BUCKETS_PER_LINE, device=device)
    build_s = time.perf_counter() - t0
    build = engine.window.get(None)[2]
    print(f"[{name}] built {n_items} keys into {build.n_shards} shard(s) of "
          f"{[t[0].capacity for t in build.shard_tables]} buckets, "
          f"{emb_rows} x {value_bytes} B rows, in {build_s:.1f} s",
          flush=True)
    client = api.FeatureClient(api.EngineBackend(engine))

    lat, version, clock = [], 1, LayerClock()
    for b in range(N_BATCHES):
        if b == N_BATCHES // 2:
            k = keys[rng.choice(emb_rows, DELTA_KEYS, replace=False)]
            p = rng.integers(0, hc.PAYLOAD_MASK, DELTA_KEYS,
                             dtype=np.uint64)
            r = rng.integers(0, 256, (DELTA_KEYS, value_bytes),
                             dtype=np.uint8)
            client.update(2, upserts={"item_attr": (k, p),
                                      "item_emb": (k, r)})
            truth, version = truth.updated(k, p, r), 2
            res = client.query({"item_attr": k, "item_emb": k},
                               consistency=api.Consistency.min_version(2))
            log.check_pending()
            check_answer(res, k, truth, engine, 2, f"[{name}] read-your-"
                         "writes")
        q = zipf_keys(rng, keys, BATCH_KEYS)
        with clock:
            t0 = time.perf_counter()
            res = client.query({"item_attr": q, "item_emb": q})
            lat.append(time.perf_counter() - t0)
        log.check_pending()
        check_answer(res, q, truth, engine, version, f"[{name}] batch {b}")
    st = engine.stats
    lat_ms = np.array(lat) * 1e3
    m = {"phase": name, "batches": st.batches, "launches": st.launches,
         "launches_per_batch": st.launches / st.batches,
         "dedup_rate": round(st.dedup_rate, 4),
         "batch_p50_ms": float(np.percentile(lat_ms, 50)),
         "batch_p99_ms": float(np.percentile(lat_ms, 99)),
         "keys_per_s": BATCH_KEYS * 2 * len(lat) / float(np.sum(lat)),
         "build_s": build_s,
         "layer_ms_per_batch": {k: v * 1e3 / len(lat)
                                for k, v in clock.seconds.items()}}
    print(f"[{name}] " + json.dumps(m), flush=True)
    return engine, m


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, iters, flush):
    """Median device time of ``fn`` over ``iters`` calls, L2 flushed before
    each (a batch finds the lines it needs cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def host_ms(fn, iters):
    """Median host time of one call of ``fn``: what the wrapper costs the
    host to enqueue its launch, the card drained before each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def kernel_ms(fn, kernel, iters, flush):
    """Mean device time of the CUDA kernel whose name holds ``kernel``, from
    torch.profiler: the kernel alone, without the wrapper's host path that
    ``time_ms`` also sees while the card idles.  None (not measured) when
    the profiler cannot trace the card or records no device time for it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:                 # CUPTI unavailable
        print(f"kernel_ms for {kernel}: not measured ({e})", file=sys.stderr)
        return None
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0]
    if not hits:
        return None
    return sum(e.self_device_time_total for e in hits) / \
        sum(e.count for e in hits) / 1e3


def touched(host_tables, q_hi, q_lo, seg):
    """(distinct 128 B lines, bucket reads) of this launch's probes, from
    the host trace of the same tables."""
    keys = (ref.u32(q_hi).cpu().numpy().astype(np.uint64) << np.uint64(32)) \
        | ref.u32(q_lo).cpu().numpy().astype(np.uint64)
    n_lines = n_reads = 0
    for t, a, b in zip(host_tables, seg[:-1], seg[1:]):
        lines = set()
        for k in keys[a:b].tolist():
            visited = t.probe_trace(k)[2]
            n_reads += len(visited)
            lines.update(v // nl.BUCKETS_PER_LINE for v in visited)
        n_lines += len(lines)
    return n_lines, n_reads


def host_tables_of(group, engines):
    """The host tables behind a device group, in any retained version."""
    for e in engines:
        for v in e.versions:
            build = e.window.get(v)[2]
            for s, g in enumerate(build.groups):
                if g is group:
                    return build.shard_tables[s]
    fail("launch group not found in any retained build")


def ra_operands(group, q_hi, q_lo):
    """The paper's RA yardstick (``core/lookup.random_access``): one random
    read per key, of its home bucket's value word.  Returns the table as a
    flat int32 view, each query's word index there (hashed beforehand, out
    of the timed call) and the number of distinct home lines."""
    t = group.tables[0]
    home = hc.bucket_of_torch(ref.u32(q_hi), ref.u32(q_lo), t.home_capacity)
    bpl = nl.BUCKETS_PER_LINE
    word = (home // bpl) * (4 * bpl) + 2 * bpl + home % bpl    # val_hi
    return t.lines.view(torch.int32).reshape(-1), word, \
        int(torch.unique(home // bpl).numel())


def measure(name, launch, engines, log, flush):
    group, q_hi, q_lo, seg = launch
    n = q_hi.shape[0]
    host_tables = host_tables_of(group, engines)
    kernel = nl.probe_lines if name == "probe_lines" else nl.probe_smem
    qh = ops.pad_to(q_hi, ops.BLOCK_Q)
    ql = ops.pad_to(q_lo, ops.BLOCK_Q)
    ms = time_ms(lambda: kernel(group, qh, ql, seg), 50, flush)
    k_ms = kernel_ms(lambda: kernel(group, qh, ql, seg), f"{name}_kernel", 50,
                     flush)
    h_ms = host_ms(lambda: kernel(group, qh, ql, seg), 50)
    plain_ms = time_ms(lambda: ref.probe_group(group, q_hi, q_lo, seg), 5,
                       flush)
    flat, word, _ = ra_operands(group, q_hi, q_lo)
    library_ms = time_ms(lambda: torch.take(flat, word), 50, flush)
    lines, reads = touched(host_tables, q_hi, q_lo, seg)
    # each query read once, each output written once, each line touched
    # read once; hash + compares per bucket read on the integer units
    t_bytes = (n * (8 + 12) + lines * 128) / HBM_BYTES_PER_S * 1e3
    t_ops = reads * OPS_PER_PROBE_STEP / INT_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": None, "max_abs_err": log.max_err[name],
            "ms": ms, "kernel_ms": k_ms, "host_ms": h_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "queries": n, "lines_touched": lines, "bucket_reads": reads,
            "probe_over_ra": library_ms / ms}


def saturation(engine, flush, n, seed=7):
    """Probe vs RA throughput on phase A's table at a batch of ``n`` present
    keys, drawn uniformly (the paper's yardstick, at batches larger than the
    main path's)."""
    rng = np.random.default_rng(seed)
    build = engine.window.get(None)[2]
    group, host = build.groups[0], build.shard_tables[0][0]
    keys, _ = host.items_arrays()
    qh, ql = hc.key_split_np(keys[rng.integers(0, len(keys), n)])
    q_hi, q_lo = nl.to_device(qh, "cuda"), nl.to_device(ql, "cuda")
    ms = time_ms(lambda: nl.probe_lines(group, q_hi, q_lo, [0, n]), 20,
                 flush)
    flat, word, lines = ra_operands(group, q_hi, q_lo)
    ra_ms = time_ms(lambda: torch.take(flat, word), 20, flush)
    # home lines only: a lower bound on the lines the probes read
    bound_ms = (n * (8 + 12) + lines * 128) / HBM_BYTES_PER_S * 1e3
    return {"queries": n, "probe_ms": ms, "ra_ms": ra_ms,
            "probe_mkeys_per_s": n / ms / 1e3,
            "ra_mkeys_per_s": n / ra_ms / 1e3, "probe_over_ra": ra_ms / ms,
            "home_lines": lines, "bound_ms": bound_ms}


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    so = nl.build_library()
    print(f"built {os.path.relpath(so)} from {SOURCE} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(so + ".log") as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas: " + line.strip())

    n_a, emb_a = 4_000_000, 200_000
    print(f"reduced: n_items {CONFIG.n_items}->{n_a} (the host builder "
          f"inserts one key at a time, ~28 us a key)")
    print(f"reduced: emb rows {CONFIG.n_items}->{emb_a} (the embedding "
          f"store is host memory and memmap only)")

    for k in nl.launches:
        nl.launches[k] = 0
    with LaunchLog() as log:
        eng_b, m_b = run_phase(
            "B", n_items=SMOKE.n_items, emb_rows=SMOKE.n_items,
            value_bytes=SMOKE.value_bytes,
            max_shard_bytes=SMOKE.max_shard_bytes,
            hot_fraction=SMOKE.hot_fraction, load_factor=SMOKE.load_factor,
            seed=1, device=device, log=log)
        eng_a, m_a = run_phase(
            "A", n_items=n_a, emb_rows=emb_a, value_bytes=CONFIG.value_bytes,
            max_shard_bytes=CONFIG.max_shard_bytes,
            hot_fraction=CONFIG.hot_fraction, load_factor=CONFIG.load_factor,
            seed=2, device=device, log=log)
    counts = dict(nl.launches)
    print("launches on the main path: " + json.dumps(counts), flush=True)
    for k, c in counts.items():
        if c == 0:
            fail(f"{k} was not launched on the main path")
    if counts["probe_lines"] != m_a["launches"] \
            or counts["probe_smem"] != m_b["launches"]:
        fail(f"kernel launches {counts} disagree with the engines' counts "
             f"A={m_a['launches']} B={m_b['launches']}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    kernels = []
    for name in ("probe_lines", "probe_smem"):
        row = measure(name, log.last[name], (eng_a, eng_b), log, flush)
        row["launches"] = counts[name]
        kernels.append(row)
    # the same small group through the device-memory kernel, for contrast
    group, q_hi, q_lo, seg = log.last["probe_smem"]
    qh, ql = ops.pad_to(q_hi, ops.BLOCK_Q), ops.pad_to(q_lo, ops.BLOCK_Q)
    contrast = {"ms": time_ms(lambda: nl.probe_lines(group, qh, ql, seg), 50,
                              flush),
                "kernel_ms": kernel_ms(
                    lambda: nl.probe_lines(group, qh, ql, seg),
                    "probe_lines_kernel", 50, flush),
                "host_ms": host_ms(lambda: nl.probe_lines(group, qh, ql, seg),
                                   50)}
    print("phase B group through probe_lines: " + json.dumps(contrast))
    for n in (1 << 16, 1 << 20):
        print("probe_saturation " + json.dumps(saturation(eng_a, flush, n)),
              flush=True)

    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
