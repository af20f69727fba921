#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batch query on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the kernels (``src/repro_torch/csrc/probe.cu``, ``fused_fm.cu`` and
``embedding_bag.cu``) with nvcc, one process per library, all started
together, then runs thirteen phases.  Two send batch queries through
``FeatureClient(EngineBackend(MultiTableEngine))``:

* **A** — the paper's deployment (``configs/bili_feature_store.CONFIG``: 1 KB
  rows, hot fraction 0.1, LF 0.8, 4 GB shards), cut in item count only: a
  4M-key NeighborHash (80 MB on the card, above the 50 MB L2, so probes go
  to HBM and ``probe_lines`` runs) and a 200k-row embedding table.
* **B** — the ``bili-feature-store-smoke`` config: 20k keys in 256 KB
  shards, two shards of ~200 KB, so ``probe_smem`` runs.

Each sends 64 zipf-skewed batches of 4096 keys (10% absent), one 64-key
delta midway, then a read-your-writes query.  Every grouped launch is held
bitwise against the plain PyTorch probe on the card, every answer against
the written data and the host ``HashTable.lookup_host_batch``, and every
batch against the version it reports.

* **C** — DeepFM CTR serving (``configs/deepfm.CONFIG``, full published
  width: a 1.56 GB field table on the card) behind the launcher's feature
  engine in the deployment's 4 GB shards, through
  ``serve_step.recsys_score_fn``: 64 requests of 512 rows after one
  warm-up, an ``item_pop`` delta after request 32, one ``min_version(2)``
  request, then one more request traced by ``torch.profiler`` for the
  card's busy share.  Every ``fused_fm`` launch is held against the plain
  FM on the same tensor, every request's probabilities against the same
  model with the plain FM, and the spliced features against the rows as
  written.
* **I** — right after C, on C's model and feature engine: DeepFM behind
  the ported ``QueryServer`` (``BatchPolicy(max_batch_keys=4096)``, a
  ``Tracer`` sampling every request), as the launcher's
  ``--feature-server`` mode drives it: after one warm-up, 8 scoring client
  threads of 16 requests of 512 rows (drawn as C draws them) through
  ``recsys_score_fn(feature_server=...)``, 2 PREFETCH threads, and an
  ``item_pop`` delta (the next version, the 64 hottest items) published
  once 16 requests are answered.  Every probe and ``fused_fm`` launch is
  held against its plain version, every request as C holds its requests
  against the rows written at the version its response names, and every
  traced request's micro-batch must name one version, both versions
  served.  It reports each lane's p50/p99 and sheds, requests and launches
  a micro-batch, the keys eliminated before the card, the median of each
  span of the server's chain, and beside them phase C's single-client p50
  and the same 8 clients through ``FeatureClient(EngineBackend(engine))``
  with no server (timed per request by wall clock; not counted as the
  main path's launches).
* **D** — two-tower user-tower serving (``configs/two_tower_retrieval.
  CONFIG``, full published width: 30.8 GB of tables on the card) as the
  ``serve_p99`` cell serves it, through ``serve_step.recsys_score_fn`` with
  no feature source: one warm-up and 64 timed requests of 512 rows, then one
  more traced.  Every ``embedding_bag`` launch is held against the plain
  bag lookup on the same tensors, every request's user vectors against the
  same model with the plain bag lookup, and their norms against 1.

* **E** — DeepFM's ``retrieval_cand`` cell (``configs/deepfm.CONFIG``,
  after C's model is freed): one warm-up and 16 timed requests, each
  1,000,000 candidate rows from ``synthetic.recsys_batch`` ranked through
  ``serve_step.bulk_rank_fn`` (one ``fused_fm`` launch at
  [1,000,000, 39, 10] a request), then one more traced.
* **F** — two-tower's ``retrieval_cand`` cell on D's model: one warm-up and
  16 timed requests, each one user against 1,000,000 zipf candidates
  through ``serve_step.retrieval_fn`` (the item tower over every candidate,
  one ``embedding_bag`` launch at [1, 50]), then one more traced.

E and F hold each kernel launch against its plain version, and each
request's top 100 against the same model with the plain FM or bag on the
same device batch: values within 1e-5, every returned value its index's
score, the order ``jax.lax.top_k``'s on the card's own scores (equal
scores by ascending index), and the two lists equal but where neighbouring
scores lie within 1e-5.  F also says whether repeated (item, category)
candidates got bitwise-equal scores, and E splits its upload into the host
concatenation of the columns and the pageable copy to the card.

* **G** — DIN serving (``configs/din.CONFIG``, full published width:
  7.2 GB of tables) and **H** — BST serving (``configs/bst.CONFIG``:
  12.8 GB), after F's model is freed, one model at a time, each through
  the launcher's ``cell_requests`` (``serve_step.recsys_score_fn``, no
  feature source, as the JAX cell): ``serve_p99`` (a warm-up, 64 timed
  requests of 512 rows, one traced) and ``serve_bulk`` (a warm-up, 8 timed
  requests of 262,144 rows, one traced), every request drawn before the
  first is timed.  Neither model reaches a kernel: any launch of the four
  fails the run.  Every request's probabilities are held within 1e-5 of a
  float64 recompute on the card written here from the model's tensors
  (every row at ``serve_p99``, 4,096 fixed rows at ``serve_bulk``).

* **J** — DeepFM training (``configs/deepfm.CONFIG``, full published
  width, its own model from seed 0, after E's is freed) on the
  ``train_batch`` cell's 65,536 rows, batches drawn and uploaded first:
  the dense step (``make_train_step(recsys_loss_fn)``, what the JAX cell
  builder runs) for a warm-up and 8 timed steps, then the sparse step
  (``make_sparse_recsys_train_step``) the same from the same initial
  parameters.  Every ``fused_fm`` and ``fused_fm_backward`` launch is held
  against its plain version on the same tensors, and the first step is
  taken again with the plain FM (loss within 1e-5, parameters within
  1e-5 but where Adam's step is ill-conditioned).  The dense run is also
  the incremental loop of ``examples/train_recsys.py``: every 4 steps the
  touched rows of field 0 go into a ``MultiTableEngine`` (a seed
  ``publish``, then ``publish_delta``) and 256 of them read back bitwise
  at the new version; a checkpoint after step 4 restores bitwise and
  gives step 5 again, bitwise; one step is traced for the card's busy
  share and top kernels.

* **K** — the streaming online-learning loop, after H.  **K.1**: DIN
  training (``configs/din.CONFIG``, full published width: a 7.2 GB item
  table) on the ``train_batch`` cell's 65,536 rows through the dense step
  ``launch/train.py`` builds: a warm-up, 8 timed steps and one traced; the
  first step's logits on 4,096 fixed rows held within 1e-5 of a float64
  recompute, every loss and ``grad_norm`` finite.  **K.2**: the realtime
  launcher's ``drive`` (``launch/realtime.py``) with DIN at published width
  but ``item_vocab`` = 10,000 items (10,000 users; 4 clients x 200
  sessions; the JAX loop's other defaults; ``--trace-sample 0.05``), its
  exporter scraped once mid-run (the freshness histogram must hold
  samples), the card traced over a 2 s window; then ``drive``'s own rules
  (no ``min_version`` violation, no served-version regression, no stage
  error, deltas and queries both non-zero), at least one full publish,
  and every item row at the final version bitwise the bytes of the last
  publish, delta or full, that wrote it (a host shadow kept in version
  order by a wrapper around the client's ``update``).  Neither part may
  launch one of the four kernels.

* **L** — BST training (``configs/bst.CONFIG``: a 12.8 GB item table) on
  ``train_batch``, after K: the dense step ``launch/train.py`` builds at
  the first item_vocab of ``L_VOCABS`` that fits the card (the published
  100M first; a cut is printed), then the sparse step at 100M.  Each
  from seed 0 on 10 batches drawn and uploaded first: a warm-up, 8 timed
  steps and one traced; the dense step's first logits on 4,096 fixed
  rows within 1e-5 of a float64 recompute, every loss and ``grad_norm``
  finite, no kernel launched.
* **M** — two-tower training (``configs/two_tower_retrieval.CONFIG``
  widths).  **M.1**: the dense step, its history bag through
  ``EmbeddingBag`` (one ``embedding_bag`` and one
  ``embedding_bag_backward`` launch a step), at 8M users and 4M items,
  both halved until the warm-up's peak memory stays under 72 GB (the cut
  printed); every backward launch held element by element against the
  plain gradient on the same tensors within 2 n 2^-24 S + 1e-30 (n the
  terms a row adds, S their magnitudes' sum), the first step's loss
  within 1e-5 of the same step's with the plain bag.  **M.2**: the
  sparse step at the published 20M users and 10M items (30.8 GB), no
  kernel.  Both run L's steps and checks.

Then each kernel is timed at the shapes the main path gave it (and the bulk
kernels at the ``serve_bulk`` batch of 262,144 rows), beside its plain
version, a library call where one computes the same function (the RA
gather, ``torch.take`` of the home value word, for the probe;
``F.embedding_bag`` for the bag; none for the FM term or its gradient)
and its bound; ``fused_fm`` also at J's [65536, 39, 10], and
``fused_fm_backward`` there; ``embedding_bag_backward`` at M.1's last
launch, its [V, D] zero-fill timed apart, beside ``torch.autograd.grad``
of ``F.embedding_bag`` (mean, with a padding row).
Phase B's last group also goes through ``probe_lines`` for contrast, with
the ratio of the two kernels' times; the redesigned kernels' constants get a
line each: ``probe_smem``'s cluster and bytes a block; ``fused_fm``'s tile,
stages and share of main-path launches on the bulk-copy branch;
``probe_lines``'s main-path launches by lanes a query, its kernel time with
1 and 8 lanes a query (each form held against the plain probe), and the
share of phase A's chain steps that stay in the line they left (from the
host trace); ``embedding_bag``'s stages and share of launches on the staged
branch.  ``probe_saturation`` lines time ``probe_lines`` (the wrapper's pick
and each form) against the RA gather at ``SATURATION_BATCHES`` present keys,
every form's answers held against the host table's items.

Exits nonzero, printing no result, without a CUDA device or without the
repository around it.  The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch import api  # noqa: E402
from repro_torch.configs import (bst, deepfm, din, registry,  # noqa: E402
                                 two_tower_retrieval)
from repro_torch.configs.bili_feature_store import CONFIG, SMOKE  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import hashcore as hc  # noqa: E402
from repro_torch.core import neighborhash as nh  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import embedding_bag as bagk  # noqa: E402
from repro_torch.kernels import fused_fm as fm  # noqa: E402
from repro_torch.kernels import neighbor_lookup as nl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import realtime  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import embedding_service as es  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.obs import exporter  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.serve.scheduler import BatchPolicy  # noqa: E402
from repro_torch.serve.server import QueryServer  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate, H100 SXM
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores, H100 SXM
OPS_PER_PROBE_STEP = 40        # hash / compare / decode: integer ops, rough
N_BATCHES, BATCH_KEYS, ABSENT = 64, 4096, 0.10
DELTA_KEYS = 64
ZIPF_A = 1.1
# phase C: DeepFM serving
C_ITEMS, C_REQUESTS, C_ROWS, C_ABSENT = 200_000, 64, 512, 0.10
# phase I: C's DeepFM and engine behind the QueryServer, concurrent clients
I_CLIENTS, I_REQUESTS, I_PREFETCH = 8, 16, 2
I_SETTLED = 16                 # requests answered before the delta goes out
SPAN_NAMES = ("serve", "admission", "lane_wait", "coalesce", "version_pin",
              "begin", "device", "finish", "scatter")
FM_TOL = 1e-5                  # kernel vs plain FM, both fp32 sums
FM_BULK = (262_144, 39, 10)    # the serve_bulk cell's batch, DeepFM widths
# probe_saturation's batches: the paper's yardstick at 2^16 and 2^20 keys,
# and batches on both sides of where lines_lanes leaves 8 lanes a query
# (21,120 on an H100), where its two forms were measured to cross
SATURATION_BATCHES = (1 << 14, 20_480, 21_120, 21_121, 24_576, 1 << 15,
                      1 << 16, 1 << 20)
# phase D: two-tower user-tower serving
D_REQUESTS, D_ROWS = 64, 512   # the serve_p99 cell's batch
BAG_TOL = 1e-5                 # kernel vs plain bag, both fp32 sums
BAG_BULK_ROWS = 262_144        # the serve_bulk cell's batch
BAG_CHECK_ROWS = 8192          # bags a plain lookup holds a launch to
# phases E and F: the retrieval_cand cell (1 user, 1M candidates, top 100)
R_CANDIDATES, R_REQUESTS, TOP_K = 1_000_000, 16, 100
TOP_K_TOL = 1e-5               # kernel path vs plain path, fp32 scores
# phases G and H: DIN and BST serving, the serve_p99 and serve_bulk cells
SEQ_P99_ROWS, SEQ_P99_REQUESTS = 512, 64
SEQ_BULK_ROWS, SEQ_BULK_REQUESTS = 262_144, 8
SEQ_CHECK_ROWS = 4096          # fixed rows of each serve_bulk request
SEQ_TOL = 1e-5                 # fp32 model vs float64 recompute, probs
# phase J: DeepFM training, the train_batch cell
J_ROWS = 65_536                # registry.REC_CELLS' train_batch
J_STEPS = 8                    # timed steps of each train step
J_PUBLISH_EVERY = 4            # steps between publishes to the engine
J_CKPT_STEP = 4                # the checkpoint's step
J_READBACK = 256               # published rows read back at each version
J_TOL = 1e-5                   # a step's loss: FM kernels vs plain FM
J_GRAD_TOL = 1e-5              # FM gradient kernel vs plain, x max |g|
# phase K: the streaming online-learning loop (DIN trained on the card)
K_CHECK_ROWS = 4096            # K.1: fixed rows of the first step's logits
K_ITEMS, K_USERS = 10_000, 10_000    # K.2: items (= item_vocab), users
K_REQUESTS = 200               # K.2: sessions a client
K_TRACE_SAMPLE = 0.05          # K.2: --trace-sample
K_SCRAPE_AFTER = 20            # K.2: deltas published before the scrape
K_WINDOW_S = 2.0               # K.2: the traced window of the loop
# phase L: BST training; the dense step's item_vocab, cut to the first that
# fits the card where the published 100M does not
L_VOCABS = (100_000_000, 90_000_000, 80_000_000, 70_000_000, 60_000_000,
            50_000_000)
# phase M: two-tower training; M.1's (users, items) start here and are
# halved together until the first step's peak stays under M_PEAK_BYTES
M_VOCABS = (8_000_000, 4_000_000)
M_MIN_ITEMS = 250_000
M_PEAK_BYTES = 72 * 10**9
BAG_GRAD_U = 2.0 ** -24        # fp32's unit roundoff: the atomics' bound
BAG_GRAD_REL = 1e-4            # ... at most this share of S (hot rows)
SOFTMAX_SHAPES = ((8, 32), (4096, 256), (32_768, 256), (65_536, 256))
#   (B, D) of the in-batch softmax: SMOKE's, one chunk, train_batch's
SOFTMAX_GRAD_TAIL = 5          # x sqrt(D) 2^-24 / T: see softmax_timing
REPLACES = {"probe_lines": "src/repro/kernels/neighbor_lookup.py:235",
            "probe_smem": "src/repro/kernels/neighbor_lookup.py:106",
            "fused_fm": "src/repro/kernels/fused_fm.py:31",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:79",
            "fused_fm_backward": "src/repro/kernels/fused_fm.py:31",
            "embedding_bag_backward": "src/repro/kernels/embedding_bag.py:79"}
LIBRARIES = {"probe": "src/repro_torch/csrc/probe.cu",
             "fused_fm": "src/repro_torch/csrc/fused_fm.cu",
             "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu"}
SOURCE = {"probe_lines": LIBRARIES["probe"],
          "probe_smem": LIBRARIES["probe"],
          "fused_fm": LIBRARIES["fused_fm"],
          "fused_fm_backward": LIBRARIES["fused_fm"],
          "embedding_bag": LIBRARIES["embedding_bag"],
          "embedding_bag_backward": LIBRARIES["embedding_bag"]}


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
    """Host-clock time spent in each layer, summed over a phase: by default
    the layers below the client — the engine's host half (``_stage``), its
    device half (``_launch``: copies and launches enqueued), the hybrid
    store's gather, and the wait for a batch's device work in ``finish``.
    ``spans`` names other (owner, attribute, layer) triples; several may
    add to one layer."""

    SPANS = ((eng.MultiTableEngine, "_stage", "stage"),
             (eng.MultiTableEngine, "_launch", "launch"),
             (eng.HybridKVStore, "get_batch", "store"),
             (torch.cuda.Event, "synchronize", "device_wait"))

    def __init__(self, spans=SPANS):
        self.spans = spans
        self.seconds = dict.fromkeys([s[2] for s in spans], 0.0)
        self.orig = [getattr(cls, attr) for cls, attr, _ in spans]

    def __enter__(self):
        for (cls, attr, name), fn in zip(self.spans, self.orig):
            setattr(cls, attr, self._timed(fn, name))
        return self

    def __exit__(self, *exc):
        for (cls, attr, _), fn in zip(self.spans, self.orig):
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
    the profiler cannot trace the card or records no device time for it in
    two traces (a trace now and then comes back without device times)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        try:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(iters):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:             # CUPTI unavailable
            print(f"kernel_ms for {kernel}: not measured ({e})",
                  file=sys.stderr)
            return None
        hits = [e for e in prof.key_averages()
                if kernel in e.key and e.self_device_time_total > 0]
        if hits:
            return sum(e.self_device_time_total for e in hits) / \
                sum(e.count for e in hits) / 1e3
    return None


def touched(host_tables, q_hi, q_lo, seg):
    """(distinct 128 B lines, bucket reads, chain steps, chain steps to a
    bucket of the line the step left) of this launch's probes, from the
    host trace of the same tables."""
    keys = (ref.u32(q_hi).cpu().numpy().astype(np.uint64) << np.uint64(32)) \
        | ref.u32(q_lo).cpu().numpy().astype(np.uint64)
    n_lines = n_reads = steps = in_line = 0
    for t, a, b in zip(host_tables, seg[:-1], seg[1:]):
        lines = set()
        for k in keys[a:b].tolist():
            visited = t.probe_trace(k)[2]
            n_reads += len(visited)
            line = [v // nl.BUCKETS_PER_LINE for v in visited]
            lines.update(line)
            steps += len(line) - 1
            in_line += sum(x == y for x, y in zip(line, line[1:]))
        n_lines += len(lines)
    return n_lines, n_reads, steps, in_line


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
    lines, reads, steps, in_line = touched(host_tables, q_hi, q_lo, seg)
    # each query read once, each output written once, each line touched
    # read once; hash + compares per bucket read on the integer units
    t_bytes = (n * (8 + 12) + lines * 128) / HBM_BYTES_PER_S * 1e3
    t_ops = reads * OPS_PER_PROBE_STEP / INT_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": None, "max_abs_err": log.max_err[name],
            "ms": ms, "kernel_ms": k_ms, "host_ms": h_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "queries": n, "lines_touched": lines, "bucket_reads": reads,
            "chain_steps": steps, "in_line_steps": in_line,
            "probe_over_ra": library_ms / ms}


def lanes_ms(group, q_hi, q_lo, seg, want, flush, iters):
    """probe_lines's kernel time with each count of lanes a query the
    kernel has (1 and 8), the wrapper's pick (``nl.lines_lanes``) forced to
    each in turn; each form's answer first held bitwise against ``want``."""
    row, pick = {}, nl.lines_lanes
    try:
        for lanes in nl.lanes_launches:
            nl.lines_lanes = lambda n, n_sm, threads, lanes=lanes: lanes

            def probe():
                return nl.probe_lines(group, q_hi, q_lo, seg)
            if not torch.equal(probe().view(torch.int32),
                               want.view(torch.int32)):
                fail(f"probe_lines with {lanes} lanes a query differs")
            row[lanes] = kernel_ms(probe, "probe_lines_kernel", iters, flush)
    finally:
        nl.lines_lanes = pick
    return row


def saturation(engine, flush, n, seed=7):
    """Probe vs RA throughput on phase A's table at a batch of ``n`` present
    keys, drawn uniformly (the paper's yardstick, at batches larger than the
    main path's); every answer, of the wrapper's pick and of each count of
    lanes, is held against the host table's items."""
    rng = np.random.default_rng(seed)
    build = engine.window.get(None)[2]
    group, host = build.groups[0], build.shard_tables[0][0]
    keys, payloads = host.items_arrays()
    pick = rng.integers(0, len(keys), n)
    qh, ql = hc.key_split_np(keys[pick])
    q_hi, q_lo = nl.to_device(qh, "cuda"), nl.to_device(ql, "cuda")
    items = payloads[pick]
    want = torch.from_numpy(np.stack([
        np.ones(n, np.uint32), (items >> np.uint64(32)).astype(np.uint32),
        (items & np.uint64(0xFFFFFFFF)).astype(np.uint32)]).view(
            np.int32)).cuda()

    def probe():
        return nl.probe_lines(group, q_hi, q_lo, [0, n])

    before = dict(nl.lanes_launches)
    answer = probe().view(torch.int32)
    lanes = [k for k in nl.lanes_launches if nl.lanes_launches[k] != before[k]]
    if not bool((answer[0] == 1).all()):
        fail(f"probe_saturation at {n} keys: {int((answer[0] != 1).sum())} "
             "present keys not found")
    if not torch.equal(answer, want):
        fail(f"probe_saturation at {n} keys: payloads differ from the host "
             "table's")
    ms = time_ms(probe, 20, flush)
    k_ms = kernel_ms(probe, "probe_lines_kernel", 20, flush)
    flat, word, lines = ra_operands(group, q_hi, q_lo)
    ra_ms = time_ms(lambda: torch.take(flat, word), 20, flush)
    # home lines only: a lower bound on the lines the probes read
    bound_ms = (n * (8 + 12) + lines * 128) / HBM_BYTES_PER_S * 1e3
    return {"queries": n, "checked": True, "lanes": lanes[0],
            "probe_ms": ms, "probe_kernel_ms": k_ms,
            "kernel_ms_by_lanes": lanes_ms(group, q_hi, q_lo, [0, n], want,
                                           flush, 20),
            "ra_ms": ra_ms,
            "probe_mkeys_per_s": n / ms / 1e3,
            "ra_mkeys_per_s": n / ra_ms / 1e3, "probe_over_ra": ra_ms / ms,
            "home_lines": lines, "bound_ms": bound_ms}


# ---------------------------------------------------------------------------
# phase C: DeepFM CTR serving behind the FeatureClient
# ---------------------------------------------------------------------------
class Recorder:
    """Wraps ``owner.<attr>`` while the block runs and keeps each call's
    arguments and result, held after its request or step by
    ``check_pending``, which calls ``check(args, kw, out)`` on each (under
    ``no_grad``) and keeps the last call's arguments, detached, in
    ``last``."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.orig = getattr(owner, attr)
        self.pending = []
        self.last = None
        self.max_err = 0.0
        self.checked = 0

    def __enter__(self):
        setattr(self.owner, self.attr, self._record)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)

    def _record(self, *args, **kw):
        out = self.orig(*args, **kw)
        self.pending.append((args, kw, out))
        return out

    def check_pending(self) -> None:
        with torch.no_grad():
            for args, kw, out in self.pending:
                self.check(args, kw, out)
                self.last = tuple(a.detach() if isinstance(a, torch.Tensor)
                                  else a for a in args)
                self.checked += 1
        self.pending.clear()

    def check(self, args, kw, out) -> None:
        raise NotImplementedError


class OpLog(Recorder):
    """Every call of the kernel dispatch ``ops.<op>`` against ``plain_op``
    on the same inputs (within ``atol`` + ``rtol`` x |plain|)."""

    def __init__(self, op, plain_op, atol, rtol):
        super().__init__(ops, op)
        self.op, self.plain_op = op, plain_op
        self.atol, self.rtol = atol, rtol

    @contextlib.contextmanager
    def plain(self):
        """``ops.<op>`` is the plain version inside the block."""
        current = getattr(ops, self.op)
        setattr(ops, self.op, self.plain_op)
        try:
            yield
        finally:
            setattr(ops, self.op, current)

    def check(self, args, kw, out) -> None:
        want = self.plain_op(*args, **kw)
        err = float((out - want).abs().max()) if out.numel() else 0.
        self.max_err = max(self.max_err, err)
        if not torch.allclose(out, want, rtol=self.rtol, atol=self.atol):
            fail(f"{self.op} differs from its plain version on "
                 f"{[tuple(a.shape) for a in args if a is not None]}"
                 f" (max abs err {err})")


class FMLog(OpLog):
    """Every ``fused_fm`` launch against the plain FM."""

    def __init__(self):
        super().__init__("fm_interaction", ref.fused_fm, FM_TOL, FM_TOL)


class BagLog(OpLog):
    """Every ``embedding_bag`` launch against the plain bag lookup, to
    BAG_TOL absolute, BAG_CHECK_ROWS bags at a time (the plain lookup
    builds [bags, L, D] intermediates: 6.7 GB at M.1's whole batch)."""

    def __init__(self):
        super().__init__("embedding_bag", ref.embedding_bag, BAG_TOL, 0.0)

    def check(self, args, kw, out) -> None:
        table, ids, weights = args
        for r in range(0, ids.shape[0], BAG_CHECK_ROWS):
            rows = slice(r, r + BAG_CHECK_ROWS)
            super().check((table, ids[rows], None if weights is None
                           else weights[rows]), kw, out[rows])


class Calls:
    """Keeps each call of ``owner.<attr>`` while the block runs, as (its
    first argument, its result) in ``calls``: the host batch each request
    hands to ``serve_step._upload`` (whose dense columns are the spliced
    features) with its columns on the card, or the scores each
    ``rec.lax_top_k`` ranks with its answer."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.orig = getattr(owner, attr)
        self.calls = []

    def __enter__(self):
        setattr(self.owner, self.attr, self._record)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)

    @property
    def last(self):
        return self.calls[-1]

    def _record(self, first, *args, **kw):
        out = self.orig(first, *args, **kw)
        self.calls.append((first, out))
        return out


def check_request(probs, batch, upload, model, fm_log, feats, pop, n_items,
                  what):
    """The request's probabilities against the same model with the plain FM
    on the same device batch, and its spliced features against the rows as
    written, times found.  ``upload``: the host batch the request handed to
    ``serve_step._upload`` and its columns on the card."""
    host, dev = upload
    rows = len(batch["item_id"])
    if probs.shape != (rows,) or not bool(probs.isfinite().all()):
        fail(f"{what}: probabilities are not finite of shape ({rows},)")
    with fm_log.plain():
        want = rec.recsys_score(model, dev)
    err = float((probs - want).abs().max())
    if not torch.allclose(probs, want, rtol=FM_TOL, atol=FM_TOL):
        fail(f"{what}: probabilities differ from the plain-FM model "
             f"(max abs err {err})")
    ids = batch["item_id"]
    found = (ids >= 1) & (ids <= n_items)
    i = np.where(found, ids - 1, 0)
    dense = host["dense"]
    if not (np.array_equal(dense[:, :8], feats[i] * found[:, None])
            and np.array_equal(dense[:, 8],
                               pop[i].astype(np.float32) * found)
            and np.array_equal(dense[:, 9:], batch["dense"][:, 9:])):
        fail(f"{what}: spliced features differ from the rows as written")
    got_dense = dev["dense"].cpu().numpy()
    if not np.array_equal(got_dense, dense):
        fail(f"{what}: the batch on the card differs from the host batch")
    return err


def c_request(rng, cfg, n_items):
    batch = launch_serve.request_batch(rng, cfg, C_ROWS, n_items)
    absent = rng.random(C_ROWS) < C_ABSENT
    batch["item_id"][absent] += n_items      # keys the tables do not hold
    return batch


def request_profiler(device):
    """A profiler of the host, and of the card where the request runs on
    one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def device_busy_ms(prof) -> tuple[float, int]:
    """(ms, events): the union of the card's kernel, copy and memset
    intervals in a profiler trace."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3, len(spans)


def run_phase_c(device, log, fm_log, cfg=deepfm.CONFIG, n_items=C_ITEMS):
    """DeepFM (by default at full published width) behind the launcher's
    feature engine; returns the phase's metrics and what it served on."""
    t0 = time.perf_counter()
    model = rec.recsys_init(cfg, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[C] {cfg.name}: {model.param_bytes()} parameter bytes on the "
          f"card ({cfg.n_sparse_fields} fields x {cfg.field_vocab} ids x "
          f"{cfg.embed_dim}, mlp {cfg.mlp}), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    engine, keys, feats, pop = launch_serve.feature_engine(
        n_items, CONFIG.max_shard_bytes, device=device)
    build_s = time.perf_counter() - t0
    print(f"[C] feature engine: {n_items} items, item_pop + item_feats "
          f"(8 x float32) in {engine.window.get(None)[2].n_shards} "
          f"shard(s), built in {build_s:.1f} s", flush=True)
    backend = api.EngineBackend(engine)
    step = serve_step.recsys_score_fn(
        cfg, model, feature_client=api.FeatureClient(backend),
        feature_fields=launch_serve.FEATURE_FIELDS)
    clock = LayerClock((
        (api.FeatureClient, "query", "feature_query"),
        (serve_step, "_splice", "splice_h2d"),
        (serve_step, "_upload", "splice_h2d"),
        (rec, "recsys_score", "forward")))
    rng = np.random.default_rng(3)
    lat, wait, max_err, scored = [], [], 0.0, 0

    def score(step, batch, timed, prof=contextlib.nullcontext()):
        nonlocal max_err, scored
        # the clock wraps _upload first, so Calls sees the timed call
        with clock if timed else contextlib.nullcontext(), \
                Calls(serve_step, "_upload") as uploads, prof:
            t0 = time.perf_counter()
            probs = step(batch)
            t1 = time.perf_counter()
            probs.cpu()                             # waits for the card
            t2 = time.perf_counter()
        if timed:
            lat.append(t2 - t0)
            wait.append(t2 - t1)
        scored += 1
        log.check_pending()
        fm_log.check_pending()
        what = f"[C] request {scored}"
        max_err = max(max_err, check_request(probs, batch, uploads.last,
                                             model, fm_log, feats, pop,
                                             n_items, what))
        return (t2 - t0) * 1e3

    first_ms = score(step, c_request(rng, cfg, n_items), timed=False)
    for r in range(C_REQUESTS):
        if r == C_REQUESTS // 2:
            k = keys[rng.choice(n_items, DELTA_KEYS, replace=False)]
            p = rng.integers(0, 1 << 20, DELTA_KEYS).astype(np.uint64)
            api.FeatureClient(backend).update(
                2, upserts={"item_pop": (k, p)})
            pop = pop.copy()
            pop[(k - 1).astype(np.int64)] = p
            v2 = serve_step.recsys_score_fn(
                cfg, model, feature_fields=launch_serve.FEATURE_FIELDS,
                feature_client=api.FeatureClient(
                    backend,
                    default_consistency=api.Consistency.min_version(2)))
            batch = c_request(rng, cfg, n_items)
            batch["item_id"][:DELTA_KEYS] = k.astype(np.int64)
            score(v2, batch, timed=False)
        score(step, c_request(rng, cfg, n_items), timed=True)
    # one more request of the timed kind, traced: the card's kernels and
    # copies over the request's host time (the profiler slows the host, so
    # the share is also given over the untraced p50)
    prof = request_profiler(device)
    traced_ms = score(step, c_request(rng, cfg, n_items), timed=False,
                      prof=prof)
    busy_ms, busy_events = device_busy_ms(prof)
    lat_ms = np.array(lat) * 1e3
    n = len(lat)
    split = {k: v * 1e3 / n for k, v in clock.seconds.items()}
    split["wait"] = float(np.sum(wait)) * 1e3 / n
    m = {"phase": "C", "model": cfg.name, "rows": C_ROWS,
         "requests_scored": scored, "requests_timed": n,
         "first_request_ms": first_ms,
         "request_p50_ms": float(np.percentile(lat_ms, 50)),
         "request_p99_ms": float(np.percentile(lat_ms, 99)),
         "rows_per_s": C_ROWS * n / float(np.sum(lat)),
         "max_abs_err_probs": max_err,
         "max_abs_err_fm": fm_log.max_err,
         "max_abs_err_probe": max(log.max_err.values()),
         "param_bytes": model.param_bytes(), "build_s": build_s,
         "shards": engine.window.get(None)[2].n_shards,
         "host_ms_per_request": split,
         "traced_request": {
             "ms": traced_ms, "device_busy_ms": busy_ms,
             "device_events": busy_events,
             "busy_share": busy_ms / traced_ms,
             "busy_share_of_p50": busy_ms / float(np.percentile(lat_ms,
                                                                50))}}
    # what phase I serves on: the model, the engine at its latest version
    # and the rows as written there
    return m, Served(cfg, model, engine, keys, feats, pop, n_items,
                     engine.latest_version)


# ---------------------------------------------------------------------------
# phase I: C's DeepFM behind the QueryServer, concurrent clients and a delta
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Served:
    """A DeepFM and the feature engine it scores behind, with the rows as
    written at the engine's latest version."""
    cfg: rec.RecsysConfig
    model: torch.nn.Module
    engine: eng.MultiTableEngine
    keys: np.ndarray
    feats: np.ndarray
    pop: np.ndarray
    n_items: int
    version: int


class ThreadCalls:
    """Like ``Calls``, for a function called from several threads at once:
    keeps each thread's last call of ``owner.<attr>`` as (its arguments,
    its result), which ``last()`` reads back on that thread."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.orig = getattr(owner, attr)
        self._last = {}

    def __enter__(self):
        setattr(self.owner, self.attr, self._record)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)

    def last(self):
        return self._last[threading.get_ident()]

    def _record(self, *args, **kw):
        out = self.orig(*args, **kw)
        self._last[threading.get_ident()] = (args, out)
        return out


def percentiles(ms) -> dict:
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def check_versions(tracer, versions):
    """Every traced request (scoring and PREFETCH) by its micro-batch: each
    batch names one version, and ``versions`` are all served.  -> requests
    and micro-batches by version."""
    by_batch = {}
    for tid in tracer.trace_ids():
        root = next(s for s in tracer.peek(tid) if s.name == "serve")
        by_batch.setdefault(root.tags["batch_id"], set()).add(
            root.tags["version"])
    mixed = {b: sorted(v) for b, v in by_batch.items() if len(v) > 1}
    if mixed:
        fail(f"[I] micro-batches mix versions: {mixed}")
    served = sorted({v for vs in by_batch.values() for v in vs})
    if served != sorted(versions):
        fail(f"[I] served versions {served}, expected {sorted(versions)}")
    return {"micro_batches_by_version": {
        str(v): sum(vs == {v} for vs in by_batch.values()) for v in served},
        "mixed_micro_batches": len(mixed)}


def span_medians(tracer, qos="RANKING") -> dict:
    """Median ms of each span of the server's chain over ``qos``'s traced
    requests."""
    by_name = {name: [] for name in SPAN_NAMES}
    for tid in tracer.trace_ids():
        spans = tracer.peek(tid)
        root = next(s for s in spans if s.name == "serve")
        if root.tags["qos"] != qos:
            continue
        for span in spans:
            by_name[span.name].append(span.duration_s * 1e3)
    return {name: float(np.median(ms)) if ms else None
            for name, ms in by_name.items()}


def run_phase_i(served: Served, log, fm_log, c_p50_ms: float) -> dict:
    """C's DeepFM and feature engine behind the QueryServer, as the
    launcher's ``--feature-server`` mode serves them: I_CLIENTS scoring
    threads of I_REQUESTS requests of C_ROWS rows (drawn as C draws them),
    I_PREFETCH PREFETCH threads, and an ``item_pop`` delta (the next
    version, DELTA_KEYS of the hottest items) published once I_SETTLED
    requests are answered.  Every request is held as C holds its requests,
    against the rows as written at the version its response names; no
    micro-batch may mix versions.  Returns the phase's metrics."""
    cfg, model, engine, n_items = (served.cfg, served.model, served.engine,
                                   served.n_items)
    v0 = served.version
    tracer = Tracer(sample_rate=1.0, capacity=1 << 20, proc="server")
    server = QueryServer(engine, BatchPolicy(
        max_batch_keys=launch_serve.SERVER_BATCH_KEYS), tracer=tracer)
    records, answered = [], threading.Event()
    hot = served.keys[:DELTA_KEYS]             # the zipf draw's hottest ids
    pops = {v0: served.pop, v0 + 1: served.pop.copy()}
    pops[v0 + 1][:DELTA_KEYS] += np.uint64(1)
    try:
        session = api.FeatureClient(
            server, default_budget_s=launch_serve.SCORING_BUDGET_S)
        step = serve_step.recsys_score_fn(
            cfg, model, feature_server=server,
            feature_budget_s=launch_serve.SCORING_BUDGET_S,
            feature_fields=launch_serve.FEATURE_FIELDS)
        with ThreadCalls(serve_step, "_upload") as uploads, \
                ThreadCalls(serve_step, "_splice") as splices:
            def on_answer(batch, probs, ms):
                (host, _), dev = uploads.last()
                (_, response, _), _ = splices.last()
                records.append((batch, probs, host, dev, response))
                if len(records) >= I_SETTLED:
                    answered.set()

            def publish():
                if not answered.wait(300):
                    fail(f"[I] fewer than {I_SETTLED} requests answered "
                         "in 300 s")
                session.update(v0 + 1, upserts={"item_pop": (
                    hot, pops[v0 + 1][:DELTA_KEYS])})

            def draw(rng):
                return c_request(rng, cfg, n_items)

            launches0 = engine.stats.launches     # the warm-up's count too
            batch = draw(np.random.default_rng(99))     # warm-up
            on_answer(batch, step(batch), 0.0)
            warm = records.pop()
            server.reset_stats()
            lat, shed, wall = launch_serve.concurrent_traffic(
                step, session, draw, clients=I_CLIENTS, requests=I_REQUESTS,
                prefetch_clients=I_PREFETCH, n_items=n_items,
                publish=publish, on_answer=on_answer)
        snap = server.stats_snapshot()
    finally:
        server.close()
    engine_launches = engine.stats.launches - launches0
    log.check_pending()
    fm_log.check_pending()
    versions = check_versions(tracer, (v0, v0 + 1))
    max_err, by_version = 0.0, {}
    for r, (batch, probs, host, dev, response) in enumerate(
            [warm] + records):
        v = response.version
        if v not in pops:
            fail(f"[I] request {r} answered from version {v}")
        by_version[str(v)] = by_version.get(str(v), 0) + 1
        max_err = max(max_err, check_request(
            probs, batch, (host, dev), model, fm_log, served.feats, pops[v],
            n_items, f"[I] request {r} (version {v})"))
    lanes = {name: {"completed": c.completed, "p50_ms": c.p50_ms,
                    "p99_ms": c.p99_ms, "shed": c.shed}
             for name, c in snap.per_class.items() if c.submitted}
    return {"phase": "I", "model": cfg.name, "rows": C_ROWS,
            "clients": I_CLIENTS, "requests_a_client": I_REQUESTS,
            "prefetch_clients": I_PREFETCH,
            "requests_scored": len(records) + 1, "scoring_shed": shed,
            **{f"request_{k}": v for k, v in percentiles(lat).items()},
            "rows_per_s": C_ROWS * len(lat) / wall,
            "phase_c_request_p50_ms": c_p50_ms,
            "lanes": lanes, "micro_batches": snap.batches,
            "requests_a_micro_batch": snap.mean_occupancy,
            "keys_eliminated_before_the_card": snap.coalesce_rate,
            "launches_a_micro_batch": snap.launches / snap.batches,
            "engine_launches": engine_launches,
            "scoring_requests_by_version": by_version, **versions,
            "span_median_ms": span_medians(tracer),
            "max_abs_err_probs": max_err, "max_abs_err_fm": fm_log.max_err,
            "max_abs_err_probe": max(log.max_err.values())}


def run_naive_i(served: Served) -> dict:
    """Phase I's scoring clients (the same requests) through
    ``FeatureClient(EngineBackend(engine))`` with no server: each request
    its own feature query, as ``benchmarks/bench_serving.py``'s naive rows
    query the engine.  A comparison: its launches are not the main path's.
    """
    cfg, model = served.cfg, served.model
    step = serve_step.recsys_score_fn(
        cfg, model, feature_fields=launch_serve.FEATURE_FIELDS,
        feature_client=api.FeatureClient(api.EngineBackend(served.engine)))

    def draw(rng):
        return c_request(rng, cfg, served.n_items)
    step(draw(np.random.default_rng(99))).cpu()             # warm-up
    lat, _, wall = launch_serve.concurrent_traffic(
        step, None, draw, clients=I_CLIENTS, requests=I_REQUESTS,
        prefetch_clients=0, n_items=served.n_items)
    return {**{f"request_{k}": v for k, v in percentiles(lat).items()},
            "rows_per_s": C_ROWS * len(lat) / wall}


def fm_bound_ms(shape):
    """(bound ms, bound by) of fp32 [B, F, D]: each input element read once
    and used for one add and one fma, each output written once."""
    b, f, d = shape
    t_bytes = (b * f * d * 4 + b * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * b * f * d + 3 * b * d) / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fm_timing(emb, flush, iters, plain_iters):
    """fused_fm on ``emb`` (fp32) by events and by profiler, cold L2, beside
    the plain FM and its bound; first held against the plain FM, with the
    branch the launch took."""
    kernel = functools.partial(fm.fused_fm, emb)
    before = dict(fm.paths)
    got, want = kernel(), ref.fused_fm(emb)
    branch = [k for k in fm.paths if fm.paths[k] != before[k]]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=FM_TOL, atol=FM_TOL):
        fail(f"fused_fm differs from the plain FM at {tuple(emb.shape)} "
             f"(max abs err {err})")
    del got, want
    bound, by = fm_bound_ms(tuple(emb.shape))
    return {"shape": list(emb.shape), "branch": branch[0],
            "max_abs_err": err,
            "ms": time_ms(kernel, iters, flush),
            "kernel_ms": kernel_ms(kernel, "fused_fm_", iters, flush),
            "host_ms": host_ms(kernel, iters),
            "plain_ms": time_ms(lambda: ref.fused_fm(emb), plain_iters,
                                flush),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def measure_fm(fm_log, flush, retrieval):
    """fused_fm at phase C's shape (the last launch's input), at the
    serve_bulk batch, and at phase E's retrieval_cand batch (``retrieval``:
    its last launch's input), beside the plain FM."""
    (emb,) = fm_log.last
    row = {"name": "fused_fm", "route": "cuda",
           "source": SOURCE["fused_fm"], "replaces": REPLACES["fused_fm"],
           "launches": None, **fm_timing(emb, flush, 50, 50),
           "max_abs_err": fm_log.max_err,
           "library_note": "no single PyTorch call computes the FM term"}
    g = torch.Generator(device=emb.device).manual_seed(11)
    bulk = torch.randn(FM_BULK, generator=g, device=emb.device).mul_(0.05)
    row["bulk"] = fm_timing(bulk, flush, 20, 5)
    del bulk
    row["retrieval"] = fm_timing(retrieval, flush, 20, 5)
    return row


def fm_plan_line(emb, paths):
    """fused_fm's plan for ``emb`` and launches by branch (``paths``)."""
    n_sm = torch.cuda.get_device_properties(emb.device).multi_processor_count
    p = fm.plan(*emb.shape, emb.element_size(), n_sm,
                emb.data_ptr() % 16 == 0)
    n_tiles = -(-emb.shape[0] // p.tile)
    return {"shape": list(emb.shape), "branch": p.branch,
            "tile_samples": p.tile, "stages": p.stages, "blocks": p.blocks,
            "threads": p.threads, "tiles": n_tiles,
            "last_tile_samples": emb.shape[0] - (n_tiles - 1) * p.tile,
            **{f"{k}_launches": v for k, v in paths.items()},
            "bulk_share": paths["bulk"] / max(1, sum(paths.values()))}


def fm_design(fm_log, paths):
    """fused_fm's plan at the main path's shape (the last launch's input)
    and at the serve_bulk batch, and the main path's launches by branch."""
    (emb,) = fm_log.last
    n_sm = torch.cuda.get_device_properties(emb.device).multi_processor_count
    bulk = fm.plan(*FM_BULK, 4, n_sm, True)
    return {**fm_plan_line(emb, paths), "bulk_shape_tile_samples": bulk.tile,
            "bulk_shape_blocks": bulk.blocks}


def lines_design(launch, row, lanes_counts, flush):
    """probe_lines on phase A: the main path's launches by lanes a query,
    the last launch's kernel time with each count of lanes, and the share
    of its chain steps that stay in the line they left (``row``: its
    ``measure``)."""
    group, q_hi, q_lo, seg = launch
    qh, ql = ops.pad_to(q_hi, ops.BLOCK_Q), ops.pad_to(q_lo, ops.BLOCK_Q)
    lanes = [k for k, v in lanes_counts.items() if v]
    return {"main_path_launches_by_lanes": lanes_counts,
            "blocks": -(-qh.shape[0] * lanes[0] // nl.LINES_THREADS),
            "kernel_ms_by_lanes": lanes_ms(
                group, qh, ql, seg, ref.probe_group(group, qh, ql, seg),
                flush, 50),
            "chain_steps": row["chain_steps"],
            "in_line_steps": row["in_line_steps"],
            "in_line_share": row["in_line_steps"]
            / max(1, row["chain_steps"])}


# ---------------------------------------------------------------------------
# phase D: two-tower user-tower serving (serve_p99)
# ---------------------------------------------------------------------------
def check_user_vectors(vecs, batch, uploads, model, bag_log, what):
    """The request's user vectors against the same model with the plain bag
    lookup on the same device batch, and their norms against 1; returns
    (max abs err, max norm err)."""
    host, dev = uploads.last
    rows = len(batch["user_id"])
    if vecs.shape != (rows, model.cfg.tower_mlp[-1]) \
            or not bool(vecs.isfinite().all()):
        fail(f"{what}: user vectors are not finite of shape "
             f"({rows}, {model.cfg.tower_mlp[-1]})")
    for k in model.inputs:
        if not np.array_equal(dev[k].cpu().numpy(), batch[k]):
            fail(f"{what}: {k} on the card differs from the request's")
    with bag_log.plain():
        want = rec.recsys_score(model, dev)
    err = float((vecs - want).abs().max())
    if not err <= BAG_TOL:
        fail(f"{what}: user vectors differ from the plain-bag model "
             f"(max abs err {err})")
    norm_err = float((torch.linalg.vector_norm(vecs, dim=-1) - 1).abs().max())
    if not norm_err <= BAG_TOL:
        fail(f"{what}: user vector norms are off 1 by {norm_err}")
    return err, norm_err


def two_tower_model(device, cfg=two_tower_retrieval.CONFIG):
    """The two-tower model of phases D and F (by default at full published
    width), random weights from seed 0."""
    t0 = time.perf_counter()
    model = rec.recsys_init(cfg, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[D] {cfg.name}: {model.param_bytes()} parameter bytes on the "
          f"card (users {cfg.user_vocab}, items {cfg.item_vocab}, cats "
          f"{cfg.cat_vocab} x {cfg.embed_dim}; towers {cfg.tower_mlp}), "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def max_memory(device):
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)


def run_phase_d(model, bag_log, requests=D_REQUESTS):
    """Two-tower user-tower serving through ``recsys_score_fn`` with no
    feature source, as the JAX launcher's serve_p99 cell serves it; returns
    the phase's metrics."""
    cfg, device = model.cfg, model.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = serve_step.recsys_score_fn(cfg, model)
    clock = LayerClock((
        (serve_step, "_upload", "upload"),
        (es, "embed_lookup", "gathers_bag"),
        (es, "embed_bag", "gathers_bag"),
        (rec, "_mlp_apply", "mlp_enqueue")))
    rng = np.random.default_rng(4)
    lat, wait, errs, scored = [], [], [0.0, 0.0], 0

    def score(batch, timed, prof=contextlib.nullcontext()):
        nonlocal scored
        # the clock wraps _upload first, so Calls sees the timed call
        with clock if timed else contextlib.nullcontext(), \
                Calls(serve_step, "_upload") as uploads, prof:
            t0 = time.perf_counter()
            vecs = step(batch)
            t1 = time.perf_counter()
            vecs.cpu()                              # waits for the card
            t2 = time.perf_counter()
        if timed:
            lat.append(t2 - t0)
            wait.append(t2 - t1)
        scored += 1
        bag_log.check_pending()
        e = check_user_vectors(vecs, batch, uploads, model, bag_log,
                               f"[D] request {scored}")
        errs[:] = [max(a, b) for a, b in zip(errs, e)]
        return (t2 - t0) * 1e3

    first_ms = score(synthetic.recsys_batch(rng, cfg, D_ROWS), timed=False)
    for _ in range(requests):
        score(synthetic.recsys_batch(rng, cfg, D_ROWS), timed=True)
    # one more request of the timed kind, traced for the card's busy share
    prof = request_profiler(device)
    traced_ms = score(synthetic.recsys_batch(rng, cfg, D_ROWS), timed=False,
                      prof=prof)
    busy_ms, busy_events = device_busy_ms(prof)
    lat_ms = np.array(lat) * 1e3
    n = len(lat)
    split = {k: v * 1e3 / n for k, v in clock.seconds.items()}
    split["wait"] = float(np.sum(wait)) * 1e3 / n
    return {
        "phase": "D", "model": cfg.name, "rows": D_ROWS,
        "requests_scored": scored, "requests_timed": n,
        "first_request_ms": first_ms,
        "request_p50_ms": float(np.percentile(lat_ms, 50)),
        "request_p99_ms": float(np.percentile(lat_ms, 99)),
        "rows_per_s": D_ROWS * n / float(np.sum(lat)),
        "max_abs_err_user_vectors": errs[0], "max_norm_err": errs[1],
        "max_abs_err_bag": bag_log.max_err,
        "param_bytes": model.param_bytes(),
        "max_memory_allocated": max_memory(device),
        "host_ms_per_request": split,
        "traced_request": {
            "ms": traced_ms, "device_busy_ms": busy_ms,
            "device_events": busy_events,
            "busy_share": busy_ms / traced_ms,
            "busy_share_of_p50": busy_ms / float(np.percentile(lat_ms, 50))}}


def bag_bound(ids, dim, elt_bytes):
    """The least time of a bag lookup of ``ids`` over a [V, dim] table on
    this card: each distinct row the batch touches read once (a row read
    again hits in L2), the indices read and the fp32 output written once;
    one fma per valid entry and element.  Also the bytes with every valid
    entry's row counted."""
    valid = ids[ids >= 0]
    entries, rows = int(valid.numel()), int(torch.unique(valid).numel())
    io = ids.numel() * 4 + ids.shape[0] * dim * 4
    t_bytes = (rows * dim * elt_bytes + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * entries * dim / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "distinct_rows": rows, "valid_entries": entries,
            "bytes": rows * dim * elt_bytes + io,
            "bytes_per_entry": entries * dim * elt_bytes + io,
            "bound_per_entry_ms": (entries * dim * elt_bytes + io)
            / HBM_BYTES_PER_S * 1e3}


def bag_timing(table, ids, flush, iters, plain_iters):
    """``embedding_bag`` (mean, as the user tower calls it) on ``ids`` by
    events and by profiler, cold L2, beside the plain version and
    ``F.embedding_bag`` on the same rows (the -1 entries compacted away
    outside the timed window)."""
    kernel = functools.partial(bagk.embedding_bag, table, ids, mode="mean")
    plain = functools.partial(ref.embedding_bag, table, ids, None, "mean")
    with torch.inference_mode():
        before = dict(bagk.paths)
        got, want = kernel(), plain()
        branch = [k for k in bagk.paths if bagk.paths[k] != before[k]]
        err = float((got - want).abs().max())
        if not err <= BAG_TOL:
            fail(f"embedding_bag differs from the plain bag on "
                 f"{tuple(ids.shape)} (max abs err {err})")
        del want
        valid = ids >= 0
        flat = ids[valid].long()
        offsets = torch.zeros(ids.shape[0], dtype=torch.long,
                              device=ids.device)
        offsets[1:] = valid.sum(dim=1).cumsum(0)[:-1]
        library = functools.partial(torch.nn.functional.embedding_bag, flat,
                                    table, offsets, mode="mean")
        library_diff = float((library() - got).abs().max())
        row = {"shape": list(ids.shape), "branch": branch[0],
               "max_abs_err": err,
               "ms": time_ms(kernel, iters, flush),
               "kernel_ms": kernel_ms(kernel, "embedding_bag", iters,
                                      flush),
               "host_ms": host_ms(kernel, iters),
               "plain_ms": time_ms(plain, plain_iters, flush),
               "library_ms": time_ms(library, iters, flush),
               "library_max_abs_diff": library_diff}
    row.update(bag_bound(ids, table.shape[1], table.element_size()))
    return row


def measure_bag(bag_log, retrieval_log, flush):
    """embedding_bag at phase D's shape (the last launch's input), at the
    serve_bulk batch of CONFIG's zipf histories over the same item table,
    and at phase F's retrieval_cand shape (``retrieval_log``'s last
    launch)."""
    table, ids, *_ = bag_log.last
    row = {"name": "embedding_bag", "route": "cuda",
           "source": SOURCE["embedding_bag"],
           "replaces": REPLACES["embedding_bag"], "launches": None,
           **bag_timing(table, ids, flush, 50, 20),
           "max_abs_err": bag_log.max_err}
    batch = synthetic.recsys_batch(np.random.default_rng(12),
                                   two_tower_retrieval.CONFIG, BAG_BULK_ROWS)
    bulk = torch.from_numpy(batch["hist_items"]).to(table.device)
    row["bulk"] = bag_timing(table, bulk, flush, 20, 3)
    del bulk
    table, ids, *_ = retrieval_log.last
    row["retrieval"] = {**bag_timing(table, ids, flush, 50, 20),
                        "max_abs_err": retrieval_log.max_err}
    return row


# ---------------------------------------------------------------------------
# phases E and F: the retrieval_cand cell
# ---------------------------------------------------------------------------
def total_order_np(scores):
    """int64 keys of fp32 ``scores`` in the float total order that
    ``jax.lax.top_k`` ranks by: +0.0 above -0.0, a positive NaN above +inf,
    a negative NaN below -inf (the bits, the low 31 flipped for
    negatives)."""
    bits = np.ascontiguousarray(scores, dtype=np.float32).view(np.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).astype(np.int64)


def check_top_k(got, scores, want, want_scores, what):
    """A request's top k (``got``: values and indices, of ``scores``)
    against the plain path's (``want``, of ``want_scores``): values within
    TOP_K_TOL; every returned value its index's score, bitwise; the order
    ``jax.lax.top_k``'s on ``scores`` (descending by the float total order,
    equal scores by ascending index), rebuilt on the host; the indices the
    plain path's but where a neighbouring score (the plain path's (k+1)-th
    included) lies within TOP_K_TOL.  Returns the distinct values of each row and how many
    positions hold another index than the plain path's."""
    (gv, gi), (wv, wi) = got, want
    k, n = gv.shape[-1], scores.shape[-1]
    if gv.shape != wv.shape or not bool(gv.isfinite().all()):
        fail(f"{what}: top-{k} values are not finite of shape "
             f"{tuple(wv.shape)}")
    err = float((gv - wv).abs().max())
    if not err <= TOP_K_TOL:
        fail(f"{what}: top-{k} values differ from the plain path's by {err}")
    s2, gv2, gi2 = (t.reshape(-1, t.shape[-1]) for t in (scores, gv, gi))
    if not torch.equal(s2.gather(1, gi2).view(torch.int32),
                       gv2.view(torch.int32)):
        fail(f"{what}: a returned value is not its index's score")
    key, gi_host = total_order_np(s2.cpu().numpy()), gi2.cpu().numpy()
    for r in range(len(key)):
        cand = np.flatnonzero(key[r] >= key[r][gi_host[r][-1]])
        order = cand[np.lexsort((cand, -key[r][cand]))][:k]
        if not np.array_equal(order, gi_host[r]):
            fail(f"{what}: the top {k} are not in lax.top_k's order "
                 "(descending by the float total order, equal scores by "
                 "ascending index)")
    w2 = want_scores.reshape(-1, n)
    nxt = (torch.topk(w2, k + 1).values[:, -1] if k < n
           else torch.full((len(w2),), float("-inf"), device=w2.device))
    wv2, wi2 = wv.reshape(-1, k), wi.reshape(-1, k)
    inf = torch.full((1,), float("inf"), device=wv2.device)
    moved = 0
    for r in range(len(wv2)):
        v = torch.cat([inf, wv2[r], nxt[r:r + 1]])
        apart = (v[1:-1] - v[2:] > TOP_K_TOL) & (v[:-2] - v[1:-1] > TOP_K_TOL)
        differ = gi2[r] != wi2[r]
        if bool((apart & differ).any()):
            fail(f"{what}: the top {k} differ from the plain path's at a "
                 f"score more than {TOP_K_TOL} from its neighbours")
        moved += int(differ.sum())
    return {"max_abs_err": err, "positions_moved": moved,
            "distinct_values": [int(torch.unique(row).numel())
                                for row in gv2]}


def repeated_pair_scores(scores, ids, cats, cat_vocab):
    """Whether candidates that repeat an (item, category) pair got
    bitwise-equal scores: the pairs that repeat, how many of them scored
    equal in every copy, and the candidates they cover."""
    key = ids.long() * cat_vocab + cats.long()
    _, inv, counts = torch.unique(key, return_inverse=True,
                                  return_counts=True)
    hi = torch.full(counts.shape, float("-inf"), device=scores.device)
    lo = torch.full(counts.shape, float("inf"), device=scores.device)
    hi = hi.scatter_reduce(0, inv, scores, "amax")
    lo = lo.scatter_reduce(0, inv, scores, "amin")
    rep = counts > 1
    return {"pairs": int(counts.numel()), "repeated_pairs": int(rep.sum()),
            "candidates_in_repeated_pairs": int(counts[rep].sum()),
            "repeated_pairs_bitwise_equal": int((rep & (hi == lo)).sum())}


def draw_requests(draw, n, seed):
    """``n`` requests ``draw(rng)``, each from its own generator spawned from
    ``seed``, drawn in parallel threads (numpy's generators release the
    interpreter lock) before any is timed."""
    rngs = [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(n)]
    with concurrent.futures.ThreadPoolExecutor(min(8, n)) as pool:
        return list(pool.map(draw, rngs))


def kernels_by_device_ms(prof, top=6):
    """The ``top`` kernels (and copies) of a trace by device ms."""
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name[:80]] = ms.get(e.name[:80], 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:top])


def ops_by_device_ms(prof, top=8):
    """The ``top`` PyTorch operations of a trace by the device ms of the
    kernels they launched themselves (an ``aten::`` op's own kernels, not
    those of the ops it calls)."""
    ms = {e.key: e.self_device_time_total / 1e3
          for e in prof.key_averages() if e.self_device_time_total > 0
          and e.device_type == torch.autograd.DeviceType.CPU}
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:top])


def mlp_flops(dims, rows):
    """Multiply-adds of an MLP over ``rows`` rows, as operations."""
    return 2 * rows * sum(i * o for i, o in zip(dims[:-1], dims[1:]))


def run_retrieval(name, step, requests, check, clock, launched, device):
    """Phase E or F's loop: ``requests`` (host arguments of ``step``) of
    which the first is a warm-up, the last traced and the rest timed;
    ``check(out, uploads, topk, what)`` holds each answer against the plain
    path after ``launched(what)`` has checked its kernel launch.  Returns
    the latencies, the waits, the checks' results and the traced request's
    profiler and ms."""
    lat, wait, checks = [], [], []
    prof = request_profiler(device)
    traced_ms = None
    for r, args in enumerate(requests):
        timed = 0 < r < len(requests) - 1
        traced = r == len(requests) - 1
        # the clock wraps first, so Calls sees the timed calls
        with clock if timed else contextlib.nullcontext(), \
                Calls(serve_step, "_upload") as uploads, \
                Calls(rec, "lax_top_k") as topk, \
                prof if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            values, indices = step(*args)
            t1 = time.perf_counter()
            values.cpu(), indices.cpu()                 # waits for the card
            t2 = time.perf_counter()
        if timed:
            lat.append(t2 - t0)
            wait.append(t2 - t1)
        if traced:
            traced_ms = (t2 - t0) * 1e3
        what = f"[{name}] request {r}"
        launched(what)
        checks.append(check((values, indices), uploads, topk, what))
    return lat, wait, checks, prof, traced_ms


def launch_check(op_log, arg, shape):
    """-> ``check(what)``: the request launched ``op_log``'s op exactly
    once, its input ``arg`` of ``shape``; then held against the plain
    version."""
    def check(what):
        shapes = [tuple(args[arg].shape) for args, _, _ in op_log.pending]
        if shapes != [tuple(shape)]:
            fail(f"{what}: {op_log.op} launched at {shapes}, expected once "
                 f"at {tuple(shape)}")
        op_log.check_pending()
    return check


def retrieval_metrics(name, cfg, n, lat, wait, checks, clock, prof,
                      traced_ms, device):
    lat_ms = np.array(lat) * 1e3
    k = len(lat)
    split = {key: v * 1e3 / k for key, v in clock.seconds.items()}
    split["wait"] = float(np.sum(wait)) * 1e3 / k
    busy_ms, busy_events = device_busy_ms(prof)
    p50 = float(np.percentile(lat_ms, 50))
    return {"phase": name, "model": cfg.name, "candidates": n,
            "top_k": TOP_K, "requests_checked": len(checks),
            "requests_timed": k,
            "request_p50_ms": p50,
            "request_p99_ms": float(np.percentile(lat_ms, 99)),
            "candidates_per_s": n * k / float(np.sum(lat)),
            "max_abs_err_top_k": max(c["max_abs_err"] for c in checks),
            "positions_moved": sum(c["positions_moved"] for c in checks),
            "distinct_values_in_top_k": [c["distinct_values"][0]
                                         for c in checks],
            "max_memory_allocated": max_memory(device),
            "matmul_precision": torch.get_float32_matmul_precision(),
            "host_ms_per_request": split,
            "traced_request": {
                "ms": traced_ms, "device_busy_ms": busy_ms,
                "device_events": busy_events,
                "busy_share": busy_ms / traced_ms,
                "busy_share_of_p50": busy_ms / p50,
                "device_ms_by_kernel": kernels_by_device_ms(prof)}}


def upload_split(batch, names, device, reps=3):
    """``serve_step._upload`` of ``batch``'s columns ``names`` (already
    int32 or float32, as a request's are), split: the host concatenation
    into one buffer, and the pageable host-to-device copy of that buffer,
    each the median host time of ``reps``, the card drained."""
    cols = [np.asarray(batch[k]).reshape(-1).view(np.int32) for k in names]
    concat, copy = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        words = np.concatenate(cols)
        t1 = time.perf_counter()
        torch.from_numpy(words).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        concat.append(t1 - t0)
        copy.append(t2 - t1)
    h2d = float(np.median(copy))
    return {"bytes": words.nbytes,
            "concat_ms": float(np.median(concat)) * 1e3,
            "h2d_ms": h2d * 1e3, "h2d_bytes_per_s": words.nbytes / h2d}


def run_phase_e(device, fm_log, cfg=deepfm.CONFIG, n=R_CANDIDATES,
                requests=R_REQUESTS):
    """DeepFM's retrieval_cand cell (by default at full published width):
    ``n`` candidate rows a request ranked through ``bulk_rank_fn``; returns
    the phase's metrics."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = rec.recsys_init(cfg, seed=0, device=device)
    print(f"[E] {cfg.name}: {model.param_bytes()} parameter bytes, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def draw(rng):
        batch = synthetic.recsys_batch(rng, cfg, n)
        batch.pop("label")
        return (batch,)
    t0 = time.perf_counter()
    batches = draw_requests(draw, requests + 2, seed=5)
    print(f"[E] drew {requests + 2} requests of {n} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    step = serve_step.bulk_rank_fn(cfg, model, top_k=TOP_K)
    clock = LayerClock((
        (serve_step, "_upload", "upload"),
        (es, "embed_lookup", "gathers"),
        (ops, "fm_interaction", "fm"),
        (rec, "_mlp_apply", "mlp"),
        (rec, "lax_top_k", "top_k")))

    def check(got, uploads, topk, what):
        (scores, _), = topk.calls
        with fm_log.plain(), Calls(rec, "lax_top_k") as plain:
            want = rec.bulk_rank(model, uploads.last[1], TOP_K)
        return check_top_k(got, scores, want, plain.calls[0][0], what)

    launched = launch_check(fm_log, 0, (n, cfg.n_sparse_fields,
                                        cfg.embed_dim))
    lat, wait, checks, prof, traced_ms = run_retrieval(
        "E", step, batches, check, clock, launched, device)
    m = retrieval_metrics("E", cfg, n, lat, wait, checks, clock, prof,
                          traced_ms, device)
    dims = (cfg.n_sparse_fields * cfg.embed_dim + cfg.n_dense,) \
        + tuple(cfg.mlp) + (1,)
    flops = mlp_flops(dims, n)
    gathered = n * cfg.n_sparse_fields * (cfg.embed_dim + 1) * 4
    upload = n * (cfg.n_sparse_fields + cfg.n_dense) * 4
    m["bound"] = {"mlp_flops": flops, "gathered_bytes": gathered,
                  "upload_bytes": upload,
                  "flops_ms": flops / FP32_OPS_PER_S * 1e3,
                  "gathered_bytes_ms": gathered / HBM_BYTES_PER_S * 1e3}
    m["fm_max_abs_err"] = fm_log.max_err
    m["upload_split"] = upload_split(batches[-1][0], model.inputs, device)
    return m


def run_phase_f(model, bag_log, n=R_CANDIDATES, requests=R_REQUESTS):
    """Two-tower's retrieval_cand cell on ``model``: one user against ``n``
    zipf candidates a request through ``retrieval_fn``; returns the
    phase's metrics."""
    cfg, device = model.cfg, model.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def draw(rng):
        user = synthetic.recsys_batch(rng, cfg, 1)
        for col in ("item_id", "item_cat"):
            user.pop(col)
        return (user, synthetic.zipf_ids(rng, cfg.item_vocab, n),
                synthetic.zipf_ids(rng, cfg.cat_vocab, n))
    requests = draw_requests(draw, requests + 2, seed=6)
    step = serve_step.retrieval_fn(cfg, model, top_k=TOP_K)
    clock = LayerClock((
        (serve_step, "_upload", "upload"),
        (es, "embed_lookup", "gathers_bag"),
        (es, "embed_bag", "gathers_bag"),
        (rec, "_mlp_apply", "mlp"),
        (rec, "lax_top_k", "top_k")))
    pairs = []

    def check(got, uploads, topk, what):
        (scores, _), = topk.calls
        dev = uploads.last[1]
        with bag_log.plain(), Calls(rec, "lax_top_k") as plain:
            want = rec.retrieval_scores(model, dev, dev["cand_ids"],
                                        dev["cand_cats"], TOP_K)
        pairs.append(repeated_pair_scores(scores[0], dev["cand_ids"],
                                          dev["cand_cats"], cfg.cat_vocab))
        return check_top_k(got, scores, want, plain.calls[0][0], what)

    launched = launch_check(bag_log, 1, (1, cfg.seq_len))
    lat, wait, checks, prof, traced_ms = run_retrieval(
        "F", step, requests, check, clock, launched, device)
    m = retrieval_metrics("F", cfg, n, lat, wait, checks, clock, prof,
                          traced_ms, device)
    m["repeated_pairs"] = pairs[-1]
    m["repeated_pairs_all_bitwise_equal"] = all(
        p["repeated_pairs_bitwise_equal"] == p["repeated_pairs"]
        for p in pairs)
    flops = mlp_flops((2 * cfg.embed_dim,) + tuple(cfg.tower_mlp), n) \
        + 2 * n * cfg.tower_mlp[-1]
    gathered = n * 2 * cfg.embed_dim * 4
    m["bound"] = {"item_tower_and_score_flops": flops,
                  "gathered_bytes": gathered, "upload_bytes": 2 * n * 4,
                  "flops_ms": flops / FP32_OPS_PER_S * 1e3,
                  "gathered_bytes_ms": gathered / HBM_BYTES_PER_S * 1e3}
    m["bag_max_abs_err"] = bag_log.max_err
    return m


# ---------------------------------------------------------------------------
# phases G and H: DIN and BST serving (serve_p99 and serve_bulk)
# ---------------------------------------------------------------------------
def _rows64(table, ids):
    """``table``'s rows of ``ids`` in float64, as ``jnp.take`` reads them: a
    negative id gives zeros, an id past the table NaN."""
    ids = ids.long()
    out = table[ids.clamp(0, table.shape[0] - 1)].double()
    out[ids < 0] = 0
    out[ids >= table.shape[0]] = float("nan")
    return out


def _mlp64(weights, biases, x, act):
    """``x @ w + b`` per layer in float64, ``act`` between layers."""
    layers = list(zip(weights, biases))
    for i, (w, b) in enumerate(layers):
        x = x @ w.double() + b.double()
        if i + 1 < len(layers):
            x = act(x)
    return x


def din_fp64(model, cols):
    """DIN's CTR probabilities of ``cols``: ``din_logits64``'s sigmoid."""
    return torch.sigmoid(din_logits64(model, cols))


def din_logits64(model, cols):
    """DIN's logits of ``cols`` (the model's columns on the card)
    recomputed in float64 from the model's tensors: the gathers, the
    concatenation ``[e, et, e - et, e * et]``, the attention MLP (sigmoids
    between layers, the last linear), the weights zeroed where the step is
    padding, the weighted sum and the head MLP."""
    hi, hc = cols["hist_items"], cols["hist_cats"]
    hist = torch.cat([_rows64(model.item_table, hi),
                      _rows64(model.cat_table, hc)], dim=-1)
    target = torch.cat([_rows64(model.item_table, cols["target_item"]),
                        _rows64(model.cat_table, cols["target_cat"])],
                       dim=-1)
    tgt = target[:, None].expand_as(hist)
    feat = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    w = _mlp64(model.attn_mlp_w, model.attn_mlp_b, feat, torch.sigmoid)
    w = w[..., 0] * (hi >= 0)
    pooled = (w[..., None] * hist).sum(dim=1)
    x = torch.cat([pooled, target, cols["dense"].double()], dim=-1)
    return _mlp64(model.mlp_w, model.mlp_b, x, torch.relu)[..., 0]


def _layer_norm64(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g.double() + b.double()


def bst_fp64(model, cols):
    """BST's CTR probabilities of ``cols``: ``bst_logits64``'s sigmoid."""
    return torch.sigmoid(bst_logits64(model, cols))


def bst_logits64(model, cols):
    """BST's logits of ``cols`` recomputed in float64 from the model's
    tensors: the history and target rows plus positions, each block
    (scores over sqrt(dh), padded keys at -1e30, softmax, output
    projection, layer norm, ReLU FFN, layer norm), the flattened sequence
    beside the dense features through the head MLP."""
    seq = torch.cat([cols["hist_items"], cols["target_item"][:, None]],
                    dim=1)
    x = _rows64(model.item_table, seq) + model.pos_table.double()[None]
    b, s, d = x.shape
    h = model.cfg.n_heads
    dh = d // h
    for p in model.blocks:
        q, k, v = ((x @ p[w].double()).reshape(b, s, h, dh)
                   for w in ("wq", "wk", "wv"))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / dh ** 0.5
        sc = sc.masked_fill(~(seq >= 0)[:, None, None, :], -1e30)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)
        x = _layer_norm64(x + o.reshape(b, s, d) @ p["wo"].double(),
                          p["ln1_g"], p["ln1_b"])
        f = torch.relu(x @ p["ffn1"].double()) @ p["ffn2"].double()
        x = _layer_norm64(x + f, p["ln2_g"], p["ln2_b"])
    x = torch.cat([x.reshape(b, -1), cols["dense"].double()], dim=-1)
    return _mlp64(model.mlp_w, model.mlp_b, x, torch.relu)[..., 0]


FP64 = {"din": din_fp64, "bst": bst_fp64}


def run_seq_cell(name, model, cell, rows, requests, check_rows, seed):
    """One cell of phase G or H: ``requests`` + 2 requests of ``rows`` rows
    (``launch_serve.cell_requests``: ``synthetic.recsys_batch`` through
    ``serve_step.recsys_score_fn``), all drawn before the first is timed;
    the first a warm-up, the last traced, the rest timed.  Every request's
    columns on the card are held against the host batch, and its
    probabilities against the float64 recompute on ``check_rows`` fixed
    rows (every row when None).  Returns the cell's metrics."""
    cfg, device = model.cfg, model.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step, draw = launch_serve.cell_requests(cfg, cell, rows, model)
    t0 = time.perf_counter()
    batches = draw_requests(draw, requests + 2, seed)
    draw_s = time.perf_counter() - t0
    idx = (None if check_rows is None else torch.from_numpy(np.sort(
        np.random.default_rng(seed).choice(rows, check_rows,
                                           replace=False))).to(device))
    clock = LayerClock((
        (serve_step, "_upload", "upload"),
        (rec, "recsys_score", "model_enqueue"),
        (es, "embed_lookup", "of_which_gathers"),
        (rec, "_mlp_apply", "of_which_mlps"),
        (rec, "_bst_block", "of_which_blocks")))
    lat, wait, errs = [], [], []
    prof = request_profiler(device)
    traced_ms = None
    for r, (batch,) in enumerate(batches):
        timed, traced = 0 < r < len(batches) - 1, r == len(batches) - 1
        # the clock wraps _upload first, so Calls sees the timed call
        with clock if timed else contextlib.nullcontext(), \
                Calls(serve_step, "_upload") as uploads, \
                prof if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            probs = step(batch)
            t1 = time.perf_counter()
            probs.cpu()                                 # waits for the card
            t2 = time.perf_counter()
        if timed:
            lat.append(t2 - t0)
            wait.append(t2 - t1)
        if traced:
            traced_ms = (t2 - t0) * 1e3
        what = f"[{name}] {cell.name} request {r}"
        dev = uploads.last[1]
        for k in model.inputs:
            if not np.array_equal(dev[k].cpu().numpy(), batch[k]):
                fail(f"{what}: {k} on the card differs from the request's")
        if probs.shape != (rows,) or not bool(probs.isfinite().all()):
            fail(f"{what}: probabilities are not finite of shape ({rows},)")
        cols = {k: dev[k] if idx is None else dev[k][idx]
                for k in model.inputs}
        want = FP64[cfg.arch](model, cols)
        got = probs if idx is None else probs[idx]
        err = float((got.double() - want).abs().max())
        if not err <= SEQ_TOL:
            fail(f"{what}: probabilities differ from the float64 recompute "
                 f"by {err}")
        errs.append(err)
    lat_ms = np.array(lat) * 1e3
    n = len(lat)
    split = {k: v * 1e3 / n for k, v in clock.seconds.items()}
    split["wait"] = float(np.sum(wait)) * 1e3 / n
    busy_ms, busy_events = device_busy_ms(prof)
    p50 = float(np.percentile(lat_ms, 50))
    return {"phase": name, "model": cfg.name, "cell": cell.name,
            "rows": rows, "requests_checked": len(errs),
            "requests_timed": n,
            "rows_checked_per_request": rows if idx is None else check_rows,
            "drawn_s": draw_s,
            "request_p50_ms": p50,
            "request_p99_ms": float(np.percentile(lat_ms, 99)),
            "rows_per_s": rows * n / float(np.sum(lat)),
            "max_abs_err_vs_fp64": max(errs),
            "max_memory_allocated": max_memory(device),
            "matmul_precision": torch.get_float32_matmul_precision(),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "host_ms_per_request": split,
            "traced_request": {
                "ms": traced_ms, "device_busy_ms": busy_ms,
                "device_events": busy_events,
                "busy_share": busy_ms / traced_ms,
                "busy_share_of_p50": busy_ms / p50,
                "device_ms_by_kernel": kernels_by_device_ms(prof),
                "device_ms_by_op": ops_by_device_ms(prof)}}


def run_phase_seq(name, cfg, device, p99_rows=SEQ_P99_ROWS,
                  p99_requests=SEQ_P99_REQUESTS, bulk_rows=SEQ_BULK_ROWS,
                  bulk_requests=SEQ_BULK_REQUESTS,
                  check_rows=SEQ_CHECK_ROWS):
    """DIN (G) or BST (H), by default at full published width, through the
    launcher's serve_p99 cell (every row checked) and serve_bulk cell
    (``check_rows`` fixed rows of each request checked), printing each
    cell's metrics."""
    t0 = time.perf_counter()
    model = rec.recsys_init(cfg, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[{name}] {cfg.name}: {model.param_bytes()} parameter bytes on "
          f"the card (items {cfg.item_vocab} x {cfg.embed_dim}, history "
          f"{cfg.seq_len}, mlp {cfg.mlp}), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    p99 = run_seq_cell(name, model, registry.cell_by_name("serve_p99"),
                       p99_rows, p99_requests, None, seed=7)
    print(f"[{name}] " + json.dumps(p99), flush=True)
    bulk = run_seq_cell(name, model, registry.cell_by_name("serve_bulk"),
                        bulk_rows, bulk_requests, check_rows, seed=8)
    print(f"[{name}] " + json.dumps(bulk), flush=True)


# ---------------------------------------------------------------------------
# phase J: DeepFM training on the card (train_batch at published width)
# ---------------------------------------------------------------------------
class BackwardLog(Recorder):
    """Every ``fused_fm.fused_fm_backward`` launch against the plain
    gradient on the same tensors: |kernel - plain| at most J_GRAD_TOL x
    max |g| (the gradient is g[b] times a column sum less an element; g ~
    1/B makes any fixed absolute tolerance vacuous)."""

    def __init__(self):
        super().__init__(fm, "fused_fm_backward")

    def check(self, args, kw, out) -> None:
        emb, g = args
        want = ref.fused_fm_backward(emb, g)
        err = float((out.float() - want.float()).abs().max())
        scale = float(g.abs().max())
        self.max_err = max(self.max_err, err)
        if err > J_GRAD_TOL * scale:
            fail(f"fused_fm_backward differs from the plain gradient on "
                 f"{tuple(emb.shape)} (max abs err {err}, max |g| {scale})")


def fm_backward_bound_ms(shape):
    """(bound ms, bound by) of the gradient at fp32 [B, F, D]: x read and
    grad written once, g read once; a sub and a mul an element, an add a
    column sum term."""
    b, f, d = shape
    t_bytes = (2 * b * f * d * 4 + b * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * b * f * d / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure_fm_backward(bwd_log, flush):
    """fused_fm_backward at phase J's shape (its last launch's inputs), by
    events and by profiler, cold L2, beside the plain gradient and the
    bound; first held against the plain gradient once more."""
    emb, g = bwd_log.last
    kernel = functools.partial(fm.fused_fm_backward, emb, g)
    got, want = kernel(), ref.fused_fm_backward(emb, g)
    err = float((got - want).abs().max())
    if err > J_GRAD_TOL * float(g.abs().max()):
        fail(f"fused_fm_backward differs from the plain gradient at "
             f"{tuple(emb.shape)} (max abs err {err})")
    del got, want
    bound, by = fm_backward_bound_ms(tuple(emb.shape))
    n_sm = torch.cuda.get_device_properties(emb.device).multi_processor_count
    p = fm.backward_plan(*emb.shape, emb.element_size(), n_sm,
                         emb.data_ptr() % 16 == 0)
    return {"name": "fused_fm_backward", "route": "cuda",
            "source": SOURCE["fused_fm_backward"],
            "replaces": REPLACES["fused_fm_backward"],
            "replaces_note": "the gradient of that kernel's function: the "
                             "JAX package has no gradient kernel and "
                             "differentiates its jnp oracle "
                             "(src/repro/kernels/ref.py:59)",
            "launches": None, "max_abs_err": bwd_log.max_err,
            "shape": list(emb.shape), "staged": p.staged,
            "tile_samples": p.tile, "blocks": p.blocks,
            "ms": time_ms(kernel, 50, flush),
            "kernel_ms": kernel_ms(kernel, "fused_fm_backward", 50, flush),
            "host_ms": host_ms(kernel, 50),
            "plain_ms": time_ms(lambda: ref.fused_fm_backward(emb, g), 20,
                                flush),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes the FM term's "
                            "gradient"}


def _params_close(got, want, state, lr):
    """(max abs err, leaf) of ``got`` against ``want`` after one step from
    the same state; fails where an element is off by more than 1e-5 +
    1e-5 |want|, or, where Adam's update was ill-conditioned (``state``'s
    sqrt(v̂) < 1e-6: a gradient near Adam's eps of 1e-8, whose size a sum's
    order decides, moves its weight by up to ``lr``), by more than
    ``lr``."""
    worst, where = 0.0, None
    for k, w in want.items():
        err = (got[k].float() - w.float()).abs()
        bound = 1e-5 + 1e-5 * w.float().abs()
        if "v" in state.get(k, {}):
            vhat = state[k]["v"] / (1 - 0.999)
            bound = torch.where(vhat.sqrt() < 1e-6, lr, bound)
        if not bool((err <= bound).all()):
            fail(f"{k} is off by {float(err.max())} beyond its tolerance")
        if float(err.max()) > worst:
            worst, where = float(err.max()), k
    return worst, where


class Publisher:
    """The incremental loop of ``examples/train_recsys.py`` on the port's
    engine: the rows touched since the last publish go in as a seed
    ``publish`` (version 1) or a ``publish_delta`` (every later version),
    keys ``row + 1``, values the trained rows' fp32 bytes; then a sample of
    them is read at the new version and must equal the trained rows
    bitwise."""

    def __init__(self, device, seed=13):
        self.engine = eng.MultiTableEngine(
            max_shard_bytes=CONFIG.max_shard_bytes, retain=2, device=device)
        self.touched: list = []
        self.version = 0
        self.rng = np.random.default_rng(seed)
        self.log = []

    def add(self, delta_ids, field_vocab):
        """Keeps the distinct rows of field 0 among a step's flat field
        ids (``delta_ids``), on the host."""
        ids = torch.unique(delta_ids)
        self.touched.append(
            ids[ids < field_vocab].cpu().numpy().astype(np.int64))

    def publish(self, table: torch.Tensor) -> dict:
        rows = np.unique(np.concatenate(self.touched))
        self.touched.clear()
        keys = rows.astype(np.uint64) + np.uint64(1)
        vals = table[torch.as_tensor(rows, device=table.device)].float() \
            .cpu().numpy().view(np.uint8)
        self.version += 1
        t0 = time.perf_counter()
        if self.version == 1:
            self.engine.publish(self.version, embeddings=[eng.EmbeddingTable(
                "field_table", keys, vals, hot_fraction=0.25)])
            mode = "seed"
        else:
            self.engine.publish_delta(
                self.version, upserts={"field_table": (keys, vals)})
            mode = "delta"
        ms = (time.perf_counter() - t0) * 1e3
        pick = self.rng.choice(len(rows), min(J_READBACK, len(rows)),
                               replace=False)
        res = self.engine.query({"field_table": keys[pick]})
        got = res["field_table"]
        if res.version != self.version or not bool(got.found.all()) or \
                not np.array_equal(got.values, vals[pick]):
            fail(f"[J] version {self.version} ({mode}) does not read back "
                 f"the trained rows bitwise")
        entry = {"version": self.version, "mode": mode, "rows": int(
            len(rows)), "ms": ms, "read_back": int(len(pick))}
        self.log.append(entry)
        print(f"[J] published v{self.version} ({mode}): {len(rows)} rows in "
              f"{ms:.1f} ms; {len(pick)} read back bitwise", flush=True)
        return entry


def timed_steps(fn, params, state, step, batches, on_step=None):
    """Runs ``fn`` over ``batches``, each step timed by CUDA events (on the
    card) and by the host clock up to a synchronize; ``on_step(i, params,
    metrics)`` runs after each step, outside its timing.  Returns the last
    (params, state, step), the per-step ms and the metrics."""
    ev_ms, host, metrics = [], [], []
    cuda = next(iter(params.values())).device.type == "cuda"
    for i, b in enumerate(batches):
        if cuda:
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            s.record()
        t0 = time.perf_counter()
        params, state, step, m = fn(params, state, step, b)
        if cuda:
            e.record()
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev_ms.append(s.elapsed_time(e))
        metrics.append(m)
        if on_step is not None:
            on_step(i, params, state, m)
    return params, state, step, ev_ms, host, metrics


def step_summary(rows, ev_ms, host, metrics):
    return {"steps": len(host), "event_ms": ev_ms, "host_ms": host,
            "event_ms_median": float(np.median(ev_ms)) if ev_ms else None,
            "host_ms_median": float(np.median(host)),
            "examples_per_s": rows / (float(np.median(host)) / 1e3),
            "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics]}


def run_phase_j(device, fm_log, bwd_log, cfg=deepfm.CONFIG, rows=J_ROWS,
                steps=J_STEPS, ckpt_dir=None):
    """DeepFM's train_batch (by default at full published width) on the
    card, through both train steps of the JAX package; returns the phase's
    metrics and the number of steps that ran the FM kernels."""
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ocfg = train_opt.OptConfig()
    t0 = time.perf_counter()
    params0 = convert.params_of(rec.recsys_init(cfg, seed=0, device=device))
    n_bytes = sum(p.numel() * p.element_size() for p in params0.values())
    print(f"[J] {cfg.name}: {n_bytes} parameter bytes, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    batches = draw_requests(
        lambda rng: (synthetic.recsys_batch(rng, cfg, rows),), steps + 2,
        seed=21)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for (b,) in batches]
    print(f"[J] drew and uploaded {steps + 2} batches of {rows} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernel_steps = 0

    def checked(n=1):
        nonlocal kernel_steps
        fm_log.check_pending()
        bwd_log.check_pending()
        kernel_steps += n

    # the first step, kernels against the plain versions: every launch on
    # the same tensors, then the whole step again with the plain FM
    def fields(b):                    # the step's flat field ids
        return {"field_table": rec.table_ids(cfg, b)["field_rows"][1]
                .reshape(-1)}

    dense = train_step.make_train_step(train_step.recsys_loss_fn(cfg), ocfg,
                                       delta_ids_fn=fields)
    s0 = train_opt.init_opt_state(params0, ocfg)
    p1, s1, st, m1 = dense(params0, s0, 0, batches[0])
    checked()
    with fm_log.plain():
        pp, sp, _, mp = dense(params0, s0, 0, batches[0])
    loss_err = abs(float(m1["loss"]) - float(mp["loss"]))
    if loss_err > J_TOL:
        fail(f"[J] the step's loss with the FM kernels differs from the "
             f"plain FM's by {loss_err}")
    param_err, param_where = _params_close(p1, pp, sp, ocfg.lr)
    del pp, sp, mp
    publisher = Publisher(device)
    publisher.add(m1["delta_ids"]["field_table"], cfg.field_vocab)

    # dense: 8 timed steps after that warm-up, a publish every 4 steps, a
    # checkpoint after step 4 (global), step 5's output kept
    saved = {}

    def after_dense(i, params, state, m):
        step = i + 2                                  # the global step
        publisher.add(m["delta_ids"]["field_table"], cfg.field_vocab)
        checked()
        if step % J_PUBLISH_EVERY == 0:
            publisher.publish(params["field_table"])
        if step == J_CKPT_STEP and ckpt_dir:
            t0 = time.perf_counter()
            train_ckpt.save(ckpt_dir, params=params, opt_state=state,
                            step=step, meta={"arch": cfg.name})
            saved["save_s"] = time.perf_counter() - t0
            saved["at_save"] = (params, state)
        if step == J_CKPT_STEP + 1:
            saved["params"], saved["loss"] = params, float(m["loss"])

    p, s, st, ev, host, ms = timed_steps(dense, p1, s1, st,
                                         batches[1:steps + 1], after_dense)
    m_dense = step_summary(rows, ev, host, ms)
    m_dense["peak_bytes"] = max_memory(device)
    del p, s
    # the checkpoint: restore into fresh tensors, take step 5 again
    ck = {}
    if ckpt_dir:
        t0 = time.perf_counter()
        rp, rs, rstep, _ = train_ckpt.restore(
            ckpt_dir, params_like=params0, opt_like=s0)
        ck = {"save_s": saved["save_s"],
              "restore_s": time.perf_counter() - t0, "step": rstep}
        # the restore gives back exactly what was saved...
        at_params, at_state = saved.pop("at_save")
        if rstep != J_CKPT_STEP or not all(
                torch.equal(rp[k], at_params[k]) for k in rp) or not all(
                torch.equal(rs[k][n], at_state[k][n])
                for k in rs for n in rs[k]):
            fail("[J] the checkpoint did not restore what was saved")
        del at_params, at_state
        # ...and the next step from it is the uninterrupted run's: bitwise
        # on the card, where every operation of the dense step sums in a
        # fixed order (the gather's backward sorts its ids, the FM kernels
        # and the GEMMs do not race); within _params_close's tolerance on
        # the CPU (a rehearsal), whose gather backward adds a row's
        # duplicate ids in an order that may change from run to run
        p_next, _, _, m_next = dense(rp, rs, rstep, batches[rstep])
        checked()
        ck["loss"] = [float(m_next["loss"]), saved["loss"]]
        ck["bitwise"] = ck["loss"][0] == ck["loss"][1] and all(
            torch.equal(p_next[k], saved["params"][k]) for k in p_next)
        if cuda and not ck["bitwise"]:
            fail(f"[J] step {rstep + 1} from the checkpoint is not the "
                 f"uninterrupted run's bitwise (losses {ck['loss']})")
        if abs(ck["loss"][0] - ck["loss"][1]) > J_TOL:
            fail(f"[J] step {rstep + 1} from the checkpoint has loss "
                 f"{ck['loss'][0]}, the uninterrupted run {ck['loss'][1]}")
        ck["param_max_abs_err"], _ = _params_close(p_next, saved["params"],
                                                   rs, ocfg.lr)
        del rp, rs, p_next
        shutil.rmtree(ckpt_dir)
    saved.clear()
    # the traced step (dense, from the first step's state)
    prof = request_profiler(device)
    with prof:
        t0 = time.perf_counter()
        pt, _, _, _ = dense(p1, s1, 1, batches[steps + 1])
        if cuda:
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    checked()
    del pt
    busy_ms, busy_events = device_busy_ms(prof)
    traced = {"ms": traced_ms, "device_busy_ms": busy_ms,
              "device_events": busy_events,
              "busy_share": busy_ms / traced_ms,
              "busy_share_of_median": busy_ms / m_dense["host_ms_median"],
              "kernels_ms": kernels_by_device_ms(prof, top=8),
              "peak_bytes": max_memory(device)}
    del p1, s1
    gc.collect()
    # sparse: the same, from the same initial parameters (the step updates
    # the tables in place, and params0 is not needed after it)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sparse = train_step.make_sparse_recsys_train_step(cfg, ocfg)
    sp0 = train_opt.init_opt_state(params0, ocfg)
    p, s, st, _ = sparse(params0, sp0, 0, batches[0])
    checked()
    p, s, st, ev, host, ms = timed_steps(
        sparse, p, s, st, batches[1:steps + 1],
        lambda i, params, state, m: checked())
    m_sparse = step_summary(rows, ev, host, ms)
    m_sparse["peak_bytes"] = max_memory(device)
    del p, s, params0
    m = {"phase": "J", "model": cfg.name, "rows": rows,
         "first_step": {"loss_kernel": float(m1["loss"]),
                        "loss_err_vs_plain_fm": loss_err,
                        "param_max_abs_err_vs_plain_fm": param_err,
                        "param_worst_leaf": param_where},
         "dense": m_dense, "sparse": m_sparse,
         "publishes": publisher.log, "checkpoint": ck, "traced_step": traced,
         "fm_max_abs_err": fm_log.max_err,
         "fm_backward_max_abs_err": bwd_log.max_err,
         "kernel_steps": kernel_steps,
         "phase_s": time.perf_counter() - t_phase}
    return m


# ---------------------------------------------------------------------------
# phase K: the streaming online-learning loop, with DIN trained on the card
# ---------------------------------------------------------------------------
def din_params_model(params):
    """DIN's path-keyed parameters as ``din_logits64`` reads a model."""
    attn = rec._path_layers(params, "attn_mlp")
    mlp = rec._path_layers(params, "mlp")
    return types.SimpleNamespace(
        item_table=params["item_table"], cat_table=params["cat_table"],
        attn_mlp_w=[w for w, _ in attn], attn_mlp_b=[b for _, b in attn],
        mlp_w=[w for w, _ in mlp], mlp_b=[b for _, b in mlp])


def run_phase_k1(device, cfg=din.CONFIG, rows=J_ROWS, steps=J_STEPS,
                 check_rows=K_CHECK_ROWS):
    """DIN's train_batch (by default at full published width) on the card
    through the dense step ``launch/train.py`` builds (``train_cell``: a
    warm-up, ``steps`` timed steps and one traced).  The first step's
    logits on ``check_rows`` fixed rows are held against a float64
    recompute; every loss and ``grad_norm`` must be finite."""
    t_phase = time.perf_counter()
    dense = train_cell("K.1", cfg, dense_step, device, rows=rows,
                       steps=steps, seed=31,
                       first=seq_first_step("K.1", cfg, check_rows, 31))
    return {"phase": "K.1", "model": cfg.name, "rows": rows, "dense": dense,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "phase_s": time.perf_counter() - t_phase}


class LoopRecorder:
    """What phase K.2 reads of the realtime loop, through wrappers around
    the launcher's own functions (``installed``):

    * a host shadow of the item rows, in version order: the seed's bytes,
      then every publish, delta or full, written as the client's
      ``update`` returns (the publisher calls it under its lock, so one
      at a time, in version order);
    * each ``update``'s ms, full and delta apart;
    * each trainer step's host ms (the two warm-ups apart)."""

    def __init__(self):
        self.shadow = None
        self.version = 1
        self.order_errors = []
        self.clients = []
        self.full_ms, self.delta_ms, self.step_ms = [], [], []
        self.warmup_ms = []

    def written(self, version, upserts, embeddings, ms):
        if version != self.version + 1:
            self.order_errors.append((self.version, version))
        self.version = version
        full = [t for t in embeddings if t.name == "item_table"]
        for t in full:
            self.shadow[:] = t.values
        if "item_table" in upserts:
            keys, vals = upserts["item_table"]
            self.shadow[np.asarray(keys, np.int64) - 1] = vals
        (self.full_ms if embeddings else self.delta_ms).append(ms)

    @contextlib.contextmanager
    def installed(self):
        rec_ = self
        real_build, real_make = realtime.build_engine, realtime.make_step_fn
        real_client = realtime.FeatureClient

        class Client(real_client):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec_.clients.append(self)

            def update(self, version, *, upserts=None, deletes=None,
                       scalars=(), embeddings=()):
                t0 = time.perf_counter()
                super().update(version, upserts=upserts, deletes=deletes,
                               scalars=scalars, embeddings=embeddings)
                rec_.written(version, upserts or {}, embeddings,
                             (time.perf_counter() - t0) * 1e3)

        def build_engine(args, item_table):
            engine = real_build(args, item_table)
            rec_.shadow = realtime._leading_rows_as_bytes(item_table,
                                                          args.n_items)
            return engine

        def make_step_fn(args, cfg, params):
            step_fn, holder = real_make(args, cfg, params)

            def timed(events):
                t0 = time.perf_counter()
                out = step_fn(events)
                ms = (time.perf_counter() - t0) * 1e3
                (rec_.warmup_ms if len(rec_.warmup_ms) < 2
                 else rec_.step_ms).append(ms)
                return out

            return timed, holder

        realtime.build_engine, realtime.make_step_fn = build_engine, \
            make_step_fn
        realtime.FeatureClient = Client
        try:
            yield self
        finally:
            realtime.build_engine, realtime.make_step_fn = real_build, \
                real_make
            realtime.FeatureClient = real_client


def run_phase_k2(device, cfg=None, n_items=K_ITEMS, n_users=K_USERS,
                 requests=K_REQUESTS, window_s=K_WINDOW_S):
    """The realtime loop (``launch/realtime.drive``) with DIN at published
    width but ``item_vocab = n_items`` (default), the JAX loop's other
    defaults, ``requests`` sessions a client, ``--trace-sample 0.05`` and
    the exporter on an ephemeral port, scraped once mid-run; the card
    traced over a window of the loop.  After the drain every item row at
    the final version must be the bytes of the last publish that wrote
    it."""
    t_phase = time.perf_counter()
    if cfg is None:
        cfg = dataclasses.replace(din.CONFIG, item_vocab=n_items)
    args = realtime.parse_args([
        "--n-items", str(n_items), "--n-users", str(n_users),
        "--requests", str(requests), "--trace-sample", str(K_TRACE_SAMPLE),
        "--device", device.type])
    registry_obj = realtime.Registry()
    tracer = realtime.Tracer(sample_rate=args.trace_sample, proc="realtime")
    recorder = LoopRecorder()
    with realtime.MetricsServer(registry_obj) as srv, recorder.installed(), \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(realtime.drive, args, registry_obj, tracer, cfg)
        # mid-run: once the loop has published K_SCRAPE_AFTER deltas
        while len(recorder.delta_ms) < K_SCRAPE_AFTER and not run.done():
            time.sleep(0.01)
        if run.done():
            fail(f"[K.2] the loop ended before {K_SCRAPE_AFTER} deltas: "
                 f"{run.result()}")
        t0 = time.perf_counter()
        with urllib.request.urlopen(srv.url, timeout=30) as r:
            body = r.read().decode()
        scrape_ms = (time.perf_counter() - t0) * 1e3
        parsed = exporter.parse_text(body)
        fresh_n = parsed.get(("repro_stream_freshness_seconds_count", ()))
        fresh_inf = parsed.get(("repro_stream_freshness_seconds_bucket",
                                (("le", "+Inf"),)))
        if not fresh_n or fresh_inf != fresh_n:
            fail(f"[K.2] the mid-run scrape shows {fresh_n} freshness "
                 f"samples (+Inf bucket {fresh_inf})")
        # the card over a window of the running loop
        steps_before = len(recorder.step_ms)
        prof = request_profiler(device)
        with prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < window_s and not run.done():
                time.sleep(0.01)
            window_ms = (time.perf_counter() - t0) * 1e3
        steps_in_window = len(recorder.step_ms) - steps_before
        busy_ms, busy_events = device_busy_ms(prof)
        rc, report = run.result()
    print("[K.2] realtime SLO report: " + json.dumps(report, sort_keys=True),
          flush=True)
    if rc != 0:
        fail(f"[K.2] the loop exited {rc}: {report}")
    if report["deltas_published"] < 1 or report["queries"] < 1:
        fail(f"[K.2] the loop did not run: {report}")
    if recorder.order_errors:
        fail(f"[K.2] publishes out of version order: "
             f"{recorder.order_errors[:5]}")
    if not recorder.full_ms:
        fail("[K.2] the batch layer published no full table set")
    if recorder.version != report["final_version"]:
        fail(f"[K.2] the shadow is at version {recorder.version}, the "
             f"loop's final version {report['final_version']}")
    # every item row served at the final version: the last publish's bytes
    direct = api.FeatureClient(recorder.clients[0].backend)
    keys = np.arange(1, n_items + 1, dtype=np.uint64)
    res = direct.query({"item_table": keys},
                       consistency=api.Consistency.pinned(
                           report["final_version"]))
    rows = res.tables["item_table"]
    if res.version != report["final_version"] or not rows.found.all():
        fail(f"[K.2] the final read served version {res.version}, "
             f"{int(rows.found.sum())} of {n_items} rows found")
    differ = int((rows.values != recorder.shadow).any(axis=1).sum())
    if differ:
        fail(f"[K.2] {differ} of {n_items} item rows at the final version "
             f"differ from the bytes last published for them")
    steps = np.asarray(recorder.step_ms)
    return {"phase": "K.2", "model": cfg.name, "n_items": n_items,
            "n_users": n_users, "clients": args.clients,
            "requests_per_client": args.requests,
            "train_batch": args.train_batch,
            "batch_publish_s": args.batch_publish_s, "slo_s": args.slo_s,
            "report": report,
            "trainer_step_ms": {
                "steps": len(steps), "warmup_ms": recorder.warmup_ms,
                "p50": float(np.percentile(steps, 50)),
                "p99": float(np.percentile(steps, 99)),
                "mean": float(steps.mean())},
            "full_publish": {
                "count": len(recorder.full_ms), "ms": recorder.full_ms,
                "fits_batch_publish_s": bool(
                    recorder.full_ms
                    and max(recorder.full_ms) < args.batch_publish_s * 1e3)},
            "delta_publish_ms": {
                "count": len(recorder.delta_ms),
                "p50": float(np.percentile(recorder.delta_ms, 50)),
                "p99": float(np.percentile(recorder.delta_ms, 99))},
            "mid_run_scrape": {"bytes": len(body), "ms": scrape_ms,
                               "freshness_samples": fresh_n,
                               "series": len(parsed)},
            "traced_window": {
                "ms": window_ms, "trainer_steps": steps_in_window,
                "device_busy_ms": busy_ms, "device_events": busy_events,
                "busy_share": busy_ms / window_ms,
                "kernels_ms": kernels_by_device_ms(prof, top=6)},
            "traces_sampled": tracer.sampled_total,
            "rows_checked_bitwise": n_items,
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phases L and M: BST and two-tower training on the card
# ---------------------------------------------------------------------------
class BagBackwardLog(Recorder):
    """Every ``embedding_bag.embedding_bag_backward`` launch against the
    plain gradient on the same tensors, element by element: |kernel -
    plain| <= min(2 n 2^-24, BAG_GRAD_REL) S + 1e-30, n the terms the row
    adds and S the sum of their magnitudes (both add the same n terms, the
    atomics in an order that changes from run to run: recursive
    summation's bound, Higham; on hot rows, where that bound is loose, a
    fixed share of S).  Keeps the largest |kernel - plain| / S and the
    largest n."""

    def __init__(self):
        super().__init__(bagk, "embedding_bag_backward")
        self.max_rel = 0.0
        self.max_n = 0

    def check(self, args, kw, out) -> None:
        err = ref.embedding_bag_backward(*args).sub_(out).abs_()
        mag, n = ref.embedding_bag_backward_terms(*args)
        self.max_err = max(self.max_err, float(err.max()))
        self.max_rel = max(self.max_rel, float(torch.where(
            mag > 0, err / mag, 0.0).max()))
        self.max_n = max(self.max_n, int(n.max()))
        share = (n.to(mag.dtype) * (2 * BAG_GRAD_U)).clamp_(max=BAG_GRAD_REL)
        bound = mag.mul_(share[:, None]).add_(1e-30)
        if not bool((err <= bound).all()):
            fail(f"embedding_bag_backward differs from the plain gradient "
                 f"beyond min(2 n 2^-24, {BAG_GRAD_REL}) S on "
                 f"{tuple(args[1].shape)} (max abs err {float(err.max())})")


def train_cell(tag, cfg, make_step, device, *, rows, steps, seed,
               first=None, after=None, peak_limit=None):
    """``cfg`` from seed 0 on ``device`` (by default the card), trained on
    ``steps`` + 2 batches of ``rows`` drawn and uploaded first: a warm-up,
    ``steps`` timed steps (events and host clock) and one traced.
    ``first(params, batch)`` runs at the initial parameters before the
    warm-up; ``after(i, params, state, metrics)`` after every step.
    Returns None, without the timed steps, when the warm-up's peak memory
    reaches ``peak_limit``; else the cell's metrics."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ocfg = train_opt.OptConfig()
    t0 = time.perf_counter()
    params = convert.params_of(rec.recsys_init(cfg, seed=0, device=device))
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    vocabs = f"item_vocab {cfg.item_vocab}" + (
        f", user_vocab {cfg.user_vocab}" if cfg.arch == "two_tower" else "")
    print(f"[{tag}] {cfg.name}: {n_bytes} parameter bytes ({vocabs}), drawn "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    batches = [{k: v.to(device) for k, v in b.items()}
               for (b,) in draw_requests(lambda rng: (launch_train.train_batch(
                   rng, cfg, rows, "cpu"),), steps + 2, seed)]
    print(f"[{tag}] drew and uploaded {steps + 2} batches of {rows} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    info = first(params, batches[0]) if first else {}
    fn = make_step(cfg, ocfg)
    state = train_opt.init_opt_state(params, ocfg)
    p, s, st, _, host0, m0 = timed_steps(fn, params, state, 0, batches[:1],
                                         after)
    del params, state
    first_peak = max_memory(device)
    print(f"[{tag}] warm-up step: {host0[0]:.0f} ms, peak {first_peak} B",
          flush=True)
    if peak_limit is not None and first_peak is not None \
            and first_peak >= peak_limit:
        return None
    ev, host, ms = [], [], []
    for b in batches[1:steps + 1]:    # one call a step: no step's inputs
        p, s, st, e, h, m = timed_steps(fn, p, s, st, [b], after)
        ev, host, ms = ev + e, host + h, ms + m       # outlive it here
    summary = step_summary(rows, ev, host, ms)
    summary["warmup_host_ms"] = host0[0]
    prof = request_profiler(device)
    with prof:
        t0 = time.perf_counter()
        p, s, st, mt = fn(p, s, st, batches[steps + 1])
        if cuda:
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if after is not None:
        after(steps + 1, p, s, mt)
    del p, s
    losses = [float(m["loss"]) for m in m0 + ms + [mt]]
    norms = [float(m["grad_norm"]) for m in m0 + ms + [mt]]
    if not np.isfinite(losses + norms).all():
        fail(f"[{tag}] losses {losses} or grad norms {norms} are not "
             f"finite")
    busy_ms, busy_events = device_busy_ms(prof)
    return {"model": cfg.name, "item_vocab": cfg.item_vocab,
            **({"user_vocab": cfg.user_vocab} if cfg.arch == "two_tower"
               else {}), "rows": rows,
            "parameter_bytes": n_bytes, **info, "steps": summary,
            "loss_all_steps": losses, "grad_norm_all_steps": norms,
            "first_step_peak_bytes": first_peak,
            "max_memory_allocated": max_memory(device),
            "traced_step": {
                "ms": traced_ms, "device_busy_ms": busy_ms,
                "device_events": busy_events,
                "busy_share": busy_ms / traced_ms,
                "busy_share_of_median": busy_ms / summary["host_ms_median"],
                "kernels_ms": kernels_by_device_ms(prof, top=8)}}


def dense_step(cfg, ocfg):
    return train_step.make_train_step(train_step.recsys_loss_fn(cfg), ocfg)


def sparse_step(cfg, ocfg):
    return train_step.make_sparse_recsys_train_step(cfg, ocfg)


def bst_params_model(params, cfg):
    """BST's path-keyed parameters as ``bst_logits64`` reads a model."""
    mlp = rec._path_layers(params, "mlp")
    return types.SimpleNamespace(
        cfg=cfg, item_table=params["item_table"],
        pos_table=params["pos_table"],
        blocks=[{k: params[f"blocks/{i}/{k}"] for k in rec.BST_BLOCK}
                for i in range(cfg.n_blocks)],
        mlp_w=[w for w, _ in mlp], mlp_b=[b for _, b in mlp])


SEQ_LOGITS64 = {"din": (lambda params, cfg: din_params_model(params),
                        din_logits64),
                "bst": (bst_params_model, bst_logits64)}


def seq_first_step(tag, cfg, check_rows, seed):
    """K.1's and L's check at the initial parameters: the first step's
    logits on ``check_rows`` fixed rows against float64, and the item rows
    its gather reads (padding clamped to row 0, as ``embed_lookup`` clamps
    it: the backward adds every one of them into the table's gradient)."""
    to_model, logits64 = SEQ_LOGITS64[cfg.arch]

    def first(params, b0):
        rows = b0["dense"].shape[0]
        idx = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
            rows, check_rows, replace=False))).to(b0["dense"].device)
        with torch.no_grad():
            logits = rec.FORWARD_ROWS[cfg.arch](
                params, cfg, b0, rec.gather_rows(params, cfg, b0))
        want = logits64(to_model(params, cfg),
                        {k: v[idx] for k, v in b0.items()})
        err = float((logits[idx].double() - want).abs().max())
        if not (logits.shape == (rows,) and err <= SEQ_TOL):
            fail(f"[{tag}] the first step's logits {tuple(logits.shape)} "
                 f"differ from the float64 recompute by {err}")
        ids = torch.cat([x.reshape(-1) for t, x in
                         rec.table_ids(cfg, b0).values()
                         if t == "item_table"])
        _, counts = torch.unique(ids.clamp(min=0), return_counts=True)
        return {"first_step_logit_max_abs_err_vs_fp64": err,
                "logit_rows_checked": check_rows,
                "first_batch_item_gather": {
                    "ids": ids.numel(), "unique": counts.numel(),
                    "hottest_row_count": int(counts.max()),
                    "padding": int((ids < 0).sum())}}
    return first


def run_phase_l(device, cfg=bst.CONFIG, rows=J_ROWS, steps=J_STEPS,
                check_rows=K_CHECK_ROWS, vocabs=L_VOCABS):
    """BST's train_batch (by default at full published width) on the card:
    the dense step ``launch/train.py`` builds at the first of ``vocabs``
    that fits, then the sparse step at ``cfg``'s own item_vocab.  Neither
    reaches a kernel."""
    t_phase = time.perf_counter()
    for vocab in vocabs:
        cut = dataclasses.replace(cfg, item_vocab=vocab)
        try:
            dense = train_cell("L", cut, dense_step, device, rows=rows,
                               steps=steps, seed=51,
                               first=seq_first_step("L", cut, check_rows,
                                                    41))
            break
        except torch.OutOfMemoryError as e:
            print(f"[L] the dense step at item_vocab {vocab} does not fit: "
                  f"{str(e).splitlines()[0]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    else:
        fail(f"[L] the dense step fits at none of item_vocab {vocabs}")
    if vocab != cfg.item_vocab:
        print(f"reduced: phase L's dense step item_vocab {cfg.item_vocab}->"
              f"{vocab} (the step's dense table gradient and its optimizer "
              f"temporaries do not fit the card at {cfg.item_vocab})",
              flush=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sparse = train_cell("L", cfg, sparse_step, device, rows=rows,
                        steps=steps, seed=52)
    return {"phase": "L", "model": cfg.name, "rows": rows,
            "dense_item_vocab": vocab, "dense": dense, "sparse": sparse,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "phase_s": time.perf_counter() - t_phase}


def kernel_counts() -> dict:
    return {**nl.launches, **fm.launches, **bagk.launches}


def run_phase_m(device, cfg=two_tower_retrieval.CONFIG, rows=J_ROWS,
                steps=J_STEPS, vocabs=M_VOCABS, min_items=M_MIN_ITEMS,
                peak_limit=M_PEAK_BYTES, flush=None):
    """Two-tower's train_batch on the card.  M.1: the dense step
    ``launch/train.py`` builds (the history bag through ``EmbeddingBag``:
    one ``embedding_bag`` and one ``embedding_bag_backward`` launch a
    step, each forward launch checked by a ``BagLog`` and each backward
    launch by a ``BagBackwardLog`` after its step), with ``cfg``'s user
    and item vocabularies cut to ``vocabs`` and halved together until the
    warm-up's peak stays under ``peak_limit``; the first step's loss held
    within 1e-5 of the same step's with the plain bag.  Where ``flush`` is
    given (on the card), M.1's last bag lookup is timed (``bag_timing``:
    its ids over a table of its shape drawn anew, since the logs keep no
    step's table past its step, which would raise the peak the step
    reports) before M.2: the sparse step at ``cfg``'s own vocabularies,
    which launches no kernel.  Returns the phase's metrics, each part's kernel
    launches and M.1's two logs."""
    t_phase = time.perf_counter()
    users, items = vocabs
    plain, last_bag = {}, {}

    def first(params, b0):            # the step's loss with the plain bag
        with torch.no_grad(), bag_log.plain():
            plain["loss"] = float(train_step.recsys_loss_fn(cut)(
                params, b0)[0])
        return {}

    def after(*_):
        bag_log.check_pending()
        bwd_log.check_pending()
        table, last_bag["ids"], _ = bag_log.last
        last_bag["shape"] = table.shape
        bag_log.last = None           # the step's table goes with its step

    while True:                       # each attempt counts from zero
        cut = dataclasses.replace(cfg, user_vocab=users, item_vocab=items)
        zero(nl.launches, fm.launches, bagk.launches, bagk.paths)
        with BagLog() as bag_log, BagBackwardLog() as bwd_log:
            try:
                dense = train_cell(
                    "M.1", cut, dense_step, device, rows=rows, steps=steps,
                    seed=61, first=first, peak_limit=peak_limit,
                    after=after)
            except torch.OutOfMemoryError as e:
                print(f"[M.1] the dense step at {users} users, {items} "
                      f"items does not fit: {str(e).splitlines()[0]}",
                      flush=True)
                dense = None
        if dense is not None:
            break
        del bag_log, bwd_log
        gc.collect()
        torch.cuda.empty_cache()
        users, items = users // 2, items // 2
        if items < min_items:
            fail(f"[M.1] the dense step does not fit under {peak_limit} B "
                 f"at {2 * items} items or more")
    m1_counts = kernel_counts()
    dense["embedding_bag_paths"] = dict(bagk.paths)
    print(f"reduced: phase M.1 (the dense step) user_vocab {cfg.user_vocab}"
          f"->{users}, item_vocab {cfg.item_vocab}->{items} (its dense "
          f"table gradients and the optimizer's temporaries; the first "
          f"step's peak {dense['first_step_peak_bytes']} B, under "
          f"{peak_limit} B)", flush=True)
    loss_err = abs(dense["loss_all_steps"][0] - plain["loss"])
    if loss_err > J_TOL:
        fail(f"[M.1] the first step's loss with the bag kernels differs "
             f"from the plain bag's by {loss_err}")
    dense.update(first_step_loss_plain_bag=plain["loss"],
                 first_step_loss_err_vs_plain_bag=loss_err,
                 forward_launches_checked=bag_log.checked,
                 forward_max_abs_err=bag_log.max_err,
                 backward_launches_checked=bwd_log.checked,
                 backward_max_abs_err=bwd_log.max_err,
                 backward_max_err_over_S=bwd_log.max_rel,
                 backward_max_terms_a_row=bwd_log.max_n)
    if flush is not None:     # the last step's ids over rows drawn anew
        dense["bag_timing"] = bag_timing(
            torch.randn(last_bag["shape"], device=device), last_bag["ids"],
            flush, 20, 5)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    zero(nl.launches, fm.launches, bagk.launches)
    sparse = train_cell("M.2", cfg, sparse_step, device, rows=rows,
                        steps=steps, seed=62)
    return {"phase": "M", "model": cfg.name, "rows": rows,
            "dense": dense, "sparse": sparse,
            "phase_s": time.perf_counter() - t_phase}, \
        m1_counts, kernel_counts(), bag_log, bwd_log


def bag_backward_bound(ids, weights, n_rows, dim):
    """The least time of the bag's gradient at ``ids`` [B, L] (and
    ``weights``) and fp32 g [B, dim] into [n_rows, dim] on this card: g,
    the ids and the weights read once, the dense gradient written once
    (its adds, one a valid entry and column, are far below the bytes).
    Beside it the kernel's own share, which adds into a zero-filled
    gradient: the same reads and each distinct touched row read and
    written once; and the zero-fill's, [n_rows, dim] written once."""
    valid = ids[(ids >= 0) & (ids < n_rows)]
    rows = int(torch.unique(valid).numel())
    io = ids.numel() * 4 * (1 if weights is None else 2) \
        + ids.shape[0] * dim * 4
    t_bytes = (io + n_rows * dim * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = valid.numel() * dim / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_bound_ms": (io + 2 * rows * dim * 4)
            / HBM_BYTES_PER_S * 1e3,
            "zero_fill_bound_ms": n_rows * dim * 4 / HBM_BYTES_PER_S * 1e3,
            "distinct_rows": rows}


def measure_bag_backward(bwd_log, flush):
    """embedding_bag_backward at M.1's shape (its last launch's inputs), by
    events (the wrapper: zero-fill and kernel) and by profiler (the kernel
    alone), cold L2, the zero-fill timed apart, beside the plain gradient,
    the bound and ``torch.autograd.grad`` of ``F.embedding_bag`` (mean,
    ``padding_idx`` a row appended to the table) on the same bags.  Also
    holds the kernel's scatter exactly: on g of ones in ``sum`` mode each
    row's gradient is the count of entries it takes, an integer fp32 adds
    exactly (below 2^24), so a dropped or repeated term shows even on the
    hottest row."""
    g, ids, w, mode, n_rows = bwd_log.last
    kernel = functools.partial(bagk.embedding_bag_backward, g, ids, w, mode,
                               n_rows)
    plain = functools.partial(ref.embedding_bag_backward, g, ids, w, mode,
                              n_rows)
    got = kernel()
    err = ref.embedding_bag_backward(g, ids, w, mode, n_rows).sub_(got)
    err = float(err.abs_().max())
    table = torch.zeros(n_rows + 1, g.shape[1], device=g.device,
                        requires_grad=True)
    bags = torch.where(ids >= 0, ids, n_rows).long()
    out = torch.nn.functional.embedding_bag(bags, table, mode=mode,
                                            padding_idx=n_rows)
    library = functools.partial(torch.autograd.grad, out, [table], g,
                                retain_graph=True)
    lib_diff = float((library()[0][:n_rows] - got).abs().max())
    del got
    counts = bagk.embedding_bag_backward(torch.ones_like(g), ids, None,
                                         "sum", n_rows)
    n = torch.bincount(ids[(ids >= 0) & (ids < n_rows)].long(),
                       minlength=n_rows)
    if not bool((counts == n[:, None].to(counts.dtype)).all()):
        fail("embedding_bag_backward on g of ones (sum) is not each row's "
             "count of entries")
    del counts, n
    grad = torch.empty(n_rows, g.shape[1], device=g.device)
    fill_ms = time_ms(grad.zero_, 20, flush)
    del grad
    ms = time_ms(kernel, 20, flush)
    return {"name": "embedding_bag_backward", "route": "cuda",
            "source": SOURCE["embedding_bag_backward"],
            "replaces": REPLACES["embedding_bag_backward"],
            "replaces_note": "the gradient of that kernel's function with "
                             "respect to the table: the JAX package has no "
                             "gradient kernel and differentiates its oracle "
                             "(src/repro/kernels/ref.py:39)",
            "launches": None, "max_abs_err": bwd_log.max_err,
            "max_err_over_S": bwd_log.max_rel,
            "max_terms_a_row": bwd_log.max_n,
            "shape": {"g": list(g.shape), "ids": list(ids.shape),
                      "rows": n_rows, "mode": mode},
            "check_max_abs_err": err, "counts_exact": True,
            "ms": ms, "kernel_ms": kernel_ms(
                kernel, "embedding_bag_backward_kernel", 20, flush),
            "zero_fill_ms": fill_ms, "host_ms": host_ms(kernel, 20),
            "plain_ms": time_ms(plain, 5, flush),
            **bag_backward_bound(ids, w, n_rows, g.shape[1]),
            "library_ms": time_ms(library, 20, flush),
            "library_max_abs_diff": lib_diff,
            "library_note": "torch.autograd.grad of F.embedding_bag(mode="
                            "'mean', padding_idx=V) into a [V + 1, D] "
                            "table, the padding row dropped"}


def plain_in_batch_softmax(u, i, logq):
    """The in-batch softmax as the port wrote it before the chunked one:
    the [B, B] logits through ``softmax_xent``, autograd's backward."""
    logits = (u @ i.T) / rec.TEMPERATURE - logq[None, :]
    return cm.softmax_xent(logits, torch.arange(u.shape[0],
                                                device=u.device))


def softmax_timing(device, flush, shapes=SOFTMAX_SHAPES, seed=63):
    """The in-batch softmax's loss and its gradients with respect to u, i
    and logq (unit u and i [B, D], logq [B] normal), the chunked one
    (``rec._in_batch_softmax``) beside ``plain_in_batch_softmax``, at each
    (B, D) of ``shapes``: device ms by events, cold L2, and peak bytes
    above the inputs.  Where both fit, the chunked loss is held within
    J_TOL of the plain one's and each gradient within SOFTMAX_GRAD_TAIL x
    sqrt(D) 2^-24 / T of its plain max: each version's logits carry its
    own fp32 rounding of a D-term dot of unit vectors, about sqrt(D)
    2^-24, over T = 0.05, and the softmax passes that on to every
    gradient as a relative error.  The plain one not fitting is recorded
    (it is the comparison, not the path)."""
    out = []
    for rows, dim in shapes:
        rng = np.random.default_rng(seed)
        u, i = (rng.normal(size=(rows, dim)).astype(np.float32)
                for _ in range(2))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        i /= np.linalg.norm(i, axis=1, keepdims=True)
        x = [torch.tensor(a, device=device, requires_grad=True)
             for a in (u, i, rng.normal(size=rows).astype(np.float32))]

        def run(f):
            loss = f(*x)
            return (loss.detach(), *torch.autograd.grad(loss, x))

        row, got = {"rows": rows, "dim": dim}, {}
        for name, f in (("chunked", rec._in_batch_softmax),
                        ("plain", plain_in_batch_softmax)):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            try:
                got[name] = run(f)
                peak = torch.cuda.max_memory_allocated(device) - base
                row[name] = {"ms": time_ms(lambda: run(f), 5, flush),
                             "peak_bytes": peak}
            except torch.OutOfMemoryError as e:
                got.pop(name, None)
                row[name] = {"fits": False,
                             "error": str(e).splitlines()[0]}
        if "plain" in got:
            (l0, *g0), (l1, *g1) = got["chunked"], got["plain"]
            row["loss_abs_err"] = float((l0 - l1).abs())
            row["grad_err_over_max"] = [
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(g0, g1)]
            row["grad_tol"] = (SOFTMAX_GRAD_TAIL * dim ** 0.5 * 2.0 ** -24
                               / rec.TEMPERATURE)
            if row["loss_abs_err"] > J_TOL or \
                    max(row["grad_err_over_max"]) > row["grad_tol"]:
                fail(f"the chunked in-batch softmax differs from the plain "
                     f"one at B={rows}, D={dim}: {row}")
        del got, x
        out.append(row)
    return out


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = {name: pool.submit(build.build_library, name)
                 for name in LIBRARIES}
    for name, future in built.items():
        so = future.result()
        print(f"built {os.path.relpath(so)} from {LIBRARIES[name]} "
              f"({time.perf_counter() - t0:.1f} s for all)", flush=True)
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    print("  ptxas: " + line.strip())


# ---------------------------------------------------------------------------
def zero(*tallies) -> None:
    """Every count of ``tallies`` to 0, just before a phase drives them."""
    for tally in tallies:
        for k in tally:
            tally[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    build_kernels()

    n_a, emb_a = 4_000_000, 200_000
    print(f"reduced: n_items {CONFIG.n_items}->{n_a} (the host builder "
          f"inserts one key at a time, ~28 us a key)")
    print(f"reduced: emb rows {CONFIG.n_items}->{emb_a} (the embedding "
          f"store is host memory and memmap only)")
    print(f"reduced: phase C feature items {CONFIG.n_items}->{C_ITEMS} (the "
          f"host builder inserts one key at a time, ~23-28 us a key); "
          f"shards stay {CONFIG.max_shard_bytes} B")
    print("reduced: phase J publishes the touched rows of field 0 (~100k "
          "every 4 steps), not of all 39 fields (~3.8M): the engine's host "
          "builder inserts one key at a time (each publish's ms is "
          "printed)")
    print(f"reduced: phase K.2 items {din.CONFIG.item_vocab}->{K_ITEMS} "
          f"(DIN's item_vocab follows them, as the JAX loop ties the two): "
          f"the batch layer rebuilds every table one key at a time every "
          f"batch_publish_s, and under the loop's traffic a full publish "
          f"took 2.2-3.5 s at 100,000 items and up to 2.9 s at 30,000 on "
          f"an H100 host, above batch_publish_s's 2 s (each full "
          f"publish's ms is printed)")

    zero(nl.launches, nl.lanes_launches)
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
    counts, lanes_counts = dict(nl.launches), dict(nl.lanes_launches)
    print("launches on the main path: " + json.dumps(counts), flush=True)
    for k, c in counts.items():
        if c == 0:
            fail(f"{k} was not launched on the main path")
    if counts["probe_lines"] != m_a["launches"] \
            or counts["probe_smem"] != m_b["launches"]:
        fail(f"kernel launches {counts} disagree with the engines' counts "
             f"A={m_a['launches']} B={m_b['launches']}")

    zero(nl.launches, fm.launches, fm.paths)
    with LaunchLog() as log_c, FMLog() as fm_log:
        m_c, served = run_phase_c(device, log_c, fm_log)
    c_counts = {**nl.launches, **fm.launches}
    c_paths = dict(fm.paths)
    m_c["launches"] = c_counts
    print("[C] " + json.dumps(m_c), flush=True)
    if c_counts["fused_fm"] != m_c["requests_scored"]:
        fail(f"fused_fm launched {c_counts['fused_fm']} times for "
             f"{m_c['requests_scored']} requests")
    if not any(c_counts[k] for k in nl.launches):
        fail("no probe kernel was launched on phase C's feature queries")

    zero(nl.launches, fm.launches, fm.paths)
    with LaunchLog() as log_i, FMLog() as fm_log_i:
        m_i = run_phase_i(served, log_i, fm_log_i, m_c["request_p50_ms"])
    i_counts = {**nl.launches, **fm.launches}
    m_i["launches"] = i_counts
    m_i["naive"] = run_naive_i(served)
    print("[I] " + json.dumps(m_i), flush=True)
    if i_counts["fused_fm"] != m_i["requests_scored"]:
        fail(f"fused_fm launched {i_counts['fused_fm']} times for "
             f"{m_i['requests_scored']} requests in phase I")
    probes_i = sum(i_counts[k] for k in nl.launches)
    if not probes_i or probes_i != m_i["engine_launches"]:
        fail(f"phase I launched {probes_i} probes; its engine counts "
             f"{m_i['engine_launches']}")

    # Phase C's model (1.72 GB) goes with ``served``; give its cached
    # blocks back before E draws the same model anew.
    del served
    gc.collect()
    torch.cuda.empty_cache()
    zero(nl.launches, fm.launches, fm.paths, bagk.launches)
    with FMLog() as fm_log_e:
        m_e = run_phase_e(device, fm_log_e)
    e_counts = {**nl.launches, **fm.launches, **bagk.launches}
    m_e["launches"] = e_counts
    print("[E] " + json.dumps(m_e), flush=True)
    if e_counts["fused_fm"] != m_e["requests_checked"]:
        fail(f"fused_fm launched {e_counts['fused_fm']} times for "
             f"{m_e['requests_checked']} requests")
    print("[E] fused_fm plan: " + json.dumps(fm_plan_line(
        fm_log_e.last[0], dict(fm.paths))), flush=True)

    # J draws its own DeepFM (1.72 GB, E's went with run_phase_e's frame)
    # and trains it on the train_batch cell through both train steps
    gc.collect()
    torch.cuda.empty_cache()
    zero(nl.launches, fm.launches, fm.paths, bagk.launches)
    with FMLog() as fm_log_j, BackwardLog() as bwd_log:
        m_j = run_phase_j(device, fm_log_j, bwd_log, ckpt_dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build",
            "chip_smoke_ckpt"))
    j_counts = {**nl.launches, **fm.launches, **bagk.launches}
    m_j["launches"] = j_counts
    print("[J] " + json.dumps(m_j), flush=True)
    steps_j = m_j["kernel_steps"]
    if not (j_counts["fused_fm"] == j_counts["fused_fm_backward"] ==
            bwd_log.checked == steps_j):
        fail(f"phase J ran {steps_j} steps on the FM kernels and checked "
             f"{bwd_log.checked} gradients; launches {j_counts}")
    if any(j_counts[k] for k in nl.launches) or j_counts["embedding_bag"] \
            or j_counts["embedding_bag_backward"]:
        fail(f"DeepFM training launched another kernel: {j_counts}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    kernels = []
    for name in ("probe_lines", "probe_smem"):
        row = measure(name, log.last[name], (eng_a, eng_b), log, flush)
        row["launches"] = counts[name] + c_counts[name] + i_counts[name]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 log_c.max_err.get(name, 0),
                                 log_i.max_err.get(name, 0))
        kernels.append(row)
    row = measure_fm(fm_log, flush, fm_log_e.last[0])
    row["launches"] = (c_counts["fused_fm"] + e_counts["fused_fm"]
                       + i_counts["fused_fm"] + j_counts["fused_fm"])
    row["max_abs_err"] = max(fm_log.max_err, fm_log_e.max_err,
                             fm_log_i.max_err, fm_log_j.max_err)
    row["retrieval"].update(launches=e_counts["fused_fm"],
                            max_abs_err=fm_log_e.max_err)
    fm_log_e.last = None                # E's 1.56 GB batch
    row["train"] = fm_timing(fm_log_j.last[0].detach(), flush, 20, 5)
    row["train"].update(launches=j_counts["fused_fm"],
                        max_abs_err=fm_log_j.max_err)
    kernels.append(row)
    row = measure_fm_backward(bwd_log, flush)
    row["launches"] = j_counts["fused_fm_backward"]
    kernels.append(row)
    fm_log_j.last = bwd_log.last = None
    print("fused_fm design: " + json.dumps(fm_design(fm_log, c_paths)),
          flush=True)
    print("probe_lines design: " + json.dumps(lines_design(
        log.last["probe_lines"], kernels[0], lanes_counts, flush)),
        flush=True)
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
    smem_ms = kernels[1]["kernel_ms"]
    contrast["smem_over_lines"] = (smem_ms / contrast["kernel_ms"]
                                   if smem_ms and contrast["kernel_ms"]
                                   else None)
    # the same two launches with the group left in L2 (zeroing one byte
    # flushes nothing), as when one shard is probed batch after batch
    warm = torch.empty(1, dtype=torch.uint8, device=device)
    contrast["warm"] = {
        "probe_smem_kernel_ms": kernel_ms(
            lambda: nl.probe_smem(group, qh, ql, seg), "probe_smem_kernel",
            50, warm),
        "probe_lines_kernel_ms": kernel_ms(
            lambda: nl.probe_lines(group, qh, ql, seg), "probe_lines_kernel",
            50, warm)}
    print("phase B group through probe_lines: " + json.dumps(contrast))
    print("probe_smem design: " + json.dumps({
        "cluster": nl.CLUSTER, "group_bytes": group.smem_bytes,
        "bytes_per_block": 4 * group.slice_words}))
    for n in SATURATION_BATCHES:
        print("probe_saturation " + json.dumps(saturation(eng_a, flush, n)),
              flush=True)

    # Phase E's model (1.72 GB) went with run_phase_e's frame; give its
    # cached blocks back, so that the two-tower tables (30.8 GB) and the
    # plain bag lookup's two [262144, 50, 256] fp32 intermediates at
    # serve_bulk (13.4 GB each) fit the card's 80 GB together.
    gc.collect()
    torch.cuda.empty_cache()
    zero(nl.launches, fm.launches, bagk.launches, bagk.paths)
    two_tower = two_tower_model(device)
    with BagLog() as bag_log:
        m_d = run_phase_d(two_tower, bag_log)
    d_counts = {**nl.launches, **fm.launches, **bagk.launches}
    m_d["launches"] = d_counts
    print("[D] " + json.dumps(m_d), flush=True)
    if d_counts["embedding_bag"] != m_d["requests_scored"]:
        fail(f"embedding_bag launched {d_counts['embedding_bag']} times for "
             f"{m_d['requests_scored']} requests")
    print("embedding_bag design: " + json.dumps({
        "stage_rows": bagk.STAGE_ROWS, "stages": bagk.STAGES,
        **{f"{k}_launches": v for k, v in bagk.paths.items()},
        "staged_share": bagk.paths["staged"]
        / max(1, sum(bagk.paths.values()))}),
        flush=True)

    zero(nl.launches, fm.launches, bagk.launches, bagk.paths)
    with BagLog() as bag_log_f:
        m_f = run_phase_f(two_tower, bag_log_f)
    f_counts = {**nl.launches, **fm.launches, **bagk.launches}
    m_f["launches"] = f_counts
    m_f["embedding_bag_paths"] = dict(bagk.paths)
    print("[F] " + json.dumps(m_f), flush=True)
    if f_counts["embedding_bag"] != m_f["requests_checked"]:
        fail(f"embedding_bag launched {f_counts['embedding_bag']} times for "
             f"{m_f['requests_checked']} requests")
    bag_row = measure_bag(bag_log, bag_log_f, flush)   # M.1 adds its own
    bag_row["launches"] = (d_counts["embedding_bag"]
                           + f_counts["embedding_bag"])
    bag_row["max_abs_err"] = max(bag_log.max_err, bag_log_f.max_err)
    bag_row["retrieval"]["launches"] = f_counts["embedding_bag"]
    kernels.append(bag_row)

    # G and H reach none of the four kernels: the two-tower tables (30.8 GB,
    # also held by the bag logs' last launches) go first, then DIN's tables
    # (7.2 GB) go with run_phase_seq's frame before BST draws its 12.8 GB.
    del two_tower, bag_log, bag_log_f
    for name, cfg in (("G", din.CONFIG), ("H", bst.CONFIG)):
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches)
        run_phase_seq(name, cfg, device)
        launched = {**nl.launches, **fm.launches, **bagk.launches}
        print(f"[{name}] launches: " + json.dumps(launched), flush=True)
        if any(launched.values()):
            fail(f"{cfg.name} serving launched a kernel: {launched}")

    # K reaches none of the kernels either: DIN trained on train_batch at
    # published width (K.1, BST's 12.8 GB gone with H's frame), then the
    # realtime loop training DIN (K.2)
    for name, run_k in (("K.1", run_phase_k1), ("K.2", run_phase_k2)):
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches)
        m_k = run_k(device)
        launched = {**nl.launches, **fm.launches, **bagk.launches}
        m_k["launches"] = launched
        print(f"[{name}] " + json.dumps(m_k), flush=True)
        if any(launched.values()):
            fail(f"phase {name} launched a kernel: {launched}")

    # L: BST trained on train_batch (K's DIN gone with its frame); M:
    # two-tower, M.1 through both bag kernels, M.2 through none
    gc.collect()
    torch.cuda.empty_cache()
    zero(nl.launches, fm.launches, bagk.launches)
    m_l = run_phase_l(device)
    m_l["launches"] = kernel_counts()
    print("[L] " + json.dumps(m_l), flush=True)
    if any(m_l["launches"].values()):
        fail(f"phase L launched a kernel: {m_l['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    m_m, m1_counts, m2_counts, bag_log_m, bwd_log_m = run_phase_m(
        device, flush=flush)
    m_m["launches"] = {"M.1": m1_counts, "M.2": m2_counts}
    print("[M] " + json.dumps(m_m), flush=True)
    steps_m = len(m_m["dense"]["loss_all_steps"])
    if not (m1_counts["embedding_bag"] == m1_counts["embedding_bag_backward"]
            == bag_log_m.checked == bwd_log_m.checked == steps_m):
        fail(f"phase M.1 took {steps_m} steps and checked "
             f"{bag_log_m.checked} bag lookups and {bwd_log_m.checked} bag "
             f"gradients; launches {m1_counts}")
    if any(m1_counts[k] for k in {**nl.launches, **fm.launches}):
        fail(f"two-tower's dense step launched another kernel: {m1_counts}")
    if any(m2_counts.values()):
        fail(f"phase M.2 launched a kernel: {m2_counts}")
    bag_row["launches"] += m1_counts["embedding_bag"]
    bag_row["max_abs_err"] = max(bag_row["max_abs_err"], bag_log_m.max_err)
    bag_row["train"] = {**m_m["dense"]["bag_timing"],
                        "launches": m1_counts["embedding_bag"],
                        "max_abs_err": bag_log_m.max_err,
                        "paths": m_m["dense"]["embedding_bag_paths"]}
    row = measure_bag_backward(bwd_log_m, flush)
    row["launches"] = m1_counts["embedding_bag_backward"]
    kernels.append(row)
    del bag_log_m, bwd_log_m
    gc.collect()
    torch.cuda.empty_cache()
    print("in-batch softmax: " + json.dumps(softmax_timing(device, flush)),
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
