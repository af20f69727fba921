#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batch query on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the kernels (``src/repro_torch/csrc/probe.cu``, ``fused_fm.cu``,
``embedding_bag.cu`` and ``segment_sum.cu``) with nvcc, one per library,
all started together, then runs nineteen phases.  Two send batch queries
through
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

* **N** — the paper's Table 1 and Fig. 9 on the card, with the JAX
  benches' sizes and query mix (90% hits, misses from [2^62, 2^63)),
  tables built at the card's 8 buckets a line.  T1: ``linear``,
  ``coalesced`` and ``neighborhash`` at LF 0.8 and 2^14, 2^17 and 2^20
  keys, 2^16 queries each, linear probing through the ``probe_linear``
  kernel and the chained tables through ``probe_lines``; and ``linear``
  at 2^22 keys (past the 50 MB L2) beside phase A's own 4M NeighborHash
  table.  Each row: ms by events and kernel ms by profiler (the chained
  tables' at 1 and at 8 lanes a query too: ``probe_linear`` runs one
  thread a query), Mkeys/s, the host table's APCL, probe/RA (the
  ``random_access`` kernel), the lines read and the share of steps that
  leave their line (host trace).  F9: NeighborHash at 2^14, 2^18 and
  2^20 keys, 256 queries through ``probe_sequential`` (one thread, one
  query after another) and 2^15 through ``probe_lines``, Mkeys/s each;
  the sequential probe's latency bound is its lines read times the
  card's dependent-load latency, taken apart from it by the
  ``load_chain`` kernel (one thread chasing line indices through a
  buffer of the table's size).  Each linear table and each F9 table is
  also probed once through the entry points a user calls,
  ``core/lookup.lookup_linear`` and ``lookup_sequential`` on the card.
  Every launch is held bitwise against its plain version and every
  answer against ``lookup_host_batch``; no speed is gated.
* **O** — the consistency protocol's replica fleet (``ClusterSim``,
  ``SimConfig``'s defaults: 8 shards, 3 replicas, retain 2, hedging at
  5 ms, naming propagation 2 s, reload 3 s; a rollout every 20 s) with
  its data plane an engine on the card over phase A's deployment cut to
  2^20 scalar keys and 200k 1 KB rows, each rollout a delta generation of
  64 keys: 1000 batch queries of 4096 zipf keys over both tables in 200
  s of sim time, under ``paper``, under ``naming``, and under ``paper``
  behind the ``QueryServer``; then a latest and a pinned read through
  ``FeatureClient(ClusterBackend(sim))``, and a ``BatchQueryService``
  (4 MB shards) over the same keys, 64 batches against the engine and the
  host tables.  Every key's answer is held bitwise against the rows
  written at the version its shard answered from: under ``paper`` no
  batch mixes versions, under ``naming`` some must.  It reports each
  run's mixed rate, hedges, sim latency p90 and p99, host ms a query and
  probe launches.

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

* **P** — DIN's (**P.1**, on G's model) and BST's (**P.2**, on H's)
  ``retrieval_cand`` cell, right after each model's G or H: 1,000,000
  candidate rows a request, each with its own history
  (``synthetic.recsys_batch``, the JAX cell's shape), through the
  launcher's ``cell_requests`` (``serve_step.bulk_rank_fn``: the model's
  columns of all rows uploaded in one copy, the forward on slices of
  ``rec.BULK_CHUNK_ROWS`` = 262,144 rows writing one [1M] fp32 logits
  tensor, one ``lax_top_k``): a warm-up, 8 timed requests and one
  traced, drawn as 8 distinct batches (one a host core; DIN's take ~50 s
  each) and cycled, the host draw's time and bytes printed.  Every
  request's top 100 is held to the card's own logits (each value its
  index's logit bitwise, ``jax.lax.top_k``'s order), and the logits of
  its top 100 and of 4,096 fixed rows within 1e-5 of the float64
  recompute; once, 262,144 rows of a request ranked in slices of 65,536
  against one slice (values within 1e-5, indices by the tie rule), with
  one slice's forward timed by events.  No kernel may launch, and the
  peak memory must stay under 80 GB.

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
  printed); every backward launch held bit for bit against the plain
  version of its order (``ref.embedding_bag_backward_ordered``) and
  element by element against the ``index_add_`` gradient on the same
  tensors within min(2 n 2^-24, 1e-4) S + 1e-30 (n the terms a row adds,
  S their magnitudes' sum), the first step's loss within 1e-5 of the
  same step's with the plain bag; after the traced step the first timed
  step is taken again from its state, restored from a host copy, and
  every parameter and optimizer leaf is compared with the uninterrupted
  run's bit for bit (a leaf that differs is printed with the operations
  that write its gradient; it does not fail the run).  **M.2**: the
  sparse step at the published 20M users and 10M items (30.8 GB), no
  kernel.  Both run L's steps and checks.

* **Q** — the port's ``launch/loadtest.py`` in-process, after M, at its
  defaults with ``--adaptive`` (8 s of zipf sessions at 60 a second with a
  4x flash crowd against a ``QueryServer`` over a host ``HybridKVStore``,
  the ``AdaptiveController`` ticking every 0.25 s): it must exit 0, its
  SLO report line parse and its registry hold the traffic and controller
  families; attainment, sheds and the controller's decisions are printed,
  not gated (they are timings).  No device work, no kernel.
* **R** — the port's multi-process serving fabric (``serve/fabric.py``),
  after Q, on the host: every ``Router`` runs in a child interpreter
  (``python -c`` with the source of ``R_CHILD``, so that the spawned shard
  servers re-run no ``__main__`` file) whose ``PYTHONPATH`` starts with a
  ``torch`` package that raises ``ImportError``, so every shard server
  shows that it boots without torch; the children's output goes to the
  log with an ``[R]`` prefix.  **R.1**: phase A's and O's 200,000 1 KB
  rows (hot fraction 0.1) on 2 shards x 2 replicas, 4 client threads x 50
  batches of 4096 zipf keys (10% absent) through
  ``FeatureClient(FabricBackend(router))``, a publisher writing 128 rows
  every 0.2 s and chaos killing a random replica every 1 s (the first
  once a quarter of the batches are answered): every answer a response
  or a typed ``FabricError``, every response's rows bitwise the rows last
  written at or before its version and every absent key not found, no
  mixed batch, at least one respawn, then every replica asked directly at
  the fleet version for every key written in the run, bitwise.  **R.2**:
  ``python -m repro_torch.launch.fabric --n-keys 8000 --requests 600
  --chaos --record`` (the smoke's keys, 4 clients x 600 batches of 512
  keys, long enough for several 1 s chaos ticks): exit 0, the record
  ``ok`` with the fabric's families, at least one ``chaos: killing``
  line, one update and one respawn.  **R.3**:
  ``test_fabric_qps_scaling_acceptance``'s queries/s at 1 and 4 shards,
  printed with the host's CPU count, not gated.  No device work, no
  kernel.

* **S** — GraphSAGE (``configs/graphsage_reddit.CONFIG``: 2 layers of
  128, the mean aggregator) trained on the card in its three regimes,
  after R, at the four GNN cells' published dims, each graph (or batch
  set) built once on the host from a seed: **S.1** ``full_graph_sm``
  (Cora's shape: 2,708 nodes, 10,556 edges, 1,433 features), **S.2**
  ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, 100 features),
  **S.3** ``minibatch_lg`` (Reddit's shape: 232,965 nodes, 114,615,892
  edges, 602 features; 10 blocks of 1,024 seeds sampled 15-10 by
  ``graph_sampler.sample_block`` from one ``CSRGraph``, uploaded before
  the steps) and **S.4** ``molecule`` (10 batches of 128 graphs of 30
  nodes), each through ``make_train_step(gnn_loss_fn(cfg, regime),
  OptConfig())`` (Adam): a warm-up, 8 timed steps (CUDA events and the
  host clock) and one traced for the card's busy share, with the host
  seconds of the graph, the CSR and (S.3) each block's sampling and
  upload, nodes (seeds, graphs) a second, each step's loss and
  ``grad_norm`` and ``max_memory_allocated``.  The neighbour mean of S.1,
  S.2 and S.4 runs on the ``csr_sum`` kernel, three launches a step
  (both layers' forward, layer 2's backward over the transposed CSR;
  the features need no gradient); S.3's dense masked means reach no
  kernel.  Every launch is held against ``ref.csr_sum`` within min(2 n
  2^-24, 1e-4) S + 1e-30 on every row (S.2: 65,536 fixed rows and the
  longest segment), the first step's loss within 1e-5 of the plain
  version's (S.1, S.2, S.4), every loss and ``grad_norm`` finite, the
  peak under 80 GB; each cell's launch count is 3 a step and no other
  kernel launches.  S.1's and S.2's last launch of each CSR and width is
  launched twice more (the same bits), then timed.

Then each kernel is timed at the shapes the main path gave it (and the bulk
kernels at the ``serve_bulk`` batch of 262,144 rows), beside its plain
version, a library call where one computes the same function (for the
probe the paper's RA yardstick instead, another function: the
``random_access`` kernel, which hashes each key and reads both value
words of its home bucket, held bitwise against
``core/lookup.random_access`` first, with the one-word ``torch.take``
over keys hashed beforehand, timed as RA before it, beside it;
``F.embedding_bag`` for the bag; none for the FM term or its gradient)
and its bound (``probe_linear`` at T1's 2^20-key linear table, 20 B a
query and 128 B a distinct line read; ``probe_sequential`` at F9's
2^20 keys, its chain of dependent loads: queries x APCL x the load
latency, timed as ``probe_sequential``'s time a query over keys that sit
in their home bucket; neither has a library call); ``fused_fm`` also at
J's [65536, 39, 10], and
``fused_fm_backward`` there; ``embedding_bag_backward`` at M.1's last
launch, twice on the same inputs (the same bits), its plan and its sort
timed apart and each of its kernels by profiler, beside both plain
gradients and ``torch.autograd.grad`` of ``F.embedding_bag`` (mean, with
a padding row); ``csr_sum`` at S.1's and S.2's three launches a step,
beside its bound (the distinct rows of x the terms name, the indices,
indptr and the output, each moved once), ``ref.csr_sum``, the
word-for-word route of the JAX package (``index_select`` into [E, D]
messages, then ``index_add_``, where they fit the card) and
``torch.sparse.mm`` of the CSR of ones.
Phase B's last group also goes through ``probe_lines`` for contrast, with
the ratio of the two kernels' times; the redesigned kernels' constants get a
line each: ``probe_smem``'s cluster and bytes a block; ``fused_fm``'s tile,
stages and share of main-path launches on the bulk-copy branch;
``probe_lines``'s main-path launches by lanes a query, its kernel time with
1 and 8 lanes a query (each form held against the plain probe), and the
share of phase A's chain steps that stay in the line they left (from the
host trace); ``embedding_bag``'s stages and share of launches on the staged
branch.  ``probe_saturation`` lines time ``probe_lines`` (the wrapper's pick
and each form) against the ``random_access`` kernel at
``SATURATION_BATCHES`` present keys, every form's answers held against the
host table's items and RA's against ``core/lookup.random_access``.

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
import io
import json
import multiprocessing
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
from repro_torch.configs import (bst, deepfm, din,  # noqa: E402
                                 graphsage_reddit, registry,
                                 two_tower_retrieval)
from repro_torch.configs.bili_feature_store import CONFIG, SMOKE  # noqa: E402
from repro_torch.core import cluster_sim as cs  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import hashcore as hc  # noqa: E402
from repro_torch.core import lookup as lk  # noqa: E402
from repro_torch.core import neighborhash as nh  # noqa: E402
from repro_torch.core.batch_query import BatchQueryService  # noqa: E402
from repro_torch.data import graph_sampler, synthetic  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import embedding_bag as bagk  # noqa: E402
from repro_torch.kernels import fused_fm as fm  # noqa: E402
from repro_torch.kernels import neighbor_lookup as nl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_sum as segk  # noqa: E402
from repro_torch.launch import realtime  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import embedding_service as es  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
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
# phase N: the paper's T1 and F9 on the card, at the JAX benches' sizes
# (benchmarks/bench_scalar_tables.py, bench_vectorization.py)
N_T1_SIZES = (1 << 14, 1 << 17, 1 << 20)
N_T1_VARIANTS = ("linear", "coalesced", "neighborhash")
N_T1_QUERIES = 1 << 16
N_LINEAR_BIG = 1 << 22         # linear past the L2, beside phase A's table
N_F9_SIZES = (1 << 14, 1 << 18, 1 << 20)
N_F9_SEQ, N_F9_BATCH = 256, 1 << 15
N_SQR = 0.9                    # the paper's successful-lookup ratio
N_APCL_KEYS = 1500             # queries the host APCL is taken over
N_LATENCY_LOADS = 4096         # dependent loads the load latency is timed on
N_ITERS = 20
N_BUILD_WORKERS = 6            # processes building N's host tables at once
# phase O: the consistency protocol's replica fleet (SimConfig's defaults)
O_KEYS, O_EMB_ROWS = 1 << 20, 200_000
O_QUERIES, O_QPS = 1000, 5     # 200 s of sim time
O_UPDATE_US = 20_000_000       # a naming rollout (3 x 5 s) ends first
O_SEED = 0
O_BQS_BATCHES = 64
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
# phase P: DIN's and BST's retrieval_cand (1M candidate rows, top 100)
P_REQUESTS = 8                 # timed requests, after a warm-up
P_DISTINCT = 8                 # distinct requests drawn (one a host core),
#                                cycled: DIN's take ~50 s each to draw
P_TOL = 1e-5                   # fp32 logits vs float64 recompute
P_CHUNK_CHECK = (262_144, 65_536)  # rows held, chunked into slices of
P_PEAK_BYTES = 80 * 10**9      # the card's 80 GB
# phase Q: the port's load-test launcher at its defaults, in-process
Q_ARGV = ["--adaptive"]
# phase R: the serving fabric, in a child interpreter that cannot import
# torch.  R.1: phase A's and O's 200k 1 KB rows (hot 0.1) on the
# launcher's 2 shards x 2 replicas, phase O's traffic, the launcher's
# publisher (128 rows every 0.2 s) and chaos (a kill every 1 s, the first
# once a quarter of the batches are answered); R.3:
# test_fabric_qps_scaling_acceptance's setup
R1 = {"rows": 200_000, "value_bytes": CONFIG.value_bytes,
      "hot_fraction": CONFIG.hot_fraction, "shards": 2, "replicas": 2,
      "clients": 4, "batches": 50, "batch_keys": BATCH_KEYS,
      "zipf_a": ZIPF_A, "absent": ABSENT, "delta_rows": 128,
      "publish_s": 0.2, "chaos_s": 1.0, "snapshot_every": 4,
      "health_period_s": 0.25, "wait_s": 120.0, "seed": 0}
R3 = {"rows": 50_000, "value_bytes": 32, "hot_fraction": 0.2,
      "shards": (1, 4), "clients": 8, "queries": 25, "batch_keys": 1024}
R2_ARGV = ["--n-keys", "8000", "--requests", "600", "--chaos"]  # the smoke's
#                                keys; 4 clients x 600 batches of 512 keys
#                                span several 1 s chaos and 0.2 s publish
#                                ticks (--smoke's 15 a client end first)
R_TIMEOUT_S = 600

S_STEPS = 8                    # timed steps of each GNN cell
S_CHECK_ROWS = 65_536          # fixed rows a csr_sum launch is held on,
#                                where it has more
S_SEED = 0
S_LOSS_TOL = 1e-5              # first step's loss: kernel vs plain sums
S_PEAK_BYTES = 80 * 10**9      # the card's 80 GB
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
BAG_GRAD_U = 2.0 ** -24        # fp32's unit roundoff: two orders' bound
BAG_GRAD_REL = 1e-4            # ... at most this share of S (hot rows)
SOFTMAX_SHAPES = ((8, 32), (4096, 256), (32_768, 256), (65_536, 256))
#   (B, D) of the in-batch softmax: SMOKE's, one chunk, train_batch's
SOFTMAX_GRAD_TAIL = 5          # x sqrt(D) 2^-24 / T: see softmax_timing
REPLACES = {"probe_lines": "src/repro/kernels/neighbor_lookup.py:235",
            "probe_smem": "src/repro/kernels/neighbor_lookup.py:106",
            "fused_fm": "src/repro/kernels/fused_fm.py:31",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:79",
            "fused_fm_backward": "src/repro/kernels/fused_fm.py:31",
            "embedding_bag_backward": "src/repro/kernels/embedding_bag.py:79",
            "probe_linear": "src/repro/core/lookup.py:152",
            "probe_sequential": "src/repro/core/lookup.py:209",
            "csr_sum": "src/repro/models/gnn.py:86"}
LIBRARIES = {"probe": "src/repro_torch/csrc/probe.cu",
             "fused_fm": "src/repro_torch/csrc/fused_fm.cu",
             "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
             "segment_sum": "src/repro_torch/csrc/segment_sum.cu"}
SOURCE = {"probe_lines": LIBRARIES["probe"],
          "probe_smem": LIBRARIES["probe"],
          "fused_fm": LIBRARIES["fused_fm"],
          "fused_fm_backward": LIBRARIES["fused_fm"],
          "embedding_bag": LIBRARIES["embedding_bag"],
          "embedding_bag_backward": LIBRARIES["embedding_bag"],
          "csr_sum": LIBRARIES["segment_sum"]}


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
        self.calls = dict.fromkeys([s[2] for s in spans], 0)
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
                self.calls[name] += 1
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
    """The one-word gather timed as RA before the hand-written RA kernel:
    each key's home val_hi word, hashed beforehand, out of the timed call,
    and read by ``torch.take`` (cheaper than the paper's RA, which hashes
    and reads both value words).  Returns the table as a flat int32 view,
    each query's word index there and the number of distinct home lines."""
    t = group.tables[0]
    home = hc.bucket_of_torch(ref.u32(q_hi), ref.u32(q_lo), t.home_capacity)
    bpl = nl.BUCKETS_PER_LINE
    word = (home // bpl) * (4 * bpl) + 2 * bpl + home % bpl    # val_hi
    return t.lines.view(torch.int32).reshape(-1), word, \
        int(torch.unique(home // bpl).numel())


def ra_timing(group, q_hi, q_lo, flush, iters):
    """The paper's RA yardstick (``core/lookup.random_access``) on the
    group's first table with these keys: the ``random_access`` kernel, which
    hashes each key and reads both value words of its home bucket in the
    timed call, its answer first held bitwise against
    ``core/lookup.random_access`` on the same table's value words; its
    bound (each key's 8 B read and 8 B written, and the two 32 B sectors of
    each distinct home line); beside it the one-word ``torch.take`` over
    keys hashed beforehand that was timed as RA before."""
    t = group.tables[0]
    want = lk.random_access(*nl.value_words(t), q_hi, q_lo,
                            capacity=t.capacity)
    got = nl.random_access(t, q_hi, q_lo)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want)):
        fail(f"random_access differs from core/lookup.random_access at "
             f"{q_hi.shape[0]} keys")
    home = hc.bucket_of_torch(ref.u32(q_hi), ref.u32(q_lo), t.capacity)
    lines = int(torch.unique(home // nl.BUCKETS_PER_LINE).numel())
    n = q_hi.shape[0]
    flat, word, _ = ra_operands(group, q_hi, q_lo)

    def ra():
        return nl.random_access(t, q_hi, q_lo)
    return {"ra_ms": time_ms(ra, iters, flush),
            "ra_kernel_ms": kernel_ms(ra, "random_access_kernel", iters,
                                      flush),
            "ra_checked_bitwise": True,
            "ra_bound_ms": (n * 16 + lines * 64) / HBM_BYTES_PER_S * 1e3,
            "ra_home_lines": lines,
            "take_one_prehashed_word_ms": time_ms(
                lambda: torch.take(flat, word), iters, flush)}


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
    ra = ra_timing(group, q_hi, q_lo, flush, 50)
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
            "library_ms": ra["ra_ms"],
            "library_note": "the paper's RA yardstick, the random_access "
                            "kernel: another function (hash and one home "
                            "bucket's two value words)",
            "queries": n, "lines_touched": lines, "bucket_reads": reads,
            "chain_steps": steps, "in_line_steps": in_line, "ra": ra,
            "probe_over_ra": ra["ra_ms"] / ms}


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
    ra = ra_timing(group, q_hi, q_lo, flush, 20)
    lines = ra["ra_home_lines"]
    # home lines only: a lower bound on the lines the probes read
    bound_ms = (n * (8 + 12) + lines * 128) / HBM_BYTES_PER_S * 1e3
    return {"queries": n, "checked": True, "lanes": lanes[0],
            "probe_ms": ms, "probe_kernel_ms": k_ms,
            "kernel_ms_by_lanes": lanes_ms(group, q_hi, q_lo, [0, n], want,
                                           flush, 20),
            **ra,
            "probe_mkeys_per_s": n / ms / 1e3,
            "ra_mkeys_per_s": n / ra["ra_ms"] / 1e3,
            "probe_over_ra": ra["ra_ms"] / ms,
            "probe_over_ra_kernels": (ra["ra_kernel_ms"] / k_ms
                                      if ra["ra_kernel_ms"] and k_ms
                                      else None),
            "home_lines": lines, "bound_ms": bound_ms}


# ---------------------------------------------------------------------------
# phase N: the paper's T1 (NeighborHash against linear probing and
# coalesced hashing) and F9 (the batch probe against one query at a time)
# ---------------------------------------------------------------------------
def query_mix(keys, n, sqr=N_SQR, seed=1):
    """The paper's workload (the JAX bench's ``table_cache.query_mix``):
    ``sqr`` of the queries hit, drawn uniformly from ``keys``; the rest
    miss, drawn from [2^62, 2^63)."""
    rng = np.random.default_rng(seed)
    n_hit = int(n * sqr)
    q = np.concatenate([keys[rng.choice(len(keys), n_hit)],
                        rng.integers(2**62, 2**63, n - n_hit)
                        .astype(np.uint64)])
    rng.shuffle(q)
    return q


def n_build(n, variant):
    """One phase-N table built on the host (a job of ``start_n_builds``'s
    pool): ``random_kv(n, seed=0)`` at LF 0.8 and the card's 8 buckets a
    line.  Returns the table and its build seconds."""
    keys, payloads = nh.random_kv(n, seed=0)
    t0 = time.perf_counter()
    table = nh.build(keys, payloads, variant=variant, load_factor=0.8,
                     buckets_per_line=hc.GPU_BUCKETS_PER_LINE)
    return table, time.perf_counter() - t0


def start_n_builds():
    """Starts every phase-N table's host build in ``N_BUILD_WORKERS``
    processes (the host builder inserts one key at a time), the largest
    first: the T1 tables, linear at ``N_LINEAR_BIG`` and the F9 tables T1
    lacks.  main() starts them once phases A and B have ended, so no
    host-clock metric of theirs shares the host with them.  Returns (the
    pool, {(keys, variant): future of (table, build seconds)});
    ``drive_phase_n`` collects them and shuts the pool down."""
    jobs = [(N_LINEAR_BIG, "linear")]
    jobs += [(n, v) for n in N_T1_SIZES for v in N_T1_VARIANTS]
    jobs += [(n, "neighborhash") for n in N_F9_SIZES if n not in N_T1_SIZES]
    cost = {"linear": 1, "coalesced": 2, "neighborhash": 4}
    jobs.sort(key=lambda j: -j[0] * cost[j[1]])
    pool = concurrent.futures.ProcessPoolExecutor(
        N_BUILD_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return pool, {j: pool.submit(n_build, *j) for j in jobs}


class NCase:
    """One table of phase N on the host and the card, and its queries."""

    def __init__(self, n, variant, device, host, build_s):
        self.n, self.variant = n, variant
        self.keys = nh.random_kv(n, seed=0)[0]
        self.host, self.build_s = host, build_s
        self.statics = lk.probe_statics(host)
        a = self.arrays = host.device_arrays()
        words = (a["key_hi"], a["key_lo"], a["val_hi"], a["val_lo"])
        st = self.statics
        if variant == "linear":      # as ops.linear_lookup makes it
            self.table = ops.one_table(
                *words, max_probes=st["max_probes"], host_check=False,
                capacity=host.capacity, device=device)
        else:                        # as core/lookup.make_lookup_fn does
            self.table = ops.one_table(
                *words, max_probes=st["max_probes"],
                home_capacity=st["home_capacity"],
                host_check=st["host_check"],
                next_idx=None if st["inline"] else a.get("next_idx"),
                device=device)
        self.group = nl.TableGroup([self.table])   # made once, not per call

    def queries(self, n_q, seed=1):
        q = query_mix(self.keys, n_q, seed=seed)
        qh, ql = hc.key_split_np(q)
        return q, nl.to_device(qh, self.table.lines.device), \
            nl.to_device(ql, self.table.lines.device)

    def probe(self, qh, ql):
        """The batch probe: linear probing for the linear table, else
        ``probe_lines`` (the engine's kernel for a table past shared
        memory)."""
        if self.variant == "linear":
            return ops.probe_linear(self.table, qh, ql)
        if self.group.device.type == "cpu":     # a rehearsal on the CPU
            return ref.probe_group(self.group, qh, ql, [0, qh.shape[0]])
        return nl.probe_lines(self.group, qh, ql, [0, qh.shape[0]])

    def plain(self, qh, ql, sequential=False):
        t = self.table
        if self.variant == "linear":
            return ref.probe_linear(t.lines, qh, ql, capacity=t.capacity,
                                    max_probes=t.max_probes)
        fn = ref.probe_sequential if sequential else ref.probe_table
        return fn(t.lines, t.next_idx, qh, ql, capacity=t.capacity,
                  home_capacity=t.home_capacity, host_check=t.host_check,
                  max_probes=t.max_probes)

    def check(self, what, out, q, qh, ql, sequential=False):
        """``out`` bitwise its plain version on the same inputs and the host
        table's ``lookup_host_batch``; returns the max abs error (0)."""
        want = self.plain(qh, ql, sequential)
        err = int((ref.u32(out) - ref.u32(want)).abs().max()) \
            if out.numel() else 0
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            fail(f"[N] {what}: differs from its plain version (max abs err "
                 f"{err})")
        hf, hp = self.host.lookup_host_batch(q)
        got = out.view(torch.int32).cpu().numpy().view(np.uint32)
        if not (np.array_equal(got[0].astype(bool), hf) and np.array_equal(
                (got[1].astype(np.uint64) << np.uint64(32))
                | got[2].astype(np.uint64), hp)):
            fail(f"[N] {what}: differs from lookup_host_batch")
        return err

    def entry(self, q, out):
        """The same queries through the entry point a user calls,
        ``core/lookup.lookup_linear`` for the linear table and
        ``lookup_sequential`` for the others, on the card from the host
        table's arrays: its answer held bitwise against ``out`` (the
        kernel's on the same queries, already held against its plain
        version and ``lookup_host_batch``)."""
        a, st = self.arrays, self.statics
        qh, ql = hc.key_split_np(q)
        words = (a["key_hi"], a["key_lo"], a["val_hi"], a["val_lo"])
        if self.variant == "linear":
            got = lk.lookup_linear(*words, qh, ql,
                                   capacity=self.host.capacity,
                                   max_probes=st["max_probes"],
                                   device=self.table.lines.device)
        else:
            got = lk.lookup_sequential(*words, a.get("next_idx"), qh, ql,
                                       device=self.table.lines.device, **st)
        found, p_hi, p_lo = got
        if not (found.dtype == torch.bool and torch.equal(
                found, out[0].view(torch.int32) != 0) and all(
                torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in ((p_hi, out[1]), (p_lo, out[2])))):
            fail(f"[N] core/lookup's entry for {self.variant} at {self.n} "
                 "keys differs from its kernel's answer")


def drive_phase_n(device, eng_a, builds):
    """Phase N's main path: every T1 table probed once by its batch probe
    (``probe_linear`` for linear probing, ``probe_lines`` for the chained
    tables) at ``N_T1_QUERIES``, and every F9 table by ``probe_sequential``
    at ``N_F9_SEQ`` and ``probe_lines`` at ``N_F9_BATCH``; each answer held
    bitwise against its plain version and the host table.  Returns the
    cases and what it printed."""
    err = {"probe_linear": 0, "probe_sequential": 0, "probe_lines": 0}
    t0 = time.perf_counter()
    pool, futures = builds
    with pool:
        hosts = {j: f.result() for j, f in futures.items()}
    print(f"[N] {len(hosts)} tables built by {N_BUILD_WORKERS} processes "
          f"in {time.perf_counter() - t0:.1f} s after phase A", flush=True)
    cases = {j: NCase(*j, device, *hosts.pop(j)) for j in sorted(hosts)}
    runs = {}
    for (n, variant), c in cases.items():
        if n in N_T1_SIZES or n == N_LINEAR_BIG:
            q, qh, ql = c.queries(N_T1_QUERIES)
            kernel = "probe_linear" if variant == "linear" else "probe_lines"
            out = c.probe(qh, ql)
            err[kernel] = max(err[kernel], c.check(
                f"T1 {variant} at {n} keys", out, q, qh, ql))
            if variant == "linear":
                c.entry(q, out)
            runs["t1", n, variant] = (c, q, qh, ql)
        if variant == "neighborhash" and n in N_F9_SIZES:
            q, qh, ql = c.queries(N_F9_SEQ, seed=2)
            out = ops.probe_sequential(c.table, qh, ql)
            err["probe_sequential"] = max(err["probe_sequential"], c.check(
                f"F9 sequential at {n} keys", out, q, qh, ql,
                sequential=True))
            c.entry(q, out)
            runs["f9_seq", n, variant] = (c, q, qh, ql)
            q, qh, ql = c.queries(N_F9_BATCH, seed=3)
            err["probe_lines"] = max(err["probe_lines"], c.check(
                f"F9 batch at {n} keys", c.probe(qh, ql), q, qh, ql))
            runs["f9_batch", n, variant] = (c, q, qh, ql)
    print("[N] build s: " + json.dumps(
        {f"{v}_{n}": c.build_s for (n, v), c in cases.items()}), flush=True)
    return {"runs": runs, "err": err, "eng_a": eng_a}


def t1_row(c, q, qh, ql, flush):
    """One T1 row: the batch probe by events and by profiler (a chained
    table's ``probe_lines`` also forced to 1 and to 8 lanes a query:
    ``probe_linear`` runs one thread a query), Mkeys/s, the host table's
    APCL, probe/RA, the lines the probe touched and the share of its steps
    that leave the line they were in (host trace), its bound (20 B a
    query, 128 B a distinct line read)."""
    n = qh.shape[0]
    name = "probe_linear" if c.variant == "linear" else "probe_lines"
    ms = time_ms(lambda: c.probe(qh, ql), N_ITERS, flush)
    k_ms = kernel_ms(lambda: c.probe(qh, ql), f"{name}_kernel", N_ITERS,
                     flush)
    lanes = {} if c.variant == "linear" else lanes_ms(
        c.group, qh, ql, [0, n], c.probe(qh, ql), flush, N_ITERS)
    ra = ra_timing(nl.TableGroup([c.table]), qh, ql, flush, N_ITERS)
    lines, reads, steps, in_line = touched([c.host], qh, ql, [0, n])
    return {"variant": c.variant, "keys": c.n, "queries": n,
            "kernel": name, "ms": ms, "kernel_ms": k_ms,
            "kernel_ms_by_lanes": lanes,
            "mkeys_per_s": n / ms / 1e3,
            "kernel_mkeys_per_s": n / k_ms / 1e3 if k_ms else None,
            "apcl": c.host.apcl(q[:N_APCL_KEYS]),
            "max_probes": c.table.max_probes,
            "lines_touched": lines, "bucket_reads": reads,
            "steps": steps, "steps_leaving_line": steps - in_line,
            "share_leaving_line": (steps - in_line) / steps if steps
            else 0.0,
            "bound_ms": (n * 20 + lines * 128) / HBM_BYTES_PER_S * 1e3,
            "ra_ms": ra["ra_ms"], "ra_kernel_ms": ra["ra_kernel_ms"],
            "probe_over_ra": ra["ra_ms"] / ms,
            "probe_over_ra_kernels": (ra["ra_kernel_ms"] / k_ms
                                      if ra["ra_kernel_ms"] and k_ms
                                      else None),
            "build_s": c.build_s}


def load_latency_ns(c, flush):
    """The card's dependent-load latency, taken apart from the probe it
    bounds: the ``load_chain`` kernel's time a load, one thread following
    ``N_LATENCY_LOADS`` lines drawn at random without repeats from a buffer
    of the size and 128 B lines of ``c``'s table (word 0 of each line the
    index of the next: no hash, no compare), the L2 flushed before each
    call; its end held against the plain chain."""
    n_lines = c.table.lines.shape[0]
    order = np.random.default_rng(4).choice(n_lines, N_LATENCY_LOADS + 1,
                                            replace=False)
    words = torch.zeros((n_lines, 4 * nl.BUCKETS_PER_LINE),
                        dtype=torch.int32)
    words[torch.from_numpy(order[:-1]), 0] = torch.from_numpy(
        order[1:].astype(np.int32))
    words = words.to(flush.device)
    start = int(order[0])
    end = int(nl.load_chain(words, start, N_LATENCY_LOADS))
    if end != int(order[-1]) or end != int(ref.load_chain(
            words, start, N_LATENCY_LOADS)):
        fail(f"[N] load_chain ended at line {end}, not {order[-1]}")
    ms = time_ms(lambda: nl.load_chain(words, start, N_LATENCY_LOADS), 5,
                 flush)
    return ms * 1e6 / N_LATENCY_LOADS


def time_phase_n(state, flush):
    """Phase N's timings, after its launches were counted: T1's rows, the
    linear probe past the L2 beside phase A's 4M NeighborHash table, F9's
    rows, and the kernels line's ``probe_linear`` and
    ``probe_sequential`` rows."""
    runs = state["runs"]
    t1 = [t1_row(*runs[k], flush) for k in sorted(
        (k for k in runs if k[0] == "t1"), key=lambda k: (k[1], k[2]))]
    for row in t1:
        print("[N] T1 " + json.dumps(row), flush=True)
    # phase A's own 4M NeighborHash table, past the L2, with the same mix
    build = state["eng_a"].window.get(None)[2]
    group, host = build.groups[0], build.shard_tables[0][0]
    keys_a = host.items_arrays()[0]
    q = query_mix(keys_a, N_T1_QUERIES)
    qh, ql = (nl.to_device(x, flush.device) for x in hc.key_split_np(q))

    def probe_a():
        return nl.probe_lines(group, qh, ql, [0, len(q)])
    ms = time_ms(probe_a, N_ITERS, flush)
    k_ms = kernel_ms(probe_a, "probe_lines_kernel", N_ITERS, flush)
    ra = ra_timing(group, qh, ql, flush, N_ITERS)
    beside = {"variant": "neighborhash (phase A's table)",
              "keys": len(keys_a), "queries": len(q), "ms": ms,
              "kernel_ms": k_ms, "mkeys_per_s": len(q) / ms / 1e3,
              "apcl": host.apcl(q[:N_APCL_KEYS]),
              "probe_over_ra": ra["ra_ms"] / ms,
              "probe_over_ra_kernels": (ra["ra_kernel_ms"] / k_ms
                                        if ra["ra_kernel_ms"] and k_ms
                                        else None)}
    print("[N] T1 past the L2 beside linear: " + json.dumps(beside),
          flush=True)
    c_lat = runs["f9_seq", N_F9_SIZES[-1], "neighborhash"][0]
    latency = load_latency_ns(c_lat, flush)
    f9 = []
    for n in N_F9_SIZES:
        c, q, qh, ql = runs["f9_seq", n, "neighborhash"]
        _, qb, qbh, qbl = runs["f9_batch", n, "neighborhash"]

        def seq():
            return nl.probe_sequential(c.table, qh, ql)
        seq_ms = time_ms(seq, N_ITERS, flush)
        batch_ms = time_ms(lambda: c.probe(qbh, qbl), N_ITERS, flush)
        apcl = c.host.apcl(q)
        lines, _, _, _ = touched([c.host], qh, ql, [0, len(q)])
        row = {"keys": n, "seq_queries": len(q), "batch_queries": len(qb),
               "seq_ms": seq_ms,
               "seq_kernel_ms": kernel_ms(seq, "probe_sequential_kernel",
                                          N_ITERS, flush),
               "batch_ms": batch_ms,
               "batch_kernel_ms": kernel_ms(lambda: c.probe(qbh, qbl),
                                            "probe_lines_kernel", N_ITERS,
                                            flush),
               "seq_mkeys_per_s": len(q) / seq_ms / 1e3,
               "batch_mkeys_per_s": len(qb) / batch_ms / 1e3,
               "seq_apcl": apcl, "seq_lines": lines,
               # each line read first costs one dependent load; a bucket
               # of a line already read comes from L1
               "seq_latency_bound_ms": lines * latency / 1e6,
               "seq_bytes_bound_ms": (len(q) * 20 + lines * 128)
               / HBM_BYTES_PER_S * 1e3}
        row["speedup"] = row["batch_mkeys_per_s"] / row["seq_mkeys_per_s"]
        f9.append(row)
        print("[N] F9 " + json.dumps(row), flush=True)
    lin = next(r for r in t1 if r["variant"] == "linear"
               and r["keys"] == N_T1_SIZES[-1])
    c, q, qh, ql = runs["t1", N_T1_SIZES[-1], "linear"]
    linear_row = {
        "name": "probe_linear", "route": "cuda",
        "source": LIBRARIES["probe"],
        "replaces": REPLACES["probe_linear"], "launches": None,
        "max_abs_err": state["err"]["probe_linear"],
        "ms": lin["ms"], "kernel_ms": lin["kernel_ms"],
        "plain_ms": time_ms(lambda: c.plain(qh, ql), 3, flush),
        "bound_ms": lin["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "none: no PyTorch call probes a hash table",
        "shape": f"T1 at {lin['keys']} keys, {lin['queries']} queries",
        "t1": [r for r in t1 if r["variant"] == "linear"]}
    c, q, qh, ql = runs["f9_seq", N_F9_SIZES[-1], "neighborhash"]
    f9_big = f9[-1]
    seq_row = {
        "name": "probe_sequential", "route": "cuda",
        "source": LIBRARIES["probe"],
        "replaces": REPLACES["probe_sequential"], "launches": None,
        "max_abs_err": state["err"]["probe_sequential"],
        "ms": f9_big["seq_ms"], "kernel_ms": f9_big["seq_kernel_ms"],
        "plain_ms": time_ms(lambda: c.plain(qh, ql, sequential=True), 2,
                            flush),
        "bound_ms": f9_big["seq_bytes_bound_ms"], "bound_by": "bytes",
        "latency_bound_ms": f9_big["seq_latency_bound_ms"],
        "bound_note": "bound_ms: the function's bytes (20 B a query, 128 B "
                      "a line read) at the memory rate, what a batch probe "
                      "could approach; latency_bound_ms: this design's "
                      "chain, the lines read one after another times the "
                      "dependent-load latency",
        "load_latency_ns": latency,
        "load_latency_how": f"the load_chain kernel's time a load over "
                            f"{N_LATENCY_LOADS} dependent loads of random "
                            f"distinct lines of a buffer the size of the "
                            f"{N_F9_SIZES[-1]}-key table's lines, L2 flushed "
                            f"before each call",
        "library_ms": None,
        "library_note": "none: no PyTorch call probes a hash table",
        "shape": f"F9 at {N_F9_SIZES[-1]} keys, {N_F9_SEQ} queries",
        "f9": f9}
    return {"t1": t1, "t1_past_l2_beside": beside, "f9": f9,
            "load_latency_ns": latency}, [linear_row, seq_row]


# ---------------------------------------------------------------------------
# phase O: the consistency protocol's replica fleet on the card
# ---------------------------------------------------------------------------
class VersionedTruth:
    """The rows as written at each version: a base and each version's
    delta (keys, payloads, rows), applied in version order."""

    def __init__(self, truth: Truth):
        self.base, self.deltas = truth, {}

    def add(self, version, k, p, rows):
        o = np.argsort(k)
        self.deltas[version] = (k[o], p[o], rows[o])

    def _apply(self, q, version, out, field):
        for v in sorted(self.deltas):
            if v > version:
                break
            k = self.deltas[v][0]
            i = np.clip(np.searchsorted(k, q), 0, len(k) - 1)
            hit = k[i] == q
            out[hit] = self.deltas[v][field][i[hit]]
        return out

    def scalar(self, q, version):
        f, p = self.base.scalar(q)
        return f, self._apply(q, version, p.copy(), 1)

    def emb(self, q, version):
        f, rows = self.base.emb(q)
        return f, self._apply(q, version, rows.copy(), 2)


class FleetData:
    """Phase O's deployment: ``O_KEYS`` scalar keys and ``O_EMB_ROWS``
    1 KB rows (phase A's shapes), each rollout a delta generation of
    ``DELTA_KEYS`` keys drawn from the version's own seed."""

    def __init__(self):
        self.keys, payloads = nh.random_kv(O_KEYS, seed=5)
        self.emb_keys = self.keys[:O_EMB_ROWS]
        self.rows = np.random.default_rng(5).integers(
            0, 256, (O_EMB_ROWS, CONFIG.value_bytes), dtype=np.uint8)
        self.payloads = payloads
        self.truth = VersionedTruth(Truth(self.keys, payloads, self.emb_keys,
                                          self.rows))

    def tables(self, version):
        if version != 0:
            fail(f"[O] a full build of version {version} was asked for; "
                 "every rollout ships a delta")
        return ([eng.ScalarTable("item_attr", self.keys, self.payloads,
                                 load_factor=CONFIG.load_factor)],
                [eng.EmbeddingTable("item_emb", self.emb_keys, self.rows,
                                    hot_fraction=CONFIG.hot_fraction)])

    def deltas(self, version):
        rng = np.random.default_rng(1000 + version)
        k = self.emb_keys[rng.choice(O_EMB_ROWS, DELTA_KEYS, replace=False)]
        p = rng.integers(0, hc.PAYLOAD_MASK, DELTA_KEYS, dtype=np.uint64)
        r = rng.integers(0, 256, (DELTA_KEYS, CONFIG.value_bytes),
                         dtype=np.uint8)
        self.truth.add(version, k, p, r)
        return {"item_attr": (k, p), "item_emb": (k, r)}, {}

    def check(self, q, key_versions, data, what):
        """Each key's answer equal to the rows written at the version its
        sim shard answered from."""
        (af, ap), (ef, er) = data["item_attr"], data["item_emb"]
        for v in np.unique(key_versions):
            m = key_versions == v
            f, p = self.truth.scalar(q[m], int(v))
            if not (np.array_equal(af[m], f) and np.array_equal(ap[m], p)):
                fail(f"{what}: item_attr differs from version {v}'s rows")
            f, rows = self.truth.emb(q[m], int(v))
            if not (np.array_equal(ef[m], f)
                    and np.array_equal(er[m][f], rows[f])):
                fail(f"{what}: item_emb differs from version {v}'s rows")


def run_fleet(tag, data, protocol, device, log, use_query_server=False):
    """One ``ClusterSim`` over ``data`` on ``device``: rollouts every
    ``O_UPDATE_US`` of sim time, ``O_QUERIES`` batch queries of
    ``BATCH_KEYS`` zipf keys over both tables, one every 1 / ``O_QPS`` s;
    every answer checked at its shard's version, every probe launch
    against the plain probe.  Returns the sim (open) and its metrics."""
    cfg = cs.SimConfig(update_interval_us=O_UPDATE_US, seed=O_SEED)
    t0 = time.perf_counter()
    sim = cs.ClusterSim(cfg, protocol=protocol, tables_for_version=data.tables,
                        deltas_for_version=data.deltas,
                        use_query_server=use_query_server, device=device)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(O_SEED)
    host_s, launches0 = [], sum(nl.launches.values())
    mixed_keys = 0

    def schedule_update(version):
        sim.start_rolling_update(version)
        sim.sim.after(cfg.update_interval_us,
                      lambda: schedule_update(version + 1))

    def query(i):
        nonlocal mixed_keys
        q = zipf_keys(rng, data.keys, BATCH_KEYS)
        t = time.perf_counter()
        ok, versions, _lat, answer = sim.query_batch(
            {"item_attr": q, "item_emb": q})
        host_s.append(time.perf_counter() - t)
        log.check_pending()
        if not ok:
            return
        if protocol == "paper" and len(set(versions)) != 1:
            fail(f"[O] {tag}: batch {i} answered from versions {versions}")
        key_versions = np.asarray(versions)[sim._shard_of_keys(q)]
        mixed_keys += int((key_versions != key_versions.max()).sum())
        data.check(q, key_versions, answer, f"[O] {tag} batch {i}")

    sim.sim.after(cfg.update_interval_us, lambda: schedule_update(1))
    step = int(1e6 / O_QPS)
    for i in range(O_QUERIES):
        sim.sim.at(i * step, functools.partial(query, i))
    sim.sim.run_until(O_QUERIES * step - 1)   # before the next rollout
    m = sim.metrics
    ms = np.array(host_s) * 1e3
    out = {"protocol": protocol, "query_server": use_query_server,
           "build_s": build_s, "queries": m.queries,
           "failures": m.failures, "mixed_version_batches":
           m.mixed_version_batches, "mixed_rate": m.mixed_rate,
           "keys_off_the_newest_version": mixed_keys,
           "hedges": m.hedges,
           "sim_latency_p90_us": m.latency_quantile(0.90),
           "sim_latency_p99_us": m.latency_quantile(0.99),
           "host_ms_per_query_p50": float(np.median(ms)),
           "host_ms_per_query_mean": float(ms.mean()),
           "versions_published": sim.current_version,
           "update_wall_us": m.update_wall_us,
           "compactions": m.compactions,
           "probe_launches": sum(nl.launches.values()) - launches0}
    print(f"[O] {tag} " + json.dumps(out), flush=True)
    if m.queries != O_QUERIES or m.failures:
        fail(f"[O] {tag}: {m.queries} queries, {m.failures} failed")
    return sim, out


def run_phase_o(device, log):
    """Phase O: the fleet under ``paper``, under ``naming``, under
    ``paper`` behind the ``QueryServer``; a latest and a pinned query
    through ``FeatureClient(ClusterBackend(sim))``; and a
    ``BatchQueryService`` over the same keys against the engine and the
    host tables."""
    t0 = time.perf_counter()
    data = FleetData()
    out = {"data_s": time.perf_counter() - t0}
    sim, out["paper"] = run_fleet("paper", data, "paper", device, log)
    if out["paper"]["mixed_version_batches"]:
        fail("[O] the paper protocol answered a batch from mixed versions")
    # the fleet as a backend: a latest and a pinned read
    client = api.FeatureClient(api.ClusterBackend(sim))
    q = zipf_keys(np.random.default_rng(9), data.keys, BATCH_KEYS)
    latest = client.query({"item_attr": q, "item_emb": q})
    log.check_pending()
    if latest.version != sim.current_version:
        fail(f"[O] latest read at {latest.version}, the fleet's newest is "
             f"{sim.current_version}")
    old = client.query({"item_attr": q, "item_emb": q},
                       consistency=api.Consistency.pinned(latest.version - 1))
    log.check_pending()
    for res in (latest, old):
        data.check(q, np.full(len(q), res.version),
                   {name: (res[name].found, res[name].payloads
                           if name == "item_attr" else res[name].values)
                    for name in ("item_attr", "item_emb")},
                   f"[O] ClusterBackend at version {res.version}")
    out["cluster_backend"] = {"latest": latest.version,
                              "pinned": old.version}
    # BatchQueryService over the same keys at the newest version
    newest = sim.current_version
    payloads = data.truth.scalar(data.keys, newest)[1]
    t0 = time.perf_counter()
    svc = BatchQueryService(data.keys, payloads, device=device)
    build_s = time.perf_counter() - t0
    rng, lat = np.random.default_rng(10), []
    for b in range(O_BQS_BATCHES):
        q = zipf_keys(rng, data.keys, BATCH_KEYS)
        t = time.perf_counter()
        f, p = svc.query(q)
        lat.append(time.perf_counter() - t)
        log.check_pending()
        res = sim.engine.query({"item_attr": q}, version=newest, strict=True)
        wf, wp = data.truth.scalar(q, newest)
        if not (np.array_equal(f, res["item_attr"].found)
                and np.array_equal(p, res["item_attr"].payloads)
                and np.array_equal(f, wf) and np.array_equal(p, wp)):
            fail(f"[O] BatchQueryService batch {b} differs from the engine")
        owners = svc.plan.shard_of_np(q)
        for s, t in enumerate(svc.shards):
            hf, hp = t.lookup_host_batch(q[owners == s])
            if not (np.array_equal(f[owners == s], hf)
                    and np.array_equal(p[owners == s], hp)):
                fail(f"[O] BatchQueryService batch {b} differs from "
                     "lookup_host_batch")
    lat_ms = np.array(lat) * 1e3
    out["batch_query_service"] = {
        "shards": svc.n_shards, "build_s": build_s,
        "batches": svc.stats.batches, "hits": svc.stats.hits,
        "batch_p50_ms": float(np.median(lat_ms)),
        "batch_p99_ms": float(np.percentile(lat_ms, 99))}
    print("[O] BatchQueryService " + json.dumps(out["batch_query_service"]),
          flush=True)
    sim.close()
    del sim, svc, client
    gc.collect()
    sim, out["naming"] = run_fleet("naming", data, "naming", device, log)
    if not out["naming"]["mixed_rate"] > 0:
        fail("[O] the naming baseline mixed no batch")
    sim.close()
    del sim
    gc.collect()
    sim, out["paper_query_server"] = run_fleet(
        "paper behind the QueryServer", data, "paper", device, log,
        use_query_server=True)
    if out["paper_query_server"]["mixed_version_batches"]:
        fail("[O] the paper protocol behind the QueryServer mixed versions")
    sim.close()
    return out


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
    return model


# ---------------------------------------------------------------------------
# phase P: DIN's and BST's retrieval_cand (1M candidate rows a request)
# ---------------------------------------------------------------------------
LOGITS64 = {"din": din_logits64, "bst": bst_logits64}


def chunk_check(name, model, batch, rows, small):
    """``rows`` fixed rows of ``batch`` on the card ranked whole (one
    slice) and in slices of ``small``: values within TOP_K_TOL, indices
    by the tie rule; and one slice's forward timed by events."""
    cols = serve_step._upload({k: np.ascontiguousarray(batch[k][:rows])
                               for k in model.inputs}, model.device)
    with Calls(rec, "lax_top_k") as whole:
        want = rec.bulk_rank(model, cols, TOP_K, chunk_rows=rows)
    with Calls(rec, "lax_top_k") as sliced:
        got = rec.bulk_rank(model, cols, TOP_K, chunk_rows=small)
    res = check_top_k(got, sliced.calls[0][0], want, whole.calls[0][0],
                      f"[{name}] {rows} rows in slices of {small}")
    res.pop("distinct_values")
    res.update(rows=rows, slice_rows=small)
    if model.device.type == "cuda":
        warm = torch.empty(1, dtype=torch.uint8, device=model.device)
        with torch.inference_mode():
            res["slice_forward_ms"] = time_ms(
                lambda: model(*(cols[k] for k in model.inputs)), 3, warm)
    return res


def run_phase_p(name, model, n=R_CANDIDATES, requests=P_REQUESTS,
                distinct=P_DISTINCT, check_rows=SEQ_CHECK_ROWS,
                chunk=P_CHUNK_CHECK, seed=9):
    """DIN's or BST's retrieval_cand on ``model`` (by default at full
    published width): ``n`` candidate rows a request, each with its own
    history (``synthetic.recsys_batch``), through the launcher's
    ``cell_requests`` (``serve_step.bulk_rank_fn``: one upload, the
    forward in slices of ``rec.BULK_CHUNK_ROWS``, one ``lax_top_k``); a
    warm-up, ``requests`` timed, one traced, drawn as ``distinct`` batches
    cycled.  Every request's top 100 is held to the card's own [n] logits
    (bitwise, ``lax.top_k``'s order), and the logits of its top 100 and
    of ``check_rows`` fixed rows to the float64 recompute; once, the
    chunked answer to the unchunked one.  Returns the phase's metrics."""
    cfg, device = model.cfg, model.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell = registry.cell_by_name("retrieval_cand")
    cell = registry.Cell(cell.name, cell.kind,
                         dict(cell.dims, n_candidates=n))
    step, draw = launch_serve.cell_requests(cfg, cell, n, model)
    t0 = time.perf_counter()
    batches = draw_requests(draw, distinct, seed)
    drawn = {"distinct": distinct, "seconds": time.perf_counter() - t0,
             "bytes_per_request": sum(batches[0][0][k].nbytes
                                      for k in model.inputs)}
    print(f"[{name}] drew {distinct} requests of {n} rows "
          f"({drawn['bytes_per_request']} B each) in "
          f"{drawn['seconds']:.1f} s", flush=True)
    fixed = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        n, check_rows, replace=False))).to(device)
    clock = LayerClock((
        (serve_step, "_upload", "upload"),
        (type(model), "forward", "forward_enqueue"),
        (rec, "lax_top_k", "top_k_enqueue")))
    last = {}

    def check(got, uploads, topk, what):
        (scores, _), = topk.calls
        if scores.shape != (n,) or not bool(scores.isfinite().all()):
            fail(f"{what}: logits are not finite of shape ({n},)")
        res = check_top_k(got, scores, got, scores, what)
        dev = uploads.last[1]
        idx = torch.cat([got[1], fixed])
        want = LOGITS64[cfg.arch](model, {k: dev[k][idx]
                                          for k in model.inputs})
        err = float((scores[idx].double() - want).abs().max())
        if not err <= P_TOL:
            fail(f"{what}: logits differ from the float64 recompute by "
                 f"{err}")
        res["max_abs_err_vs_fp64"] = err
        last["scores"] = scores
        return res

    lat, wait, checks, prof, traced_ms = run_retrieval(
        name, step, [batches[r % distinct] for r in range(requests + 2)],
        check, clock, lambda what: None, device)
    m = retrieval_metrics(name, cfg, n, lat, wait, checks, clock, prof,
                          traced_ms, device)
    slices = -(-n // rec.BULK_CHUNK_ROWS)
    if clock.calls["forward_enqueue"] != slices * requests:
        fail(f"[{name}] {clock.calls['forward_enqueue']} forwards in "
             f"{requests} timed requests, expected {slices} each")
    m.update(
        drawn=drawn, chunk_rows=rec.BULK_CHUNK_ROWS,
        slices_per_request=slices,
        host_forward_enqueue_ms_per_slice=clock.seconds["forward_enqueue"]
        * 1e3 / clock.calls["forward_enqueue"],
        max_abs_err_vs_fp64=max(c["max_abs_err_vs_fp64"] for c in checks),
        rows_checked_vs_fp64=TOP_K + check_rows,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    m["traced_request"]["device_ms_by_op"] = ops_by_device_ms(prof)
    m["chunk_check"] = chunk_check(name, model, batches[0][0], *chunk)
    if device.type == "cuda":
        warm = torch.empty(1, dtype=torch.uint8, device=device)
        m["top_k_ms"] = time_ms(
            lambda: rec.lax_top_k(last["scores"], TOP_K), 5, warm)
        m["max_memory_allocated"] = max_memory(device)
        if not m["max_memory_allocated"] < P_PEAK_BYTES:
            fail(f"[{name}] peak memory {m['max_memory_allocated']} B is "
                 f"not under {P_PEAK_BYTES} B")
    return m


# ---------------------------------------------------------------------------
# phase Q: the port's load-test launcher, in-process
# ---------------------------------------------------------------------------
def run_phase_q(argv=Q_ARGV):
    """``launch/loadtest.main(argv)`` in-process with a record file: the
    run must exit 0, its SLO report line parse, and its registry hold the
    traffic and controller families.  Returns the report's numbers (none
    is gated: they are timings)."""
    from repro_torch.launch import loadtest
    record = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_loadtest.json")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            loadtest.main(list(argv) + ["--record", record])
            rc = 0
        except SystemExit as e:
            rc = e.code
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    print("\n".join("[Q] " + line for line in text.splitlines()),
          flush=True)
    if rc != 0:
        fail(f"[Q] loadtest exited {rc}")
    prefix = "loadtest SLO report: "
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    if len(lines) != 1:
        fail(f"[Q] {len(lines)} SLO report lines")
    report = json.loads(lines[0][len(prefix):])
    with open(record) as f:
        metrics = json.load(f)["metrics"]
    os.remove(record)
    families = {k.split("{")[0] for k in metrics}
    for want in ("repro_traffic_requests_offered_total",
                 "repro_traffic_class_requests_offered_total",
                 "repro_traffic_ctl_ticks_total",
                 "repro_traffic_ctl_lane_max_batch_keys"):
        if want not in families:
            fail(f"[Q] the registry lacks {want}")
    keys = ("offered", "completed", "shed", "failed", "attainment",
            "offered_rps", "dispatch_lag_ms", "p50_ms", "p99_ms",
            "per_class", "burst", "controller")
    return {"phase": "Q", "argv": list(argv), "exit_code": rc,
            "seconds": seconds,
            "families": sorted(f for f in families
                               if f.startswith("repro_traffic")),
            **{k: report.get(k) for k in keys}}


# ---------------------------------------------------------------------------
# phase R: the serving fabric, every Router in a torch-free child
# ---------------------------------------------------------------------------
# r_expected, r1_deployment, r3_qps and r_child run in the child
# interpreter, which gets their source through ``python -c`` (no file for
# the spawned shard servers to re-run as ``__main__``) and cannot import
# torch: each imports what it needs itself and reads nothing of this
# module's globals.
def r_expected(keys, rows, written, q, version):
    """The rows of present keys ``q`` as last written at or before
    ``version``: the built rows, then each key's publishes in order."""
    import bisect

    import numpy as np
    idx = np.searchsorted(keys, q)
    out = rows[idx]
    for i in np.flatnonzero(np.isin(idx, np.fromiter(written, np.int64))):
        versions, got = written[int(idx[i])]
        j = bisect.bisect_right(versions, version)
        if j:
            out[i] = got[j - 1]
    return out


def r1_deployment(p):
    """R.1: the checked deployment.  Returns its numbers and the checks it
    failed."""
    import threading
    import time

    import numpy as np

    from repro_torch.api import (Consistency, FeatureClient, QueryRequest,
                                 UpdateRequest, as_backend, wire)
    from repro_torch.core.query_types import EmbeddingTable
    from repro_torch.serve.fabric import (FabricConfig, FabricError, Router,
                                          shard_of_keys)

    failures = []
    rng = np.random.default_rng(p["seed"])
    keys = np.unique(rng.integers(1, 1 << 62, p["rows"] * 2,
                                  dtype=np.uint64))[:p["rows"]]
    rows = rng.integers(0, 256, (len(keys), p["value_bytes"]),
                        dtype=np.uint8)
    cfg = FabricConfig(n_shards=p["shards"], n_replicas=p["replicas"],
                       snapshot_root=p["root"],
                       health_period_s=p["health_period_s"],
                       snapshot_every=p["snapshot_every"])
    t0 = time.perf_counter()
    router = Router.build([EmbeddingTable(
        "emb", keys, rows, hot_fraction=p["hot_fraction"])], cfg)
    m = {"build_and_spawn_s": time.perf_counter() - t0}
    print(f"R.1: {p['shards']} shards x {p['replicas']} replicas over "
          f"{len(keys)} rows of {p['value_bytes']} B up in "
          f"{m['build_and_spawn_s']:.2f} s", flush=True)
    # key index -> ([version, ...], [row, ...]) in version order, written
    # before each publish goes out: a publish that fails typed stays in
    # the router's update log and reaches the fleet with the next one
    written: dict = {}
    wlock = threading.Lock()
    stop = threading.Event()
    client = FeatureClient(as_backend(router), default_budget_s=5.0)
    answers, lat, fabric_errors, other_errors = [], [], [0], []
    kills, kill_to_answer = [], []
    lock = threading.Lock()
    total = p["clients"] * p["batches"]
    # the first kill waits for a quarter of the batches, so that one lands
    # under load however fast the host drives them; then one every chaos_s
    quarter = threading.Event()

    def worker(cid):
        wrng = np.random.default_rng(100 + cid)
        for _ in range(p["batches"]):
            idx = (wrng.zipf(p["zipf_a"], p["batch_keys"]) - 1) % len(keys)
            q = keys[idx]
            absent = wrng.random(len(q)) < p["absent"]
            q[absent] = wrng.integers(2**63, 2**64 - 2, int(absent.sum()),
                                      dtype=np.uint64)
            t = time.perf_counter()
            try:
                res = client.query({"emb": q})
            except FabricError:
                with lock:
                    fabric_errors[0] += 1
                continue
            except Exception as e:  # noqa: BLE001  (a check that fails)
                with lock:
                    other_errors.append(repr(e))
                continue
            ms = (time.perf_counter() - t) * 1e3
            with lock:
                lat.append(ms)
                answers.append((q, res.version, res["emb"].found,
                                res["emb"].values))
                if 4 * len(answers) >= total:
                    quarter.set()

    def publisher():
        prng = np.random.default_rng(7)
        version = router.fleet_version
        while not stop.wait(p["publish_s"]):
            version += 1
            idx = prng.choice(len(keys), p["delta_rows"], replace=False)
            new = prng.integers(0, 256, (len(idx), p["value_bytes"]),
                                dtype=np.uint8)
            with wlock:
                for i, row in zip(idx.tolist(), new):
                    vs, rs = written.setdefault(i, ([], []))
                    vs.append(version)
                    rs.append(row)
            try:
                router.apply_update(UpdateRequest(
                    version=version, upserts={"emb": (keys[idx], new)}))
            except FabricError:
                pass

    def first_answer(s, r, dead, t_kill):
        deadline = time.monotonic() + p["wait_s"]
        while time.monotonic() < deadline:
            h = router.replicas[s][r]
            if h is not None and h is not dead and h.alive:
                try:
                    h.call(wire.KIND_HEALTH, wire.encode_tree({}),
                           timeout=p["wait_s"])
                except FabricError:
                    continue
                with lock:
                    kill_to_answer.append(time.monotonic() - t_kill)
                return
            time.sleep(0.005)

    watchers = []

    def chaos():
        crng = np.random.default_rng(13)
        quarter.wait(p["wait_s"])
        while not stop.is_set():
            s = int(crng.integers(0, p["shards"]))
            r = int(crng.integers(0, p["replicas"]))
            h = router.replicas[s][r]
            if h is not None and h.alive:
                print(f"chaos: killing shard {s} replica {r}", flush=True)
                t_kill = time.monotonic()
                h.kill()
                kills.append((s, r))
                w = threading.Thread(target=first_answer,
                                     args=(s, r, h, t_kill), daemon=True)
                w.start()
                watchers.append(w)
            stop.wait(p["chaos_s"])

    threads = [threading.Thread(target=worker, args=(c,))
               for c in range(p["clients"])]
    aux = [threading.Thread(target=publisher, daemon=True),
           threading.Thread(target=chaos, daemon=True)]
    t0 = time.perf_counter()
    for t in threads + aux:
        t.start()
    for t in threads:
        t.join(p["wait_s"] * 4)
    wall = time.perf_counter() - t0
    stop.set()
    for t in aux:
        t.join(p["wait_s"])
    for t in watchers:
        t.join(p["wait_s"])
    if any(t.is_alive() for t in threads + aux + watchers):
        failures.append("a client, publisher or chaos thread hung")

    def whole():
        """Every replica alive and at the fleet version."""
        for g in router.replicas:
            for h in g:
                if h is None or not h.alive:
                    return False
                try:
                    _, data = h.call(wire.KIND_HEALTH, wire.encode_tree({}),
                                     timeout=p["wait_s"])
                except FabricError:
                    return False
                if wire.decode_tree(data)["version"] != router.fleet_version:
                    return False
        return True

    # the whole fleet back at the fleet version, then one snapshot timed
    deadline = time.monotonic() + p["wait_s"]
    while time.monotonic() < deadline:
        if whole():
            break
        time.sleep(0.05)
    else:
        failures.append("the fleet did not come back whole at the fleet "
                        "version")
    t = time.perf_counter()
    router.snapshot_now()
    m["snapshot_s"] = time.perf_counter() - t

    # every answer against the rows written at or before its version
    if len(answers) + fabric_errors[0] + len(other_errors) != total:
        failures.append(f"{total} batches sent, {len(answers)} answered, "
                        f"{fabric_errors[0] + len(other_errors)} errors")
    if other_errors:
        failures.append(f"errors not typed FabricError: {other_errors[:3]}")
    bad = 0
    for q, version, found, values in answers:
        present = q < np.uint64(2**63)
        if not np.array_equal(found, present):
            bad += 1
            continue
        want = r_expected(keys, rows, written, q[present], version)
        if not np.array_equal(values[present], want):
            bad += 1
    if bad:
        failures.append(f"{bad} of {len(answers)} answers differ from the "
                        f"rows written at their versions")
    # every replica asked directly, at the fleet version, for every key
    # written in the run: the respawned ones replayed the update log
    v = router.fleet_version
    widx = np.array(sorted(written), dtype=np.int64)
    owner = shard_of_keys(keys[widx], p["shards"])
    readback = 0
    for s, group in enumerate(router.replicas):
        sk = keys[widx[owner == s]]
        want = r_expected(keys, rows, written, sk, v)
        for r, h in enumerate(group):
            try:
                _, data = h.call(wire.KIND_QUERY, wire.encode_request(
                    QueryRequest(tables={"emb": sk},
                                 consistency=Consistency.pinned(v))),
                    timeout=p["wait_s"])
                res = wire.decode_response(data)
            except Exception as e:  # noqa: BLE001  (a check that fails)
                failures.append(f"shard {s} replica {r}: {e!r}")
                continue
            tr = res.tables["emb"]
            if res.version != v or not tr.found.all() \
                    or not np.array_equal(tr.values, want):
                failures.append(f"shard {s} replica {r} does not hold the "
                                f"rows written up to version {v}")
            readback += len(sk)
    c = router.metrics.snapshot()
    router.close()
    if c.mixed_version_averted:
        failures.append(f"mixed_version_averted = {c.mixed_version_averted}")
    if c.respawns < 1:
        failures.append("no replica was respawned")
    done = len(lat)
    m.update({
        "batches": total, "answered": done, "fabric_errors": fabric_errors[0],
        "batch_p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "batch_p99_ms": float(np.percentile(lat, 99)) if lat else None,
        "batches_per_s": done / wall,
        "key_seeks_per_s": done * p["batch_keys"] / wall,
        "drive_s": wall, "kills": len(kills),
        "kill_to_first_answer_s": sorted(kill_to_answer),
        "fleet_version": v, "keys_written": len(widx),
        "readback_keys": readback, "answers_checked": len(answers),
        "counts": {k: getattr(c, k) for k in (
            "queries", "sub_queries", "updates", "consistent_batches",
            "mixed_version_averted", "version_retries", "failovers",
            "replica_failures", "respawns", "snapshots")}})
    return m, failures


def r3_qps(p):
    """R.3: test_fabric_qps_scaling_acceptance's measurement, not gated:
    8 client threads x 25 queries of 1024 keys at 1 and 4 shards."""
    import os
    import threading
    import time

    import numpy as np

    from repro_torch.api import QueryRequest
    from repro_torch.core.query_types import EmbeddingTable
    from repro_torch.serve.fabric import FabricConfig, Router

    n = p["rows"]
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 62, n * 2, dtype=np.uint64))[:n]
    vals = np.random.default_rng(3).integers(0, 255, (n, p["value_bytes"]),
                                             dtype=np.uint8)
    table = EmbeddingTable("emb", keys, vals,
                           hot_fraction=p["hot_fraction"])
    qps = {}
    for n_shards in p["shards"]:
        router = Router.build([table], FabricConfig(
            n_shards=n_shards, n_replicas=1, respawn=False,
            snapshot_root=os.path.join(p["root"], f"s{n_shards}")))
        try:
            reqs = [{"emb": keys[np.random.default_rng(100 + c).integers(
                0, n, p["batch_keys"])]} for c in range(p["clients"])]
            for r in reqs[:2]:
                router.query(QueryRequest(tables=r))
            done = [0]
            lock = threading.Lock()

            def worker(req):
                for _ in range(p["queries"]):
                    router.query(QueryRequest(tables=req))
                    with lock:
                        done[0] += 1

            threads = [threading.Thread(target=worker, args=(r,))
                       for r in reqs]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            qps[n_shards] = done[0] / (time.perf_counter() - t0)
        finally:
            router.close()
    lo, hi = min(p["shards"]), max(p["shards"])
    return {"qps": {str(k): v for k, v in qps.items()},
            "ratio": qps[hi] / qps[lo], "reference_floor": 2.5,
            "host_cpus": os.cpu_count()}


def r_child(p):
    """Phase R's child: R.1, then R.3; one ``R result:`` line."""
    import json
    import sys
    m1, failures = r1_deployment(p["r1"])
    m3 = r3_qps(p["r3"])
    torch_mods = sorted(k for k, v in sys.modules.items()
                        if v is not None and k.split(".")[0] == "torch")
    if torch_mods:
        failures.append(f"the fabric's interpreter imported {torch_mods}")
    print("R result: " + json.dumps({"r1": m1, "r3": m3,
                                     "failures": failures}), flush=True)
    return 1 if failures else 0


R_CHILD = (r_expected, r1_deployment, r3_qps, r_child)


def run_phase_r(r1=R1, r3=R3):
    """R.1 and R.3 in one child interpreter (``python -c``, so the spawned
    shard servers re-run no ``__main__`` file), R.2 as ``python -m
    repro_torch.launch.fabric``; in both, ``PYTHONPATH`` starts with a
    directory whose ``torch`` package raises ``ImportError``, so every
    process of every fabric is shown to boot without torch.  Their output
    goes to the log with an ``[R]`` prefix; a non-zero exit (the child's
    on a failed check of R.1, which it lists on its ``R result:`` line) or
    a bad record fails the run.  Returns the numbers: R.1's checks are the
    only gates, R.3's ratio is printed, not gated."""
    import inspect
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke_fabric")
    shutil.rmtree(work, ignore_errors=True)
    shim = os.path.join(work, "shim", "torch")
    os.makedirs(shim)
    with open(os.path.join(shim, "__init__.py"), "w") as f:
        f.write("raise ImportError('phase R: the fabric runs without "
                "torch')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(shim), os.path.join(repo, "src")]))
    code = "\n\n".join(inspect.getsource(fn) for fn in R_CHILD) \
        + "\n\nimport json, sys\nsys.exit(r_child(json.loads(sys.argv[1])))\n"
    params = {"r1": {**r1, "root": os.path.join(work, "r1")},
              "r3": {**r3, "root": os.path.join(work, "r3")}}

    def run(tag, argv):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True,
                              text=True, timeout=R_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        print("\n".join("[R] " + line for line in text.splitlines()),
              flush=True)
        if proc.returncode != 0:
            fail(f"[R] {tag} exited {proc.returncode}")
        return text, seconds

    try:
        out, seconds = run("R.1/R.3", [sys.executable, "-c", code,
                                       json.dumps(params)])
        prefix = "R result: "
        result = json.loads([ln for ln in out.splitlines()
                             if ln.startswith(prefix)][-1][len(prefix):])
        record = os.path.join(repo, "build", "chip_smoke_fabric.json")
        r2_text, r2_seconds = run("R.2", [
            sys.executable, "-m", "repro_torch.launch.fabric", *R2_ARGV,
            "--snapshot-root", os.path.join(work, "r2"), "--record",
            record])
        with open(record) as f:
            rec = json.load(f)
        os.remove(record)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if rec.get("ok") is not True:
        fail(f"[R] the launcher's record says ok={rec.get('ok')}")
    families = {k.split("{")[0] for k in rec["metrics"]}
    for want in ("repro_fabric_version_retries_total",
                 "repro_fabric_failovers_total",
                 "repro_fabric_respawns_total"):
        if want not in families:
            fail(f"[R] the launcher's record lacks {want}")
    if not rec["metrics"].get("repro_fabric_queries_total", 0) > 0:
        fail("[R] the launcher's record counts no query")
    r2 = {"argv": R2_ARGV, "alias": rec["alias"], "seconds": r2_seconds,
          "kills": r2_text.count("chaos: killing"),
          **{k.split("_total")[0].removeprefix("repro_fabric_"): v
             for k, v in rec["metrics"].items()
             if k.startswith("repro_fabric_")}}
    if not (r2["kills"] >= 1 and r2.get("updates", 0) >= 1
            and r2.get("respawns", 0) >= 1):
        fail(f"[R] R.2 drove no chaos: {r2['kills']} kills, "
             f"{r2.get('updates')} updates, {r2.get('respawns')} respawns")
    return {"phase": "R", "seconds_r1_r3": seconds, "r1": result["r1"],
            "r2": r2, "r3": result["r3"]}


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
    """Every ``embedding_bag.embedding_bag_backward`` launch bit for bit
    against ``ref.embedding_bag_backward_ordered`` (the plain version of
    the kernel's order) on the same tensors, and against the plain
    ``index_add_`` gradient element by element: |kernel - plain| <= min(2
    n 2^-24, BAG_GRAD_REL) S + 1e-30, n the terms the row adds and S the
    sum of their magnitudes (both add the same n terms in two orders:
    recursive summation's bound, Higham; on hot rows, where that bound is
    loose, a fixed share of S).  Keeps the largest |kernel - plain| / S and
    the largest n."""

    def __init__(self):
        super().__init__(bagk, "embedding_bag_backward")
        self.max_rel = 0.0
        self.max_n = 0

    def check(self, args, kw, out) -> None:
        if not torch.equal(ref.embedding_bag_backward_ordered(*args)
                           .view(torch.int32), out.view(torch.int32)):
            fail(f"embedding_bag_backward differs from the plain version of "
                 f"its order on {tuple(args[1].shape)}")
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


def host_copy(params, state):
    """A checkpoint of (params, state) held in host memory: every leaf
    copied to the CPU (the card has no room for a second copy of M.1's
    tables beside a step)."""
    return ({k: v.to("cpu") for k, v in params.items()},
            {k: {n: v.to("cpu") for n, v in st.items()}
             for k, st in state.items()})


def train_cell(tag, cfg, make_step, device, *, rows, steps, seed,
               first=None, after=None, peak_limit=None, resume=None):
    """``cfg`` from seed 0 on ``device`` (by default the card), trained on
    ``steps`` + 2 batches of ``rows`` drawn and uploaded first: a warm-up,
    ``steps`` timed steps (events and host clock) and one traced.
    ``first(params, batch)`` runs at the initial parameters before the
    warm-up; ``after(i, params, state, metrics)`` after every step.
    ``resume(params, state, step, batch, fn, want)``, where given, runs
    after the traced step with the state the first timed step started
    from (restored from a host copy into fresh tensors), that step's batch
    and function, and ``want``, host copies of that step's result; what it
    returns goes into the step metrics under ``resume``.  Returns None,
    without the timed steps, when the warm-up's peak memory reaches
    ``peak_limit``; else the cell's metrics."""
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
    saved = {}
    for i, b in enumerate(batches[1:steps + 1]):  # one call a step: no
        if resume is not None and i == 0:         # step's inputs outlive
            saved["at"] = host_copy(p, s) + (st,)  # it here
        p, s, st, e, h, m = timed_steps(fn, p, s, st, [b], after)
        ev, host, ms = ev + e, host + h, ms + m
        if resume is not None and i == 0:
            saved["want"] = host_copy(p, s)
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
    if resume is not None:
        (hp, hs, st0), want = saved.pop("at"), saved.pop("want")
        params = {k: v.to(device) for k, v in hp.items()}
        state = {k: {n: v.to(device) for n, v in x.items()}
                 for k, x in hs.items()}
        del hp, hs
        summary["resume"] = resume(params, state, st0, batches[1], fn, want)
        del params, state, want
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
    return {**nl.launches, **fm.launches, **bagk.launches, **segk.launches}


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

    def resume(params, state, step, batch, fn, want):
        """The first timed step again from its state restored, against the
        uninterrupted run's result, leaf by leaf, bit for bit; each leaf
        that differs named with the operations that write its gradient."""
        p, s, _, m = fn(params, state, step, batch)
        after(None, p, s, m)          # the logs hold this step's launches
        del params, state
        wp, ws = want
        leaves = [(k, p[k], wp[k]) for k in p] + [
            (f"{k}/{n}", s[k][n], ws[k][n]) for k in s for n in s[k]]
        differs = {k: writers(k.split("/")[0]) for k, a, b in leaves
                   if not same_bits(a, b.to(a.device))}
        return {"steps": 1, "loss": float(m["loss"]),
                "leaves": len(leaves), "bitwise": not differs,
                "differs": differs}

    while True:                       # each attempt counts from zero
        cut = dataclasses.replace(cfg, user_vocab=users, item_vocab=items)
        zero(nl.launches, fm.launches, bagk.launches, bagk.paths)
        with BagLog() as bag_log, BagBackwardLog() as bwd_log:
            try:
                dense = train_cell(
                    "M.1", cut, dense_step, device, rows=rows, steps=steps,
                    seed=61, first=first, peak_limit=peak_limit,
                    after=after, resume=resume)
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
    again = dense["steps"]["resume"]
    again["loss_bitwise"] = again["loss"] == dense["steps"]["loss"][0]
    print(f"[M.1] the first timed step again from its state restored: "
          + ("bitwise the uninterrupted run's in all "
             f"{again['leaves']} parameter and optimizer leaves"
             if again["bitwise"] and again["loss_bitwise"] else
             f"differs from the uninterrupted run (loss bitwise: "
             f"{again['loss_bitwise']}) in {json.dumps(again['differs'])}"),
          flush=True)
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


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def writers(key: str) -> str:
    """The operations of two-tower's dense step that write the gradient of
    parameter ``key`` (its optimizer state follows it)."""
    if key == "item_table":
        return ("embedding_bag_backward (the history bag; each launch is "
                "held bitwise to its ordered plain version) and index_put_ "
                "(the item gather's backward)")
    if key.endswith("_table"):
        return f"index_put_ (the {key[:-6]} gather's backward)"
    return "the towers' backward (fp32 GEMMs, reductions) and the optimizer"


def bag_backward_bound(ids, weights, n_rows, dim):
    """The least time of the bag's gradient at ``ids`` [B, L] (and
    ``weights``) and fp32 g [B, dim] into [n_rows, dim] on this card: g,
    the ids and the weights read once, the dense gradient written once
    (its adds, one a valid entry and column, are far below the bytes).
    Beside it the shares of its two parts: the levels' (the same reads and
    each distinct touched row written once) and the zero fill's (every row
    written once), which run one after the other."""
    valid = ids[(ids >= 0) & (ids < n_rows)]
    rows = int(torch.unique(valid).numel())
    io = ids.numel() * 4 * (1 if weights is None else 2) \
        + ids.shape[0] * dim * 4
    t_bytes = (io + n_rows * dim * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = valid.numel() * dim / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "levels_bound_ms": (io + rows * dim * 4) / HBM_BYTES_PER_S * 1e3,
            "fill_bound_ms": n_rows * dim * 4 / HBM_BYTES_PER_S * 1e3,
            "distinct_rows": rows}


def kernels_per_call_ms(fn, kernels, iters, flush):
    """Device ms a call of ``fn`` spends in the CUDA kernels whose names
    hold each of ``kernels``, from one torch.profiler trace of ``iters``
    calls (cold L2), and their sum under ``"all"``; None (not measured)
    where the profiler records no device time."""
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
    except RuntimeError as e:             # CUPTI unavailable
        print(f"kernels_per_call_ms: not measured ({e})", file=sys.stderr)
        return dict.fromkeys([*kernels, "all"])
    out = {k: sum(e.self_device_time_total for e in prof.key_averages()
                  if k in e.key) / iters / 1e3 for k in kernels}
    out["all"] = sum(out.values())
    return out if out["all"] > 0 else dict.fromkeys(out)


def measure_bag_backward(bwd_log, flush):
    """embedding_bag_backward at M.1's shape (its last launch's inputs), by
    events (the wrapper: the zero fill, the sort, the plan and the
    kernels) and by profiler (each kernel alone, a call's sum), cold L2,
    the zero fill, the sort and the plan (with its sort; and its host time)
    timed apart, beside both plain gradients, the bound and ``torch.autograd.grad`` of
    ``F.embedding_bag`` (mean, ``padding_idx`` a row appended to the table)
    on the same bags.  Holds two launches on the same inputs to the same
    bits, and the scatter exactly: on g of ones in ``sum`` mode each row's
    gradient is the count of entries it takes, an integer fp32 adds
    exactly (below 2^24), so a dropped or repeated term shows even on the
    hottest row."""
    g, ids, w, mode, n_rows = bwd_log.last
    kernel = functools.partial(bagk.embedding_bag_backward, g, ids, w, mode,
                               n_rows)
    plain = functools.partial(ref.embedding_bag_backward, g, ids, w, mode,
                              n_rows)
    ordered = functools.partial(ref.embedding_bag_backward_ordered, g, ids,
                                w, mode, n_rows)
    got = kernel()
    if not torch.equal(kernel().view(torch.int32), got.view(torch.int32)):
        fail("two embedding_bag_backward launches on the same inputs differ")
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
    def sort():
        return bagk.embedding_bag_backward_sort(ids, n_rows)

    def plan():
        return bagk.embedding_bag_backward_plan(*sort(), n_rows)
    levels = plan().levels
    grad = torch.empty(n_rows, g.shape[1], device=g.device)
    fill_ms = time_ms(grad.zero_, 20, flush)
    del grad
    parts = kernels_per_call_ms(
        kernel, ("bag_backward_scale_kernel", "bag_backward_level_kernel"),
        20, flush)
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
            "launches_bitwise_ordered": bwd_log.checked,
            "shape": {"g": list(g.shape), "ids": list(ids.shape),
                      "rows": n_rows, "mode": mode},
            "plan": {"chunk": bagk.BAG_CHUNK, "levels": len(levels),
                     "chunks": [lv.n_chunks for lv in levels]},
            "check_max_abs_err": err, "counts_exact": True,
            "repeat_bitwise": True,
            "ms": time_ms(kernel, 20, flush),
            "sort_ms": time_ms(sort, 20, flush),
            "plan_ms": time_ms(plan, 20, flush),
            "plan_host_ms": host_ms(plan, 20),
            "kernel_ms": parts["all"],
            "scale_kernel_ms": parts["bag_backward_scale_kernel"],
            "levels_kernel_ms": parts["bag_backward_level_kernel"],
            "zero_fill_ms": fill_ms, "host_ms": host_ms(kernel, 20),
            "plain_ms": time_ms(plain, 5, flush),
            "ordered_plain_ms": time_ms(ordered, 3, flush),
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


# ---------------------------------------------------------------------------
# phase S: GraphSAGE trained on the card in its three regimes
# ---------------------------------------------------------------------------
class CsrLog(OpLog):
    """Every ``ops.csr_sum`` call (the neighbour mean's sums, forward and
    backward) held against ``ref.csr_sum`` on the same inputs, element by
    element within min(2 n 2^-24, 1e-4) S + 1e-30 (n the segment's terms,
    S their magnitudes' sum: two orders' bound, as for the bag gradient),
    on every row, or on ``S_CHECK_ROWS`` fixed rows (and the longest
    segment's) where a launch has more.  Keeps the last call of each CSR
    and width under ``kept`` (inputs and output) for the repeat check and
    the timings."""

    def __init__(self):
        super().__init__("csr_sum", ref.csr_sum, 0.0, 0.0)
        self.kept = {}
        self.bitwise = 0          # launches equal to the plain version
        self.max_rel = 0.0        # max |err| / (S + 1e-30)

    def check(self, args, kw, out) -> None:
        x, indptr, indices = args
        self.kept[(x.shape[1], indptr.data_ptr())] = (
            x.detach(), indptr, indices, out.detach())
        n_rows = indptr.shape[0] - 1
        if n_rows <= S_CHECK_ROWS:
            rows = None
            sub = (indptr, indices)
        else:
            g = torch.Generator(device=x.device).manual_seed(S_SEED)
            pick = torch.randperm(n_rows, generator=g,
                                  device=x.device)[:S_CHECK_ROWS]
            longest = torch.argmax(indptr[1:] - indptr[:-1])[None]
            rows = torch.unique(torch.cat([pick, longest]))
            sub = sub_csr(indptr, indices, rows)
        got = out if rows is None else out[rows]
        want = ref.csr_sum(x, *sub)
        s = ref.csr_sum(x.abs(), *sub)
        n = (sub[0][1:] - sub[0][:-1]).to(s.dtype)[:, None]
        tol = torch.clamp(2 * n * BAG_GRAD_U, max=BAG_GRAD_REL) * s + 1e-30
        err = (got - want).abs()
        self.max_err = max(self.max_err, float(err.max()) if err.numel()
                           else 0.0)
        self.max_rel = max(self.max_rel, float((err / (s + 1e-30)).max())
                           if err.numel() else 0.0)
        self.bitwise += int(torch.equal(got, want))
        if not bool((err <= tol).all()):
            fail(f"csr_sum differs from ref.csr_sum on {tuple(x.shape)} x "
                 f"{n_rows} rows (max abs err {float(err.max())})")


def sub_csr(indptr, indices, rows):
    """(indptr, indices) of the CSR's ``rows`` alone, in that order."""
    length = indptr[rows + 1] - indptr[rows]
    sub_ptr = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                          device=indptr.device)
    torch.cumsum(length, 0, out=sub_ptr[1:])
    offset = torch.repeat_interleave(indptr[rows] - sub_ptr[:-1], length)
    pos = torch.arange(int(sub_ptr[-1]), device=indptr.device) + offset
    return sub_ptr, indices[pos]


def csr_bound(x, indptr, indices):
    """The least time of ``csr_sum`` on these inputs on this card: the
    distinct rows of x the indices name, the indices, indptr read once and
    [R, D] fp32 written once, against its adds (one a term and column)."""
    dim = x.shape[1]
    distinct = int(torch.unique(indices).numel()) if indices.numel() else 0
    n_rows = indptr.shape[0] - 1
    t_bytes = (distinct * dim * 4 + indices.numel() * 4 + indptr.numel() * 8
               + n_rows * dim * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = indices.numel() * dim / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "distinct_rows": distinct}


def csr_timing(x, indptr, indices, out, flush, *, plain_iters=3,
               library=True):
    """One kept ``csr_sum`` launch: the same inputs twice more through the
    kernel (the same bits as the main path's output, or the run fails),
    then timed by events and by profiler (cold L2), beside its bound, the
    plain version (``ref.csr_sum``), the word-for-word route of the JAX
    package (``index_select`` into [nnz, D], then ``index_add_`` by row,
    where it fits the card) and ``torch.sparse.mm`` of the [R, N] CSR of
    ones (held within 1e-4 x max |out|)."""
    kernel = functools.partial(segk.csr_sum, x, indptr, indices)
    for _ in range(2):
        if not same_bits(kernel(), out):
            fail(f"two csr_sum launches on the same inputs ({tuple(x.shape)}"
                 f", {indptr.shape[0] - 1} rows) differ")
    n_rows, nnz, dim = indptr.shape[0] - 1, indices.numel(), x.shape[1]
    row = {"x": list(x.shape), "rows": n_rows, "nnz": nnz,
           "max_segment": int((indptr[1:] - indptr[:-1]).max()),
           "repeat_bitwise": True,
           "ms": time_ms(kernel, 20, flush),
           "kernel_ms": kernel_ms(kernel, "csr_sum_kernel", 20, flush),
           "host_ms": host_ms(kernel, 20),
           **csr_bound(x, indptr, indices),
           "plain_ms": time_ms(functools.partial(ref.csr_sum, x, indptr,
                                                 indices), plain_iters,
                               flush)}
    free = torch.cuda.mem_get_info(x.device)[0]
    if nnz * (dim * 4 + 8) * 1.2 < free:
        seg_rows = torch.repeat_interleave(
            torch.arange(n_rows, device=x.device), indptr[1:] - indptr[:-1])

        def gather_scatter():
            return torch.zeros(n_rows, dim, device=x.device).index_add_(
                0, seg_rows, x.index_select(0, indices))
        row["gather_scatter_ms"] = time_ms(gather_scatter, 3, flush)
        del seg_rows
    else:
        row["gather_scatter_ms"] = None
        row["gather_scatter_note"] = (f"not measured: its [{nnz}, {dim}] "
                                      f"messages do not fit beside the "
                                      f"graph ({free} B free)")
    if library:
        adj = torch.sparse_csr_tensor(
            indptr, indices.long(), torch.ones(nnz, device=x.device),
            size=(n_rows, x.shape[0]))
        lib = functools.partial(torch.sparse.mm, adj, x)
        diff = float((lib() - out).abs().max())
        if diff > 1e-4 * max(float(out.abs().max()), 1.0):
            fail(f"torch.sparse.mm and csr_sum disagree by {diff}")
        row["library_ms"] = time_ms(lib, 20, flush)
        row["library_max_abs_diff"] = diff
        del adj
    else:
        row["library_ms"] = None
    return row


def run_gnn_cell(tag, shape, device, log, seed=S_SEED, smoke=False):
    """One GNN cell at published width (the docstring's phase S says what
    it runs and holds; ``smoke``: SMOKE's at ``registry.reduce_cell``'s
    size, for a rehearsal on the CPU), its host graph (or batches) built
    once; returns its metrics."""
    cuda = device.type == "cuda"
    cell = registry.cell_by_name(shape, "gnn")
    if smoke:
        cell = registry.reduce_cell(cell)
    cfg = gnn.cell_config(graphsage_reddit.SMOKE if smoke
                          else graphsage_reddit.CONFIG, cell)
    d = cell.dims
    rng = np.random.default_rng(seed)
    info = {}
    t0 = time.perf_counter()
    if cell.kind == "gnn_molecule":
        host = [synthetic.molecule_batch(rng, d["n_graphs"], d["n_nodes"],
                                         d["n_edges"], d["d_feat"],
                                         d["n_classes"])
                for _ in range(S_STEPS + 2)]
    else:
        host = synthetic.random_graph(rng, d["n_nodes"], d["n_edges"],
                                      d["d_feat"], d["n_classes"])
    info["graph_host_s"] = time.perf_counter() - t0
    print(f"[{tag}] {cell.name}: host graph in {info['graph_host_s']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    if cell.kind == "gnn_full":
        batches = [gnn.gnn_batch(host, cell.kind, device)] * (S_STEPS + 2)
        rows = d["n_nodes"]
    elif cell.kind == "gnn_molecule":
        batches = [gnn.gnn_batch(h, cell.kind, device) for h in host]
        rows = d["n_graphs"]
    else:
        csr = graph_sampler.CSRGraph(host["feats"].shape[0], host["edges"])
        info["csr_host_s"] = time.perf_counter() - t0
        batches, sample_s, upload_s = [], [], []
        for _ in range(S_STEPS + 2):
            t1 = time.perf_counter()
            seeds = rng.integers(0, host["feats"].shape[0], d["batch_nodes"])
            blk = graph_sampler.sample_block(rng, csr, host["feats"],
                                             host["labels"], seeds,
                                             tuple(d["fanouts"]))
            t2 = time.perf_counter()
            batches.append(gnn.gnn_batch(blk, cell.kind, device))
            if cuda:
                torch.cuda.synchronize()
            sample_s.append(t2 - t1)
            upload_s.append(time.perf_counter() - t2)
        info.update(sample_host_s=sample_s, upload_s=upload_s,
                    block_bytes=sum(v.nbytes for v in blk.values()))
        del csr, blk
        rows = d["batch_nodes"]
    if cuda:
        torch.cuda.synchronize()
    if cell.kind != "gnn_minibatch":
        info["upload_and_csr_s"] = time.perf_counter() - t0
    del host
    print(f"[{tag}] batches on the card: " + json.dumps(info), flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    regime = gnn.REGIMES[cell.kind]
    params = gnn.sage_init(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    ocfg = train_opt.OptConfig()
    fn = train_step.make_train_step(train_step.gnn_loss_fn(cfg, regime),
                                    ocfg)
    if cell.kind != "gnn_minibatch":
        with torch.no_grad(), log.plain():
            plain_loss = float(gnn.gnn_loss(params, cfg, batches[0],
                                            regime)[0])
    state = train_opt.init_opt_state(params, ocfg)

    def after(i, p, s, m):
        log.check_pending()

    p, s, st, _, host0, m0 = timed_steps(fn, params, state, 0, batches[:1],
                                         after)
    del params, state
    if cell.kind != "gnn_minibatch":
        info["first_loss"] = float(m0[0]["loss"])
        info["first_loss_plain"] = plain_loss
        if not abs(info["first_loss"] - plain_loss) <= S_LOSS_TOL:
            fail(f"[{tag}] the first step's loss {info['first_loss']} is not "
                 f"within {S_LOSS_TOL} of the plain version's {plain_loss}")
    p, s, st, ev, host_ms_, ms = timed_steps(fn, p, s, st,
                                             batches[1:S_STEPS + 1], after)
    summary = step_summary(rows, ev, host_ms_, ms)
    summary["warmup_host_ms"] = host0[0]
    prof = request_profiler(device)
    with prof:
        t0 = time.perf_counter()
        p, s, st, mt = fn(p, s, st, batches[S_STEPS + 1])
        if cuda:
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    log.check_pending()
    losses = [float(m["loss"]) for m in m0 + ms + [mt]]
    norms = [float(m["grad_norm"]) for m in m0 + ms + [mt]]
    if not np.isfinite(losses + norms).all():
        fail(f"[{tag}] losses {losses} or grad norms {norms} are not finite")
    busy_ms, busy_events = device_busy_ms(prof)
    peak = max_memory(device)
    if peak is not None and peak >= S_PEAK_BYTES:
        fail(f"[{tag}] peak memory {peak} B reaches the card's 80 GB")
    unit = {"gnn_full": "nodes", "gnn_minibatch": "seeds",
            "gnn_molecule": "graphs"}[cell.kind]
    summary[f"{unit}_per_s"] = summary.pop("examples_per_s")
    del p, s, batches
    return {"cell": cell.name, "regime": regime, "dims": d,
            "cfg": dataclasses.asdict(cfg), **info, "steps": summary,
            "loss_all_steps": losses, "grad_norm_all_steps": norms,
            "max_memory_allocated": peak,
            "traced_step": {
                "ms": traced_ms, "device_busy_ms": busy_ms,
                "device_events": busy_events,
                "busy_share": busy_ms / traced_ms,
                "kernels_ms": kernels_by_device_ms(prof, top=8)}}


def run_phase_s(device, flush):
    """S.1-S.4 one after another, each cell's launches counted from 0 just
    before it and read just after; S.1's and S.2's kept launches timed
    after their counts are read (their repeat launches and timings count
    nowhere).  Returns (metrics, the ``csr_sum`` row of the kernels
    line)."""
    out, launched, timings = {}, {}, []
    max_err = max_rel = 0.0
    bitwise = checked = 0
    for tag, shape in (("S.1", "full_graph_sm"), ("S.2", "ogb_products"),
                       ("S.3", "minibatch_lg"), ("S.4", "molecule")):
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches, segk.launches,
             segk.paths)
        t0 = time.perf_counter()
        with CsrLog() as log:
            m = run_gnn_cell(tag, shape, device, log)
        counts = {**kernel_counts(), **segk.launches}
        m.update(launches=counts, paths=dict(segk.paths),
                 seconds=time.perf_counter() - t0)
        want = 0 if shape == "minibatch_lg" else 3 * (S_STEPS + 2)
        if counts["csr_sum"] != want or log.checked != want:
            fail(f"[{tag}] csr_sum launched {counts['csr_sum']} times and "
                 f"{log.checked} were checked; {want} expected "
                 f"(3 a step)")
        if any(v for k, v in counts.items() if k != "csr_sum"):
            fail(f"[{tag}] launched another kernel: {counts}")
        launched[tag] = counts["csr_sum"]
        max_err, max_rel = max(max_err, log.max_err), max(max_rel,
                                                          log.max_rel)
        bitwise, checked = bitwise + log.bitwise, checked + log.checked
        m["csr_sum_bitwise_plain"] = f"{log.bitwise}/{log.checked}"
        print(f"[{tag}] " + json.dumps(m), flush=True)
        out[tag] = m
        if tag in ("S.1", "S.2"):
            gc.collect()
            torch.cuda.empty_cache()
            for (dim, _), (x, indptr, indices, o) in log.kept.items():
                row = csr_timing(x, indptr, indices, o, flush,
                                 plain_iters=3 if tag == "S.2" else 10)
                row["cell"] = tag
                print(f"[{tag}] csr_sum timing: " + json.dumps(row),
                      flush=True)
                timings.append(row)
        del log
    main = next(r for r in timings if r["cell"] == "S.2"
                and r["x"][1] == 100)
    row = {"name": "csr_sum", "route": "cuda", "source": SOURCE["csr_sum"],
           "replaces": REPLACES["csr_sum"],
           "replaces_note": "no TPU kernel: the JAX package's neighbour "
                            "mean is plain jnp (take + segment_sum / deg, "
                            "src/repro/models/gnn.py:86-88, :132-133)",
           "launches": sum(launched.values()), "launches_by_cell": launched,
           "max_abs_err": max_err, "max_err_over_S": max_rel,
           "launches_bitwise_plain": f"{bitwise}/{checked}",
           **{k: main[k] for k in ("ms", "kernel_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
           "shape": "S.2 layer 1 forward", "shapes": timings}
    return out, row


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
    builds_n = start_n_builds()        # phase N's host tables
    counts, lanes_counts = dict(nl.launches), dict(nl.lanes_launches)
    print("launches on the main path: " + json.dumps(counts), flush=True)
    for k in ("probe_lines", "probe_smem"):
        if counts[k] == 0:
            fail(f"{k} was not launched on the main path")
    if counts["probe_lines"] != m_a["launches"] \
            or counts["probe_smem"] != m_b["launches"]:
        fail(f"kernel launches {counts} disagree with the engines' counts "
             f"A={m_a['launches']} B={m_b['launches']}")

    # N: the paper's T1 and F9 through the two baselines' kernels and the
    # batch probe, each launch held against its plain version as it runs
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    zero(nl.launches, nl.lanes_launches)
    t_n = time.perf_counter()
    state_n = drive_phase_n(device, eng_a, builds_n)
    n_counts = dict(nl.launches)
    print("[N] launches: " + json.dumps(n_counts), flush=True)
    for k in ("probe_linear", "probe_sequential", "probe_lines"):
        if n_counts[k] == 0:
            fail(f"{k} was not launched in phase N")
    m_n, n_rows = time_phase_n(state_n, flush)
    print("[N] " + json.dumps(m_n), flush=True)
    for row in n_rows:
        row["launches"] = n_counts[row["name"]]
    print(f"[N] took {time.perf_counter() - t_n:.1f} s", flush=True)
    del state_n
    gc.collect()
    torch.cuda.empty_cache()

    # O: the consistency protocol's fleet, its data plane on the card
    print(f"reduced: phase O keys {CONFIG.n_items}->{O_KEYS}, embedding rows "
          f"{CONFIG.n_items}->{O_EMB_ROWS}: each ClusterSim builds its own "
          f"engine, and the host builder took 60.3 s at 4M keys")
    zero(nl.launches, nl.lanes_launches)
    t_o = time.perf_counter()
    with LaunchLog() as log_o:
        m_o = run_phase_o(device, log_o)
    o_counts = dict(nl.launches)
    m_o["launches"] = o_counts
    m_o["seconds"] = time.perf_counter() - t_o
    print("[O] " + json.dumps(m_o), flush=True)
    if sum(o_counts[k] for k in ("probe_lines", "probe_smem")) == 0:
        fail("no probe kernel was launched on phase O's fleet")
    if o_counts["probe_linear"] or o_counts["probe_sequential"]:
        fail(f"phase O launched a baseline kernel: {o_counts}")
    gc.collect()
    torch.cuda.empty_cache()

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

    kernels = []
    for name in ("probe_lines", "probe_smem"):
        row = measure(name, log.last[name], (eng_a, eng_b), log, flush)
        row["launches"] = counts[name] + n_counts[name] + o_counts[name] \
            + c_counts[name] + i_counts[name]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 log_o.max_err.get(name, 0),
                                 log_c.max_err.get(name, 0),
                                 log_i.max_err.get(name, 0))
        kernels.append(row)
    kernels.extend(n_rows)
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

    # G, H and P reach none of the four kernels: the two-tower tables (30.8
    # GB, also held by the bag logs' last launches) go first; P.1 ranks
    # retrieval_cand on G's DIN, P.2 on H's BST; DIN's tables (7.2 GB) go
    # before BST draws its 12.8 GB.
    del two_tower, bag_log, bag_log_f
    for name, p_name, cfg in (("G", "P.1", din.CONFIG),
                              ("H", "P.2", bst.CONFIG)):
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches)
        seq_model = run_phase_seq(name, cfg, device)
        launched = {**nl.launches, **fm.launches, **bagk.launches}
        print(f"[{name}] launches: " + json.dumps(launched), flush=True)
        if any(launched.values()):
            fail(f"{cfg.name} serving launched a kernel: {launched}")
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches)
        t_p = time.perf_counter()
        m_p = run_phase_p(p_name, seq_model)
        m_p["launches"] = kernel_counts()
        m_p["seconds"] = time.perf_counter() - t_p
        print(f"[{p_name}] " + json.dumps(m_p), flush=True)
        if any(m_p["launches"].values()):
            fail(f"{cfg.name}'s retrieval_cand launched a kernel: "
                 f"{m_p['launches']}")
        del seq_model

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
    steps_m = len(m_m["dense"]["loss_all_steps"]) \
        + m_m["dense"]["steps"]["resume"]["steps"]
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

    # Q: the load-test launcher over a host store; no device work
    zero(nl.launches, fm.launches, bagk.launches)
    m_q = run_phase_q()
    m_q["launches"] = kernel_counts()
    print("[Q] " + json.dumps(m_q), flush=True)
    if any(m_q["launches"].values()):
        fail(f"phase Q launched a kernel: {m_q['launches']}")

    # R: the serving fabric in torch-free child interpreters; no device work
    print(f"reduced: phase R rows {CONFIG.n_items}->{R1['rows']} (the "
          f"fabric's builder writes every shard's snapshot and each replica "
          f"restores it at boot; the build stays near 15 s)")
    zero(nl.launches, fm.launches, bagk.launches)
    m_r = run_phase_r()
    m_r["launches"] = kernel_counts()
    print("[R] " + json.dumps(m_r), flush=True)
    if any(m_r["launches"].values()):
        fail(f"phase R launched a kernel: {m_r['launches']}")

    # S: GraphSAGE trained in its three regimes, the neighbour mean on the
    # csr_sum kernel forward and backward; no other kernel
    m_s, csr_row = run_phase_s(device, flush)
    kernels.append(csr_row)
    print("[S] " + json.dumps({tag: {
        "step_event_ms_median": m["steps"]["event_ms_median"],
        "step_host_ms_median": m["steps"]["host_ms_median"],
        "busy_share": m["traced_step"]["busy_share"],
        "max_memory_allocated": m["max_memory_allocated"],
        "launches": m["launches"]["csr_sum"]} for tag, m in m_s.items()}),
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
