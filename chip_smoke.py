#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batch query on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the kernels (``src/repro_torch/csrc/probe.cu``, ``fused_fm.cu``,
``embedding_bag.cu`` and ``segment_sum.cu``) with nvcc, one per library,
all started together, then runs twenty-four phases.  Two send batch queries
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
  leave their line (host trace); then, a line a T1 size, linear
  probing's time over NeighborHash's.  F9: NeighborHash at 2^14, 2^18 and
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
  2^18 scalar keys (2^20 before phase V) and 200k 1 KB rows, each
  rollout a delta generation of
  64 keys: 300 batch queries of 4096 zipf keys over both tables in 60
  s of sim time (cut from 1000 in 200 s to keep the script inside its
  time limit), under ``paper``, under ``naming``, and under ``paper``
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
  (both layers' forward, each dividing by deg in the launch and keeping
  its hottest sources' rows in L2 by reading the rest evict-first, and
  layer 2's backward over the transposed CSR; the features need no
  gradient);
  S.3's dense masked means reach no kernel.  Every launch is held
  against ``ref.csr_sum`` (then ``/ deg``) within min(2 n 2^-24, 1e-4) S
  + 1e-30 on every row (S.2: 65,536 fixed rows and the longest segment)
  and counted where bitwise, the first step's loss within 1e-5 of the plain
  version's (S.1, S.2, S.4), every loss and ``grad_norm`` finite, the
  peak under 80 GB; each cell's launch count is 3 a step and no other
  kernel launches.  The traced step's busy share takes the ``csr_sum``
  launches' time from CUDA events around each, not from the trace, which
  loses some of them (it counts those it holds).  S.1's and S.2's last
  launch of each CSR and width is launched twice more (the same bits),
  then timed; a ``csr_sum design`` line gives the card's L2 (the hot
  rows' budget) and, a launch, its hot rows and their share
  of the terms, its kernel ms with and without the marks (the same bits)
  and over uniform sources (the control: what plain LRU kept), a
  forward's ms with its ``/ deg`` as a second pass, beside its bound and
  floors.

* **T** — the sharded batch query (``core/distributed.py``) over
  ``torch.distributed``, after S, every process group destroyed before the
  next sub-phase.  Its host tables (phase A's 4M keys in 1 and in 4
  NeighborHash shards, ``build_sharded``) are built by two spawned
  processes started once phase N's tables are built.  **T.1**: NCCL, world 1, in
  this process: ``make_distributed_lookup`` under ``replicated`` and
  ``a2a``, 64 batches of 4096 keys with phase A's hit mix each; every
  answer bitwise ``lookup_host_batch``'s and every probe launch its plain
  version's, the last batch also the single-table ``ops.neighbor_lookup``'s,
  a2a dropping nothing.  **T.2**: gloo, four rank processes (spawned) on
  the one card, one shard each (NCCL refuses two ranks on one device, so
  every collective is staged through the host): ``replicated``, ``a2a``
  at capacity factor 2.0 and at 0.5 (which drops); every kept answer
  bitwise the host tables', every dropped one not found with a zero
  payload, the summed ``n_dropped`` a numpy recount of the overflow,
  replicated equal to a2a at 2.0; per rank the probe's ms by CUDA events
  beside the exchange's by the host clock.  **T.3**: two-tower's user tower
  at published width (``configs/two_tower_retrieval.CONFIG``, 30.8 GB of
  tables drawn once here and shared with four gloo ranks by IPC handle,
  each rank serving views of its row blocks, ``convert.two_tower_row_blocks``)
  through ``serve_step.recsys_score_fn`` under ``a2a`` and ``psum16``, D's
  traffic (64 requests of 512 rows after a warm-up, one more traced for its
  host split); held to the world-1 ``xla`` tower on the same weights and
  requests (the plain bag) within 1e-5 (a2a, with the routing's drops at
  the reference's capacity factor 1.5 applied to it) and 2e-2 (psum16,
  whose history means are held within the bf16 bound (S + 1) 2^-8 sum_s
  |partial_s|), norms 1 +- 1e-5, every ``embedding_bag`` launch against
  its plain version, 64 launches a rank under psum16 and none under a2a,
  the card's peak across all processes under 80 GB.  A rank that fails or
  passes ``T_TIMEOUT_S`` fails the run.

* **U** — LM serving, after T, through ``serve_step.lm_prefill_fn`` and
  ``lm_decode_fn`` with random weights (``lm.lm_init``, seed 0) and bf16
  products accumulating in fp32.  **U.1**: qwen3-14b whole
  (``configs/qwen3_14b.CONFIG``, 40 layers, 29.5 GB): ``prefill_32k`` at
  batch 1 (one warm-up, 2 timed requests of random tokens), ``decode_32k``
  at batch 8 (4 if the peak passes ``U_DECODE_PEAK``): the serve
  launcher's request (``launch_serve.lm_request``: its caches, 42.9 GB,
  drawn on the card), then one warm-up and 16 timed chained steps, one
  more traced; ``long_500k`` is not run (85.9 GB of cache).  **U.2**:
  deepseek-v3-671b at published width cut to 4 layers (3 dense, 1 MoE of
  256 experts, the MTP block; 31.6 GB): ``prefill_32k`` at 1 (the warm-up
  through ``lm_backbone`` with the MoE layer tapped), ``decode_32k`` at 128,
  ``long_500k`` at 1.  Each holds: every logit finite; 8 decode steps
  after a 512-token prefill whose caches come from the layers'
  ``return_cache`` (``lm.lm_prefill``) against the longer prefills' last
  logits within ``U_AGREE_TOL`` of max |logit| (U.2 at a capacity factor
  of E / k, so that no slot drops); the same config cut to 2 dense layers
  in float32 against a plain float64 recompute on the card (512 tokens and
  4 decode steps) within ``U_F64_TOL``; U.2's MoE: its dropped share
  equal to a numpy recount of ``route_by_owner`` from the card's own
  top-k experts, and 256 fixed tokens within ``U_MOE_TOL`` (normwise) of a
  float64 recompute of their kept slots; the peak under 80 GB.  **U.3**:
  the five SMOKE configs on the card and on the CPU from the same
  parameters and request (``u3_compare``): prefill logits, 4 decode
  steps' logits and the caches, within 1e-5 in float32 and ``U3_BF16_TOL``
  in bf16.  It prints prefill ms a request (events and host) and
  tokens/s, decode ms a step and tokens/s, peaks, and the busy share and
  top kernels of one traced decode step.  U launches none of the
  kernels.
* **V** — LM training on the card, the ``train_4k`` cell's sequence of
  4,096 one a step (of its 256) at published width, through the train
  launcher's step (``make_train_step(lm_loss_fn(cfg), rule,
  in_place=True)``, the rule
  ``launch/cells.opt_cfg``'s for the published depth): **V.1** qwen3-14b
  cut to the most layers whose step ``launch/train.lm_train_bytes`` puts
  under 76 GB (Adafactor); **V.2** deepseek-v3-671b's 3 dense layers and
  its MTP block (MLA's backward, ``_mtp_loss``); **V.3** qwen3-moe's
  first 3 MoE layers (128 experts, top 8), each layer's dropped share
  equal to a numpy recount and 256 tokens against float64
  (``moe_check``), the step's ``moe_dropped`` their sum.  Each: a
  warm-up, 4 steps timed (events and host clock), one traced (busy
  share, kernels by kind and the top ones), one in its two halves;
  every loss and ``grad_norm`` finite, the peak under 80 GB, the chunked
  CE against one projection of the same hidden states within 1e-5.
  V.1's and V.2's width at 2 dense layers in float32 (1,024 tokens):
  remat against none (the same loss, gradients within 1e-5 normwise),
  then against a plain float64 recompute differentiated on the card
  (``lm_loss64``: the loss within 1e-5, each gradient leaf within
  ``V_F64_GRAD_TOL`` normwise).  **V.4**: the five SMOKE configs, a step
  and a step of two microbatches, on the card and on the CPU from the
  same parameters and batch (``v4_compare``), within 1e-5 in float32 and
  ``V4_BF16_TOL`` in bf16.  V launches none of the kernels.
* **W** — the cell builder, the dry-run and the H100 roofline.  **W.1**:
  ``python -m repro_torch.launch.dryrun --all`` (every (arch x cell) of
  the registry at published width on the ``meta`` device, the layer fit
  checked), ``deepfm/train_batch/sparse_emb``,
  ``qwen3-14b/train_4k/accum2`` and the cut cells W.2 and W.3 read
  (``w_cut_cells``), in a child interpreter started right after the
  kernels' build (nice 10, no card visible: ``start_w1``) and joined
  here; a line a cell (FLOPs by dtype, bytes, argument and peak GB,
  whether it fits 80 GB, the bound and its term, MODEL over counted
  FLOPs); W fails unless every record is ``ok``.  **W.2**: five bundles
  of ``launch/cells.build_cell`` through ``materialize_bundle`` on the
  card, at published width: DeepFM ``serve_p99`` (``fused_fm``) and
  ``train_batch`` (and ``fused_fm_backward``), two-tower ``serve_p99``
  (``embedding_bag``), GraphSAGE ``full_graph_sm`` (``csr_sum``), and
  qwen3-14b ``decode_32k`` at U.1's batch 8; each held to
  ``test_arch_smoke``'s checks, every kernel launch of its checked run
  against its plain version, three runs timed by events, its peak and
  time beside the dry-run's peak and bound.  **W.3**: V.1-V.3's peaks
  beside the dry-run's and ``lm_train_bytes``' estimates.
* **X** — the sharded LM serving paths over ``torch.distributed``, after
  W.  **X.1**: NCCL at world 1 in this process: ``_flash_decode_body``
  (qwen3-14b's heads) and ``_mla_flash_body`` (deepseek-v3's) at one
  shard through their all-reduces, held to the one-device decode paths
  on the same float32 tensors within ``X1_F32_TOL`` of max, and
  ``_moe_body`` (deepseek-v3's MoE at ``X1_EXPERTS`` experts) through the
  NCCL ``all_to_all`` over the group of one, bitwise the local body.
  **X.2**: four gloo ranks on the card at ``make_mesh(model=4)``
  (``x_rank``), each drawing its share of the same weights
  (``lm.lm_init(..., mesh=)``): qwen3-14b cut to ``X_Q_LAYERS`` layers at
  ``decode_32k``'s 32,768 positions (8,192 a rank) and U.1's batch 8,
  the launcher's request 1, a warm-up, ``X_Q_STEPS`` timed chained steps
  and one traced for its collectives' host time; rank 0 then decodes the
  same tokens over the whole caches in one process on the card, every
  step's logits within ``U3_BF16_TOL`` of max |logit| of the ranks' (all
  four the same bits).  deepseek-v3-671b cut to 1 dense and 1 MoE layer
  (64 of the 256 experts a rank): a prefill of ``X_D_PROMPT`` tokens (the
  MoE's sequence split, 1,024 a rank) into caches split along the
  sequence, then ``X_D_STEPS`` decode steps.  X fails if any layer took
  the one-device path (``attention.DECODE_PATHS``, ``moe.EP_PATHS``).
  After the ranks exit, this process draws deepseek-v3 whole at the same
  seed (~28 GB, never beside the ranks) and holds each rank's MoE taps
  (prefill and decode) to the local ``_moe_body`` over the same tokens
  (the same capacity) within ``U_MOE_TOL`` normwise, the same dropped
  share, and the prefill taps through ``moe_check`` (a numpy recount of
  the drops, 256 tokens against float64).  It prints each rank's step
  and prefill times, the exchange's share of the traced step, its peak
  beside its weight and cache bytes, the card's peak across the
  processes, and the decode step's p50 at four ranks beside one
  process.  X launches none of the kernels.

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
indptr and the output, each moved once) and two floors of its design (a
row read from memory a term; the same with each hot row read once),
``ref.csr_sum``, the
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

import atexit
import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import gc
import hashlib
import io
import json
import math
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
from repro_torch.configs import (bst, deepfm, deepseek_v3_671b,  # noqa
                                 din, graphsage_reddit, qwen3_14b,
                                 qwen3_moe_235b, registry,
                                 two_tower_retrieval)
from repro_torch.configs.bili_feature_store import CONFIG, SMOKE  # noqa: E402
from repro_torch.core import cluster_sim as cs  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
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
from repro_torch.launch import cells as launch_cells  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch import materialize as launch_mat  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import realtime  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import embedding_service as es  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.obs import exporter  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
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
O_KEYS, O_EMB_ROWS = 1 << 18, 200_000   # 2^20 until phase V came
O_QUERIES, O_QPS = 300, 5      # 60 s of sim time, 3 versions
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
T_KEYS, T_SEED = 4_000_000, 2    # phase A's keys, seed and hit mix
T_BATCHES = 64                 # T.1, T.2: batches of BATCH_KEYS a run
T_WORLD = 4                    # T.2, T.3: gloo ranks on the one card
T2_RUNS = (("replicated", 2.0), ("a2a", 2.0), ("a2a", 0.5))  # 0.5 drops
T2_RUN_TAGS = tuple((f"{s}{cf}", s) for s, cf in T2_RUNS)
T3_IMPLS = ("a2a", "psum16")
T3_REQUESTS = D_REQUESTS       # D's traffic: 64 requests of D_ROWS
T3_PSUM_TOWER_TOL = 2e-2       # psum16's vectors: the JAX package's own
                               # psum16 tolerance (tests/test_perf_paths.py)
T_PEAK_BYTES = 80 * 10**9      # the card's 80 GB, across all processes
T_TIMEOUT_S = 300              # a set of ranks, and each gloo collective
T_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_t")
U_PREFILL_BATCH = 1            # U: prefill_32k's 32 sequences cut to 1
U_PREFILL_REQUESTS = 2         # timed, after one warm-up
U_DECODE_STEPS = 16            # timed decode steps, after one warm-up
U1_DECODE_BATCHES = (8, 4)     # U.1 decode_32k: 128 cut to 8, else 4
U_DECODE_PEAK = 76 * 10**9     # ... when batch 8's peak passes this
U2_LAYERS = 4                  # U.2: 3 dense layers, 1 MoE layer (+ MTP)
U_AGREE_PROMPT = 512           # decode after a prefill of this many tokens
U_AGREE_STEPS = 8
U_AGREE_TOL = 0.1              # bf16, of max |logit|: 2.3x the largest
                               # seen (4.4e-2, U.2's MLA; PERF.md)
U_F64_STEPS = 4
U_F64_TOL = 1e-4               # float32 against float64, of max |logit|
                               # (seen: 6.0e-6)
U_MOE_CHECK_TOKENS = 256
U_MOE_TOL = 2.0 ** -5          # bf16 MoE output, normwise, against float64
                               # (seen: 4.9e-3)
U3_F32_TOL = 1e-5              # SMOKE on the card against the CPU
U3_BF16_TOL = 3e-2             # the CPU parity's (seen: 5.9e-3)
U_PEAK_BYTES = 80 * 10**9      # the card's 80 GB
V_SEQ = 4096                   # V: train_4k's sequence, one a step (of 256)
V_STEPS = 4                    # timed steps after a warm-up, one traced
V1_PEAK_TARGET = 76 * 10**9    # V.1: the most layers whose estimate fits
V2_LAYERS = 3                  # V.2: deepseek-v3's 3 dense layers (+ MTP)
V3_LAYERS = 3                  # V.3: qwen3-moe's first 3 MoE layers
V_CHECK_SEQ = 1024             # the float64 and remat checks' sequence
V_CHECK_LAYERS = 2
V_F64_LOSS_TOL = 1e-5          # float32 loss against float64, relative
V_F64_GRAD_TOL = 1e-4          # each gradient leaf, normwise
V_XENT_TOL = 1e-5              # the chunked CE against one projection
V_REMAT_TOL = 1e-5             # gradients with and without remat, normwise
V4_F32_TOL = 1e-5              # SMOKE steps, card against CPU, of max |x|
V4_BF16_TOL = U3_BF16_TOL      # ... in bf16: an updated bf16 parameter may
                               # round one ulp (2^-8 of it) the other way,
                               # a bf16 gradient differ by a few ulps (seen:
                               # 1.6% of the largest |g|, as sqrt(v))
V4_ADAM_SENSITIVE = 1e-6       # sqrt(v-hat) below this, or a gradient whose
                               # sign the two devices' differ on: Adam's
                               # first step is a sign; held to lr there
W_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_dryrun")
W_VARIANTS = (("deepfm", "train_batch", "sparse_emb"),
              ("qwen3-14b", "train_4k", "accum2"))
W2_CELLS = (("deepfm", "serve_p99"), ("deepfm", "train_batch"),
            ("two-tower-retrieval", "serve_p99"),
            ("graphsage-reddit", "full_graph_sm"))
W2_DECODE_BATCH = U1_DECODE_BATCHES[0]   # U.1's cut of decode_32k's 128
W_RUNS = 3                     # W.2: timed runs after the checked one
X_SEED = 37
X1_BATCH, X1_SEQ = 8, 4096     # X.1: the flash bodies' batch and positions
X1_TOKENS, X1_EXPERTS = 512, 16  # X.1: deepseek-v3's MoE at 16 experts
X1_F32_TOL = 1e-5              # float32 body against the one-device path
X_WORLD = 4                    # X.2: gloo ranks on the one card, model 4
X_Q_LAYERS = 4                 # X.2 qwen3-14b: 4 of its 40 layers
X_Q_BATCH = U1_DECODE_BATCHES[0]  # decode_32k's 128 sequences cut to U.1's
X_Q_STEPS = 8                  # timed decode steps after one warm-up
X_D_PROMPT = 4096              # X.2 deepseek-v3: the prefill's tokens
X_D_STEPS = 4                  # its decode steps after the prefill
X_TIMEOUT_S = 600              # the ranks, and each gloo collective
X_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_x")
W_TIMEOUT_S = 1000             # the dry-run child, from the script's start
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
    by = {(r["variant"], r["keys"]): r for r in t1}
    ratios = {n: {"linear_over_neighborhash_kernel_ms":
                  by["linear", n]["kernel_ms"]
                  / by["neighborhash", n]["kernel_ms"]
                  if by["linear", n]["kernel_ms"]
                  and by["neighborhash", n]["kernel_ms"] else None,
                  "linear_over_neighborhash_ms": by["linear", n]["ms"]
                  / by["neighborhash", n]["ms"]}
              for n in N_T1_SIZES}
    print("[N] T1 NeighborHash against linear probing: " + json.dumps(
        ratios), flush=True)
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
    return {"t1": t1, "t1_linear_over_neighborhash": ratios,
            "t1_past_l2_beside": beside, "f9": f9,
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


def device_busy_ms(prof, keep=lambda e: True) -> tuple[float, int]:
    """(ms, events): the union of the card's kernel, copy and memset
    intervals in a profiler trace (those ``keep`` keeps)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and keep(e))
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


def two_tower_model(device, cfg=two_tower_retrieval.CONFIG, tag="D"):
    """The two-tower model of phases D, F and T.3 (by default at full
    published width), random weights from seed 0."""
    t0 = time.perf_counter()
    model = rec.recsys_init(cfg, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {model.param_bytes()} parameter bytes on the "
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
    S their magnitudes' sum: two orders' bound, as for the bag gradient;
    the forward's division by deg in the same call, so both sides divided),
    on every row, or on ``S_CHECK_ROWS`` fixed rows (and the longest
    segment's) where a launch has more.  Keeps the last call of each CSR
    and width under ``kept`` (inputs and output) for the repeat check and
    the timings."""

    def __init__(self):
        super().__init__("csr_sum", ref.csr_sum, 0.0, 0.0)
        self.kept = {}
        self.bitwise = 0          # launches equal to the plain version
        self.max_rel = 0.0        # max |err| / (S + 1e-30)
        self.events = None        # a list: each call's CUDA events go there

    def _record(self, *args, **kw):
        if self.events is None:
            return super()._record(*args, **kw)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        out = super()._record(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def check(self, args, kw, out) -> None:
        x, indptr, indices, deg, marked = (tuple(args) + (None, False))[:5]
        self.kept[(x.shape[1], indptr.data_ptr())] = (
            x.detach(), indptr, indices, deg, marked, out.detach())
        n_rows = indptr.shape[0] - 1
        if n_rows <= S_CHECK_ROWS:
            rows = None
            sub = (indptr, indices, deg)
        else:
            g = torch.Generator(device=x.device).manual_seed(S_SEED)
            pick = torch.randperm(n_rows, generator=g,
                                  device=x.device)[:S_CHECK_ROWS]
            longest = torch.argmax(indptr[1:] - indptr[:-1])[None]
            rows = torch.unique(torch.cat([pick, longest]))
            sub = (*sub_csr(indptr, indices, rows),
                   None if deg is None else deg[rows])
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
    [R, D] fp32 written once, against its adds (one a term and column).
    Beside it two floors of this design on this graph, whose sources are
    random: ``term_floor_ms`` reads a row from memory a term, and
    ``hot_floor_ms`` the same but each hot (marked) row once."""
    dim = x.shape[1]
    ids = segk.decode(indices)
    distinct = int(torch.unique(ids).numel()) if ids.numel() else 0
    hot_terms = int((indices < 0).sum())
    hot_rows = int(torch.unique(ids[indices < 0]).numel()) if hot_terms \
        else 0
    n_rows, nnz = indptr.shape[0] - 1, indices.numel()
    fixed = nnz * 4 + indptr.numel() * 8 + n_rows * dim * 4
    t_bytes = (distinct * dim * 4 + fixed) / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * dim / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "distinct_rows": distinct,
            "term_floor_ms": (nnz * dim * 4 + fixed) / HBM_BYTES_PER_S * 1e3,
            "hot_floor_ms": ((nnz - hot_terms + hot_rows) * dim * 4 + fixed)
            / HBM_BYTES_PER_S * 1e3,
            "hot_rows": hot_rows, "hot_term_share": hot_terms / max(nnz, 1)}


def csr_timing(x, indptr, indices, deg, marked, out, flush, *,
               plain_iters=3, library=True):
    """One kept ``csr_sum`` launch: the same inputs twice more through the
    kernel (the same bits as the main path's output, or the run fails),
    then timed by events and by profiler (cold L2), beside its bound and
    floors, the plain version (``ref.csr_sum``), the word-for-word route of
    the JAX package (``index_select`` into [nnz, D], then ``index_add_`` by
    row, where it fits the card) and ``torch.sparse.mm`` of the [R, N] CSR
    of ones (held within 1e-4 x max |out|).  The design's controls by
    profiler: the same launch with no row marked hot (the same bits), and
    the same segments over sources drawn uniformly at random, unmarked (how
    much of the term stream plain LRU keeps in L2 without the skew); by
    events, a forward's sum and then its ``/ deg`` as a second pass (the
    same bits)."""
    kernel = functools.partial(segk.csr_sum, x, indptr, indices, deg, marked)
    for _ in range(2):
        if not same_bits(kernel(), out):
            fail(f"two csr_sum launches on the same inputs ({tuple(x.shape)}"
                 f", {indptr.shape[0] - 1} rows) differ")
    n_rows, nnz, dim = indptr.shape[0] - 1, indices.numel(), x.shape[1]
    row = {"x": list(x.shape), "rows": n_rows, "nnz": nnz,
           "max_segment": int((indptr[1:] - indptr[:-1]).max()),
           "fused_deg": deg is not None, "repeat_bitwise": True,
           "ms": time_ms(kernel, 20, flush),
           "kernel_ms": kernel_ms(kernel, "csr_sum_kernel", 20, flush),
           "host_ms": host_ms(kernel, 20),
           **csr_bound(x, indptr, indices),
           "plain_ms": time_ms(functools.partial(ref.csr_sum, x, indptr,
                                                 indices, deg), plain_iters,
                               flush)}
    ids = segk.decode(indices)
    if marked:
        cold = functools.partial(segk.csr_sum, x, indptr, ids, deg)
        if not same_bits(cold(), out):
            fail("csr_sum with no row marked hot differs from the marked "
                 "launch")
        row["kernel_ms_hot_off"] = kernel_ms(cold, "csr_sum_kernel", 20,
                                             flush)
    else:
        row["kernel_ms_hot_off"] = row["kernel_ms"]
    if deg is not None:
        def unfused():
            return segk.csr_sum(x, indptr, indices, None, marked) / deg
        if not same_bits(unfused(), out):
            fail("csr_sum then / deg differs from the fused division")
        row["unfused_ms"] = time_ms(unfused, 20, flush)
    g = torch.Generator(device=x.device).manual_seed(S_SEED)
    uniform = torch.randint(0, x.shape[0], (nnz,), generator=g,
                            device=x.device, dtype=torch.int32)
    row["kernel_ms_uniform_sources"] = kernel_ms(
        functools.partial(segk.csr_sum, x, indptr, uniform, deg),
        "csr_sum_kernel", 20, flush)
    del uniform
    free = torch.cuda.mem_get_info(x.device)[0]
    if nnz * (dim * 4 + 8) * 1.2 < free:
        seg_rows = torch.repeat_interleave(
            torch.arange(n_rows, device=x.device), indptr[1:] - indptr[:-1])

        def gather_scatter():
            return torch.zeros(n_rows, dim, device=x.device).index_add_(
                0, seg_rows, x.index_select(0, ids))
        row["gather_scatter_ms"] = time_ms(gather_scatter, 3, flush)
        del seg_rows
    else:
        row["gather_scatter_ms"] = None
        row["gather_scatter_note"] = (f"not measured: its [{nnz}, {dim}] "
                                      f"messages do not fit beside the "
                                      f"graph ({free} B free)")
    if library:
        adj = torch.sparse_csr_tensor(
            indptr, ids.long(), torch.ones(nnz, device=x.device),
            size=(n_rows, x.shape[0]))
        lib = functools.partial(torch.sparse.mm, adj, x)
        want = out if deg is None else out * deg.reshape(n_rows, 1)
        diff = float((lib() - want).abs().max())
        if diff > 1e-4 * max(float(want.abs().max()), 1.0):
            fail(f"torch.sparse.mm and csr_sum disagree by {diff}")
        row["library_ms"] = time_ms(lib, 20, flush)
        row["library_max_abs_diff"] = diff
        row["library_note"] = ("the sum alone, without the division by "
                               "deg" if deg is not None else "the sum")
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
    log.events = [] if cuda else None
    with prof:
        t0 = time.perf_counter()
        p, s, st, mt = fn(p, s, st, batches[S_STEPS + 1])
        if cuda:
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    sums_ms = sum(a.elapsed_time(b) for a, b in log.events or [])
    log.events = None
    log.check_pending()
    losses = [float(m["loss"]) for m in m0 + ms + [mt]]
    norms = [float(m["grad_norm"]) for m in m0 + ms + [mt]]
    if not np.isfinite(losses + norms).all():
        fail(f"[{tag}] losses {losses} or grad norms {norms} are not finite")
    # the trace loses some of the csr_sum launches (an H100's held 1 to 3
    # of a step's 3): their time comes from events around each instead
    busy_ms, busy_events = device_busy_ms(
        prof, lambda e: "csr_sum_kernel" not in e.name)
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
                "ms": traced_ms, "device_busy_ms": busy_ms + sums_ms,
                "csr_sum_event_ms": sums_ms,
                "device_events": busy_events,
                "busy_share": (busy_ms + sums_ms) / traced_ms,
                "csr_sum_in_trace": sum(
                    1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "csr_sum_kernel" in e.name),
                "kernels_ms": kernels_by_device_ms(prof, top=8)}}


def run_phase_s(device, flush):
    """S.1-S.4 one after another, each cell's launches counted from 0 just
    before it and read just after; S.1's and S.2's kept launches timed
    after their counts are read (their repeat launches and timings count
    nowhere), then the design line.  Returns (metrics, the ``csr_sum`` row
    of the kernels line)."""
    out, launched, timings = {}, {}, []
    max_err = max_rel = 0.0
    bitwise = checked = 0
    for tag, shape in (("S.1", "full_graph_sm"), ("S.2", "ogb_products"),
                       ("S.3", "minibatch_lg"), ("S.4", "molecule")):
        gc.collect()
        torch.cuda.empty_cache()
        zero(nl.launches, fm.launches, bagk.launches, segk.launches,
             segk.paths, segk.hot_launches)
        t0 = time.perf_counter()
        with CsrLog() as log:
            m = run_gnn_cell(tag, shape, device, log)
        counts = {**kernel_counts(), **segk.launches}
        m.update(launches=counts, paths=dict(segk.paths),
                 hot_launches=segk.hot_launches["csr_sum"],
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
            for x, indptr, indices, deg, marked, o in log.kept.values():
                row = csr_timing(x, indptr, indices, deg, marked, o, flush,
                                 plain_iters=3 if tag == "S.2" else 10)
                row["cell"] = tag
                print(f"[{tag}] csr_sum timing: " + json.dumps(row),
                      flush=True)
                timings.append(row)
        del log
    print("csr_sum design: " + json.dumps({
        "l2_bytes": segk.l2_bytes(device),
        "launches": [{k: r.get(k) for k in (
            "cell", "x", "fused_deg", "hot_rows", "hot_term_share",
            "kernel_ms", "kernel_ms_hot_off", "kernel_ms_uniform_sources",
            "ms", "unfused_ms", "bound_ms", "term_floor_ms",
            "hot_floor_ms")} for r in timings]}), flush=True)
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


# ---------------------------------------------------------------------------
# phase T: the sharded batch query and two-tower's sharded user tower
# ---------------------------------------------------------------------------
def t_build(n_shards, n_keys):
    """Phase A's keys (``random_kv(n_keys, seed=T_SEED)``) in ``n_shards``
    NeighborHash shards (a job of ``start_t_builds``' pool) -> (the
    ``ShardedTables``, build seconds)."""
    keys, payloads = nh.random_kv(n_keys, seed=T_SEED)
    t0 = time.perf_counter()
    st = tdist.build_sharded(keys, payloads, n_shards)
    return st, time.perf_counter() - t0


def start_t_builds():
    """Starts T.1's one-shard and T.2's four-shard host builds in two
    processes (the host builder inserts one key at a time: 60-130 s at 4M
    keys); main() starts them once phase N's tables are built, so they run
    beside N's kernel timings and phase O.  Returns (the pool, {n_shards:
    future})."""
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    return pool, {s: pool.submit(t_build, s, T_KEYS) for s in (1, T_WORLD)}


def t_queries(keys, seed):
    """``T_BATCHES`` batches of ``BATCH_KEYS`` keys with phase A's hit mix:
    zipf-skewed over the keys, ``ABSENT`` of them absent."""
    rng = np.random.default_rng(seed)
    return np.stack([zipf_keys(rng, keys, BATCH_KEYS)
                     for _ in range(T_BATCHES)])


def t_rdv(name):
    """A fresh ``file://`` rendezvous under ``T_DIR``."""
    os.makedirs(T_DIR, exist_ok=True)
    path = os.path.join(T_DIR, f"rendezvous-{name}-{os.getpid()}")
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


class TSpans:
    """Per-batch time in the sharded lookup's layers, while the block runs:
    each rank-local probe by CUDA events (``distributed._probe``; the host
    clock in a rehearsal on the CPU) and each collective by the host clock
    (``COLLECTIVES``: with gloo, the copies to the host and back
    included).  ``take()`` returns (probe ms, exchange ms) since the last
    call."""

    COLLECTIVES = ("all_to_all", "all_gather", "all_reduce_sum",
                   "all_reduce_max")

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events, self.exchange_s, self.probe_s = [], 0.0, 0.0
        self.orig = {k: getattr(tdist, k)
                     for k in ("_probe",) + self.COLLECTIVES}

    def __enter__(self):
        tdist._probe = self._probe
        for k in self.COLLECTIVES:
            setattr(tdist, k, self._timed(self.orig[k]))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(tdist, k, fn)

    def _probe(self, *args):
        if not self.cuda:
            t0 = time.perf_counter()
            out = self.orig["_probe"](*args)
            self.probe_s += time.perf_counter() - t0
            return out
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = self.orig["_probe"](*args)
        e.record()
        self.events.append((s, e))
        return out

    def _timed(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.exchange_s += time.perf_counter() - t0
        return timed

    def take(self):
        if self.cuda:
            torch.cuda.synchronize()
        probe = sum(s.elapsed_time(e) for s, e in self.events) \
            + self.probe_s * 1e3
        out = (probe, self.exchange_s * 1e3)
        self.events, self.exchange_s, self.probe_s = [], 0.0, 0.0
        return out


def launched(counts) -> dict:
    """The kernels a count names with a launch."""
    return {str(k): v for k, v in counts.items() if v}


def t_answers(res):
    """(found, p_hi, p_lo[, n_dropped]) on the card -> host numpy."""
    return [r.view(torch.int32).cpu().numpy() if r.dtype == torch.uint32
            else r.cpu().numpy() for r in res]


def t_payload(p_hi, p_lo):
    return (p_hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | p_lo.view(np.uint32).astype(np.uint64)


def run_phase_t1(st, device, log):
    """T.1: NCCL world 1 in this process: ``make_distributed_lookup`` over
    one shard of phase A's keys, both schemes, T_BATCHES batches each;
    every answer bitwise the host table's and every probe launch its plain
    version's; a2a drops nothing."""
    keys = nh.random_kv(T_KEYS, seed=T_SEED)[0]
    host = st.host_table(0)
    qs = t_queries(keys, seed=11)
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=t_rdv("t1"),
        world_size=1, rank=0)
    out = {}
    try:
        route = tdist.exchange_route(None, device)
        for scheme in tdist.SCHEMES:
            fn = tdist.make_distributed_lookup(None, st, scheme=scheme,
                                               device=device)
            t_answers(fn(*hc.key_split_np(qs[0])))       # warm-up
            log.check_pending()
            zero(nl.launches, nl.lanes_launches)
            lat = []
            for b, q in enumerate(qs):
                qh, ql = hc.key_split_np(q)
                t0 = time.perf_counter()
                res = t_answers(fn(qh, ql))
                lat.append(time.perf_counter() - t0)
                log.check_pending()
                f, p = host.lookup_host_batch(q)
                if not (np.array_equal(res[0], f)
                        and np.array_equal(t_payload(res[1], res[2]), p)):
                    fail(f"[T.1] {scheme} batch {b} differs from "
                         f"lookup_host_batch")
                if scheme == "a2a" and res[3].sum():
                    fail(f"[T.1] a2a dropped {res[3].sum()} keys at world 1")
            counts = dict(nl.launches)
            if device.type == "cuda" and \
                    counts["probe_lines"] + counts["probe_smem"] != len(qs):
                fail(f"[T.1] {scheme}: {counts} probe launches for "
                     f"{len(qs)} batches")
            # the last batch through the single-table probe (not counted)
            want = ops.neighbor_lookup(
                *(st.arrays[k][0] for k in tdist.WORDS), qh, ql,
                max_probes=st.max_probes, home_capacity=st.capacity,
                device=device)
            if not all(np.array_equal(a, w.view(torch.int32).cpu().numpy())
                       for a, w in zip(res, want)):
                fail(f"[T.1] {scheme} differs from ops.neighbor_lookup")
            lat_ms = np.array(lat) * 1e3
            out[scheme] = {
                "exchange": route, "batches": len(qs),
                "batch_p50_ms": float(np.percentile(lat_ms, 50)),
                "batch_p99_ms": float(np.percentile(lat_ms, 99)),
                "launches": launched(counts),
                "lanes": launched(nl.lanes_launches)}
    finally:
        torch.distributed.destroy_process_group()
    return out


def t_rank(rank, subs, rdvs, world, device_type):
    """One rank, spawned: T.2, then T.3, each in its own process group over
    gloo on card 0 (the CPU in a rehearsal), destroyed before the next.
    Rank 0 writes its arrays under ``T_DIR``; every rank writes its metrics
    and the digests of its arrays."""
    t_start = time.perf_counter()
    device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    for sub in list(subs):
        payload = subs.pop(sub)          # T.3's: views of the parent's
        t0 = time.perf_counter()
        torch.distributed.init_process_group(
            "gloo", init_method=rdvs[sub], world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=T_TIMEOUT_S))
        try:
            arrays, metrics = T_RANKS[sub](rank, device, *payload)
        finally:
            torch.distributed.destroy_process_group()
        metrics["digests"] = {k: digest(v) for k, v in arrays.items()}
        metrics["seconds"] = time.perf_counter() - t0
        if sub == "T.2":
            metrics["start_seconds"] = t0 - t_start
        if rank == 0 or sub == "T.2":      # T.2's a2a answers are slices
            np.savez(os.path.join(T_DIR, f"{sub}-rank{rank}.npz"), **arrays)
        with open(os.path.join(T_DIR, f"{sub}-rank{rank}.json"), "w") as f:
            json.dump(metrics, f)
        del payload, arrays              # give the shared tables back
        gc.collect()


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def t_inputs(name, **arrays) -> str:
    """Arrays a rank reads, in a file under ``T_DIR``: a spawned process
    reads its arguments only once it has imported this script, so large
    ones passed by pickle would start the ranks one after another."""
    path = os.path.join(T_DIR, f"{name}-inputs.npz")
    np.savez(path, **arrays)
    return path


def t2_rank(rank, device, path):
    """T.2's rank: its shard line-packed once on the card, each run's
    batches (the whole batch under ``replicated``, its slice under
    ``a2a``) answered, every probe launch held against its plain
    version."""
    with np.load(path) as f:
        qs, meta = f["qs"], f["meta"]
        st = tdist.ShardedTables(
            n_shards=int(meta[0]), capacity=int(meta[1]),
            max_probes=int(meta[2]), arrays={k: f[k] for k in tdist.WORDS})
    n_loc = qs.shape[1] // T_WORLD
    arrays, metrics = {}, {"exchange": tdist.exchange_route(None, device)}
    with LaunchLog() as log, TSpans(device) as spans:
        for scheme, cf in T2_RUNS:
            tag = f"{scheme}{cf}"
            fn = tdist.make_distributed_lookup(
                None, st, scheme=scheme, capacity_factor=cf, device=device)
            local = qs if scheme == "replicated" else \
                qs[:, rank * n_loc:(rank + 1) * n_loc]
            t_answers(fn(*hc.key_split_np(local[0])))    # warm-up
            log.check_pending()
            spans.take()
            zero(nl.launches, nl.lanes_launches)
            lat, probe, exch, res = [], [], [], []
            for q in local:
                qh, ql = hc.key_split_np(q)
                t0 = time.perf_counter()
                res.append(t_answers(fn(qh, ql)))
                lat.append(time.perf_counter() - t0)
                log.check_pending()
                p, e = spans.take()
                probe.append(p)
                exch.append(e)
            for i, name in enumerate(("found", "p_hi", "p_lo", "n_dropped")
                                     [:len(res[0])]):
                arrays[f"{tag}_{name}"] = np.stack([r[i] for r in res])
            lat_ms = np.array(lat) * 1e3
            metrics[tag] = {
                "batch_p50_ms": float(np.percentile(lat_ms, 50)),
                "batch_p99_ms": float(np.percentile(lat_ms, 99)),
                "probe_ms_median": float(np.median(probe)),
                "exchange_ms_median": float(np.median(exch)),
                "launches": launched(nl.launches)}
    metrics["max_abs_err"] = log.max_err
    return arrays, metrics


def t3_rank(rank, device, params, cfg, path):
    """T.3's rank: its row blocks of the two-tower tables (views of the
    parent's, shared by IPC handle), the requests through
    ``recsys_score_fn`` under ``a2a`` and ``psum16``: a warm-up, the timed
    requests, one traced for the layers' split; every bag launch against
    its plain version, ``psum16``'s history means kept."""
    with np.load(path) as f:
        requests = [{k: f[f"{k}{i}"] for k in rec.TwoTower.inputs}
                    for i in range(int(f["n"]))]
    model = convert.two_tower_row_blocks(params, cfg, rank, T_WORLD)
    arrays, metrics = {}, {"exchange": tdist.exchange_route(None, device)}
    for impl in T3_IMPLS:
        step = serve_step.recsys_score_fn(cfg, model, lookup_impl=impl)
        with BagLog() as bag_log, Calls(es, "embed_bag_psum") as hists:
            step(requests[0]).cpu()
            bag_log.check_pending()
            hists.calls.clear()
            zero(nl.launches, fm.launches, bagk.launches)
            lat, vecs = [], []
            for req in requests:
                t0 = time.perf_counter()
                vecs.append(step(req).cpu().numpy())
                lat.append(time.perf_counter() - t0)
                bag_log.check_pending()
            counts = kernel_counts()
            arrays[f"{impl}_vecs"] = np.stack(vecs)
            if hists.calls:
                arrays[f"{impl}_hist"] = np.stack(
                    [h.cpu().numpy() for _, h in hists.calls])
        clock = LayerClock((
            (serve_step, "_upload", "upload"),
            (tdist, "all_to_all", "exchange"),
            (tdist, "all_reduce_sum", "exchange"),
            (ops, "embedding_bag", "bag"),
            (rec, "_mlp_apply", "mlp")))
        with clock:
            t0 = time.perf_counter()
            step(requests[0]).cpu()
            traced = time.perf_counter() - t0
        lat_ms = np.array(lat) * 1e3
        metrics[impl] = {
            "requests": len(requests),
            "request_p50_ms": float(np.percentile(lat_ms, 50)),
            "request_p99_ms": float(np.percentile(lat_ms, 99)),
            "launches": launched(counts), "bag_max_abs_err": bag_log.max_err,
            "bag_checked": bag_log.checked,
            "traced_request_ms": traced * 1e3,
            "traced_host_ms": {k: v * 1e3 for k, v in clock.seconds.items()}}
    return arrays, metrics


T_RANKS = {"T.2": t2_rank, "T.3": t3_rank}


def run_world(tag, target, args, world, timeout_s, device):
    """``world`` spawned processes of ``target(rank, *args)``; fails the
    run if one exits non-zero or the set passes ``timeout_s`` (every rank
    is then killed) -> the card's peak use across all processes
    (``torch.cuda.mem_get_info``, polled; None on the CPU)."""
    cuda = device.type == "cuda"
    total = torch.cuda.mem_get_info()[1] if cuda else 0
    low, stop = [total], threading.Event()

    def poll():
        while cuda and not stop.is_set():
            low[0] = min(low[0], torch.cuda.mem_get_info()[0])
            stop.wait(0.05)
    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    ctx = torch.multiprocessing.start_processes(
        target, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"[{tag}] ranks passed {timeout_s} s")
    except torch.multiprocessing.ProcessRaisedException as e:
        fail(f"[{tag}] a rank failed:\n{e}")
    except torch.multiprocessing.ProcessExitedException as e:
        fail(f"[{tag}] a rank exited with code {e.exit_code}")
    finally:
        stop.set()
        watcher.join()
    return total - low[0] if cuda else None


def spawn_ranks(subs, device):
    """``T_WORLD`` ranks in spawned processes, each running the
    sub-phases of ``subs`` ({name: payload}) in turn (``run_world``).
    Returns {name: each rank's (arrays, metrics)} (only rank 0 writes
    T.3's arrays; every rank the digests of its own) and the card's peak
    use across all processes."""
    rdvs = {sub: t_rdv(sub) for sub in subs}
    peak = run_world("T", t_rank, (subs, rdvs, T_WORLD, device.type),
                     T_WORLD, T_TIMEOUT_S, device)
    outs = {}
    for sub in subs:
        outs[sub] = []
        for r in range(T_WORLD):
            path = os.path.join(T_DIR, f"{sub}-rank{r}.npz")
            arrays = {}
            if os.path.exists(path):
                with np.load(path) as f:
                    arrays = dict(f)
            with open(os.path.join(T_DIR, f"{sub}-rank{r}.json")) as f:
                outs[sub].append((arrays, json.load(f)))
    return outs, peak


def same_digests(outs, names, what):
    """Every rank's digest of each of ``names`` equals rank 0's array."""
    for n in names:
        want = digest(outs[0][0][n])
        if any(mt["digests"][n] != want for _, mt in outs[1:]):
            fail(f"{what}: the ranks' {n} differ")


def t2_dropped(qs, cf):
    """The queries a2a drops at ``cf``: a numpy recount, per rank slice and
    destination, of the queries past its capacity in slice order."""
    hi, lo = hc.key_split_np(qs.reshape(-1))
    owner = (hc.hash64_np(hi, lo) % np.uint32(T_WORLD)).reshape(qs.shape)
    n_loc = qs.shape[1] // T_WORLD
    cap = tdist.a2a_capacity(n_loc, T_WORLD, cf)
    dropped = np.zeros(qs.shape, bool)
    for b in range(qs.shape[0]):
        for r in range(T_WORLD):
            o = owner[b, r * n_loc:(r + 1) * n_loc]
            for d in range(T_WORLD):
                dropped[b, r * n_loc + np.flatnonzero(o == d)[cap:]] = True
    return dropped


def check_t2(st, qs, outs):
    """T.2's answers: kept ones bitwise the host tables', dropped ones not
    found with zero payload, the summed n_dropped the numpy recount's,
    replicated equal to a2a at 2.0 (and dropping none), a2a at 0.5
    dropping some."""
    hi, lo = hc.key_split_np(qs.reshape(-1))
    owner = hc.hash64_np(hi, lo) % np.uint32(T_WORLD)
    want_f = np.zeros(qs.size, bool)
    want_p = np.zeros(qs.size, np.uint64)
    for s in range(T_WORLD):
        m = owner == s
        want_f[m], want_p[m] = st.host_table(s).lookup_host_batch(
            qs.reshape(-1)[m])
    want_f, want_p = want_f.reshape(qs.shape), want_p.reshape(qs.shape)
    got = {}
    for scheme, cf in T2_RUNS:
        tag = f"{scheme}{cf}"
        names = [f"{tag}_{n}" for n in ("found", "p_hi", "p_lo")]
        if scheme == "replicated":
            same_digests(outs, names, f"[T.2] {tag}")
            f, ph, pl = (outs[0][0][n] for n in names)
            dropped = np.zeros(qs.shape, bool)
        else:
            f, ph, pl = (np.concatenate([a[n] for a, _ in outs], axis=1)
                         for n in names)
            dropped = t2_dropped(qs, cf)
            n_drop = sum(int(a[f"{tag}_n_dropped"].sum()) for a, _ in outs)
            if n_drop != int(dropped.sum()):
                fail(f"[T.2] {tag}: n_dropped {n_drop}, the recount "
                     f"{int(dropped.sum())}")
        p = t_payload(ph, pl)
        if not (np.array_equal(f[~dropped], want_f[~dropped])
                and np.array_equal(p[~dropped], want_p[~dropped])):
            fail(f"[T.2] {tag}: a kept answer differs from the host tables")
        if f[dropped].any() or p[dropped].any():
            fail(f"[T.2] {tag}: a dropped query has an answer")
        got[tag] = (f, p, int(dropped.sum()))
    if got["a2a2.0"][2] or not (np.array_equal(got["a2a2.0"][0],
                                               got["replicated2.0"][0])
                                and np.array_equal(got["a2a2.0"][1],
                                                   got["replicated2.0"][1])):
        fail("[T.2] a2a at 2.0 differs from replicated or dropped keys")
    if not got["a2a0.5"][2]:
        fail("[T.2] a2a at 0.5 dropped nothing")
    return {"ranks": [{k: v for k, v in mt.items() if k != "digests"}
                      for _, mt in outs],
            "dropped": {tag: v[2] for tag, v in got.items()},
            "queries": int(qs.size)}


def t3_expected(model, req, device):
    """What ``a2a`` and ``psum16`` should give on one request, from the
    whole model on the card with the plain bag: the routing's drops (a
    numpy recount at the user tower's capacity factor) zero their rows;
    a2a's history mean divides by every valid id, dropped or not.  ->
    (a2a vectors, psum16 vectors, the plain history mean, the bf16 bound
    on psum16's history, rows with a dropped lookup, dropped lookups)."""
    cfg = model.cfg

    def kept(ids, vocab):
        flat = ids.reshape(-1)
        owner = np.maximum(flat, 0) // (vocab // T_WORLD)
        cap = tdist.a2a_capacity(flat.size, T_WORLD, 1.5)
        keep = np.ones(flat.size, bool)
        for d in range(T_WORLD):
            keep[np.flatnonzero(owner == d)[cap:]] = False
        return keep.reshape(ids.shape)

    uid, hist = req["user_id"], req["hist_items"]
    keep_u, keep_h = kept(uid, cfg.user_vocab), kept(hist, cfg.item_vocab)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    u = es.embed_lookup(model.user_table, t(uid)) * t(keep_u)[:, None]
    ids = t(hist)
    valid = (ids >= 0)
    rows = es.embed_lookup(model.item_table, ids) * \
        (valid & t(keep_h))[..., None]
    mean_a2a = rows.sum(1) / valid.sum(1, keepdim=True).clamp(min=1)
    mean = ref.embedding_bag(model.item_table, ids.to(torch.int32), None,
                             "mean")
    rows_per = cfg.item_vocab // T_WORLD
    mag = torch.zeros_like(mean)
    for s in range(T_WORLD):
        mine = (ids >= s * rows_per) & (ids < (s + 1) * rows_per)
        mag += ref.embedding_bag(model.item_table, torch.where(
            mine, ids, -1).to(torch.int32), None, "sum").abs()
    bound = (T_WORLD + 1) * 2.0 ** -8 * mag / \
        valid.sum(1, keepdim=True).clamp(min=1)
    dense = t(req["dense"])
    mlp = list(zip(model.user_mlp_w, model.user_mlp_b))
    tower = lambda h: rec._l2_normalise(rec._mlp_apply(
        mlp, torch.cat([u, h, dense], dim=-1)))
    touched = ~keep_u | ~(keep_h | (hist < 0)).all(axis=1)
    return (tower(mean_a2a), tower(mean), mean, bound, touched,
            int((~keep_u).sum() + (~keep_h & (hist >= 0)).sum()))


def t3_inputs(device, cfg):
    """T.3's model (whole tables, drawn once), D's traffic and what each
    request should give."""
    model = two_tower_model(device, cfg, tag="T.3")
    rng = np.random.default_rng(4)
    requests = [synthetic.recsys_batch(rng, cfg, D_ROWS)
                for _ in range(T3_REQUESTS)]
    requests = [{k: r[k] for k in model.inputs} for r in requests]
    with torch.inference_mode():
        expected = [t3_expected(model, r, device) for r in requests]
    return model, requests, expected


def check_t3(outs, expected, device):
    """T.3's vectors against the world-1 ``xla`` tower with a2a's drops
    applied (1e-5; psum16 2e-2 and its history means within the bf16
    bound), norms, every rank's vectors the same, the bag's launches."""
    m = {"ranks": [{k: v for k, v in mt.items() if k != "digests"}
                   for _, mt in outs]}
    for impl, tol in (("a2a", BAG_TOL), ("psum16", T3_PSUM_TOWER_TOL)):
        vecs = outs[0][0][f"{impl}_vecs"]
        same_digests(outs, [f"{impl}_vecs"], f"[T.3] {impl}")
        err = norm_err = hist_ratio = 0.0
        for i, e in enumerate(expected):
            want = (e[0] if impl == "a2a" else e[1]).cpu().numpy()
            err = max(err, float(np.abs(vecs[i] - want).max()))
            norm_err = max(norm_err, float(np.abs(
                np.linalg.norm(vecs[i], axis=-1) - 1).max()))
            if impl == "psum16":
                h = torch.from_numpy(outs[0][0]["psum16_hist"][i]).to(device)
                d = (h - e[2]).abs()
                if not bool((d <= e[3]).all()):
                    fail(f"[T.3] psum16 request {i}: the history mean is "
                         f"off the bf16 bound")
                hist_ratio = max(hist_ratio, float(
                    (d / e[3].clamp(min=1e-30)).max()))
        if not (err <= tol and norm_err <= BAG_TOL):
            fail(f"[T.3] {impl}: max abs err {err} (tolerance {tol}), norm "
                 f"err {norm_err}")
        launches = [mt[impl]["launches"].get("embedding_bag", 0)
                    for _, mt in outs]
        others = [k for _, mt in outs for k in mt[impl]["launches"]
                  if k != "embedding_bag"]
        if others:
            fail(f"[T.3] {impl} launched {others}")
        on_card = T3_REQUESTS if impl == "psum16" and device.type == "cuda" \
            else 0
        if launches != [on_card] * T_WORLD:
            fail(f"[T.3] {impl}: embedding_bag launches {launches}")
        m[impl] = {"max_abs_err": err, "max_norm_err": norm_err,
                   "embedding_bag_launches": launches}
        if impl == "psum16":
            m[impl]["hist_err_over_bound_max"] = hist_ratio
    m["rows_with_a_drop"] = int(sum(e[4].sum() for e in expected))
    m["dropped_lookups"] = sum(e[5] for e in expected)
    return m


def run_phase_t(device, builds, log, t3_cfg=two_tower_retrieval.CONFIG):
    """T.1 here, then T.2 and T.3 in four spawned ranks, each process group
    destroyed before the next; returns the metrics and the kernels'
    launches and max errors."""
    pool, futures = builds
    built = {s: f.result() for s, f in futures.items()}
    pool.shutdown()
    for s, (st, secs) in built.items():
        print(f"[T] built {T_KEYS} keys into {s} shard(s) of {st.capacity} "
              f"buckets (max_probes {st.max_probes}) in {secs:.1f} s",
              flush=True)
    shutil.rmtree(T_DIR, ignore_errors=True)
    st4 = built[T_WORLD][0]
    try:
        t0 = time.perf_counter()
        t1 = run_phase_t1(built.pop(1)[0], device, log)
        t1["seconds"] = time.perf_counter() - t0
        print("[T.1] " + json.dumps(t1), flush=True)
        t0 = time.perf_counter()
        qs = t_queries(nh.random_kv(T_KEYS, seed=T_SEED)[0], seed=12)
        model, requests, expected = t3_inputs(device, t3_cfg)
        params = convert.params_of(model)
        prep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.makedirs(T_DIR, exist_ok=True)
        t2_in = t_inputs("T.2", qs=qs, meta=np.array(
            [st4.n_shards, st4.capacity, st4.max_probes]), **st4.arrays)
        t3_in = t_inputs("T.3", n=len(requests), **{
            f"{k}{i}": r[k] for i, r in enumerate(requests) for k in r})
        outs, peak = spawn_ranks({"T.2": (t2_in,),
                                  "T.3": (params, t3_cfg, t3_in)}, device)
        ranks_s = time.perf_counter() - t0
        m_bytes = model.param_bytes()
        del params, model
        if device.type == "cuda":
            torch.cuda.ipc_collect()     # the ranks' views of the tables
        if peak is not None and peak >= T_PEAK_BYTES:
            fail(f"[T] the card's peak {peak} B is over {T_PEAK_BYTES}")
        t0 = time.perf_counter()
        t2 = check_t2(st4, qs, outs["T.2"])
        t2["check_seconds"] = time.perf_counter() - t0
        print("[T.2] " + json.dumps(t2), flush=True)
        t0 = time.perf_counter()
        t3 = check_t3(outs["T.3"], expected, device)
        t3.update(check_seconds=time.perf_counter() - t0,
                  param_bytes=m_bytes)
        print("[T.3] " + json.dumps(t3), flush=True)
        timing = {"prepare_s": prep_s, "ranks_s": ranks_s,
                  "peak_bytes": peak}
        print("[T] " + json.dumps(timing), flush=True)
    finally:
        shutil.rmtree(T_DIR, ignore_errors=True)
    probes = {k: sum(t1[s]["launches"].get(k, 0) for s in tdist.SCHEMES)
              + sum(r[tag]["launches"].get(k, 0) for r in t2["ranks"]
                    for tag, _ in T2_RUN_TAGS)
              for k in ("probe_lines", "probe_smem")}
    probe_err = max([log.max_err.get(k, 0) for k in probes]
                    + [max(r["max_abs_err"].values()) for r in t2["ranks"]])
    bag = sum(r["psum16"]["launches"].get("embedding_bag", 0)
              for r in t3["ranks"])
    bag_err = max(r["psum16"]["bag_max_abs_err"] for r in t3["ranks"])
    return ({"T.1": t1, "T.2": t2, "T.3": t3, "T": timing}, probes,
            probe_err, bag, bag_err)


# ---------------------------------------------------------------------------
# phase U: LM serving
# ---------------------------------------------------------------------------
def u_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def u_reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def u_tokens(cfg, shape, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=device)


def u_timed(fn, device):
    """-> (fn's result, host ms, event ms or None): one call, the card
    drained before and after."""
    u_sync(device)
    ev = None
    if device.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    out = fn()
    if ev is not None:
        ev[1].record()
    u_sync(device)
    host = (time.perf_counter() - t0) * 1e3
    return out, host, (ev[0].elapsed_time(ev[1]) if ev else None)


def u_median(xs):
    xs = [x for x in xs if x is not None]
    return float(np.median(xs)) if xs else None


def moe_recount(topi: np.ndarray, n_experts: int, cap: int):
    """``route_by_owner``'s kept flags over the flattened top-k experts,
    recounted in numpy: a slot is kept when fewer than ``cap`` earlier
    slots (in token order) went to its expert -> (kept [t, k], dropped)."""
    owner = topi.reshape(-1)
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(
        np.bincount(owner, minlength=n_experts))[:-1]])
    rank = np.empty(owner.shape, np.int64)
    rank[order] = np.arange(len(owner)) - starts[owner[order]]
    kept = rank < cap
    return kept.reshape(topi.shape), int((~kept).sum())


def moe_check(params, cfg, tap, device, n_check=U_MOE_CHECK_TOKENS,
              tag="U.2", layer=0):
    """MoE layer ``layer`` on one forward (U.2's prefill, V.3's batch):
    its dropped share against a numpy recount of ``route_by_owner`` from
    the card's own top-k experts, and ``n_check`` fixed tokens of its
    output against a per-token float64 recompute of their kept slots (and
    the shared expert)."""
    h, y, dropped = tap
    p = lm.layer_view(params, "moe_layers", layer)
    mp = cm.sub(p, "moe")
    mcfg = cfg.moe
    x = h.reshape(-1, h.shape[-1])
    t, k = x.shape[0], mcfg.top_k
    with torch.no_grad():
        _, topv, topi = moe.route(mp, mcfg, x)
    cap = moe.capacity(mcfg, t)
    kept, n_dropped = moe_recount(topi.cpu().numpy(), mcfg.n_experts, cap)
    share = float(np.float32(n_dropped) / np.float32(t * k))
    if share != float(dropped):
        fail(f"[{tag}] the MoE dropped {float(dropped)} of its slots; a "
             f"numpy recount of route_by_owner gives {share}")
    toks = np.linspace(0, t - 1, n_check).astype(np.int64)
    x64 = x[toks].double()
    want = torch.zeros_like(x64)
    ti = topi[toks].cpu().numpy()
    w = topv[toks].to(y.dtype).double()
    for e in np.unique(ti):
        rows, slots = np.nonzero((ti == e) & kept[toks])
        if not len(rows):
            continue
        wg, wu, wd = (mp[n][int(e)].double() for n in
                      ("w_gate", "w_up", "w_down"))
        v = x64[rows]
        out = (torch.nn.functional.silu(v @ wg) * (v @ wu)) @ wd
        want.index_add_(0, torch.from_numpy(rows).to(device),
                        out * w[rows, slots][:, None])
    if mcfg.n_shared:
        s = cm.sub(mp, "shared")
        want += (torch.nn.functional.silu(x64 @ s["w_gate"].double())
                 * (x64 @ s["w_up"].double())) @ s["w_down"].double()
    got = y.reshape(-1, y.shape[-1])[toks].double()
    diff, den = (got - want).norm(dim=-1), want.norm(dim=-1)
    # a token whose every slot dropped (and no shared expert) mixes nothing
    rel = torch.where(den > 0, diff / den.clamp(min=1e-300), diff).max() \
        .item()
    if not rel <= U_MOE_TOL:
        fail(f"[{tag}] the MoE output of {n_check} fixed tokens is {rel} "
             f"(normwise) from its float64 recompute (limit {U_MOE_TOL})")
    return {"capacity": cap, "dropped_share": share,
            "dropped_slots": n_dropped, "checked_tokens": n_check,
            "max_normwise_err_f64": rel}


def u_prefill(tag, cfg, params, batch, seq, device, requests,
              taps=None):
    """The prefill_32k cell at ``batch`` x ``seq``: one warm-up request
    (through ``lm_backbone`` with the MoE layers tapped when ``taps`` is
    a list), then ``requests`` timed through ``serve_step.lm_prefill_fn``
    -> metrics."""
    step = serve_step.lm_prefill_fn(cfg)
    u_reset_peak(device)
    tokens = u_tokens(cfg, (batch, seq), 1, device)
    with torch.no_grad():
        _, warm_ms, warm_ev = u_timed(lambda: lm.lm_logits(
            params, cfg, lm.lm_backbone(params, cfg, tokens,
                                        taps=taps)[0][:, -1:]), device)
    host, ev, finite = [], [], True
    for i in range(requests):
        tokens = u_tokens(cfg, (batch, seq), i + 2, device)
        logits, h_ms, e_ms = u_timed(lambda: step(params, tokens), device)
        host.append(h_ms)
        ev.append(e_ms)
        finite = finite and bool(logits.isfinite().all())
        if tuple(logits.shape) != (batch, cfg.vocab):
            fail(f"[{tag}] prefill logits {tuple(logits.shape)}")
    if not finite:
        fail(f"[{tag}] a prefill logit is not finite")
    ms = u_median(ev) or u_median(host)
    return {"batch": batch, "seq": seq, "requests": requests,
            "warmup_host_ms": warm_ms, "request_host_ms": host,
            "request_event_ms": ev, "request_ms_median": ms,
            "tokens_per_s": batch * seq / (ms / 1e3),
            "peak_bytes": max_memory(device)}


def u_decode(tag, cfg, params, cell, batch, device, steps, trace=True):
    """The decode ``cell`` (decode_32k or long_500k) at ``batch``
    sequences: the serve launcher's request 1 (``launch_serve.lm_request``:
    its token, positions and caches), then 1 + ``steps`` chained decode
    steps through ``serve_step.lm_decode_fn`` (each step's token the last
    one's argmax, its positions one on), the first a warm-up, one more
    traced."""
    step = serve_step.lm_decode_fn(cfg)
    u_reset_peak(device)
    t0 = time.perf_counter()
    token, pos, caches = launch_serve.lm_request(cfg, cell, batch, 1, device)
    u_sync(device)
    draw_s = time.perf_counter() - t0
    host, ev, finite = [], [], True
    for i in range(steps + 1):
        (logits, caches), h_ms, e_ms = u_timed(
            lambda: step(params, token, pos, caches), device)
        if i:
            host.append(h_ms)
            ev.append(e_ms)
        finite = finite and bool(logits.isfinite().all())
        token, pos = logits.float().argmax(-1).to(token.dtype), pos + 1
    if not finite:
        fail(f"[{tag}] a decode logit is not finite")
    out = {"batch": batch, "seq": cell.dims["seq"], "steps": steps,
           "cache_bytes": lm.cache_bytes(cfg, batch, cell.dims["seq"]),
           "request_draw_s": draw_s, "step_host_ms": host,
           "step_event_ms": ev}
    ms = u_median(ev) or u_median(host)
    out.update(step_ms_median=ms, tokens_per_s=batch / (ms / 1e3),
               peak_bytes=max_memory(device),
               f32_route=attn.F32_ROUTE["route"])
    if trace:
        with request_profiler(device) as prof:
            _, wall, _ = u_timed(lambda: step(params, token, pos, caches),
                                 device)
        busy, _ = device_busy_ms(prof)
        out["traced_step"] = {"host_ms": wall, "device_busy_ms": busy,
                              "busy_share": busy / wall if wall else None,
                              "top_kernels_ms": kernels_by_device_ms(prof)}
    return out


def u_agree(tag, cfg, params, device, prompt=U_AGREE_PROMPT,
            steps=U_AGREE_STEPS, tol=U_AGREE_TOL):
    """A prefill of ``prompt`` tokens whose caches come from the attention
    layers' ``return_cache`` (``lm.lm_prefill``), then ``steps`` decode
    steps; each step's logits against the last-position logits of the
    prefill of the longer prompt, within ``tol`` of their max |logit|
    (the JAX package's ``test_gqa_prefill_decode_agree`` and
    ``test_mla_prefill_decode_agree`` at published width)."""
    tokens = u_tokens(cfg, (1, prompt + steps), 3, device)
    prefill = serve_step.lm_prefill_fn(cfg)
    decode = serve_step.lm_decode_fn(cfg)
    errs = []
    with torch.no_grad():
        _, caches = lm.lm_prefill(params, cfg, tokens[:, :prompt],
                                  prompt + steps)
        pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
        for j in range(steps):
            got, caches = decode(params, tokens[:, prompt + j], pos, caches)
            want = prefill(params, tokens[:, :prompt + j + 1]).float()
            err = (got.float() - want).abs().max().item()
            errs.append(err / want.abs().max().item())
            pos = pos + 1
    del caches
    if not max(errs) <= tol:
        fail(f"[{tag}] decode after a {prompt}-token prefill is "
             f"{max(errs)} of max |logit| from the longer prefill "
             f"(limit {tol})")
    return {"prompt": prompt, "steps": steps, "rel_err": errs}


# float64 recompute: plain causal attention over the whole prompt
def _rms64(x, g, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rope64(x, pos, base):
    half = x.shape[-1] // 2
    inv = base ** (-torch.arange(0, 2 * half, 2, dtype=torch.float64,
                                 device=x.device) / (2 * half))
    ang = pos.double()[:, None] * inv
    c, s = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _attn64(q, k, v):
    """q [S, H, d], k [S, H, d], v [S, H, dv]: causal softmax attention."""
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    n = q.shape[0]
    s.masked_fill_(torch.ones(n, n, dtype=torch.bool, device=q.device)
                   .triu(1), float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


def layer64(p, cfg, x, pos):
    """One dense pre-norm layer (GQA or MLA, SwiGLU) in float64, plainly:
    the whole causal score matrix, MLA's keys expanded."""
    n = x.shape[0]
    a = _rms64(x, p["ln1"])
    if cfg.attn_type == "mla":
        m = cfg.mla_cfg()
        q = (_rms64(a @ p["attn/w_dq"], p["attn/q_gamma"])
             @ p["attn/w_uq"]).view(n, m.n_heads, -1)
        q = torch.cat([q[..., :m.dh_nope],
                       _rope64(q[..., m.dh_nope:], pos, m.rope_base)], -1)
        ckv = _rms64(a @ p["attn/w_dkv"], p["attn/kv_gamma"])
        kr = _rope64((a @ p["attn/w_kr"])[:, None], pos, m.rope_base)
        k = torch.cat([(ckv @ p["attn/w_uk"]).view(n, m.n_heads, -1),
                       kr.expand(n, m.n_heads, m.dh_rope)], -1)
        v = (ckv @ p["attn/w_uv"]).view(n, m.n_heads, m.dv)
        o = _attn64(q, k, v)
    else:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (a @ p["attn/wq"]).view(n, h, dh)
        k = (a @ p["attn/wk"]).view(n, kv, dh)
        v = (a @ p["attn/wv"]).view(n, kv, dh)
        if cfg.qk_norm:
            q, k = _rms64(q, p["attn/q_gamma"]), _rms64(k, p["attn/k_gamma"])
        q, k = _rope64(q, pos, cfg.rope_base), _rope64(k, pos, cfg.rope_base)
        g = h // kv
        o = _attn64(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))
    x = x + o.reshape(n, -1) @ p["attn/wo"]
    f = _rms64(x, p["ln2"])
    return x + (torch.nn.functional.silu(f @ p["ffn/w_gate"])
                * (f @ p["ffn/w_up"])) @ p["ffn/w_down"]


def lm_hidden64(p64, cfg, tokens):
    """Float64 hidden states [S, d] of one sequence ``tokens`` [S] through
    a dense-only LM's layers (``layer64``), before the final norm."""
    x = p64["embed"][tokens.long()]
    pos = torch.arange(len(tokens), device=tokens.device)
    stack = cm.sub(p64, "dense_layers")
    for i in range(cfg.n_layers):
        x = layer64({k: v[i] for k, v in stack.items()}, cfg, x, pos)
    return x


def lm_logits64(params, cfg, tokens, last):
    """Float64 logits of the ``last`` positions of one sequence ``tokens``
    [S] through a dense-only LM's layers (``lm_hidden64``)."""
    p64 = {k: v.double() for k, v in params.items()
           if not k.startswith("mtp/")}
    x = lm_hidden64(p64, cfg, tokens)
    return _rms64(x[-last:], p64["final_ln"]) @ p64["unembed"]


def u_fp64(tag, cfg, device, prompt=U_AGREE_PROMPT, steps=U_F64_STEPS,
           tol=U_F64_TOL):
    """``cfg`` (a dense-only cut) in float32 from seed 1: a prefill of
    ``prompt`` tokens and ``steps`` decode steps against ``lm_logits64``
    of the whole sequence, within ``tol`` of the max |logit|."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.n_moe_layers:
        raise ValueError("the float64 recompute takes dense layers only")
    params = lm.lm_init(cfg, seed=1, device=device)
    tokens = u_tokens(cfg, (1, prompt + steps), 4, device)
    decode = serve_step.lm_decode_fn(cfg)
    with torch.no_grad():
        want = lm_logits64(params, cfg, tokens[0], steps + 1)
        got, caches = lm.lm_prefill(params, cfg, tokens[:, :prompt],
                                    prompt + steps)
        rows = [got[0]]
        pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
        for j in range(steps):
            got, caches = decode(params, tokens[:, prompt + j], pos, caches)
            rows.append(got[0])
            pos = pos + 1
    scale = want.abs().max().item()
    errs = [(r.double() - w).abs().max().item() / scale
            for r, w in zip(rows, want)]
    del params, caches
    if not max(errs) <= tol:
        fail(f"[{tag}] float32 prefill / decode is {max(errs)} of max "
             f"|logit| from float64 (limit {tol})")
    return {"layers": cfg.n_layers, "prompt": prompt, "steps": steps,
            "rel_err": errs}


def u3_compare(arch, dtype, device, steps=4, seed=7):
    """An LM arch's SMOKE at ``dtype`` on ``device`` and on the CPU with the
    same parameters and request (the serve launcher's ``decode_32k`` smoke
    request ``seed``, its positions held ``steps`` short of the cache's
    end): prefill logits, ``steps`` chained decode steps' logits (each
    step's token the CPU's argmax of the last) and the caches after them
    -> max |difference| / max |CPU value| of each."""
    cfg = dataclasses.replace(registry.LM_ARCHS[arch].SMOKE, dtype=dtype)
    cpu = torch.device("cpu")
    params = lm.lm_init(cfg, seed=seed, device=cpu)
    cell = registry.reduce_cell(registry.cell_by_name("decode_32k", "lm"))
    b, s = cell.dims["batch"], cell.dims["seq"]
    tokens = u_tokens(cfg, (b, s), seed, cpu)
    token, pos, caches = launch_serve.lm_request(cfg, cell, b, seed, cpu)
    pos = pos.clamp(max=s - steps)
    prefill, decode = (serve_step.lm_prefill_fn(cfg),
                       serve_step.lm_decode_fn(cfg))
    runs, chosen = [], []
    for i, dev in enumerate((cpu, device)):
        p = {k: v.to(dev) for k, v in params.items()}
        c = {kind: {n: t.to(dev).clone() for n, t in e.items()}
             for kind, e in caches.items()}
        logits = [prefill(p, tokens.to(dev)).float().cpu()]
        tok, ps = token.to(dev), pos.to(dev)
        for j in range(steps):
            lg, c = decode(p, tok, ps, c)
            logits.append(lg.float().cpu())
            if i == 0:
                chosen.append(lg.float().argmax(-1).to(token.dtype))
            tok, ps = chosen[j].to(dev), ps + 1
        runs.append((logits, {f"{k}/{n}": t.float().cpu()
                              for k, e in c.items() for n, t in e.items()}))
    (lc, cc), (lg, cg) = runs

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    return {"prefill": rel(lg[0], lc[0]),
            "decode": max(rel(g, w) for g, w in zip(lg[1:], lc[1:])),
            "caches": max(rel(cg[k], cc[k]) for k in cc),
            "finite": all(bool(t.isfinite().all()) for t in lg)}


def u_check_peak(tag, m):
    if m.get("peak_bytes") is not None and m["peak_bytes"] >= U_PEAK_BYTES:
        fail(f"[{tag}] the card's peak {m['peak_bytes']} B is over "
             f"{U_PEAK_BYTES}")


def u_free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_phase_u(device, u1=None, u2=None, smoke=False):
    """U.1 qwen3-14b whole, U.2 deepseek-v3-671b at published width cut to
    ``U2_LAYERS`` layers, U.3 the five SMOKE configs on the card against
    the CPU -> metrics.  ``u1`` / ``u2`` replace the configs (and
    ``smoke`` the cells' sizes) to rehearse on the CPU."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    out = {}
    cell = {c.name: registry.reduce_cell(c) if smoke else c
            for c in registry.LM_CELLS}
    cells = [("U.1", u1 or qwen3_14b.CONFIG, U1_DECODE_BATCHES, False),
             ("U.2", u2 or dataclasses.replace(
                 deepseek_v3_671b.CONFIG, n_layers=U2_LAYERS),
              (registry.cell_by_name("decode_32k", "lm").dims["batch"],),
              True)]
    for tag, cfg, batches, long_ctx in cells:
        t_cell = time.perf_counter()
        u_free(device)
        t0 = time.perf_counter()
        params = lm.lm_init(cfg, seed=0, device=device)
        u_sync(device)
        m = {"config": cfg.name, "layers": cfg.n_layers,
             "param_bytes": lm.param_bytes(cfg),
             "init_s": time.perf_counter() - t0}
        print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, "
              f"{m['param_bytes']} parameter bytes on the card in "
              f"{m['init_s']:.1f} s", flush=True)
        taps = [] if cfg.moe is not None else None
        m["prefill_32k"] = u_prefill(tag, cfg, params, U_PREFILL_BATCH,
                                     cell["prefill_32k"].dims["seq"], device,
                                     U_PREFILL_REQUESTS, taps=taps)
        u_check_peak(tag, m["prefill_32k"])
        if taps is not None:
            m["moe"] = moe_check(params, cfg, taps[0], device)
        del taps
        print(f"[{tag}] prefill_32k " + json.dumps(m["prefill_32k"]),
              flush=True)
        u_free(device)
        for b in batches:
            d = u_decode(tag, cfg, params, cell["decode_32k"], b, device,
                         U_DECODE_STEPS)
            u_check_peak(tag, d)
            if d["peak_bytes"] is None or d["peak_bytes"] <= U_DECODE_PEAK \
                    or b == batches[-1]:
                break
            print(f"reduced: {tag} decode_32k batch {b}->{batches[-1]}: "
                  f"the peak {d['peak_bytes']} B passed {U_DECODE_PEAK} B",
                  flush=True)
            u_free(device)
        m["decode_32k"] = d
        print(f"[{tag}] decode_32k " + json.dumps(d), flush=True)
        u_free(device)
        if long_ctx:
            m["long_500k"] = u_decode(tag, cfg, params, cell["long_500k"],
                                      1, device, U_DECODE_STEPS, trace=False)
            u_check_peak(tag, m["long_500k"])
            print(f"[{tag}] long_500k " + json.dumps(m["long_500k"]),
                  flush=True)
            u_free(device)
        agree_cfg = cfg
        if cfg.moe is not None:        # room for every token: no drops
            agree_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        m["decode_agrees"] = u_agree(tag, agree_cfg, params, device)
        del params
        u_free(device)
        dense = dataclasses.replace(cfg, n_layers=2,
                                    n_dense_layers=2 if cfg.moe else 0)
        m["float64"] = u_fp64(tag, dense, device)
        m["seconds"] = time.perf_counter() - t_cell
        print(f"[{tag}] checks " + json.dumps(
            {k: m[k] for k in ("decode_agrees", "float64", "moe")
             if k in m}), flush=True)
        out[tag] = m
    t0 = time.perf_counter()
    u3 = {}
    for arch in registry.LM_ARCHS:
        for dtype, tol in (("float32", U3_F32_TOL),
                           ("bfloat16", U3_BF16_TOL)):
            r = u3_compare(arch, dtype, device)
            u3[f"{arch}/{dtype}"] = r
            worst = max(r["prefill"], r["decode"], r["caches"])
            if not r["finite"] or not worst <= tol:
                fail(f"[U.3] {arch} {dtype} on the card is {worst} from the "
                     f"CPU (limit {tol}): {r}")
    u3["seconds"] = time.perf_counter() - t0
    print("[U.3] " + json.dumps(u3), flush=True)
    out["U.3"] = u3
    return out


# ---------------------------------------------------------------------------
# phase V: LM training
# ---------------------------------------------------------------------------
def v_batch(cfg, seq, seed, device, batch=1):
    """``synthetic.lm_batch`` of ``batch`` x ``seq`` from
    ``default_rng(seed)``, on ``device``."""
    return {"tokens": torch.as_tensor(synthetic.lm_batch(
        np.random.default_rng(seed), batch, seq, cfg.vocab)["tokens"],
        device=device)}


def v1_layers(cfg=qwen3_14b.CONFIG, seq=V_SEQ, target=V1_PEAK_TARGET):
    """The most layers of ``cfg`` whose train step at one sequence
    ``launch/train.lm_train_bytes`` puts under ``target``."""
    ocfg = launch_cells.opt_cfg("lm", cfg)
    for n in range(cfg.n_layers, 0, -1):
        c = dataclasses.replace(cfg, n_layers=n)
        if launch_train.step_peak(launch_train.lm_train_bytes(
                c, ocfg, 1, seq)) <= target:
            return n
    raise SystemExit(f"{cfg.name}: not one layer fits {target} B")


def normwise(got, want) -> float:
    """||got - want|| / ||want|| in float64 (||got - want|| when want is
    zero), 2^26 elements at a time."""
    d2 = n2 = 0.0
    for a, b in zip(got.reshape(-1).split(1 << 26),
                    want.reshape(-1).split(1 << 26)):
        b = b.double()
        d2 += (a.double() - b).square().sum().item()
        n2 += b.square().sum().item()
    return math.sqrt(d2 / n2) if n2 else math.sqrt(d2)


def v_xent_check(tag, cfg, params, tokens):
    """The chunked CE (S - 1 positions padded to the chunk) against one
    projection of the same hidden states -> relative difference."""
    with torch.no_grad():
        h, _ = lm.lm_backbone(params, cfg, tokens)
        chunked = lm._chunked_xent(params, cfg, h[:, :-1], tokens[:, 1:])
        whole = lm._chunked_xent(params, dataclasses.replace(
            cfg, loss_chunk=0), h[:, :-1], tokens[:, 1:])
    rel = abs(chunked.item() - whole.item()) / abs(whole.item())
    if not rel <= V_XENT_TOL:
        fail(f"[{tag}] the chunked CE {chunked.item()} is {rel} from one "
             f"projection's {whole.item()} (limit {V_XENT_TOL})")
    return {"positions": tokens.shape[1] - 1, "chunk": cfg.loss_chunk,
            "chunked": chunked.item(), "whole": whole.item(), "rel": rel}


def kernel_classes_ms(prof) -> dict:
    """A trace's device ms by kind of kernel: GEMMs (cuBLAS, CUTLASS),
    element-wise and copies, reductions and softmax, the rest."""
    out = {"gemm": 0.0, "elementwise": 0.0, "reduce_softmax": 0.0,
           "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name.lower()
        kind = ("gemm" if any(w in n for w in ("gemm", "nvjet", "cutlass",
                                                "sm90_xmma", "cublas"))
                else "elementwise" if any(w in n for w in (
                    "elementwise", "copy", "fill", "memset", "memcpy"))
                else "reduce_softmax" if any(w in n for w in (
                    "reduce", "softmax", "norm"))
                else "other")
        out[kind] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def v_train(tag, cfg, device, steps=V_STEPS, seq=V_SEQ):
    """``cfg``'s ``train_4k`` at one sequence of ``seq`` a step: weights
    from ``lm_init`` (seed 0), the optimizer rule of
    ``launch/cells.opt_cfg`` (the published depth's), the launcher's step
    (``make_train_step(lm_loss_fn(cfg), rule, in_place=True)``) on
    ``lm_batch`` tokens; a warm-up, ``steps`` timed by events and host
    clock, one more traced, one more in its two halves (the loss and its
    gradients; the update).  An MoE config's layers are tapped on the
    warm-up's batch first (``moe_check`` each, and the warm-up's
    ``moe_dropped`` their sum).  Then the chunked CE against one
    projection on the trained weights -> metrics."""
    ocfg = launch_cells.opt_cfg("lm", cfg)
    u_free(device)
    u_reset_peak(device)
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, seed=0, device=device)
    state = train_opt.init_opt_state(params, ocfg)
    u_sync(device)
    m = {"config": cfg.name, "layers": cfg.n_layers,
         "published_layers": launch_cells.published_layers(cfg),
         "rule": ocfg.dense_rule, "table_rule": ocfg.table_rule,
         "param_bytes": lm.param_bytes(cfg),
         "estimate_bytes": launch_train.lm_train_bytes(cfg, ocfg, 1, seq),
         "seq": seq, "batch": 1, "init_s": time.perf_counter() - t0}
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} of {m['published_layers']} "
          f"layers, {m['param_bytes']} parameter bytes, rule "
          f"{ocfg.dense_rule} (tables {ocfg.table_rule}), drawn in "
          f"{m['init_s']:.1f} s", flush=True)
    fn = train_step.make_train_step(train_step.lm_loss_fn(cfg), ocfg,
                                    in_place=True)
    batches = [v_batch(cfg, seq, 10 + i, device) for i in range(steps + 2)]
    taps = None
    if cfg.moe is not None:
        taps = []
        with torch.no_grad():
            lm.lm_backbone(params, cfg, batches[0]["tokens"], taps=taps)
        m["moe"] = [moe_check(params, cfg, tap, device, tag=tag, layer=i)
                    for i, tap in enumerate(taps)]
        tapped = torch.zeros((), dtype=torch.float32, device=device)
        for _, _, d in taps:
            tapped = tapped + d
        del taps
    step, losses, gnorms, host, ev = 0, [], [], [], []
    for i in range(steps + 1):
        (params, state, step, metrics), h_ms, e_ms = u_timed(
            lambda: fn(params, state, step, batches[i]), device)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        if i:
            host.append(h_ms)
            ev.append(e_ms)
        elif cfg.moe is not None:
            m["moe_dropped"] = metrics["moe_dropped"].item()
            if m["moe_dropped"] != tapped.item():
                fail(f"[{tag}] the step's moe_dropped {m['moe_dropped']} is "
                     f"not its layers' {tapped.item()}")
    with request_profiler(device) as prof:
        (params, state, step, metrics), wall, _ = u_timed(
            lambda: fn(params, state, step, batches[-1]), device)
    losses.append(metrics["loss"].item())
    gnorms.append(metrics["grad_norm"].item())
    # one more step in its two halves: the loss and its gradients, then
    # the in-place update
    (_, _, grads), fb_host, fb_ev = u_timed(
        lambda: train_step._value_and_grad(
            train_step.lm_loss_fn(cfg), params, batches[0],
            layer_leaves=lm.is_stacked), device)
    gn, up_host, up_ev = u_timed(lambda: train_opt.apply_updates_(
        params, grads, state, ocfg, step + 1), device)
    gnorms.append(gn.item())
    del grads
    if not np.isfinite(losses + gnorms).all():
        fail(f"[{tag}] a loss or grad_norm is not finite: {losses} {gnorms}")
    busy, _ = device_busy_ms(prof)
    ms = u_median(ev) or u_median(host)
    m.update(steps=steps, step_host_ms=host, step_event_ms=ev,
             step_ms_median=ms, tokens_per_s=seq / (ms / 1e3),
             loss=losses, grad_norm=gnorms, peak_bytes=max_memory(device),
             split_step_ms={"loss_and_grads": fb_ev or fb_host,
                            "update": up_ev or up_host},
             traced_step={"host_ms": wall, "device_busy_ms": busy,
                          "busy_share": busy / wall if wall else None,
                          "kernels_by_kind_ms": kernel_classes_ms(prof),
                          "top_kernels_ms": kernels_by_device_ms(prof)})
    del prof, state, metrics
    u_free(device)
    m["xent_chunks"] = v_xent_check(tag, cfg, params, batches[0]["tokens"])
    del params
    u_free(device)
    return m


def xent64(logits, targets):
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets.long()[:, None])[:, 0]).mean()


def lm_loss64(p64, cfg, tokens):
    """``lm.lm_loss`` of one sequence ``tokens`` [S] through a dense-only
    LM in float64, plainly (``lm_hidden64``, every position's logits at
    once; MTP's block through ``layer64``)."""
    h = lm_hidden64(p64, cfg, tokens)
    loss = xent64(_rms64(h[:-1], p64["final_ln"]) @ p64["unembed"],
                  tokens[1:])
    if cfg.mtp_depth:
        p = cm.sub(p64, "mtp")
        x = torch.cat([_rms64(h[:-1], p["ln_h"]),
                       _rms64(p64["embed"][tokens[1:].long()], p["ln_e"])],
                      -1) @ p["proj"]
        x = layer64(cm.sub(p, "block"), cfg, x,
                    torch.arange(len(tokens) - 1, device=tokens.device))
        x = _rms64(x, p["final_ln"])
        loss = loss + 0.3 * xent64(x[:-1] @ p64["unembed"], tokens[2:])
    return loss


def v_checks(tag, cfg, device, seq=V_CHECK_SEQ, layers=V_CHECK_LAYERS):
    """``cfg`` cut to ``layers`` dense layers (MTP kept) in float32, seed
    1, one sequence of ``seq`` (the loss over chunks, the last padded):
    the loss and gradients with remat against without (the loss the same
    bits, each leaf within ``V_REMAT_TOL`` normwise), then against
    float64 (``lm_loss64`` differentiated; the loss within
    ``V_F64_LOSS_TOL``, each leaf within ``V_F64_GRAD_TOL`` normwise)."""
    c32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32",
                              remat=True,
                              n_dense_layers=layers if cfg.moe else 0)
    u_free(device)
    params = lm.lm_init(c32, seed=1, device=device)
    batch = v_batch(c32, seq, 3, device)
    loss_r, _, grads = train_step._value_and_grad(
        train_step.lm_loss_fn(c32), params, batch)
    loss_n, _, grads_n = train_step._value_and_grad(
        train_step.lm_loss_fn(dataclasses.replace(c32, remat=False)),
        params, batch)
    remat = {k: normwise(grads_n[k], g) for k, g in grads.items()}
    del grads_n
    out = {"layers": layers, "seq": seq, "loss_remat": loss_r.item(),
           "loss_no_remat": loss_n.item(),
           "remat_grad_max": max(remat.values())}
    if loss_r.item() != loss_n.item() or not out["remat_grad_max"] \
            <= V_REMAT_TOL:
        fail(f"[{tag}] remat changes the loss ({loss_r.item()} against "
             f"{loss_n.item()}) or a gradient by {out['remat_grad_max']} "
             f"(limit {V_REMAT_TOL})")
    grads = {k: g.cpu() for k, g in grads.items()}
    p64 = {}
    for k in list(params):
        p64[k] = params.pop(k).double().requires_grad_()
    u_free(device)
    loss64 = lm_loss64(p64, c32, batch["tokens"][0])
    g64 = dict(zip(p64, torch.autograd.grad(loss64, list(p64.values()))))
    del p64
    u_free(device)
    errs = {k: normwise(grads[k].to(device), g) for k, g in g64.items()}
    del g64
    worst = max(errs, key=errs.get)
    out.update(loss_f64=loss64.item(),
               loss_rel=abs(loss_r.item() - loss64.item())
               / abs(loss64.item()),
               grad_normwise_max=errs[worst], grad_worst_leaf=worst,
               grad_normwise=errs)
    u_free(device)
    if not out["loss_rel"] <= V_F64_LOSS_TOL \
            or not errs[worst] <= V_F64_GRAD_TOL:
        fail(f"[{tag}] float32 training is {out['loss_rel']} (loss; limit "
             f"{V_F64_LOSS_TOL}) and {errs[worst]} ({worst}, normwise; "
             f"limit {V_F64_GRAD_TOL}) from float64")
    return out


def v4_compare(arch, dtype, device, accum, seed=7):
    """One step of the launcher's LM step (in place, a layer's leaves at
    a time) of an LM arch's SMOKE at ``dtype`` (the rule of ``launch/cells.opt_cfg``) on
    ``device`` and on the CPU from the same parameters (``lm_init`` seed
    ``seed``) and batch (the reduced ``train_4k``: 2 x 16) -> the loss's
    and grad_norm's relative difference and each parameter's and state's
    max |difference| / max |CPU value| (an Adam element whose first step
    is a sign, sqrt(v-hat) < ``V4_ADAM_SENSITIVE`` on the CPU, held to
    lr instead)."""
    cfg = dataclasses.replace(registry.LM_ARCHS[arch].SMOKE, dtype=dtype)
    ocfg = launch_cells.opt_cfg("lm", cfg)
    cpu = torch.device("cpu")
    params = lm.lm_init(cfg, seed=seed, device=cpu)
    cell = registry.reduce_cell(registry.cell_by_name("train_4k", "lm"))
    tokens = v_batch(cfg, cell.dims["seq"], seed, cpu,
                     batch=cell.dims["batch"])["tokens"]
    runs = []
    for dev in (cpu, device):
        p = {k: v.to(dev).clone() for k, v in params.items()}
        st = train_opt.init_opt_state(p, ocfg)
        fn = train_step.make_train_step(train_step.lm_loss_fn(cfg), ocfg,
                                        accum_steps=accum, in_place=True)
        p, st, _, metrics = fn(p, st, 0, {"tokens": tokens.to(dev)})
        runs.append(({k: v.float().cpu() for k, v in p.items()},
                     {f"{k}/{n}": t.float().cpu() for k, e in st.items()
                      for n, t in e.items()},
                     {k: metrics[k].item() for k in ("loss", "grad_norm")}))
    (pc, sc, mc), (pg, sg, mg) = runs

    def rel(a, b, loose=None):
        d = (a - b).abs()
        if loose is not None:
            d = torch.where(loose, (d - ocfg.lr).clamp(min=0), d)
        return (d.max() / b.abs().max().clamp(min=1e-30)).item()
    err = {"loss": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
           "grad_norm": abs(mg["grad_norm"] - mc["grad_norm"])
           / mc["grad_norm"]}
    leaves = {}
    for k in pc:
        loose = None
        if f"{k}/v" in sc and f"{k}/m" in sc:            # an Adam leaf
            vhat = sc[f"{k}/v"] / (1 - ocfg.b2)
            loose = (vhat.sqrt() < V4_ADAM_SENSITIVE) \
                | (sc[f"{k}/m"].sign() != sg[f"{k}/m"].sign())
        leaves[k] = rel(pg[k], pc[k], loose)
    for k in sc:                 # second moments in the gradient's units
        root = k.rsplit("/", 1)[1] in ("v", "vr", "vc", "acc")
        leaves[k] = rel(sg[k].sqrt(), sc[k].sqrt()) if root \
            else rel(sg[k], sc[k])
    worst = max(leaves, key=leaves.get)
    err.update(params_state=leaves[worst], worst_leaf=worst,
               finite=all(math.isfinite(x) for x in (*mg.values(),
                                                       *mc.values())))
    return err


def run_phase_v(device, v1=None, v2=None, v3=None, seq=V_SEQ, steps=V_STEPS,
                check_seq=V_CHECK_SEQ):
    """V.1 qwen3-14b at published width cut to ``v1_layers``, V.2
    deepseek-v3-671b's ``V2_LAYERS`` dense layers and its MTP block, V.3
    qwen3-moe's first ``V3_LAYERS`` MoE layers, each trained at one
    sequence of ``seq`` (``v_train``); V.1's and V.2's width checked at
    ``V_CHECK_LAYERS`` layers (``v_checks``); V.4 the five SMOKE configs,
    a step and a step of two microbatches, card against CPU -> metrics.
    ``v1`` / ``v2`` / ``v3`` (and ``seq``, ``steps``, ``check_seq``)
    replace them to rehearse on the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    out = {}
    cells = [("V.1", v1 or dataclasses.replace(
                 qwen3_14b.CONFIG, n_layers=v1_layers()), True),
             ("V.2", v2 or dataclasses.replace(
                 deepseek_v3_671b.CONFIG, n_layers=V2_LAYERS), True),
             ("V.3", v3 or dataclasses.replace(
                 qwen3_moe_235b.CONFIG, n_layers=V3_LAYERS), False)]
    for tag, cfg, check in cells:
        t0 = time.perf_counter()
        m = v_train(tag, cfg, device, steps=steps, seq=seq)
        print(f"[{tag}] " + json.dumps(m), flush=True)
        if m["peak_bytes"] is not None and m["peak_bytes"] >= U_PEAK_BYTES:
            fail(f"[{tag}] the card's peak {m['peak_bytes']} B is over "
                 f"{U_PEAK_BYTES}")
        if check:
            m["checks"] = v_checks(tag, cfg, device, seq=check_seq)
        m["seconds"] = time.perf_counter() - t0
        print(f"[{tag}] took {m['seconds']:.1f} s", flush=True)
        if check:
            c = dict(m["checks"])
            c.pop("grad_normwise")
            print(f"[{tag}] checks " + json.dumps(c), flush=True)
        out[tag] = m
    t0 = time.perf_counter()
    v4 = {}
    for arch in registry.LM_ARCHS:
        for dtype, tol in (("float32", V4_F32_TOL),
                           ("bfloat16", V4_BF16_TOL)):
            for accum in (1, 2):
                r = v4_compare(arch, dtype, device, accum)
                v4[f"{arch}/{dtype}/accum{accum}"] = r
                worst = max(r["loss"], r["grad_norm"], r["params_state"])
                if not r["finite"] or not worst <= tol:
                    fail(f"[V.4] {arch} {dtype} accum {accum} on the card "
                         f"is {worst} from the CPU (limit {tol}): {r}")
    v4["seconds"] = time.perf_counter() - t0
    print("[V.4] " + json.dumps(v4), flush=True)
    out["V.4"] = v4
    return out


# ---------------------------------------------------------------------------
# phase W: the cell builder's bundles, the dry-run and the H100 roofline
# ---------------------------------------------------------------------------
def w_cut_cells(n_v1: int, smoke: bool = False) -> dict:
    """The cut cells phase W reads a dry-run of: W.2's qwen3-14b
    ``decode_32k`` at U.1's batch, and V.1-V.3's configs at one sequence
    of ``V_SEQ`` -> {tag: (arch, config, cell)}.  ``smoke``: the SMOKE
    configs at ``registry.reduce_cell``'s sizes, to rehearse on the
    CPU."""
    decode = registry.cell_by_name("decode_32k", "lm")
    train = registry.cell_by_name("train_4k", "lm")
    batch, seq = W2_DECODE_BATCH, V_SEQ
    configs = {a: m.CONFIG for a, m in registry.LM_ARCHS.items()}
    if smoke:
        decode, train = registry.reduce_cell(decode), \
            registry.reduce_cell(train)
        batch, seq = decode.dims["batch"], train.dims["seq"]
        configs = {a: m.SMOKE for a, m in registry.LM_ARCHS.items()}
    one_seq = registry.Cell(train.name, train.kind,
                            {**train.dims, "batch": 1, "seq": seq})
    v = {"V.1": ("qwen3-14b", n_v1), "V.2": ("deepseek-v3-671b", V2_LAYERS),
         "V.3": ("qwen3-moe-235b-a22b", V3_LAYERS)}
    out = {"W.2 qwen3-14b/decode_32k": (
        "qwen3-14b", configs["qwen3-14b"],
        registry.Cell(decode.name, decode.kind,
                      {**decode.dims, "batch": batch}))}
    for tag, (arch, layers) in v.items():
        cfg = configs[arch]
        out[tag] = (arch, dataclasses.replace(
            cfg, n_layers=min(layers, cfg.n_layers) if smoke else layers),
            one_seq)
    return out


def w_cut_path(out_dir: str, tag: str) -> str:
    return os.path.join(out_dir, "cut__" + tag.replace(" ", "_")
                        .replace("/", "_") + ".json")


def w1_child(out_dir: str, smoke: bool = False) -> int:
    """W.1's work, in a child interpreter that never touches the card:
    ``python -m repro_torch.launch.dryrun --all`` into ``out_dir``, the
    ``W_VARIANTS``, then the dry-run of each of ``w_cut_cells`` (one pass,
    no layer fit) -> the CLI's exit code.  ``smoke``: every cell at SMOKE
    (``run_cell(smoke=True)``), to rehearse on the CPU."""
    t_child = time.perf_counter()
    if smoke:
        rc = 0
        for arch, shape in launch_cells.all_cells():
            rc = rc or int(not launch_dryrun.run_cell(
                arch, shape, out_dir, force=True, smoke=True)["ok"])
    else:
        rc = launch_dryrun.main(["--all", "--force", "--out", out_dir])
    for arch, shape, variant in W_VARIANTS:
        rec = launch_dryrun.run_cell(arch, shape, out_dir, variant=variant,
                                     force=True, smoke=smoke)
        rc = rc or (0 if rec["ok"] else 1)
    mesh = launch_mesh.make_local_mesh()
    n_v1 = V2_LAYERS if smoke else v1_layers()
    for tag, (arch, cfg, cell) in w_cut_cells(n_v1, smoke).items():
        t0 = time.time()
        rec = {"tag": tag, "arch": arch, "shape": cell.name,
               "config": cfg.name, "layers": cfg.n_layers,
               "dims": cell.dims, "ok": False}
        try:
            bundle = launch_cells._lm_cell(arch, cfg, cell, mesh)
            rec.update(ok=True, n_devices=1, meta=bundle.meta,
                       **launch_dryrun.measure(bundle))
        except Exception as e:       # noqa: BLE001 — recorded, W fails it
            rec["error"] = f"{type(e).__name__}: {e}"
            rc = 1
        rec["wall_s"] = round(time.time() - t0, 2)
        with open(w_cut_path(out_dir, tag), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[{'OK' if rec['ok'] else 'FAIL'}] {tag} "
              f"wall={rec['wall_s']}s", flush=True)
    print(f"W.1 counted every cell in {time.perf_counter() - t_child:.1f} "
          f"s, exit {rc}", flush=True)
    return rc


def start_w1(smoke: bool = False):
    """Starts ``w1_child`` in a child interpreter at low priority, with no
    card visible, its output to ``W_DIR/log.txt`` -> (the process, the
    start time).  main() joins it at phase W, and kills it at exit if it
    still runs."""
    shutil.rmtree(W_DIR, ignore_errors=True)
    os.makedirs(W_DIR)
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.w1_child({W_DIR!r}, {smoke!r}))")
    with open(os.path.join(W_DIR, "log.txt"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=log,
            stderr=subprocess.STDOUT, cwd=root,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            preexec_fn=lambda: os.nice(10))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, time.perf_counter()


def w_roofline(rec: dict, cfg, cell) -> dict:
    """A dry-run record's bound on the H100 at ``cfg`` and ``cell``."""
    family = registry.family(rec["arch"])
    r = roofline.from_record(rec, roofline.model_flops_for(
        family, cfg, cell, rec["meta"]))
    return {"bound_s": r.bound_time_s, "dominant": r.dominant,
            "compute_s": r.compute_s, "memory_s": r.memory_s,
            "collective_s": r.collective_s,
            "model_over_counted": r.useful_flops_ratio}


def w1_line(name: str, rec: dict, cfg, cell) -> dict:
    """W.1's line of one record (it fails the phase unless ``ok``)."""
    if not rec.get("ok"):
        fail(f"[W.1] the dry-run of {name} failed: {rec.get('error')}")
    c, m = rec["cost"], rec["memory"]
    return {"cell": name,
            "flops": {k[len("flops_"):]: v for k, v in c.items()
                      if k.startswith("flops_")},
            "bytes_accessed": c["bytes accessed"],
            "argument_gb": m["argument_size_in_bytes"] / 1e9,
            "peak_gb": m["peak_size_in_bytes"] / 1e9,
            "fits_80gb": rec["fits_hbm"], **w_roofline(rec, cfg, cell),
            "collectives": rec["collectives"]["total"],
            "kernels": {k: v["calls"] for k, v in rec.get("kernels",
                                                          {}).items()},
            "wall_s": rec["wall_s"]}


def run_phase_w1(proc, t_start, n_v1, smoke=False) -> dict:
    """Joins the dry-run child and prints W.1's line a cell -> {name:
    record}: the registry's cells, the variants and the cut cells
    (``smoke``: as ``start_w1(smoke=True)`` counted them)."""
    try:
        rc = proc.wait(timeout=max(1.0, W_TIMEOUT_S
                                   - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"[W.1] the dry-run did not end within {W_TIMEOUT_S} s")
    waited = time.perf_counter() - t_start
    with open(os.path.join(W_DIR, "log.txt")) as f:
        log = f.read()
    print(f"[W.1] the dry-run child exited {rc}, joined {waited:.1f} s "
          f"after it started: {log.strip().splitlines()[-1]}", flush=True)
    recs = {}
    for arch, shape in launch_cells.all_cells():
        with open(launch_dryrun.record_path(W_DIR, arch, shape)) as f:
            recs[f"{arch}/{shape}"] = json.load(f)
    for arch, shape, variant in W_VARIANTS:
        with open(launch_dryrun.record_path(W_DIR, arch, shape,
                                            variant)) as f:
            recs[f"{arch}/{shape}/{variant}"] = json.load(f)
    for name, rec in recs.items():
        family = registry.family(rec["arch"])
        configs = launch_cells.configs_of(rec["arch"])
        cell = registry.cell_by_name(rec["shape"], family)
        line = w1_line(name, rec, configs.SMOKE if smoke else configs.CONFIG,
                       registry.reduce_cell(cell) if smoke else cell)
        print("[W.1] " + json.dumps(line), flush=True)
    for tag, (arch, cfg, cell) in w_cut_cells(n_v1, smoke).items():
        with open(w_cut_path(W_DIR, tag)) as f:
            rec = json.load(f)
        recs[tag] = rec
        print(f"[W.1] reduced: {tag} {cfg.name} {cfg.n_layers} layers "
              f"{cell.dims} " + json.dumps(w1_line(tag, rec, cfg, cell)),
              flush=True)
    if rc != 0:
        fail(f"[W.1] the dry-run exited {rc}: {log[-2000:]}")
    return recs


def w_finite(out) -> bool:
    """Every float leaf of ``out`` finite, checked 2^26 elements at a
    time (a 21.5 GB cache leaves no room for its whole mask)."""
    step = 1 << 26
    for x in torch.utils._pytree.tree_flatten(out)[0]:
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            flat = x.reshape(-1)
            for i in range(0, flat.numel(), step):
                if not bool(torch.isfinite(flat[i:i + step]).all()):
                    return False
    return True


def allocated(device):
    return (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else None)


def w2_bundle(tag, bundle, device, rec, cfg, logs) -> dict:
    """One bundle of the builder run for real on the card (W.2): its
    arguments from ``materialize_bundle`` on the card, one run inside
    ``logs`` (every kernel launch held against its plain version) whose
    ``max_memory_allocated``, less what the process held before the
    arguments were drawn (``held_before_bytes``: earlier phases' caches
    and library workspaces), is the bundle's peak (``peak_bytes``, over
    the dry-run's in ``peak_over_dryrun``), then ``W_RUNS`` timed
    by CUDA events; ``test_arch_smoke``'s checks -> metrics beside the
    dry-run's peak and bound, the bundle's bytes allocated before the
    checked run (its arguments) and those the run left allocated once its
    outputs went (what a first call keeps: library workspaces)."""
    u_free(device)
    held = allocated(device)           # what the process holds already
    t0 = time.perf_counter()
    args = launch_mat.materialize_bundle(bundle, seed=0, device=device)
    u_sync(device)
    draw_s = time.perf_counter() - t0
    u_reset_peak(device)
    before = allocated(device)
    with contextlib.ExitStack() as stack:
        for log in logs:
            stack.enter_context(log)
        out, _, first_ms = u_timed(lambda: bundle.fn(*args), device)
        raw_peak = max_memory(device)  # before the checks' plain versions
        for log in logs:
            log.check_pending()
            log.last = None            # its launch's tensors (the tables)
            getattr(log, "kept", {}).clear()
    peak = raw_peak - held if raw_peak is not None else None   # the bundle's
    if not w_finite(out):
        fail(f"[{tag}] produced non-finite outputs")
    if bundle.meta.get("has_opt"):
        for k, p in args[0].items():
            if out[0][k].shape != p.shape:
                fail(f"[{tag}] {k} changed shape: {tuple(p.shape)} -> "
                     f"{tuple(out[0][k].shape)}")
        if int(out[2]) != 1:
            fail(f"[{tag}] the step did not advance: {int(out[2])}")
    if bundle.cell.kind == "rec_serve":
        lead = torch.utils._pytree.tree_flatten(out)[0][0].shape[0]
        if lead != bundle.cell.dims["batch"]:
            fail(f"[{tag}] leading dim {lead}, batch "
                 f"{bundle.cell.dims['batch']}")
    del out
    u_sync(device)
    kept = allocated(device) - before if before is not None else None
    before = before - held if before is not None else None
    ev = []
    for _ in range(W_RUNS):
        out, _, e_ms = u_timed(lambda: bundle.fn(*args), device)
        ev.append(e_ms)
        del out
    ms = u_median(ev)
    dry_peak = rec["memory"]["peak_size_in_bytes"]
    bound = w_roofline(rec, cfg, bundle.cell)
    m = {"cell": f"{bundle.arch_id}/{bundle.cell.name}",
         "dims": bundle.cell.dims, "draw_s": draw_s,
         "first_ms": first_ms, "step_ms": ev, "step_ms_median": ms,
         "max_memory_allocated": raw_peak, "held_before_bytes": held,
         "peak_bytes": peak, "allocated_before": before,
         "kept_after_the_step": kept,
         "dryrun_peak_bytes": dry_peak,
         "peak_over_dryrun": peak / dry_peak if peak and dry_peak else None,
         "dryrun_argument_bytes": rec["memory"]["argument_size_in_bytes"],
         "bound_ms": bound["bound_s"] * 1e3, "bound_by": bound["dominant"],
         "bound_over_measured": bound["bound_s"] * 1e3 / ms if ms else None}
    del args
    u_free(device)
    return m


def run_phase_w2(device, recs, smoke=False) -> tuple[dict, dict]:
    """W.2: ``W2_CELLS`` through ``build_cell`` and ``materialize_bundle``
    on the card at published width, then qwen3-14b's ``decode_32k`` at
    ``W2_DECODE_BATCH`` through ``_lm_cell`` of the cut cell; the kernels'
    counts from 0 just before and read just after -> (metrics, counts).
    ``smoke``: the SMOKE cells, to rehearse on the CPU (no kernel
    launches there; the logs then check nothing)."""
    mesh = launch_mesh.make_local_mesh()
    cut = w_cut_cells(V2_LAYERS if smoke else v1_layers(),
                      smoke)["W.2 qwen3-14b/decode_32k"]
    logs = (FMLog(), BackwardLog(), BagLog(), CsrLog())
    out = {}
    zero(nl.launches, fm.launches, bagk.launches, segk.launches)
    for arch, shape in W2_CELLS:
        bundle = launch_cells.build_cell(arch, shape, mesh, smoke=smoke)
        configs = launch_cells.configs_of(arch)
        cfg = configs.SMOKE if smoke else configs.CONFIG
        tag = f"W.2 {arch}/{shape}"
        out[tag] = w2_bundle(tag, bundle, device, recs[f"{arch}/{shape}"],
                             cfg, logs)
        print(f"[{tag}] " + json.dumps(out[tag]), flush=True)
    arch, cfg, cell = cut
    tag = "W.2 qwen3-14b/decode_32k"
    full = registry.cell_by_name(cell.name, "lm").dims["batch"]
    print(f"reduced: {tag} batch {full}->{cell.dims['batch']} (U.1's cut: "
          f"the cache at {full} is "
          f"{lm.cache_bytes(cfg, full, cell.dims['seq'])} B)", flush=True)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    out[tag] = w2_bundle(tag, launch_cells._lm_cell(arch, cfg, cell, mesh),
                         device, recs[tag], cfg, logs)
    print(f"[{tag}] " + json.dumps(out[tag]), flush=True)
    counts = kernel_counts()
    checked = {log.__class__.__name__: log.checked for log in logs}
    print("[W.2] launches: " + json.dumps(counts) + " checked against "
          "their plain versions: " + json.dumps(checked), flush=True)
    for k in ("fused_fm", "fused_fm_backward", "embedding_bag", "csr_sum"):
        if counts[k] == 0 and device.type == "cuda":
            fail(f"[W.2] {k} was not launched by the builder's bundles")
    for log in logs:
        if not log.checked and device.type == "cuda":
            fail(f"[W.2] {log.__class__.__name__} checked no launch")
    out["max_abs_err"] = {log.__class__.__name__: log.max_err
                          for log in logs}
    return out, counts


def run_phase_w3(recs, v_peaks: dict, n_v1: int, smoke=False) -> dict:
    """W.3: the dry-run's peak of V.1-V.3's cut configs beside the peaks
    phase V measured in this process and ``launch/train.lm_train_bytes``'
    estimates."""
    out = {}
    for tag, (arch, cfg, cell) in w_cut_cells(n_v1, smoke).items():
        if not tag.startswith("V."):
            continue
        ocfg = launch_cells.opt_cfg("lm", cfg)
        est = launch_train.step_peak(launch_train.lm_train_bytes(
            cfg, ocfg, 1, cell.dims["seq"]))
        dry = recs[tag]["memory"]["peak_size_in_bytes"]
        got = v_peaks.get(tag)
        out[tag] = {"config": cfg.name, "layers": cfg.n_layers,
                    "dryrun_peak_bytes": dry, "measured_peak_bytes": got,
                    "estimate_bytes": est,
                    "measured_over_dryrun": got / dry if got else None,
                    "estimate_over_dryrun": est / dry,
                    **w_roofline(recs[tag], cfg, cell)}
        print(f"[W.3] {tag} " + json.dumps(out[tag]), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase X: the sharded LM serving paths over torch.distributed
# ---------------------------------------------------------------------------
def x_paths_zero() -> None:
    for counts in (attn.DECODE_PATHS, moe.EP_PATHS):
        for k in counts:
            counts[k] = 0


def x_paths() -> dict:
    return {**attn.DECODE_PATHS, **moe.EP_PATHS}


def x_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp(
        min=1e-300)).item()


def run_phase_x1(device, smoke=False) -> dict:
    """X.1: a world of one over NCCL in this process (gloo on the CPU):
    ``_flash_decode_body`` and ``_mla_flash_body`` at one shard through
    their all-reduces, wired as ``gqa_decode`` / ``mla_decode`` wire them,
    against the one-device decode paths on the same float32 tensors
    (output and cache within ``X1_F32_TOL`` of their max); ``_moe_body``
    through the NCCL ``all_to_all`` over the group of one against the
    local body, bitwise (output, aux, dropped share)."""
    gqa_cfg = (qwen3_14b.SMOKE if smoke else qwen3_14b.CONFIG).gqa_cfg()
    mla_cfg = (deepseek_v3_671b.SMOKE if smoke
               else deepseek_v3_671b.CONFIG).mla_cfg()
    mcfg = dataclasses.replace(
        (deepseek_v3_671b.SMOKE if smoke else deepseek_v3_671b.CONFIG).moe,
        n_experts=X1_EXPERTS)
    b, seq = (2, 16) if smoke else (X1_BATCH, X1_SEQ)
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=t_rdv("x1"),
        world_size=1, rank=0)
    out = {}
    try:
        group = torch.distributed.group.WORLD
        out["exchange"] = tdist.exchange_route(group, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(X_SEED)
        pos = torch.linspace(0, seq - 1, b, device=device).to(torch.int32)
        x = torch.randn(b, 1, gqa_cfg.d_model, generator=gen, device=device)
        p = attn.gqa_init(gqa_cfg, generator=gen, device=device,
                          dtype=torch.float32)
        kv_shape = (b, seq, gqa_cfg.n_kv_heads, gqa_cfg.head_dim)
        kc, vc = (torch.randn(kv_shape, generator=gen, device=device)
                  for _ in range(2))
        with torch.no_grad():
            # each path twice (it writes the same entries again), the
            # second timed
            whole = {"k": kc.clone(), "v": vc.clone()}
            for _ in range(2):
                (y_w, _), w_host, w_ev = u_timed(
                    lambda: attn.gqa_decode(p, gqa_cfg, x, whole, pos),
                    device)
            q, k_new, v_new = attn._gqa_qkv(p, gqa_cfg, x, pos)
            h, kv, dh = gqa_cfg.n_heads, gqa_cfg.n_kv_heads, gqa_cfg.head_dim
            for _ in range(2):
                (o, kc, vc), f_host, f_ev = u_timed(
                    lambda: attn._flash_decode_body(
                        q.view(b, kv, h // kv, dh), kc, vc, k_new[:, 0],
                        v_new[:, 0], pos, group=group, index=0, smax=seq,
                        n_shards=1), device)
            y_f = o.view(b, 1, h * dh) @ p["wo"]
        out["gqa"] = {"batch": b, "positions": seq,
                      "rel_err": max(x_rel(y_f, y_w),
                                     x_rel(kc, whole["k"]),
                                     x_rel(vc, whole["v"])),
                      "body_host_ms": f_host, "body_event_ms": f_ev,
                      "whole_host_ms": w_host, "whole_event_ms": w_ev}
        del p, kc, vc, whole, o
        p = attn.mla_init(mla_cfg, generator=gen, device=device,
                          dtype=torch.float32)
        x = torch.randn(b, 1, mla_cfg.d_model, generator=gen, device=device)
        ckv = torch.randn(b, seq, mla_cfg.kv_lora, generator=gen,
                          device=device)
        kr = torch.randn(b, seq, mla_cfg.dh_rope, generator=gen,
                         device=device)
        with torch.no_grad():
            whole = {"ckv": ckv.clone(), "kr": kr.clone()}
            for _ in range(2):
                (y_w, _), w_host, w_ev = u_timed(
                    lambda: attn.mla_decode(p, mla_cfg, x, whole, pos),
                    device)
            q_abs, qr, ckv_new, kr_new = attn._mla_absorbed(p, mla_cfg, x,
                                                            pos)
            for _ in range(2):
                (ctx, ckv, kr), f_host, f_ev = u_timed(
                    lambda: attn._mla_flash_body(
                        q_abs, qr, ckv, kr, ckv_new, kr_new, pos,
                        group=group, index=0, smax=seq, n_shards=1,
                        scale=attn.mla_scale(mla_cfg)), device)
            y_f = attn._mla_out(p, mla_cfg, ctx, x.dtype)
        out["mla"] = {"batch": b, "positions": seq,
                      "rel_err": max(x_rel(y_f, y_w),
                                     x_rel(ckv, whole["ckv"]),
                                     x_rel(kr, whole["kr"])),
                      "body_host_ms": f_host, "body_event_ms": f_ev,
                      "whole_host_ms": w_host, "whole_event_ms": w_ev}
        del p, ckv, kr, whole
        mp = moe.moe_init(mcfg, generator=gen, device=device,
                          dtype=torch.bfloat16)
        xt = torch.randn(X1_TOKENS, mcfg.d_model, generator=gen,
                         device=device).to(torch.bfloat16)
        with torch.no_grad():
            for _ in range(2):
                local, l_host, l_ev = u_timed(
                    lambda: moe._moe_body(mp, xt, mcfg), device)
                exch, e_host, e_ev = u_timed(
                    lambda: moe._moe_body(mp, xt, mcfg, group), device)
        out["moe"] = {
            "experts": mcfg.n_experts, "tokens": X1_TOKENS,
            "capacity": moe.capacity(mcfg, X1_TOKENS),
            "bitwise": all(torch.equal(a, c) for a, c in zip(local, exch)),
            "dropped_share": float(local[2]),
            "exchanged_host_ms": e_host, "exchanged_event_ms": e_ev,
            "local_host_ms": l_host, "local_event_ms": l_ev}
        del mp
    finally:
        torch.distributed.destroy_process_group()
        u_free(device)
    for name in ("gqa", "mla"):
        if not out[name]["rel_err"] <= X1_F32_TOL:
            fail(f"[X.1] the {name} flash body at one shard is "
                 f"{out[name]['rel_err']} of max from the one-device "
                 f"decode (limit {X1_F32_TOL})")
    if not out["moe"]["bitwise"]:
        fail("[X.1] the MoE body through the all_to_all over a group of "
             "one differs from the local body")
    return out


def x_configs(smoke=False) -> dict:
    """X.2's two configs at published width, cut in depth."""
    if smoke:
        return {"qwen3": dataclasses.replace(qwen3_14b.SMOKE, n_layers=2),
                "deepseek": dataclasses.replace(
                    deepseek_v3_671b.SMOKE, n_layers=2, n_dense_layers=1,
                    mtp_depth=0)}
    return {"qwen3": dataclasses.replace(qwen3_14b.CONFIG,
                                         n_layers=X_Q_LAYERS),
            "deepseek": dataclasses.replace(
                deepseek_v3_671b.CONFIG, n_layers=2, n_dense_layers=1,
                mtp_depth=0)}


def x_reserved(device):
    """The most this process's allocator held from the card (blocks freed
    but kept included) since the last reset."""
    return (torch.cuda.max_memory_reserved(device) if device.type == "cuda"
            else None)


def x_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def x_decode_chain(step, params, token, pos, caches, steps, device):
    """1 + ``steps`` chained decode steps (the first a warm-up), one more
    traced for its collectives' host time -> (the tokens fed, each step's
    logits in fp32 on the host, the timed steps' host and event ms, the
    traced step's host ms and its collectives' host ms)."""
    fed, logits_all, host, ev = [], [], [], []
    for i in range(steps + 2):
        fed.append(token.clone())
        if i == steps + 1:
            with TSpans(device) as spans:
                (logits, caches), traced_ms, _ = u_timed(
                    lambda: step(params, token, pos, caches), device)
                exchange_ms = spans.take()[1]
        else:
            (logits, caches), h_ms, e_ms = u_timed(
                lambda: step(params, token, pos, caches), device)
            if i:
                host.append(h_ms)
                ev.append(e_ms)
        logits_all.append(logits.float().cpu())
        token, pos = logits.float().argmax(-1).to(token.dtype), pos + 1
    return fed, logits_all, host, ev, (traced_ms, exchange_ms)


def x2_qwen(rank, mesh, device, cfg, smoke) -> tuple[dict, dict]:
    """X.2's qwen3-14b ``decode_32k`` at this rank: its share of the
    weights (all of them: no experts) and of the launcher's request 1
    (``launch_serve.lm_request``: its slices of the caches), then the
    chained decode steps; rank 0 then decodes the same tokens over the
    whole caches in one process, on the same card, and holds every step's
    logits to the ranks' within ``U3_BF16_TOL`` of max |logit|."""
    cell = registry.cell_by_name("decode_32k", "lm")
    if smoke:
        cell = registry.reduce_cell(cell)
    b, s = (cell.dims["batch"] if smoke else X_Q_BATCH), cell.dims["seq"]
    u_reset_peak(device)
    params = lm.lm_init(cfg, seed=0, device=device, mesh=mesh)
    token, pos, caches = launch_serve.lm_request(cfg, cell, b, 1, device,
                                                 mesh)
    pos0 = pos.clone()
    x_paths_zero()
    fed, logits_all, host, ev, traced = x_decode_chain(
        serve_step.lm_decode_fn(cfg, mesh, s), params, token, pos, caches,
        X_Q_STEPS if not smoke else 2, device)
    m = {"batch": b, "positions": s, "positions_a_rank": s // mesh.size(
        "model"), "steps": len(host), "paths": x_paths(),
         "step_host_ms": host, "step_event_ms": ev,
         "step_ms_p50": float(np.percentile(ev if ev[0] is not None
                                            else host, 50)),
         "traced_step_host_ms": traced[0],
         "traced_exchange_host_ms": traced[1],
         "exchange_share": traced[1] / traced[0],
         "weight_bytes": x_bytes(params.values()),
         "cache_bytes": x_bytes(t for e in caches.values()
                                for t in e.values()),
         "peak_bytes": max_memory(device),
         "peak_reserved_bytes": x_reserved(device),
         "finite": all(bool(l.isfinite().all()) for l in logits_all)}
    del caches
    u_free(device)
    if rank == 0:
        whole_token, whole_pos, whole = launch_serve.lm_request(
            cfg, cell, b, 1, device)
        if not torch.equal(whole_pos, pos0):
            fail("[X.2] the one-process request's positions differ")
        one = serve_step.lm_decode_fn(cfg)
        errs, host1, ev1 = [], [], []
        p = whole_pos
        for i, tok in enumerate(fed):
            (got, whole), h_ms, e_ms = u_timed(
                lambda: one(params, tok, p, whole), device)
            if i:
                host1.append(h_ms)
                ev1.append(e_ms)
            want = logits_all[i]
            errs.append(((got.float().cpu() - want).abs().max()
                         / want.abs().max()).item())
            p = p + 1
        m["one_process"] = {
            "step_host_ms": host1, "step_event_ms": ev1,
            "step_ms_p50": float(np.percentile(
                ev1 if ev1[0] is not None else host1, 50)),
            "rel_err": errs, "cache_bytes": x_bytes(
                t for e in whole.values() for t in e.values())}
        del whole
    del params
    u_free(device)
    m["logits_digest"] = digest(torch.stack(logits_all).numpy())
    return m, {}


def x_tap_arrays(taps, prefix) -> dict:
    """MoE taps (tokens, output, dropped share) as host arrays, bf16 by its
    bits."""
    out = {}
    for i, (x, y, dropped) in enumerate(taps):
        for name, t in (("x", x), ("y", y)):
            t = t.detach().cpu()
            out[f"{prefix}{i}_{name}"] = (t.view(torch.int16) if t.dtype ==
                                          torch.bfloat16 else t).numpy()
        out[f"{prefix}{i}_dropped"] = np.array(float(dropped), np.float32)
    return out


def x2_deepseek(rank, mesh, device, cfg, smoke) -> tuple[dict, dict]:
    """X.2's deepseek-v3-671b at this rank: its share of the weights (64 of
    the 256 experts), a prefill of ``X_D_PROMPT`` tokens (the MoE's
    sequence split over the 4 ranks) into its slices of caches of
    ``X_D_PROMPT + X_D_STEPS`` positions, then ``X_D_STEPS`` chained decode
    steps (the flash body, the MoE over the whole batch); every MoE tap
    saved for the parent's check."""
    prompt = 32 if smoke else X_D_PROMPT
    cache_len = prompt + X_D_STEPS
    u_reset_peak(device)
    params = lm.lm_init(cfg, seed=0, device=device, mesh=mesh)
    tokens = u_tokens(cfg, (1, prompt), 1, device)
    taps = []
    x_paths_zero()
    with torch.no_grad():
        (logits, caches), pre_host, pre_ev = u_timed(
            lambda: lm.lm_prefill(params, cfg, tokens, cache_len, mesh,
                                  taps), device)
        finite = bool(logits.isfinite().all())
        token = logits.float().argmax(-1).to(torch.int32)
        pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
        host, ev, dec_taps = [], [], []
        for _ in range(X_D_STEPS):
            (logits, caches), h_ms, e_ms = u_timed(
                lambda: lm.lm_decode_step(params, cfg, token, pos, caches,
                                          mesh, cache_len, dec_taps),
                device)
            host.append(h_ms)
            ev.append(e_ms)
            finite = finite and bool(logits.isfinite().all())
            token, pos = logits.float().argmax(-1).to(torch.int32), pos + 1
    m = {"prompt": prompt, "cache_positions": cache_len,
         "positions_a_rank": cache_len // mesh.size("model"),
         "moe_tokens_a_rank_prefill": int(taps[0][0].shape[0]),
         "paths": x_paths(), "prefill_host_ms": pre_host,
         "prefill_event_ms": pre_ev, "step_host_ms": host,
         "step_event_ms": ev, "weight_bytes": x_bytes(params.values()),
         "cache_bytes": x_bytes(t for e in caches.values()
                                for t in e.values()),
         "peak_bytes": max_memory(device),
         "peak_reserved_bytes": x_reserved(device), "finite": finite,
         "prefill_dropped_share": float(taps[0][2])}
    arrays = {**x_tap_arrays(taps, "prefill"),
              **x_tap_arrays(dec_taps, "decode")}
    del params, caches, taps, dec_taps
    u_free(device)
    return m, arrays


def x_rank(rank, world, rdv, device_type, smoke):
    """One X.2 rank, spawned: gloo over card 0 (the CPU in a rehearsal),
    ``make_mesh(model=world)``, qwen3-14b's decode then deepseek-v3's
    prefill and decode; its metrics and arrays under ``X_DIR``."""
    device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    t0 = time.perf_counter()
    torch.distributed.init_process_group(
        "gloo", init_method=rdv, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=X_TIMEOUT_S))
    out, arrays = {"start_seconds": time.perf_counter() - t0}, {}
    try:
        mesh = launch_mesh.make_mesh(model=world)
        out["exchange"] = tdist.exchange_route(mesh.model_group, device)
        cfgs = x_configs(smoke)
        for tag, run in (("qwen3", x2_qwen), ("deepseek", x2_deepseek)):
            # every rank's last run freed before any draws the next
            torch.distributed.barrier()
            t1 = time.perf_counter()
            out[tag], a = run(rank, mesh, device, cfgs[tag], smoke)
            out[tag]["seconds"] = time.perf_counter() - t1
            arrays.update({f"{tag}_{k}": v for k, v in a.items()})
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(X_DIR, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(X_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def x_spawn(device, smoke) -> tuple:
    """``X_WORLD`` ranks (``x_rank``, ``run_world``) -> each rank's
    (metrics, arrays) and the card's peak use across all processes."""
    peak = run_world("X.2", x_rank, (X_WORLD, t_rdv("x2"), device.type,
                                     smoke), X_WORLD, X_TIMEOUT_S, device)
    outs = []
    for r in range(X_WORLD):
        with np.load(os.path.join(X_DIR, f"rank{r}.npz")) as f:
            arrays = dict(f)
        with open(os.path.join(X_DIR, f"rank{r}.json")) as f:
            outs.append((json.load(f), arrays))
    return outs, peak


def x_tap(arrays, prefix, i, device):
    def t(name):
        a = torch.from_numpy(arrays[f"{prefix}{i}_{name}"])
        return (a.view(torch.bfloat16) if a.dtype == torch.int16
                else a).to(device)
    return t("x"), t("y"), float(arrays[f"{prefix}{i}_dropped"])


def check_x2(outs, device, cfgs, smoke) -> dict:
    """After the ranks: every layer on the sharded path, the qwen3 ranks'
    logits equal and within ``U3_BF16_TOL`` of the one-process decode;
    then deepseek-v3 whole (this process, the ranks gone) at the same
    seed: each rank's MoE answers against the local ``_moe_body`` over its
    tokens (the same capacity) within ``U_MOE_TOL`` normwise, their
    dropped shares equal, and the prefill taps through ``moe_check`` (the
    dropped share against a numpy recount, tokens against float64)."""
    q_cfg, d_cfg = cfgs["qwen3"], cfgs["deepseek"]
    m = {}
    for r, (o, _) in enumerate(outs):
        q, d = o["qwen3"], o["deepseek"]
        want_q = {"flash": (q["steps"] + 2) * q_cfg.n_layers, "whole": 0,
                  "expert_parallel": 0, "local": 0}
        steps_d = len(d["step_host_ms"])
        want_d = {"flash": steps_d * d_cfg.n_layers, "whole": 0,
                  "expert_parallel": (steps_d + 1) * d_cfg.n_moe_layers,
                  "local": 0}
        for name, got, want in (("qwen3-14b", q["paths"], want_q),
                                ("deepseek-v3", d["paths"], want_d)):
            if got != want:
                fail(f"[X.2] rank {r} {name}: the layers took {got}; every "
                     f"one must take the sharded path: {want}")
        if not (q["finite"] and d["finite"]):
            fail(f"[X.2] rank {r}: a logit is not finite")
    for r, (o, _) in enumerate(outs[1:], 1):
        if o["qwen3"]["logits_digest"] != outs[0][0]["qwen3"]["logits_digest"]:
            fail(f"[X.2] rank {r}'s qwen3 logits differ from rank 0's")
    one = outs[0][0]["qwen3"]["one_process"]
    if not max(one["rel_err"]) <= U3_BF16_TOL:
        fail(f"[X.2] qwen3-14b's decode over 4 ranks is {max(one['rel_err'])}"
             f" of max |logit| from the one-process decode (limit "
             f"{U3_BF16_TOL})")
    m["qwen3_rel_err_max"] = max(one["rel_err"])
    u_free(device)
    t0 = time.perf_counter()
    whole = lm.lm_init(d_cfg, seed=0, device=device)
    mp = cm.sub(lm.layer_view(whole, "moe_layers", 0), "moe")
    checks = []
    with torch.no_grad():
        for r, (_, a) in enumerate(outs):
            for prefix in ("deepseek_prefill", "deepseek_decode"):
                n = sum(1 for k in a if k.startswith(prefix)
                        and k.endswith("_dropped"))
                for i in range(n):
                    x, y, dropped = x_tap(a, prefix, i, device)
                    want, _, want_drop = moe._moe_body(mp, x, d_cfg.moe)
                    diff = (y.double() - want.double()).norm(dim=-1)
                    den = want.double().norm(dim=-1)
                    rel = torch.where(den > 0, diff / den.clamp(
                        min=1e-300), diff).max().item()
                    row = {"rank": r, "tap": f"{prefix}{i}",
                           "tokens": int(x.shape[0]),
                           "capacity": moe.capacity(d_cfg.moe, x.shape[0]),
                           "dropped_share": dropped,
                           "local_dropped_share": float(want_drop),
                           "max_normwise_err_vs_local": rel,
                           "bitwise_local": bool(torch.equal(y, want))}
                    if prefix.endswith("prefill"):
                        row["f64"] = moe_check(
                            whole, d_cfg, (x, y, torch.tensor(dropped)),
                            device, tag=f"X.2 rank {r}",
                            n_check=64 if smoke else U_MOE_CHECK_TOKENS)
                    if dropped != float(want_drop):
                        fail(f"[X.2] rank {r} {prefix}{i}: dropped "
                             f"{dropped}, the local body {float(want_drop)}")
                    if not rel <= U_MOE_TOL:
                        fail(f"[X.2] rank {r} {prefix}{i}: the expert-"
                             f"parallel MoE is {rel} (normwise) from the "
                             f"local body (limit {U_MOE_TOL})")
                    checks.append(row)
    decode = [c for c in checks if "decode" in c["tap"]]
    m["moe_checks"] = [c for c in checks if "prefill" in c["tap"]]
    m["moe_decode_checks"] = {
        "taps": len(decode), "bitwise_local": sum(c["bitwise_local"]
                                                  for c in decode),
        "max_normwise_err_vs_local": max(c["max_normwise_err_vs_local"]
                                         for c in decode),
        "dropped_shares": sorted({c["dropped_share"] for c in decode})}
    m["whole_check_seconds"] = time.perf_counter() - t0
    m["whole_weight_bytes"] = x_bytes(whole.values())
    del whole, mp
    u_free(device)
    return m


def run_phase_x(device, smoke=False) -> dict:
    """X.1 here, then X.2 in ``X_WORLD`` spawned gloo ranks on the card
    and its checks -> metrics."""
    shutil.rmtree(X_DIR, ignore_errors=True)
    os.makedirs(X_DIR, exist_ok=True)
    cfgs = x_configs(smoke)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    out = {}
    try:
        t0 = time.perf_counter()
        out["X.1"] = run_phase_x1(device, smoke)
        out["X.1"]["seconds"] = time.perf_counter() - t0
        print("[X.1] " + json.dumps(out["X.1"]), flush=True)
        held = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else None
        t0 = time.perf_counter()
        outs, peak = x_spawn(device, smoke)
        ranks_s = time.perf_counter() - t0
        for r, (o, _) in enumerate(outs):
            print(f"[X.2] rank {r} " + json.dumps(o), flush=True)
        print("[X.2] " + json.dumps({
            "ranks_seconds": ranks_s, "peak_bytes_all_processes": peak,
            "parent_allocated_bytes": held}), flush=True)
        if peak is not None and peak >= U_PEAK_BYTES:
            fail(f"[X.2] the card's peak {peak} B is over {U_PEAK_BYTES}")
        t0 = time.perf_counter()
        m = check_x2(outs, device, cfgs, smoke)
        m.update(ranks_seconds=ranks_s, peak_bytes_all_processes=peak,
                 check_seconds=time.perf_counter() - t0)
        out["X.2"] = m
        print("[X.2] " + json.dumps(m), flush=True)
        q = outs[0][0]["qwen3"]
        print("[X.2] qwen3-14b decode_32k step p50: " + json.dumps({
            "four_ranks_ms": q["step_ms_p50"],
            "one_process_ms": q["one_process"]["step_ms_p50"],
            "exchange_share_of_traced_step": q["exchange_share"]}),
            flush=True)
    finally:
        shutil.rmtree(X_DIR, ignore_errors=True)
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
    w1 = start_w1()                    # W.1's dry-run, beside the card's

    n_a, emb_a = T_KEYS, 200_000
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
    builds_t = start_t_builds()        # phase T's, once N's are in
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
    print(f"reduced: phase O queries 1000->{O_QUERIES} a run (the script's "
          f"time limit; phase T came after it)")
    print(f"reduced: phase O keys {CONFIG.n_items}->{O_KEYS}, embedding rows "
          f"{CONFIG.n_items}->{O_EMB_ROWS}: each ClusterSim builds its own "
          f"engine, and the host builder took 60.3 s at 4M keys; 2^20 keys "
          f"took 130 s of builds in all on a slow host, with phase V the "
          f"script's time limit")
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

    # T: the sharded batch query over torch.distributed (T.1 NCCL world 1
    # here; T.2, T.3 four gloo ranks on the card), then two-tower's user
    # tower from four ranks' row blocks; counts zeroed in each process just
    # before its run
    gc.collect()
    torch.cuda.empty_cache()
    t_s = time.perf_counter()
    with LaunchLog() as log_t:
        m_t, t_probes, t_probe_err, t_bag, t_bag_err = run_phase_t(
            device, builds_t, log_t)
    print(f"[T] took {time.perf_counter() - t_s:.1f} s; launches "
          + json.dumps({**t_probes, "embedding_bag": t_bag}), flush=True)
    if not t_probes["probe_lines"] + t_probes["probe_smem"]:
        fail("no probe kernel was launched in phase T")
    for row in kernels[:2]:
        row["launches"] += t_probes[row["name"]]
        row["sharded"] = {"launches": t_probes[row["name"]]}
        row["max_abs_err"] = max(row["max_abs_err"], t_probe_err)
    bag_row["launches"] += t_bag
    bag_row["sharded"] = {"launches": t_bag, "max_abs_err": t_bag_err}
    bag_row["max_abs_err"] = max(bag_row["max_abs_err"], t_bag_err)

    # U: LM serving, qwen3-14b whole and deepseek-v3-671b at published
    # width; no kernel of the four
    print(f"reduced: U.1 prefill_32k batch 32->{U_PREFILL_BATCH}, "
          f"{U_PREFILL_REQUESTS} timed requests (fp32 scores of one query "
          f"chunk are 2.7 GB a sequence; the script's time limit)")
    print(f"reduced: U.1 decode_32k batch 128->{U1_DECODE_BATCHES[0]} (the "
          f"cache at 128 is {lm.cache_bytes(qwen3_14b.CONFIG, 128, 32768)} "
          f"B)")
    print(f"reduced: U.1 long_500k not run: its cache alone is "
          f"{lm.cache_bytes(qwen3_14b.CONFIG, 1, 524288)} B")
    print(f"reduced: U.2 deepseek-v3-671b layers 61->{U2_LAYERS} (3 dense, "
          f"1 MoE, the MTP block), prefill_32k batch 32->"
          f"{U_PREFILL_BATCH}, {U_PREFILL_REQUESTS} timed requests")
    u_free(device)
    zero(nl.launches, fm.launches, bagk.launches, segk.launches)
    t_u = time.perf_counter()
    m_u = run_phase_u(device)
    u_counts = kernel_counts()
    print(f"[U] took {time.perf_counter() - t_u:.1f} s; launches "
          + json.dumps(u_counts), flush=True)
    if any(u_counts.values()):
        fail(f"phase U launched a kernel: {u_counts}")
    del m_u

    # V: LM training, qwen3-14b, deepseek-v3's dense layers and MTP,
    # qwen3-moe's MoE layers at published width; no kernel of the four
    n_v1 = v1_layers()
    print(f"reduced: V train_4k batch 256->1, {V_STEPS} timed steps (the "
          f"script's time limit)")
    whole = launch_train.step_peak(launch_train.lm_train_bytes(
        qwen3_14b.CONFIG, launch_cells.opt_cfg("lm", qwen3_14b.CONFIG), 1,
        V_SEQ))
    print(f"reduced: V.1 qwen3-14b layers 40->{n_v1} (the most whose step "
          f"launch/train.lm_train_bytes puts under {V1_PEAK_TARGET} B; "
          f"whole, it puts the step at {whole} B)")
    print(f"reduced: V.2 deepseek-v3-671b layers 61->{V2_LAYERS} (its dense "
          f"layers and the MTP block; one MoE layer of 256 experts is "
          f"11.3B parameters, ~68 GB trained)")
    print(f"reduced: V.3 qwen3-moe-235b-a22b layers 94->{V3_LAYERS} (MoE)")
    u_free(device)
    zero(nl.launches, fm.launches, bagk.launches, segk.launches)
    t_v = time.perf_counter()
    m_v = run_phase_v(device)
    v_counts = kernel_counts()
    print(f"[V] took {time.perf_counter() - t_v:.1f} s; launches "
          + json.dumps(v_counts), flush=True)
    if any(v_counts.values()):
        fail(f"phase V launched a kernel: {v_counts}")
    v_peaks = {tag: m_v[tag]["peak_bytes"] for tag in ("V.1", "V.2", "V.3")}
    del m_v

    # W: the dry-run of every cell (W.1, joined here), the builder's
    # bundles on the card through fused_fm, its gradient, embedding_bag
    # and csr_sum (W.2), the dry-run's peaks beside V's (W.3)
    u_free(device)
    t_w = time.perf_counter()
    recs = run_phase_w1(*w1, n_v1)
    m_w2, w_counts = run_phase_w2(device, recs)
    m_w3 = run_phase_w3(recs, v_peaks, n_v1)
    print(f"[W] took {time.perf_counter() - t_w:.1f} s (W.1's wait "
          f"included); launches " + json.dumps(w_counts), flush=True)
    by_name = {row["name"]: row for row in kernels}
    for name, log in (("fused_fm", "FMLog"),
                      ("fused_fm_backward", "BackwardLog"),
                      ("embedding_bag", "BagLog"), ("csr_sum", "CsrLog")):
        row, err = by_name[name], m_w2["max_abs_err"][log]
        row["launches"] += w_counts[name]
        row["cell_bundles"] = {"launches": w_counts[name],
                               "max_abs_err": err}
        row["max_abs_err"] = max(row["max_abs_err"], err)
    del recs, m_w2, m_w3

    # X: the sharded LM serving paths over torch.distributed, X.1 NCCL at
    # world 1 here, X.2 four gloo ranks on the card; no kernel of the four
    cfgs = x_configs()
    print(f"reduced: X.1 deepseek-v3's MoE experts 256->{X1_EXPERTS} (a "
          f"world of one holds every expert); the flash bodies at batch "
          f"{X1_BATCH} over {X1_SEQ} positions in float32")
    print(f"reduced: X.2 qwen3-14b layers 40->{X_Q_LAYERS}, decode_32k batch "
          f"128->{X_Q_BATCH} (U.1's): "
          f"{lm.param_bytes(cfgs['qwen3'])} B of weights and "
          f"{lm.cache_bytes(cfgs['qwen3'], X_Q_BATCH, 32768)} B of cache, a "
          f"quarter of the cache a rank")
    print(f"reduced: X.2 deepseek-v3-671b layers 61->2 (1 dense, 1 MoE of "
          f"256 experts, 64 a rank), no MTP block (serving does not run "
          f"it): {lm.param_bytes(cfgs['deepseek'])} B whole; a prefill of "
          f"{X_D_PROMPT} tokens at batch 1 (prefill_32k: 32 x 32768) and "
          f"{X_D_STEPS} decode steps")
    u_free(device)
    zero(nl.launches, fm.launches, bagk.launches, segk.launches)
    t_x = time.perf_counter()
    run_phase_x(device)
    x_counts = kernel_counts()
    print(f"[X] took {time.perf_counter() - t_x:.1f} s; launches "
          + json.dumps(x_counts), flush=True)
    if any(x_counts.values()):
        fail(f"phase X launched a kernel: {x_counts}")

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
