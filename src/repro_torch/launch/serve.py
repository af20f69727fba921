"""Serving launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch din|bst|two-tower-retrieval|deepfm \
        [--shape serve_p99|serve_bulk|retrieval_cand] [--smoke] \
        [--requests 20] [--batch ROWS] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm \
        --feature-server [--clients 8] [--prefetch-clients 2] [--smoke] \
        [--requests 20] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch graphsage-reddit [--shape molecule|full_graph_sm|...] \
        [--smoke] [--requests 20] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-14b|deepseek-7b|nemotron-4-340b|deepseek-v3-671b|\
qwen3-moe-235b-a22b [--shape decode_32k|prefill_32k|long_500k|train_4k] \
        [--smoke] [--requests 20] [--batch SEQUENCES] [--device cuda|cpu] \
        [--model-ranks N]

Builds the model at its published width (the arch's ``CONFIG`` in
``configs/``; ``--smoke`` takes ``SMOKE`` and the cell at
``registry.reduce_cell``'s size) with random weights from a seed
and answers ``--requests`` synthetic requests of the ``--shape`` cell
(``configs/registry.REC_CELLS``, default ``serve_p99``), one client in
sequence, printing the request latency's p50 and p99.

* ``serve_p99`` and ``serve_bulk`` score a batch of the cell's rows
  (``--batch`` overrides them) through ``serve_step.recsys_score_fn``:
  ``deepfm`` scores CTR behind the ported ``FeatureClient``, over a feature
  engine built as the JAX package's launcher builds it for its feature
  server (the ``bili-feature-store-smoke`` item count and shard size;
  ``item_feats``: 8 float32 per item, ``item_pop``: a scalar per item,
  keyed by ``item_id = sparse_ids[:, 0] % n_items + 1``);
  ``two-tower-retrieval`` serves the user tower with no feature source, as
  the JAX launcher's cell does for this arch: each request's answer is its
  L2-normalised user vectors.  ``din`` and ``bst`` score CTR with no
  feature source either (their batches have no ``sparse_ids`` to key a
  feature lookup), as the JAX cell does.
* ``retrieval_cand`` ranks the cell's candidates for one user and answers
  the top 100 (at most the candidates), with no feature source, as the JAX
  launcher's ``build_cell`` does: two-tower through
  ``serve_step.retrieval_fn`` (one user's columns, zipf candidate items and
  categories); DeepFM, DIN and BST through ``serve_step.bulk_rank_fn`` (a
  batch of candidate rows from ``synthetic.recsys_batch``, each with its
  own history; DIN's and BST's forward runs on slices of 262,144 rows).
* ``train_batch`` exits, pointing to the train launcher
  (``python -m repro_torch.launch.train``).
* ``graphsage-reddit`` runs its cell's train step for each request, as
  the JAX launcher does: the ``--shape`` cell's (default ``molecule``;
  ``configs/registry.GNN_CELLS``) bundle from ``launch/cells.build_cell``
  at the local mesh, its arguments from ``materialize_bundle`` (seed 0:
  the base parameters, zero optimizer state, step 0; the warm-up runs
  them), and request i's optimizer state, step and batch random arrays of
  the bundle's shapes from ``materialize`` with seed ``i + 1`` (integers
  below the cell's classes), the JAX launcher's draws bit for bit
  (``gnn_request``), uploaded before the request is timed; each request
  runs from the base parameters.  The latency is the step and the wait
  for its loss on the host (the drawn state holds negative second
  moments, so only the loss is checked).

An LM arch (``configs/registry.LM_ARCHS``) serves its ``--shape`` cell
(``configs/registry.LM_CELLS``, default ``decode_32k``) as the JAX
launcher does, with weights from ``lm.lm_init`` (seed 0) and each request
drawn by ``launch/materialize.py`` with seed ``i + 1`` for request i (the
warm-up's with seed 0): ``prefill_32k`` a [B, S] prompt of random tokens
through ``serve_step.lm_prefill_fn`` (its last position's logits);
``decode_32k`` and ``long_500k`` one decode step of ``lm_decode_fn``
over random tokens, positions and caches [L, B, S, ...].  ``--batch``
sets B, the sequences a request.  The caches are ``materialize``'s, the
JAX package's draws bit for bit, up to ``HOST_DRAW_ELEMENTS`` values; a
larger cache (42.9 GB at qwen3-14b's ``decode_32k`` at B = 8) is drawn
on the device instead, N(0, 0.02) from a generator seeded ``i + 1``
there, since numpy would take minutes a request.  Before it allocates
anything the launcher reckons the weights, the caches and the attention's
working set in bytes (``lm_bytes``); on the card it exits if they pass
the free memory, naming them and the largest ``--batch`` that fits.  On
the card bf16 products accumulate in fp32
(``allow_bf16_reduced_precision_reduction`` off), as XLA's do.
``train_4k`` runs the train step as its requests, as the JAX launcher
does: each request one step of ``make_train_step(lm_loss_fn(cfg),
cells.opt_cfg("lm", cfg))`` (the functional update: every request starts
from the same parameters, the train launcher's ``lm_params``: the JAX
launcher's ``materialize`` from seed 0, or ``lm_init`` seed 0 on the
device for a larger model) on its optimizer state,
step and tokens, ``materialize``'d with seed ``i + 1`` as the JAX cell
builder shapes them (tokens in [0, 8)); an optimizer state of more than
``HOST_DRAW_ELEMENTS`` values is drawn N(0, 0.02) on the device from a
generator seeded ``i + 1`` there, its step and tokens then from
``np.random.default_rng(i + 1)`` alone.  The answer waited for is the
step's loss; the drawn state holds negative second moments, so the
updated parameters may not be finite (as the JAX launcher's), and only
the loss is checked.  On the card it exits when the step's bytes
(``launch/train.lm_train_bytes`` and a second copy of the parameters and
state) pass the free memory.  It prints the request p50 and p99 and
tokens a second.

``--model-ranks N`` serves an LM's prefill or decode cell from N rank
processes (spawned; a ``file://`` rendezvous in a temporary directory)
at ``launch/mesh.make_mesh(model=N)``, in place of the reference's
production mesh: each rank draws its share of the same weights
(``lm.lm_init(..., mesh=)``: E / N experts of each MoE stack) and of each
request (its slices of the caches, the sequence split over the N ranks
where they divide it), and runs the sharded paths (the flash-decode's
combine and the MoE's ``all_to_all`` over the ``model`` group).  On the
CPU the ranks talk over gloo; on the card over NCCL where each rank has a
card of its own, else over gloo staged through the host, every rank on
card 0.  Each rank prints its line; the launcher returns rank 0's
numbers, ``finite`` over every rank's.  ``train_4k`` at N ranks is
refused: training through the expert-parallel exchange is ROADMAP queue
1, item 15.4.

``--feature-server`` serves the feature lookups through the ported
``QueryServer``, as the JAX launcher's feature-server mode does: over the
same feature engine, ``--clients`` threads each score ``--requests``
batches of the ``--shape`` cell's rows (``--batch`` overrides them)
whose lookups ride the RANKING lane of a ``FeatureClient(server,
default_budget_s=2.0)`` and coalesce with the other clients' into
micro-batches of at most 4096 keys; ``--prefetch-clients`` threads send
256 uniform ids at a time on the PREFETCH lane (0.5 s budget, shed
requests dropped); an ``item_pop`` delta (version 2, 64 keys) is
published while they run, after one warm-up request and a reset of the
server's stats.  It prints the request p50 and p99, the shed count,
rows/s and the server's ``StatsSnapshot.summary()``.  Only an arch whose
batches carry ``sparse_ids`` to key the lookup (DeepFM) takes it.

The model (and the probe) run on ``--device`` (default ``cuda``; there is
no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.api.backends import EngineBackend
from repro_torch.api.client import FeatureClient
from repro_torch.configs import bili_feature_store, registry
from repro_torch.core import distributed as tdist
from repro_torch.core import hashcore as hc
from repro_torch.core.engine import (EmbeddingTable, MultiTableEngine,
                                     ScalarTable)
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import cells
from repro_torch.launch import materialize as mat
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as launch_train
from repro_torch.launch.materialize import materialize
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step
from repro_torch.serve.scheduler import BatchPolicy, ShedError
from repro_torch.serve.server import QueryServer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

FEATURE_FIELDS = (("item_feats", "item_id"), ("item_pop", "item_id"))
TOP_K = 100
SERVER_BATCH_KEYS = 4096       # the feature server's micro-batch key budget
SCORING_BUDGET_S = 2.0         # a scoring request's lookup budget
PREFETCH_IDS, PREFETCH_BUDGET_S = 256, 0.5
DELTA_KEYS = 64
HOST_DRAW_ELEMENTS = 1 << 26    # a larger LM cache is drawn on the device


def feature_engine(n_items: int, max_shard_bytes: int, *, device):
    """-> (engine, keys, feats, pop): ``item_pop`` (scalar) and
    ``item_feats`` (8 float32 per item) over keys 1..n_items."""
    rng = np.random.default_rng(0)
    keys = np.arange(1, n_items + 1, dtype=np.uint64)
    feats = rng.normal(size=(n_items, 8)).astype(np.float32)
    pop = rng.integers(0, 1 << 20, n_items).astype(np.uint64)
    engine = MultiTableEngine(
        [ScalarTable("item_pop", keys, pop)],
        [EmbeddingTable("item_feats", keys,
                        feats.view(np.uint8).reshape(n_items, -1),
                        hot_fraction=0.25)],
        max_shard_bytes=max_shard_bytes,
        buckets_per_line=hc.GPU_BUCKETS_PER_LINE, version=1, device=device)
    return engine, keys, feats, pop


def request_batch(rng: np.random.Generator, cfg, rows: int,
                  n_items: int) -> dict:
    """One scoring request: a synthetic DeepFM batch plus its ``item_id``
    feature key."""
    batch = synthetic.recsys_batch(rng, cfg, rows)
    batch["item_id"] = (batch["sparse_ids"][:, 0].astype(np.int64)
                        % n_items + 1)
    return batch


def cell_requests(cfg, cell: registry.Cell, rows: int, model):
    """-> (step, draw): ``draw(rng)`` makes one request of ``cell`` (the
    step's arguments, on the host) and ``step(*args)`` answers it on the
    model's device."""
    if cell.kind == "rec_retrieval":
        n = cell.dims["n_candidates"]
        k = min(TOP_K, n)
        if cfg.arch == "two_tower":
            def draw(rng):
                user = synthetic.recsys_batch(rng, cfg, cell.dims["batch"])
                for col in ("item_id", "item_cat"):
                    user.pop(col)
                return (user, synthetic.zipf_ids(rng, cfg.item_vocab, n),
                        synthetic.zipf_ids(rng, cfg.cat_vocab, n))
            return serve_step.retrieval_fn(cfg, model, top_k=k), draw

        def draw(rng):
            batch = synthetic.recsys_batch(rng, cfg, n)
            batch.pop("label")
            return (batch,)
        return serve_step.bulk_rank_fn(cfg, model, top_k=k), draw
    if cfg.arch == "deepfm":
        fs = bili_feature_store.SMOKE
        engine, *_ = feature_engine(fs.n_items, fs.max_shard_bytes,
                                    device=model.device)
        step = serve_step.recsys_score_fn(
            cfg, model, feature_client=FeatureClient(EngineBackend(engine)),
            feature_fields=FEATURE_FIELDS)
        return step, lambda rng: (request_batch(rng, cfg, rows,
                                                fs.n_items),)
    return (serve_step.recsys_score_fn(cfg, model),
            lambda rng: (synthetic.recsys_batch(rng, cfg, rows),))


def concurrent_traffic(step, session, draw, *, clients: int, requests: int,
                       prefetch_clients: int, n_items: int, publish=None,
                       on_answer=None):
    """``clients`` threads at once, each scoring ``requests`` batches
    ``draw(rng)`` through ``step`` (its own generator, seeded by the
    client's number, so two calls draw the same requests), beside
    ``prefetch_clients`` threads that look up PREFETCH_IDS uniform item ids
    at a time on the PREFETCH lane of ``session`` until the scoring clients
    are done.  ``publish()`` runs on
    the calling thread once every thread has started; ``on_answer(batch,
    probs, ms)`` sees each scored request on its client's thread.  A
    request the server sheds counts in ``shed``; any other error in any
    thread is raised here once every thread has been joined.  -> (request
    latencies in ms, shed count, wall seconds of the scoring clients)."""
    lat, shed, errors = [], [0], []
    lock = threading.Lock()
    scoring_done = threading.Event()

    def scoring(cid):
        rng = np.random.default_rng(100 + cid)
        for _ in range(requests):
            batch = draw(rng)
            t0 = time.perf_counter()
            try:
                probs = step(batch)
                probs.cpu()                     # waits for the card
            except ShedError:
                with lock:
                    shed[0] += 1
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(ms)
            if on_answer is not None:
                on_answer(batch, probs, ms)

    def prefetch(pid):
        rng = np.random.default_rng(900 + pid)
        while not scoring_done.is_set():
            ids = rng.integers(1, n_items + 1, PREFETCH_IDS).astype(np.uint64)
            try:
                session.query({"item_feats": ids}, qos="PREFETCH",
                              budget_s=PREFETCH_BUDGET_S)
            except ShedError:
                pass

    def guarded(fn, i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — raised after the joins
            with lock:
                errors.append(e)

    scorers = [threading.Thread(target=guarded, args=(scoring, c))
               for c in range(clients)]
    fetchers = [threading.Thread(target=guarded, args=(prefetch, p))
                for p in range(prefetch_clients)]
    t0 = time.perf_counter()
    for t in scorers + fetchers:
        t.start()
    try:
        if publish is not None:
            publish()
    finally:
        for t in scorers:
            t.join()
        wall = time.perf_counter() - t0
        scoring_done.set()
        for t in fetchers:
            t.join()
    if errors:
        raise errors[0]
    return lat, shed[0], wall


def serve_with_feature_server(cfg, model, cell: registry.Cell, *, rows: int,
                              clients: int, requests: int,
                              prefetch_clients: int) -> dict:
    """DeepFM behind the ported ``QueryServer`` over the launcher's feature
    engine (the module docstring's ``--feature-server``)."""
    fs = bili_feature_store.SMOKE
    engine, keys, _, pop = feature_engine(fs.n_items, fs.max_shard_bytes,
                                          device=model.device)
    server = QueryServer(engine, BatchPolicy(max_batch_keys=SERVER_BATCH_KEYS))
    finite = [True]
    try:
        session = FeatureClient(server, default_budget_s=SCORING_BUDGET_S)
        step = serve_step.recsys_score_fn(
            cfg, model, feature_client=session,
            feature_budget_s=SCORING_BUDGET_S, feature_fields=FEATURE_FIELDS)

        def draw(rng):
            return request_batch(rng, cfg, rows, fs.n_items)

        def publish():
            session.update(2, upserts={"item_pop": (
                keys[:DELTA_KEYS], pop[:DELTA_KEYS] + np.uint64(1))})

        def on_answer(batch, probs, ms):
            if not bool(probs.isfinite().all()):
                finite[0] = False

        step(draw(np.random.default_rng(99))).cpu()         # warm-up
        server.reset_stats()
        lat, shed, wall = concurrent_traffic(
            step, session, draw, clients=clients, requests=requests,
            prefetch_clients=prefetch_clients, n_items=fs.n_items,
            publish=publish, on_answer=on_answer)
        snap = server.stats_snapshot()
    finally:
        server.close()
    res = {"device": str(model.device), "rows": rows, "scored": len(lat),
           "shed": shed, "rows_per_s": rows * len(lat) / wall,
           "p50_ms": float(np.percentile(lat, 50)) if lat else float("nan"),
           "p99_ms": float(np.percentile(lat, 99)) if lat else float("nan"),
           "versions_served": sorted(engine.stats.versions_served),
           "finite": finite[0], "server": snap}
    lat_line = (f"p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms"
                if lat else "no requests served")
    print(f"{cfg.name}/{cell.name}/feature-server: {clients} clients x "
          f"{requests} requests of {rows} rows on {model.device}, "
          f"{lat_line} shed={shed} rows/s={res['rows_per_s']:.0f}")
    print(f"  server: {snap.summary()}")
    return res


def gnn_request(bundle, i: int, device) -> tuple:
    """Request ``i``'s arguments after the parameters (optimizer state,
    step, batch) of a GNN cell's bundle, as the JAX launcher draws them:
    ``materialize`` of their shapes with seed ``i + 1``."""
    return materialize(tuple(bundle.args[1:]), seed=i + 1,
                       int_high=bundle.meta.get("int_high"), device=device)


def serve_gnn(arch: str, shape: str, *, smoke: bool, requests: int,
              device) -> dict:
    """``requests`` runs of the GNN cell ``shape``'s train step from the
    same base parameters (the module docstring says how): p50 / p99 ms."""
    bundle = cells.build_cell(arch, shape, mesh_mod.make_local_mesh(),
                              smoke=smoke)
    base = mat.materialize_bundle(bundle, seed=0, device=device)
    configs = cells.configs_of(arch)
    name = (configs.SMOKE if smoke else configs.CONFIG).name

    def answer(args) -> float:
        return float(bundle.fn(*args)[3]["loss"])

    answer(base)                                # warm-up
    lat, losses = [], []
    for i in range(requests):
        req = gnn_request(bundle, i, device)
        t0 = time.perf_counter()
        losses.append(answer((base[0],) + tuple(req)))
        lat.append((time.perf_counter() - t0) * 1e3)
    res = {"arch": name, "shape": bundle.cell.name,
           "device": str(device), "requests": requests,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "finite": bool(np.isfinite(losses).all())}
    print(f"{name}/{bundle.cell.name}: {requests} requests (a train "
          f"step each) on {device}, p50={res['p50_ms']:.2f}ms "
          f"p99={res['p99_ms']:.2f}ms")
    return res


def lm_request_specs(cfg, cell: registry.Cell, batch: int) -> tuple:
    """The request of an LM cell as the JAX cell builder shapes it:
    ``(tokens [B, S],)`` to prefill, ``(token [B], pos [B], caches)`` to
    decode."""
    s = cell.dims["seq"]
    if cell.kind == "prefill":
        return (cm.ShapeDtype((batch, s), torch.int32),)
    tok = cm.ShapeDtype((batch,), torch.int32)
    return (tok, tok, lm.decode_cache_specs(cfg, batch, s))


def lm_bytes(cfg, cell: registry.Cell, batch: int, mesh=None) -> dict:
    """What serving ``cell`` at ``batch`` sequences holds on the device, in
    bytes: the weights, the decode caches, and the largest working set of
    one step (an estimate): for prefill one query chunk's fp32 scores, its
    softmax and their cast, with the fp32 keys and ten activations of the
    whole prompt; for decode one layer's fp32 scores and softmax.  At a
    ``mesh``, one rank's: its share of the weights, its slices of the
    caches, its rows' working set."""
    s = cell.dims["seq"]
    h = cfg.n_heads
    dh = (cfg.mla_cfg().dh_nope + cfg.mla_cfg().dh_rope
          if cfg.attn_type == "mla" else cfg.head_dim)
    kv = h if cfg.attn_type == "mla" else cfg.n_kv_heads
    caches = lm.cache_bytes(cfg, batch, s, mesh) \
        if cell.kind == "decode" else 0
    if mesh is not None:
        rows = mesh.batch_rows(batch)
        batch = rows.stop - rows.start
    if cell.kind == "prefill":
        qc = min(cfg.q_chunk, s)
        work = batch * (h * qc * s * 10 + s * kv * dh * 4
                        + 10 * s * max(cfg.d_model, cfg.d_ff) * 2)
    else:
        work = batch * h * s * 8
    return {"weights": lm.param_bytes(cfg, mesh), "caches": caches,
            "work": work}


def _device_caches(specs: dict, seed: int, device, mesh=None) -> dict:
    """Decode caches of ``specs`` drawn N(0, 0.02) on ``device`` from a
    generator seeded ``seed`` there, one [Smax, ...] row of a layer and
    sequence at a time; at a ``mesh``, this rank's slices of the same
    draws (every row drawn, the rank's kept)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for kind, entry in specs.items():
        out[kind] = {}
        for name, sd in entry.items():
            n_layers, b, s_max = sd.shape[:3]
            rows, seq = (slice(0, b), slice(0, s_max)) if mesh is None \
                else lm.cache_slices(mesh, b, s_max)
            t = torch.empty((n_layers, rows.stop - rows.start,
                             seq.stop - seq.start) + tuple(sd.shape[3:]),
                            dtype=sd.dtype, device=device)
            for i in range(n_layers * b):
                part = torch.randn((s_max,) + tuple(sd.shape[3:]),
                                   generator=gen, device=device).mul_(0.02)
                layer, row = divmod(i, b)
                if rows.start <= row < rows.stop:
                    t[layer, row - rows.start].copy_(part[seq])
            out[kind][name] = t
    return out


def lm_request(cfg, cell: registry.Cell, batch: int, seed: int, device,
               mesh=None):
    """Request ``seed`` of an LM cell, on ``device`` (module docstring); at
    a ``mesh``, the whole tokens and positions and this rank's slices of
    the caches."""
    specs = lm_request_specs(cfg, cell, batch)
    if cell.kind == "prefill":
        return materialize(specs, seed=seed, device=device)
    if sum(math.prod(sd.shape) for e in specs[2].values()
           for sd in e.values()) <= HOST_DRAW_ELEMENTS:
        token, pos, caches = materialize(specs, seed=seed, device=device)
        return (token, pos, caches if mesh is None
                else lm.cache_share(caches, mesh))
    # token and pos are the first leaves: the same draws as the whole tree's
    return (*materialize(specs[:2], seed=seed, device=device),
            _device_caches(specs[2], seed, device, mesh))


def lm_train_request_specs(cfg, ocfg: opt.OptConfig, cell: registry.Cell,
                           batch: int) -> tuple:
    """A train cell's request as the JAX cell builder shapes it: (the
    optimizer state as the JAX package's nested tree, the step, ``{tokens:
    [B, S]}``)."""
    meta = {k: torch.empty(sp.shape, dtype=sp.dtype or cfg.torch_dtype,
                           device="meta")
            for k, sp in lm.param_specs(cfg).items()}
    state = {k: {n: cm.ShapeDtype(tuple(t.shape), t.dtype)
                 for n, t in st.items()}
             for k, st in opt.init_opt_state(meta, ocfg).items()}
    return (mat.nested(state), cm.ShapeDtype((), torch.int32),
            {"tokens": cm.ShapeDtype((batch, cell.dims["seq"]),
                                     torch.int32)})


def lm_train_request(cfg, ocfg: opt.OptConfig, cell: registry.Cell,
                     batch: int, seed: int, device) -> tuple:
    """Request ``seed`` of a train cell on ``device`` -> (optimizer state
    ``{path: {name: tensor}}``, step, batch) (module docstring)."""
    state_specs, step_spec, batch_spec = lm_train_request_specs(
        cfg, ocfg, cell, batch)
    paths = list(lm.param_specs(cfg))
    n = sum(math.prod(sd.shape) for k in paths
            for sd in mat.at(state_specs, k).values())
    if n <= HOST_DRAW_ELEMENTS:
        tree, step, b = materialize((state_specs, step_spec, batch_spec),
                                    seed=seed, device=device)
        state = {k: mat.at(tree, k) for k in paths}
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        state = {k: {name: torch.randn(sd.shape, generator=gen,
                                       device=device, dtype=sd.dtype)
                     .mul_(0.02)
                     for name, sd in mat.at(state_specs, k).items()}
                 for k in paths}
        step, b = materialize((step_spec, batch_spec), seed=seed,
                              device=device)
    return state, int(step), b


def serve_lm_train(cfg, cell: registry.Cell, b: int, requests: int,
                   device) -> dict:
    """``requests`` train steps of the cell ``train_4k`` (module
    docstring)."""
    ocfg = cells.opt_cfg("lm", cfg)
    if device.type == "cuda":
        need = launch_train.lm_train_bytes(cfg, ocfg, b, cell.dims["seq"])
        total = launch_train.step_peak(need) + need["params"] \
            + need["opt_state"]                  # the functional update's
        free = torch.cuda.mem_get_info(device)[0]
        if total > free:
            raise SystemExit(
                f"{cfg.name}/{cell.name} at --batch {b} needs {total} B "
                f"({need}, and a second copy of the parameters and state) "
                f"and the card has {free} B free")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    params, _ = launch_train.lm_params(cfg, device)
    step_fn = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg)

    def answer(req):
        state, step, batch = req
        return float(step_fn(params, state, step, batch)[3]["loss"])

    answer(lm_train_request(cfg, ocfg, cell, b, 0, device))   # warm-up
    lat, losses = [], []
    for i in range(requests):
        req = lm_train_request(cfg, ocfg, cell, b, i + 1, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        losses.append(answer(req))
        lat.append((time.perf_counter() - t0) * 1e3)
        del req
    tokens = b * cell.dims["seq"]
    res = {"arch": cfg.name, "shape": cell.name, "device": str(device),
           "batch": b, "seq": cell.dims["seq"], "requests": requests,
           "rule": ocfg.dense_rule, "losses": losses,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "tokens_per_s": tokens * len(lat) / (sum(lat) / 1e3),
           "finite": bool(np.isfinite(losses).all())}
    print(f"{cfg.name}/{cell.name}: {requests} requests (a train step "
          f"each, {ocfg.dense_rule}) of {b} x {cell.dims['seq']} on "
          f"{device}, p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms "
          f"tokens/s={res['tokens_per_s']:.0f}")
    return res


def serve_lm(arch: str, shape: str, *, smoke: bool, requests: int,
             batch, device, mesh=None) -> dict:
    """``requests`` requests of the LM cell ``shape`` (module docstring):
    p50 / p99 ms and tokens a second; at a ``mesh``, this rank's part
    (``--model-ranks``)."""
    configs = registry.LM_ARCHS[arch]
    cfg = configs.SMOKE if smoke else configs.CONFIG
    cell = registry.cell_by_name(shape, "lm")
    if smoke:
        cell = registry.reduce_cell(cell)
    b = cell.dims["batch"] if batch is None else batch
    if cell.kind == "train":
        return serve_lm_train(cfg, cell, b, requests, device)
    where = ""
    if mesh is not None:
        where = f" (rank {mesh.model_index} of {mesh.size('model')})"
    if device.type == "cuda":
        need = lm_bytes(cfg, cell, b, mesh)
        # ranks that share one card (gloo) share its free memory
        sharing = 1 if mesh is None or torch.cuda.device_count() \
            >= mesh.size("model") else mesh.size("model")
        free = torch.cuda.mem_get_info(device)[0] // sharing
        if sum(need.values()) > free:
            per_seq = (need["caches"] + need["work"]) / b
            fits = int((free - need["weights"]) // per_seq) if per_seq else 0
            raise SystemExit(
                f"{cfg.name}/{cell.name}{where} at --batch {b} needs "
                f"{sum(need.values())} B ({need}) and the card has {free} B "
                f"free; the largest --batch that fits is {max(fits, 0)}")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    params = lm.lm_init(cfg, seed=0, device=device, mesh=mesh)
    step = (serve_step.lm_prefill_fn(cfg, mesh) if cell.kind == "prefill"
            else serve_step.lm_decode_fn(cfg, mesh, cell.dims["seq"]))

    def answer(req):
        out = step(params, *req)
        return (out if cell.kind == "prefill" else out[0]).cpu()

    answer(lm_request(cfg, cell, b, 0, device, mesh))        # warm-up
    lat, finite = [], True
    for i in range(requests):
        req = lm_request(cfg, cell, b, i + 1, device, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits = answer(req)
        lat.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(logits.isfinite().all())
        del req
    tokens = b * (cell.dims["seq"] if cell.kind == "prefill" else 1)
    res = {"arch": cfg.name, "shape": cell.name, "device": str(device),
           "batch": b, "seq": cell.dims["seq"], "requests": requests,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "tokens_per_s": tokens * len(lat) / (sum(lat) / 1e3),
           "finite": finite}
    print(f"{cfg.name}/{cell.name}{where}: {requests} requests of {b} x "
          f"{cell.dims['seq']} on {device}, p50={res['p50_ms']:.2f}ms "
          f"p99={res['p99_ms']:.2f}ms tokens/s={res['tokens_per_s']:.0f}",
          flush=True)
    return res


RANK_TIMEOUT_S = 1800


def _serve_rank(rank: int, ranks: int, rdv: str, out_dir: str, arch: str,
                shape: str, smoke: bool, requests: int, batch,
                device_type: str) -> None:
    """One rank of ``--model-ranks``, spawned: its process group, the mesh,
    ``serve_lm`` at it, its numbers into ``out_dir``."""
    if device_type == "cuda":
        own_card = torch.cuda.device_count() >= ranks
        device = torch.device("cuda", rank if own_card else 0)
        torch.cuda.set_device(device)
        backend = "nccl" if own_card else "gloo"
    else:
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    torch.distributed.init_process_group(
        backend, init_method=rdv, world_size=ranks, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = mesh_mod.make_mesh(model=ranks)
        res = serve_lm(arch, shape, smoke=smoke, requests=requests,
                       batch=batch, device=device, mesh=mesh)
        res["exchange"] = tdist.exchange_route(mesh.model_group, device)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def serve_lm_ranks(arch: str, shape: str, *, smoke: bool, requests: int,
                   batch, device, ranks: int) -> dict:
    """``--model-ranks``: ``ranks`` spawned processes serve the cell at
    ``make_mesh(model=ranks)`` (module docstring) -> rank 0's numbers,
    with ``ranks``, the exchange's route and ``finite`` over every
    rank."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _serve_rank, args=(ranks, "file://" + os.path.join(tmp, "rdv"),
                               tmp, arch, shape, smoke, requests, batch,
                               device.type),
            nprocs=ranks, join=True, start_method="spawn")
        results = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    res = dict(results[0], ranks=ranks,
               finite=all(r["finite"] for r in results))
    print(f"{res['arch']}/{res['shape']} at {ranks} model ranks over "
          f"{res['exchange']}: p50={res['p50_ms']:.2f}ms (rank 0), every "
          f"rank finite: {res['finite']}")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    choices=[c.name for c in registry.REC_CELLS
                             + registry.GNN_CELLS + registry.LM_CELLS],
                    help="serve_p99 for a recsys arch, molecule for "
                         "graphsage-reddit, decode_32k for an LM")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a scoring request, sequences an LM request "
                         "(default: the cell's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--feature-server", action="store_true",
                    help="serve the feature lookups through the QueryServer "
                         "to concurrent clients (DeepFM)")
    ap.add_argument("--clients", type=int, default=8,
                    help="scoring client threads for --feature-server")
    ap.add_argument("--prefetch-clients", type=int, default=2,
                    help="PREFETCH-lane lookup threads for --feature-server")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="serve an LM's prefill or decode from this many "
                         "rank processes, its cache and experts split over "
                         "them")
    args = ap.parse_args(argv)
    try:
        family = registry.family(args.arch)
    except KeyError:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch)) from None
    shape = args.shape or {"recsys": "serve_p99", "gnn": "molecule",
                           "lm": "decode_32k"}[family]
    if shape not in [c.name for c in registry.CELLS[family]]:
        ap.error(f"{shape} is not a cell of {args.arch}")
    if family == "lm":
        if args.feature_server:
            ap.error("--feature-server takes a recsys arch")
        if args.requests < 1 or (args.batch is not None and args.batch < 1):
            ap.error("--requests and --batch must be at least 1")
        if args.model_ranks < 1:
            ap.error("--model-ranks must be at least 1")
        if args.model_ranks > 1:
            if registry.cell_by_name(shape, "lm").kind == "train":
                raise SystemExit(f"--model-ranks serves prefill and decode; "
                                 f"{shape} at {args.model_ranks} ranks: "
                                 + moe.EP_AUTOGRAD)
            return serve_lm_ranks(args.arch, shape, smoke=args.smoke,
                                  requests=args.requests, batch=args.batch,
                                  device=ops.resolve_device(args.device),
                                  ranks=args.model_ranks)
        return serve_lm(args.arch, shape, smoke=args.smoke,
                        requests=args.requests, batch=args.batch,
                        device=ops.resolve_device(args.device))
    if args.model_ranks != 1:
        ap.error("--model-ranks takes an LM arch")
    if family == "gnn":
        if args.feature_server or args.batch is not None:
            ap.error("--feature-server and --batch take a recsys arch")
        if args.requests < 1:
            ap.error("--requests must be at least 1")
        return serve_gnn(args.arch, shape, smoke=args.smoke,
                         requests=args.requests,
                         device=ops.resolve_device(args.device))
    configs = registry.ARCHS[args.arch]
    cell = registry.cell_by_name(shape)
    if args.smoke:
        cell = registry.reduce_cell(cell)
    if cell.kind == "rec_train":
        raise SystemExit(f"--shape {cell.name} is a train cell: run python "
                         "-m repro_torch.launch.train")
    if args.batch is not None and cell.kind != "rec_serve":
        ap.error(f"--batch sets a scoring cell's rows; {cell.name} ranks "
                 "its cell's candidates")
    if args.feature_server:
        if cell.kind != "rec_serve":
            ap.error(f"--feature-server scores a serving cell's requests; "
                     f"{cell.name} ranks candidates")
        if "sparse_ids" not in synthetic.recsys_batch(
                np.random.default_rng(0), configs.SMOKE, 1):
            raise SystemExit(f"--feature-server needs an arch whose batches "
                             f"carry sparse_ids to key the lookup (deepfm), "
                             f"not {args.arch}")
        if args.clients < 1 or args.prefetch_clients < 0:
            ap.error("--clients must be at least 1, --prefetch-clients at "
                     "least 0")
    rows = cell.dims["batch"] if args.batch is None else args.batch
    n_cand = cell.dims.get("n_candidates")
    if args.requests < 1 or rows < 1:
        ap.error("--requests and --batch must be at least 1")
    device = ops.resolve_device(args.device)
    cfg = configs.SMOKE if args.smoke else configs.CONFIG
    if n_cand is not None and cfg.arch != "two_tower":
        rows = n_cand                           # one candidate a row
    model = rec.recsys_init(cfg, seed=0, device=device)
    if args.feature_server:
        return serve_with_feature_server(
            cfg, model, cell, rows=rows, clients=args.clients,
            requests=args.requests, prefetch_clients=args.prefetch_clients)
    step, draw = cell_requests(cfg, cell, rows, model)

    def answer(request):
        """The request's scores (or top-k values) on the host: waits for
        the card."""
        out = step(*request)
        return (out[0] if isinstance(out, tuple) else out).cpu()

    rng = np.random.default_rng(100)
    answer(draw(rng))                           # warm-up
    lat = []
    for _ in range(args.requests):
        request = draw(rng)
        t0 = time.perf_counter()
        scores = answer(request)
        lat.append((time.perf_counter() - t0) * 1e3)
    res = {"arch": cfg.name, "shape": cell.name, "device": str(device),
           "rows": rows, "candidates": n_cand, "requests": args.requests,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "finite": bool(scores.isfinite().all())}
    what = f"{rows} rows"
    if n_cand is not None:
        what = (f"{what} x {n_cand} candidates" if cfg.arch == "two_tower"
                else f"{n_cand} candidate rows") + f", top {scores.shape[-1]}"
    print(f"{cfg.name}/{cell.name}: {args.requests} requests of {what} on "
          f"{device}, p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms")
    return res


if __name__ == "__main__":
    main()
