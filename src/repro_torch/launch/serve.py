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
  ``configs/registry.GNN_CELLS``) dense step, each request's from the same
  base parameters (seed 0) and fresh optimizer state, on a batch drawn
  from ``np.random.default_rng(i + 1)`` for request i as the train
  launcher draws one (``launch/train.gnn_arrays``: at ``molecule`` a
  ``synthetic.molecule_batch``; the JAX launcher draws random arrays of the
  cell's shapes instead, through ``launch/materialize.py``, which the port
  lacks), uploaded before the request is timed.  The latency is the step
  and the wait for its loss on the host.

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
import threading
import time

import numpy as np

from repro_torch.api.backends import EngineBackend
from repro_torch.api.client import FeatureClient
from repro_torch.configs import bili_feature_store, registry
from repro_torch.core import hashcore as hc
from repro_torch.core.engine import (EmbeddingTable, MultiTableEngine,
                                     ScalarTable)
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step
from repro_torch.serve.scheduler import BatchPolicy, ShedError
from repro_torch.serve.server import QueryServer
from repro_torch.train import optimizer as opt

FEATURE_FIELDS = (("item_feats", "item_id"), ("item_pop", "item_id"))
TOP_K = 100
SERVER_BATCH_KEYS = 4096       # the feature server's micro-batch key budget
SCORING_BUDGET_S = 2.0         # a scoring request's lookup budget
PREFETCH_IDS, PREFETCH_BUDGET_S = 256, 0.5
DELTA_KEYS = 64


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


def serve_gnn(arch: str, shape: str, *, smoke: bool, requests: int,
              device) -> dict:
    """``requests`` runs of the GNN cell ``shape``'s train step from the
    same base parameters (the module docstring says how): p50 / p99 ms."""
    cell, cfg, params, step = launch_train.gnn_setup(arch, shape, smoke,
                                                     device)
    state = opt.init_opt_state(params, opt.OptConfig())

    def request(seed):
        return gnn.gnn_batch(launch_train.gnn_arrays(
            np.random.default_rng(seed), cell), cell.kind, device)

    def answer(batch) -> float:
        return float(step(params, state, 0, batch)[3]["loss"])

    answer(request(0))                          # warm-up
    lat, losses = [], []
    for i in range(requests):
        batch = request(i + 1)
        t0 = time.perf_counter()
        losses.append(answer(batch))
        lat.append((time.perf_counter() - t0) * 1e3)
    res = {"arch": cfg.name, "shape": cell.name, "device": str(device),
           "requests": requests, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "finite": bool(np.isfinite(losses).all())}
    print(f"{cfg.name}/{cell.name}: {requests} requests (a train step "
          f"each) on {device}, p50={res['p50_ms']:.2f}ms "
          f"p99={res['p99_ms']:.2f}ms")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    choices=[c.name for c in registry.REC_CELLS
                             + registry.GNN_CELLS],
                    help="serve_p99 for a recsys arch, molecule for "
                         "graphsage-reddit")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a scoring request (default: the cell's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--feature-server", action="store_true",
                    help="serve the feature lookups through the QueryServer "
                         "to concurrent clients (DeepFM)")
    ap.add_argument("--clients", type=int, default=8,
                    help="scoring client threads for --feature-server")
    ap.add_argument("--prefetch-clients", type=int, default=2,
                    help="PREFETCH-lane lookup threads for --feature-server")
    args = ap.parse_args(argv)
    try:
        family = registry.family(args.arch)
    except KeyError:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch)) from None
    shape = args.shape or {"recsys": "serve_p99", "gnn": "molecule"}[family]
    if shape not in [c.name for c in registry.CELLS[family]]:
        ap.error(f"{shape} is not a cell of {args.arch}")
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
