"""Serving launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch din|bst|two-tower-retrieval|deepfm \
        [--shape serve_p99|serve_bulk|retrieval_cand] [--smoke] \
        [--requests 20] [--batch ROWS] [--device cuda|cpu]

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
  categories), DeepFM through ``serve_step.bulk_rank_fn`` (a batch of
  candidate rows).  For ``din`` and ``bst`` it exits naming ROADMAP:
  their ``retrieval_cand`` is not ported.
* ``train_batch`` raises: training is not ported.

The model (and the probe) run on ``--device`` (default ``cuda``; there is
no fallback to the CPU).
"""
from __future__ import annotations

import argparse
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
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step

FEATURE_FIELDS = (("item_feats", "item_id"), ("item_pop", "item_id"))
TOP_K = 100


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="serve_p99",
                    choices=[c.name for c in registry.REC_CELLS])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a scoring request (default: the cell's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch not in registry.ARCHS:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch))
    configs = registry.ARCHS[args.arch]
    cell = registry.cell_by_name(args.shape)
    if args.smoke:
        cell = registry.reduce_cell(cell)
    if cell.kind == "rec_train":
        raise SystemExit(f"--shape {cell.name}: training is not ported "
                         "(ROADMAP queue 1, item 12)")
    if cell.kind == "rec_retrieval" and \
            configs.CONFIG.arch not in serve_step.RETRIEVAL_ARCHS:
        raise SystemExit(f"--shape {cell.name}: "
                         + serve_step.RANK_NOT_PORTED.format(arch=args.arch))
    if args.batch is not None and cell.kind != "rec_serve":
        ap.error(f"--batch sets a scoring cell's rows; {cell.name} ranks "
                 "its cell's candidates")
    rows = cell.dims["batch"] if args.batch is None else args.batch
    n_cand = cell.dims.get("n_candidates")
    if args.requests < 1 or rows < 1:
        ap.error("--requests and --batch must be at least 1")
    device = ops.resolve_device(args.device)
    cfg = configs.SMOKE if args.smoke else configs.CONFIG
    if n_cand is not None and cfg.arch == "deepfm":
        rows = n_cand                           # one candidate a row
    model = rec.recsys_init(cfg, seed=0, device=device)
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
