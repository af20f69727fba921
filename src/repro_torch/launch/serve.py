"""Serving launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepfm|two-tower-retrieval [--smoke] [--requests 20] \
        [--batch 512] [--device cuda|cpu]

Builds the model at its published width (``configs/deepfm.CONFIG`` or
``configs/two_tower_retrieval.CONFIG``; ``--smoke`` takes ``SMOKE``) with
random weights from a seed and scores ``--requests`` synthetic batches of
``--batch`` rows (512: the ``serve_p99`` cell) through
``serve_step.recsys_score_fn``, one client in sequence, printing the
request latency's p50 and p99.

* ``deepfm`` scores CTR behind the ported ``FeatureClient``, over a
  feature engine built as the JAX package's launcher builds it for its
  feature server (the ``bili-feature-store-smoke`` item count and shard
  size; ``item_feats``: 8 float32 per item, ``item_pop``: a scalar per
  item, keyed by ``item_id = sparse_ids[:, 0] % n_items + 1``).
* ``two-tower-retrieval`` serves the user tower with no feature source, as
  the JAX launcher's ``serve_p99`` cell does for this arch: each request's
  answer is its L2-normalised user vectors.

The model (and the probe) run on ``--device`` (default ``cuda``; there is
no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api.backends import EngineBackend
from repro_torch.api.client import FeatureClient
from repro_torch.configs import (bili_feature_store, deepfm,
                                 two_tower_retrieval)
from repro_torch.core import hashcore as hc
from repro_torch.core.engine import (EmbeddingTable, MultiTableEngine,
                                     ScalarTable)
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step

FEATURE_FIELDS = (("item_feats", "item_id"), ("item_pop", "item_id"))
ARCHS = {"deepfm": deepfm, "two-tower-retrieval": two_tower_retrieval}


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.requests < 1 or args.batch < 1:
        ap.error("--requests and --batch must be at least 1")
    if args.arch not in ARCHS:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch))
    device = ops.resolve_device(args.device)
    configs = ARCHS[args.arch]
    cfg = configs.SMOKE if args.smoke else configs.CONFIG
    model = rec.recsys_init(cfg, seed=0, device=device)
    if cfg.arch == "deepfm":
        fs = bili_feature_store.SMOKE
        engine, *_ = feature_engine(fs.n_items, fs.max_shard_bytes,
                                    device=device)
        step = serve_step.recsys_score_fn(
            cfg, model, feature_client=FeatureClient(EngineBackend(engine)),
            feature_fields=FEATURE_FIELDS)

        def request(rng):
            return request_batch(rng, cfg, args.batch, fs.n_items)
    else:
        step = serve_step.recsys_score_fn(cfg, model)

        def request(rng):
            return synthetic.recsys_batch(rng, cfg, args.batch)

    rng = np.random.default_rng(100)
    step(request(rng)).cpu()                    # warm-up
    lat = []
    for _ in range(args.requests):
        batch = request(rng)
        t0 = time.perf_counter()
        scores = step(batch).cpu()              # waits for the card
        lat.append((time.perf_counter() - t0) * 1e3)
    out = {"arch": cfg.name, "device": str(device), "rows": args.batch,
           "requests": args.requests,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "finite": bool(scores.isfinite().all())}
    print(f"{cfg.name}/serve: {args.requests} requests of {args.batch} rows "
          f"on {device}, p50={out['p50_ms']:.2f}ms "
          f"p99={out['p99_ms']:.2f}ms")
    return out


if __name__ == "__main__":
    main()
