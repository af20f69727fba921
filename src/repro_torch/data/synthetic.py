"""Synthetic recsys batches: a copy of the JAX package's
``data/synthetic.py`` (``zipf_ids``, ``recsys_batch``).  numpy only, so the
same seed gives the same batch in both packages.

Recsys ids are zipfian (hot/cold skew drives the hybrid store and table
sharding); behaviour sequences have ragged lengths (-1 padding exercises
masks and EmbeddingBag).
"""
from __future__ import annotations

import numpy as np


def zipf_ids(rng: np.random.Generator, vocab: int, size, a: float = 1.1
             ) -> np.ndarray:
    """Zipfian ids in [0, vocab) — heavy head, long tail."""
    raw = rng.zipf(a, size=size)
    return ((raw - 1) % vocab).astype(np.int32)


def recsys_batch(rng: np.random.Generator, cfg, batch: int) -> dict:
    """Matches models/recsys.py input contracts for cfg.arch."""
    out: dict = {}
    L = cfg.seq_len
    if cfg.arch in ("din", "bst"):
        lens = rng.integers(1, L + 1, batch)
        hist = zipf_ids(rng, cfg.item_vocab, (batch, L))
        mask = np.arange(L)[None, :] < lens[:, None]
        out["hist_items"] = np.where(mask, hist, -1).astype(np.int32)
        out["hist_cats"] = np.where(
            mask, zipf_ids(rng, cfg.cat_vocab, (batch, L)), -1
        ).astype(np.int32)
        out["target_item"] = zipf_ids(rng, cfg.item_vocab, batch)
        out["target_cat"] = zipf_ids(rng, cfg.cat_vocab, batch)
        out["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(
            np.float32)
        out["label"] = (rng.random(batch) < 0.1).astype(np.float32)
    elif cfg.arch == "two_tower":
        lens = rng.integers(1, L + 1, batch)
        hist = zipf_ids(rng, cfg.item_vocab, (batch, L))
        mask = np.arange(L)[None, :] < lens[:, None]
        out["user_id"] = rng.integers(0, cfg.user_vocab, batch,
                                      dtype=np.int32)
        out["hist_items"] = np.where(mask, hist, -1).astype(np.int32)
        out["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(
            np.float32)
        out["item_id"] = zipf_ids(rng, cfg.item_vocab, batch)
        out["item_cat"] = zipf_ids(rng, cfg.cat_vocab, batch)
    elif cfg.arch == "deepfm":
        out["sparse_ids"] = zipf_ids(
            rng, cfg.field_vocab, (batch, cfg.n_sparse_fields))
        out["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(
            np.float32)
        out["label"] = (rng.random(batch) < 0.25).astype(np.float32)
    else:
        raise ValueError(cfg.arch)
    return out
