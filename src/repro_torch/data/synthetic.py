"""Synthetic recsys batches and graphs: a copy of the JAX package's
``data/synthetic.py`` (``zipf_ids``, ``recsys_batch``, ``random_graph``,
``molecule_batch``).  numpy only, so the same seed gives the same batch in
both packages.

Recsys ids are zipfian (hot/cold skew drives the hybrid store and table
sharding); behaviour sequences have ragged lengths (-1 padding exercises
masks and EmbeddingBag).  Graph sources are power-law (hub sources with
long out-lists), destinations uniform; molecule batches pad their nodes
and edges (-1).
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


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int, n_classes: int) -> dict:
    """Power-lawish directed graph as (feats, edges, labels)."""
    # preferential-attachment-flavoured endpoints
    src = (rng.pareto(1.5, n_edges) * n_nodes / 8).astype(np.int64) % n_nodes
    dst = rng.integers(0, n_nodes, n_edges)
    edges = np.stack([src, dst]).astype(np.int32)
    return {
        "feats": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "edges": edges,
        "labels": rng.integers(0, n_classes, n_nodes, dtype=np.int32),
        "train_mask": (rng.random(n_nodes) < 0.3).astype(np.float32),
    }


def molecule_batch(rng: np.random.Generator, n_graphs: int, n_nodes: int,
                   n_edges: int, d_feat: int, n_classes: int) -> dict:
    """``n_graphs`` small graphs of at most ``n_nodes`` nodes and
    ``n_edges`` edges: node_feats [G, N, F] (zero past a graph's size),
    edges [G, E, 2] (src, dst; -1 past its edge count), node_mask [G, N],
    labels [G]."""
    sizes = rng.integers(max(n_nodes // 2, 2), n_nodes + 1, n_graphs)
    node_mask = np.arange(n_nodes)[None, :] < sizes[:, None]
    edges = np.stack([
        rng.integers(0, n_nodes, (n_graphs, n_edges)),
        rng.integers(0, n_nodes, (n_graphs, n_edges))], axis=-1)
    edges = np.minimum(edges, (sizes[:, None, None] - 1))
    e_valid = np.arange(n_edges)[None, :] < rng.integers(
        n_edges // 2, n_edges + 1, n_graphs)[:, None]
    edges = np.where(e_valid[..., None], edges, -1).astype(np.int32)
    return {
        "node_feats": (rng.normal(size=(n_graphs, n_nodes, d_feat)) *
                       node_mask[..., None]).astype(np.float32),
        "edges": edges,
        "node_mask": node_mask.astype(np.float32),
        "labels": rng.integers(0, n_classes, n_graphs, dtype=np.int32),
    }
