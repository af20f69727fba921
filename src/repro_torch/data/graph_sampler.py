"""Fanout neighbour sampler over CSR adjacency (GraphSAGE minibatch
training): a copy of the JAX package's ``data/graph_sampler.py``, numpy
only, so the same rng gives the same blocks in both packages.

Builds CSR once, then per minibatch uniformly samples ``fanouts``
neighbours per hop *with replacement when the degree is short* (mask marks
real draws), producing the dense fanout-tree blocks ``models/gnn.py``
consumes.  The blocks are host arrays; the caller uploads them.
"""
from __future__ import annotations

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, edges: np.ndarray):
        """edges [2, E] src->dst; we sample *in-neighbours* of dst (message
        direction), i.e. CSR over dst."""
        dst = edges[1].astype(np.int64)
        src = edges[0].astype(np.int64)
        order = np.argsort(dst, kind="stable")
        self.n_nodes = n_nodes
        self.indices = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)])

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        return self.indptr[nodes + 1] - self.indptr[nodes]

    def sample_neighbors(self, rng: np.random.Generator, nodes: np.ndarray,
                         fanout: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (neigh [len(nodes), fanout] int64, mask [len(nodes), fanout])."""
        deg = self.degree(nodes)
        draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(len(nodes), fanout))
        neigh = self.indices[self.indptr[nodes][:, None] + draw]
        mask = deg[:, None] > 0
        mask = np.broadcast_to(mask, neigh.shape).copy()
        neigh = np.where(mask, neigh, 0)
        return neigh, mask


def sample_block(rng: np.random.Generator, g: CSRGraph, feats: np.ndarray,
                 labels: np.ndarray, seeds: np.ndarray,
                 fanouts: tuple[int, int]) -> dict:
    """2-hop dense fanout tree for a seed batch."""
    f1, f2 = fanouts
    h1, m1 = g.sample_neighbors(rng, seeds, f1)                # [B, f1]
    h2, m2 = g.sample_neighbors(rng, h1.reshape(-1), f2)       # [B*f1, f2]
    b = len(seeds)
    h2 = h2.reshape(b, f1, f2)
    m2 = m2.reshape(b, f1, f2) & m1[..., None]
    return {
        "seed_feats": feats[seeds].astype(np.float32),
        "h1_feats": (feats[h1] * m1[..., None]).astype(np.float32),
        "h2_feats": (feats[h2] * m2[..., None]).astype(np.float32),
        "h1_mask": m1.astype(np.float32),
        "h2_mask": m2.astype(np.float32),
        "labels": labels[seeds].astype(np.int32),
    }


def block_shapes(batch: int, fanouts: tuple[int, int], d_feat: int) -> dict:
    """(shape, dtype) of each array of a block of ``batch`` seeds."""
    f1, f2 = fanouts
    return {
        "seed_feats": ((batch, d_feat), np.float32),
        "h1_feats": ((batch, f1, d_feat), np.float32),
        "h2_feats": ((batch, f1, f2, d_feat), np.float32),
        "h1_mask": ((batch, f1), np.float32),
        "h2_mask": ((batch, f1, f2), np.float32),
        "labels": ((batch,), np.int32),
    }
