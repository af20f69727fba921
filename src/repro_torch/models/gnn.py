"""GraphSAGE (mean aggregator) in three execution regimes, from the JAX
package's ``models/gnn.py``:

  * full-graph: message passing over a global edge list.  Each layer's
    neighbour mean is ``kernels/ops.neighbor_mean`` over the graph's CSRs
    (``Adjacency``, built once a graph by a stable sort): on the card the
    ``csr_sum`` CUDA kernel gathers and sums in one pass, forward and
    (over the transposed CSR) backward, where the JAX package's
    ``jnp.take`` + ``segment_sum`` build an [E, D] message tensor;
  * sampled minibatch: dense fanout trees (seed, [B, f1], [B, f1, f2])
    produced by ``data/graph_sampler.py``; their masked means are plain
    torch, as the JAX package computes them in plain jnp;
  * batched small graphs (molecule): the valid edges of the G graphs of N
    nodes flattened to global ids ``g * N + src -> g * N + dst`` (the -1
    pads dropped: the JAX package adds them as zero messages to node 0,
    the same sum) through the same neighbour mean.

Parameters are one flat dict of tensors keyed by the JAX pytree paths
(``layers/0/w_self``, ``cls``), in ``jax.tree_util``'s leaf order, as the
trainer (``train/``) takes them.  The JAX package's mesh sharding
(``mi.shard``) and its full-graph cell's edge padding (a multiple of the
device count: none on one card) have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as seg
from repro_torch.models import common as cm

# a cell's kind -> the regime its loss runs
REGIMES = {"gnn_full": "full_graph", "gnn_minibatch": "minibatch",
           "gnn_molecule": "molecule"}


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    d_feat: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    fanouts: tuple = (25, 10)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def cell_config(cfg: GNNConfig, cell) -> GNNConfig:
    """``cfg`` at a cell's features, classes and fanouts, as the JAX
    package's ``launch/cells.py::_gnn_cell`` sets them."""
    d = cell.dims
    return dataclasses.replace(cfg, d_feat=d["d_feat"],
                               n_classes=d["n_classes"],
                               fanouts=tuple(d.get("fanouts", cfg.fanouts)))


def param_shapes(cfg: GNNConfig) -> dict:
    """Each parameter's path -> shape, in ``jax.tree_util``'s leaf order."""
    dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
    out = {"cls": (cfg.d_hidden, cfg.n_classes)}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        out.update({f"layers/{i}/b": (dout,),
                    f"layers/{i}/w_neigh": (din, dout),
                    f"layers/{i}/w_self": (din, dout)})
    return out


def sage_init(cfg: GNNConfig, generator: torch.Generator,
              device) -> dict:
    """Random parameters of ``cfg`` drawn from ``generator`` (which lives
    on ``device``) in the JAX package's order: each layer's ``w_self`` then
    ``w_neigh`` (scaled by 1/sqrt(fan-in)), its ``b`` zero, then ``cls``."""
    kw = dict(generator=generator, device=device, dtype=cfg.torch_dtype)
    dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layers/{i}/w_self"] = cm.dense_param(din, dout, **kw)
        params[f"layers/{i}/w_neigh"] = cm.dense_param(din, dout, **kw)
        params[f"layers/{i}/b"] = torch.zeros(dout, dtype=cfg.torch_dtype,
                                              device=device)
    params["cls"] = cm.dense_param(cfg.d_hidden, cfg.n_classes, **kw)
    return {k: params[k] for k in param_shapes(cfg)}


def _layer(params: dict, i: int) -> dict:
    return {k: params[f"layers/{i}/{k}"] for k in ("w_self", "w_neigh", "b")}


def _combine(layer: dict, h_self: torch.Tensor, h_neigh: torch.Tensor,
             last: bool) -> torch.Tensor:
    out = h_self @ layer["w_self"] + h_neigh @ layer["w_neigh"] + layer["b"]
    if not last:
        out = torch.relu(out)
        # L2-normalize as in the paper (GraphSAGE §3.1)
        out = out / torch.linalg.vector_norm(out, dim=-1,
                                             keepdim=True).clamp(min=1e-6)
    return out


# ---------------------------------------------------------------------------
# full-graph
# ---------------------------------------------------------------------------
def sage_full_graph(params: dict, cfg: GNNConfig, feats: torch.Tensor,
                    adj: seg.Adjacency) -> torch.Tensor:
    """feats [N, F]; ``adj`` the graph's CSRs (``seg.adjacency`` of its
    edges src -> dst).  Returns logits [N, C]."""
    h = feats
    for li in range(cfg.n_layers):
        agg = ops.neighbor_mean(h, adj)
        h = _combine(_layer(params, li), h, agg, last=False)
    return h @ params["cls"]


# ---------------------------------------------------------------------------
# sampled minibatch (dense fanout tree)
# ---------------------------------------------------------------------------
def _masked_mean(x: torch.Tensor, m: torch.Tensor, dim: int) -> torch.Tensor:
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1.0)


def sage_minibatch(params: dict, cfg: GNNConfig, block: dict) -> torch.Tensor:
    """block: seed_feats [B, F]; h1_feats [B, f1, F]; h2_feats [B, f1, f2, F];
    h1_mask [B, f1]; h2_mask [B, f1, f2].  2-layer SAGE. Returns [B, C]."""
    l1, l2 = _layer(params, 0), _layer(params, 1)
    h2m = block["h2_mask"][..., None].to(block["h2_feats"].dtype)
    h1m = block["h1_mask"][..., None].to(block["h1_feats"].dtype)
    # layer 1 on hop-1 nodes: aggregate their hop-2 neighbours
    agg2 = _masked_mean(block["h2_feats"], h2m, 2)
    h1 = _combine(l1, block["h1_feats"], agg2, last=False)     # [B, f1, H]
    # layer 1 on seeds: aggregate hop-1 neighbours (raw feats)
    agg1 = _masked_mean(block["h1_feats"], h1m, 1)
    h0 = _combine(l1, block["seed_feats"], agg1, last=False)   # [B, H]
    # layer 2 on seeds: aggregate layer-1 hop-1 states
    agg = _masked_mean(h1, h1m, 1)
    h = _combine(l2, h0, agg, last=False)
    return h @ params["cls"]


# ---------------------------------------------------------------------------
# batched small graphs (molecule) — graph-level classification
# ---------------------------------------------------------------------------
def molecule_adjacency(edges: torch.Tensor, n_nodes: int) -> seg.Adjacency:
    """The ``Adjacency`` of a molecule batch's edges [G, E, 2] (src, dst;
    -1 pad) over its G * n_nodes nodes: graph g's edge (s, d) becomes
    g * n_nodes + s -> g * n_nodes + d, in (g, e) order; pads are dropped."""
    g = edges.shape[0]
    base = torch.arange(g, device=edges.device)[:, None] * n_nodes
    valid = (edges[..., 0] >= 0).reshape(-1)
    src = (edges[..., 0].long() + base).reshape(-1)[valid]
    dst = (edges[..., 1].long() + base).reshape(-1)[valid]
    return seg.adjacency(src, dst, g * n_nodes)


def sage_molecule(params: dict, cfg: GNNConfig, batch: dict,
                  adj: seg.Adjacency) -> torch.Tensor:
    """node_feats [G, N, F]; node_mask [G, N]; ``adj``
    (``molecule_adjacency`` of the batch's edges).  Returns graph logits
    [G, C] (mean readout)."""
    feats = batch["node_feats"]
    g, n, _ = feats.shape
    nmask = batch["node_mask"][..., None].to(feats.dtype)
    h = feats
    for li in range(cfg.n_layers):
        agg = ops.neighbor_mean(h.reshape(g * n, -1), adj).reshape(g, n, -1)
        h = _combine(_layer(params, li), h, agg, last=False) * nmask
    readout = _masked_mean(h, nmask, 1)
    return readout @ params["cls"]


# ---------------------------------------------------------------------------
# batches and losses
# ---------------------------------------------------------------------------
def gnn_batch(arrays: dict, kind: str, device) -> dict:
    """A cell's host arrays (``synthetic.random_graph``, a
    ``graph_sampler.sample_block`` block or ``synthetic.molecule_batch``)
    as tensors on ``device``; a graph's (``gnn_full``, ``gnn_molecule``)
    with its ``Adjacency`` built there under ``adj``."""
    batch = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    if kind == "gnn_full":
        batch["adj"] = seg.adjacency(batch["edges"][0], batch["edges"][1],
                                     batch["feats"].shape[0])
    elif kind == "gnn_molecule":
        batch["adj"] = molecule_adjacency(batch["edges"],
                                          batch["node_feats"].shape[1])
    return batch


def gnn_loss(params: dict, cfg: GNNConfig, batch: dict,
             regime: str) -> tuple[torch.Tensor, dict]:
    """The JAX package's ``gnn_loss``: softmax cross-entropy of the
    regime's logits (full graph: masked by ``train_mask``).  A graph's
    batch carries its ``Adjacency`` under ``adj`` (``gnn_batch``)."""
    if regime == "full_graph":
        logits = sage_full_graph(params, cfg, batch["feats"], batch["adj"])
        loss = cm.softmax_xent(logits, batch["labels"],
                               batch.get("train_mask"))
    elif regime == "minibatch":
        logits = sage_minibatch(params, cfg, batch)
        loss = cm.softmax_xent(logits, batch["labels"])
    elif regime == "molecule":
        logits = sage_molecule(params, cfg, batch, batch["adj"])
        loss = cm.softmax_xent(logits, batch["labels"])
    else:
        raise ValueError(regime)
    return loss, {"loss": loss}
