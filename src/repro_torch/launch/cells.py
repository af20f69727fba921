"""The cell builder, from the JAX package's ``launch/cells.py``: (arch x
cell x mesh) -> a ``CellBundle`` of a step function, the shapes and dtypes
of its arguments, and what the cell counts.  The dry-run
(``launch/dryrun.py``) runs exactly these bundles on the meta device;
``launch/materialize.materialize_bundle`` gives them data, and the GNN
serve launcher and ``chip_smoke.py``'s phase W run them for real.

``CellBundle.args`` are trees of ``models/common.ShapeDtype``: parameters
a path-keyed dict in ``jax.tree_util``'s leaf order (``mlp/0/w``), the
optimizer state ``{path: {name: ShapeDtype}}``, the step a 0-dim int32,
batches dicts keyed as the reference's.  ``fn`` takes the reference
bundle's positional arguments and returns what it returns:

* a train cell (``train``, ``rec_train``, ``gnn_*``): ``fn(params,
  opt_state, step, batch) -> (params, opt_state, step + 1, metrics)``,
  through ``train/train_step.py``'s steps (an LM's in place, as
  ``launch/train.lm_setup``'s; ``accumN`` splits it into N microbatches;
  ``sparse_emb`` takes the sparse-embedding recsys step);
* ``rec_serve``: ``fn(params, batch)`` -> the probabilities [B] (two-tower:
  the user vectors [B, D]), ``recsys_score`` of a model whose parameters
  are the given tensors (``convert.model_view``); two-tower's ``a2a`` and
  ``psum16`` variants look up over the mesh's ``model`` group;
* ``rec_retrieval``: two-tower's ``fn(params, batch, cand_ids,
  cand_cats)``, a pointwise arch's ``fn(params, batch)`` -> the top
  ``min(100, N)`` (values, indices);
* ``prefill``: ``fn(params, tokens) -> logits [B, V]``; ``decode``:
  ``fn(params, token, pos, caches) -> (logits, caches)``.

``meta`` is the reference bundle's dict, key for key (``tokens``,
``kv_len``, ``has_opt``, ``int_high``, ``examples``, ``edges``,
``seeds``, ``graphs``, ``candidates``).  The reference's ``in_shardings``
and ``out_shardings`` are left out until the production mesh (ROADMAP
queue 1, item 15.4) consumes them: at the local mesh every leaf is
replicated.  A full-graph cell builds its CSRs inside the step
(``kernels/segment_sum.adjacency``), where the reference pads its edge
list there.

``opt_cfg`` is the reference's ``_opt_cfg``, and ``published_layers`` the
depth it reads from a config cut in depth.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.data import graph_sampler
from repro_torch.kernels import segment_sum as seg
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import gnn
from repro_torch.models import lm
from repro_torch.models import recsys as rec
from repro_torch.models.common import ShapeDtype
from repro_torch.serve import serve_step as serve
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ADAFACTOR_AT = 40 * 5120     # d_model x n_layers from which an LM trains
#                              with Adafactor (~14B dense and up)
VARIANTS = ("baseline", "sparse_emb", "a2a", "psum16")   # and accumN


def published_layers(cfg) -> int:
    """``cfg``'s depth as published: a config cut in depth (``n_layers``
    replaced, name and width kept) counts its registry config's layers;
    any other config its own."""
    for configs in registry.LM_ARCHS.values():
        c = configs.CONFIG
        if c.name == cfg.name and c.d_model == cfg.d_model:
            return c.n_layers
    return cfg.n_layers


def opt_cfg(family: str, cfg) -> opt.OptConfig:
    """The reference's ``_opt_cfg``: Adam, or Adafactor for an LM whose
    ``d_model`` x (published) ``n_layers`` reaches ``ADAFACTOR_AT``; the
    tables' rule ``adagrad_rows`` on every path holding "table" or "embed"
    (an LM's ``unembed`` too)."""
    dense_rule = "adam"
    if family == "lm" and cfg.d_model * published_layers(cfg) \
            >= ADAFACTOR_AT:
        dense_rule = "adafactor"
    return opt.OptConfig(dense_rule=dense_rule)


@dataclasses.dataclass
class CellBundle:
    arch_id: str
    cell: registry.Cell
    fn: Callable
    args: tuple               # trees of ShapeDtype
    meta: dict


def _sds(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(shape), dtype)


STEP = _sds((), torch.int32)


def _meta_like(tree):
    """A tree of tensors -> the same tree of ``ShapeDtype``."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return _sds(tree.shape, tree.dtype)


def param_shapes(family: str, cfg) -> dict:
    """``{path: ShapeDtype}`` of ``cfg``'s parameters in ``jax.tree_util``'s
    leaf order, drawing nothing: an LM's from ``lm.param_specs``, GraphSAGE's
    from ``gnn.param_shapes``, a recsys model's from its init on the meta
    device (no generator, no data)."""
    if family == "lm":
        return {k: _sds(sp.shape, sp.dtype or cfg.torch_dtype)
                for k, sp in lm.param_specs(cfg).items()}
    if family == "gnn":
        return {k: _sds(shape, cfg.torch_dtype)
                for k, shape in gnn.param_shapes(cfg).items()}
    return _meta_like(convert.params_of(rec.recsys_init(cfg,
                                                        device="meta")))


def _params_and_opt(family: str, cfg, want_opt: bool):
    """(parameter shapes, optimizer-state shapes or None, opt config or
    None): the state's shapes from ``opt.init_opt_state`` on meta
    tensors."""
    params = param_shapes(family, cfg)
    if not want_opt:
        return params, None, None
    ocfg = opt_cfg(family, cfg)
    state = opt.init_opt_state(
        {k: torch.empty(sd.shape, dtype=sd.dtype, device="meta")
         for k, sd in params.items()}, ocfg)
    return params, _meta_like(state), ocfg


def _host_step(step) -> int:
    """A 0-dim step tensor as the port's steps take it: a Python int (0 on
    the meta device, which holds no value; the step only scales the
    update)."""
    if isinstance(step, torch.Tensor):
        return 0 if step.device.type == "meta" else int(step)
    return int(step)


def _train_fn(step_fn: Callable) -> Callable:
    """The reference bundle's train signature over a port step: the step
    a 0-dim int32 tensor in and out, on the parameters' device."""
    def fn(params, opt_state, step, batch):
        p, s, n, metrics = step_fn(params, opt_state, _host_step(step),
                                   batch)
        device = next(iter(params.values())).device
        return p, s, torch.tensor(n, dtype=torch.int32, device=device), \
            metrics
    return fn


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_cell(arch_id, cfg, cell, mesh, variant="baseline") -> CellBundle:
    b, s = cell.dims["batch"], cell.dims["seq"]
    kind = cell.kind
    if kind == "train":
        params, state, ocfg = _params_and_opt("lm", cfg, True)
        accum = int(variant[5:]) if variant.startswith("accum") else 1
        fn = _train_fn(ts.make_train_step(ts.lm_loss_fn(cfg), ocfg,
                                          accum_steps=accum, in_place=True))
        return CellBundle(arch_id, cell, fn,
                          (params, state, STEP,
                           {"tokens": _sds((b, s), torch.int32)}),
                          {"tokens": b * s, "has_opt": True})
    params, *_ = _params_and_opt("lm", cfg, False)
    if kind == "prefill":
        return CellBundle(arch_id, cell, serve.lm_prefill_fn(cfg),
                          (params, _sds((b, s), torch.int32)),
                          {"tokens": b * s})
    if kind == "decode":
        tok = _sds((b,), torch.int32)
        return CellBundle(arch_id, cell, serve.lm_decode_fn(cfg),
                          (params, tok, tok,
                           lm.decode_cache_specs(cfg, b, s)),
                          {"tokens": b, "kv_len": s})
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _gnn_full_loss(cfg, n: int) -> Callable:
    def loss_fn(params, batch):
        edges = batch["edges"]
        return gnn.gnn_loss(params, cfg, {
            **batch, "adj": seg.adjacency(edges[0], edges[1], n)},
            "full_graph")
    return loss_fn


def _molecule_loss(cfg, n: int) -> Callable:
    def loss_fn(params, batch):
        return gnn.gnn_loss(params, cfg, {
            **batch, "adj": gnn.molecule_adjacency(batch["edges"], n)},
            "molecule")
    return loss_fn


def _gnn_cell(arch_id, cfg, cell, mesh) -> CellBundle:
    d = cell.dims
    cfg = gnn.cell_config(cfg, cell)
    params, state, ocfg = _params_and_opt("gnn", cfg, True)
    kind = cell.kind
    high = {"has_opt": True, "int_high": d["n_classes"]}
    if kind == "gnn_full":
        n, e = d["n_nodes"], d["n_edges"]
        batch = {"feats": _sds((n, d["d_feat"]), torch.float32),
                 "edges": _sds((2, e), torch.int32),
                 "labels": _sds((n,), torch.int32),
                 "train_mask": _sds((n,), torch.float32)}
        loss_fn, meta = _gnn_full_loss(cfg, n), {"edges": e, **high}
    elif kind == "gnn_minibatch":
        shapes = graph_sampler.block_shapes(d["batch_nodes"],
                                            tuple(d["fanouts"]), d["d_feat"])
        batch = {k: _sds(sh, getattr(torch, dt.__name__))
                 for k, (sh, dt) in shapes.items()}
        loss_fn = ts.gnn_loss_fn(cfg, "minibatch")
        meta = {"seeds": d["batch_nodes"], **high}
    elif kind == "gnn_molecule":
        g, n, e, f = d["n_graphs"], d["n_nodes"], d["n_edges"], d["d_feat"]
        batch = {"node_feats": _sds((g, n, f), torch.float32),
                 "edges": _sds((g, e, 2), torch.int32),
                 "node_mask": _sds((g, n), torch.float32),
                 "labels": _sds((g,), torch.int32)}
        loss_fn, meta = _molecule_loss(cfg, n), {"graphs": g, **high}
    else:
        raise ValueError(kind)
    fn = _train_fn(ts.make_train_step(loss_fn, ocfg))
    return CellBundle(arch_id, cell, fn, (params, state, STEP, batch), meta)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def _rec_batch_sds(cfg, b: int) -> dict:
    out = {}
    if cfg.arch in ("din", "bst"):
        out = {
            "hist_items": _sds((b, cfg.seq_len), torch.int32),
            "hist_cats": _sds((b, cfg.seq_len), torch.int32),
            "target_item": _sds((b,), torch.int32),
            "target_cat": _sds((b,), torch.int32),
            "dense": _sds((b, cfg.n_dense), torch.float32),
            "label": _sds((b,), torch.float32),
        }
        if cfg.arch == "bst":
            out.pop("hist_cats")
            out.pop("target_cat")
    elif cfg.arch == "two_tower":
        out = {
            "user_id": _sds((b,), torch.int32),
            "hist_items": _sds((b, cfg.seq_len), torch.int32),
            "dense": _sds((b, cfg.n_dense), torch.float32),
            "item_id": _sds((b,), torch.int32),
            "item_cat": _sds((b,), torch.int32),
        }
    elif cfg.arch == "deepfm":
        out = {
            "sparse_ids": _sds((b, cfg.n_sparse_fields), torch.int32),
            "dense": _sds((b, cfg.n_dense), torch.float32),
            "label": _sds((b,), torch.float32),
        }
    return out


def _score_fn(cfg, mesh, variant: str) -> Callable:
    """``recsys_score`` over a model of the given parameters; two-tower's
    ``a2a`` / ``psum16`` over the mesh's ``model`` group."""
    impl = variant if variant in ("a2a", "psum16") else "xla"

    def fn(params, batch):
        model = convert.model_view(cfg, params)
        if isinstance(model, rec.TwoTower):
            model = model.with_lookup(impl, mesh.model_group)
        return rec.recsys_score(model, batch)
    return fn


def _rec_cell(arch_id, cfg, cell, mesh, variant="baseline") -> CellBundle:
    kind = cell.kind
    b = cell.dims["batch"]
    if kind == "rec_train":
        params, state, ocfg = _params_and_opt("recsys", cfg, True)
        batch = _rec_batch_sds(cfg, b)
        if variant == "sparse_emb":
            step_fn = ts.make_sparse_recsys_train_step(cfg, ocfg)
        else:
            step_fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
        return CellBundle(arch_id, cell, _train_fn(step_fn),
                          (params, state, STEP, batch),
                          {"examples": b, "has_opt": True})
    params, *_ = _params_and_opt("recsys", cfg, False)
    if kind == "rec_serve":
        batch = _rec_batch_sds(cfg, b)
        batch.pop("label", None)
        return CellBundle(arch_id, cell, _score_fn(cfg, mesh, variant),
                          (params, batch), {"examples": b})
    if kind == "rec_retrieval":
        n_cand = cell.dims["n_candidates"]
        top_k = min(100, n_cand)
        if cfg.arch == "two_tower":
            batch = _rec_batch_sds(cfg, b)
            for k in ("item_id", "item_cat"):
                batch.pop(k)

            def fn(params, batch, cand_ids, cand_cats):
                return rec.retrieval_scores(convert.model_view(cfg, params),
                                            batch, cand_ids, cand_cats,
                                            top_k)
            cand = (_sds((n_cand,), torch.int32),) * 2
            return CellBundle(arch_id, cell, fn, (params, batch) + cand,
                              {"candidates": n_cand})
        # pointwise archs: bulk-rank n_cand items for one user
        batch = _rec_batch_sds(cfg, n_cand)
        batch.pop("label", None)

        def fn(params, batch):
            return rec.bulk_rank(convert.model_view(cfg, params), batch,
                                 top_k)
        return CellBundle(arch_id, cell, fn, (params, batch),
                          {"candidates": n_cand})
    raise ValueError(kind)


# ---------------------------------------------------------------------------
def configs_of(arch_id: str) -> Any:
    """The config module of ``arch_id`` (its ``CONFIG`` and ``SMOKE``)."""
    family = registry.family(arch_id)
    return {"recsys": registry.ARCHS, "gnn": registry.GNN_ARCHS,
            "lm": registry.LM_ARCHS}[family][arch_id]


def all_cells() -> list:
    """(arch, cell name) of every cell of the registry."""
    return [(arch, c.name)
            for archs in (registry.ARCHS, registry.GNN_ARCHS,
                          registry.LM_ARCHS)
            for arch in archs
            for c in registry.CELLS[registry.family(arch)]]


def build_cell(arch_id: str, cell_name: str, mesh: mesh_mod.Mesh, *,
               smoke: bool = False, variant: str = "baseline") -> CellBundle:
    """The bundle of ``arch_id``'s cell ``cell_name`` at ``mesh``: at
    published width, or with ``smoke`` the SMOKE config at
    ``registry.reduce_cell``'s size."""
    if variant not in VARIANTS and not (variant.startswith("accum")
                                        and variant[5:].isdigit()):
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS} "
                         "or accumN")
    family = registry.family(arch_id)
    cell = registry.cell_by_name(cell_name, family)
    if smoke:
        cell = registry.reduce_cell(cell)
    configs = configs_of(arch_id)
    cfg = configs.SMOKE if smoke else configs.CONFIG
    if family == "lm":
        return _lm_cell(arch_id, cfg, cell, mesh, variant)
    if family == "gnn":
        return _gnn_cell(arch_id, cfg, cell, mesh)
    return _rec_cell(arch_id, cfg, cell, mesh, variant)
