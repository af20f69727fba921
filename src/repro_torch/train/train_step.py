"""Train steps, from the JAX package's ``train/train_step.py``: loss ->
gradients -> clipped update.

A train step maps ``(params, opt_state, step, batch)`` to ``(params',
opt_state', step + 1, metrics)``: ``params`` a path-keyed dict of tensors,
``opt_state`` ``{path: {name: tensor}}`` (``core/convert.py``), ``step`` an
int, ``batch`` a dict of tensors on the parameters' device.  ``metrics``
holds ``loss`` and ``grad_norm`` as 0-dim tensors (read them with
``float`` where the host needs them) and, where asked, ``delta_ids``.

* ``make_train_step`` differentiates the whole loss with autograd: every
  table's gradient is dense, as JAX's is.  With ``in_place`` it updates
  the caller's parameters and state in place (``opt.apply_updates_``, a
  block of a leaf at a time) and returns the same dicts, and a layer
  stack's gradient is a list of its layers' (never one tensor of the
  stack), each freed once its layer is updated: the LM launcher's step,
  whose parameters, gradients and state fill most of the card, where one
  contiguous gradient of a 32-layer stack (5.7 GB) did not fit the space
  its layers' gradients left behind.
* ``make_sparse_recsys_train_step`` gathers the rows a batch touches,
  differentiates with respect to those rows only and scatters row-wise
  Adagrad into the touched rows: into the table and its accumulator in
  place (``index_add_``), where JAX returns new arrays; so the caller's
  table tensors are the updated ones.

``lm_loss_fn``, ``recsys_loss_fn`` and ``gnn_loss_fn`` are the family
loss adapters that ``make_train_step`` differentiates (GraphSAGE with
``OptConfig()``: Adam on every leaf, as the JAX cell builder picks for
family ``gnn``; an LM with ``launch/cells.opt_cfg``'s rule).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import gnn
from repro_torch.models import lm
from repro_torch.models import recsys as rec
from repro_torch.train import optimizer as opt


def _by_layer(path: str, v: torch.Tensor,
              layer_leaves: Optional[Callable]) -> bool:
    """Whether the leaf at ``path`` is differentiated a layer at a time."""
    return layer_leaves is not None and layer_leaves(path) and v.dim() >= 3


def _value_and_grad(loss_fn: Callable, params: dict, *args,
                    layer_leaves: Optional[Callable] = None):
    """-> (loss, metrics, grads of ``loss_fn(params, *args)`` w.r.t. every
    entry of ``params``), each gradient in its entry's dtype.  An entry of
    three or more axes whose path ``layer_leaves`` names is differentiated
    a layer at a time: ``loss_fn`` gets it as the list of its first axis'
    views, each a leaf, and its gradient comes back as the list of
    theirs (a stack of vectors, a layer's norm gains, stays whole)."""
    leaves, flat = {}, []
    for k, v in params.items():
        if _by_layer(k, v, layer_leaves):
            leaves[k] = [t.requires_grad_() for t in v.detach().unbind(0)]
            flat.extend(leaves[k])
        else:
            leaves[k] = v.detach().requires_grad_()
            flat.append(leaves[k])
    loss, metrics = loss_fn(leaves, *args)
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g  # unused: zero, as JAX
    grads = {k: [grad(t) for t in p] if isinstance(p, list) else grad(p)
             for k, p in leaves.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptConfig,
                    accum_steps: int = 1,
                    delta_ids_fn: Optional[Callable] = None,
                    in_place: bool = False):
    """``loss_fn(params, batch) -> (loss, metrics)``.

    ``accum_steps`` > 1 splits the batch into that many microbatches along
    its first axis and sums their gradients in order into fp32 (then
    divides), as the JAX step's ``scan`` does; ``metrics`` are the last
    microbatch's.

    ``in_place``: the update writes into ``params`` and ``opt_state``
    (module docstring), which the step returns, and the layer stacks
    (``lm.is_stacked``) are differentiated a layer at a time
    (``_value_and_grad``), their gradients a list of layers through the
    update (with ``accum_steps``, each layer's fp32 sum a tensor of its
    own), so the update's work grows by a layer a layer.

    ``delta_ids_fn(batch) -> {table_name: ids}`` adds the embedding rows
    this step touched to ``metrics["delta_ids"]``: the per-step delta a
    driver accumulates into incremental serving publishes
    (``engine.publish_delta``)."""

    layer_leaves = lm.is_stacked if in_place else None

    def train_step(params: dict, opt_state: dict, step: int, batch: dict):
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(
                loss_fn, params, batch, layer_leaves=layer_leaves)
        else:
            # fp32 sums; a layered leaf's a list of its layers', as its
            # gradients come (the update then goes a layer at a time)
            grads = {k: [torch.zeros(p.shape[1:], dtype=torch.float32,
                                     device=p.device)
                         for _ in range(p.shape[0])]
                     if _by_layer(k, p, layer_leaves) else
                     torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for k, p in params.items()}
            loss = 0.0
            for i in range(accum_steps):
                mb = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                   + x.shape[1:])[i]
                      for k, x in batch.items()}
                l, metrics, g = _value_and_grad(
                    loss_fn, params, mb, layer_leaves=layer_leaves)
                for k in grads:
                    if isinstance(g[k], list):
                        for acc, part in zip(grads[k], g[k]):
                            acc += part
                    else:
                        grads[k] += g[k]
                del g
                loss = loss + l
            for g in grads.values():
                for part in g if isinstance(g, list) else [g]:
                    part /= accum_steps
            loss = loss / accum_steps
        if in_place:
            gnorm = opt.apply_updates_(params, grads, opt_state, opt_cfg,
                                       step + 1)
            new_params, new_state = params, opt_state
        else:
            new_params, new_state, gnorm = opt.apply_updates(
                params, grads, opt_state, opt_cfg, step + 1)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        if delta_ids_fn is not None:
            metrics["delta_ids"] = delta_ids_fn(batch)
        return new_params, new_state, step + 1, metrics

    return train_step


def make_sparse_recsys_train_step(cfg, opt_cfg: opt.OptConfig,
                                  emit_deltas: bool = False):
    """The sparse-embedding step of ``cfg``'s recsys model: rows gathered
    (zeros for a negative id), gradients w.r.t. the dense parameters and
    the rows only, ``apply_updates`` on the dense parameters (so
    ``grad_norm`` covers those alone), then per table, for each of its row
    keys in ``table_ids``' order: the rows' mean squared gradient added into
    the accumulator at their ids (all of a key's rows before any scale is
    read), ``scale = lr / (sqrt(acc[id]) + eps)``, and ``-scale * g`` added
    into the table's rows.  Duplicate ids accumulate.  Tables and their
    accumulators are updated in place.

    ``emit_deltas=True`` adds ``metrics["delta_ids"]``: per table the raw
    (repeated, -1-padded) row ids it scattered into, its row keys in sorted
    order."""

    def train_step(params: dict, opt_state: dict, step: int, batch: dict):
        ids_map = rec.table_ids(cfg, batch)
        table_names = sorted({t for t, _ in ids_map.values()})
        dense = {k: v for k, v in params.items() if k not in table_names}
        rows = {k: params[t][ids.long().clamp(min=0)]
                * (ids >= 0).to(params[t].dtype)[..., None]
                for k, (t, ids) in ids_map.items()}

        def loss_on(leaves, tables):
            merged = {**{k: leaves[k] for k in dense}, **tables}
            return rec.recsys_loss_rows(
                merged, cfg, batch, {k: leaves["rows/" + k] for k in rows})

        both = {**dense, **{"rows/" + k: v for k, v in rows.items()}}
        loss, metrics, g = _value_and_grad(
            loss_on, both, {t: params[t] for t in table_names})
        new_dense, new_dense_state, gnorm = opt.apply_updates(
            dense, {k: g[k] for k in dense},
            {k: opt_state[k] for k in dense}, opt_cfg, step + 1)

        new_params, new_state = dict(params), dict(opt_state)
        new_params.update(new_dense)
        new_state.update(new_dense_state)
        for t in table_names:
            table, acc = params[t], opt_state[t]["acc"]
            for k, (tname, ids) in ids_map.items():
                if tname != t:
                    continue
                flat = ids.reshape(-1)
                flat_ids = flat.long().clamp(min=0)
                gf = g["rows/" + k].float().reshape(-1, table.shape[-1]) \
                    * (flat >= 0).float()[:, None]
                acc.index_add_(0, flat_ids, (gf * gf).mean(dim=-1))
                scale = opt_cfg.lr / (torch.sqrt(acc[flat_ids])
                                      + opt_cfg.eps)
                table.index_add_(0, flat_ids,
                                 (-scale[:, None] * gf).to(table.dtype))
            new_state[t] = {"acc": acc}
        metrics = dict(metrics, grad_norm=gnorm)
        if emit_deltas:
            metrics["delta_ids"] = {
                t: torch.cat([ids.reshape(-1)
                              for k, (tn, ids) in sorted(ids_map.items())
                              if tn == t])
                for t in table_names}
        return new_params, new_state, step + 1, metrics

    return train_step


def lm_loss_fn(cfg) -> Callable:
    """``lm.lm_loss`` of ``cfg`` as ``loss_fn(params, batch)`` (its stacks
    tensors or lists of layers)."""
    def fn(params: dict, batch: dict):
        return lm.lm_loss(params, cfg, batch)
    return fn


def recsys_loss_fn(cfg) -> Callable:
    def fn(params: dict, batch: dict):
        return rec.recsys_loss(params, cfg, batch)
    return fn


def gnn_loss_fn(cfg, regime: str) -> Callable:
    """``gnn.gnn_loss`` of ``cfg`` in ``regime`` (full_graph | minibatch |
    molecule) as ``loss_fn(params, batch)``."""
    def fn(params: dict, batch: dict):
        return gnn.gnn_loss(params, cfg, batch, regime)
    return fn
