"""Recsys and GNN train steps, from the JAX package's
``train/train_step.py``: loss -> gradients -> clipped update.

A train step maps ``(params, opt_state, step, batch)`` to ``(params',
opt_state', step + 1, metrics)``: ``params`` a path-keyed dict of tensors,
``opt_state`` ``{path: {name: tensor}}`` (``core/convert.py``), ``step`` an
int, ``batch`` a dict of tensors on the parameters' device.  ``metrics``
holds ``loss`` and ``grad_norm`` as 0-dim tensors (read them with
``float`` where the host needs them) and, where asked, ``delta_ids``.

* ``make_train_step`` differentiates the whole loss with autograd: every
  table's gradient is dense, as JAX's is.
* ``make_sparse_recsys_train_step`` gathers the rows a batch touches,
  differentiates with respect to those rows only and scatters row-wise
  Adagrad into the touched rows: into the table and its accumulator in
  place (``index_add_``), where JAX returns new arrays; so the caller's
  table tensors are the updated ones.

``recsys_loss_fn`` and ``gnn_loss_fn`` are the family loss adapters that
``make_train_step`` differentiates (GraphSAGE with ``OptConfig()``: Adam
on every leaf, as the JAX cell builder picks for family ``gnn``).  The LM
models serve (``models/lm.py``); their loss adapter, ``lm_loss_fn``, comes
with LM training (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import gnn
from repro_torch.models import recsys as rec
from repro_torch.train import optimizer as opt


def _value_and_grad(loss_fn: Callable, params: dict, *args):
    """-> (loss, metrics, grads of ``loss_fn(params, *args)`` w.r.t. every
    entry of ``params``), each gradient in its entry's dtype."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        k: torch.zeros_like(p) if g is None else g     # unused: zero, as JAX
        for (k, p), g in zip(leaves.items(), grads)}


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptConfig,
                    accum_steps: int = 1,
                    delta_ids_fn: Optional[Callable] = None):
    """``loss_fn(params, batch) -> (loss, metrics)``.

    ``accum_steps`` > 1 splits the batch into that many microbatches along
    its first axis and sums their gradients in order (then divides), as the
    JAX step's ``scan`` does; ``metrics`` are the last microbatch's.

    ``delta_ids_fn(batch) -> {table_name: ids}`` adds the embedding rows
    this step touched to ``metrics["delta_ids"]``: the per-step delta a
    driver accumulates into incremental serving publishes
    (``engine.publish_delta``)."""

    def train_step(params: dict, opt_state: dict, step: int, batch: dict):
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = 0.0
            for i in range(accum_steps):
                mb = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                   + x.shape[1:])[i]
                      for k, x in batch.items()}
                l, metrics, g = _value_and_grad(loss_fn, params, mb)
                grads = {k: grads[k] + g[k] for k in grads}
                loss = loss + l
            grads = {k: g / accum_steps for k, g in grads.items()}
            loss = loss / accum_steps
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
