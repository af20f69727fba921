"""The serving steps, from the JAX package's ``serve/serve_step.py``.

``lm_prefill_fn`` and ``lm_decode_fn`` serve an LM (``models/lm.py``): a
prompt's last-position logits, and one token of decode over the caches.

``recsys_score_fn`` scores a batch with any of the four recsys archs (DIN,
BST, DeepFM, the two-tower user tower); ``retrieval_fn`` (two-tower) and
``bulk_rank_fn`` (DeepFM, DIN, BST: 1M candidate rows, DIN's and BST's
scored in row slices) serve the ``retrieval_cand`` cell, the top
candidates of one user.
Each step sends the columns the model reads (and the candidates) to the
card in one copy and the model scores them there.  With a feature source,
a scoring request's feature columns are first resolved in ONE fused,
version-pinned ``FeatureClient`` query over the port's ``MultiTableEngine``
(whose probe runs on the card), directly or through a ``QueryServer`` that
coalesces concurrent requests' lookups into micro-batches, and spliced
into the batch's dense columns on the host (paper Fig 2's query side in
front of the model).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.client import FeatureClient
from repro_torch.api.types import QoSClass
from repro_torch.models import lm as lm_mod
from repro_torch.models import recsys as rec


def lm_decode_fn(cfg, mesh=None, smax: Optional[int] = None):
    """``step(params, token [B], pos [B], caches) -> (logits [B, V],
    caches)``: one token of decode, the caches written in place at
    ``pos``.  At a ``mesh``, this rank's part (``lm.lm_decode_step``): its
    rows' logits, its slices of caches of ``smax`` positions."""
    @torch.no_grad()
    def step(params, token, pos, caches):
        return lm_mod.lm_decode_step(params, cfg, token, pos, caches, mesh,
                                     smax)
    return step


def lm_prefill_fn(cfg, mesh=None):
    """``step(params, tokens [B, S]) -> logits [B, V]`` of the last
    position (at a ``mesh``, of this rank's rows)."""
    @torch.no_grad()
    def step(params, tokens):
        h, _ = lm_mod.lm_backbone(params, cfg, tokens, mesh=mesh)
        return lm_mod.lm_logits(params, cfg, h[:, -1:])[:, 0]
    return step


def _upload(batch: dict, device: torch.device) -> dict:
    """The batch's columns on ``device`` in one host-to-device copy: each is
    a 4-byte column (integer ids, checked to fit int32, or float32), laid
    end to end as int32 words and split again on the card, so every column
    arrives contiguous."""
    cols = {}
    for name, a in batch.items():
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        elif a.dtype != np.int32:
            if a.size and (a.min() < np.iinfo(np.int32).min
                           or a.max() > np.iinfo(np.int32).max):
                raise ValueError(f"{name} must fit in int32")
            a = a.astype(np.int32)
        cols[name] = a
    words = torch.from_numpy(np.concatenate(
        [a.reshape(-1).view(np.int32) for a in cols.values()])).to(device)
    out, at = {}, 0
    for name, a in cols.items():
        t = words[at:at + a.size].view(a.shape)
        out[name] = t.view(torch.float32) if a.dtype == np.float32 else t
        at += a.size
    return out


def _splice(fields: Sequence[tuple], res, dense) -> np.ndarray:
    """``dense`` with its leading columns replaced by the resolved feature
    columns, in ``fields`` order: an embedding row viewed as float32, a
    scalar's payload as float32, both times ``found`` (a miss gives
    zeros)."""
    cols = []
    for table, _field in fields:
        tr = res[table]
        if tr.values is not None:            # embedding: float32 rows
            rows = np.ascontiguousarray(tr.values).view(np.float32)
            rows = rows.reshape(len(tr.found), -1)
        else:                                # scalar: payload column
            rows = tr.payloads.astype(np.float32)[:, None]
        cols.append(rows * tr.found[:, None])
    feats = np.concatenate(cols, axis=-1)
    dense = np.array(dense, dtype=np.float32)
    d = min(feats.shape[1], dense.shape[1])
    dense[:, :d] = feats[:, :d]
    return dense


def recsys_score_fn(cfg, model, *, feature_client=None, feature_engine=None,
                    feature_server=None,
                    feature_fields: Optional[Sequence[tuple]] = None,
                    feature_qos="RANKING",
                    feature_budget_s: Optional[float] = None,
                    lookup_impl: str = "xla", group=None):
    """Scoring step ``step(batch)`` on the model's device: ``recsys_score``
    of the batch's ``model.inputs`` columns, uploaded in one copy (the CTR
    probabilities [B] of DIN, BST and DeepFM, two-tower's user vectors
    [B, tower_mlp[-1]]).  DIN and BST are served with no feature source, as
    the JAX launcher serves them (their batches have no ``sparse_ids``
    keys to look up).  With a feature source the step first resolves
    ``feature_fields`` — ``(table_name, batch_field)`` pairs — in one fused
    batch query and splices the returned float32 rows into the batch's
    dense columns before the model runs.

    The source is a ``feature_client`` (``api.FeatureClient``; over a
    ``QueryServer`` its lookups coalesce with other in-flight scoring
    requests into QoS-laned micro-batches), a ``feature_engine`` (a
    ``MultiTableEngine``) or a ``feature_server`` (a
    ``serve.server.QueryServer``), the last two each wrapped in a client
    here; at most one may be given.  Lookups ride the ``feature_qos`` lane
    with ``feature_budget_s`` as their budget.

    ``lookup_impl`` and ``group`` pick two-tower's user-tower lookups
    (``TwoTower.with_lookup``: ``xla``, or ``a2a`` / ``psum16`` over the
    ranks of ``group``, each rank scoring its own slice of the batch); the
    pointwise archs take ``xla`` only."""
    if cfg.arch not in rec.INIT:
        raise NotImplementedError(rec.NOT_PORTED.format(arch=cfg.arch))
    if isinstance(model, rec.TwoTower):
        model = model.with_lookup(lookup_impl, group)
    elif lookup_impl != "xla" or group is not None:
        raise ValueError(f"{cfg.name} serves its whole tables: lookup_impl "
                         f"{lookup_impl!r} and a group are two-tower's")
    device = model.device

    def step(batch):
        return rec.recsys_score(model, _upload(
            {k: batch[k] for k in model.inputs}, device))

    sources = [s for s in (feature_engine, feature_server, feature_client)
               if s is not None]
    if len(sources) > 1:
        raise ValueError("pass exactly one of feature_client / "
                         "feature_engine / feature_server")
    if not sources:
        return step

    client = (feature_client if feature_client is not None
              else FeatureClient(sources[0]))
    qos = QoSClass.parse(feature_qos)
    fields = list(feature_fields or ())
    if not fields:
        raise ValueError("feature engine/server/client given but no "
                         "feature_fields")
    names = [t for t, _ in fields]
    if len(set(names)) != len(names):
        raise ValueError("duplicate table names in feature_fields: one "
                         "fused request carries one key set per table")

    def step_with_store(batch):
        n_rows = len(np.asarray(batch["dense"]))
        request = {}
        for table, field in fields:
            ids = np.asarray(batch[field])
            if ids.ndim != 1 or len(ids) != n_rows:
                raise ValueError(
                    f"feature field {field!r} must be 1-D of length "
                    f"{n_rows} (one key per example), got {ids.shape}")
            request[table] = ids.astype(np.uint64)
        res = client.query(request, qos=qos,            # one fused query,
                           budget_s=feature_budget_s)   # pinned
        batch = dict(batch, dense=_splice(fields, res, batch["dense"]))
        return step(batch)

    return step_with_store


def retrieval_fn(cfg, model, top_k: int = 100):
    """Retrieval step ``step(batch, cand_ids, cand_cats)`` on the model's
    device (two-tower): ``rec.retrieval_scores`` of the user columns of
    ``batch`` against the candidates ``cand_ids``, ``cand_cats`` [N], all
    uploaded in one copy -> (values, indices), each [B, top_k].  No
    feature source, as in the JAX package's ``retrieval_cand`` cell."""
    if cfg.arch != "two_tower":
        raise ValueError(f"retrieval_fn serves two_tower, not {cfg.arch}; "
                         "a pointwise arch ranks through bulk_rank_fn")
    device = model.device

    def step(batch, cand_ids, cand_cats):
        cols = _upload({**{k: batch[k] for k in model.inputs},
                        "cand_ids": cand_ids, "cand_cats": cand_cats},
                       device)
        return rec.retrieval_scores(model, cols, cols["cand_ids"],
                                    cols["cand_cats"], top_k)
    return step


def bulk_rank_fn(cfg, model, top_k: int = 100,
                 chunk_rows: Optional[int] = None):
    """``retrieval_cand`` for a pointwise arch (DeepFM, DIN, BST):
    ``step(batch)`` uploads the model's columns of N candidate rows in one
    copy and returns ``rec.bulk_rank`` of them on the model's device ->
    (values, indices) of the top ``top_k`` logits, the forward run on row
    slices of the uploaded columns (``chunk_rows``: ``rec.bulk_rank``'s
    default when None)."""
    if cfg.arch == "two_tower":
        raise ValueError("bulk_rank_fn ranks a pointwise arch (DeepFM, DIN, "
                         "BST), not two_tower; two_tower retrieves through "
                         "retrieval_fn")
    if cfg.arch not in rec.INIT:
        raise NotImplementedError(rec.NOT_PORTED.format(arch=cfg.arch))
    device = model.device

    def step(batch):
        return rec.bulk_rank(model, _upload(
            {k: batch[k] for k in model.inputs}, device), top_k, chunk_rows)
    return step
