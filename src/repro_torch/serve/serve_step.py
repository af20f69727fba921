"""The recsys scoring step, from the JAX package's ``serve/serve_step.py``.

With a feature source, a request's feature columns are resolved in ONE
fused, version-pinned ``FeatureClient`` query over the port's
``MultiTableEngine`` (whose probe runs on the card), spliced into the
batch's dense columns on the host, and the batch crosses to the card in one
copy; the model then scores it there (paper Fig 2's query side in front of
the model).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.client import FeatureClient
from repro_torch.api.types import QoSClass
from repro_torch.models import recsys as rec


def _upload(batch: dict, device: torch.device) -> dict:
    """The model's inputs (``sparse_ids``, ``dense``) on ``device`` in one
    host-to-device copy: both are 4-byte columns, packed side by side as
    int32 words and split again on the card."""
    ids = np.asarray(batch["sparse_ids"])
    dense = np.asarray(batch["dense"], dtype=np.float32)
    if ids.dtype != np.int32:
        if ids.size and (ids.min() < np.iinfo(np.int32).min
                         or ids.max() > np.iinfo(np.int32).max):
            raise ValueError("sparse_ids must fit in int32")
        ids = ids.astype(np.int32)
    n_ids = ids.shape[1]
    words = torch.from_numpy(np.concatenate(
        [ids, dense.view(np.int32)], axis=1)).to(device)
    return {"sparse_ids": words[:, :n_ids],
            "dense": words[:, n_ids:].view(torch.float32)}


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
                    feature_budget_s: Optional[float] = None):
    """Scoring step ``step(batch) -> CTR probabilities [B]`` on the model's
    device.  With a feature source the step first resolves
    ``feature_fields`` — ``(table_name, batch_field)`` pairs — in one fused
    batch query and splices the returned float32 rows into the batch's
    dense columns before the model runs.

    The source is a ``feature_client`` (``api.FeatureClient``) or a
    ``feature_engine`` (a ``MultiTableEngine``, wrapped in a client here);
    at most one may be given.  Lookups ride the ``feature_qos`` lane with
    ``feature_budget_s`` as their budget.  ``feature_server`` waits for the
    port's ``QueryServer`` (ROADMAP queue 1, item 9) and raises."""
    if feature_server is not None:
        raise NotImplementedError(
            "feature_server needs the QueryServer, which is not ported yet "
            "(ROADMAP queue 1, item 9); pass feature_client or "
            "feature_engine")
    if cfg.arch != "deepfm":
        raise NotImplementedError(rec.NOT_PORTED.format(arch=cfg.arch))
    device = model.device

    def step(batch):
        return rec.recsys_score(model, _upload(batch, device))

    sources = [s for s in (feature_engine, feature_client) if s is not None]
    if len(sources) > 1:
        raise ValueError("pass exactly one of feature_client / "
                         "feature_engine")
    if not sources:
        return step

    client = (feature_client if feature_client is not None
              else FeatureClient(feature_engine))
    qos = QoSClass.parse(feature_qos)
    fields = list(feature_fields or ())
    if not fields:
        raise ValueError("feature engine/client given but no feature_fields")
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
