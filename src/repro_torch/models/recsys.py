"""Recsys models, from the JAX package's ``models/recsys.py``: DeepFM.

DeepFM scores a request of ``sparse_ids`` [B, F] (one id per field) and
``dense`` [B, n_dense] features: an FM branch over the fields' embeddings,
whose second-order term runs on the ``fused_fm`` CUDA kernel on the card
(``kernels/ops.fm_interaction``), beside a deep MLP over the same
embeddings and the dense features.  The port runs one card: every table
lives whole on it.

DIN, BST and two-tower wait for the ``embedding_bag`` kernel (ROADMAP
queue 1, items 10-11; queue 2, item c): their entry points here raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import embedding_service as es

NOT_PORTED = ("only deepfm is ported; {arch} waits for the embedding_bag "
              "kernel (ROADMAP queue 1, items 10-11; queue 2, item c)")


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str                     # din | bst | two_tower | deepfm
    embed_dim: int
    item_vocab: int = 1_000_000
    cat_vocab: int = 10_000
    user_vocab: int = 1_000_000
    seq_len: int = 0              # user-behaviour history length
    n_dense: int = 13
    n_sparse_fields: int = 0      # deepfm fields
    field_vocab: int = 100_000
    mlp: tuple = ()
    attn_mlp: tuple = ()          # din
    n_blocks: int = 1             # bst
    n_heads: int = 8              # bst
    tower_mlp: tuple = ()         # two_tower
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _mlp_apply(layers: Sequence[tuple[torch.Tensor, torch.Tensor]],
               x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU after every layer but the last."""
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


class DeepFM(nn.Module):
    """DeepFM's parameters on one device, as the JAX package's
    ``deepfm_init`` lays them out: ``field_table`` [V·F, D] and ``w1_table``
    [V·F, 1] (one table for all fields, field f's ids offset by f·V),
    ``dense_w1`` [n_dense, 1], the MLP's ``(w [in, out], b [out])`` layers
    from F·D + n_dense to 1, and the scalar ``bias``."""

    def __init__(self, cfg: RecsysConfig, *, field_table: torch.Tensor,
                 w1_table: torch.Tensor, dense_w1: torch.Tensor,
                 mlp: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 bias: torch.Tensor):
        super().__init__()
        self.cfg = cfg

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.field_table = param(field_table)
        self.w1_table = param(w1_table)
        self.dense_w1 = param(dense_w1)
        self.mlp_w = nn.ParameterList([param(w) for w, _ in mlp])
        self.mlp_b = nn.ParameterList([param(b) for _, b in mlp])
        self.bias = param(bias)
        self.register_buffer("field_offset", torch.arange(
            cfg.n_sparse_fields, device=field_table.device) * cfg.field_vocab)

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """sparse_ids [B, F] (any int dtype), dense [B, n_dense] -> logits
        [B]."""
        flat_ids = sparse_ids.long() + self.field_offset
        emb = es.embed_lookup(self.field_table, flat_ids)         # [B, F, D]
        fm2 = ops.fm_interaction(emb)                             # [B]
        w1 = es.embed_lookup(self.w1_table, flat_ids)[..., 0].sum(-1)
        dense1 = (dense @ self.dense_w1)[..., 0]
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
        deep = _mlp_apply(list(zip(self.mlp_w, self.mlp_b)), deep_in)[..., 0]
        return self.bias + w1 + dense1 + fm2.to(deep.dtype) + deep


def deepfm_init(cfg: RecsysConfig, *, generator: torch.Generator,
                device) -> DeepFM:
    """Random DeepFM weights drawn on ``device`` (the JAX package's
    ``deepfm_init``: tables at scale 0.05, dense weights at 1/sqrt(in),
    zero biases)."""
    d, f, dt = cfg.embed_dim, cfg.n_sparse_fields, cfg.torch_dtype
    kw = dict(generator=generator, device=device, dtype=dt)
    field_table = es.table_init(es.TableCfg(
        "fields", cfg.field_vocab * f, d), **kw)
    w1_table = es.table_init(es.TableCfg(
        "fields_w1", cfg.field_vocab * f, 1), **kw)
    dense_w1 = cm.dense_param(cfg.n_dense, 1, **kw)
    dims = (f * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,)
    mlp = [(cm.dense_param(i, o, **kw),
            torch.zeros(o, dtype=dt, device=device))
           for i, o in zip(dims[:-1], dims[1:])]
    return DeepFM(cfg, field_table=field_table, w1_table=w1_table,
                  dense_w1=dense_w1, mlp=mlp,
                  bias=torch.zeros((), dtype=dt, device=device))


def recsys_init(cfg: RecsysConfig, *, seed: int = 0,
                device=None) -> DeepFM:
    """The model of ``cfg`` with random weights from ``seed``, on
    ``device`` (default ``"cuda"``; raises without a card)."""
    if cfg.arch != "deepfm":
        raise NotImplementedError(NOT_PORTED.format(arch=cfg.arch))
    device = ops.resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return deepfm_init(cfg, generator=generator, device=device)


def recsys_score(model: nn.Module, batch: dict) -> torch.Tensor:
    """Serving: CTR probability [B] of a batch holding ``sparse_ids`` and
    ``dense`` (tensors on the model's device, or arrays, which are moved
    there)."""
    if not isinstance(model, DeepFM):
        raise NotImplementedError(NOT_PORTED.format(
            arch=type(model).__name__))
    dev = model.device
    ids = torch.as_tensor(batch["sparse_ids"], device=dev)
    dense = torch.as_tensor(batch["dense"], device=dev)
    with torch.inference_mode():
        return torch.sigmoid(model(ids, dense))
