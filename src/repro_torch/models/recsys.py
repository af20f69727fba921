"""Recsys models, from the JAX package's ``models/recsys.py``: DeepFM, the
two-tower towers, DIN and BST, with the serving heads of the
``retrieval_cand`` cell.

DeepFM scores a request of ``sparse_ids`` [B, F] (one id per field) and
``dense`` [B, n_dense] features: an FM branch over the fields' embeddings,
whose second-order term runs on the ``fused_fm`` CUDA kernel on the card
(``kernels/ops.fm_interaction``), beside a deep MLP over the same
embeddings and the dense features.

Two-tower serving scores a request of ``user_id`` [B], ``hist_items``
[B, L] (-1 pad) and ``dense`` [B, n_dense] with the user tower: the user's
row, the mean of the history's item rows (the ``embedding_bag`` CUDA kernel
on the card, ``embedding_service.embed_bag``) and the dense features
through an MLP, L2-normalised.  The item tower maps candidates
(``item_id``, ``item_cat``) through their rows and its own MLP, also
L2-normalised.

DIN scores a request of ``hist_items``, ``hist_cats`` [B, L] (-1 pad),
``target_item``, ``target_cat`` [B] and ``dense`` [B, n_dense]: each
history step's item and category rows against the target's, through an
attention MLP with sigmoids between its layers and a linear last layer,
give one unnormalised weight a step (zero where the step is padding); the
weighted sum of the steps, the target and the dense features go through
the head MLP.  BST scores ``hist_items`` [B, L], ``target_item`` [B] and
``dense``: the L + 1 item rows plus a position table through transformer
blocks (multi-head attention with padded keys masked, layer norms, a
ReLU FFN), flattened beside the dense features into the head MLP.  Both
reach no kernel: their gathers are ``embed_lookup`` and their layers
plain PyTorch, as the JAX package computes them outside any Pallas kernel.

``retrieval_scores`` (two-tower: user vectors against every candidate's
item vector) and ``bulk_rank`` (DeepFM, DIN, BST: the logits of a batch of
candidate rows, scored in row slices) end in ``lax_top_k``, which keeps
``jax.lax.top_k``'s order: values descending by the float total order
(+0.0 above -0.0, NaN by its sign beyond the infinities), equal values by
ascending index.

The training half (``table_ids`` to ``recsys_loss``) is the JAX package's,
over the parameters as one flat dict of tensors keyed by the JAX pytree
paths (``field_table``, ``mlp/0/w``, ``blocks/0/wq``; ``core/convert.py``
maps a model to it): ``recsys_loss`` is what the dense train step
differentiates, ``recsys_loss_rows`` over gathered rows what the sparse
step does.  It leaves the serving models above alone: they keep frozen
parameters and score under ``inference_mode``.

A model runs on one card with every table whole on it, but for
two-tower's user tower, which ``TwoTower.lookup_impl`` also serves from
row blocks over the ranks of a process group (the JAX package's ``a2a``
and ``psum16`` lookups).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import embedding_service as es

NOT_PORTED = ("{arch} is not ported: the port trains and serves the four "
              "recsys archs (din, bst, two_tower, deepfm), graphsage-reddit "
              "and the five LM archs (train_4k, prefill_32k, decode_32k, "
              "long_500k on one device; their serving sequence-sharded "
              "and expert-parallel over a torch.distributed world), and "
              "builds and dry-runs every cell at one device; training "
              "through the expert-parallel exchange, the dense weights' "
              "FSDP / tensor-parallel placement and the production mesh "
              "wait for ROADMAP queue 1, item 15.4")


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
               x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` after every layer but the last."""
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i + 1 < len(layers):
            x = act(x)
    return x


def _mlp_init(dims: Sequence[int], **kw) -> list:
    """The JAX package's ``_mlp_init``: per layer a 1/sqrt(in)-scaled
    weight and a zero bias."""
    return [(cm.dense_param(i, o, **kw),
             torch.zeros(o, dtype=kw["dtype"], device=kw["device"]))
            for i, o in zip(dims[:-1], dims[1:])]


class _Recsys(nn.Module):
    """What the port's models share: frozen parameters on one device, and
    ``inputs``, the batch columns ``forward`` takes, in order."""

    inputs: tuple = ()

    @staticmethod
    def _param(t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    @classmethod
    def _mlp(cls, layers) -> tuple[nn.ParameterList, nn.ParameterList]:
        return (nn.ParameterList([cls._param(w) for w, _ in layers]),
                nn.ParameterList([cls._param(b) for _, b in layers]))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())


class DeepFM(_Recsys):
    """DeepFM's parameters on one device, as the JAX package's
    ``deepfm_init`` lays them out: ``field_table`` [V·F, D] and ``w1_table``
    [V·F, 1] (one table for all fields, field f's ids offset by f·V),
    ``dense_w1`` [n_dense, 1], the MLP's ``(w [in, out], b [out])`` layers
    from F·D + n_dense to 1, and the scalar ``bias``."""

    inputs = ("sparse_ids", "dense")

    def __init__(self, cfg: RecsysConfig, *, field_table: torch.Tensor,
                 w1_table: torch.Tensor, dense_w1: torch.Tensor,
                 mlp: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 bias: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.field_table = self._param(field_table)
        self.w1_table = self._param(w1_table)
        self.dense_w1 = self._param(dense_w1)
        self.mlp_w, self.mlp_b = self._mlp(mlp)
        self.bias = self._param(bias)
        self.register_buffer("field_offset", torch.arange(
            cfg.n_sparse_fields, device=field_table.device) * cfg.field_vocab)

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
    mlp = _mlp_init((f * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,), **kw)
    return DeepFM(cfg, field_table=field_table, w1_table=w1_table,
                  dense_w1=dense_w1, mlp=mlp,
                  bias=torch.zeros((), dtype=dt, device=device))


class TwoTower(_Recsys):
    """Two-tower parameters on one device, as the JAX package's
    ``two_tower_init`` lays them out: ``user_table`` [user_vocab, D],
    ``item_table`` [item_vocab, D], ``cat_table`` [cat_vocab, D], and the
    ``(w [in, out], b [out])`` layers of ``user_mlp`` (2·D + n_dense ->
    tower_mlp) and ``item_mlp`` (2·D -> tower_mlp).  ``forward`` is the
    user tower, ``item_tower`` the item tower.

    ``lookup_impl`` picks the user tower's lookups as the JAX package's
    ``user_tower`` does: ``xla`` (whole tables: a gather and the bag
    kernel), or, over the ranks of ``group`` (None: the default group),
    ``a2a`` (both tables through ``embed_lookup_a2a``, the history's mean
    taken here) or ``psum16`` (the user row through ``embed_lookup_a2a``,
    the history through ``embed_bag_psum``).  Then ``user_table`` and
    ``item_table`` may be this rank's row blocks
    (``core/convert.two_tower_row_blocks``); a model of row blocks serves
    the user tower only."""

    inputs = ("user_id", "hist_items", "dense")

    def __init__(self, cfg: RecsysConfig, *, user_table: torch.Tensor,
                 item_table: torch.Tensor, cat_table: torch.Tensor,
                 user_mlp: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 item_mlp: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 lookup_impl: str = "xla", group=None):
        super().__init__()
        self.cfg = cfg
        self.user_table = self._param(user_table)
        self.item_table = self._param(item_table)
        self.cat_table = self._param(cat_table)
        self.user_mlp_w, self.user_mlp_b = self._mlp(user_mlp)
        self.item_mlp_w, self.item_mlp_b = self._mlp(item_mlp)
        self.lookup_impl, self.group = _lookup_impl(lookup_impl), group

    @property
    def row_blocks(self) -> bool:
        """True when the user and item tables are one rank's row blocks."""
        return (self.user_table.shape[0], self.item_table.shape[0]) != \
            (self.cfg.user_vocab, self.cfg.item_vocab)

    def with_lookup(self, lookup_impl: str, group=None) -> "TwoTower":
        """The same parameters (shared, not copied) under another
        ``lookup_impl`` and ``group``."""
        other = copy.copy(self)
        other.lookup_impl, other.group = _lookup_impl(lookup_impl), group
        return other

    def forward(self, user_id: torch.Tensor, hist_items: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """user_id [B], hist_items [B, L] (-1 pad; int32 on the card),
        dense [B, n_dense] -> the L2-normalised user vector
        [B, tower_mlp[-1]]: the JAX package's ``user_tower`` with this
        model's ``lookup_impl``."""
        cfg, group = self.cfg, self.group
        if self.lookup_impl == "a2a":
            u = es.embed_lookup_a2a(self.user_table, user_id,
                                    cfg.user_vocab, group)
            rows = es.embed_lookup_a2a(self.item_table, hist_items,
                                       cfg.item_vocab, group)
            valid = (hist_items >= 0).to(rows.dtype)
            hist = (rows * valid[..., None]).sum(1) / \
                valid.sum(1)[:, None].clamp(min=1.0)
        elif self.lookup_impl == "psum16":
            u = es.embed_lookup_a2a(self.user_table, user_id,
                                    cfg.user_vocab, group)
            hist = es.embed_bag_psum(self.item_table,
                                     hist_items.to(torch.int32),
                                     cfg.item_vocab, "mean", group)
        else:
            self._whole("the xla lookups")
            u = es.embed_lookup(self.user_table, user_id)           # [B, D]
            hist = es.embed_bag(self.item_table, hist_items.to(torch.int32),
                                None, "mean")                        # [B, D]
        x = torch.cat([u, hist.to(u.dtype), dense], dim=-1)
        return _l2_normalise(
            _mlp_apply(list(zip(self.user_mlp_w, self.user_mlp_b)), x))

    def item_tower(self, item_id: torch.Tensor,
                   item_cat: torch.Tensor) -> torch.Tensor:
        """item_id [N], item_cat [N] -> the L2-normalised item vector
        [N, tower_mlp[-1]]: the JAX package's ``item_tower`` ('xla'
        lookups)."""
        self._whole("the item tower")
        e = torch.cat([es.embed_lookup(self.item_table, item_id),
                       es.embed_lookup(self.cat_table, item_cat)], dim=-1)
        return _l2_normalise(
            _mlp_apply(list(zip(self.item_mlp_w, self.item_mlp_b)), e))

    def _whole(self, what: str) -> None:
        if self.row_blocks:
            raise ValueError(f"{what} needs whole tables; this model holds "
                             f"row blocks of {self.user_table.shape[0]} "
                             f"users and {self.item_table.shape[0]} items")


LOOKUP_IMPLS = ("xla", "a2a", "psum16")


def _lookup_impl(name: str) -> str:
    if name not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup_impl {name!r}; one of "
                         f"{LOOKUP_IMPLS}")
    return name


def _l2_normalise(v: torch.Tensor) -> torch.Tensor:
    """``v`` over its L2 norm, the norm clamped at 1e-6 (a zero vector stays
    zero), as both JAX towers end."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(
        min=1e-6)


def two_tower_init(cfg: RecsysConfig, *, generator: torch.Generator,
                   device) -> TwoTower:
    """Random two-tower weights drawn on ``device`` (the JAX package's
    ``two_tower_init``: tables at scale 0.05, dense weights at
    1/sqrt(in), zero biases)."""
    d = cfg.embed_dim
    kw = dict(generator=generator, device=device, dtype=cfg.torch_dtype)
    return TwoTower(
        cfg,
        user_table=es.table_init(es.TableCfg("user", cfg.user_vocab, d), **kw),
        item_table=es.table_init(es.TableCfg("item", cfg.item_vocab, d), **kw),
        cat_table=es.table_init(es.TableCfg("cat", cfg.cat_vocab, d), **kw),
        user_mlp=_mlp_init((2 * d + cfg.n_dense,) + tuple(cfg.tower_mlp),
                           **kw),
        item_mlp=_mlp_init((2 * d,) + tuple(cfg.tower_mlp), **kw))


class DIN(_Recsys):
    """DIN's parameters on one device, as the JAX package's ``din_init``
    lays them out: ``item_table`` [item_vocab, D], ``cat_table``
    [cat_vocab, D], the ``(w [in, out], b [out])`` layers of ``attn_mlp``
    (8·D -> attn_mlp -> 1) and of the head ``mlp`` (4·D + n_dense -> mlp
    -> 1)."""

    inputs = ("hist_items", "hist_cats", "target_item", "target_cat",
              "dense")

    def __init__(self, cfg: RecsysConfig, *, item_table: torch.Tensor,
                 cat_table: torch.Tensor,
                 attn_mlp: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 mlp: Sequence[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.item_table = self._param(item_table)
        self.cat_table = self._param(cat_table)
        self.attn_mlp_w, self.attn_mlp_b = self._mlp(attn_mlp)
        self.mlp_w, self.mlp_b = self._mlp(mlp)

    def attention(self, hist_items: torch.Tensor, hist_cats: torch.Tensor,
                  target_item: torch.Tensor, target_cat: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (weights [B, L], hist [B, L, 2·D], target [B, 2·D]): the
        attention MLP (sigmoid between its layers, the last linear) over
        ``[e, et, e - et, e * et]`` of each step's item||cat rows ``e`` and
        the target's ``et``, zeroed after the MLP where the step is padding.
        Not normalised (DIN paper §4.3)."""
        hist = torch.cat([es.embed_lookup(self.item_table, hist_items),
                          es.embed_lookup(self.cat_table, hist_cats)],
                         dim=-1)
        target = torch.cat([es.embed_lookup(self.item_table, target_item),
                            es.embed_lookup(self.cat_table, target_cat)],
                           dim=-1)
        tgt = target[:, None].expand_as(hist)
        feat = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
        score = _mlp_apply(list(zip(self.attn_mlp_w, self.attn_mlp_b)), feat,
                           act=torch.sigmoid)[..., 0]
        return score * (hist_items >= 0).to(score.dtype), hist, target

    def forward(self, hist_items: torch.Tensor, hist_cats: torch.Tensor,
                target_item: torch.Tensor, target_cat: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """The batch's columns (ids of any int dtype, -1 pad) -> logits
        [B]: the JAX package's ``din_forward``."""
        weights, hist, target = self.attention(hist_items, hist_cats,
                                               target_item, target_cat)
        pooled = torch.einsum("bl,bld->bd", weights, hist)
        x = torch.cat([pooled, target, dense], dim=-1)
        return _mlp_apply(list(zip(self.mlp_w, self.mlp_b)), x)[..., 0]


def din_init(cfg: RecsysConfig, *, generator: torch.Generator,
             device) -> DIN:
    """Random DIN weights drawn on ``device`` (the JAX package's
    ``din_init``: tables at scale 0.05, dense weights at 1/sqrt(in), zero
    biases)."""
    d = cfg.embed_dim
    kw = dict(generator=generator, device=device, dtype=cfg.torch_dtype)
    return DIN(
        cfg,
        item_table=es.table_init(es.TableCfg("item", cfg.item_vocab, d), **kw),
        cat_table=es.table_init(es.TableCfg("cat", cfg.cat_vocab, d), **kw),
        attn_mlp=_mlp_init((8 * d,) + tuple(cfg.attn_mlp) + (1,), **kw),
        mlp=_mlp_init((4 * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,), **kw))


BST_BLOCK = ("wq", "wk", "wv", "wo", "ln1_g", "ln1_b", "ffn1", "ffn2",
             "ln2_g", "ln2_b")


def _bst_block(p, x: torch.Tensor, n_heads: int,
               mask: torch.Tensor) -> torch.Tensor:
    """One transformer block, the JAX package's ``_bst_block``: ``p`` maps
    ``BST_BLOCK``'s names to tensors, ``x`` [B, S, D], ``mask`` [B, S]
    (True where the key is a real step).  Masked scores are the finite
    -1e30, the softmax runs in fp32, and a row with no real key spreads its
    weight evenly, as in the JAX code."""
    b, s, d = x.shape
    dh = d // n_heads
    q = (x @ p["wq"]).reshape(b, s, n_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, n_heads, dh)
    v = (x @ p["wv"]).reshape(b, s, n_heads, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    sc = torch.where(mask[:, None, None, :], sc, -1e30)
    a = torch.softmax(sc.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, s, d)
    x = cm.layer_norm(x + o @ p["wo"], p["ln1_g"], p["ln1_b"])
    h = torch.relu(x @ p["ffn1"]) @ p["ffn2"]
    return cm.layer_norm(x + h, p["ln2_g"], p["ln2_b"])


class BST(_Recsys):
    """BST's parameters on one device, as the JAX package's ``bst_init``
    lays them out: ``item_table`` [item_vocab, D], ``pos_table``
    [seq_len + 1, D], ``blocks`` (each ``BST_BLOCK``'s weights: the
    attention's [D, D] projections, the FFN's [D, 4·D] and [4·D, D], no
    biases, and two layer norms' [D] gains and offsets) and the head
    ``mlp`` ((seq_len + 1)·D + n_dense -> mlp -> 1)."""

    inputs = ("hist_items", "target_item", "dense")

    def __init__(self, cfg: RecsysConfig, *, item_table: torch.Tensor,
                 pos_table: torch.Tensor, blocks: Sequence[dict],
                 mlp: Sequence[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.item_table = self._param(item_table)
        self.pos_table = self._param(pos_table)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: self._param(blk[k]) for k in BST_BLOCK})
            for blk in blocks)
        self.mlp_w, self.mlp_b = self._mlp(mlp)

    def forward(self, hist_items: torch.Tensor, target_item: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """The batch's columns (ids of any int dtype, -1 pad) -> logits
        [B]: the JAX package's ``bst_forward``.  A padded step keeps its
        zero row plus its position through the blocks and into the head,
        as there."""
        seq_ids = torch.cat([hist_items, target_item[:, None]], dim=1)
        x = es.embed_lookup(self.item_table, seq_ids) + self.pos_table[None]
        mask = seq_ids >= 0
        for blk in self.blocks:
            x = _bst_block(blk, x, self.cfg.n_heads, mask)
        x = torch.cat([x.reshape(x.shape[0], -1), dense], dim=-1)
        return _mlp_apply(list(zip(self.mlp_w, self.mlp_b)), x)[..., 0]


def bst_init(cfg: RecsysConfig, *, generator: torch.Generator,
             device) -> BST:
    """Random BST weights drawn on ``device`` (the JAX package's
    ``bst_init``: the item table at scale 0.05, positions at 0.02, dense
    weights at 1/sqrt(in), layer-norm gains 1, offsets and biases 0)."""
    d, s, dt = cfg.embed_dim, cfg.seq_len + 1, cfg.torch_dtype
    kw = dict(generator=generator, device=device, dtype=dt)

    def block():
        ones = torch.ones(d, dtype=dt, device=device)
        zeros = torch.zeros(d, dtype=dt, device=device)
        return {"wq": cm.dense_param(d, d, **kw),
                "wk": cm.dense_param(d, d, **kw),
                "wv": cm.dense_param(d, d, **kw),
                "wo": cm.dense_param(d, d, **kw),
                "ln1_g": ones, "ln1_b": zeros,
                "ffn1": cm.dense_param(d, 4 * d, **kw),
                "ffn2": cm.dense_param(4 * d, d, **kw),
                "ln2_g": ones.clone(), "ln2_b": zeros.clone()}

    return BST(
        cfg,
        item_table=es.table_init(es.TableCfg("item", cfg.item_vocab, d), **kw),
        pos_table=cm.normal_init((s, d), 0.02, **kw),
        blocks=[block() for _ in range(cfg.n_blocks)],
        mlp=_mlp_init((s * d + cfg.n_dense,) + tuple(cfg.mlp) + (1,), **kw))


INIT = {"din": din_init, "bst": bst_init, "two_tower": two_tower_init,
        "deepfm": deepfm_init}


def recsys_init(cfg: RecsysConfig, *, seed: int = 0,
                device=None) -> _Recsys:
    """The model of ``cfg`` with random weights from ``seed``, on
    ``device`` (default ``"cuda"``; raises without a card).  On the meta
    device its parameters have shapes and dtypes and no data, and no
    generator is made (the meta device has none)."""
    if cfg.arch not in INIT:
        raise NotImplementedError(NOT_PORTED.format(arch=cfg.arch))
    device = ops.resolve_device(device)
    generator = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    return INIT[cfg.arch](cfg, generator=generator, device=device)


def recsys_score(model: _Recsys, batch: dict) -> torch.Tensor:
    """Serving, as the JAX package's ``recsys_score``: the CTR probability
    [B] of a pointwise arch (DIN, BST, DeepFM: the sigmoid of its logits),
    or two-tower's L2-normalised user vector [B, tower_mlp[-1]] (not a
    probability).  ``batch`` holds the model's ``inputs`` as tensors on its
    device, or arrays, which are moved there."""
    with torch.inference_mode():
        out = model(*_columns(model, batch))
    return out if isinstance(model, TwoTower) else torch.sigmoid(out)


def _columns(model: _Recsys, batch: dict) -> list:
    """The model's ``inputs`` from ``batch``, as tensors on its device."""
    return [torch.as_tensor(batch[k], device=model.device)
            for k in model.inputs]


def lax_top_k(scores: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of fp32 ``scores`` [..., N] -> (values, indices),
    each [..., k]: the k largest of each row by the float total order, in
    descending order, equal values by ascending index.  The total order
    ranks +0.0 above -0.0, a positive NaN above +inf and a negative NaN
    below -inf, as ``jax.lax.top_k`` does; a float sort treats the zeros
    as equal and puts every NaN first.  So the rows are sorted on
    ``total_order_key``, stably, which keeps equal keys in index order on
    every device (``torch.topk`` promises no order among ties on the
    card), and the values are gathered at the indices."""
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"top_k of {k} from {scores.shape[-1]} scores")
    _, indices = torch.sort(total_order_key(scores), dim=-1,
                            descending=True, stable=True)
    indices = indices[..., :k]
    return scores.gather(-1, indices), indices


def total_order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that order fp32 ``scores`` as the float total order does:
    the bits as int32, with the low 31 bits flipped for negatives (so a
    larger magnitude ranks lower, and -0.0 just below +0.0)."""
    if scores.dtype != torch.float32:
        raise TypeError(f"total_order_key takes float32, got {scores.dtype}")
    bits = scores.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def retrieval_scores(model: TwoTower, batch: dict, cand_ids, cand_cats,
                     top_k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``retrieval_scores``: the user vectors ``u``
    [B, D] of ``batch`` (the user tower's ``inputs``), the item vectors
    ``c`` [N, D] of the candidates ``cand_ids``, ``cand_cats`` [N], and the
    top ``top_k`` of ``u @ c.T`` [B, N] -> (values, indices), each
    [B, top_k].  Every input is moved to the model's device."""
    if not isinstance(model, TwoTower):
        raise NotImplementedError(
            f"retrieval_scores takes a two-tower model, not "
            f"{type(model).__name__}")
    dev = model.device
    with torch.inference_mode():
        u = model(*_columns(model, batch))                      # [B, D]
        c = model.item_tower(torch.as_tensor(cand_ids, device=dev),
                             torch.as_tensor(cand_cats, device=dev))
        return lax_top_k(u @ c.T, top_k)                       # [B, N]


BULK_CHUNK_ROWS = 262_144   # serve_bulk's batch: DIN's and BST's slice


def bulk_rank(model: _Recsys, batch: dict, top_k: int = 100,
              chunk_rows: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``retrieval_cand`` for a pointwise arch (DeepFM, DIN, BST), as the
    JAX package's ``bulk_rank_fn`` does it: the logits [N] of a batch of N
    candidate rows (not probabilities) and their top ``top_k`` ->
    (values, indices), each [top_k].

    The forward runs on row slices of at most ``chunk_rows`` (default:
    the whole batch for DeepFM, ``BULK_CHUNK_ROWS`` for DIN and BST, whose
    per-row activations for 1M rows do not fit one card), each slice's
    logits written into one fp32 [N] tensor on the model's device, and
    ``lax_top_k`` ranks all N once.  Every op of the three forwards is
    row-wise (no batch statistic), so a slice changes only the batch a
    GEMM sees.  An out-of-memory error is raised, not retried smaller."""
    if not isinstance(model, (DeepFM, DIN, BST)):
        raise NotImplementedError(
            f"bulk_rank takes a pointwise model (DeepFM, DIN, BST), not "
            f"{type(model).__name__}; two-tower ranks through "
            "retrieval_scores")
    cols = _columns(model, batch)
    n = cols[0].shape[0]
    if chunk_rows is None:
        chunk_rows = n if isinstance(model, DeepFM) else BULK_CHUNK_ROWS
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be at least 1, got {chunk_rows}")
    with torch.inference_mode():
        if chunk_rows >= n:
            return lax_top_k(model(*cols), top_k)
        logits = torch.empty(n, dtype=torch.float32, device=model.device)
        for r0 in range(0, n, chunk_rows):
            logits[r0:r0 + chunk_rows] = model(
                *(c[r0:r0 + chunk_rows] for c in cols))
        return lax_top_k(logits, top_k)


# ---------------------------------------------------------------------------
# training: the loss, and the sparse-embedding path's rows (the JAX package's
# ``table_ids`` ... ``recsys_loss``), over a dict keyed by pytree paths
# ---------------------------------------------------------------------------
def _path_layers(params: dict, name: str) -> list:
    """The ``(w, b)`` layers of the MLP ``name`` in a path-keyed dict."""
    n = sum(1 for k in params if k.startswith(name + "/") and
            k.endswith("/w"))
    return [(params[f"{name}/{i}/w"], params[f"{name}/{i}/b"])
            for i in range(n)]


def table_ids(cfg: RecsysConfig, batch: dict) -> dict:
    """-> {row_key: (table_name, ids)}: the rows each table gives the
    forward, as the JAX package's ``table_ids`` names them."""
    if cfg.arch == "din":
        return {"hist_items": ("item_table", batch["hist_items"]),
                "target_item": ("item_table", batch["target_item"]),
                "hist_cats": ("cat_table", batch["hist_cats"]),
                "target_cat": ("cat_table", batch["target_cat"])}
    if cfg.arch == "bst":
        return {"seq_ids": ("item_table", torch.cat(
            [batch["hist_items"], batch["target_item"][:, None]], dim=1))}
    if cfg.arch == "two_tower":
        return {"user_id": ("user_table", batch["user_id"]),
                "hist_items": ("item_table", batch["hist_items"]),
                "item_id": ("item_table", batch["item_id"]),
                "item_cat": ("cat_table", batch["item_cat"])}
    if cfg.arch == "deepfm":
        ids = batch["sparse_ids"]
        flat = ids + torch.arange(cfg.n_sparse_fields, dtype=ids.dtype,
                                  device=ids.device) * cfg.field_vocab
        return {"field_rows": ("field_table", flat),
                "w1_table": ("w1_table", flat)}
    raise ValueError(cfg.arch)


def gather_rows(params: dict, cfg: RecsysConfig, batch: dict) -> dict:
    return {k: es.embed_lookup(params[t], ids)
            for k, (t, ids) in table_ids(cfg, batch).items()}


def _din_forward_rows(params, cfg, batch, rows):
    hist = torch.cat([rows["hist_items"], rows["hist_cats"]], dim=-1)
    target = torch.cat([rows["target_item"], rows["target_cat"]], dim=-1)
    tgt = target[:, None].expand_as(hist)
    feat = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    score = _mlp_apply(_path_layers(params, "attn_mlp"), feat,
                       act=torch.sigmoid)[..., 0]
    valid = (batch["hist_items"] >= 0).to(score.dtype)
    pooled = torch.einsum("bl,bld->bd", score * valid, hist)
    x = torch.cat([pooled, target, batch["dense"]], dim=-1)
    return _mlp_apply(_path_layers(params, "mlp"), x)[..., 0]


def _bst_forward_rows(params, cfg, batch, rows):
    mask = torch.cat([batch["hist_items"], batch["target_item"][:, None]],
                     dim=1) >= 0
    x = rows["seq_ids"] + params["pos_table"][None]
    for i in range(cfg.n_blocks):
        x = _bst_block({k: params[f"blocks/{i}/{k}"] for k in BST_BLOCK}, x,
                       cfg.n_heads, mask)
    x = torch.cat([x.reshape(x.shape[0], -1), batch["dense"]], dim=-1)
    return _mlp_apply(_path_layers(params, "mlp"), x)[..., 0]


SOFTMAX_CHUNK = 4096      # rows of in-batch logits held at once
TEMPERATURE = 0.05


class _InBatchSoftmax(torch.autograd.Function):
    """The in-batch softmax loss ``mean_r(lse_r - logits[r, r])`` of
    ``logits = u @ i.T / TEMPERATURE - logq[None, :]``, as the JAX
    package's ``softmax_xent`` computes it with labels ``arange(B)`` (the
    row max held constant, the gold logit the diagonal element itself),
    taken ``chunk`` rows of logits at a time, so that no [B, B] tensor
    exists at any moment.  Under ``grads`` the same pass also takes the
    loss's gradients with respect to the inputs that require them (from
    ``p = softmax - one-hot`` of each chunk: ``p @ i`` for u, ``p.T @ u``
    for i, ``-sum_r p`` for logq), and the backward scales those [B, D]
    and [B] results by its upstream gradient.  The products stay
    ``torch.matmul``: the JAX package computes them outside any Pallas
    kernel."""

    @staticmethod
    def forward(ctx, u, i, logq, chunk, grads):
        b, dt = u.shape[0], torch.promote_types(u.dtype, torch.float32)
        need_u, need_i, need_q = (grads and n
                                  for n in ctx.needs_input_grad[:3])
        gu = torch.empty_like(u) if need_u else None
        gi = torch.zeros_like(i) if need_i else None
        gq = torch.zeros_like(logq) if need_q else None
        nll = torch.zeros((), dtype=dt, device=u.device)
        for r0 in range(0, b, chunk):
            logits = _logits_chunk(u, i, logq, r0, chunk)
            gold = logits.diagonal(r0).clone()
            m = logits.amax(dim=-1, keepdim=True)
            p = logits.sub_(m).exp_()                # in place: one chunk
            s = p.sum(dim=-1)
            nll += (torch.log(s) + m[:, 0] - gold).sum()
            if not (need_u or need_i or need_q):
                continue
            p /= s[:, None]
            p.diagonal(r0).sub_(1.0)                 # softmax - one-hot
            p /= b
            if need_q:
                gq -= p.sum(dim=0).to(gq.dtype)
            p /= TEMPERATURE
            p = p.to(u.dtype)
            if need_u:
                gu[r0:r0 + chunk] = p @ i
            if need_i:
                gi += p.T @ u[r0:r0 + chunk]
        ctx.save_for_backward(gu, gi, gq)
        return nll / b

    @staticmethod
    def backward(ctx, g):
        return tuple(None if t is None else t * g.to(t.dtype)
                     for t in ctx.saved_tensors) + (None, None)


def _logits_chunk(u, i, logq, r0: int, chunk: int) -> torch.Tensor:
    """The logits of rows ``r0:r0 + chunk`` against every item, in fp32 (a
    float64 ``u`` stays float64)."""
    dt = torch.promote_types(u.dtype, torch.float32)
    logits = (u[r0:r0 + chunk] @ i.T).to(dt) / TEMPERATURE
    if logq is not None:
        logits = logits - logq.to(dt)[None, :]
    return logits


def _in_batch_softmax(u: torch.Tensor, i: torch.Tensor,
                      logq=None) -> torch.Tensor:
    """In-batch sampled softmax of unit user vectors ``u`` against unit
    item vectors ``i`` at temperature 0.05, less the popularity correction
    ``logq`` [B] where given (Yi et al., RecSys'19): the JAX package's
    ``softmax_xent`` over ``u @ i.T / 0.05`` with labels ``arange(B)``,
    ``SOFTMAX_CHUNK`` rows of logits at a time (``_InBatchSoftmax``), its
    gradients taken in the same pass where grad is enabled."""
    return _InBatchSoftmax.apply(u, i, logq, SOFTMAX_CHUNK,
                                 torch.is_grad_enabled())


def _two_tower_loss_rows(params, cfg, batch, rows):
    valid = (batch["hist_items"] >= 0).to(rows["hist_items"].dtype)
    hist = (rows["hist_items"] * valid[..., None]).sum(1) / \
        valid.sum(1)[:, None].clamp(min=1.0)
    u = _l2_normalise(_mlp_apply(
        _path_layers(params, "user_mlp"),
        torch.cat([rows["user_id"], hist, batch["dense"]], dim=-1)))
    i = _l2_normalise(_mlp_apply(
        _path_layers(params, "item_mlp"),
        torch.cat([rows["item_id"], rows["item_cat"]], dim=-1)))
    return _in_batch_softmax(u, i)          # no logq here, as in JAX


def _deepfm_forward_rows(params, cfg, batch, rows):
    emb = rows["field_rows"]
    fm2 = ops.fm_interaction(emb)
    w1 = rows["w1_table"][..., 0].sum(-1)
    dense1 = (batch["dense"] @ params["dense_w1"])[..., 0]
    deep_in = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]],
                        dim=-1)
    deep = _mlp_apply(_path_layers(params, "mlp"), deep_in)[..., 0]
    return params["bias"] + w1 + dense1 + fm2.to(deep.dtype) + deep


FORWARD_ROWS = {"din": _din_forward_rows, "bst": _bst_forward_rows,
                "deepfm": _deepfm_forward_rows}


def recsys_loss_rows(params: dict, cfg: RecsysConfig, batch: dict,
                     rows: dict):
    """-> (loss, {"loss": loss}) of the forward over gathered ``rows``."""
    if cfg.arch == "two_tower":
        loss = _two_tower_loss_rows(params, cfg, batch, rows)
        return loss, {"loss": loss}
    logits = FORWARD_ROWS[cfg.arch](params, cfg, batch, rows)
    loss = cm.bce_with_logits(logits, batch["label"])
    return loss, {"loss": loss}


def two_tower_loss(params: dict, cfg: RecsysConfig,
                   batch: dict) -> torch.Tensor:
    """The JAX package's ``two_tower_loss``: the user tower (its history
    through ``embed_bag``, so the bag kernel on the card) and the item
    tower of the batch's own items, in-batch softmax."""
    u = es.embed_lookup(params["user_table"], batch["user_id"])
    hist = es.embed_bag(params["item_table"],
                        batch["hist_items"].to(torch.int32), None, "mean")
    u = _l2_normalise(_mlp_apply(
        _path_layers(params, "user_mlp"),
        torch.cat([u, hist.to(u.dtype), batch["dense"]], dim=-1)))
    i = _l2_normalise(_mlp_apply(
        _path_layers(params, "item_mlp"),
        torch.cat([es.embed_lookup(params["item_table"], batch["item_id"]),
                   es.embed_lookup(params["cat_table"], batch["item_cat"])],
                  dim=-1)))
    return _in_batch_softmax(u, i, batch.get("logq"))


def recsys_loss(params: dict, cfg: RecsysConfig, batch: dict):
    """-> (loss, {"loss": loss}): the JAX package's ``recsys_loss``, what
    the dense train step differentiates (every table's gradient dense)."""
    if cfg.arch == "two_tower":
        loss = two_tower_loss(params, cfg, batch)
        return loss, {"loss": loss}
    logits = FORWARD_ROWS[cfg.arch](params, cfg, batch,
                                    gather_rows(params, cfg, batch))
    loss = cm.bce_with_logits(logits, batch["label"])
    return loss, {"loss": loss}
