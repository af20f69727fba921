"""The LM transformer family, from the JAX package's ``models/lm.py``: one
decoder-only stack covering deepseek-7b (llama-arch GQA), qwen3-14b (GQA +
qk-norm), nemotron-4-340b (GQA + squared-ReLU FFN), deepseek-v3-671b (MLA
+ shared/routed MoE + MTP) and qwen3-moe-235b (GQA + MoE): pre-RMSNorm
blocks, the first ``n_dense_layers`` dense and the rest MoE.

Parameters are one flat dict keyed by the JAX package's paths, a stack of
layers as ``[L, ...]`` tensors (``dense_layers/attn/wq``,
``moe_layers/moe/w_gate``, ``mtp/block/ffn/w_up``), in ``jax.tree_util``'s
leaf order; ``core/convert.lm_from_reference`` carries the JAX package's
tree across.  The layers run one at a time over views of the stacks, each
stack unbound once a forward (``layers``), so that autograd holds one node
a stack: its backward stacks the layers' gradients once, where a view a
layer (``v[i]``) would add a zero tensor of the whole stack a layer.  The
LM train step goes further (``train_step.make_train_step``'s
``in_place``): it passes each stack as a list of its layers, each a
leaf of its own, so that no gradient of a whole stack is ever made.

Serving: ``lm_backbone`` and ``lm_logits`` (prefill), ``lm_prefill``
(prefill writing the decode caches), ``lm_decode_step`` (decode, caches
updated in place) and the caches' shapes (``decode_cache_specs``,
``make_decode_caches``).  Each takes a ``mesh`` (``launch/mesh.make_mesh``
over a ``torch.distributed`` world, ``(data, model)``) and then runs this
rank's part of the reference's sharded serving: the batch's rows split
over ``data`` where it divides them (``Mesh.batch_rows``; the inputs are
the whole batch on every rank, the outputs this rank's rows), the decode
caches split over ``model`` along the sequence where ``model`` divides
their ``smax`` positions (``models/attention.py``'s flash-decode; the
caches are this rank's slices, ``decode_cache_specs(..., mesh)``), the
MoE's experts split over ``model`` (``models/moe.py``; in decode the
batch is gathered over ``data`` first, as the reference replicates it
there).  Everything else, the dense layers, the prefill attention and the
vocabulary tables, runs whole on every ``model`` rank for its rows: the
reference shards them by GSPMD constraints (``mi.shard``, the
parameters' ``Boxed`` specs), which place memory and change no value, so
this is a departure in memory, not in values.  The dense weights'
FSDP / tensor-parallel placement is ROADMAP queue 1, item 15.4.

Training: ``lm_loss`` (next-token cross entropy over sequence chunks,
``_chunked_xent``; the MoE's aux loss; DeepSeek-V3's multi-token
prediction, ``_mtp_loss``), differentiated by ``train/train_step.py``.
With ``cfg.remat`` each layer of a differentiated forward runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): only its
input is kept, and its activations are recomputed in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed as dist
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ParamSpec, ShapeDtype

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STACKS = (("dense", "dense_layers"), ("moe", "moe_layers"))


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"              # gqa | mla
    ffn_type: str = "swiglu"            # swiglu | squared_relu
    qk_norm: bool = False
    moe: Optional[moe_mod.MoEConfig] = None
    n_dense_layers: int = 0             # leading dense layers in MoE models
    mtp_depth: int = 0                  # DeepSeek-V3 multi-token prediction
    rope_base: float = 10000.0
    q_chunk: int = 512
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512     # sequence chunking of the CE (0 = off)
    unroll: bool = False      # the reference's scan unrolling (no effect here)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.moe else 0

    def gqa_cfg(self) -> attn.GQAConfig:
        return attn.GQAConfig(self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.qk_norm, self.rope_base,
                              self.q_chunk)

    def mla_cfg(self) -> attn.MLAConfig:
        return attn.MLAConfig(self.d_model, self.n_heads,
                              rope_base=self.rope_base, q_chunk=self.q_chunk)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _prefixed(prefix: str, specs: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in specs.items()}


def _ffn_specs(cfg: LMConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dense = attn._dense
    if cfg.ffn_type == "swiglu":
        return {"w_gate": dense(d, f), "w_up": dense(d, f),
                "w_down": dense(f, d)}
    if cfg.ffn_type == "squared_relu":
        return {"w_in": dense(d, f), "w_out": dense(f, d)}
    raise ValueError(cfg.ffn_type)


def _layer_specs(cfg: LMConfig, use_moe: bool) -> dict:
    a = (attn.mla_specs(cfg.mla_cfg()) if cfg.attn_type == "mla"
         else attn.gqa_specs(cfg.gqa_cfg()))
    p = {"ln1": ParamSpec((cfg.d_model,), None), **_prefixed("attn", a),
         "ln2": ParamSpec((cfg.d_model,), None)}
    if use_moe:
        p.update(_prefixed("moe", moe_mod.moe_specs(cfg.moe)))
    else:
        p.update(_prefixed("ffn", _ffn_specs(cfg)))
    return p


def param_specs(cfg: LMConfig) -> dict:
    """``{path: ParamSpec}`` of the whole model, in ``jax.tree_util``'s leaf
    order (paths sorted component by component)."""
    d = cfg.d_model
    n_dense = cfg.n_layers - cfg.n_moe_layers
    specs = {"embed": ParamSpec((cfg.vocab, d), 0.02),
             "final_ln": ParamSpec((d,), None),
             "unembed": attn._dense(d, cfg.vocab)}
    for n, key, use_moe in ((n_dense, "dense_layers", False),
                            (cfg.n_moe_layers, "moe_layers", True)):
        if n:
            specs.update({f"{key}/{k}": v.stacked(n) for k, v in
                          _layer_specs(cfg, use_moe).items()})
    if cfg.mtp_depth:
        specs.update(_prefixed("mtp", {
            "proj": attn._dense(2 * d, d),
            "ln_h": ParamSpec((d,), None), "ln_e": ParamSpec((d,), None),
            **_prefixed("block", _layer_specs(cfg, use_moe=False)),
            "final_ln": ParamSpec((d,), None)}))
    return dict(sorted(specs.items(), key=lambda kv: kv[0].split("/")))


def param_bytes(cfg: LMConfig, mesh=None) -> int:
    """The parameters' bytes (at a ``mesh``, this rank's share)."""
    cuts = expert_cuts(cfg, mesh)
    total = 0
    for path, spec in param_specs(cfg).items():
        shape = list(spec.shape)
        if path in cuts:
            dim, start, stop = cuts[path]
            shape[dim] = stop - start
        total += ShapeDtype(tuple(shape), spec.dtype or cfg.torch_dtype).nbytes
    return total


def expert_cuts(cfg: LMConfig, mesh=None) -> dict:
    """``{path: (1, start, stop)}``: the experts of each MoE stack
    (``[L, E, ...]``) this rank of ``mesh`` holds, ``E / n`` of them for a
    ``model`` axis of n; empty with no mesh, one ``model`` rank or no
    MoE."""
    if mesh is None or cfg.moe is None or mesh.size("model") == 1:
        return {}
    n, e = mesh.size("model"), cfg.moe.n_experts
    if e % n:
        raise ValueError(f"{e} experts do not split over {n} model ranks")
    e_loc = e // n
    cut = (1, mesh.model_index * e_loc, (mesh.model_index + 1) * e_loc)
    return {f"moe_layers/moe/{w}": cut
            for w in ("w_gate", "w_up", "w_down")}


def lm_init(cfg: LMConfig, *, seed: int = 0, device="cuda",
            mesh=None) -> dict:
    """Random weights of ``cfg`` on ``device``, from a generator seeded
    ``seed`` there: every matrix a truncated normal scaled by 1/sqrt(fan
    in) (the embedding by 0.02), every norm's gain ones, as the reference
    draws them (from another stream: the two packages draw different
    numbers).  At a ``mesh``, this rank's share (``expert_cuts``) of the
    same draws."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cm.draw_params(param_specs(cfg), generator=gen, device=device,
                          dtype=cfg.torch_dtype, keep=expert_cuts(cfg, mesh))


def layer_view(params: dict, key: str, i: int) -> dict:
    """Layer ``i`` of the stack ``key`` (``dense_layers``, ``moe_layers``)
    as a dict of views."""
    return {k: v[i] for k, v in cm.sub(params, key).items()}


def layers(params: dict, key: str) -> list:
    """The stack ``key`` as one dict of views a layer, each stack leaf
    unbound once (one autograd node a leaf).  A stack given as a list of
    its layers (``is_stacked``: the train step's leaves a layer at a
    time) is taken as it is."""
    per_leaf = {k: v if isinstance(v, (list, tuple)) else torch.unbind(v)
                for k, v in cm.sub(params, key).items()}
    return [{k: v[i] for k, v in per_leaf.items()}
            for i in range(n_stacked(params, key))]


def is_stacked(path: str) -> bool:
    """True for a leaf of a layer stack (``[L, ...]``)."""
    return path.split("/", 1)[0] in ("dense_layers", "moe_layers")


def n_stacked(params: dict, key: str) -> int:
    return next(len(v) for k, v in params.items()
                if k.startswith(key + "/"))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _ffn_apply(p: dict, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return cm.squared_relu(x @ p["w_in"]) @ p["w_out"]


def _attn_apply(p: dict, cfg: LMConfig, a: torch.Tensor,
                return_cache: bool):
    if cfg.attn_type == "mla":
        return attn.mla_apply(p, cfg.mla_cfg(), a, return_cache=return_cache)
    return attn.gqa_apply(p, cfg.gqa_cfg(), a, return_cache=return_cache)


def _layer_apply(p: dict, cfg: LMConfig, x: torch.Tensor, use_moe: bool,
                 return_cache: bool = False, taps: Optional[list] = None,
                 mesh=None):
    """Pre-norm block -> (x, (aux, dropped)) and, with ``return_cache``, the
    layer's attention cache.  ``taps``, where given, gets each MoE layer's
    body ``(tokens, output, dropped)`` (``moe.moe_apply``)."""
    a = cm.rms_norm(x, p["ln1"])
    out = _attn_apply(cm.sub(p, "attn"), cfg, a, return_cache)
    attn_out, cache = out if return_cache else (out, None)
    del a, out
    x = x + attn_out
    del attn_out
    h = cm.rms_norm(x, p["ln2"])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_moe:
        y, aux, dropped = moe_mod.moe_apply(cm.sub(p, "moe"), cfg.moe, h,
                                            mesh, taps=taps)
    else:
        y, aux, dropped = _ffn_apply(cm.sub(p, "ffn"), cfg, h), zero, zero
    x = x + y
    return (x, (aux, dropped), cache) if return_cache else (x, (aux, dropped))


# ---------------------------------------------------------------------------
# forward: prefill, training
# ---------------------------------------------------------------------------
def _rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch given whole (module docstring)."""
    return tokens if mesh is None else tokens[mesh.batch_rows(len(tokens))]


def lm_backbone(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                caches: Optional[dict] = None,
                taps: Optional[list] = None, mesh=None,
                smax: Optional[int] = None):
    """tokens [B, S] -> (hidden [B, S, d] before the final norm, (aux,
    dropped) summed over the MoE layers).  With ``caches`` (the decode
    caches, ``make_decode_caches``, at least S long) every layer's cache
    is written into ``[:, :, :S]`` of its stack.  Under autograd with
    ``cfg.remat`` every layer is checkpointed (module docstring); ``taps``
    then stays empty (a recomputed layer would tap twice).  At a ``mesh``
    the hidden states are this rank's rows', and ``caches`` this rank's
    slices of caches of ``smax`` positions (module docstring)."""
    x = params["embed"][_rows(tokens, mesh).long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    s = tokens.shape[1]
    lo, hi = 0, s
    if caches is not None and mesh is not None:
        _, seq = cache_slices(mesh, len(tokens), smax)
        lo, hi = min(s, seq.start), min(s, seq.stop)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for kind, key in STACKS:
        if key + "/ln1" not in params:
            continue
        for i, p in enumerate(layers(params, key)):
            if remat:
                x, (a, d) = checkpoint(_layer_apply, p, cfg, x,
                                       kind == "moe", False, None, mesh,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            elif caches is None:
                x, (a, d) = _layer_apply(p, cfg, x, kind == "moe",
                                         taps=taps, mesh=mesh)
            else:
                x, (a, d), c = _layer_apply(p, cfg, x, kind == "moe", True,
                                            taps, mesh)
                for name, t in c.items():
                    caches[kind][name][i, :, :hi - lo] = t[:, lo:hi]
            aux, dropped = aux + a, dropped + d
    return x, (aux, dropped)


def lm_logits(params: dict, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    return cm.rms_norm(h, params["final_ln"]) @ params["unembed"]


def _chunk_nll(project, hx, tx, mx):
    """One chunk's masked NLL sum: its masked mean times its mask's sum."""
    return cm.softmax_xent(project(hx), tx, mx) * mx.sum()


def _chunked_xent(params: dict, cfg: LMConfig, h: torch.Tensor,
                  targets: torch.Tensor, project=None) -> torch.Tensor:
    """Cross entropy of ``targets`` [B, S] under ``project(h)`` (default
    ``lm_logits``) over sequence chunks of ``cfg.loss_chunk``: one [B, C,
    V] logits chunk is the only vocabulary-sized tensor alive, and each is
    recomputed in the backward (checkpointed, as the reference's
    ``jax.checkpoint``).  S is padded to a multiple of the chunk and the
    padding masked; the chunks' masked NLL sums add in order and the total
    is divided by B * S (S before the padding).  ``S <= loss_chunk`` (or a
    chunk of 0) takes the mean over one projection."""
    if project is None:
        def project(hx):
            return lm_logits(params, cfg, hx)
    b, s, _ = h.shape
    chunk = cfg.loss_chunk
    if chunk <= 0 or s <= chunk:
        return cm.softmax_xent(project(h), targets)
    pad = (-s) % chunk
    mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s + pad, chunk):
        part = slice(start, start + chunk)
        args = (project, h[:, part], targets[:, part], mask[:, part])
        tot = tot + (checkpoint(_chunk_nll, *args, use_reentrant=False,
                                preserve_rng_state=False)
                     if torch.is_grad_enabled() else _chunk_nll(*args))
    return tot / (b * s)


def lm_loss(params: dict, cfg: LMConfig, batch: dict):
    """batch ``{"tokens": [B, S] int}``; the targets are the tokens one
    position on -> (loss, metrics): ``xent``, ``moe_aux`` and
    ``moe_dropped`` (summed over the MoE layers), ``mtp`` where the config
    predicts two tokens, and ``loss`` = xent + ``aux_weight`` x aux (an
    MoE config) + 0.3 x mtp, as the reference."""
    tokens = batch["tokens"]
    h, (aux, dropped) = lm_backbone(params, cfg, tokens)
    loss = _chunked_xent(params, cfg, h[:, :-1], tokens[:, 1:])
    metrics = {"xent": loss, "moe_aux": aux, "moe_dropped": dropped}
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_weight * aux
    if cfg.mtp_depth:
        mtp = _mtp_loss(params, cfg, tokens, h)
        metrics["mtp"] = mtp
        loss = loss + 0.3 * mtp
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction (depth 1): hidden state t
    (normed) beside the embedding of token t + 1 (normed), projected, one
    more dense block (not checkpointed, as in the reference), the final
    norm, then the shared unembedding predicts token t + 2, chunked like
    the main loss."""
    p = cm.sub(params, "mtp")
    emb_next = params["embed"][tokens[:, 1:].long()]
    hh = cm.rms_norm(h[:, :-1], p["ln_h"])
    ee = cm.rms_norm(emb_next, p["ln_e"])
    x = torch.cat([hh, ee], dim=-1) @ p["proj"]
    del hh, ee, emb_next
    x, _ = _layer_apply(cm.sub(p, "block"), cfg, x, use_moe=False)
    x = cm.rms_norm(x, p["final_ln"])
    return _chunked_xent(params, cfg, x[:, :-1], tokens[:, 2:],
                         project=lambda hx: hx @ params["unembed"])


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def lm_prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor,
               cache_len: int, mesh=None, taps: Optional[list] = None):
    """Prefill that leaves the decode caches behind: tokens [B, S] ->
    (the last position's logits [B, V], caches of ``cache_len`` positions
    holding the S prompt positions, zeros past them).  At a ``mesh``, this
    rank's rows' logits and its slices of the caches.  ``taps`` as
    ``lm_backbone``'s."""
    caches = make_decode_caches(cfg, tokens.shape[0], cache_len,
                                tokens.device, mesh)
    h, _ = lm_backbone(params, cfg, tokens, caches=caches, taps=taps,
                       mesh=mesh, smax=cache_len)
    return lm_logits(params, cfg, h[:, -1:])[:, 0], caches


def _layer_decode(p: dict, cfg: LMConfig, x, cache: dict, pos,
                  use_moe: bool, mesh=None, smax: Optional[int] = None,
                  taps: Optional[list] = None, split: bool = False):
    a = cm.rms_norm(x, p["ln1"])
    ap = cm.sub(p, "attn")
    if cfg.attn_type == "mla":
        y, cache = attn.mla_decode(ap, cfg.mla_cfg(), a, cache, pos, mesh,
                                   smax)
    else:
        y, cache = attn.gqa_decode(ap, cfg.gqa_cfg(), a, cache, pos, mesh,
                                   smax)
    x = x + y
    h = cm.rms_norm(x, p["ln2"])
    if not use_moe:
        return x + _ffn_apply(cm.sub(p, "ffn"), cfg, h), cache
    mp = cm.sub(p, "moe")
    if mesh is None or mesh.group is None:
        y, _, _ = moe_mod.moe_apply(mp, cfg.moe, h, taps=taps)
        return x + y, cache
    # the reference replicates a decode step's tokens on every rank: a
    # batch split over data is gathered for the MoE, this rank's rows kept
    b = h.shape[0]
    if split:
        h = dist.all_gather(h, mesh.data_group, dim=0)
    y, _, _ = moe_mod.moe_apply(mp, cfg.moe, h, mesh, decode=True,
                                taps=taps)
    if split:
        y = y[mesh.data_index * b:(mesh.data_index + 1) * b]
    return x + y, cache


def lm_decode_step(params: dict, cfg: LMConfig, token: torch.Tensor,
                   pos: torch.Tensor, caches: dict, mesh=None,
                   smax: Optional[int] = None, taps: Optional[list] = None):
    """One-token decode.  token [B] int; pos [B] the current lengths;
    ``caches`` ``{'dense': {k, v or ckv, kr: [Ld, B, Smax, ...]}, 'moe':
    ...}``.  Each layer writes its new entry into its slice of the stacks IN
    PLACE (the reference returns new caches) -> (logits [B, V], the same
    caches).  At a ``mesh``: ``token`` and ``pos`` the whole batch, the
    caches this rank's slices of caches of ``smax`` positions
    (``decode_cache_specs(..., mesh)``), the logits this rank's rows'
    (module docstring).  ``taps`` gets each MoE layer's body tokens,
    output and dropped share."""
    b = len(token)
    pos = _rows(pos, mesh)
    x = params["embed"][_rows(token, mesh).long()[:, None]]
    split = len(pos) < b
    for kind, key in STACKS:
        if kind not in caches:
            continue
        for i, p in enumerate(layers(params, key)):
            view = {name: t[i] for name, t in caches[kind].items()}
            x, _ = _layer_decode(p, cfg, x, view, pos, kind == "moe", mesh,
                                 smax, taps, split)
    return lm_logits(params, cfg, x)[:, 0], caches


def decode_cache_specs(cfg: LMConfig, batch: int, s_max: int,
                       mesh=None) -> dict:
    """The decode caches' shapes and dtypes (the reference's
    ``make_decode_cache_specs`` without its shardings):
    ``{'dense' / 'moe': {k, v: [L, B, Smax, Hkv, dh]}}`` for GQA,
    ``{ckv: [L, B, Smax, kv_lora], kr: [L, B, Smax, dh_rope]}`` for MLA.
    At a ``mesh``, a rank's slice of them: the reference's ``P(None,
    bspec, 'model', ...)`` gives it ``B / data`` rows where ``data``
    divides B and ``Smax / n`` positions where the n ``model`` ranks
    divide Smax (``Mesh.batch_rows``, ``Mesh.seq_shards``)."""
    dt = cfg.torch_dtype
    n_dense = cfg.n_layers - cfg.n_moe_layers
    if mesh is not None:
        rows, seq = cache_slices(mesh, batch, s_max)
        batch, s_max = rows.stop - rows.start, seq.stop - seq.start

    def entry(n):
        if cfg.attn_type == "mla":
            m = cfg.mla_cfg()
            return {"ckv": ShapeDtype((n, batch, s_max, m.kv_lora), dt),
                    "kr": ShapeDtype((n, batch, s_max, m.dh_rope), dt)}
        kv = ShapeDtype((n, batch, s_max, cfg.n_kv_heads, cfg.head_dim), dt)
        return {"k": kv, "v": kv}

    out = {}
    if n_dense:
        out["dense"] = entry(n_dense)
    if cfg.n_moe_layers:
        out["moe"] = entry(cfg.n_moe_layers)
    return out


def make_decode_caches(cfg: LMConfig, batch: int, s_max: int,
                       device, mesh=None) -> dict:
    """Zeroed decode caches of ``decode_cache_specs`` on ``device``."""
    return {kind: {name: torch.zeros(sd.shape, dtype=sd.dtype, device=device)
                   for name, sd in entry.items()}
            for kind, entry in decode_cache_specs(cfg, batch, s_max,
                                                  mesh).items()}


def cache_slices(mesh, batch: int, s_max: int) -> tuple:
    """(rows, positions): the slices of whole decode caches [L, B, Smax,
    ...] that this rank of ``mesh`` holds (``decode_cache_specs``)."""
    s_loc = s_max // mesh.seq_shards(s_max)
    seq = slice(0, s_max) if s_loc == s_max else slice(
        mesh.model_index * s_loc, (mesh.model_index + 1) * s_loc)
    return mesh.batch_rows(batch), seq


def cache_share(caches: dict, mesh) -> dict:
    """Whole decode caches -> this rank of ``mesh``'s slices of them, each
    contiguous (a copy, unless the slice is the whole cache)."""
    out = {}
    for kind, entry in caches.items():
        out[kind] = {}
        for name, t in entry.items():
            rows, seq = cache_slices(mesh, t.shape[1], t.shape[2])
            out[kind][name] = t[:, rows, seq].contiguous()
    return out


def cache_bytes(cfg: LMConfig, batch: int, s_max: int, mesh=None) -> int:
    return sum(sd.nbytes for entry in
               decode_cache_specs(cfg, batch, s_max, mesh).values()
               for sd in entry.values())
