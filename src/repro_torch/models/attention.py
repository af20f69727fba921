"""Attention blocks, from the JAX package's ``models/attention.py``: GQA
(optionally qk-norm) and MLA (DeepSeek-V3), with query-chunked attention
for prefill (no S x S score tensor: one [B, Hkv, G, q_chunk, S] chunk at a
time) and KV-cache decode.

Shapes:  x [B, S, d];  GQA cache {k, v: [B, Smax, Hkv, dh]};
         MLA cache {ckv: [B, Smax, kv_lora], kr: [B, Smax, dh_rope]}.

Parameters are path-keyed dicts of tensors (``wq``, ``q_gamma``, ...), the
JAX package's names and shapes.  Decode takes the reference's two paths:
with a ``mesh`` (``launch/mesh.make_mesh``) whose ``model`` axis has n > 1
ranks that divide the cache's ``smax`` positions, each rank holds its
slice ``[B_loc, smax / n, ...]`` of the cache and runs the flash-decode
body (``_flash_decode_body``, ``_mla_flash_body``): the new entry written
on its owning shard only, the softmax's max, sum and fp32 numerator
combined over the ``model`` group (``core/distributed``'s
``all_reduce_max`` and ``all_reduce_sum``).  Otherwise the cache is whole
on the rank and the one-device path runs (the reference's fallback).
``DECODE_PATHS`` counts which ran.

Two departures, neither of which changes a value beyond rounding:

* ``_chunked_attention`` skips, for each query chunk, the keys wholly past
  the chunk's last position under the causal mask: the reference gives
  them a score of -1e30, whose probability is exactly 0.
* The decode paths update the cache in place (``index_put_`` at ``[b,
  pos[b]]``) and return the same tensors, where JAX returns new arrays.

The scores of a bf16 cache are accumulated in fp32 (the reference's
``preferred_element_type=float32``): on the card by ``torch.bmm(...,
out_dtype=torch.float32)`` where this PyTorch has it, else, as on the CPU,
by a product of fp32 copies of one head's slice of the cache at a time
(``F32_ROUTE`` says which ran).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import distributed as dist
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec

NEG = -1e30          # the reference's mask value
DECODE_PATHS = {"flash": 0, "whole": 0}    # decode calls, by path


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_base: float = 10000.0
    q_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dv: int = 128
    rope_base: float = 10000.0
    q_chunk: int = 512


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _dense(i: int, o: int) -> ParamSpec:
    return ParamSpec((i, o), 1.0 / math.sqrt(i))


def gqa_specs(cfg: GQAConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _dense(d, h * dh), "wk": _dense(d, kv * dh),
         "wv": _dense(d, kv * dh), "wo": _dense(h * dh, d)}
    if cfg.qk_norm:
        p["q_gamma"] = p["k_gamma"] = ParamSpec((dh,), None)
    return p


def mla_specs(cfg: MLAConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "w_dq": _dense(d, cfg.q_lora),
        "q_gamma": ParamSpec((cfg.q_lora,), None),
        "w_uq": _dense(cfg.q_lora, h * (cfg.dh_nope + cfg.dh_rope)),
        "w_dkv": _dense(d, cfg.kv_lora),
        "kv_gamma": ParamSpec((cfg.kv_lora,), None),
        "w_uk": _dense(cfg.kv_lora, h * cfg.dh_nope),
        "w_uv": _dense(cfg.kv_lora, h * cfg.dv),
        "w_kr": _dense(d, cfg.dh_rope),
        "wo": _dense(h * cfg.dv, d),
    }


def gqa_init(cfg: GQAConfig, *, generator: torch.Generator, device,
             dtype=torch.bfloat16) -> dict:
    return cm.draw_params(gqa_specs(cfg), generator=generator,
                          device=device, dtype=dtype)


def mla_init(cfg: MLAConfig, *, generator: torch.Generator, device,
             dtype=torch.bfloat16) -> dict:
    return cm.draw_params(mla_specs(cfg), generator=generator,
                          device=device, dtype=dtype)


def _scalar_in(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX rounds a scalar it multiplies a
    ``dtype`` array by."""
    return float(torch.tensor(x, dtype=dtype))


# ---------------------------------------------------------------------------
# chunked causal attention core
# ---------------------------------------------------------------------------
def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       q_chunk: int, causal: bool,
                       q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hkv, G, dh]; k [B, Sk, Hkv, dh]; v [B, Sk, Hkv, dv] ->
    [B, Sq, Hkv, G, dv] in ``v``'s dtype.  One query chunk at a time: the
    scores in fp32 (``(q . k) * 1/sqrt(dh)``), the causal mask at -1e30,
    the softmax, then ``p`` in ``v``'s dtype times ``v``.  Each chunk's
    tensors are freed before the next chunk starts (the chunks run from
    the last); keys past a chunk's last position are skipped under the
    causal mask (module docstring)."""
    b, sq, hkv, g, dh = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = _scalar_in(1.0 / math.sqrt(dh), torch.float32)
    # both laid out once so that every chunk's products are plain batched
    # GEMMs over (B, Hkv), their key range a slice of the last axis
    kt = k.permute(0, 2, 3, 1).to(torch.float32,        # [B, Hkv, dh, Sk]
                                  memory_format=torch.contiguous_format)
    vt = v.permute(0, 2, 1, 3).contiguous()              # [B, Hkv, Sk, dv]
    out = torch.empty((b, sq, hkv, g, dv), dtype=v.dtype, device=v.device)
    # the last chunk first: under the causal mask a chunk's key range, and
    # so its score buffers, grow with its start, and taken from the last
    # each chunk's buffers fit in the blocks the one before it freed
    for start in reversed(range(0, sq, q_chunk)):
        n = min(q_chunk, sq - start)
        kend = min(sk, q_offset + start + n) if causal else sk
        qi = q[:, start:start + n].float().permute(0, 2, 3, 1, 4) \
            .reshape(b, hkv, g * n, dh)
        s = torch.matmul(qi, kt[..., :kend]).mul_(scale)  # [B,Hkv,G*n,kend]
        if causal:
            c0 = max(0, min(kend, q_offset + start + 1))
            if c0 < kend:
                qpos = q_offset + start + torch.arange(n, device=q.device)
                kpos = torch.arange(c0, kend, device=q.device)
                masked = (kpos[None, :] > qpos[:, None]).repeat(g, 1)
                s[..., c0:kend].masked_fill_(masked, NEG)
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.matmul(p.to(v.dtype), vt[:, :, :kend])  # [B,Hkv,G*n,dv]
        del p
        out[:, start:start + n] = o.view(b, hkv, g, n, dv) \
            .permute(0, 3, 1, 2, 4)
    return out


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :]


def gqa_apply(params: dict, cfg: GQAConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              return_cache: bool = False):
    """Prefill: x [B, S, d] -> y [B, S, d] (and, with ``return_cache``, the
    layer's cache ``{k, v}`` [B, S, Hkv, dh] after the norms and rope)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = _positions(s, x.device)
    q = (x @ params["wq"]).view(b, s, h, dh)
    k = (x @ params["wk"]).view(b, s, kv, dh)
    v = (x @ params["wv"]).view(b, s, kv, dh)
    if cfg.qk_norm:
        q = cm.rms_norm(q, params["q_gamma"])
        k = cm.rms_norm(k, params["k_gamma"])
    cos, sin = cm.rope_angles(positions, dh, cfg.rope_base)
    q = cm.apply_rope(q, cos[:, :, None], sin[:, :, None])
    k = cm.apply_rope(k, cos[:, :, None], sin[:, :, None])
    out = _chunked_attention(q.view(b, s, kv, h // kv, dh), k, v,
                             q_chunk=min(cfg.q_chunk, s), causal=True)
    y = out.view(b, s, h * dh) @ params["wo"]
    if return_cache:
        return y, {"k": k, "v": v}
    return y


F32_ROUTE = {"route": None}    # on the card: "out_dtype" or "upcast"


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, accumulated and returned in fp32 (the reference's
    ``preferred_element_type=float32``): on the card from bf16 directly
    where ``torch.bmm`` takes ``out_dtype`` (tried once), else, as on the
    CPU, from fp32 copies."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda and F32_ROUTE["route"] != "upcast":
        try:
            out = torch.bmm(a, b, out_dtype=torch.float32)
        except (TypeError, RuntimeError, NotImplementedError):
            F32_ROUTE["route"] = "upcast"
        else:
            F32_ROUTE["route"] = "out_dtype"
            return out
    return torch.bmm(a.float(), b.float())


def _decode_softmax(s: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """s [B, ..., Smax] fp32: the keys past ``pos[b]`` at -1e30, then the
    softmax over the last axis."""
    smax = s.shape[-1]
    mask = torch.arange(smax, device=s.device)[None, :] > pos[:, None]
    s.masked_fill_(mask.view((s.shape[0],) + (1,) * (s.dim() - 2)
                             + (smax,)), NEG)
    return torch.softmax(s, dim=-1)


def seq_shards(mesh, smax: Optional[int]) -> int:
    """The ``model`` ranks a decode cache of ``smax`` positions is split
    over at ``mesh`` (1: whole on this rank).  A mesh whose ``model`` axis
    has several ranks needs ``smax``, since a rank holds a slice."""
    if mesh is None or mesh.size("model") == 1:
        return 1
    if smax is None:
        raise ValueError("decode at a mesh with a model axis of "
                         f"{mesh.size('model')} ranks needs the cache's "
                         "whole length smax")
    return mesh.seq_shards(smax)


def _shard_write(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 base: int) -> None:
    """Writes ``new[b]`` at ``[b, pos[b] - base]`` of this shard's cache
    slice ``c`` for the rows whose position it owns, in place; every other
    row re-writes its entry at the clamped position, as the reference
    does (no value changes, and the host never waits for the card)."""
    li = pos.long() - base
    own = (li >= 0) & (li < c.shape[1])
    li = li.clamp(0, c.shape[1] - 1)
    bidx = torch.arange(c.shape[0], device=c.device)
    own = own.view((-1,) + (1,) * (new.dim() - 1))
    c.index_put_((bidx, li), torch.where(own, new.to(c.dtype), c[bidx, li]))


def _shard_mask(s: torch.Tensor, pos: torch.Tensor, base: int) -> None:
    """The keys of this shard past ``pos[b]`` at -1e30, in place."""
    kpos = base + torch.arange(s.shape[-1], device=s.device)
    mask = kpos[None, :] > pos[:, None]
    s.masked_fill_(mask.view((s.shape[0],) + (1,) * (s.dim() - 2)
                             + (s.shape[-1],)), NEG)


def _flash_combine(s: torch.Tensor, group):
    """s [B, ..., S_loc] fp32 masked scores -> (e = exp(s - m), l) with
    ``m`` the max over every shard's keys (``pmax``) and ``l`` the sum of
    ``e`` over them (``psum``).  A shard with every key masked gives e of
    exactly 0 (m is finite: position 0 is always attended)."""
    m = dist.all_reduce_max(s.amax(dim=-1), group)
    e = torch.exp(s - m[..., None])
    return e, dist.all_reduce_sum(e.sum(dim=-1), group)


def _flash_decode_body(qg, k_c, v_c, k_new, v_new, pos, *, group,
                       index: int, smax: int, n_shards: int):
    """The reference's ``_flash_decode_body`` on one ``model`` rank: the
    cache S-sharded over ``group``, this rank shard ``index``; the update
    lands only in the owning shard; the softmax combines with small
    all-reduces.  qg [B, kv, g, dh] (every rank the same); k_c / v_c this
    rank's [B, S_loc, kv, dh], updated in place -> (o [B, kv, g, dh] in
    v_c's dtype, k_c, v_c)."""
    b, kv, g, dh = qg.shape
    base = index * (smax // n_shards)
    _shard_write(k_c, k_new, pos, base)
    _shard_write(v_c, v_new, pos, base)
    q = (qg * _scalar_in(1.0 / dh ** 0.5, qg.dtype)).to(k_c.dtype)
    s = torch.empty((b, kv, g, k_c.shape[1]), dtype=torch.float32,
                    device=qg.device)
    for j in range(kv):
        s[:, j] = _bmm_f32(q[:, j], k_c[:, :, j].transpose(1, 2))
    _shard_mask(s, pos, base)
    e, l = _flash_combine(s, group)
    del s
    num = torch.empty((b, kv, g, v_c.shape[-1]), dtype=torch.float32,
                      device=qg.device)
    for j in range(kv):
        num[:, j] = torch.bmm(e[:, j].to(v_c.dtype), v_c[:, :, j])
    num = dist.all_reduce_sum(num, group)
    o = num / l.clamp(min=1e-30)[..., None]
    return o.to(v_c.dtype), k_c, v_c


def _gqa_qkv(params: dict, cfg: GQAConfig, x: torch.Tensor,
             pos: torch.Tensor):
    """A decode step's query [B, 1, H, dh] and new key and value [B, 1,
    Hkv, dh]: the projections, the qk norms, the rope at ``pos``."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).view(b, 1, h, dh)
    k_new = (x @ params["wk"]).view(b, 1, kv, dh)
    v_new = (x @ params["wv"]).view(b, 1, kv, dh)
    if cfg.qk_norm:
        q = cm.rms_norm(q, params["q_gamma"])
        k_new = cm.rms_norm(k_new, params["k_gamma"])
    cos, sin = cm.rope_angles(pos[:, None], dh, cfg.rope_base)
    q = cm.apply_rope(q, cos[:, :, None], sin[:, :, None])
    k_new = cm.apply_rope(k_new, cos[:, :, None], sin[:, :, None])
    return q, k_new, v_new


def gqa_decode(params: dict, cfg: GQAConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, mesh=None, smax: Optional[int] = None):
    """One-token decode.  x [B, 1, d]; cache ``{k, v}`` [B, Smax, Hkv, dh]
    (at a ``mesh`` that splits ``smax`` positions, this rank's slice
    [B, smax / n, Hkv, dh]: module docstring); ``pos`` [B] the current
    lengths.  Writes the new key and value at ``[b, pos[b]]`` of the cache
    IN PLACE (the reference returns a new cache) and attends over
    positions ``<= pos[b]`` -> (y [B, 1, d], the same cache dict).  One
    kv head at a time: its slice of the cache is a strided batch of
    matrices, so no copy of the cache is made."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    q, k_new, v_new = _gqa_qkv(params, cfg, x, pos)
    n = seq_shards(mesh, smax)
    if n > 1:
        DECODE_PATHS["flash"] += 1
        o, _, _ = _flash_decode_body(
            q.view(b, kv, g, dh), cache["k"], cache["v"], k_new[:, 0],
            v_new[:, 0], pos, group=mesh.model_group,
            index=mesh.model_index, smax=smax, n_shards=n)
        return o.view(b, 1, h * dh) @ params["wo"], cache
    DECODE_PATHS["whole"] += 1
    k_c, v_c = cache["k"], cache["v"]
    bidx = torch.arange(b, device=x.device)
    pidx = pos.long()
    k_c.index_put_((bidx, pidx), k_new[:, 0].to(k_c.dtype))
    v_c.index_put_((bidx, pidx), v_new[:, 0].to(v_c.dtype))
    # the reference scales q by a weak-typed scalar: rounded to q's dtype
    # first (here on the host, so that nothing is copied to the card)
    qg = (q.view(b, kv, g, dh) * _scalar_in(1.0 / dh ** 0.5, q.dtype)) \
        .to(k_c.dtype)
    smax = k_c.shape[1]
    s = torch.empty((b, kv, g, smax), dtype=torch.float32, device=x.device)
    for j in range(kv):
        s[:, j] = _bmm_f32(qg[:, j], k_c[:, :, j].transpose(1, 2))
    p = _decode_softmax(s, pos).to(v_c.dtype)
    del s
    o = torch.empty((b, kv, g, v_c.shape[-1]), dtype=v_c.dtype,
                    device=x.device)
    for j in range(kv):
        o[:, j] = torch.bmm(p[:, j], v_c[:, :, j])
    y = o.view(b, 1, h * dh) @ params["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _mla_qkv(params: dict, cfg: MLAConfig, x: torch.Tensor,
             positions: torch.Tensor):
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = cm.rms_norm(x @ params["w_dq"], params["q_gamma"])
    q = (cq @ params["w_uq"]).view(b, s, h, cfg.dh_nope + cfg.dh_rope)
    q_nope, q_rope = q[..., :cfg.dh_nope], q[..., cfg.dh_nope:]
    ckv = cm.rms_norm(x @ params["w_dkv"], params["kv_gamma"])
    kr = x @ params["w_kr"]                                 # [B, S, dh_rope]
    cos, sin = cm.rope_angles(positions, cfg.dh_rope, cfg.rope_base)
    q_rope = cm.apply_rope(q_rope, cos[:, :, None], sin[:, :, None])
    kr = cm.apply_rope(kr[:, :, None], cos[:, :, None],
                       sin[:, :, None])[:, :, 0]
    return q_nope, q_rope, ckv, kr


def mla_apply(params: dict, cfg: MLAConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              return_cache: bool = False):
    """Prefill: the latent ``ckv`` and ``kr`` expanded to per-head keys and
    values (MHA: GQA with G = 1).  With ``return_cache``, also the layer's
    latent cache ``{ckv [B, S, kv_lora], kr [B, S, dh_rope]}``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = _positions(s, x.device)
    q_nope, q_rope, ckv, kr = _mla_qkv(params, cfg, x, positions)
    k_nope = (ckv @ params["w_uk"]).view(b, s, h, cfg.dh_nope)
    v = (ckv @ params["w_uv"]).view(b, s, h, cfg.dv)
    k = torch.cat([k_nope, kr[:, :, None].expand(b, s, h, cfg.dh_rope)],
                  dim=-1)
    del k_nope
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = _chunked_attention(q.view(b, s, h, 1, cfg.dh_nope + cfg.dh_rope),
                             k, v, q_chunk=min(cfg.q_chunk, s), causal=True)
    y = out.view(b, s, h * cfg.dv) @ params["wo"]
    if return_cache:
        return y, {"ckv": ckv, "kr": kr}
    return y


def _mla_flash_body(q_abs, q_rope, ckv_c, kr_c, ckv_new, kr_new, pos, *,
                    group, index: int, smax: int, n_shards: int,
                    scale: float):
    """The reference's ``_mla_flash_body`` on one ``model`` rank: the
    latent-cache flash-decode, scores and context both in the kv_lora
    latent space, combined over the S-shards of ``group`` with small
    all-reduces.  q_abs [B, H, L], q_rope [B, H, dh_rope] fp32; ckv_c /
    kr_c this rank's [B, S_loc, ...], updated in place -> (ctx [B, H, L]
    fp32, ckv_c, kr_c)."""
    base = index * (smax // n_shards)
    _shard_write(ckv_c, ckv_new, pos, base)
    _shard_write(kr_c, kr_new, pos, base)
    s = _bmm_f32(q_abs.to(ckv_c.dtype), ckv_c.transpose(1, 2))
    s += _bmm_f32(q_rope.to(kr_c.dtype), kr_c.transpose(1, 2))
    s *= scale
    _shard_mask(s, pos, base)
    e, l = _flash_combine(s, group)
    del s
    num = dist.all_reduce_sum(_bmm_f32(e.to(ckv_c.dtype), ckv_c), group)
    return num / l.clamp(min=1e-30)[..., None], ckv_c, kr_c


def mla_decode(params: dict, cfg: MLAConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, mesh=None, smax: Optional[int] = None):
    """Latent-cache decode in the absorbed form: the nope score is
    ``(q_nope W_uk^T) . ckv`` (``q_abs`` in fp32), the context stays in
    the latent space and meets ``W_uv`` in fp32.  The cache (this rank's
    slice at a ``mesh`` that splits ``smax``: module docstring) is updated
    IN PLACE at ``[b, pos[b]]`` and returned (the reference returns a new
    one) -> (y [B, 1, d], cache)."""
    b = x.shape[0]
    q_abs, qr, ckv_new, kr_new = _mla_absorbed(params, cfg, x, pos)
    scale = mla_scale(cfg)
    ckv_c, kr_c = cache["ckv"], cache["kr"]
    n = seq_shards(mesh, smax)
    if n > 1:
        DECODE_PATHS["flash"] += 1
        ctx, _, _ = _mla_flash_body(
            q_abs, qr, ckv_c, kr_c, ckv_new, kr_new, pos,
            group=mesh.model_group, index=mesh.model_index, smax=smax,
            n_shards=n, scale=scale)
    else:
        DECODE_PATHS["whole"] += 1
        bidx = torch.arange(b, device=x.device)
        pidx = pos.long()
        ckv_c.index_put_((bidx, pidx), ckv_new.to(ckv_c.dtype))
        kr_c.index_put_((bidx, pidx), kr_new.to(kr_c.dtype))
        s = _bmm_f32(q_abs.to(ckv_c.dtype), ckv_c.transpose(1, 2))
        s += _bmm_f32(qr.to(kr_c.dtype), kr_c.transpose(1, 2))
        s *= scale
        p = _decode_softmax(s, pos)
        del s
        ctx = _bmm_f32(p.to(ckv_c.dtype), ckv_c)             # [B, H, L]
    return _mla_out(params, cfg, ctx, x.dtype), cache


def _mla_absorbed(params: dict, cfg: MLAConfig, x: torch.Tensor,
                  pos: torch.Tensor):
    """A decode step's absorbed query ``q_abs`` [B, H, L] = q_nope W_uk^T
    and rope query [B, H, dh_rope] (both fp32), and its new latent entry
    ``ckv`` [B, L] and ``kr`` [B, dh_rope]."""
    h = cfg.n_heads
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv(params, cfg, x, pos[:, None])
    w_uk = params["w_uk"].view(cfg.kv_lora, h, cfg.dh_nope)
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(),
                         w_uk.float())
    return q_abs, q_rope[:, 0].float(), ckv_new[:, 0], kr_new[:, 0]


def mla_scale(cfg: MLAConfig) -> float:
    return (cfg.dh_nope + cfg.dh_rope) ** -0.5


def _mla_out(params: dict, cfg: MLAConfig, ctx: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The latent context [B, H, L] (fp32) through W_uv (fp32) and ``wo``
    -> y [B, 1, d] in ``dtype``."""
    b, h = ctx.shape[0], cfg.n_heads
    w_uv = params["w_uv"].view(cfg.kv_lora, h, cfg.dv)
    o = torch.einsum("bhl,lhd->bhd", ctx, w_uv.float())
    return o.reshape(b, 1, h * cfg.dv).to(dtype) @ params["wo"]
