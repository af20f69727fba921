"""Attention blocks, from the JAX package's ``models/attention.py``: GQA
(optionally qk-norm) and MLA (DeepSeek-V3), with query-chunked attention
for prefill (no S x S score tensor: one [B, Hkv, G, q_chunk, S] chunk at a
time) and KV-cache decode.

Shapes:  x [B, S, d];  GQA cache {k, v: [B, Smax, Hkv, dh]};
         MLA cache {ckv: [B, Smax, kv_lora], kr: [B, Smax, dh_rope]}.

Parameters are path-keyed dicts of tensors (``wq``, ``q_gamma``, ...), the
JAX package's names and shapes.  The decode paths are the JAX package's
one-device paths (the cache whole on one card: ``attention.py``'s
fallback when the ``model`` axis has one shard); the sequence-sharded
flash-decode waits for ROADMAP queue 1, item 15.3.

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

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec

NEG = -1e30          # the reference's mask value


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
    tensors are freed before the next chunk starts; keys past a chunk's
    last position are skipped under the causal mask (module docstring)."""
    b, sq, hkv, g, dh = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = _scalar_in(1.0 / math.sqrt(dh), torch.float32)
    # both laid out once so that every chunk's products are plain batched
    # GEMMs over (B, Hkv), their key range a slice of the last axis
    kt = k.permute(0, 2, 3, 1).to(torch.float32,        # [B, Hkv, dh, Sk]
                                  memory_format=torch.contiguous_format)
    vt = v.permute(0, 2, 1, 3).contiguous()              # [B, Hkv, Sk, dv]
    out = torch.empty((b, sq, hkv, g, dv), dtype=v.dtype, device=v.device)
    for start in range(0, sq, q_chunk):
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


def gqa_decode(params: dict, cfg: GQAConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor):
    """One-token decode.  x [B, 1, d]; cache ``{k, v}`` [B, Smax, Hkv, dh];
    ``pos`` [B] the current lengths.  Writes the new key and value at
    ``[b, pos[b]]`` of the cache IN PLACE (the reference returns a new
    cache) and attends over positions ``<= pos[b]`` -> (y [B, 1, d], the
    same cache dict).  One kv head at a time: its slice of the cache is a
    strided batch of matrices, so no copy of the cache is made."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    q = (x @ params["wq"]).view(b, 1, h, dh)
    k_new = (x @ params["wk"]).view(b, 1, kv, dh)
    v_new = (x @ params["wv"]).view(b, 1, kv, dh)
    if cfg.qk_norm:
        q = cm.rms_norm(q, params["q_gamma"])
        k_new = cm.rms_norm(k_new, params["k_gamma"])
    cos, sin = cm.rope_angles(pos[:, None], dh, cfg.rope_base)
    q = cm.apply_rope(q, cos[:, :, None], sin[:, :, None])
    k_new = cm.apply_rope(k_new, cos[:, :, None], sin[:, :, None])

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


def mla_decode(params: dict, cfg: MLAConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor):
    """Latent-cache decode in the absorbed form: the nope score is
    ``(q_nope W_uk^T) . ckv`` (``q_abs`` in fp32), the context stays in
    the latent space and meets ``W_uv`` in fp32.  The cache is updated IN
    PLACE at ``[b, pos[b]]`` and returned (the reference returns a new
    one) -> (y [B, 1, d], cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv(params, cfg, x, pos[:, None])
    w_uk = params["w_uk"].view(cfg.kv_lora, h, cfg.dh_nope)
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(),
                         w_uk.float())                       # [B, H, L]
    scale = (cfg.dh_nope + cfg.dh_rope) ** -0.5
    qr = q_rope[:, 0].float()

    ckv_c, kr_c = cache["ckv"], cache["kr"]
    bidx = torch.arange(b, device=x.device)
    pidx = pos.long()
    ckv_c.index_put_((bidx, pidx), ckv_new[:, 0].to(ckv_c.dtype))
    kr_c.index_put_((bidx, pidx), kr_new[:, 0].to(kr_c.dtype))
    s = _bmm_f32(q_abs.to(ckv_c.dtype), ckv_c.transpose(1, 2))
    s += _bmm_f32(qr.to(kr_c.dtype), kr_c.transpose(1, 2))
    s *= scale
    p = _decode_softmax(s, pos)
    del s
    ctx = _bmm_f32(p.to(ckv_c.dtype), ckv_c)                 # [B, H, L]
    w_uv = params["w_uv"].view(cfg.kv_lora, h, cfg.dv)
    o = torch.einsum("bhl,lhd->bhd", ctx, w_uv.float())
    y = o.reshape(b, 1, h * cfg.dv).to(x.dtype) @ params["wo"]
    return y, cache

