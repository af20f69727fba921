"""Optimizers over path-keyed parameter dicts, from the JAX package's
``train/optimizer.py``.

Three rules, chosen per leaf by its path (``rule_for_path``):

* ``adam`` — fp32 m and v; the dense towers.
* ``adafactor`` — a factored second moment (row and column fp32) and bf16
  momentum; the JAX package's rule for its largest LMs.
* ``adagrad_rows`` — row-wise Adagrad for embedding tables: one fp32
  accumulator a row.

Parameters are a flat dict ``{path: tensor}``, the optimizer state
``{path: {name: tensor}}`` (``core/convert.py``).  The updates return new
tensors, as the JAX functions do; the step is 1-based.  The JAX package's
sharding specs (``opt_state_specs``) have no counterpart on one card.

Scalars that JAX computes in float32 from the step (the bias corrections,
adafactor's decay) are computed here in numpy float32 on the host, so both
packages feed the same float32 values to the element-wise arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    table_rule: str = "adagrad_rows"
    dense_rule: str = "adam"          # adam | adafactor


def rule_for_path(path: str, cfg: OptConfig) -> str:
    """A table's rule where the path names a table or an embedding, else the
    dense rule."""
    if "table" in path or "embed" in path:
        return cfg.table_rule
    return cfg.dense_rule


def _zeros(p: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=p.device)


def _leaf_state(rule: str, p: torch.Tensor) -> dict:
    if rule == "adam":
        return {"m": _zeros(p, p.shape), "v": _zeros(p, p.shape)}
    if rule == "adafactor":
        st = {"m": _zeros(p, p.shape, torch.bfloat16)}
        if p.dim() >= 2:          # names in sorted order, as JAX flattens
            st["vc"] = _zeros(p, p.shape[:-2] + p.shape[-1:])      # col
            st["vr"] = _zeros(p, p.shape[:-1])                     # row
        else:
            st["v"] = _zeros(p, p.shape)
        return st
    if rule == "adagrad_rows":
        return {"acc": _zeros(p, p.shape[:1])}
    raise ValueError(rule)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    return {k: _leaf_state(rule_for_path(k, cfg), p)
            for k, p in params.items()}


def _f32(x) -> float:
    """A host float32 scalar as a Python float (exact)."""
    return float(np.float32(x))


def _adam_update(p, g, st, cfg: OptConfig, step: int):
    g = g.float()
    m = cfg.b1 * st["m"] + (1 - cfg.b1) * g
    v = cfg.b2 * st["v"] + (1 - cfg.b2) * g * g
    one, s = np.float32(1), np.float32(step)
    mhat = m / _f32(one - np.float32(cfg.b1) ** s)
    vhat = v / _f32(one - np.float32(cfg.b2) ** s)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * p.float()
    new_p = (p.float() - cfg.lr * upd).to(p.dtype)
    return new_p, {"m": m, "v": v}


def _adafactor_update(p, g, st, cfg: OptConfig, step: int):
    g = g.float()
    decay = _f32(np.float32(1) - np.float32(1) / np.maximum(
        np.float32(step), np.float32(1)) ** np.float32(0.8))
    new_st = {}
    if "vr" in st:
        vr = decay * st["vr"] + (1 - decay) * (g * g).mean(dim=-1)
        vc = decay * st["vc"] + (1 - decay) * (g * g).mean(dim=-2)
        new_st["vr"], new_st["vc"] = vr, vc
        denom = torch.sqrt(
            vr[..., None] * vc[..., None, :]
            / vr.mean(dim=-1, keepdim=True)[..., None].clamp(min=1e-30)
        ) + cfg.eps
    else:
        v = decay * st["v"] + (1 - decay) * g * g
        new_st["v"] = v
        denom = torch.sqrt(v) + cfg.eps
    upd = g / denom
    m = cfg.b1 * st["m"].float() + (1 - cfg.b1) * upd
    new_st["m"] = m.to(torch.bfloat16)
    new_p = (p.float() - cfg.lr * m).to(p.dtype)
    return new_p, dict(sorted(new_st.items()))


def _adagrad_rows_update(p, g, st, cfg: OptConfig, step: int):
    g = g.float()
    # mean over every axis but the first (none for a 1-D leaf, as jnp.mean
    # with an empty axis tuple; torch's mean would reduce them all)
    row_sq = (g * g).mean(dim=tuple(range(1, g.dim()))) if g.dim() > 1 \
        else g * g
    acc = st["acc"] + row_sq
    scale = cfg.lr / (torch.sqrt(acc) + cfg.eps)
    new_p = (p.float() - scale.reshape((-1,) + (1,) * (g.dim() - 1)) * g
             ).to(p.dtype)
    return new_p, {"acc": acc}


_UPDATES: dict[str, Callable] = {
    "adam": _adam_update,
    "adafactor": _adafactor_update,
    "adagrad_rows": _adagrad_rows_update,
}


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in grads.values()]).sum())


def apply_updates(params: dict, grads: dict, opt_state: dict,
                  cfg: OptConfig, step: int):
    """``step``: the 1-based step.  The gradients are scaled by
    ``min(1, grad_clip / max(|g|, 1e-12))`` (``|g|`` their global norm)
    when ``grad_clip`` is set.  Returns (new_params, new_state, |g|)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-12), max=1.0) \
        if cfg.grad_clip else 1.0
    new_p, new_s = {}, {}
    for k, p in params.items():
        new_p[k], new_s[k] = _UPDATES[rule_for_path(k, cfg)](
            p, grads[k] * clip, opt_state[k], cfg, step)
    return new_p, new_s, gnorm
