"""Optimizers over path-keyed parameter dicts, from the JAX package's
``train/optimizer.py``.

Three rules, chosen per leaf by its path (``rule_for_path``):

* ``adam`` — fp32 m and v; the dense towers.
* ``adafactor`` — a factored second moment (row and column fp32) and bf16
  momentum; the JAX package's rule for its largest LMs.
* ``adagrad_rows`` — row-wise Adagrad for embedding tables: one fp32
  accumulator a row.

Parameters are a flat dict ``{path: tensor}``, the optimizer state
``{path: {name: tensor}}`` (``core/convert.py``).  ``apply_updates``
returns new tensors, as the JAX function does; ``apply_updates_`` writes
the same values into the parameters and the state in place, a block of
each leaf at a time (``update_blocks``), so that a model near the card's
size needs no second copy of either.  The step is 1-based.  The JAX
package's sharding specs (``opt_state_specs``) have no counterpart on one
card.

The clipped gradient is ``g.float() * clip``: JAX's ``g * clip`` promotes
a bf16 leaf to fp32 there (``clip`` is an fp32 array), where torch would
keep ``bf16 * 0-dim fp32`` in bf16 and round the scaled gradient once
more.

Scalars that JAX computes in float32 from the step (the bias corrections,
adafactor's decay) are computed here in numpy float32 on the host, so both
packages feed the same float32 values to the element-wise arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
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


# a leaf's fp32 work is done this many elements at a time (whole rows of
# what a rule reduces over): no fp32 copy of a [40, 5120, 17408] stack
BLOCK_ELEMENTS = 1 << 26


def _square_sum(g) -> torch.Tensor:
    """``sum(square(g.float()))`` without an fp32 copy of a large leaf: a
    list of layers (``train_step``'s in-place step) or a leaf of three
    or more axes sums each slice of its first axis (recursively), a larger
    leaf of ``BLOCK_ELEMENTS`` sums blocks of rows; the parts' sums add
    in order.  A stack and the list of its layers sum alike."""
    if isinstance(g, (list, tuple)):
        parts = g
    elif g.dim() >= 3:
        parts = g.unbind(0)
    elif g.dim() and g.numel() > BLOCK_ELEMENTS:
        step = max(1, BLOCK_ELEMENTS // (g.numel() // g.shape[0]))
        parts = g.split(step)
    else:
        return g.float().square().sum()
    return torch.stack([_square_sum(x) for x in parts]).sum()


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [_square_sum(g) for g in grads.values()]).sum())


def _clip(grads: dict, cfg: OptConfig):
    """-> (|g|, the gradients' scale: ``min(1, grad_clip / max(|g|,
    1e-12))`` as an fp32 0-dim tensor when ``grad_clip`` is set, else
    1.0)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-12), max=1.0) \
        if cfg.grad_clip else 1.0
    return gnorm, clip


def apply_updates(params: dict, grads: dict, opt_state: dict,
                  cfg: OptConfig, step: int):
    """``step``: the 1-based step.  The gradients are scaled by
    ``min(1, grad_clip / max(|g|, 1e-12))`` (``|g|`` their global norm)
    when ``grad_clip`` is set, in fp32.  Returns (new_params, new_state,
    |g|)."""
    gnorm, clip = _clip(grads, cfg)
    new_p, new_s = {}, {}
    for k, p in params.items():
        new_p[k], new_s[k] = _UPDATES[rule_for_path(k, cfg)](
            p, grads[k].float() * clip, opt_state[k], cfg, step)
    return new_p, new_s, gnorm


def _unit(rule: str, shape: tuple) -> int:
    """The elements of the smallest piece of a leaf of ``shape`` that
    ``rule`` updates on its own: adam's element, adagrad_rows' row,
    adafactor's matrix over the last two axes (of a leaf of fewer than
    three axes, the whole leaf: its row and column means span it)."""
    n = math.prod(shape)
    if rule == "adafactor":
        return shape[-2] * shape[-1] if len(shape) >= 3 else n
    if rule == "adagrad_rows" and len(shape) > 1:
        return n // shape[0]
    return 1


def largest_block(rule: str, shape: tuple) -> int:
    """The elements of the largest of ``update_blocks``' blocks."""
    unit = _unit(rule, shape)
    return min(math.prod(shape), max(1, BLOCK_ELEMENTS // unit) * unit)


def update_blocks(rule: str, p: torch.Tensor, st: dict):
    """The blocks of leaf ``p`` and its state ``st`` that ``rule`` updates
    independently, as ``(p block, {name: state block})`` views: whole
    units (``_unit``), as many as fit ``BLOCK_ELEMENTS`` and at least
    one."""
    unit = _unit(rule, tuple(p.shape))
    if unit == p.numel():
        return [(p, st)]
    if rule == "adafactor":
        r, c = p.shape[-2:]
        pv = p.view(-1, r, c)
        sv = {"m": st["m"].view(-1, r, c), "vc": st["vc"].view(-1, c),
              "vr": st["vr"].view(-1, r)}
    else:                        # rows of adagrad_rows, elements of adam
        pv = p.view(-1, unit) if unit > 1 else p.view(-1)
        sv = {n: t.view(-1) for n, t in st.items()}
    step = max(1, BLOCK_ELEMENTS // unit)
    return [(pv[i:i + step], {n: t[i:i + step] for n, t in sv.items()})
            for i in range(0, pv.shape[0], step)]


def apply_updates_(params: dict, grads: dict, opt_state: dict,
                   cfg: OptConfig, step: int) -> torch.Tensor:
    """``apply_updates`` IN PLACE: every block of every leaf
    (``update_blocks``) takes the functional rule's values, written into
    the parameter and its state, so nothing larger than a block is made.
    The same values bit for bit: each rule's arithmetic within a block is
    the whole leaf's.  A gradient may be the list of the layers of a
    stack of three or more axes (``train_step``'s in-place step): each
    layer's slice is then updated from its own where the rule allows
    (Adam, Adafactor), else from their stack.
    Each gradient is dropped from ``grads`` once its leaf is updated, a
    layer's once its slice is.  Returns |g|."""
    gnorm, clip = _clip(grads, cfg)
    for k, p in params.items():
        rule = rule_for_path(k, cfg)
        g, st = grads.pop(k), opt_state[k]
        if not isinstance(g, list):
            parts = [(p, st, g)]
        elif rule in ("adam", "adafactor"):
            # a layer's slice (a matrix or more) is whole units of the rule
            parts = [(p[i], {n: t[i] for n, t in st.items()}, g[i])
                     for i in range(len(g))]
        else:
            parts = [(p, st, torch.stack(g))]
        del g
        while parts:
            pp, ss, gg = parts.pop(0)
            gg = gg.contiguous()
            for (pb, sb), (gb, _) in zip(update_blocks(rule, pp, ss),
                                         update_blocks(rule, gg, ss)):
                new_p, new_s = _UPDATES[rule](pb, gb.float() * clip, sb,
                                              cfg, step)
                pb.copy_(new_p)
                for n, t in new_s.items():
                    sb[n].copy_(t)
            # a layer's gradient goes once it is used
            del pp, ss, gg, gb, new_p, new_s
    return gnorm
