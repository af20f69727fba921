"""Mixture-of-Experts FFN, from the JAX package's ``models/moe.py``, at one
expert-parallel rank.

The dispatch is the paper's batch-query protocol: tokens are keys, experts
are shards.  The tokens are bucketed by owning expert into fixed-capacity
buffers (``core/distributed.route_by_owner`` and ``scatter_to_buffers``),
every expert answers its buffer, and the answers are gathered back and
mixed by the top-k gate weights; tokens past an expert's capacity are
dropped and counted (never silently).  With one rank the reference's
``all_to_all`` over ``model`` is the identity; its torch.distributed form
waits for ROADMAP queue 1, item 15.3.

One departure, the one ``core/distributed.py`` makes: only kept slots are
written into the send buffers.  The reference also writes a zero for every
dropped slot at ``(expert, 0)``, which a kept token holds whenever that
expert overflows, and on the CPU the zero wins: that token loses one expert
of its mixture (``tests/test_torch_lm.py`` shows it).  Here it keeps it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as dist
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec
from repro_torch.models.recsys import lax_top_k


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0          # shared experts (always-on), DeepSeek style
    shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    aux_weight: float = 0.001
    norm_topk: bool = True     # renormalize top-k gate weights to sum to 1

    @property
    def shared_ff(self) -> int:
        return self.shared_d_ff or (self.n_shared * self.d_ff)


def moe_specs(cfg: MoEConfig) -> dict:
    """The router in fp32 whatever the model's dtype, as the reference."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    p = {"router": ParamSpec((d, e), scale, torch.float32),
         "w_gate": ParamSpec((e, d, f), scale),
         "w_up": ParamSpec((e, d, f), scale),
         "w_down": ParamSpec((e, f, d), 1.0 / math.sqrt(f))}
    if cfg.n_shared:
        fs = cfg.shared_ff
        p["shared/w_gate"] = ParamSpec((d, fs), scale)
        p["shared/w_up"] = ParamSpec((d, fs), scale)
        p["shared/w_down"] = ParamSpec((fs, d), 1.0 / math.sqrt(fs))
    return p


def moe_init(cfg: MoEConfig, *, generator: torch.Generator, device,
             dtype=torch.bfloat16) -> dict:
    return cm.draw_params(moe_specs(cfg), generator=generator,
                          device=device, dtype=dtype)


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """An expert's buffer: ``max(ceil(t k / E cf), 1)`` slots."""
    return max(int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def route(params: dict, cfg: MoEConfig, x: torch.Tensor):
    """x [t, d] -> (probs [t, E], top-k weights [t, k], top-k experts
    [t, k]): the fp32 router, its softmax and ``lax_top_k`` (equal
    probabilities by ascending expert), renormalised when ``norm_topk``."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    topv, topi = lax_top_k(probs, cfg.top_k)
    if cfg.norm_topk:
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, topv, topi


def _moe_body(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x [t, d] this rank's tokens -> (y [t, d], aux, dropped share)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, topv, topi = route(params, cfg, x)

    # the Switch load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, topi.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=x.device))
    aux = e * (me * ce).sum()

    # dispatch: the batch-query fan-out into [E, cap, d]
    cap = capacity(cfg, t)
    r = dist.route_by_owner(topi.reshape(-1).to(torch.int32), e, cap)
    send, = dist.scatter_to_buffers(r, [x.repeat_interleave(k, dim=0)], e,
                                    cap)
    dropped = r.n_dropped.float() / (t * k)

    # the experts, then the answers back and mixed
    h = torch.bmm(send, params["w_gate"])
    u = torch.bmm(send, params["w_up"])
    del send
    y = torch.bmm(F.silu(h) * u, params["w_down"])
    del h, u
    per_slot, = dist.gather_from_buffers(r, [y])
    del y
    per_slot = torch.where(r.kept[:, None], per_slot, 0)
    w = topv.reshape(-1)[:, None].to(per_slot.dtype)
    out = (per_slot * w).view(t, k, d).sum(dim=1)
    if cfg.n_shared:
        s = cm.sub(params, "shared")
        out = out + _swiglu(x, s["w_gate"], s["w_up"], s["w_down"])
    return out, aux, dropped


def moe_apply(params: dict, cfg: MoEConfig, x: torch.Tensor):
    """x [B, S, d] -> (y [B, S, d], aux loss, dropped share), every token
    of ``x`` on this rank (the reference's body with ``model`` of 1)."""
    y, aux, dropped = _moe_body(params, x.reshape(-1, x.shape[-1]), cfg)
    return y.view(x.shape), aux, dropped
