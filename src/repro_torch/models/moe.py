"""Mixture-of-Experts FFN, from the JAX package's ``models/moe.py``, with
expert parallelism over the ``model`` axis of a ``torch.distributed``
mesh (``launch/mesh.make_mesh``).

The dispatch is the paper's batch-query protocol: tokens are keys, experts
are shards.  The tokens are bucketed by owning expert into fixed-capacity
buffers (``core/distributed.route_by_owner`` and ``scatter_to_buffers``),
exchanged with an ``all_to_all`` over the ``model`` group, answered by each
rank's own experts, sent back the same way and mixed by the top-k gate
weights; tokens past an expert's capacity are dropped and counted (never
silently).  In a world of one there is no exchange (the reference's
``all_to_all`` over a ``model`` axis of 1 is the identity).

At a mesh each ``model`` rank holds ``E / n`` experts (``w_gate``,
``w_up``, ``w_down`` sliced on their expert axis; ``core/convert.
lm_rank_share``), the router and the shared experts whole.  ``moe_apply``
takes the reference's token layout: in prefill this rank's batch rows,
their sequence split over ``model`` where it divides (sequence
parallelism; the output all-gathered back along it), else every token on
every ``model`` rank; in decode (``decode=True``) the whole batch on every
rank (the reference's ``P(None, None, None)``).  The capacity is each
rank's own, from its own token count; ``aux`` and the dropped share are
averaged over every rank of the world (the reference's ``pmean`` over
all axes).  ``EP_PATHS`` counts the bodies that exchanged and those that
ran every expert locally.  Autograd through the exchange is refused
(``EP_AUTOGRAD``): training the expert-parallel MoE is ROADMAP queue 1,
item 15.4.

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

EP_PATHS = {"expert_parallel": 0, "local": 0}     # MoE bodies, by path
EP_AUTOGRAD = ("autograd through the expert-parallel all_to_all (a model "
               "group of more than one rank) waits for ROADMAP queue 1, "
               "item 15.4; run the expert-parallel MoE under "
               "torch.no_grad()")


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


def _moe_body(params: dict, x: torch.Tensor, cfg: MoEConfig, group=None):
    """x [t, d] this rank's tokens -> (y [t, d], aux, dropped share), both
    this rank's own (not averaged).  With ``group`` (the ``model`` group of
    n ranks, each holding ``E / n`` experts) the [E, cap, d] buffers go
    through the reference's tiled ``all_to_all(send, 0, 1)``, each rank's
    experts answer ``[E / n, n cap, d]`` (by source rank), and the answers
    come back by the inverse ``(1, 0)``; with None every expert is local."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = 1 if group is None else dist.group_size(group)
    e_loc = params["w_gate"].shape[0]
    if e_loc * n != e:
        raise ValueError(f"{e_loc} experts a rank x {n} ranks != "
                         f"{e} experts")
    if n > 1 and torch.is_grad_enabled() and (
            x.requires_grad or any(v.requires_grad for v in params.values())):
        raise NotImplementedError(EP_AUTOGRAD)
    EP_PATHS["local" if group is None else "expert_parallel"] += 1
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
    if group is not None:
        # [E, cap, d] -> [E_loc, n cap, d], source rank by source rank
        send = dist.all_to_all(send.view(n, e_loc, cap, d), group) \
            .transpose(0, 1).reshape(e_loc, n * cap, d)

    # the experts, then the answers back and mixed
    h = torch.bmm(send, params["w_gate"])
    u = torch.bmm(send, params["w_up"])
    del send
    y = torch.bmm(F.silu(h) * u, params["w_down"])
    del h, u
    if group is not None:
        # [E_loc, n cap, d] -> [E, cap, d]: each source's slots back to it
        y = dist.all_to_all(y.view(e_loc, n, cap, d).transpose(0, 1),
                            group).reshape(e, cap, d)
    per_slot, = dist.gather_from_buffers(r, [y])
    del y
    per_slot = torch.where(r.kept[:, None], per_slot, 0)
    w = topv.reshape(-1)[:, None].to(per_slot.dtype)
    out = (per_slot * w).view(t, k, d).sum(dim=1)
    if cfg.n_shared:
        s = cm.sub(params, "shared")
        out = out + _swiglu(x, s["w_gate"], s["w_up"], s["w_down"])
    return out, aux, dropped


def moe_apply(params: dict, cfg: MoEConfig, x: torch.Tensor, mesh=None,
              decode: bool = False, taps: Optional[list] = None):
    """x [B, S, d] -> (y [B, S, d], aux loss, dropped share).  With no
    ``mesh`` (or one of no process group) every token of ``x`` runs here
    through every expert (the reference's body with ``model`` of 1).  At a mesh
    (module docstring) ``x`` is this rank's batch rows in prefill, the
    whole batch in decode; the experts are this rank's share.  ``taps``,
    where given, gets the body's ``(tokens [t, d], output [t, d], dropped
    share)`` of this rank."""
    _, s_len, d = x.shape
    if mesh is None or mesh.group is None:
        y, aux, dropped = _moe_body(params, x.reshape(-1, d), cfg)
        if taps is not None:
            taps.append((x.reshape(-1, d), y, dropped))
        return y.view(x.shape), aux, dropped
    n = mesh.size("model")
    group = mesh.model_group if n > 1 else None
    sp = not decode and n > 1 and s_len % n == 0
    part = x
    if sp:
        s_loc = s_len // n
        part = x[:, mesh.model_index * s_loc:(mesh.model_index + 1) * s_loc]
    t_in = part.reshape(-1, d)
    y, aux, dropped = _moe_body(params, t_in, cfg, group)
    if taps is not None:
        taps.append((t_in, y, dropped))
    y = y.view(part.shape)
    if sp:
        y = dist.all_gather(y, mesh.model_group, dim=1)
    both = dist.all_reduce_sum(torch.stack([aux, dropped]), mesh.group) \
        / dist.group_size(mesh.group)
    return y, both[0], both[1]
