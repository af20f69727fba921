"""What the port's models share: the JAX package's initializers
(``models/common.py``), on an explicit ``torch.Generator`` and device, its
``layer_norm`` and its two losses, ``softmax_xent`` and
``bce_with_logits``.

The JAX package boxes every parameter with a ``PartitionSpec`` and shards it
over a mesh (``Boxed``, ``MeshInfo``).  The port has neither: a parameter
is a plain tensor, and the one sharded layout it serves, two-tower's user
and item tables in row blocks over a ``torch.distributed`` group, is cut
by ``core/convert.two_tower_row_blocks`` and looked up by
``models/embedding_service.py``'s ``embed_lookup_a2a`` and
``embed_bag_psum`` (``core/distributed.py``'s routing).  The two packages
draw different numbers from the same seed, so parity tests carry the JAX
parameters over (``core/convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def normal_init(shape, scale: float, *, generator: torch.Generator,
                device, dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal cut at +-2, drawn on ``device``
    from ``generator`` (which lives there too)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense_param(in_dim: int, out_dim: int, *, generator: torch.Generator,
                device, dtype=torch.float32) -> torch.Tensor:
    """A [in_dim, out_dim] weight, scaled by 1/sqrt(in_dim)."""
    return normal_init((in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                       generator=generator, device=device, dtype=dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's ``layer_norm`` over the last axis: in fp32, the
    variance as the mean of the squared deviation, ``rsqrt(var + eps)``,
    then ``gamma`` and ``beta``, and a cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``softmax_xent``: the mean (or, with ``mask``, the
    masked mean) negative log-likelihood of ``labels`` [*] under ``logits``
    [*, V], in fp32.  The max is held constant under differentiation, and
    the gold logit is taken by a compare-and-select over the last axis, as
    there."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits, 0.0).sum(dim=-1)
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``bce_with_logits``: the mean of ``max(l, 0) - l·y
    + log1p(exp(-|l|))`` in fp32.  At ``l == 0`` the gradient is JAX's:
    ``torch.maximum`` splits it evenly, as ``jnp.maximum`` does, and ``|l|``
    is a select whose slope there is 1, as ``jnp.abs``'s is (``abs``'s is
    0)."""
    logits, labels = logits.float(), labels.float()
    magnitude = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels
            + torch.log1p(torch.exp(-magnitude))).mean()
