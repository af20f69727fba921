"""What the port's models share: the JAX package's initializers
(``models/common.py``), on an explicit ``torch.Generator`` and device, and
its ``layer_norm``.

The JAX package boxes every parameter with a ``PartitionSpec`` and shards it
over a mesh (``Boxed``, ``MeshInfo``).  The port runs on one card and has
neither: a parameter is a plain tensor.  Sharding is ROADMAP queue 1,
item 13.  The two packages draw different numbers from the same seed, so
parity tests carry the JAX parameters over (``core/convert.py``).
"""
from __future__ import annotations

import math

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
