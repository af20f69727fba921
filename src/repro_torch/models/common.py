"""What the port's models share: the JAX package's initializers
(``models/common.py``), on an explicit ``torch.Generator`` and device, its
``layer_norm``, ``rms_norm``, ``squared_relu``, the rotary embedding
(``rope_angles``, ``apply_rope``) and its two losses, ``softmax_xent`` and
``bce_with_logits``.  ``ParamSpec`` and ``draw_params`` build a path-keyed
parameter dict from its shapes (the LM's, ``models/lm.py``), and
``ShapeDtype`` stands where the JAX package passes a
``jax.ShapeDtypeStruct`` (``launch/materialize.py``).

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

import dataclasses
import math
from typing import NamedTuple, Optional

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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's ``rms_norm`` over the last axis: in fp32, ``x *
    rsqrt(mean(x^2) + eps) * gamma``, and a cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def rope_angles(positions: torch.Tensor, dim: int,
                base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, S] int -> (cos, sin) [*, S, dim/2] fp32, the JAX
    package's angles: ``position * base ** (-2i / dim)``.  The inverse
    frequencies are fp32's ``1 / base ** (2i / dim)``; at ``base`` 1e4 they
    are the JAX package's bit for bit, at 1e6 one may lie an ulp away, which
    moves an angle by at most ``position`` times that ulp
    (``tests/test_torch_lm.py`` holds that bound up to position 524,287)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(base, exps)     # a host scalar: no copy to the card
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n_head, dim]; cos / sin broadcastable [..., S, 1, dim/2].
    Rotate-half, as the JAX package's ``apply_rope``: the two halves of the
    last axis (not interleaved pairs), in fp32, then ``x``'s dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype, without its data (the JAX package's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape, the scale of its truncated normal (``None``
    for a norm's gain, all ones) and its dtype (``None``: the model's)."""
    shape: tuple
    scale: Optional[float]
    dtype: Optional[torch.dtype] = None

    def stacked(self, n: int) -> "ParamSpec":
        return dataclasses.replace(self, shape=(n,) + tuple(self.shape))


# the fp32 draws of one parameter are made this many elements at a time, so
# that drawing a [256, 7168, 2048] expert stack needs no fp32 copy of it
DRAW_CHUNK = 1 << 26


def draw_params(specs: dict, *, generator: torch.Generator, device,
                dtype: torch.dtype, keep: Optional[dict] = None) -> dict:
    """``{path: ParamSpec}`` -> ``{path: tensor}`` on ``device``, in
    ``specs``' order: each tensor allocated once in its dtype and filled in
    place, ``DRAW_CHUNK`` elements of fp32 draws at a time (whole rows of
    its last axis).  ``keep`` ``{path: (dim, start, stop)}`` keeps only
    ``[start, stop)`` of that leaf's axis ``dim`` (not its last): every
    row is still drawn, so the kept part holds the whole leaf's values and
    every later leaf the same draws (a rank's share of the experts)."""
    out = {}
    for path, spec in specs.items():
        cut = (keep or {}).get(path)
        shape = list(spec.shape)
        if cut:
            shape[cut[0]] = cut[2] - cut[1]
        t = torch.empty(shape, dtype=spec.dtype or dtype, device=device)
        if spec.scale is None:
            t.fill_(1)
        else:
            last = spec.shape[-1]
            rows = t.view(-1, last)
            n_rows = math.prod(spec.shape[:-1])
            ranges = _kept_rows(spec.shape, cut) if cut \
                else [(0, n_rows, 0)]
            step = max(1, DRAW_CHUNK // last)
            for i in range(0, n_rows, step):
                part = normal_init((min(step, n_rows - i), last), spec.scale,
                                   generator=generator, device=device)
                for lo, hi, at in ranges:
                    a, b = max(lo, i), min(hi, i + part.shape[0])
                    if a < b:
                        rows[at + a - lo:at + b - lo].copy_(
                            part[a - i:b - i])
        out[path] = t
    return out


def _kept_rows(shape: tuple, cut: tuple) -> list:
    """The rows (of the last axis) of a leaf of ``shape`` that ``cut``
    ``(dim, start, stop)`` keeps, as ``(first, end, at)`` runs: rows
    ``[first, end)`` of the whole leaf land at row ``at`` of the kept
    one."""
    dim, start, stop = cut
    if not 0 <= dim < len(shape) - 1:
        raise ValueError(f"a cut keeps part of an axis before the last, "
                         f"not axis {dim} of {tuple(shape)}")
    inner = math.prod(shape[dim + 1:-1])
    n = shape[dim]
    return [((o * n + start) * inner, (o * n + stop) * inner,
             o * (stop - start) * inner)
            for o in range(math.prod(shape[:dim]))]


def sub(params: dict, prefix: str) -> dict:
    """The entries of a path-keyed dict under ``prefix/``, the prefix
    dropped (``sub(p, "attn")["wq"]`` is ``p["attn/wq"]``)."""
    head = prefix + "/"
    return {k[len(head):]: v for k, v in params.items()
            if k.startswith(head)}
