"""Roofline terms of a cell on one NVIDIA H100 SXM, from the JAX package's
``roofline/analysis.py``, over the port's dry-run records
(``launch/dryrun.py``):

    compute    = sum over dtypes of counted FLOPs / that dtype's peak
    memory     = bytes accessed / 3.35e12 B/s of HBM
    collective = collective bytes / 450e9 B/s (NVLink, each way)

The constants are NVIDIA's data sheet's for one H100 SXM, dense: 989e12
FLOP/s for bf16 and fp16 matrix products on the tensor cores and 67e12
FLOP/s for fp32 (the port leaves TF32 off, so an fp32 product runs at
the CUDA cores' rate); the reference's are a TPU v5e's and are not
carried across.  The dry-run counts FLOPs by the dtype of each product's
inputs (``flops_<dtype>``), which is why the compute term is a sum.

The reference parses post-SPMD HLO for its collective bytes.  The port
has no HLO: a ``Tally`` receives the bytes of each call to
``core/distributed.all_to_all``, ``all_gather``, ``all_reduce_sum`` and
``all_reduce_max`` while it is open (``note_collective``), and
``collective_bytes`` gives them in the reference's dict shape: bytes a
kind (``all-to-all``, ``all-gather``, ``all-reduce``), ``<kind>_ops`` and
``total``.  A dry tally (the dry-run's) also receives
each hand-written kernel's work from its wrapper's meta route
(``note_kernel``), and a collective under it is counted and not run.

``Roofline``, ``from_record``, ``lm_param_counts`` and ``model_flops_for``
keep the reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# one H100 SXM, NVIDIA's data sheet, dense
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way
HBM_BYTES = 80e9             # the card's 80 GB
CARD = "H100 SXM (989e12 bf16 / 67e12 fp32 FLOP/s, 3.35e12 B/s HBM, " \
    "450e9 B/s NVLink)"


# ---------------------------------------------------------------------------
# what the code path reports while a tally is open
# ---------------------------------------------------------------------------
_OPEN: list = []


class Tally:
    """Collects, while open (``with Tally() as t:``), the bytes of every
    collective the code path calls and, when ``dry``, the work each
    hand-written kernel's meta route reports: ``kernels`` {name: {calls,
    flops, bytes, dtype}}, ``collectives`` {kind: bytes, <kind>_ops:
    calls}.  Under a dry tally a collective is counted and not run."""

    def __init__(self, dry: bool = False):
        self.dry = dry
        self.kernels: dict = {}
        self.collectives: dict = {}

    def __enter__(self) -> "Tally":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)

    def kernel_flops(self) -> dict:
        """{dtype: FLOPs} the kernels reported."""
        out: dict = {}
        for k in self.kernels.values():
            out[k["dtype"]] = out.get(k["dtype"], 0) + k["flops"]
        return out

    def kernel_bytes(self) -> int:
        return sum(k["bytes"] for k in self.kernels.values())


def note_kernel(name: str, flops: int, nbytes: int,
                dtype: str = "float32") -> None:
    """A kernel's meta route: its work (``flops`` of ``dtype``, ``nbytes``
    moved, by the formula behind its bound) into every open dry tally."""
    for t in _OPEN:
        if t.dry:
            k = t.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                            "bytes": 0, "dtype": dtype})
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)


def note_collective(kind: str, nbytes: int) -> bool:
    """A collective of ``kind`` moving ``nbytes`` (its result's bytes on
    this rank) into every open tally -> True when one is dry (the caller
    then returns an empty result and does not run it)."""
    dry = False
    for t in _OPEN:
        t.collectives[kind] = t.collectives.get(kind, 0) + int(nbytes)
        t.collectives[kind + "_ops"] = t.collectives.get(kind + "_ops",
                                                         0) + 1
        dry = dry or t.dry
    return dry


def collective_bytes(tally: Tally) -> dict:
    """The tally's collectives in the reference's shape: bytes a kind,
    ``total``, and ``<kind>_ops``."""
    out = {k: v for k, v in tally.collectives.items()
           if not k.endswith("_ops")}
    out["total"] = sum(out.values())
    out.update({k: v for k, v in tally.collectives.items()
                if k.endswith("_ops")})
    return out


def memory_dict(mem: dict) -> dict:
    """The dry-run's memory record, its keys in the reference's names."""
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "peak_size_in_bytes")
    return {k: int(mem[k]) for k in keys if mem.get(k) is not None}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    model_flops: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops and self.flops_global:
            return self.model_flops / self.flops_global
        return None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """(useful work at peak) / (bound time)."""
        if not self.model_flops:
            return None
        ideal = self.compute_s * (self.useful_flops_ratio or 0)
        return ideal / self.bound_time_s if self.bound_time_s else None


def compute_s(cost: dict) -> float:
    """Each dtype's counted FLOPs (``flops_<dtype>``) over its peak; a
    dtype without a peak here is taken at fp32's."""
    return sum(v / PEAK_FLOPS.get(k[len("flops_"):], PEAK_FLOPS["float32"])
               for k, v in cost.items() if k.startswith("flops_"))


def from_record(rec: dict, model_flops: Optional[float] = None) -> Roofline:
    """rec: one dry-run record; its counts are one device's."""
    n = rec["n_devices"]
    flops_dev = rec["cost"].get("flops", 0.0)
    bytes_dev = rec["cost"].get("bytes accessed", 0.0)
    coll_dev = rec.get("collectives", {}).get("total", 0.0)
    return Roofline(
        compute_s=compute_s(rec["cost"]),
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_dev / NVLINK_BW,
        flops_global=flops_dev * n,
        bytes_global=bytes_dev * n,
        coll_bytes_global=coll_dev * n,
        model_flops=model_flops,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); serving analogues.
# ---------------------------------------------------------------------------
def lm_param_counts(cfg) -> dict:
    """Analytic parameter counts for an LMConfig."""
    d = cfg.d_model
    if cfg.attn_type == "mla":
        m = cfg.mla_cfg()
        attn = (d * m.q_lora + m.q_lora * cfg.n_heads *
                (m.dh_nope + m.dh_rope) + d * m.kv_lora
                + m.kv_lora * cfg.n_heads * (m.dh_nope + m.dv)
                + d * m.dh_rope + cfg.n_heads * m.dv * d)
    else:
        attn = d * cfg.n_heads * cfg.head_dim \
            + 2 * d * cfg.n_kv_heads * cfg.head_dim \
            + cfg.n_heads * cfg.head_dim * d
    if cfg.ffn_type == "swiglu":
        ffn_dense = 3 * d * cfg.d_ff
    else:
        ffn_dense = 2 * d * cfg.d_ff
    n_dense = cfg.n_layers - cfg.n_moe_layers
    total = cfg.vocab * d * 2                      # embed + unembed
    active = cfg.vocab * d * 2
    total += cfg.n_layers * attn
    active += cfg.n_layers * attn
    total += n_dense * ffn_dense
    active += n_dense * ffn_dense
    if cfg.moe is not None:
        mc = cfg.moe
        per_expert = 3 * d * mc.d_ff
        shared = 3 * d * mc.shared_ff if mc.n_shared else 0
        total += cfg.n_moe_layers * (mc.n_experts * per_expert + shared
                                     + d * mc.n_experts)
        active += cfg.n_moe_layers * (mc.top_k * per_expert + shared
                                      + d * mc.n_experts)
    return {"total": total, "active": active}


def model_flops_for(family: str, cfg, cell, mode_meta: dict) -> float:
    """Useful-work FLOPs for the cell (forward+backward for train: 6·N·D;
    forward only for serving: 2·N·D; + attention O(S²)/O(S·KV) terms)."""
    if family == "lm":
        counts = lm_param_counts(cfg)
        n_active = counts["active"]
        b = cell.dims["batch"]
        s = cell.dims["seq"]
        if cell.kind == "train":
            flops = 6.0 * n_active * b * s
            # causal attention score+value FLOPs (fwd 2·2·(S²/2)·d·H, ×3 bwd)
            attn_dim = cfg.n_heads * cfg.head_dim if cfg.attn_type == "gqa" \
                else cfg.n_heads * (cfg.mla_cfg().dh_nope
                                    + cfg.mla_cfg().dh_rope)
            flops += 6.0 * cfg.n_layers * b * s * s * attn_dim
            return flops
        if cell.kind == "prefill":
            attn_dim = cfg.n_heads * cfg.head_dim if cfg.attn_type == "gqa" \
                else cfg.n_heads * (cfg.mla_cfg().dh_nope
                                    + cfg.mla_cfg().dh_rope)
            return 2.0 * n_active * b * s + 2.0 * cfg.n_layers * b * s * s \
                * attn_dim
        # decode: one token against a KV cache of length s
        attn_dim = cfg.n_heads * cfg.head_dim if cfg.attn_type == "gqa" \
            else cfg.n_heads * cfg.mla_cfg().kv_lora  # absorbed form
        return 2.0 * n_active * b + 4.0 * cfg.n_layers * b * s * attn_dim
    if family == "gnn":
        d = cell.dims
        h = cfg.d_hidden
        if cell.kind == "gnn_full":
            f = d["d_feat"]
            per_layer = 2.0 * d["n_nodes"] * (f * h + h * h) \
                + 2.0 * d["n_edges"] * f
            return 6.0 * per_layer                        # fwd+bwd approx ×3
        if cell.kind == "gnn_minibatch":
            b = d["batch_nodes"]
            f1, f2 = d["fanouts"]
            f = d["d_feat"]
            gathers = b * (1 + f1 + f1 * f2)
            return 6.0 * gathers * 2 * f * h
        b = d["n_graphs"]
        return 6.0 * b * d["n_nodes"] * 2 * d["d_feat"] * h
    # recsys: embedding gather bytes dominate; dense FLOPs = MLPs
    b = cell.dims.get("batch", 1)
    if cell.kind == "rec_retrieval":
        b = cell.dims["n_candidates"]
    dims = (getattr(cfg, "mlp", ()) or ()) + (getattr(cfg, "tower_mlp", ())
                                              or ())
    mlp_flops = 0.0
    prev = None
    for w in dims:
        if prev:
            mlp_flops += 2.0 * prev * w
        prev = w
    mlp_flops = max(mlp_flops, 2.0 * 64 * 64)
    factor = 6.0 if cell.kind == "rec_train" else 2.0
    return factor * b * mlp_flops * 4     # ×4: embeds+interactions, coarse
