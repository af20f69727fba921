"""The port's dry-run: every (arch x cell) of the registry at published
width, run once on the ``meta`` device at one card, counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--variant accum2] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

The JAX package's dry-run lowers and compiles each cell for 512
placeholder TPU devices and reads XLA's cost and memory analyses and the
post-SPMD HLO.  The port has no HLO: ``run_cell`` builds the cell at the
local mesh (``launch/mesh.make_local_mesh``) and runs its ``fn`` once on
meta tensors of its arguments' shapes (tensors with shapes and dtypes and
no data, so a 671B-parameter step takes no memory) under ``Counter``, a
``TorchDispatchMode``, and a dry ``roofline.analysis.Tally``:

* FLOPs by dtype: each matrix product's (mm, addmm, bmm, baddbmm,
  convolution), by ``torch.utils.flop_counter``'s formulas and the dtype
  of its inputs, plus the hand-written kernels' own counts, which their
  wrappers report on meta (``note_kernel``) where they launch nothing.
  This is not XLA's convention, which counts every HLO op: element-wise
  work and reductions are not counted here (``flops_convention``).
* ``bytes accessed``: the inputs and outputs of each dispatched op that is
  not a view and writes something (a gather's source counted by the rows
  it reads, an indexed write by the rows it writes), plus the kernels'
  bytes, by the formulas behind their bounds (every entry of a bag, every
  term of a CSR read: there are no ids to count distinct rows by).
* memory: live bytes by storage, each storage counted when an op first
  makes it and released by a finalizer when it dies (no tensor is
  copied); ``argument_size_in_bytes`` the arguments', ``peak_size_in_bytes``
  the most alive at once, ``temp_size_in_bytes`` the peak less the
  arguments, ``output_size_in_bytes`` the outputs' storages,
  ``alias_size_in_bytes`` those of them that are arguments (an in-place
  train step returns its parameters and state).
* collectives: ``core/distributed``'s calls, counted and not run.

The record keeps the reference's schema (``ok``, ``n_devices``, ``meta``,
``memory``, ``cost`` with ``flops``, ``flops_<dtype>`` and ``bytes
accessed``, ``collectives``, ``wall_s``) and adds ``flops_convention`` and
``fits_hbm`` (the peak within the card's 80 GB).  ``layer_fit`` is the
reference's ``_fit_layers`` kept as a check: the reference fits an LM's
totals from two unrolled depths because XLA counts a scan body once; the
meta pass counts every layer, so the totals fitted from ``base`` and
``base + 1`` layers must equal the full count (a mismatch fails the cell),
and ``roofline/report.effective_record`` reads it unchanged.

``--multi-pod`` and ``--both-meshes`` refuse: the production mesh needs
the dense weights' FSDP / tensor-parallel placement and the bundles'
shardings, which wait for ROADMAP queue 1, item 15.4.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import ShapeDtype
from repro_torch.roofline import analysis

FLOPS_CONVENTION = ("matrix products (FlopCounterMode) + hand-written "
                    "kernels")
DEFAULT_OUT = os.path.join("artifacts", "dryrun_torch")
aten = torch.ops.aten
# ops that make or rename a tensor without moving its bytes
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.detach,
             aten.alias, aten.lift_fresh}
# ops that read a source by the rows they return
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# ops that write into their first argument at indexed rows
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_add_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class Counter(TorchDispatchMode):
    """Counts what the ops run under it do (module docstring): ``flops``
    {dtype: FLOPs}, ``bytes``, and live, peak, argument and output bytes
    by storage."""

    def __init__(self):
        super().__init__()
        self.flops: dict = {}
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.storages: dict = {}          # storage id -> bytes, while alive
        self.args: set = set()

    # -- storages ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.storages:
            return
        n = s.nbytes()
        self.storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._release, key)

    def _release(self, key) -> None:
        self.live -= self.storages.pop(key, 0)

    def arguments(self, tree) -> int:
        """Registers the argument tensors as alive (the caller holds them)
        -> their bytes."""
        for t in _tensors(tree):
            self._track(t)
            self.args.add(t.untyped_storage()._cdata)
        return self.live

    def outputs(self, tree) -> tuple[int, int]:
        """-> (bytes of the outputs' storages, of those that are
        arguments)."""
        seen, out, alias = set(), 0, 0
        for t in _tensors(tree):
            s = t.untyped_storage()
            if s._cdata in seen:
                continue
            seen.add(s._cdata)
            out += s.nbytes()
            alias += s.nbytes() if s._cdata in self.args else 0
        return out, alias

    # -- ops --------------------------------------------------------------
    def _op_bytes(self, packet, func, args, out_tensors) -> int:
        if packet in _NO_BYTES or func.is_view:
            return 0
        ins = list({id(t): t for t in _tensors(args)}.values())
        if packet in _GATHERS:      # the rows read, the indices, the rows
            got = sum(_nbytes(t) for t in out_tensors)
            return 2 * got + sum(_nbytes(t) for t in ins[1:])
        if packet in _SCATTERS:     # indices and values read, the rows
            rest = [_nbytes(t) for t in ins[1:]]    # read and written
            return sum(rest) + 2 * max(rest, default=0)
        return sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in out_tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite op (``matmul`` under inference mode) is counted
            # by the ops it decomposes into, as outside inference mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            ins = _tensors(args)
            dtype = str(ins[0].dtype).removeprefix("torch.") if ins \
                else "float32"
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[dtype] = self.flops.get(dtype, 0) + int(n)
        out_tensors = _tensors(out)
        self.bytes += self._op_bytes(packet, func, (args, kwargs),
                                     out_tensors)
        for t in out_tensors:
            self._track(t)
        return out


def meta_args(tree):
    """A tree of ``ShapeDtype`` -> the same tree of meta tensors."""
    if isinstance(tree, ShapeDtype):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_args(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_args(v) for v in tree)
    return tree


def measure(bundle) -> dict:
    """One run of ``bundle.fn`` on meta tensors, counted -> the record's
    ``memory``, ``cost``, ``collectives`` and ``fits_hbm``."""
    args = meta_args(bundle.args)
    with analysis.Tally(dry=True) as tally, Counter() as c:
        arg_bytes = c.arguments(args)
        out = bundle.fn(*args)
        out_bytes, alias = c.outputs(out)
    del out
    flops = dict(c.flops)
    for dtype, n in tally.kernel_flops().items():
        flops[dtype] = flops.get(dtype, 0) + n
    cost = {"flops": sum(flops.values()),
            **{f"flops_{k}": v for k, v in sorted(flops.items())},
            "bytes accessed": c.bytes + tally.kernel_bytes()}
    memory = analysis.memory_dict({
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": c.peak - arg_bytes,
        "alias_size_in_bytes": alias,
        "peak_size_in_bytes": c.peak})
    return {"memory": memory, "cost": cost,
            "collectives": analysis.collective_bytes(tally),
            "kernels": tally.kernels,
            "fits_hbm": c.peak <= analysis.HBM_BYTES}


def _fit_layers(arch_id: str, shape: str, mesh, record: dict,
                variant: str = "baseline"):
    """The reference's layer fit, as a check (module docstring): the
    cell at ``base`` and ``base + 1`` layers (the dense prefix of a mixed
    model held at its depth), its FLOPs, bytes and collective bytes
    extrapolated linearly to the published depth -> ``layer_fit``, with
    ``matches_count`` whether they equal the full count."""
    if registry.family(arch_id) != "lm":
        return None
    cfg = cells_mod.configs_of(arch_id).CONFIG
    n_dense = cfg.n_layers - cfg.n_moe_layers
    base = n_dense + 1 if (cfg.moe is not None and n_dense) else 1
    cell = registry.cell_by_name(shape, "lm")
    points = {}
    for ln in (base, base + 1):
        small = dataclasses.replace(cfg, n_layers=ln)
        points[ln] = measure(cells_mod._lm_cell(arch_id, small, cell, mesh,
                                                variant))
    lo, hi = points[base], points[base + 1]
    n_extra = cfg.n_layers - base
    fitted = {}
    for key in ("flops", "bytes accessed"):
        per = hi["cost"][key] - lo["cost"][key]
        fitted[key] = lo["cost"][key] + per * n_extra
        fitted[key + "_per_layer"] = per
    per = hi["collectives"]["total"] - lo["collectives"]["total"]
    fitted["collective_total"] = lo["collectives"]["total"] + per * n_extra
    fitted["collective_per_layer"] = per
    fitted["fit_base_layers"] = base
    fitted["mtp_excluded"] = False
    fitted["matches_count"] = (
        fitted["flops"] == record["cost"]["flops"]
        and fitted["bytes accessed"] == record["cost"]["bytes accessed"]
        and fitted["collective_total"] == record["collectives"]["total"])
    return fitted


def record_path(out_dir: str, arch_id: str, shape: str,
                variant: str = "baseline") -> str:
    tag = f"{arch_id}__{shape}__local"
    if variant != "baseline":
        tag += f"__{variant}"
    return os.path.join(out_dir, tag + ".json")


def run_cell(arch_id: str, shape: str, out_dir: str = DEFAULT_OUT,
             variant: str = "baseline", force: bool = False,
             fit_layers: bool = True, mesh=None, smoke: bool = False,
             write: bool = True) -> dict:
    """The cell's record (module docstring), written to ``out_dir`` (read
    from there instead when it is there and not ``force``)."""
    path = record_path(out_dir, arch_id, shape, variant)
    if write and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    mesh = mesh or mesh_mod.make_local_mesh()
    if not mesh.local:
        raise SystemExit(mesh_mod.ITEM_15_4)
    record = {"arch": arch_id, "shape": shape, "mesh": "local",
              "variant": variant, "smoke": smoke, "ok": False,
              "flops_convention": FLOPS_CONVENTION}
    t0 = time.time()
    try:
        bundle = cells_mod.build_cell(arch_id, shape, mesh, smoke=smoke,
                                      variant=variant)
        record.update(ok=True, n_devices=1, meta=bundle.meta,
                      **measure(bundle))
        if fit_layers and not smoke:
            record["layer_fit"] = _fit_layers(arch_id, shape, mesh, record,
                                              variant)
            if record["layer_fit"] and \
                    not record["layer_fit"]["matches_count"]:
                record["ok"] = False
                record["error"] = "the layer fit does not reproduce the " \
                    "full count"
    except Exception as e:           # noqa: BLE001 — record the failure
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["wall_s"] = round(time.time() - t0, 2)
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    status = "OK" if record["ok"] else "FAIL"
    print(f"[{status}] {os.path.basename(path)[:-5]} "
          f"wall={record['wall_s']}s", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the production mesh is item 15.4's")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="refused: the production mesh is item 15.4's")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise SystemExit(mesh_mod.ITEM_15_4)
    if args.all:
        jobs = cells_mod.all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        jobs = [(args.arch, args.shape)]
    failures = 0
    for arch, shape in jobs:
        rec = run_cell(arch, shape, args.out, variant=args.variant,
                       force=args.force)
        failures += 0 if rec["ok"] else 1
    print(f"dry-run: {len(jobs) - failures}/{len(jobs)} cells counted")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
