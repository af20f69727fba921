"""Render the dry-run and roofline tables from the port's dry-run records
(``launch/dryrun.py``), as the JAX package's ``roofline/report.py`` does
from its own, with one H100 SXM's constants.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir artifacts/dryrun_torch] [--variant baseline] \\
        [--card "NVIDIA H100 80GB HBM3, 700.00 W"] [--compare-baseline DIR]

Prints markdown.  ``--card`` names the machine the records were counted
on (the dry-run needs no card; the bounds are the H100's).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

from repro_torch.configs import registry
from repro_torch.launch import cells as cells_mod
from repro_torch.roofline import analysis


def effective_record(rec: dict) -> dict:
    """Substitute layer-fitted totals when present (the port's fit equals
    its count: ``launch/dryrun.py``)."""
    out = dict(rec)
    lf = rec.get("layer_fit")
    if lf:
        cost = dict(rec["cost"])
        cost["flops"] = lf["flops"]
        cost["bytes accessed"] = lf["bytes accessed"]
        out["cost"] = cost
        coll = dict(rec.get("collectives", {}))
        coll["total"] = lf["collective_total"]
        out["collectives"] = coll
    return out


def load_records(d: str, mesh: str = "local", variant: str = "baseline"
                 ) -> dict:
    recs = {}
    for p in glob.glob(os.path.join(d, f"*__{mesh}*.json")):
        with open(p) as f:
            r = json.load(f)
        if r.get("variant", "baseline") != variant:
            continue
        recs[(r["arch"], r["shape"])] = r
    return recs


def cell_and_config(rec: dict):
    """(family, config, cell) the record was counted at."""
    family = registry.family(rec["arch"])
    cell = registry.cell_by_name(rec["shape"], family)
    configs = cells_mod.configs_of(rec["arch"])
    if rec.get("smoke"):
        return family, configs.SMOKE, registry.reduce_cell(cell)
    return family, configs.CONFIG, cell


def roofline_for(rec: dict) -> analysis.Roofline:
    family, cfg, cell = cell_and_config(rec)
    mf = analysis.model_flops_for(family, cfg, cell, rec["meta"])
    return analysis.from_record(effective_record(rec), model_flops=mf)


def note_for(rec: dict, r) -> str:
    if r.dominant == "collective":
        return "cut cross-shard traffic (resharding/overlap)"
    if r.dominant == "memory":
        return "raise arithmetic intensity (fuse/requantize/cache)"
    if (r.useful_flops_ratio or 1) < 0.5:
        return "compute-bound but wasteful: remove remat/dispatch overhead"
    return "compute-bound: kernel efficiency / larger per-card batch"


def compare(base_dir: str, opt_dir: str):
    """Baseline-vs-optimized bound-time table."""
    base = load_records(base_dir)
    new = load_records(opt_dir)
    print("\n### Baseline vs optimized (bound time per step, one H100)\n")
    print("| arch | shape | baseline bound s (term) | optimized bound s "
          "(term) | speedup |")
    print("|---|---|---|---|---|")
    gains = []
    for key in sorted(base):
        if key not in new or not base[key]["ok"] or not new[key]["ok"]:
            continue
        rb = roofline_for(base[key])
        rn = roofline_for(new[key])
        sp = rb.bound_time_s / max(rn.bound_time_s, 1e-12)
        gains.append(sp)
        print(f"| {key[0]} | {key[1]} | {rb.bound_time_s:.4g} "
              f"({rb.dominant}) | {rn.bound_time_s:.4g} ({rn.dominant}) | "
              f"×{sp:.2f} |")
    if gains:
        geo = math.exp(sum(math.log(g) for g in gains) / len(gains))
        print(f"\nGeomean speedup across {len(gains)} cells: ×{geo:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join("artifacts",
                                                  "dryrun_torch"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--card", default=None,
                    help="the machine the records were counted on")
    ap.add_argument("--compare-baseline", default=None,
                    help="baseline records dir for the comparison table")
    args = ap.parse_args(argv)
    if args.compare_baseline:
        compare(args.compare_baseline, args.dir)
        return
    recs = load_records(args.dir, variant=args.variant)
    where = f", counted on the host of {args.card}" if args.card else ""

    print(f"### Dry-run — each cell once on the meta device at one card "
          f"(local mesh){where}\n")
    print("FLOPs are matrix products (FlopCounterMode) and the hand-written "
          "kernels' own counts, not XLA's every-op count.\n")
    print("| arch | shape | ok | FLOPs bf16 | FLOPs fp32 | bytes accessed | "
          "args GB | peak GB | fits 80 GB | wall s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape), r in sorted(recs.items()):
        if not r["ok"]:
            print(f"| {arch} | {shape} | FAIL | | | | | | | "
                  f"{r.get('wall_s', 0)} |")
            continue
        c, m = r["cost"], r["memory"]
        print(f"| {arch} | {shape} | OK | {c.get('flops_bfloat16', 0):.4g} "
              f"| {c.get('flops_float32', 0):.4g} | "
              f"{c['bytes accessed']:.4g} | "
              f"{m['argument_size_in_bytes'] / 1e9:.2f} | "
              f"{m['peak_size_in_bytes'] / 1e9:.2f} | "
              f"{'yes' if r['fits_hbm'] else 'no'} | {r['wall_s']} |")

    print(f"\n### Roofline — per (arch × shape), one {analysis.CARD}\n")
    print("| arch | shape | compute s | memory s | collective s | dominant "
          "| MODEL/counted flops | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    rows = []
    for (arch, shape), rec in sorted(recs.items()):
        if not rec["ok"]:
            continue
        r = roofline_for(rec)
        ratio = r.useful_flops_ratio
        frac = r.roofline_fraction
        rows.append(((arch, shape), r))
        tail = f"{ratio:.3g} | {frac:.3f} |" if ratio is not None \
            and frac is not None else "n/a | n/a |"
        print(f"| {arch} | {shape} | {r.compute_s:.4g} | {r.memory_s:.4g} | "
              f"{r.collective_s:.4g} | **{r.dominant}** | {tail}")

    print("\n#### Bottleneck notes (what would move the dominant term)\n")
    for (arch, shape), r in rows:
        print(f"- **{arch} × {shape}** ({r.dominant}-bound, "
              f"frac={r.roofline_fraction or 0:.3f}): {note_for(None, r)}")
    if not rows:
        return
    scored = sorted((r.roofline_fraction or 0, k, r) for k, r in rows)
    coll = sorted(((r.collective_s / max(r.bound_time_s, 1e-12), k, r)
                   for k, r in rows), reverse=True)
    print("\n#### Hillclimb candidates")
    print(f"- worst roofline fraction: {scored[0][1]} "
          f"(frac={scored[0][0]:.4f})")
    print(f"- most collective-bound: {coll[0][1]} "
          f"(coll share={coll[0][0]:.2f})")


if __name__ == "__main__":
    main()
