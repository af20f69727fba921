"""Training launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch din|bst|two-tower-retrieval|deepfm [--shape train_batch] \
        [--smoke] [--steps 50] [--ckpt-dir DIR] [--ckpt-every 25] \
        [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch graphsage-reddit \
        [--shape minibatch_lg|full_graph_sm|ogb_products|molecule] ...

The counterpart of the JAX package's ``launch/train.py``: builds the arch's
model at its published width (``CONFIG``; ``--smoke`` takes ``SMOKE`` and
the cell at ``registry.reduce_cell``'s size) from seed 0 and trains it
through the dense step the JAX cell builder makes.

* A recsys arch: the port's ``recsys_init``, ``synthetic.recsys_batch``
  batches of the train cell (``train_batch``: 65,536 rows),
  ``make_train_step(recsys_loss_fn(cfg), OptConfig())``.
* ``graphsage-reddit``: ``gnn.sage_init`` at the cell's features and
  classes, ``make_train_step(gnn_loss_fn(cfg, regime), OptConfig())``
  (Adam), on the JAX launcher's batches (``gnn_arrays``), each step's
  drawn anew as there: a fresh ``synthetic.random_graph`` of the cell's
  size for a full-graph cell (its CSRs built on the device), a fresh
  graph, its host CSR and one ``graph_sampler.sample_block`` of the
  cell's seeds and fanouts for ``minibatch_lg`` (the default), a
  ``synthetic.molecule_batch`` for ``molecule``.  At ``minibatch_lg``
  that is a graph of 114.6M edges on the host every step.

It prints ``step N loss=... (s/step)`` after the first step and every
tenth, then ``done``.  With ``--ckpt-dir`` it resumes from a checkpoint
there and saves one every ``--ckpt-every`` steps (async).

An LM arch exits: the port serves the LM archs
(``python -m repro_torch.launch.serve``) but does not train them yet.

It runs on ``--device`` (default ``cuda``; there is no fallback to the
CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.data import graph_sampler, synthetic
from repro_torch.kernels import ops
from repro_torch.models import gnn
from repro_torch.models import recsys as rec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def train_batch(rng: np.random.Generator, cfg, rows: int, device) -> dict:
    """One synthetic batch of ``rows`` as tensors on ``device`` (two-tower's
    without its label, as the JAX launcher drops it)."""
    b = synthetic.recsys_batch(rng, cfg, rows)
    if cfg.arch == "two_tower":
        b.pop("label", None)
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def gnn_arrays(rng: np.random.Generator, cell) -> dict:
    """One batch of a GNN cell as host arrays, as the JAX launcher's
    ``_real_batch`` draws it: the whole graph (``gnn_full``), a block
    sampled from a fresh graph (``gnn_minibatch``) or a molecule batch."""
    d = cell.dims
    if cell.kind == "gnn_full":
        return synthetic.random_graph(rng, d["n_nodes"], d["n_edges"],
                                      d["d_feat"], d["n_classes"])
    if cell.kind == "gnn_minibatch":
        g = synthetic.random_graph(rng, d["n_nodes"] if "n_nodes" in d
                                   else 1000, d.get("n_edges", 5000),
                                   d["d_feat"], d["n_classes"])
        csr = graph_sampler.CSRGraph(g["feats"].shape[0], g["edges"])
        seeds = rng.integers(0, g["feats"].shape[0], d["batch_nodes"])
        return graph_sampler.sample_block(rng, csr, g["feats"], g["labels"],
                                          seeds, tuple(d["fanouts"]))
    return synthetic.molecule_batch(rng, d["n_graphs"], d["n_nodes"],
                                    d["n_edges"], d["d_feat"],
                                    d["n_classes"])


def gnn_setup(arch: str, shape: str, smoke: bool, device):
    """(cell, cfg, params, train step) of ``arch``'s GNN cell ``shape``:
    the cell (reduced with ``smoke``), the config at its dims, parameters
    from seed 0 on ``device`` and the dense step with ``OptConfig()``."""
    cell = registry.cell_by_name(shape, "gnn")
    if smoke:
        cell = registry.reduce_cell(cell)
    configs = registry.GNN_ARCHS[arch]
    cfg = gnn.cell_config(configs.SMOKE if smoke else configs.CONFIG, cell)
    params = gnn.sage_init(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    fn = ts.make_train_step(ts.gnn_loss_fn(cfg, gnn.REGIMES[cell.kind]),
                            opt.OptConfig())
    return cell, cfg, params, fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    choices=[c.name for c in registry.REC_CELLS
                             + registry.GNN_CELLS],
                    help="train_batch for a recsys arch, minibatch_lg for "
                         "graphsage-reddit")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        family = registry.family(args.arch)
    except KeyError:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch)) from None
    if family == "lm":
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch))
    shape = args.shape or {"recsys": "train_batch",
                           "gnn": "minibatch_lg"}[family]
    if shape not in [c.name for c in registry.CELLS[family]]:
        ap.error(f"{shape} is not a cell of {args.arch}")
    cell = registry.cell_by_name(shape, family)
    if family == "recsys" and cell.kind != "rec_train":
        ap.error(f"{shape} is not a train cell; serve it with "
                 "python -m repro_torch.launch.serve")
    if args.steps < 1 or args.ckpt_every < 1:
        ap.error("--steps and --ckpt-every must be at least 1")
    device = ops.resolve_device(args.device)
    ocfg = opt.OptConfig()
    if family == "gnn":
        cell, cfg, params, fn = gnn_setup(args.arch, shape, args.smoke,
                                          device)

        def draw(rng):
            return gnn.gnn_batch(gnn_arrays(rng, cell), cell.kind, device)
        d = cell.dims              # seeds, graphs or nodes a step
        rows = d.get("batch_nodes") or d.get("n_graphs") or d["n_nodes"]
    else:
        if args.smoke:
            cell = registry.reduce_cell(cell)
        configs = registry.ARCHS[args.arch]
        cfg = configs.SMOKE if args.smoke else configs.CONFIG
        params = convert.params_of(rec.recsys_init(cfg, seed=0,
                                                   device=device))
        fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
        rows = cell.dims["batch"]

        def draw(rng):
            return train_batch(rng, cfg, rows, device)
    opt_state = opt.init_opt_state(params, ocfg)
    step = 0
    if args.ckpt_dir and ckpt.exists(args.ckpt_dir):
        params, opt_state, step, _ = ckpt.restore(
            args.ckpt_dir, params_like=params, opt_like=opt_state)
        print(f"resumed at step {step}")
    rng = np.random.default_rng(0)
    losses, saves = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = draw(rng)
        params, opt_state, step, metrics = fn(params, opt_state, step, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0 or i == 0:
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            saves.append(ckpt.save(args.ckpt_dir, params=params,
                                   opt_state=opt_state, step=step,
                                   meta={"arch": args.arch},
                                   async_save=True))
    for t in saves:
        t.join()
    print("done")
    return {"arch": cfg.name, "shape": cell.name, "device": str(device),
            "rows": rows, "step": step, "losses": losses}


if __name__ == "__main__":
    main()
