"""Training launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch din|bst|two-tower-retrieval|deepfm [--shape train_batch] \
        [--smoke] [--steps 50] [--ckpt-dir DIR] [--ckpt-every 25] \
        [--device cuda|cpu]

The counterpart of the JAX package's ``launch/train.py``: builds the arch's
model at its published width (``CONFIG``; ``--smoke`` takes ``SMOKE`` and
the cell at ``registry.reduce_cell``'s size) with the port's
``recsys_init`` from seed 0, and trains it on ``synthetic.recsys_batch``
batches of the train cell (``train_batch``: 65,536 rows) through the dense
step the JAX cell builder makes, ``make_train_step(recsys_loss_fn(cfg),
OptConfig())``.  It prints ``step N loss=... (s/step)`` after the first
step and every tenth, then ``done``.  With ``--ckpt-dir`` it resumes from
a checkpoint there and saves one every ``--ckpt-every`` steps (async).

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
from repro_torch.data import synthetic
from repro_torch.kernels import ops
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_batch",
                    choices=[c.name for c in registry.REC_CELLS])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch not in registry.ARCHS:
        raise SystemExit(f"--arch {args.arch}: "
                         + rec.NOT_PORTED.format(arch=args.arch))
    cell = registry.cell_by_name(args.shape)
    if cell.kind != "rec_train":
        ap.error(f"{args.shape} is not a train cell; serve it with "
                 "python -m repro_torch.launch.serve")
    if args.steps < 1 or args.ckpt_every < 1:
        ap.error("--steps and --ckpt-every must be at least 1")
    if args.smoke:
        cell = registry.reduce_cell(cell)
    configs = registry.ARCHS[args.arch]
    cfg = configs.SMOKE if args.smoke else configs.CONFIG
    device = ops.resolve_device(args.device)
    ocfg = opt.OptConfig()
    params = convert.params_of(rec.recsys_init(cfg, seed=0, device=device))
    opt_state = opt.init_opt_state(params, ocfg)
    step = 0
    if args.ckpt_dir and ckpt.exists(args.ckpt_dir):
        params, opt_state, step, _ = ckpt.restore(
            args.ckpt_dir, params_like=params, opt_like=opt_state)
        print(f"resumed at step {step}")
    fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
    rng = np.random.default_rng(0)
    losses, saves = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = train_batch(rng, cfg, cell.dims["batch"], device)
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
    return {"arch": cfg.name, "device": str(device), "rows": cell.dims[
        "batch"], "step": step, "losses": losses}


if __name__ == "__main__":
    main()
