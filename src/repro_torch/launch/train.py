"""Training launcher for the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch din|bst|two-tower-retrieval|deepfm [--shape train_batch] \
        [--smoke] [--steps 50] [--ckpt-dir DIR] [--ckpt-every 25] \
        [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch graphsage-reddit \
        [--shape minibatch_lg|full_graph_sm|ogb_products|molecule] ...
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-14b|deepseek-7b|nemotron-4-340b|deepseek-v3-671b|\
qwen3-moe-235b-a22b [--shape train_4k] ...

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

* An LM arch: its ``train_4k`` cell (batch 256 x 4,096 tokens; another
  LM cell exits, pointing to the serve launcher) through
  ``make_train_step(lm_loss_fn(cfg), cells.opt_cfg("lm", cfg),
  in_place=True)``: Adam, or Adafactor from ~14B (the rule is printed),
  the update in place a block at a time, the stacks' gradients a layer at
  a time.  Parameters are the JAX launcher's: ``materialize`` of the
  parameter shapes from seed 0 (N(0, 0.02) every leaf, the JAX package's
  draws bit for bit) while they hold at most ``HOST_DRAW_PARAMS`` values,
  else ``lm.lm_init`` on the device from seed 0 (numpy would take
  minutes); which one ran is printed.  Batches are ``synthetic.lm_batch``
  of the cell's sequences from ``np.random.default_rng(0)``, as the JAX
  launcher draws them.  On the card the launcher first reckons the step's
  bytes (``lm_train_bytes``: parameters, gradients, optimizer state, and
  the larger of the update's transient and the activations,
  ``step_peak``) against the free memory: it cuts the batch to what fits
  and prints the cut, or exits naming the bytes when not one sequence
  fits.  bf16 products accumulate in fp32 there.

It prints ``step N loss=... (s/step)`` after the first step and every
tenth, then ``done``.  With ``--ckpt-dir`` it resumes from a checkpoint
there and saves one every ``--ckpt-every`` steps (async).

It runs on ``--device`` (default ``cuda``; there is no fallback to the
CPU).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.data import graph_sampler, synthetic
from repro_torch.kernels import ops
from repro_torch.launch import cells
from repro_torch.launch import materialize as mat
from repro_torch.models import common as cm
from repro_torch.models import gnn
from repro_torch.models import lm
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


HOST_DRAW_PARAMS = mat.HOST_DRAW_PARAMS   # larger parameters are drawn
#                                           on the device


def _state_bytes(rule: str, shape: tuple) -> int:
    """The optimizer state of one leaf of ``shape``, in bytes."""
    n = math.prod(shape)
    if rule == "adam":
        return 8 * n
    if rule == "adafactor":
        if len(shape) < 2:
            return 6 * n
        lead = math.prod(shape[:-2])
        return 2 * n + 4 * lead * (shape[-2] + shape[-1])
    return 4 * shape[0]                                  # adagrad_rows


def lm_train_bytes(cfg, ocfg: opt.OptConfig, batch: int, seq: int) -> dict:
    """What one train step of ``cfg`` at ``batch`` x ``seq`` holds on the
    device, in bytes (an estimate) under the launcher's step (in place,
    the stacks' gradients a layer at a time): the parameters, their
    gradients and the optimizer state, held throughout; the update's
    transient (one block's fp32 work); and the activations of
    ``batch`` sequences: the layers' inputs (all of them under remat),
    one layer's working set (the fp32 scores of the causal half and their
    bf16 copy, the FFN's or the experts' products), the hidden states
    around the loss and one loss chunk's fp32 logits.  The transient and
    the activations are not alive together (``step_peak``)."""
    specs = lm.param_specs(cfg)
    params = lm.param_bytes(cfg)
    state = sum(_state_bytes(opt.rule_for_path(k, ocfg), tuple(sp.shape))
                for k, sp in specs.items())
    block = max(opt.largest_block(opt.rule_for_path(k, ocfg),
                                  tuple(sp.shape))
                for k, sp in specs.items())
    item = cfg.torch_dtype.itemsize
    d, s = cfg.d_model, seq
    heads = cfg.n_heads
    qc = min(cfg.q_chunk, s)
    attn = heads * s * (s + qc) // 2 * 6 + 8 * s * heads * 192
    if cfg.moe is not None:
        m = cfg.moe
        slots = int(math.ceil(s * m.top_k * m.capacity_factor))
        ffn = slots * (d + 3 * m.d_ff) * item * 2 + s * m.n_experts * 16 \
            + 3 * s * m.shared_ff * item
    else:
        ffn = 4 * s * cfg.d_ff * item
    layer = attn + ffn + 8 * s * d * 4
    kept = cfg.n_layers * s * d * item
    if not cfg.remat:
        layer *= cfg.n_layers
    chunk = min(cfg.loss_chunk or s, s)
    loss = 6 * s * d * item + 3 * chunk * cfg.vocab * 4
    if cfg.mtp_depth:
        loss += attn + ffn + 8 * s * d * 4
    return {"params": params, "grads": params, "opt_state": state,
            "transient": 8 * 4 * block,
            "activations": batch * (kept + layer + loss)}


def step_peak(need: dict) -> int:
    """The peak of ``lm_train_bytes``' parts: what is held throughout, and
    the larger of the transient and the activations."""
    return need["params"] + need["grads"] + need["opt_state"] \
        + max(need["transient"], need["activations"])


def lm_params(cfg, device) -> tuple:
    """-> (parameters of ``cfg`` on ``device``, how they were drawn)
    (module docstring)."""
    specs = lm.param_specs(cfg)
    if sum(math.prod(sp.shape) for sp in specs.values()) \
            <= HOST_DRAW_PARAMS:
        tree = mat.materialize(mat.nested({
            k: cm.ShapeDtype(tuple(sp.shape), sp.dtype or cfg.torch_dtype)
            for k, sp in specs.items()}), seed=0, device=device)
        return {k: mat.at(tree, k) for k in specs}, "materialize(seed=0)"
    return lm.lm_init(cfg, seed=0, device=device), "lm_init(seed=0)"


def lm_setup(arch: str, shape: str, smoke: bool, device):
    """(cell, cfg, opt config, parameters, train step, sequences a step)
    of ``arch``'s LM train cell ``shape`` (module docstring)."""
    cell = registry.cell_by_name(shape, "lm")
    if cell.kind != "train":
        raise SystemExit(f"{shape} is not a train cell; serve it with "
                         "python -m repro_torch.launch.serve")
    if smoke:
        cell = registry.reduce_cell(cell)
    configs = registry.LM_ARCHS[arch]
    cfg = configs.SMOKE if smoke else configs.CONFIG
    ocfg = cells.opt_cfg("lm", cfg)
    b, s = cell.dims["batch"], cell.dims["seq"]
    if device.type == "cuda":
        need = lm_train_bytes(cfg, ocfg, b, s)
        free = torch.cuda.mem_get_info(device)[0]
        per_seq = need["activations"] // b
        one = step_peak(lm_train_bytes(cfg, ocfg, 1, s))
        if one > free:
            raise SystemExit(
                f"{cfg.name}/{cell.name} needs {one} B for one sequence "
                f"({lm_train_bytes(cfg, ocfg, 1, s)}) and the card has "
                f"{free} B free")
        if step_peak(need) > free:      # held + b x per_seq <= free
            fits = (free - need["params"] - need["grads"]
                    - need["opt_state"]) // per_seq
            print(f"reduced: {cfg.name}/{cell.name} batch {b}->{fits}: "
                  f"{step_peak(need)} B ({need}) pass the card's {free} B "
                  f"free", flush=True)
            b = fits
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    print(f"{cfg.name}/{cell.name}: {ocfg.dense_rule} (d_model "
          f"{cfg.d_model} x {cells.published_layers(cfg)} published "
          f"layers), tables {ocfg.table_rule}", flush=True)
    params, how = lm_params(cfg, device)
    print(f"parameters: {how}, {lm.param_bytes(cfg)} B", flush=True)
    fn = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg, in_place=True)
    return cell, cfg, ocfg, params, fn, b


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    choices=[c.name for c in registry.REC_CELLS
                             + registry.GNN_CELLS + registry.LM_CELLS],
                    help="train_batch for a recsys arch, minibatch_lg for "
                         "graphsage-reddit, train_4k for an LM")
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
    shape = args.shape or {"recsys": "train_batch", "gnn": "minibatch_lg",
                           "lm": "train_4k"}[family]
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
    if family == "lm":
        cell, cfg, ocfg, params, fn, rows = lm_setup(
            args.arch, shape, args.smoke, device)
        seq = cell.dims["seq"]

        def draw(rng):
            return {"tokens": torch.as_tensor(synthetic.lm_batch(
                rng, rows, seq, cfg.vocab)["tokens"], device=device)}
    elif family == "gnn":
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
    losses, gnorms, saves = [], [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = draw(rng)
        params, opt_state, step, metrics = fn(params, opt_state, step, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
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
            "rows": rows, "step": step, "losses": losses,
            "grad_norms": gnorms}


if __name__ == "__main__":
    main()
