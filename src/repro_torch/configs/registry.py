"""The cells the port runs, from the JAX package's ``configs/registry.py``:
``Cell``, ``REC_CELLS``, ``GNN_CELLS`` and ``LM_CELLS`` with their dims,
and ``cell_by_name``; ``reduce_cell`` is the JAX launcher's
``launch/cells.py::_reduce_cell`` (the ``--smoke`` sizes).

``ARCHS`` maps the JAX launcher's four recsys archs to their config
modules, ``GNN_ARCHS`` its GNN arch, ``LM_ARCHS`` its five LM archs;
``family`` names an arch's family (``recsys``, ``gnn`` or ``lm``), as the
JAX registry's ``ArchSpec.family`` does.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (bst, deepfm, deepseek_7b,
                                 deepseek_v3_671b, din, graphsage_reddit,
                                 nemotron_4_340b, qwen3_14b, qwen3_moe_235b,
                                 two_tower_retrieval)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str          # train | prefill | decode | rec_train | rec_serve |
    #                    rec_retrieval | gnn_full | gnn_minibatch |
    #                    gnn_molecule
    dims: dict


LM_CELLS = (
    Cell("train_4k", "train", {"seq": 4096, "batch": 256}),
    Cell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    Cell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    Cell("long_500k", "decode", {"seq": 524288, "batch": 1}),
)


GNN_CELLS = (
    Cell("full_graph_sm", "gnn_full",
         {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    Cell("minibatch_lg", "gnn_minibatch",
         {"batch_nodes": 1024, "fanouts": (15, 10), "d_feat": 602,
          "n_classes": 41, "n_nodes": 232_965, "n_edges": 114_615_892}),
    Cell("ogb_products", "gnn_full",
         {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
          "n_classes": 47}),
    Cell("molecule", "gnn_molecule",
         {"n_graphs": 128, "n_nodes": 30, "n_edges": 64, "d_feat": 32,
          "n_classes": 10}),
)


REC_CELLS = (
    Cell("train_batch", "rec_train", {"batch": 65536}),
    Cell("serve_p99", "rec_serve", {"batch": 512}),
    Cell("serve_bulk", "rec_serve", {"batch": 262144}),
    Cell("retrieval_cand", "rec_retrieval",
         {"batch": 1, "n_candidates": 1_000_000}),
)

ARCHS = {"din": din, "bst": bst, "two-tower-retrieval": two_tower_retrieval,
         "deepfm": deepfm}
GNN_ARCHS = {"graphsage-reddit": graphsage_reddit}
LM_ARCHS = {"deepseek-7b": deepseek_7b, "qwen3-14b": qwen3_14b,
            "nemotron-4-340b": nemotron_4_340b,
            "deepseek-v3-671b": deepseek_v3_671b,
            "qwen3-moe-235b-a22b": qwen3_moe_235b}
CELLS = {"recsys": REC_CELLS, "gnn": GNN_CELLS, "lm": LM_CELLS}


def family(arch_id: str) -> str:
    """``recsys``, ``gnn`` or ``lm``; raises ``KeyError`` for an arch the
    port does not run."""
    if arch_id in ARCHS:
        return "recsys"
    if arch_id in GNN_ARCHS:
        return "gnn"
    if arch_id in LM_ARCHS:
        return "lm"
    raise KeyError(arch_id)


def cell_by_name(name: str, family: str = "recsys") -> Cell:
    for c in CELLS[family]:
        if c.name == name:
            return c
    raise KeyError(f"no {family} cell {name!r}")


def reduce_cell(cell: Cell) -> Cell:
    """The cell at CPU smoke size, the same kind: an LM cell at batch 2 and
    32 positions (16 to train); a recsys cell at batch 8 and (where it has
    candidates) 64 candidates; a GNN cell at the JAX launcher's tiny
    graphs."""
    d = dict(cell.dims)
    if cell.kind in ("train", "prefill", "decode"):
        d.update(batch=2, seq=32 if cell.kind != "train" else 16)
    elif cell.kind == "gnn_full":
        d.update(n_nodes=200, n_edges=800, d_feat=24, n_classes=5)
    elif cell.kind == "gnn_minibatch":
        d.update(batch_nodes=8, fanouts=(4, 3), d_feat=24, n_classes=5,
                 n_nodes=500, n_edges=2000)
    elif cell.kind == "gnn_molecule":
        d.update(n_graphs=4, n_nodes=10, n_edges=16, d_feat=8, n_classes=3)
    else:
        d.update(batch=8)
        if "n_candidates" in d:
            d.update(n_candidates=64)
    return Cell(cell.name, cell.kind, d)
