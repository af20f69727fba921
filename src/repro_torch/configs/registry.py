"""The recsys cells the port serves, from the JAX package's
``configs/registry.py``: ``Cell``, ``REC_CELLS`` with their dims, and
``cell_by_name``; ``reduce_cell`` is the recsys branch of the JAX
launcher's ``launch/cells.py::_reduce_cell`` (the ``--smoke`` sizes).

``ARCHS`` maps the JAX launcher's four recsys archs to their config
modules.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import bst, deepfm, din, two_tower_retrieval


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str          # rec_train | rec_serve | rec_retrieval
    dims: dict


REC_CELLS = (
    Cell("train_batch", "rec_train", {"batch": 65536}),
    Cell("serve_p99", "rec_serve", {"batch": 512}),
    Cell("serve_bulk", "rec_serve", {"batch": 262144}),
    Cell("retrieval_cand", "rec_retrieval",
         {"batch": 1, "n_candidates": 1_000_000}),
)

ARCHS = {"din": din, "bst": bst, "two-tower-retrieval": two_tower_retrieval,
         "deepfm": deepfm}


def cell_by_name(name: str) -> Cell:
    for c in REC_CELLS:
        if c.name == name:
            return c
    raise KeyError(f"no recsys cell {name!r}")


def reduce_cell(cell: Cell) -> Cell:
    """The cell at CPU smoke size: the same kind, batch 8 and (where it has
    candidates) 64 candidates."""
    d = dict(cell.dims, batch=8)
    if "n_candidates" in d:
        d.update(n_candidates=64)
    return Cell(cell.name, cell.kind, d)
