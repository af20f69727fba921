"""The meshes the port's cells are built at, from the JAX package's
``launch/mesh.py``.

``make_local_mesh()`` describes the world this process runs in, as axes
``("data", "model")``: ``data`` the size of the default
``torch.distributed`` process group (1 when there is none) and ``model``
1.  It holds that group and, in a world of more than one rank, a group of
this rank alone for the ``model`` axis, so that a lookup sharded over
``model`` (two-tower's ``a2a`` and ``psum16``) takes the local path, as
the reference's does at its local mesh.  Making it in a world of several
ranks is a collective: every rank makes it.

``make_production_mesh(multi_pod=)`` describes the TPU v5e pods the
reference compiles its cells for: 16 x 16 with axes ``(data, model)``, or
2 x 16 x 16 with ``(pod, data, model)``.  It holds no ranks: running a
cell on it is ROADMAP queue 1, item 15.3's work, and the dry-run refuses
it (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

ITEM_15_3 = ("the production mesh (16x16 or 2x16x16) runs the sharded LM "
             "paths, which wait for ROADMAP queue 1, item 15.3")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``group`` the process group of the ranks it
    spans (None: this process alone, or a production mesh), ``model_group``
    the group a ``model``-sharded lookup runs over (None: a world of
    one)."""
    axis_names: tuple
    shape: tuple
    group: Optional[Any] = None
    model_group: Optional[Any] = None
    local: bool = True



def make_local_mesh() -> Mesh:
    """This process's world as ``(data, model)`` with ``model`` 1."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(("data", "model"), (1, 1))
    world = dist.get_world_size()
    model_group = None
    if world > 1:
        model_group, _ = dist.new_subgroups(group_size=1)
    return Mesh(("data", "model"), (world, 1), group=dist.group.WORLD,
                model_group=model_group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips (v5e pod).  Multi-pod: 2 pods x
    256."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, local=False)
