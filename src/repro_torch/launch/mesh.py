"""The meshes the port's cells are built at, from the JAX package's
``launch/mesh.py``.

``make_local_mesh()`` describes the world this process runs in, as axes
``("data", "model")``: ``data`` the size of the default
``torch.distributed`` process group (1 when there is none) and ``model``
1.  It holds that group and, in a world of more than one rank, a group of
this rank alone for the ``model`` axis, so that a lookup sharded over
``model`` (two-tower's ``a2a`` and ``psum16``) takes the local path, as
the reference's does at its local mesh.

``make_mesh(model=n)`` describes the same world as ``(data, model)`` =
``(world / n, n)``: rank r sits at ``(r // n, r % n)``, where
``jax.make_mesh((world / n, n), ("data", "model"))`` puts device r on
host devices (``tests/test_torch_lm_sharded.py`` reads the JAX mesh's
``devices`` to hold it).  It holds the ``model`` group of this rank's
row (the LM's sequence-sharded decode caches and its experts run over
it) and the ``data`` group of its column (a decode step's MoE gathers
the batch over it).  Making either mesh in a world of several ranks is a
collective: every rank makes it.

``make_production_mesh(multi_pod=)`` describes the TPU v5e pods the
reference compiles its cells for: 16 x 16 with axes ``(data, model)``, or
2 x 16 x 16 with ``(pod, data, model)``.  It holds no ranks: running a
cell on it needs the dense weights' FSDP / tensor-parallel placement and
the bundles' shardings, ROADMAP queue 1, item 15.4, and the dry-run
refuses it (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

ITEM_15_4 = ("the production mesh (16x16 or 2x16x16) needs the dense "
             "weights' FSDP / tensor-parallel placement, the bundles' "
             "in_shardings / out_shardings and the dry-run at that mesh, "
             "which wait for ROADMAP queue 1, item 15.4 (the port runs the "
             "sharded LM serving paths at make_mesh(model=n) over a "
             "torch.distributed world)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``group`` the process group of the ranks it
    spans (None: this process alone, or a production mesh), ``model_group``
    the group of this rank's ``model`` row (None: a world of one),
    ``data_group`` the group of its ``data`` column (None where no path
    runs over it), and this rank's ``(data_index, model_index)``."""
    axis_names: tuple
    shape: tuple
    group: Optional[Any] = None
    model_group: Optional[Any] = None
    local: bool = True
    data_group: Optional[Any] = None
    data_index: int = 0
    model_index: int = 0

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def batch_rows(self, batch: int) -> slice:
        """The rows of a batch of ``batch`` this rank holds: its block of
        ``batch / data`` where ``data`` divides it (the reference's
        ``bspec``), else all of them (replicated)."""
        data = self.size("data")
        if batch % data:
            return slice(0, batch)
        n = batch // data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def seq_shards(self, s_max: int) -> int:
        """How many ``model`` ranks a decode cache of ``s_max`` positions
        is split over: all of them where there are several and they
        divide it (the reference's flash-decode), else 1 (every rank holds
        it whole: the reference's fallback)."""
        n = self.size("model")
        return n if n > 1 and s_max % n == 0 else 1


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


def make_mesh(model: int = 1) -> Mesh:
    """The default process group as ``(data, model)`` = ``(world / model,
    model)`` (module docstring); with no process group, a world of one
    (``model`` must be 1 then)."""
    if not (dist.is_available() and dist.is_initialized()):
        if model != 1:
            raise ValueError(f"model={model} needs a torch.distributed "
                             f"world of a multiple of {model} ranks")
        return Mesh(("data", "model"), (1, 1))
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the world of "
                         f"{world} ranks")
    data = world // model
    model_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model + m for m in range(model)] for d in range(data)])
    data_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model + m for d in range(data)] for m in range(model)])
    return Mesh(("data", "model"), (data, model), group=dist.group.WORLD,
                model_group=model_group, data_group=data_group,
                data_index=rank // model, model_index=rank % model)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips (v5e pod).  Multi-pod: 2 pods x
    256."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, local=False)
