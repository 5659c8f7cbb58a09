"""Mesh plans over ``torch.distributed`` process groups.

The counterpart of ``repro.launch.mesh.make_mesh_plan_for_devices``: where
the JAX package lays a named device mesh over local devices, the port lays
the same named mesh over the ranks of the process group the caller has
initialized (``torch.distributed.init_process_group`` with the backend,
address, world size and rank of its choice). Rank ``r`` sits at the
row-major coordinate ``r`` of the mesh.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.distributed import MeshPlan


def _groups_over(shape, varying, rank: int):
    """Create the process groups whose ranks differ only along the axes in
    ``varying`` (every rank creates every group, in the same order, as
    ``new_group`` requires); return the one holding ``rank``, or ``None``
    when such a group would hold one rank."""
    import torch.distributed as dist

    if math.prod(shape[i] for i in varying) == 1:
        return None
    members = {}
    for r in range(math.prod(shape)):
        coords = np.unravel_index(r, shape)
        key = tuple(int(c) for i, c in enumerate(coords) if i not in varying)
        members.setdefault(key, []).append(r)
    mine = None
    for key in sorted(members):
        group = dist.new_group(members[key])
        if rank in members[key]:
            mine = group
    return mine


def make_mesh_plan(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data", "model"),
    node_axes: Optional[Sequence[str]] = None,
    slot_axes: Optional[Sequence[str]] = None,
) -> MeshPlan:
    """A :class:`MeshPlan` of ``shape`` over the initialized process group.

    Bucket rows are split over ``node_axes`` and neighbour slots over
    ``slot_axes``; together they must name every axis once. By default the
    slots go over ``"model"`` (when the mesh has it) and the rows over the
    other axes, as in the JAX package. A mesh of one rank needs no process
    group, and its plan issues no collective."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if slot_axes is None:
        slot_axes = tuple(a for a in axis_names if a == "model")
    if node_axes is None:
        node_axes = tuple(a for a in axis_names if a not in slot_axes)
    node_axes, slot_axes = tuple(node_axes), tuple(slot_axes)
    if sorted(node_axes + slot_axes) != sorted(axis_names):
        raise ValueError(f"node axes {node_axes} and slot axes {slot_axes} must "
                         f"name every axis of {axis_names} once")
    size = math.prod(shape)
    if size == 1:
        return MeshPlan(shape=shape, axis_names=axis_names,
                        node_axes=node_axes, slot_axes=slot_axes)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs torch.distributed initialized "
                           f"with world size {size}")
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {shape} needs {size} ranks, the process group "
                         f"has {dist.get_world_size()}")
    rank = dist.get_rank()
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
    dims = dict(zip(axis_names, shape))

    def index(axes):
        return int(np.ravel_multi_index([coords[a] for a in axes],
                                        [dims[a] for a in axes])) if axes else 0

    node_dims = [axis_names.index(a) for a in node_axes]
    slot_dims = [axis_names.index(a) for a in slot_axes]
    return MeshPlan(
        shape=shape, axis_names=axis_names,
        node_axes=node_axes, slot_axes=slot_axes,
        rank=rank, node_index=index(node_axes), slot_index=index(slot_axes),
        node_group=_groups_over(shape, node_dims, rank),
        slot_group=_groups_over(shape, slot_dims, rank),
        world_group=dist.group.WORLD,
        backend=str(dist.get_backend()),
    )
