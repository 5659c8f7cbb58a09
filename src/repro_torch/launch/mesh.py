"""Mesh plans over ``torch.distributed`` process groups.

The counterpart of ``repro.launch.mesh.make_mesh_plan_for_devices``: where
the JAX package lays a named device mesh over local devices, the port lays
the same named mesh over the ranks of the process group the caller has
initialized (``torch.distributed.init_process_group`` with the backend,
address, world size and rank of its choice). Rank ``r`` sits at the
row-major coordinate ``r`` of the mesh. :func:`sub_mesh_plan` lays a mesh
over a block of those ranks (a part-parallel slice).

:func:`make_production_plan` is the counterpart of
``repro.launch.mesh.make_production_mesh``: the paper-scale mesh the
dry-run prices, laid over a process group of the ``"fake"`` backend that
:func:`fake_process_group` opens (512 ranks in one process, no device and
no network; its collectives run on meta tensors and move nothing).

:func:`make_production_mesh` and :func:`make_device_mesh` are the LM
dry-run's meshes: a ``DeviceMesh`` with named dims over the same group,
on which the sharding policy lays its DTensor placements
(:mod:`repro_torch.sharding.policy`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.distributed import MeshPlan


def _groups_over(shape, varying, rank: int, ranks: Optional[Sequence[int]] = None):
    """Create the process groups whose ranks differ only along the axes in
    ``varying`` (every rank creates every group, in the same order, as
    ``new_group`` requires); return the one holding ``rank``, or ``None``
    when such a group would hold one rank (or none holds ``rank``).
    ``ranks[i]`` is the process group's rank at the mesh's row-major
    coordinate ``i`` (default ``i``)."""
    import torch.distributed as dist

    if math.prod(shape[i] for i in varying) == 1:
        return None
    members = {}
    for i in range(math.prod(shape)):
        coords = np.unravel_index(i, shape)
        key = tuple(int(c) for d, c in enumerate(coords) if d not in varying)
        members.setdefault(key, []).append(int(ranks[i]) if ranks is not None else i)
    mine = None
    for key in sorted(members):
        group = dist.new_group(members[key])
        if rank in members[key]:
            mine = group
    return mine


def _axes(axis_names, node_axes, slot_axes):
    """Validated ``(node_axes, slot_axes)``: by default the slots go over
    ``"model"`` (when the mesh has it) and the rows over the other axes, as
    in the JAX package."""
    if slot_axes is None:
        slot_axes = tuple(a for a in axis_names if a == "model")
    if node_axes is None:
        node_axes = tuple(a for a in axis_names if a not in slot_axes)
    node_axes, slot_axes = tuple(node_axes), tuple(slot_axes)
    if sorted(node_axes + slot_axes) != sorted(axis_names):
        raise ValueError(f"node axes {node_axes} and slot axes {slot_axes} must "
                         f"name every axis of {axis_names} once")
    return node_axes, slot_axes


def _plan_over(shape, axis_names, node_axes, slot_axes, ranks, me: int,
               world_group, backend: str) -> MeshPlan:
    """The plan of a mesh of ``shape`` whose row-major coordinate ``i`` holds
    the group's rank ``ranks[i]``, seen from rank ``me``. Creates its node
    and slot groups (and, with ``world_group=None``, a group of all its
    ranks) on every rank, in the same order."""
    dims = dict(zip(axis_names, shape))
    node_dims = [axis_names.index(a) for a in node_axes]
    slot_dims = [axis_names.index(a) for a in slot_axes]
    node_group = _groups_over(shape, node_dims, me, ranks)
    slot_group = _groups_over(shape, slot_dims, me, ranks)
    if world_group is None:
        world_group = _groups_over(shape, range(len(shape)), me, ranks)
    if me not in ranks:
        return MeshPlan(shape=shape, axis_names=axis_names, node_axes=node_axes,
                        slot_axes=slot_axes, rank=-1, node_index=-1, slot_index=-1,
                        backend=backend, ranks=tuple(ranks))
    local = list(ranks).index(me)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(local, shape))))

    def index(axes):
        return int(np.ravel_multi_index([coords[a] for a in axes],
                                        [dims[a] for a in axes])) if axes else 0

    return MeshPlan(
        shape=shape, axis_names=axis_names,
        node_axes=node_axes, slot_axes=slot_axes,
        rank=local, node_index=index(node_axes), slot_index=index(slot_axes),
        node_group=node_group, slot_group=slot_group, world_group=world_group,
        backend=backend, ranks=tuple(int(r) for r in ranks),
    )


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
    node_axes, slot_axes = _axes(axis_names, node_axes, slot_axes)
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
    return _plan_over(shape, axis_names, node_axes, slot_axes, tuple(range(size)),
                      dist.get_rank(), world_group=dist.group.WORLD,
                      backend=str(dist.get_backend()))


def sub_mesh_plan(plan: MeshPlan, shape: Sequence[int], ranks: Sequence[int],
                  me: int) -> MeshPlan:
    """The plan of a sub-mesh of ``plan``: ``shape`` over the group ranks
    ``ranks`` (row-major), with ``plan``'s axis names, node and slot axes and
    backend, seen from the group's rank ``me``. Every rank of the process
    group must call it for every sub-mesh, in the same order (it creates
    the sub-mesh's node, slot and world groups); only a plan that holds
    ``me`` carries live groups."""
    shape = tuple(int(s) for s in shape)
    ranks = tuple(int(r) for r in ranks)
    if math.prod(shape) != len(ranks):
        raise ValueError(f"sub-mesh {shape} needs {math.prod(shape)} ranks, got {ranks}")
    return _plan_over(shape, plan.axis_names, plan.node_axes, plan.slot_axes, ranks, me,
                      world_group=None, backend=plan.backend)


def make_production_plan(*, multi_pod: bool = False) -> MeshPlan:
    """The production mesh: ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` (512 ranks) or ``(16, 16)`` over ``("data", "model")`` (256),
    rows over the "pod" and "data" axes and slots over "model", seen from
    the process group's rank. It needs an initialized process group of that
    many ranks (the dry-run's :func:`fake_process_group`; every rank of an
    SPMD sweep has the same shapes, so rank 0 stands for all of them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_plan(shape, axes)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """Initialize the default process group with PyTorch's ``"fake"``
    backend as rank 0 of ``world_size`` ranks, and destroy it on the way
    out. The backend ships with PyTorch (``torch.testing._internal.
    distributed.fake_pg``); without it this raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_device_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axis_names`` over the
    first ranks of the initialized process group, rank ``r`` at the
    row-major coordinate ``r`` (the tests' ``(4, 2)``; a fake group's meta
    tensors run on a ``"cpu"`` mesh). The group needs at least the mesh's
    size in ranks, and this rank among them."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs torch.distributed initialized "
                           f"with world size {math.prod(shape)}")
    if not dist.get_rank() < math.prod(shape) <= dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks with rank "
                         f"{dist.get_rank()}, the process group has {dist.get_world_size()}")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """The LM dry-run's production mesh: ``(2, 16, 16)`` over ``("pod",
    "data", "model")`` (512 ranks; "pod" carries only data parallelism) or
    ``(16, 16)`` over ``("data", "model")`` (256), as a ``DeviceMesh`` over
    the initialized process group (the dry-run's :func:`fake_process_group`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes)
