"""Logical-axis -> mesh-axis sharding policy with divisibility fallback: the
port of ``repro.sharding.policy``.

One place decides how every tensor is laid out on the mesh. Layers annotate
*logical* axes ("embed", "mlp", "heads", "experts", ...); :func:`resolve`
maps them to mesh axes using a rules table and falls back to replication
whenever the dimension is not divisible by the mesh axis size (grok's 8
experts on a 16-wide model axis). Fallbacks are recorded in a
:class:`ResolveLog` so the dry-run can report them.

Default rules (the "megatron+fsdp" layout):

  batch   -> ("pod", "data")   pure DP across pods
  embed   -> "data"            FSDP/ZeRO-3: params gathered on use
  vocab   -> "model"           tensor-parallel embedding / logits
  heads   -> "model"           attention TP
  mlp     -> "model"           feed-forward TP
  experts -> "model"           expert parallelism (when divisible)
  kv_heads-> "model"           (falls back to replicated for kv < 16)
  layers  -> None              never sharded
  seq     -> None              (the long-decode cache overrides to "data")

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or a mapping ``{axis name: size}`` in mesh-dim order (enough for the
pure resolution, which needs no process group). A spec is a :class:`Spec`,
one entry per tensor dim: ``None``, a mesh axis, or a tuple of mesh axes;
:func:`placements` turns it into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

Axis = Optional[str]
MeshAxes = Optional[Tuple[str, ...]]


class Spec(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of mesh
    axis names (the dim sharded over their product, major axis first)."""

    def __new__(cls, *parts):
        # A one-axis tuple is that axis, as a PartitionSpec normalizes it.
        parts = tuple(p[0] if isinstance(p, (tuple, list)) and len(p) == 1
                      else tuple(p) if isinstance(p, list) else p for p in parts)
        return super().__new__(cls, parts)

    def __repr__(self):
        return "Spec(" + ", ".join(repr(p) for p in self) + ")"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping, in mesh-dim
    order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the sharding policy needs a DeviceMesh with named dims")
    return dict(zip(names, (int(s) for s in mesh.shape)))


# ------------------------------------------------------------------ #
# Active mesh: layers emit logical activation constraints; they resolve
# against the mesh in scope, and are no-ops when there is none (one card,
# the CPU tests).
# ------------------------------------------------------------------ #
_ACTIVE_AXES: Dict[str, int] = {}
_ACTIVE_RULES: Optional[Dict[str, MeshAxes]] = None
_ACTIVE_LOG: Optional["ResolveLog"] = None
_ACTIVE_MESH = None  # the DeviceMesh, when active_mesh was given one


class active_mesh:
    """Context manager: declare the mesh (and optionally the rules table)
    whose axes activation constraints may use, and the log that records
    the sites where an activation is replicated for an op DTensor cannot
    shard (:func:`repro_torch.models.layers.replicate_for`)."""

    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None,
                 log: Optional["ResolveLog"] = None):
        self.axes = mesh_axes(mesh) if mesh is not None else {}
        self.mesh = None if mesh is None or isinstance(mesh, Mapping) else mesh
        self.rules = rules
        self.log = log

    def __enter__(self):
        global _ACTIVE_AXES, _ACTIVE_RULES, _ACTIVE_LOG, _ACTIVE_MESH
        self._saved = (_ACTIVE_AXES, _ACTIVE_RULES, _ACTIVE_LOG, _ACTIVE_MESH)
        _ACTIVE_AXES = self.axes
        _ACTIVE_RULES = self.rules
        _ACTIVE_LOG = self.log
        _ACTIVE_MESH = self.mesh
        return self

    def __exit__(self, *exc):
        global _ACTIVE_AXES, _ACTIVE_RULES, _ACTIVE_LOG, _ACTIVE_MESH
        _ACTIVE_AXES, _ACTIVE_RULES, _ACTIVE_LOG, _ACTIVE_MESH = self._saved
        return False


def mesh_active() -> bool:
    """Whether an :class:`active_mesh` with a mesh is in scope."""
    return bool(_ACTIVE_AXES)


def active_rules() -> Dict[str, MeshAxes]:
    """The rules table of the :class:`active_mesh` in scope (the default
    rules when it names none)."""
    return _ACTIVE_RULES or DEFAULT_RULES


def active_device_mesh():
    """The ``DeviceMesh`` of the :class:`active_mesh` in scope, if it was
    given one (``None`` otherwise)."""
    return _ACTIVE_MESH if _ACTIVE_AXES else None


def active_log() -> Optional["ResolveLog"]:
    """The log of the :class:`active_mesh` in scope (``None`` outside one)."""
    return _ACTIVE_LOG if _ACTIVE_AXES else None


def filter_spec(spec: Sequence) -> Optional[Spec]:
    """Drop axes not present in the active mesh; None if no mesh active."""
    if not _ACTIVE_AXES:
        return None
    parts = []
    for entry in spec:
        if entry is None:
            parts.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in _ACTIVE_AXES)
            parts.append(kept if kept else None)
        else:
            parts.append(entry if entry in _ACTIVE_AXES else None)
    return Spec(*parts)


def active_dp_size() -> int:
    """Product of active batch-rule axes (1 without an active mesh)."""
    if not _ACTIVE_AXES:
        return 1
    rules = _ACTIVE_RULES or DEFAULT_RULES
    out = 1
    for ax in rules.get("batch") or ():
        out *= _ACTIVE_AXES.get(ax, 1)
    return out


def logical_spec(shape: Sequence[int], axes: Sequence[Axis]) -> Optional[Spec]:
    """Resolve LOGICAL axes for an activation against the active mesh with
    divisibility fallback — e.g. an [8, cap, d] expert buffer only gets
    Spec("model", ...) when 8 divides the model axis (jamba 16e yes, grok 8e
    no). Returns None when no mesh is active."""
    if not _ACTIVE_AXES:
        return None
    rules = _ACTIVE_RULES or DEFAULT_RULES
    used: set = set()
    parts = []
    for size, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        mesh_axes_ = rules.get(name)
        if mesh_axes_ is None:
            parts.append(None)
            continue
        chosen = []
        prod = 1
        for ax in mesh_axes_:
            if ax not in _ACTIVE_AXES or ax in used:
                continue
            nsize = _ACTIVE_AXES[ax]
            if size % (prod * nsize) != 0:
                continue
            chosen.append(ax)
            prod *= nsize
        if not chosen:
            parts.append(None)
        else:
            parts.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
            used.update(chosen)
    return Spec(*parts)


DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "experts": ("model",),
    "inner": ("model",),  # SSM d_inner
    "layers": None,
    "seq": None,
    "cache_seq": None,
    "cache_batch": ("pod", "data"),
    "state": None,
    "conv": None,
    "frames": None,
    "patches": None,
}

# Variants used by the perf pass; selected per arch/shape in configs.
LONG_DECODE_RULES = dict(DEFAULT_RULES, cache_seq=("data",), cache_batch=None)
TP_ONLY_RULES = dict(DEFAULT_RULES, embed=None)

# Decode/serving layout: the default (training) rules FSDP-shard params over
# "data" and re-gather the full weights every decode step. SERVE_RULES run
# Megatron-style tensor parallelism over the flattened (data x model) axis
# on the weights' output dims: weights stay resident, each block pays one
# small activation all-reduce, and the KV cache shards over its sequence dim
# (flash-decode style).
SERVE_RULES = dict(
    DEFAULT_RULES,
    batch=None,
    embed=None,
    mlp=("data", "model"),
    expert_mlp=("data", "model"),
    inner=("data", "model"),
    heads=("data", "model"),
    kv_heads=("model",),
    vocab=("data", "model"),
    cache_batch=None,
    cache_seq=("data",),
)


@dataclasses.dataclass
class ResolveLog:
    """Fallbacks recorded during resolution (reported by the dry-run):
    ``replicated`` the reference's (axes, dim, size, axis size) entries of
    :func:`resolve`, ``ops`` the (op, site) pairs where an activation was
    replicated because DTensor has no sharding rule for the op."""

    replicated: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)

    def note(self, axes, dim, size, axis_size):
        self.replicated.append((axes, dim, size, axis_size))

    def note_op(self, op: str, site: str):
        if (op, site) not in self.ops:
            self.ops.append((op, site))


def resolve(
    shape: Sequence[int],
    axes: Sequence[Axis],
    mesh,
    rules: Optional[Dict[str, MeshAxes]] = None,
    log: Optional[ResolveLog] = None,
) -> Spec:
    """Spec for a tensor with the given logical axes."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    used: set = set()
    parts = []
    for dim, (size, name) in enumerate(zip(shape, axes)):
        if name is None:
            parts.append(None)
            continue
        mesh_axes_ = rules.get(name)
        if mesh_axes_ is None:
            parts.append(None)
            continue
        # Keep only axes present in this mesh, unused so far, and divisible.
        chosen = []
        prod = 1
        for ax in mesh_axes_:
            if ax not in sizes or ax in used:
                continue
            nsize = sizes[ax]
            if size % (prod * nsize) != 0:
                if log is not None:
                    log.note(tuple(axes), dim, size, nsize)
                continue
            chosen.append(ax)
            prod *= nsize
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
            used.add(chosen[0])
        else:
            parts.append(tuple(chosen))
            used.update(chosen)
    return Spec(*parts)


def data_axes(mesh, rules=None) -> Tuple[str, ...]:
    """Mesh axes carrying the batch (for per-device batch calculations)."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    return tuple(a for a in (rules.get("batch") or ()) if a in sizes)


def dp_size(mesh, rules=None) -> int:
    sizes = mesh_axes(mesh)
    return int(math.prod(sizes[a] for a in data_axes(mesh, rules)))


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The shard shape of one rank: each dim divided by the product of the
    mesh axes it is sharded over (the reference's
    ``NamedSharding.shard_shape``; ``resolve`` only picks dividing axes)."""
    sizes = mesh_axes(mesh)
    out = []
    for size, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(sizes[a] for a in names)
        if size % n:
            raise ValueError(f"dim of size {size} does not divide over {names} ({n})")
        out.append(size // n)
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``, one per
    mesh dim: ``Shard(d)`` where tensor dim ``d`` is sharded over that mesh
    dim, else ``Replicate()``.

    A dim sharded over several axes shards in mesh-dim order, as JAX's
    ``PartitionSpec`` does when its tuple lists them major first; a tuple
    in another order than the mesh's raises (DTensor would shard the dim in
    mesh order, a different layout)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise KeyError(f"spec {spec!r}: mesh {names} has no axis {ax!r}")
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: dim {dim} is sharded over {axes}, not in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)
