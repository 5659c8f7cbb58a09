"""What one call costs a device, counted from the ops it dispatches: the
counterpart of the reference dry-run's ``compiled.memory_analysis()``,
``cost_analysis_dict(compiled)`` and ``parse_collectives(compiled.as_text())``.

:class:`Tally` is a ``TorchDispatchMode``. Over the aten and ``c10d`` ops
dispatched inside it, on any device (meta tensors included, which is how
the dry-run traces a sweep at sizes no device holds), it records:

* ``peak_bytes``: the peak of the bytes held by the storages created inside
  the call (the reference's ``temp_size_in_bytes``). A storage counts once,
  whatever views share it, from the op that creates it until it is freed;
  views and in-place ops allocate nothing;
* ``read_bytes`` and ``write_bytes``: each op reads its tensor arguments
  once and writes its outputs once. A gather (``index``) reads as many
  source elements as it writes; a scatter (``index_put_``,
  ``scatter_reduce_``) and any in-place op write only what they touch of
  their destination. A broadcast input counts its distinct elements. Views
  move nothing, and collectives are priced on the wire, not here;
* ``int_ops``: one per output element of a pointwise op, one per input
  element of a reduction;
* ``bytes_by_op``: the bytes read and written, by op name;
* ``collectives``: each ``c10d`` collective with its process group's size
  and ranks and its ring wire bytes
  (:class:`repro_torch.roofline.analysis.CollectiveStats`).

Work that aten does not see is charged by its wrapper through
:func:`record_kernel`: the counts kernel's meta shape function charges
what the kernel would read, write and compute.
"""
from __future__ import annotations

import math
import threading

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.analysis import CollectiveStats

_aten = torch.ops.aten
_GATHERS = {_aten.index.Tensor, _aten.gather.default, _aten.index_select.default}
_SCATTERS = {_aten.index_put_.default, _aten.scatter_reduce_.two, _aten.scatter_.src,
             _aten.scatter_add_.default, _aten.index_add_.default}
_UNWRITTEN = {_aten.empty.memory_format, _aten.empty_strided.default}  # allocate only
_COLLECTIVES = {"c10d::allreduce_": "all-reduce", "c10d::allgather_": "all-gather"}
_local = threading.local()  # .active: the tallies entered on this thread, innermost last


def record_kernel(name: str, *, read_bytes: int, write_bytes: int, int_ops: int) -> None:
    """Charge one kernel that runs outside aten to the innermost tally active
    on this thread (dispatch modes are per thread); nothing when none is."""
    active = getattr(_local, "active", None)
    if active:
        active[-1]._charge(name, read_bytes, write_bytes, int_ops)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast dimension, of
    stride 0, holds one)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _group_ranks(func, args, kwargs):
    """The global ranks of the process group a ``c10d`` op runs over."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup

    for i, arg in enumerate(func._schema.arguments):
        if "ProcessGroup" in str(arg.type):
            pg = args[i] if i < len(args) else kwargs[arg.name]
            return dist.get_process_group_ranks(ProcessGroup.unbox(pg))
    raise ValueError(f"{func} has no process group argument")


class Tally(TorchDispatchMode):
    """Peak live bytes, bytes read and written, int32 ops and collectives of
    the ops run inside ``with Tally() as t:``."""

    def __init__(self):
        super().__init__()
        self.peak_bytes = 0
        self.read_bytes = 0
        self.write_bytes = 0
        self.int_ops = 0
        self.bytes_by_op = {}
        self.collectives = CollectiveStats()
        self._live = {}  # storage address -> (weak ref, bytes)
        self._live_bytes = 0

    @property
    def hbm_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    def __enter__(self):
        if not hasattr(_local, "active"):
            _local.active = []
        _local.active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _local.active.remove(self)
        return super().__exit__(*exc)

    def _charge(self, name: str, read: int, write: int, ops: int) -> None:
        self.read_bytes += int(read)
        self.write_bytes += int(write)
        self.int_ops += int(ops)
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + int(read) + int(write)

    def _free_expired(self) -> None:
        for key, (ref, nbytes) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self._live_bytes -= nbytes

    def _allocate(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        ref = StorageWeakRef(storage)
        self._live[ref.cdata] = (ref, storage.nbytes())
        self._live_bytes += storage.nbytes()
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._free_expired()
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_storages = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        new = [t for t in outs if StorageWeakRef(t.untyped_storage()).cdata not in in_storages]
        for t in new:
            if StorageWeakRef(t.untyped_storage()).cdata not in self._live:
                self._allocate(t)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        mutable = func._schema.is_mutable
        if (not new and not mutable) or func in _UNWRITTEN:  # a view, or an allocation
            return out
        if func in _GATHERS:
            src = args[0]
            read = sum(_nbytes(t) for t in ins if t is not src)
            read += sum(t.numel() for t in outs) * src.element_size()
            write = sum(_nbytes(t) for t in outs)
        elif mutable:  # writes what it touches of args[0], reads the rest
            dest = args[0]
            others = [t for t in ins if t is not dest]
            read = sum(_nbytes(t) for t in others)
            touched = (max((t.numel() for t in others), default=0) if func in _SCATTERS
                       else dest.numel())
            write = touched * dest.element_size()
        else:
            read = sum(_nbytes(t) for t in {id(t): t for t in ins}.values())
            write = sum(_nbytes(t) for t in outs)
        ops = 0
        if torch.Tag.pointwise in func.tags:
            ops = sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            ops = args[0].numel()
        self._charge(func.overloadpacket.__name__, read, write, ops)
        return out

    def _collective(self, func, args, kwargs) -> None:
        kind = _COLLECTIVES.get(func._schema.name)
        if kind is None:
            raise NotImplementedError(f"Tally: no cost model for {func._schema.name}")
        # allreduce_(tensors, ...) reduces in place; allgather_(outputs, inputs, ...)
        size = sum(t.numel() * t.element_size() for t in _tensors(args[0]))
        self.collectives.add(kind, size, _group_ranks(func, args, kwargs))
