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
* ``flops``: 2 m k n of each product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``) and 2 x output elements x (input channels / groups x kernel
  elements) of a ``convolution``;
* ``bytes_by_op``: the bytes read and written, by op name;
* ``collectives``: each ``c10d`` collective, and each ``_c10d_functional``
  one that DTensor issues (all-gather, reduce-scatter, all-reduce,
  all-to-all, and DTensor's own ``shard_dim_alltoall``), with its process
  group's size and ranks and its ring wire bytes
  (:class:`repro_torch.roofline.analysis.CollectiveStats`). ``wait_tensor``
  and ``_wrap_tensor_autograd`` move nothing.

Under DTensor (the LM dry-run), an op on DTensors is passed on
(``NotImplemented``): DTensor desugars it into the collectives that
redistribute its inputs and the op on each rank's local shard, and those
come back here, so every number is rank 0's. The fake tensors DTensor's
sharding propagation computes shapes with are not charged.

Work that aten does not see is charged by its wrapper through
:func:`record_kernel`: the counts kernel's meta shape function charges
what the kernel would read, write and compute.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import CollectiveStats

_aten = torch.ops.aten
_GATHERS = {_aten.index.Tensor, _aten.gather.default, _aten.index_select.default}
_SCATTERS = {_aten.index_put_.default, _aten.scatter_reduce_.two, _aten.scatter_.src,
             _aten.scatter_add_.default, _aten.index_add_.default}
_UNWRITTEN = {_aten.empty.memory_format, _aten.empty_strided.default}  # allocate only
_COLLECTIVES = {"c10d::allreduce_": "all-reduce", "c10d::allgather_": "all-gather"}
_FUNCTIONAL = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
_NO_WIRE = {"_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd"}
_PRODUCTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}
_local = threading.local()  # .active: the tallies entered on this thread, innermost last


def record_kernel(name: str, *, read_bytes: int, write_bytes: int, int_ops: int) -> None:
    """Charge one kernel that runs outside aten to the innermost tally active
    on this thread (dispatch modes are per thread); nothing when none is."""
    active = getattr(_local, "active", None)
    if active:
        active[-1]._charge(name, read_bytes, write_bytes, int_ops)


def repeated(times: int):
    """Context manager: charge what runs inside it ``times`` times to the
    innermost tally active on this thread (a loop whose iterations are the
    same ops on the same shapes, run once); nothing when none is active."""
    active = getattr(_local, "active", None)
    return active[-1]._repeat(times) if active else contextlib.nullcontext()


def _tensors(tree, out=None):
    """The tensors of nested lists, tuples and dicts, depth first."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast dimension, of
    stride 0, holds one)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _product_flops(func, args) -> int:
    """2 m k n of a product (batched: times the batch)."""
    a, b = (args[1], args[2]) if func in (_aten.addmm.default, _aten.baddbmm.default) else args[:2]
    return 2 * math.prod(a.shape) * b.shape[-1]


def _conv_flops(args, out) -> int:
    """2 x output elements x (input channels / groups x kernel elements)."""
    weight = args[1]
    return 2 * out.numel() * (weight.shape[1] * math.prod(weight.shape[2:]))


def _dtensor_type():
    """``DTensor`` (``None`` on a torch without ``torch.distributed``)."""
    global _DTENSOR
    if _DTENSOR is False:
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:
            DTensor = None
        _DTENSOR = DTensor
    return _DTENSOR


_DTENSOR = False


def _is_fake(tensors) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(type(t) is FakeTensor for t in tensors)


def _functional_ranks(group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(group_name))


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
        self.flops = 0
        self.bytes_by_op = {}
        self.collectives = CollectiveStats()
        self._live = {}  # storage address -> (weak ref, bytes)
        self._live_bytes = 0
        self._times = 1  # charges count this many times (:func:`repeated`)

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

    @contextlib.contextmanager
    def _repeat(self, times: int):
        saved, self._times = self._times, self._times * int(times)
        try:
            yield
        finally:
            self._times = saved

    def _charge(self, name: str, read: int, write: int, ops: int) -> None:
        n = self._times
        self.read_bytes += int(read) * n
        self.write_bytes += int(write) * n
        self.int_ops += int(ops) * n
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + (int(read) + int(write)) * n

    def _free_expired(self) -> None:
        for key, (ref, nbytes) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self._live_bytes -= nbytes

    def _allocate(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live, unless it already is. Frees are found
        lazily: only an allocation that would raise the peak scans for the
        storages freed since (the live bytes are an upper bound between
        scans, so the peak stays exact)."""
        storage = t.untyped_storage()
        ref = StorageWeakRef(storage)
        old = self._live.get(ref.cdata)
        if old is not None:
            if not old[0].expired():
                return
            del self._live[ref.cdata]  # a freed storage's address, reused
            self._live_bytes -= old[1]
        self._live[ref.cdata] = (ref, storage.nbytes())
        self._live_bytes += storage.nbytes()
        if self._live_bytes > self.peak_bytes:
            self._free_expired()
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _dtensor_type() is not None and any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented  # DTensor desugars it; its local ops come back
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # Under inference mode composite ops (matmul, einsum) arrive
            # whole; their decomposition runs with this mode pushed again,
            # so its ops come back here.
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            # DTensor views a local shard as it would view the whole tensor,
            # and a shard that a redistribution left with other strides
            # cannot always be viewed. On meta shards (no values) the view
            # is taken as a copy, which the tally charges.
            if func is not _aten.view.default or args[0].device.type != "meta":
                raise
            func, args = _aten.reshape.default, (args[0].contiguous(), args[1])
            out = func(*args)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _is_fake(ins) or _is_fake(outs):  # DTensor's shape propagation
            return out
        in_storages = {t.untyped_storage()._cdata for t in ins}
        new = [t for t in outs if t.untyped_storage()._cdata not in in_storages]
        for t in new:
            self._allocate(t)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        if func.namespace in ("_c10d_functional", "_dtensor"):
            self._functional(func, args)
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
        if func in _PRODUCTS:
            self.flops += _product_flops(func, args) * self._times
        elif func is _aten.convolution.default:
            self.flops += _conv_flops(args, outs[0]) * self._times
        return out

    def _functional(self, func, args) -> None:
        name = func._schema.name
        if name in _NO_WIRE:
            return
        kind = _FUNCTIONAL.get(name)
        if kind is None:
            raise NotImplementedError(f"Tally: no cost model for {name}")
        size = args[0].numel() * args[0].element_size()
        ranks = _functional_ranks(args[-1])
        if kind == "all-gather":  # priced by its result
            size *= len(ranks)
        self.collectives.add(kind, size, ranks, self._times)

    def _collective(self, func, args, kwargs) -> None:
        kind = _COLLECTIVES.get(func._schema.name)
        if kind is None:
            raise NotImplementedError(f"Tally: no cost model for {func._schema.name}")
        # allreduce_(tensors, ...) reduces in place; allgather_(outputs, inputs, ...)
        size = sum(t.numel() * t.element_size() for t in _tensors(args[0]))
        self.collectives.add(kind, size, _group_ranks(func, args, kwargs), self._times)
