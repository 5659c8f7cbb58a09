"""Roofline terms of a traced k-core sweep on an H100 fleet: the counterpart
of ``repro.roofline.analysis``.

Three terms per device, all in seconds:

  compute    = int32 ops per device / hw.PEAK_INT32_OPS
  memory     = bytes read and written per device / hw.HBM_BW
  collective = sum over the collectives of wire bytes / the op's link rate

The reference reads the first two from XLA's ``cost_analysis()`` of the
compiled sweep and prices them at the TPU's bf16 rate; here
:class:`repro_torch.roofline.tally.Tally` counts them from the ops of one
traced sweep, and the compares are int32 ops on the CUDA cores (as in
:func:`repro_torch.roofline.kcore_model.roofline_time_s`). Each collective
is priced on its own link: NVLink when its group lies inside one aligned
block of ``hw.NVLINK_DOMAIN`` ranks (one node), the node's InfiniBand port
otherwise. The wire bytes follow the ring model of :func:`ring_wire_bytes`,
with ``n`` the size of the op's process group.

Not ported: ``split_computations``, ``loop_multipliers``, ``_shape_bytes``
and the HLO regexes read XLA's optimized HLO text, and PyTorch has no HLO
(the tally sees each collective as the host calls it, so there is no loop
to count). ``active_params`` and ``model_flops`` belong to the LM harness
and come with it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch.roofline import hw

def ring_wire_bytes(kind: str, size: int, n: int) -> int:
    """Per-rank bytes a ring moves for one collective over ``n`` ranks:

      all-gather          (n-1)/n * result bytes
      reduce-scatter      (n-1)/n * size
      all-reduce          2 (n-1)/n * operand bytes
      all-to-all          (n-1)/n * operand bytes
      collective-permute  operand bytes

    in integer arithmetic (exact where ``n`` divides the product, as it
    does for an all-gather's result)."""
    if kind == "collective-permute":
        return int(size)
    if n <= 1:
        return 0
    if kind == "all-reduce":
        return 2 * (n - 1) * int(size) // n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) * int(size) // n
    raise ValueError(f"unknown collective kind {kind!r}")


def link_of(ranks: Sequence[int]) -> str:
    """``"nvlink"`` when every rank lies in one aligned block of
    ``hw.NVLINK_DOMAIN`` ranks, else ``"ib"``."""
    return "nvlink" if len({int(r) // hw.NVLINK_DOMAIN for r in ranks}) <= 1 else "ib"


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)  # kind -> raw bytes
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)  # kind -> ring bytes per rank
    count: Dict[str, int] = dataclasses.field(default_factory=dict)
    link_wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)  # link -> ring bytes

    def add(self, kind: str, size: int, ranks: Sequence[int]) -> None:
        """One collective of ``kind`` over the group ``ranks`` (global ranks),
        ``size`` raw bytes (the result of an all-gather, else the operand)."""
        wire = ring_wire_bytes(kind, size, len(ranks))
        link = link_of(ranks)
        self.op_bytes[kind] = self.op_bytes.get(kind, 0) + int(size)
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + wire
        self.count[kind] = self.count.get(kind, 0) + 1
        self.link_wire_bytes[link] = self.link_wire_bytes.get(link, 0) + wire

    @property
    def total_wire(self) -> int:
        return sum(self.wire_bytes.values())

    def seconds(self) -> float:
        """Wire time per rank, each link at its one-way rate."""
        rate = {"nvlink": hw.NVLINK_BW, "ib": hw.IB_BW}
        return sum(b / rate[link] for link, b in self.link_wire_bytes.items())


@dataclasses.dataclass
class Roofline:
    int_ops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(int_ops: float, hbm_bytes: float, colls: CollectiveStats) -> Roofline:
    """The three terms of one device's sweep and the largest of them."""
    terms = {
        "compute": int_ops / hw.PEAK_INT32_OPS,
        "memory": hbm_bytes / hw.HBM_BW,
        "collective": colls.seconds(),
    }
    return Roofline(
        int_ops_per_device=int_ops,
        hbm_bytes_per_device=hbm_bytes,
        wire_bytes_per_device=colls.total_wire,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
    )
