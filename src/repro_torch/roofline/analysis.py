"""Roofline terms of a traced k-core sweep on an H100 fleet: the counterpart
of ``repro.roofline.analysis``.

Three terms per device, all in seconds:

  compute    = int32 ops per device / hw.PEAK_INT32_OPS
               (an LM step, :func:`flop_roofline_terms`: FLOPs per device /
               hw.PEAK_FLOPS_BF16)
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
to count).

``active_params`` and ``model_flops`` are the LM dry-run's "useful work"
yardstick, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

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

    def add(self, kind: str, size: int, ranks: Sequence[int], times: int = 1) -> None:
        """``times`` collectives of ``kind`` over the group ``ranks`` (global
        ranks), ``size`` raw bytes each (the result of an all-gather, else
        the operand)."""
        wire = ring_wire_bytes(kind, size, len(ranks)) * times
        link = link_of(ranks)
        self.op_bytes[kind] = self.op_bytes.get(kind, 0) + int(size) * times
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + wire
        self.count[kind] = self.count.get(kind, 0) + times
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


@dataclasses.dataclass
class FlopRoofline:
    """The reference's ``Roofline`` of an LM step, on an H100 fleet."""

    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: Optional[float] = None
    useful_fraction: Optional[float] = None  # MODEL_FLOPS / (flops * chips)

    def as_dict(self):
        return dataclasses.asdict(self)


def flop_roofline_terms(flops_per_device: float, hbm_bytes: float, colls: CollectiveStats,
                        n_chips: int, model_flops: Optional[float] = None) -> FlopRoofline:
    """The three terms of one device's LM step: FLOPs at the tensor cores'
    dense bf16 rate, bytes at HBM's, each collective on its link
    (:meth:`CollectiveStats.seconds`)."""
    terms = {
        "compute": flops_per_device / hw.PEAK_FLOPS_BF16,
        "memory": hbm_bytes / hw.HBM_BW,
        "collective": colls.seconds(),
    }
    useful = None
    if model_flops:
        useful = model_flops / max(flops_per_device * n_chips, 1.0)
    return FlopRoofline(
        flops_per_device=flops_per_device,
        hbm_bytes_per_device=hbm_bytes,
        wire_bytes_per_device=colls.total_wire,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops_total=model_flops,
        useful_fraction=useful,
    )


# --------------------------------------------------------------------- #
# MODEL_FLOPS (the "useful work" yardstick)
# --------------------------------------------------------------------- #
def active_params(cfg) -> int:
    """Active parameters per token (MoE: top_k/n_experts of routed experts).

    Counted over the reference's leaves (a scanned slot is one leaf of all
    its layers), as the reference truncates each leaf's share to an int."""
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.model import CausalLM
    from repro_torch.models.module import SpecModule

    specs = {}
    for name, mod in CausalLM(cfg, device="meta").named_modules():
        if isinstance(mod, SpecModule):
            for pname, spec in mod.param_specs.items():
                specs[f"{name}.{pname}" if name else pname] = spec
    total = 0
    for leaf in reference_leaves(cfg):
        spec = specs[leaf.keys[0]]
        n = len(leaf.keys) if leaf.stacked else 1
        for d in spec.shape:
            n *= d
        if "experts" in (spec.axes or ()):  # routed expert weight
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


def model_flops(cfg, shape, total_params: int, act_params: int) -> float:
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * act_params * tokens
    if shape.kind == "prefill":
        return 2.0 * act_params * tokens
    # decode: one token per sequence
    return 2.0 * act_params * shape.global_batch
