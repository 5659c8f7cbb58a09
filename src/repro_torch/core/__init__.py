"""DC-kCore core: h-index ops, the conquer engine, divide, and the pipeline."""
from repro_torch.core.hindex import hindex_count, hindex_of_sequence, hindex_sorted
from repro_torch.core.decompose import DecomposeResult, decompose
from repro_torch.core.divide import (
    exact_candidates,
    plan_thresholds,
    rough_candidates,
    timed_candidates,
)
from repro_torch.core.dckcore import DCKCoreReport, PartReport, dc_kcore

__all__ = [
    "hindex_count",
    "hindex_of_sequence",
    "hindex_sorted",
    "DecomposeResult",
    "decompose",
    "exact_candidates",
    "plan_thresholds",
    "rough_candidates",
    "timed_candidates",
    "DCKCoreReport",
    "PartReport",
    "dc_kcore",
]
