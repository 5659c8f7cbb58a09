"""Runtime utilities of the port: failure injection and retries, and the
greedy serving loop of the LM harness."""
from repro_torch.runtime.fault import (
    FAULT_SITES,
    FailureInjector,
    FaultPlan,
    FaultSpec,
    InjectedFailure,
    run_with_retries,
)
from repro_torch.runtime.serve_loop import greedy_generate

__all__ = [
    "FailureInjector",
    "FaultPlan",
    "FaultSpec",
    "FAULT_SITES",
    "InjectedFailure",
    "run_with_retries",
    "greedy_generate",
]
