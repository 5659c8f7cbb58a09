"""Runtime utilities of the port: failure injection and retries."""
from repro_torch.runtime.fault import (
    FAULT_SITES,
    FailureInjector,
    FaultPlan,
    FaultSpec,
    InjectedFailure,
    run_with_retries,
)

__all__ = [
    "FailureInjector",
    "FaultPlan",
    "FaultSpec",
    "FAULT_SITES",
    "InjectedFailure",
    "run_with_retries",
]
