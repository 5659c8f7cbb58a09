"""Runtime of the port: the training loop, failure injection and retries,
and the greedy serving loop of the LM harness."""
from repro_torch.runtime.train_loop import TrainLoop, make_train_step
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
    "TrainLoop",
    "make_train_step",
    "FailureInjector",
    "FaultPlan",
    "FaultSpec",
    "FAULT_SITES",
    "InjectedFailure",
    "run_with_retries",
    "greedy_generate",
]
