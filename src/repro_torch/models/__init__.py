"""The LM side of the harness in PyTorch: the JAX package's ``models/``
(dense, MoE, SSM, hybrid, cross-attention and enc-dec architectures with KV
and SSM caches), plus the carry of its parameters (:mod:`.convert`)."""
from repro_torch.models.convert import from_reference
from repro_torch.models.model import CausalLM, ce_loss, loss_fn
from repro_torch.models.module import ParamSpec, SpecModule, count_params, init_params

__all__ = [
    "CausalLM",
    "ParamSpec",
    "SpecModule",
    "ce_loss",
    "count_params",
    "from_reference",
    "init_params",
    "loss_fn",
]
