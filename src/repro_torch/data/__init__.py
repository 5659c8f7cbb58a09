"""Token sources of the LM harness (copies of the JAX package's ``data/``)."""
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.data.loader import MemmapTokens, Prefetcher

__all__ = ["SyntheticTokens", "MemmapTokens", "Prefetcher"]
