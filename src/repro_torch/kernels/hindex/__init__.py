"""h-index kernel (``csrc/hindex.cu``) and its plain PyTorch version."""
from repro_torch.kernels.hindex.ops import hindex_op, hindex_plain

__all__ = ["hindex_op", "hindex_plain"]
