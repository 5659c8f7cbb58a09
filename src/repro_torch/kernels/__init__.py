"""Hand-written CUDA kernels of the sweep, with their plain PyTorch versions.

* :mod:`repro_torch.kernels.fused` -- gather + h-index + dirty push per
  bucket (``engine="fused"``), from ``csrc/fused.cu``;
* :mod:`repro_torch.kernels.hindex` -- h-index over pre-gathered estimates
  (``engine="kernel"``), from ``csrc/hindex.cu``;
* :mod:`repro_torch.kernels.counts` -- per-slot-shard suffix counts of the
  distributed engine (``use_kernel=True``), from ``csrc/counts.cu``.

Each wrapper launches its kernel for CUDA tensors, by a launch plan
computed from the shapes, and runs the plain version for CPU tensors; the
plans and the one launch path all three take are in
:mod:`repro_torch.kernels.plan`. :mod:`repro_torch.kernels.build` compiles
the sources with ``nvcc`` at first use.
"""
