"""DC-kCore in PyTorch for NVIDIA Hopper: the port of the ``repro`` JAX package.

The batch pipeline on one device: :mod:`repro_torch.graph` builds and
bucketizes the CSR graph (numpy, byte-identical to the JAX package),
:func:`repro_torch.core.decompose` runs the h-index fixed point on a part
with the CUDA kernels of :mod:`repro_torch.kernels`, and
:func:`repro_torch.core.dc_kcore` runs the sequential divide / conquer /
merge loop. Nothing here imports JAX or the ``repro`` package.
"""
