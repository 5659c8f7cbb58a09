"""NVIDIA H100 SXM constants (the target card of the PyTorch port).

Published figures (NVIDIA H100 data sheet and Hopper architecture white
paper, SXM part, full 700 W power limit):

* 80 GB of HBM3 at 3.35 TB/s;
* 132 streaming multiprocessors (SMs);
* 989 TFLOP/s dense bf16 on the tensor cores.

The k-core sweep does no tensor-core math. Its operations are int32
compares and adds, and on Hopper those run on the CUDA cores: each SM has
64 INT32 lanes (4 sub-partitions of 16), each retiring one int32 op per
clock. The INT32 rate is therefore

    INT32_OPS = SMS * INT32_LANES_PER_SM * sm_clock_hz
              = 132 * 64 * 1.98e9 = 16.73e12 ops/s

at the 1,980 MHz maximum SM clock of the SXM part. A card capped below
700 W may clock lower under load; :func:`int32_ops_per_s` recomputes the
rate from the SM count and the clock read on the card (``nvidia-smi
--query-gpu=clocks.max.sm``).

The fleet's links, for the collective term of the dry-run's roofline
(data-sheet constants, not measurements):

* NVLink 4 at 900 GB/s per GPU, 450 GB/s each way, among the 8 GPUs of one
  node (H100 SXM data sheet; the HGX H100 8-GPU board joins them all to
  all through NVSwitch);
* one 400 Gb/s NDR InfiniBand port per GPU, 50 GB/s each way, between
  nodes (DGX H100: eight ConnectX-7 ports for its eight GPUs).

A ring moves each of its wire bytes once in one direction, so a link is
priced at its one-way rate.
"""

HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80 * 10**9
PEAK_FLOPS_BF16 = 989e12  # dense, tensor cores
SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9  # maximum SM clock of the SXM part


def int32_ops_per_s(sms: int = SMS, sm_clock_hz: float = SM_CLOCK_HZ) -> float:
    """CUDA-core int32 op rate: SMs x INT32 lanes per SM x SM clock."""
    return float(sms) * INT32_LANES_PER_SM * float(sm_clock_hz)


PEAK_INT32_OPS = int32_ops_per_s()

NVLINK_BW = 450e9  # bytes/s each way per GPU (NVLink 4, 900 GB/s both ways)
NVLINK_DOMAIN = 8  # GPUs one NVLink switch fabric joins (one HGX node)
IB_BW = 50e9  # bytes/s each way per GPU (one 400 Gb/s NDR port)
