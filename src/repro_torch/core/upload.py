"""Host-to-device upload of a part's arrays through a page-locked staging ring.

A pageable ``tensor.to("cuda")`` makes the host wait while CUDA
stages the bytes through its own small page-locked buffer, and runs far
below the host link. :func:`to_device` moves a large array through a ring
of :data:`RING_CHUNKS` page-locked host chunks of :data:`CHUNK_BYTES`
each instead. For each piece of the flat source, in turn:

  1. wait for the previous copy out of the piece's chunk (its event);
  2. fill the chunk with torch's CPU ``copy_`` (spread over the intra-op
     threads);
  3. enqueue the chunk's ``non_blocking`` copy to the device on the
     current stream and record the chunk's event there.

So the host fills chunk ``i + 1`` while the copy engine drains chunk
``i``. The ring is made on the first staged upload to a device and kept
for the process: it is staging memory and holds no data between calls.
One lock guards it, so threads that upload at once (part-parallel slices,
each on its own stream) take turns; a chunk's event is recorded on the
stream that enqueued its copy, and the host waits on it before the chunk is
filled again, whichever thread fills it.

Arrays under :data:`STAGE_MIN_BYTES`, and every array bound for a device
other than CUDA, take ``torch.as_tensor(a, dtype).to(device)``: on the CPU
the tensor shares the array's memory.

``to_device.staged_bytes`` and ``to_device.direct_bytes`` count the bytes
that took each path, under one lock.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

# Arrays below this take the direct copy. A pageable ``.to`` runs at a
# fifth of the ring's rate and waits for the stream to drain, which would
# stall the ring's copies queued before it, so even a part's row-id arrays
# (about a MiB each) go through the ring.
STAGE_MIN_BYTES = 256 << 10
CHUNK_BYTES = 32 << 20  # one piece of a staged upload
RING_CHUNKS = 4  # page-locked host memory per device: RING_CHUNKS * CHUNK_BYTES


def piece_plan(nbytes: int) -> List[Tuple[int, int, int]]:
    """The pieces of a staged upload of ``nbytes`` bytes: ``(start, stop,
    chunk)``, byte offsets into the flat source and the ring chunk that
    carries them, in order. Empty when the array takes the direct copy."""
    if nbytes < STAGE_MIN_BYTES:
        return []
    return [(start, min(start + CHUNK_BYTES, nbytes), i % RING_CHUNKS)
            for i, start in enumerate(range(0, nbytes, CHUNK_BYTES))]


class _Ring:
    """The page-locked chunks of one device and the event of each chunk's
    last copy out."""

    def __init__(self):
        self.chunks = torch.empty((RING_CHUNKS, CHUNK_BYTES), dtype=torch.uint8,
                                  pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(RING_CHUNKS)]
        self.lock = threading.Lock()

    def upload(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy the flat uint8 host tensor ``src`` into the flat uint8
        device tensor ``dst``, on the current stream of ``dst``'s device."""
        stream = torch.cuda.current_stream(dst.device)
        with self.lock:
            for start, stop, slot in piece_plan(src.numel()):
                chunk = self.chunks[slot, :stop - start]
                self.events[slot].synchronize()  # its last copy has left
                chunk.copy_(src[start:stop])
                dst[start:stop].copy_(chunk, non_blocking=True)
                self.events[slot].record(stream)


_RINGS: Dict[int, _Ring] = {}
_RINGS_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _ring(dev: torch.device) -> _Ring:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _RINGS_LOCK:
        if index not in _RINGS:
            _RINGS[index] = _Ring()
        return _RINGS[index]


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` (a numpy array or CPU tensor) as a ``dtype`` tensor on
    ``device``: staged through the device's ring when it is a CUDA device
    and the array has at least :data:`STAGE_MIN_BYTES` bytes, else
    ``torch.as_tensor(a, dtype=dtype).to(device)``."""
    src = torch.as_tensor(a, dtype=dtype)
    dev = torch.device(device)
    nbytes = src.numel() * src.element_size()
    if dev.type != "cuda" or not piece_plan(nbytes):
        with _COUNT_LOCK:
            to_device.direct_bytes += nbytes
        return src.to(dev)
    dst = torch.empty(src.shape, dtype=dtype, device=dev)
    _ring(dev).upload(src.contiguous().view(-1).view(torch.uint8),
                      dst.view(-1).view(torch.uint8))
    with _COUNT_LOCK:
        to_device.staged_bytes += nbytes
    return dst


to_device.staged_bytes = 0
to_device.direct_bytes = 0
