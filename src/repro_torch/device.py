"""Device selection of the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The entry points default to ``"cuda"``. Without a usable GPU that is an
    error, never a quiet move to the CPU: the CPU runs only when the caller
    asks for it (``device="cpu"``), as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU"
        )
    return dev
