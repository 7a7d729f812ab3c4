"""Small host constants on the device without a host sync."""
from __future__ import annotations

import torch


def const(data, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)`` without waiting
    for the device: a copy from pageable host memory to the card first
    synchronizes the stream, so each such constant in a forward would let
    the card run dry; one from pinned memory is asynchronous (PyTorch
    keeps the pinned block until the copy has run).  Under tracing
    (``torch.export``) the constant is a plain copy in the graph."""
    t = torch.tensor(data, dtype=dtype)
    if (torch.device(device).type == "cuda"
            and not torch.compiler.is_compiling()):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
