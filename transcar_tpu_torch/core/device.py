"""Small host constants on the device without a host sync, and the
deterministic mode every entry point sets on the card."""
from __future__ import annotations

import os

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


#: cuBLAS's deterministic workspace settings (CUDA's documented pair); any
#: other value, or none, lets cuBLAS split a product by its free streams.
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def set_deterministic(device) -> bool:
    """Put this process in PyTorch's deterministic mode for a model on
    ``device``, once, before it touches the card: the same weights, batch
    and generator state then give the same bits run after run, as the
    JAX package's XLA programs do (its TPU kernels sum in a fixed order,
    and so do the port's).  On a CUDA device:

    * ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless a deterministic value is
      set already (cuBLAS reads it when it makes its first workspace);
    * ``torch.use_deterministic_algorithms(True)``, without ``warn_only``:
      an op with no deterministic implementation raises on the card;
    * ``torch.backends.cudnn.deterministic = True`` and ``benchmark =
      False``;
    * ``torch.utils.deterministic.fill_uninitialized_memory = False``:
      every buffer the port reads it has written first, so the fill would
      only add a pass over each new tensor.

    On the CPU it changes nothing, so that tests sharing a process do not
    pass the mode to each other.  Returns whether it set the mode."""
    if torch.device(device).type != "cuda":
        return False
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC[0]
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.utils.deterministic.fill_uninitialized_memory = False
    return True
