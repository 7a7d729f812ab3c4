"""Tensor ops: plain PyTorch versions and the CUDA kernel wrappers.

Importing the package registers the serving kernels as ``torch.library``
ops (``torch.ops.transcar.dcn_forward``, ``masked_attention``,
``osa_reduce``, ``msdeform_forward``), which a program exported by
``cli/export.py`` calls."""
from transcar_tpu_torch.ops import (pallas_attention, pallas_dcn,  # noqa: F401
                                    pallas_msdeform, pallas_osa)
