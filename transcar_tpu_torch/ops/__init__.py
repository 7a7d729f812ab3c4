"""Tensor ops: plain PyTorch versions and the CUDA kernel wrappers.

Importing the package registers the serving kernels as ``torch.library``
ops (``torch.ops.transcar.dcn_forward``, ``masked_attention``,
``osa_reduce``, ``msdeform_forward``; the opt-in ``osa_block`` (K5) and
``bottleneck`` (K6); int8 serving's ``int8_amax``, ``int8_codes`` and
``int8_conv``), which a program exported by ``cli/export.py`` calls."""
from transcar_tpu_torch.ops import (int8, pallas_attention,  # noqa: F401
                                    pallas_bottleneck, pallas_dcn,
                                    pallas_msdeform, pallas_osa,
                                    pallas_osa_block)
