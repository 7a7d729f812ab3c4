"""DCNv2 forward kernel for Hopper (``csrc/dcn_forward.cu``).

Replaces ``transcar_tpu/ops/pallas_dcn.py::fused_deform_conv`` (the
Pallas TPU kernels ``_kernel`` / ``_kernel_onedot``, reached through
``fused_deform_conv_ad``): 3×3, stride 1, pad 1, dilation 1, zero-padded
bilinear taps × σ(mask) and the fused 9·Cin → Cout contraction.

What bounds it on the H100: the flagship runs it 26 times a request
(23× [6, 58, 100, 256] → 256, 3× [6, 29, 50, 512] → 512), about 1.07 TFLOP
a sample, so it is tensor-core bound once the bilinear gather keeps up;
the gather reads 4 corners × 9 taps per pixel, about 36× the input, which
stays in the 50 MB L2 (the largest input is 17.8 MB in bf16).

What the design does about it: an implicit GEMM over M = N·H·W pixels,
N = Cout and K = 9·Cin.  A block owns a 64-pixel × 128-channel output
tile.  It first computes, once per (pixel, tap) in float32, the four
corner addresses (−1 outside the image) and their bilinear weights with
σ(mask) folded in.  Then for each 32-wide K slice it gathers the corners
with 16-byte loads, writes the modulated sample (rounded to the working
type, as ``pallas_dcn.py`` rounds ``sampled``) into a shared-memory A
tile, stages the weight slice as the B tile and multiplies on the tensor
cores (``nvcuda::wmma`` bf16 16×16×16, fp32 accumulate; float32 inputs
take a CUDA-core FMA loop instead, so the float32 path has no TF32).
The sampled [pixels, 9·Cin] matrix never reaches device memory.  The
TPU kernel's row band, one-hot matmuls and ``rows_per_step`` were Mosaic
workarounds and are gone: the result is exact for any offset.
"""
from __future__ import annotations

import ctypes

import torch

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.dcn import modulated_deform_conv

#: Kernel launches since the count was last set to 0.
launches = 0

_ENTRY = {torch.bfloat16: "dcn_forward_bf16", torch.float32: "dcn_forward_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def fused_deform_conv(x: torch.Tensor, offset_mask: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """DCNv2, 3×3 / stride 1 / pad 1 / dilation 1, exact for any offset.

    Args:
      x: [N, H, W, Cin] (bfloat16 or float32).
      offset_mask: [N, H, W, 27] raw conv_offset output, same dtype as x
        (mmcv layout: ch 2k = Δy_k, 2k+1 = Δx_k, 18+k = mask logit).
      weight: [3, 3, Cin, Cout]; cast to x.dtype.
    Returns:
      [N, H, W, Cout] in x.dtype.

    A CPU tensor takes the plain version (``ops/dcn.py``); a CUDA tensor
    launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return modulated_deform_conv(x, offset_mask, weight.to(x.dtype))
    global launches
    n, h, w, cin = x.shape
    cout = weight.shape[-1]
    if x.dtype not in _ENTRY:
        raise TypeError(f"dcn kernel takes bfloat16 or float32, not {x.dtype}")
    if offset_mask.shape != (n, h, w, 27) or offset_mask.dtype != x.dtype:
        raise ValueError(f"offset_mask {tuple(offset_mask.shape)} "
                         f"{offset_mask.dtype} must be [{n}, {h}, {w}, 27] "
                         f"{x.dtype}")
    if weight.shape != (3, 3, cin, cout):
        raise ValueError(f"weight {tuple(weight.shape)} must be "
                         f"[3, 3, {cin}, Cout]")
    if cin % 32 or cout % 8:
        raise ValueError(f"dcn kernel needs Cin % 32 == 0 and Cout % 8 == 0,"
                         f" got Cin={cin}, Cout={cout}")
    if not (x.is_cuda and offset_mask.device == x.device
            and weight.device == x.device):
        raise ValueError("dcn kernel: all tensors must be on one CUDA device")
    x = x.contiguous()
    offset_mask = offset_mask.contiguous()
    weight = weight.to(x.dtype).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("dcn kernel needs 16-byte aligned x and weight")
    fn = kernel_lib.function(_ENTRY[x.dtype], _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), offset_mask.data_ptr(), weight.data_ptr(),
                out.data_ptr(), n, h, w, cin, cout, stream)
    kernel_lib.check(rc, _ENTRY[x.dtype])
    launches += 1
    return out
