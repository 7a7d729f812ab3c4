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

The backward, K3 (``csrc/dcn_backward.cu``), replaces
``transcar_tpu/ops/pallas_dcn.py::_fused_dcn_bwd_impl`` (the Pallas
``_bwd_kernel``, the custom VJP of ``fused_deform_conv_ad``).  It returns
d_x, d_offset_mask and d_W, all accumulated in float32.  What bounds it:
two GEMMs as large as the forward's, d_samp = d_out × W9ᵀ and
d_W = sampledᵀ × d_out (2 × 41 GFLOP per layer-3 launch), so it is
tensor-core bound; its compulsory traffic (x, offset_mask, W, d_out in,
d_x, d_offset_mask, d_W out) is about 60 MB per layer-3 launch in bf16.
What the design does about it: two kernels, each a ``wgmma`` tile on
``csrc/hopper_tile.cuh`` in bfloat16 (the path ``detr3d_r101`` trains).
(a) d_samp = d_out × W9ᵀ with its scatter: a block owns a band of 128
pixels (64 where Cout > 256) and a group of taps; its d_out band arrives
once by TMA and stays in shared memory while the W9 slices [64 channels,
64 Cout] stream through a 4-stage ring.  Consumer warpgroups form each
[band, 64-channel] d_samp tile in float32 and hand it to a double-buffered
shared tile; two scatter warpgroups rebuild each pixel's four bilinear
corners, add σ(mask)·weight·d_samp into a float32 d_x with 16-byte vector
reductions and reduce the offset and mask terms over the channels with
warp shuffles (one-sided floor-convention derivatives, so an integer
sample position differentiates as ``ops/dcn.py`` under autograd does),
while the consumers multiply the next slice.  (b) d_W = sampledᵀ × d_out
over the pixels: two gather warpgroups write the modulated sample,
rounded to the working type as the forward rounds it, straight into the
swizzled shared layout that ``wgmma`` reads as a transposed A, d_out
arrives by TMA as a transposed B, and pixel splits add their float32
tiles with vector reductions.  float32 (used only by the checks) and
bfloat16 with Cout > 1024 keep the first kernels: per tap and 128-channel
slice a ``wmma`` d_samp tile and a 4-warp scatter, and a 32-pixel
regather against d_out.  The summation order of the atomics varies from
run to run.  The band, one-hot matmuls and ``rows_per_step`` of the TPU
kernel are gone: exact for any offset.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.dcn import modulated_deform_conv

#: K1 (forward) launches since the count was last set to 0.
launches = 0
#: K3 (backward) launches since the count was last set to 0.
backward_launches = 0

_ENTRY = {torch.bfloat16: "dcn_forward_bf16", torch.float32: "dcn_forward_f32"}
_BWD_DATA = {torch.bfloat16: "dcn_backward_data_bf16",
             torch.float32: "dcn_backward_data_f32"}
_BWD_WEIGHT = {torch.bfloat16: "dcn_backward_weight_bf16",
               torch.float32: "dcn_backward_weight_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def fused_deform_conv(x: torch.Tensor, offset_mask: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """DCNv2, 3×3 / stride 1 / pad 1 / dilation 1, exact for any offset,
    differentiable in all three inputs.

    Args:
      x: [N, H, W, Cin] (bfloat16 or float32).
      offset_mask: [N, H, W, 27] raw conv_offset output, same dtype as x
        (mmcv layout: ch 2k = Δy_k, 2k+1 = Δx_k, 18+k = mask logit).
      weight: [3, 3, Cin, Cout], any float dtype (the float32 parameter):
        cast to x.dtype for the product, and its gradient comes back in
        its own dtype, accumulated in float32.
    Returns:
      [N, H, W, Cout] in x.dtype.

    A CPU tensor takes the plain version (``ops/dcn.py`` under autograd);
    a CUDA tensor launches K1 forward and K3 backward, or raises.
    """
    if x.device.type == "cpu":
        return modulated_deform_conv(x, offset_mask, weight.to(x.dtype))
    return FusedDeformConvFunction.apply(x, offset_mask, weight)


class FusedDeformConvFunction(torch.autograd.Function):
    """K1 forward, K3 backward (the custom VJP of the JAX package's
    ``fused_deform_conv_ad``)."""

    @staticmethod
    def forward(ctx, x, offset_mask, weight):
        x, offset_mask = x.contiguous(), offset_mask.contiguous()
        ctx.save_for_backward(x, offset_mask, weight)
        return forward_kernel(x, offset_mask, weight)

    @staticmethod
    def backward(ctx, d_out):
        return backward_kernel(*ctx.saved_tensors, d_out)


def _check(x, offset_mask, weight) -> None:
    """Raise on what the kernels do not take."""
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


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("dcn kernel needs 16-byte aligned tensors")


def forward_kernel(x: torch.Tensor, offset_mask: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors (see :func:`fused_deform_conv`)."""
    global launches
    _check(x, offset_mask, weight)
    n, h, w, cin = x.shape
    cout = weight.shape[-1]
    x = x.contiguous()
    offset_mask = offset_mask.contiguous()
    weight = weight.to(x.dtype).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    _aligned(x, weight)
    fn = kernel_lib.function(_ENTRY[x.dtype], _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), offset_mask.data_ptr(), weight.data_ptr(),
                out.data_ptr(), n, h, w, cin, cout, stream)
    kernel_lib.check(rc, _ENTRY[x.dtype])
    launches += 1
    return out


def backward_kernel(x: torch.Tensor, offset_mask: torch.Tensor,
                    weight: torch.Tensor, d_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: (d_x, d_offset_mask, d_weight) of
    :func:`fused_deform_conv` for the output gradient ``d_out``.

    d_out is taken in x.dtype and made contiguous NHWC; d_x comes back
    contiguous NHWC in x.dtype (the layout of the forward's NHWC view of
    a channels-last tensor), d_offset_mask in its dtype and d_weight in
    the weight's dtype.
    """
    global backward_launches
    _check(x, offset_mask, weight)
    n, h, w, cin = x.shape
    cout = weight.shape[-1]
    x = x.contiguous()
    offset_mask = offset_mask.contiguous()
    w_t = weight.to(x.dtype).contiguous()
    d_out = d_out.to(x.dtype).contiguous()
    if d_out.shape != (n, h, w, cout):
        raise ValueError(f"d_out {tuple(d_out.shape)} must be "
                         f"[{n}, {h}, {w}, {cout}]")
    d_x = torch.zeros((n, h, w, cin), dtype=torch.float32, device=x.device)
    d_om = torch.empty_like(offset_mask)
    d_w = torch.zeros((9 * cin, cout), dtype=torch.float32, device=x.device)
    _aligned(x, w_t, d_out, d_x, d_w)
    backward_data(x, offset_mask, w_t, d_out, d_x, d_om)
    backward_weight(x, offset_mask, d_out, d_w)
    backward_launches += 1
    return (d_x.to(x.dtype), d_om,
            d_w.reshape(3, 3, cin, cout).to(weight.dtype))


def backward_data(x, offset_mask, w_t, d_out, d_x, d_om) -> None:
    """K3's first device kernel, (a): adds d_x into the zeroed float32
    ``d_x`` and writes ``d_om``, on tensors :func:`backward_kernel` has
    checked and laid out (``w_t`` [3, 3, Cin, Cout] in x.dtype).  Counts
    no launch: :func:`backward_kernel` counts the backward once."""
    n, h, w, cin = x.shape
    name = _BWD_DATA[x.dtype]
    fn = kernel_lib.function(name, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), offset_mask.data_ptr(), w_t.data_ptr(),
                d_out.data_ptr(), d_x.data_ptr(), d_om.data_ptr(),
                n, h, w, cin, d_out.shape[-1], stream)
    kernel_lib.check(rc, name)


def backward_weight(x, offset_mask, d_out, d_w) -> None:
    """K3's second device kernel, (b): adds d_W into the zeroed float32
    ``d_w`` [9·Cin, Cout] (see :func:`backward_data`)."""
    n, h, w, cin = x.shape
    name = _BWD_WEIGHT[x.dtype]
    fn = kernel_lib.function(name, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), offset_mask.data_ptr(), d_out.data_ptr(),
                d_w.data_ptr(), n, h, w, cin, d_out.shape[-1], stream)
    kernel_lib.check(rc, name)


def plain_backward(x: torch.Tensor, offset_mask: torch.Tensor,
                   weight: torch.Tensor, d_out: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's plain version: autograd through ``ops/dcn.py`` (the CPU path
    of :func:`fused_deform_conv`), on any device."""
    with torch.enable_grad():
        xs, oms, ws = (t.detach().requires_grad_()
                       for t in (x, offset_mask, weight))
        out = modulated_deform_conv(xs, oms, ws.to(x.dtype))
        return torch.autograd.grad(out, (xs, oms, ws), d_out)
