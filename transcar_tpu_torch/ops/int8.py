"""Dynamic int8 convolution, the int8 serving mode
(``model.backbone.quantize=int8``; ``transcar_tpu/ops/int8.py``).

Symmetric per-output-channel weight scales and a symmetric dynamic
per-tensor activation scale, int8 × int8 summed exactly in int32, then
``float(acc) · (s_x · s_w[c])`` rounded once to the output dtype.  An
accuracy-for-speed serving mode (about 1% error a conv), never a parity
path and never used in training (``build_model`` forces it off).

Layouts are the port's: activations NCHW tensors in channels-last
memory, weights OIHW.  The public functions take the JAX package's
arguments (``stride``, ``padding``, ``dilation``, ``out_dtype``).

On a CPU tensor :func:`dynamic_int8_conv` runs the plain version: the
quantizers in float32 (a true division, round half to even), the codes
convolved as float64 by ``F.conv2d``, which is exact (|sum| ≤ K·127² <
2⁵³), then int32 → float32 and the dequantize in JAX's order.  On a CUDA
tensor it launches the kernels of ``csrc/int8_conv.cu`` or raises.

The kernels replace no TPU kernel: the JAX package computes this
convolution in XLA (``transcar_tpu/ops/int8.py:48``,
``lax.conv_general_dilated`` with ``preferred_element_type=int32``).  They
exist because PyTorch has no int8 convolution on CUDA.

What bounds them on the H100.  The convolution: 2·M·Cout·K integer
operations at 1,979 dense int8 TOPS against the int8 codes read once and
the output written once at 3.35 TB/s, a balance of ~590 operations a
byte.  A 1×1 conv of 64 → 256 channels (R101 stage 1) does ~57 a byte
(bfloat16 out) and is bound by its bytes; a 3×3 conv of 224 channels
does ~1,300 and is bound by its operations.  The quantize pass reads the
activation twice (amax, then the codes) and writes one byte an element:
bound by its bytes.

What the design does about it.  The first version is simple: an implicit
GEMM (M = N·Ho·Wo pixels, N = Cout, K = kh·kw·Cin) of ``mma.sync``
m16n8k32 s8 products over a 3-stage ``cp.async`` ring, 16-byte gathers of
the NHWC codes with zero fill at the image edge (the stem's Cin = 3 is
gathered byte by byte), the dequantize in the epilogue with ``s_x`` read
from device memory, so an int8 request makes no host sync.  The weight's
K-major codes ([Cout, Kp], Kp a multiple of 64, zero past K) and scales
are computed once per weight version by :func:`prepare_weight` and
cached by the model, as the K-major weights of K1, K4 and K6 are.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from transcar_tpu_torch.ops import kernel_lib

#: int8 convolution kernel launches since the count was last set to 0.
launches = 0
#: Activation quantize passes on the card (amax, then codes: two kernels).
quantize_launches = 0

_EPS = 1e-8
#: The kernel's K step: the weight codes are zero-padded to a multiple.
K_STEP = 64
KERNEL_SIZES = (1, 3, 7)
STRIDES = (1, 2)
_P, _I = ctypes.c_void_p, ctypes.c_int


class QuantWeight(NamedTuple):
    """A weight's codes [Cout, Cin, kh, kw] int8, its scales [Cout]
    float32, and on the card its K-major codes [Cout, Kp] (else None)."""
    q: torch.Tensor
    scale: torch.Tensor
    kmajor: Optional[torch.Tensor]


def quantize_per_tensor(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (codes int8 in ``x``'s
    layout, scale float32 0-d).  ``s = max(max|x|, 1e-8) / 127``,
    ``q = clip(round(x / s), -127, 127)``, in float32.  A CPU tensor takes
    :func:`plain_quantize_per_tensor`; a CUDA tensor launches the quantize
    kernels or raises."""
    if x.device.type == "cpu":
        return plain_quantize_per_tensor(x)
    return quantize_kernel(x)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true float32 division.  The divisor
    is a tensor on ``amax``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, an ulp off at times."""
    m = torch.clamp(amax, min=_EPS)
    return m / torch.full_like(m, 127.0)


def plain_quantize_per_tensor(x: torch.Tensor):
    """The quantize pass's plain version (see :func:`quantize_per_tensor`)."""
    xf = x.float()
    s = _scale(xf.abs().amax())
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quantize_weight_per_channel(weight: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW kernel:
    (codes int8, scales [Cout] float32), the max over all but dim 0."""
    wf = weight.float()
    s = _scale(wf.abs().amax(dim=tuple(range(1, wf.ndim))))
    shape = (-1,) + (1,) * (wf.ndim - 1)
    q = torch.clamp(torch.round(wf / s.view(shape)), -127, 127)
    return q.to(torch.int8), s


def kmajor_codes(q: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: OIHW codes as [Cout, Kp] int8 with k =
    (ky·kw + kx)·Cin + ci, zero past K = kh·kw·Cin, Kp a multiple of
    :data:`K_STEP`."""
    cout = q.shape[0]
    flat = q.permute(0, 2, 3, 1).reshape(cout, -1)
    k = flat.shape[1]
    out = torch.zeros((cout, -(-k // K_STEP) * K_STEP), dtype=torch.int8,
                      device=q.device)
    out[:, :k] = flat
    return out


def prepare_weight(weight: torch.Tensor) -> QuantWeight:
    """:func:`quantize_weight_per_channel` of ``weight`` and, on the card,
    its :func:`kmajor_codes`: what a model caches per weight version."""
    q, s = quantize_weight_per_channel(weight)
    return QuantWeight(q, s.contiguous(),
                       kmajor_codes(q) if weight.is_cuda else None)


def plain_int8_conv(xq, s_x, wq, s_w, stride: int = 1, padding: int = 0,
                    dilation: int = 1, out_dtype=torch.float32):
    """The convolution's plain version on codes: float64 ``F.conv2d``
    (exact), int32, float32, times ``s_x · s_w``, one rounding to
    ``out_dtype``."""
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding,
                   dilation=dilation)
    acc = acc.to(torch.int32).to(torch.float32)
    return (acc * (s_x * s_w).view(1, -1, 1, 1)).to(out_dtype)


def dynamic_int8_conv(x: torch.Tensor, weight: torch.Tensor, *,
                      stride: int = 1, padding: int = 0, dilation: int = 1,
                      out_dtype=None,
                      weight_q: Optional[QuantWeight] = None) -> torch.Tensor:
    """``dequant(conv_int8(quant(x), quant(weight)))``: x [N, Cin, H, W]
    (channels-last memory on the card), weight [Cout, Cin, kh, kw] float;
    returns [N, Cout, Ho, Wo] in ``out_dtype`` (default ``x.dtype``).
    ``weight_q`` is :func:`prepare_weight` of ``weight``, when the caller
    caches it (the numbers are those of quantizing at every call)."""
    out_dtype = out_dtype or x.dtype
    if weight_q is None:
        weight_q = prepare_weight(weight)
    if x.device.type == "cpu":
        xq, s_x = plain_quantize_per_tensor(x)
        return plain_int8_conv(xq, s_x, weight_q.q, weight_q.scale, stride,
                               padding, dilation, out_dtype)
    xq, s_x = quantize_kernel(x)
    return conv_kernel(xq, s_x, weight_q, stride, padding, dilation,
                       out_dtype)


def _channels_last(x: torch.Tensor) -> bool:
    return x.dim() == 4 and x.permute(0, 2, 3, 1).is_contiguous()


def quantize_kernel(x: torch.Tensor):
    """The quantize pass on a CUDA tensor (float32 or bfloat16, dense in
    NCHW or channels-last memory): codes in ``x``'s layout and the scale
    as a 0-d device tensor, never read on the host."""
    global quantize_launches
    if not x.is_cuda:
        raise ValueError("int8 quantize kernel: the tensor must be on a CUDA "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 quantize kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not (x.is_contiguous() or _channels_last(x)):
        raise ValueError("int8 quantize kernel: the tensor must be dense "
                         "(contiguous or channels-last)")
    q = torch.empty_like(x, dtype=torch.int8)
    buf = torch.empty(2, dtype=torch.float32, device=x.device)  # s, amax
    fn = kernel_lib.function("int8_quantize", _P, _I, ctypes.c_longlong, _P,
                             _P, _P, _P)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
                buf[1].data_ptr(), q.data_ptr(), buf.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(rc, "int8_quantize")
    quantize_launches += 1
    return q, buf[0]


def conv_kernel(xq: torch.Tensor, s_x: torch.Tensor, weight_q: QuantWeight,
                stride: int = 1, padding: int = 0, dilation: int = 1,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 convolution kernel on CUDA tensors: xq [N, Cin, H, W] int8
    codes in channels-last memory, ``s_x`` a device scalar, ``weight_q``
    with its K-major codes; returns [N, Cout, Ho, Wo] in channels-last
    memory.  Takes square kernels of 1, 3 or 7, strides 1 and 2, any
    padding and dilation 1, and raises on anything else."""
    global launches
    q, s_w, wk = weight_q
    cout, cin, kh, kw = q.shape
    if dilation != 1:
        raise ValueError(f"int8 conv kernel: dilation {dilation} (only 1)")
    if kh != kw or kh not in KERNEL_SIZES or stride not in STRIDES:
        raise ValueError(f"int8 conv kernel: a {kh}x{kw} kernel at stride "
                         f"{stride} (takes square {KERNEL_SIZES}, strides "
                         f"{STRIDES})")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 conv kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    dev = xq.device
    if not xq.is_cuda or any(t is None or t.device != dev
                             for t in (s_x, s_w, wk)):
        raise ValueError("int8 conv kernel: codes, scales and K-major weight "
                         "codes must be on one CUDA device")
    if xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[1] != cin:
        raise ValueError(f"int8 conv kernel: codes {tuple(xq.shape)} "
                         f"{xq.dtype} do not match the weight's Cin {cin}")
    if not _channels_last(xq):
        raise ValueError("int8 conv kernel: the activation must be in "
                         "channels-last memory (NHWC)")
    kp = -(-kh * kw * cin // K_STEP) * K_STEP
    if (wk.dtype != torch.int8 or tuple(wk.shape) != (cout, kp)
            or not wk.is_contiguous() or s_w.dtype != torch.float32
            or tuple(s_w.shape) != (cout,) or not s_w.is_contiguous()
            or s_x.dtype != torch.float32 or s_x.numel() != 1):
        raise ValueError("int8 conv kernel: the weight codes must be "
                         f"[{cout}, {kp}] int8 and the scales float32 "
                         "(see prepare_weight)")
    n, _, h, w = xq.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv kernel: empty output {ho}x{wo}")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    fn = kernel_lib.function("int8_conv", _P, _P, _P, _P, _P, *([_I] * 13),
                             _P)
    with torch.cuda.device(dev):
        rc = fn(xq.data_ptr(), wk.data_ptr(), s_x.data_ptr(),
                s_w.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), n, h, w, cin, cout, kh, kw,
                stride, padding, ho, wo, kp,
                torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(rc, "int8_conv")
    launches += 1
    return out.permute(0, 3, 1, 2)
