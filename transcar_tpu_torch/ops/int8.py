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

:func:`dynamic_int8_conv` calls three registered ops, the amax pass
(:data:`int8_amax`), the codes pass (:data:`int8_codes`) and the conv
(:data:`int8_conv`), so that ``torch.export`` traces an int8 model and
``FlopCounterMode`` counts it.  On a CPU tensor they run the plain
versions: the quantizers in float32 (a true division, round half to
even), the codes convolved as float64 by ``F.conv2d``, which is exact
(|sum| ≤ K·127² < 2⁵³), then int32 → float32 and the dequantize in JAX's
order.  On a CUDA tensor they launch the kernels of ``csrc/int8_conv.cu``
or raise.

The kernels replace no TPU kernel: the JAX package computes this
convolution in XLA (``transcar_tpu/ops/int8.py:48``,
``lax.conv_general_dilated`` with ``preferred_element_type=int32``, the
dequantize fused by XLA into the following BN and ReLU).  They exist
because PyTorch has no int8 convolution on CUDA.

ConvBN's epilogue.  The conv takes FrozenBN's folded ``(scale, bias)``
and the ReLU flag, and repeats the module's eager roundings, so the
result is bit for bit ``relu(bn(dequant))`` (:func:`plain_int8_convbn`):
``t = o(float(acc) · (s_x · s_w[c]))``, ``u = o(t · o(scale[c]))``,
``v = o(u + o(bias[c]))``, ``max(v, 0)``, ``o()`` the rounding to the
output dtype.  Where the output feeds the next int8 conv, the epilogue
also returns ``max |out|`` (``want_amax``), and the next conv's quantize
runs its codes pass only (``amax``).  A ``Bottleneck`` quantizes its
input once for ``conv1`` and ``downsample`` (``codes``).

What bounds them on the H100.  The convolution: 2·M·Cout·K integer
operations at 1,979 dense int8 TOPS against the int8 codes read once and
the output written once at 3.35 TB/s, a balance of ~590 operations a
byte.  A 1×1 conv of 256 → 1024 channels (R101 stage 3) does ~128 a byte
(bfloat16 out) and is bound by its bytes; a 3×3 conv of 224 channels
does ~1,300 and is bound by its operations.  The quantize passes are
bound by their bytes: the amax pass reads the activation, the codes pass
reads it again and writes one byte an element.

What the design does about it.  Convs with Cin % 16 == 0 and Cout % 8 ==
0 (every conv of the two presets but the stems) run on the persistent
``wgmma`` body of ``csrc/osa_wgmma.cuh`` instantiated for s8: a TMA ring
of 128-channel K slices, ``wgmma`` m64nNk32 s8 with int32 accumulators,
one slice's products in flight while the next slice is awaited, the
epilogue of one tile overlapping the next tile's loads.  The Cout tile
is the whole Cout up to 128; above it a multiple of 128 takes staged
128-wide tiles (the 1×1 convs bound by their output bytes, which leave
in TMA stores from shared memory), and 160, 192 and 224 (VoVNet's 3×3
chain) one tile of the whole Cout, so each pixel tile's gathered codes
are read once.  Stride 2 reads the input through one tensor map per tap
parity.  The stems (Cin ≤ 4) run on a second tile (``mma.sync`` m16n8k32
s8 over a ``cp.async`` ring) with the same epilogue: their image is
quantized into 4-channel codes (:func:`code_channels`) and their weight
laid out with each kernel row padded to 4 taps, so the tile gathers 4
adjacent pixels at once (K = 224 for the 7×7; on the ``wgmma`` tile a
stem's codes padded to 16 channels fill a 128-channel slice a tap, K =
6,272).  The choice goes by shape only (:func:`takes_wgmma`), and a
conv that neither tile takes raises.  The standalone amax is one launch
(its last block publishes the max and resets the scratch pair it met
in, so no memset precedes it), the codes pass another; both read 16
bytes at a time, four loads in flight a thread.  ``s_x`` stays on the
device, so an int8 request makes no host sync.  The weight's K-major
codes ([Cout, Kp], Kp a multiple of 64, zero past K) and scales are
computed once per weight version by :func:`prepare_weight` and cached
by the model, as the K-major weights of K1, K4 and K6 are.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib

#: int8 convolution kernel launches since the count was last set to 0.
launches = 0
#: Of those, the launches on the ``wgmma`` tile (:func:`takes_wgmma`).
wgmma_launches = 0
#: Activation codes passes on the card (one a quantized activation).
quantize_launches = 0
#: Standalone amax passes on the card: a codes pass whose activation came
#: without an amax from a conv epilogue runs one first.
amax_launches = 0

_EPS = 1e-8
#: The kernel's K step: the weight codes are zero-padded to a multiple.
K_STEP = 64
#: A stem's codes channels (:func:`code_channels`).
QUAD = 4
KERNEL_SIZES = (1, 3, 7)
STRIDES = (1, 2)
_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = (_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, *([_I] * 12), _P)


class QuantWeight(NamedTuple):
    """A weight's codes [Cout, Cin, kh, kw] int8, its scales [Cout]
    float32, and on the card its K-major codes [Cout, Kp] (else None)."""
    q: torch.Tensor
    scale: torch.Tensor
    kmajor: Optional[torch.Tensor]


def quantize_per_tensor(x: torch.Tensor, amax: Optional[torch.Tensor] = None,
                        channels: Optional[int] = None):
    """Symmetric per-tensor int8 quantization: (codes int8 in ``x``'s
    layout, scale float32 0-d).  ``s = max(max|x|, 1e-8) / 127``,
    ``q = clip(round(x / s), -127, 127)``, in float32.  ``amax`` is
    ``max|x|`` where the caller has it (a conv epilogue's); then only the
    codes pass (:data:`int8_codes`) runs, else the amax pass
    (:data:`int8_amax`) runs first.  ``channels`` = 4 writes a stem's
    4-channel codes (:func:`code_channels`; the card's conv reads them).
    The ops run their plain versions on a CPU tensor and launch the
    quantize kernels on a CUDA tensor, or raise."""
    if amax is None:
        amax = int8_amax(x)
    return int8_codes(x, amax, x.shape[1] if channels is None else channels)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true float32 division.  The divisor
    is a tensor on ``amax``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, an ulp off at times."""
    m = torch.clamp(amax, min=_EPS)
    return m / torch.full_like(m, 127.0)


def plain_amax(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` in float32, a 0-d tensor: the amax pass's plain version."""
    return x.float().abs().amax()


def plain_quantize_per_tensor(x: torch.Tensor,
                              amax: Optional[torch.Tensor] = None):
    """The quantize pass's plain version (see :func:`quantize_per_tensor`);
    given ``amax``, the codes pass's alone."""
    xf = x.float()
    s = _scale(plain_amax(x) if amax is None else amax.float())
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def plain_codes(x: torch.Tensor, amax: torch.Tensor, channels: int):
    """The codes pass's plain version: :func:`plain_quantize_per_tensor`
    from ``amax``, a stem's codes widened to ``channels`` (zero codes, in
    channels-last memory) as the card writes them."""
    q, s = plain_quantize_per_tensor(x, amax)
    if channels != x.shape[1]:
        _check_quad(x, channels)
        q = F.pad(q, (0, 0, 0, 0, 0, channels - x.shape[1])).contiguous(
            memory_format=torch.channels_last)
    return q, s


def quantize_weight_per_channel(weight: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW kernel:
    (codes int8, scales [Cout] float32), the max over all but dim 0."""
    wf = weight.float()
    s = _scale(wf.abs().amax(dim=tuple(range(1, wf.ndim))))
    shape = (-1,) + (1,) * (wf.ndim - 1)
    q = torch.clamp(torch.round(wf / s.view(shape)), -127, 127)
    return q.to(torch.int8), s


def code_channels(cin: int) -> int:
    """Channels of a conv's activation codes on the card: a stem's image
    (Cin ≤ 4) is quantized into 4 channels, those past Cin zero codes, so
    that its tile gathers 4-byte pixels; any other Cin as it is."""
    return max(cin, QUAD)


def kmajor_codes(q: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: OIHW codes as [Cout, Kp] int8 with k =
    (ky·kw + kx)·Cin + ci, zero past K = kh·kw·Cin, Kp a multiple of
    :data:`K_STEP`.  A stem's (Cin ≤ 4) is laid out for its 4-channel
    codes, each kernel row padded to a multiple of 4 taps: k = (ky·kwp +
    kx)·4 + ci, kwp = kw rounded up to 4, zero where ci ≥ Cin or kx ≥
    kw."""
    cout, cin, _, kw = q.shape
    if cin <= QUAD:
        q = F.pad(q, (0, -kw % QUAD, 0, 0, 0, QUAD - cin))
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


def plain_int8_convbn(xq, s_x, wq, s_w, stride: int = 1, padding: int = 0,
                      dilation: int = 1, out_dtype=torch.float32,
                      affine=None, relu: bool = False):
    """The fused epilogue's plain version: :func:`plain_int8_conv`, then
    FrozenBN's ``y · scale + bias`` with both cast to ``out_dtype`` (two
    ops, two roundings, as ``models/common.FrozenBN`` computes it) where
    ``affine`` is given, then ReLU where ``relu``."""
    y = plain_int8_conv(xq, s_x, wq, s_w, stride, padding, dilation,
                        out_dtype)
    if affine is not None:
        scale, bias = affine
        shape = (1, -1, 1, 1)
        y = y * scale.to(y.dtype).view(shape) + bias.to(y.dtype).view(shape)
    return F.relu(y) if relu else y


def dynamic_int8_conv(x: torch.Tensor, weight: torch.Tensor, *,
                      stride: int = 1, padding: int = 0, dilation: int = 1,
                      out_dtype=None,
                      weight_q: Optional[QuantWeight] = None,
                      affine=None, relu: bool = False, codes=None,
                      amax: Optional[torch.Tensor] = None,
                      want_amax: bool = False):
    """``dequant(conv_int8(quant(x), quant(weight)))``: x [N, Cin, H, W]
    (channels-last memory on the card), weight [Cout, Cin, kh, kw] float;
    returns [N, Cout, Ho, Wo] in ``out_dtype`` (default ``x.dtype``).
    ``weight_q`` is :func:`prepare_weight` of ``weight``, when the caller
    caches it (the numbers are those of quantizing at every call).

    ConvBN's epilogue: ``affine`` (FrozenBN's folded float32 ``(scale,
    bias)``) and ``relu`` are applied as :func:`plain_int8_convbn` applies
    them.  ``codes`` is :func:`quantize_per_tensor` of ``x`` where the
    caller already has it (one quantize for two convs of one input);
    ``amax`` is ``max|x|`` where a producing epilogue took it.  With
    ``want_amax`` the result is ``(out, max|out|)``, the max a 0-d float32
    tensor on ``x``'s device."""
    out_dtype = out_dtype or x.dtype
    if weight_q is None:
        weight_q = prepare_weight(weight)
    if codes is None:
        codes = quantize_per_tensor(
            x, amax, code_channels(weight_q.q.shape[1]) if x.is_cuda else None)
    xq, s_x = codes
    scale, bias = affine if affine is not None else (None, None)
    out, out_amax = int8_conv(xq, s_x, weight_q.q, weight_q.scale,
                              weight_q.kmajor, stride, padding, dilation,
                              out_dtype, scale, bias, relu, want_amax)
    return (out, out_amax) if want_amax else out


def _channels_last(x: torch.Tensor) -> bool:
    return x.dim() == 4 and x.permute(0, 2, 3, 1).is_contiguous()


def _scratch(device: torch.device) -> torch.Tensor:
    """The int32 scratch pair of the amax reductions on ``device``'s
    current stream (:func:`kernel_lib.zeroed_scratch`): left zero by every
    launch that uses it (its last block resets it), so no launch needs a
    memset first."""
    return kernel_lib.zeroed_scratch(device, 2)


def _check_activation(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: the tensor must be on a CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if not (x.is_contiguous() or _channels_last(x)):
        raise ValueError(f"{name}: the tensor must be dense (contiguous or "
                         f"channels-last)")


def _check_quad(x: torch.Tensor, channels: int) -> None:
    if (channels != QUAD or x.dim() != 4 or x.shape[1] >= QUAD
            or not _channels_last(x)):
        raise ValueError(f"int8 quantize kernel: codes of {channels} "
                         f"channels are written for a channels-last image of "
                         f"fewer than {QUAD}, not {tuple(x.shape)}")


def amax_kernel(x: torch.Tensor) -> torch.Tensor:
    """The amax pass on a CUDA tensor (float32 or bfloat16, dense in NCHW
    or channels-last memory): ``max|x|`` as a 0-d float32 device tensor,
    never read on the host; one launch."""
    global amax_launches
    _check_activation(x, "int8 amax kernel")
    amax = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernel_lib.function("int8_amax", _P, _I, ctypes.c_longlong, _P,
                                 _P, _P)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
            amax.data_ptr(), _scratch(x.device).data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check(rc, "int8_amax")
    amax_launches += 1
    return amax


def codes_kernel(x: torch.Tensor, amax: torch.Tensor,
                 channels: Optional[int] = None):
    """The codes pass on a CUDA tensor (as :func:`amax_kernel`) from its
    ``amax`` (a float32 device scalar): codes in ``x``'s layout and the
    scale as a 0-d device tensor; one launch.  ``channels`` = 4 for a
    channels-last x of fewer channels (a stem's image,
    :func:`code_channels`) writes 4-channel codes [N, 4, H, W] in
    channels-last memory, the added channels zero codes."""
    global quantize_launches
    _check_activation(x, "int8 quantize kernel")
    if (amax.device != x.device or amax.dtype != torch.float32
            or amax.numel() != 1):
        raise ValueError("int8 quantize kernel: amax must be a float32 "
                         "scalar on the tensor's device")
    quad = channels is not None and channels != x.shape[1]
    if quad:
        _check_quad(x, channels)
        n, _, h, w = x.shape
        q = torch.empty((n, h, w, QUAD), dtype=torch.int8,
                        device=x.device).permute(0, 3, 1, 2)
    else:
        q = torch.empty_like(x, dtype=torch.int8)
    s = torch.empty((), dtype=torch.float32, device=x.device)
    x_bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if quad:
            name = "int8_codes_quad"
            rc = kernel_lib.function(name, _P, _I, ctypes.c_longlong, _I, _P,
                                     _P, _P, _P)(
                x.data_ptr(), x_bf16, x.numel() // x.shape[1], x.shape[1],
                amax.data_ptr(), q.data_ptr(), s.data_ptr(), stream)
        else:
            name = "int8_codes"
            rc = kernel_lib.function(name, _P, _I, ctypes.c_longlong, _P, _P,
                                     _P, _P)(
                x.data_ptr(), x_bf16, x.numel(), amax.data_ptr(),
                q.data_ptr(), s.data_ptr(), stream)
    kernel_lib.check(rc, name)
    quantize_launches += 1
    return q, s


def quantize_kernel(x: torch.Tensor, amax: Optional[torch.Tensor] = None,
                    channels: Optional[int] = None):
    """The quantize passes on a CUDA tensor, as the model runs them: the
    amax pass (:func:`amax_kernel`) unless ``amax`` is given, then the
    codes pass (:func:`codes_kernel`)."""
    if amax is None:
        amax = amax_kernel(x)
    return codes_kernel(x, amax, channels)


def takes_wgmma(cin: int, cout: int) -> bool:
    """Whether a conv runs on the ``wgmma`` tile: Cin % 16 == 0 and Cout %
    8 == 0, every conv of the two int8 presets but the stems (Cin = 3),
    which run on the ``mma.sync`` tile (Cin ≤ 4).  By shape only."""
    return cin % 16 == 0 and cout % 8 == 0


def _affine_ok(t, cout: int, dev) -> bool:
    return (t.dtype == torch.float32 and tuple(t.shape) == (cout,)
            and t.is_contiguous() and t.device == dev)


def conv_kernel(xq: torch.Tensor, s_x: torch.Tensor, weight_q: QuantWeight,
                stride: int = 1, padding: int = 0, dilation: int = 1,
                out_dtype=torch.bfloat16, affine=None, relu: bool = False,
                want_amax: bool = False):
    """The int8 convolution kernel on CUDA tensors: xq [N, Cin, H, W] int8
    codes in channels-last memory, ``s_x`` a device scalar, ``weight_q``
    with its K-major codes; ``affine`` (float32 [Cout] scale and bias) and
    ``relu`` as in :func:`dynamic_int8_conv`.  Returns [N, Cout, Ho, Wo] in
    channels-last memory, and with ``want_amax`` its ``max|out|`` as a 0-d
    float32 device tensor beside it.  Takes square kernels of 1, 3 or 7,
    strides 1 and 2, any padding and dilation 1, Cin ≤ 4 or Cin % 16 == 0
    and Cout % 8 == 0 (:func:`takes_wgmma`), and raises on anything
    else."""
    global launches, wgmma_launches
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
    wgmma = takes_wgmma(cin, cout)
    if not wgmma and cin > QUAD:
        raise ValueError(f"int8 conv kernel: {cin} -> {cout} channels (takes "
                         f"Cin <= {QUAD}, or Cin % 16 == 0 and Cout % 8 == 0)")
    dev = xq.device
    if not xq.is_cuda or any(t is None or t.device != dev
                             for t in (s_x, s_w, wk)):
        raise ValueError("int8 conv kernel: codes, scales and K-major weight "
                         "codes must be on one CUDA device")
    cq = code_channels(cin)
    if xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[1] != cq:
        raise ValueError(f"int8 conv kernel: codes {tuple(xq.shape)} "
                         f"{xq.dtype} do not match the weight's Cin {cin} "
                         f"({cq} code channels: see code_channels)")
    if not _channels_last(xq):
        raise ValueError("int8 conv kernel: the activation must be in "
                         "channels-last memory (NHWC)")
    kwp = -(-kw // QUAD) * QUAD if cin <= QUAD else kw
    kp = -(-kh * kwp * cq // K_STEP) * K_STEP
    if (wk.dtype != torch.int8 or tuple(wk.shape) != (cout, kp)
            or not wk.is_contiguous() or s_w.dtype != torch.float32
            or tuple(s_w.shape) != (cout,) or not s_w.is_contiguous()
            or s_x.dtype != torch.float32 or s_x.numel() != 1):
        raise ValueError("int8 conv kernel: the weight codes must be "
                         f"[{cout}, {kp}] int8 and the scales float32 "
                         "(see prepare_weight)")
    if affine is not None and not all(_affine_ok(t, cout, dev)
                                      for t in affine):
        raise ValueError(f"int8 conv kernel: the affine must be two float32 "
                         f"[{cout}] contiguous tensors on the codes' device")
    n, _, h, w = xq.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv kernel: empty output {ho}x{wo}")
    if wgmma and any(t.data_ptr() % 16 for t in (xq, wk)):
        raise ValueError("int8 conv kernel: the wgmma tile takes 16-byte "
                         "aligned codes")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    amax = (torch.empty((), dtype=torch.float32, device=dev) if want_amax
            else None)
    name = "int8_conv_wgmma" if wgmma else "int8_conv_mma"
    scale, bias = affine if affine is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = kernel_lib.function(name, *_CONV_ARGS)
    with torch.cuda.device(dev):
        rc = fn(xq.data_ptr(), wk.data_ptr(), s_x.data_ptr(),
                s_w.data_ptr(), ptr(scale), ptr(bias), int(relu),
                out.data_ptr(), int(out_dtype == torch.bfloat16), ptr(amax),
                _scratch(dev).data_ptr() if want_amax else None, n, h, w,
                cq, cout, kh, kw, stride, padding, ho, wo, kp,
                torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(rc, name)
    launches += 1
    wgmma_launches += wgmma
    out = out.permute(0, 3, 1, 2)
    return (out, amax) if want_amax else out


def _no_amax(like: torch.Tensor) -> torch.Tensor:
    """What :data:`int8_conv` returns for the amax without ``want_amax``:
    an empty [0] float32 tensor (no bytes, no launch)."""
    return like.new_empty((0,), dtype=torch.float32)


def _affine_pair(scale, bias):
    if (scale is None) != (bias is None):
        raise ValueError("int8 conv: the affine takes both a scale and a "
                         "bias, or neither")
    return None if scale is None else (scale, bias)


def _conv_cuda(xq, s_x, wq, s_w, wk, stride, padding, dilation, out_dtype,
               scale, bias, relu, want_amax):
    out = conv_kernel(xq, s_x, QuantWeight(wq, s_w, wk), stride, padding,
                      dilation, out_dtype, _affine_pair(scale, bias), relu,
                      want_amax)
    return out if want_amax else (out, _no_amax(out))


def _conv_cpu(xq, s_x, wq, s_w, wk, stride, padding, dilation, out_dtype,
              scale, bias, relu, want_amax):
    out = plain_int8_convbn(xq, s_x, wq, s_w, stride, padding, dilation,
                            out_dtype, _affine_pair(scale, bias), relu)
    # the card's layout, which the fake gives (a no-op for the model's
    # channels-last activations)
    out = out.contiguous(memory_format=torch.channels_last)
    return out, plain_amax(out) if want_amax else _no_amax(out)


def _conv_fake(xq, s_x, wq, s_w, wk, stride, padding, dilation, out_dtype,
               scale, bias, relu, want_amax):
    n, _, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    out = xq.new_empty((n, ho, wo, cout), dtype=out_dtype).permute(0, 3, 1, 2)
    return out, (xq.new_empty((), dtype=torch.float32) if want_amax
                 else _no_amax(xq))


def _codes_fake(x, amax, channels):
    if channels != x.shape[1]:
        n, _, h, w = x.shape
        q = x.new_empty((n, h, w, channels), dtype=torch.int8).permute(
            0, 3, 1, 2)
    else:
        q = torch.empty_like(x, dtype=torch.int8)
    return q, x.new_empty((), dtype=torch.float32)


#: The amax pass as a registered op, ``torch.ops.transcar.int8_amax(x)``:
#: :func:`amax_kernel` on CUDA, :func:`plain_amax` on the CPU; a 0-d float32
#: result.  The scratch pair the kernel meets in stays inside it.
int8_amax = kernel_lib.register_op(
    "int8_amax(Tensor x) -> Tensor",
    cuda=lambda x: amax_kernel(x), cpu=lambda x: plain_amax(x),
    fake=lambda x: x.new_empty((), dtype=torch.float32))

#: The codes pass as a registered op, ``torch.ops.transcar.int8_codes(x,
#: amax, channels)`` → (codes, scale): :func:`codes_kernel` on CUDA
#: (``int8_codes``, or ``int8_codes_quad`` where ``channels`` exceeds x's),
#: :func:`plain_codes` on the CPU; the codes in x's layout (a stem's in
#: channels-last memory), the scale 0-d float32.
int8_codes = kernel_lib.register_op(
    "int8_codes(Tensor x, Tensor amax, int channels) -> (Tensor, Tensor)",
    cuda=lambda *a: codes_kernel(*a), cpu=lambda *a: plain_codes(*a),
    fake=_codes_fake)

#: The int8 convolution as a registered op, ``torch.ops.transcar.int8_conv(
#: xq, s_x, wq, s_w, wk, stride, padding, dilation, out_dtype, scale, bias,
#: relu, want_amax)`` → (out, amax): :func:`conv_kernel` on CUDA (``wk`` the
#: K-major codes of :func:`prepare_weight`), :func:`plain_int8_convbn` on the
#: CPU (``wk`` unused).  ``scale`` / ``bias`` are FrozenBN's folded affine or
#: None; out is [N, Cout, Ho, Wo] in channels-last memory, amax its 0-d
#: float32 ``max|out|`` with ``want_amax`` and an empty [0] tensor without.
int8_conv = kernel_lib.register_op(
    "int8_conv(Tensor xq, Tensor s_x, Tensor wq, Tensor s_w, Tensor? wk, "
    "int stride, int padding, int dilation, ScalarType out_dtype, "
    "Tensor? scale, Tensor? bias, bool relu, bool want_amax) -> "
    "(Tensor, Tensor)",
    cuda=lambda *a: _conv_cuda(*a), cpu=lambda *a: _conv_cpu(*a),
    fake=_conv_fake)


@register_flop_formula(torch.ops.transcar.int8_conv)
def _int8_conv_flops(xq_shape, sx_shape, wq_shape, *args, out_shape=None,
                     **kwargs) -> float:
    n, _, ho, wo = out_shape[0]
    cout, cin, kh, kw = wq_shape
    return counts.int8_conv(n, ho, wo, cin, cout, kh, kw)
