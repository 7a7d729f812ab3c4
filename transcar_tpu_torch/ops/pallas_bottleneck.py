"""Fused ResNet bottleneck kernel for Hopper (``csrc/bottleneck.cu``, K6).

Replaces ``transcar_tpu/ops/pallas_bottleneck.py::bottleneck_fused`` (the
Pallas TPU ``_kernel``): a stride-1 caffe bottleneck,
``relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1 x))))))) + identity)``
with the identity either x or ``bnd(convd x)``.  The TPU's VMEM gate
``_pick_rows`` is gone: every stride-1 non-DCN block takes the kernel.

What bounds it on the H100: on ``transcar_r101`` with
``block_impl=fused`` it runs 6 times a request (``layer1_0..2`` at
232 × 400, ``layer2_1..3`` at 116 × 200), 0.470 TFLOP against 2.35 GB
of compulsory traffic (one read of x, one write of the output), so its
bound is the memory's (about 0.7 ms).

What the design does about it, for now: three launches a call.  conv1
(1×1) and conv2 (3×3) each apply their affine and ReLU in float32 and
write their output rounded to the activation dtype (the TPU kernel rounds
them there too); conv3 adds the residual in float32 and applies the ReLU
in its epilogue.  So h1 and h2 make a round trip through device memory
(about 1.3 GB a request on top of the compulsory 2.35); keeping conv1's
halo tile and conv2's tile on chip, one kernel per tile, is the next step.

bfloat16 calls with Cin, Cm and Cout multiples of 8 and a 16-byte aligned
x (:func:`takes_wgmma_tile`: every R101 and R50 bottleneck) take the
Hopper tile of ``csrc/osa_wgmma.cuh``, the persistent ``wgmma`` kernel fed
by TMA that K4 and K5 run, in K6's own instantiations: conv1 is its
reduce form with one piece and no channel sums; conv2 its 3×3 form (K5's
chain conv: the zero fill of a 4-D TMA box is the padding); conv3 its
reduce form on a 128-wide Cout tile with a residual epilogue.  The
identity is read as bfloat16 at the output's own addresses, the loads
issued before the tile's multiply so that they land while it runs.  The
downsample of ``layer1_0`` is a second piece of conv3 that the tile runs
into its own float32 accumulator (two m64n128 accumulators, 128 registers
a consumer thread; the reason for the 128-wide tile) and scales by its own
affine (sd, bd) before the add, as the TPU kernel does.  The other way,
the downsample product written once in float32 and read back as the
residual, moves about 1.1 GB more a request and costs a fourth launch
(``chip_smoke.py --variants k6`` times a bfloat16 stand-in of it, which
moves half those bytes).  sd is not folded into the weight: that would
change the bfloat16 rounding of the weight, not just the order of the
sums.  The weights are read K-major, [Cm, Cin], [Cm, 3, 3, Cm], [Cout, Cm]
and [Cout, Cin] in bfloat16 (:func:`kmajor_weights`), the 1×1 conv
parameters' own layout: ``models/resnet.Bottleneck`` caches them per
parameter version, and a call without them builds them; copies that are
given but not in that layout, dtype and device raise, so that a broken
cache cannot add copy kernels to every call.  Each call counts in
:data:`launches` and in :data:`wgmma_launches`.

float32 calls (the checks) and bfloat16 calls outside those shapes take
the implicit-GEMM tile of ``csrc/conv_tile.cuh`` (``wmma`` or CUDA-core
FMAs, ``cp.async`` double buffering): conv3 runs the downsample product
in a second float32 accumulator there too.  Any Cm works, including the
Cm = 512 of ResNet-50 layer 4.  Nothing falls back on failure: a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib
from transcar_tpu_torch.ops.pallas_osa import check_forward_only
from transcar_tpu_torch.ops.pallas_osa_block import (conv3x3_affine_relu,
                                                     kmajor_conv_weight)

#: K6 launches (calls, each of 3 device kernels) since the count was last
#: set to 0.
launches = 0
#: Of those, the calls that took the Hopper (wgmma) tile.
wgmma_launches = 0

_ENTRY = {torch.bfloat16: "bottleneck_bf16", torch.float32: "bottleneck_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
Affine = Tuple[torch.Tensor, torch.Tensor]


def _mat(w: torch.Tensor) -> torch.Tensor:
    """A 1×1 kernel [1, 1, I, O] or [I, O] as [I, O]."""
    return w.reshape(w.shape[-2], w.shape[-1])


def _dense_affine(x2d, w, affine, dtype):
    """x2d @ w of the dtype-rounded values with float32 accumulation, then
    the affine in float32."""
    acc = x2d.float() @ _mat(w).to(dtype).float()
    return acc * affine[0].float() + affine[1].float()


def plain_bottleneck(x: torch.Tensor, w1, aff1: Affine, w2, aff2: Affine,
                     w3, aff3: Affine, wd=None, affd: Optional[Affine] = None
                     ) -> torch.Tensor:
    """K6's plain version: h1 and h2 rounded to x's dtype, conv3's and the
    downsample's affines on float32 accumulators, the identity added in
    float32 before the last ReLU, one rounding of the output."""
    n, h, w, cin = x.shape
    dtype = x.dtype
    x2d = x.reshape(-1, cin)
    h1 = torch.relu(_dense_affine(x2d, w1, aff1, dtype)).to(dtype)
    h1 = h1.reshape(n, h, w, -1)
    h2 = conv3x3_affine_relu(h1, w2, aff2).to(dtype)
    h3 = _dense_affine(h2.reshape(n * h * w, -1), w3, aff3, dtype)
    ident = (x2d.float() if wd is None
             else _dense_affine(x2d, wd, affd, dtype))
    return torch.relu(h3 + ident).to(dtype).reshape(n, h, w, -1)


def bottleneck_fused(x: torch.Tensor, w1, aff1: Affine, w2, aff2: Affine,
                     w3, aff3: Affine, wd=None, affd: Optional[Affine] = None,
                     rows_per_chunk: Optional[int] = None,
                     kmajor: Optional[tuple] = None) -> torch.Tensor:
    """Fused stride-1 bottleneck.

    Args:
      x: [N, H, W, Cin] (bfloat16 or float32).
      w1: [1, 1, Cin, Cm] or [Cin, Cm]; w2: [3, 3, Cm, Cm]; w3: [1, 1, Cm,
        Cout] or [Cm, Cout]; wd: optional [1, 1, Cin, Cout] or [Cin, Cout]
        downsample (without it Cin must equal Cout); any float dtype.
      aff1, aff2, aff3, affd: ([C] scale, [C] bias) folded FrozenBN.
      rows_per_chunk: the TPU kernel's row chunking; ignored.
      kmajor: optional :func:`kmajor_weights` of the kernels in x's dtype
        (cached copies) for the Hopper tile, which builds them when they
        are absent and raises when they do not have the layout, dtype and
        device it reads; the other tile ignores them.
    Returns: [N, H, W, Cout] in x's dtype.

    It calls the registered op :data:`bottleneck`: a CPU tensor takes
    :func:`plain_bottleneck`, a CUDA tensor launches K6 or raises.
    """
    del rows_per_chunk
    affs = [t for a in (aff1, aff2, aff3, affd) if a is not None for t in a]
    check_forward_only("bottleneck_fused", x, w1, w2, w3, wd, *affs)
    affd = affd if wd is not None else (None, None)
    return bottleneck(x, w1, *aff1, w2, *aff2, w3, *aff3, wd, *affd,
                      [k for k in kmajor or () if k is not None])


def _split(args):
    """The op's arguments as :func:`kernel` takes them."""
    (x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd, kmajor) = args
    if wd is not None and (sd is None or bd is None):
        raise ValueError("bottleneck: a downsample needs its affine")
    ks = (*kmajor, None)[:4] if kmajor else None
    return (x, w1, (s1, b1), w2, (s2, b2), w3, (s3, b3), wd,
            None if wd is None else (sd, bd), ks)


def _bottleneck_fake(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd,
                     kmajor):
    return x.new_empty((*x.shape[:3], w3.shape[-1]))


#: K6 as a registered op, ``torch.ops.transcar.bottleneck(x, w1, s1, b1, w2,
#: s2, b2, w3, s3, b3, wd, sd, bd, kmajor)``: :func:`kernel` on CUDA (its
#: three launches), :func:`plain_bottleneck` on the CPU; each affine comes
#: as its scale and bias, the downsample and its affine are None without
#: one, and ``kmajor`` lists the :func:`kmajor_weights` that are not None
#: (empty where the caller has none); its fake gives the contiguous [N, H,
#: W, Cout] output.
bottleneck = kernel_lib.register_op(
    "bottleneck(Tensor x, Tensor w1, Tensor s1, Tensor b1, Tensor w2, "
    "Tensor s2, Tensor b2, Tensor w3, Tensor s3, Tensor b3, Tensor? wd, "
    "Tensor? sd, Tensor? bd, Tensor[] kmajor) -> Tensor",
    cuda=lambda *a: kernel(*_split(a)),
    cpu=lambda *a: plain_bottleneck(*_split(a)[:-1]),
    fake=_bottleneck_fake)


@register_flop_formula(torch.ops.transcar.bottleneck)
def _bottleneck_flops(x_shape, w1_shape, s1, b1, w2_shape, s2, b2, w3_shape,
                      s3, b3, wd_shape, *args, out_shape=None,
                      **kwargs) -> float:
    n, h, w, cin = x_shape
    return counts.bottleneck(n, h, w, cin, w2_shape[-1], w3_shape[-1],
                             wd_shape is not None)


def kmajor_weights(w1, w2, w3, wd=None, dtype=torch.bfloat16) -> tuple:
    """The Hopper tile's K-major copies of the JAX-layout kernels, in
    ``dtype``, contiguous: w1 [Cin, Cm] → [Cm, Cin], w2 [3, 3, Cm, Cm] →
    [Cm, 3, 3, Cm], w3 [Cm, Cout] → [Cout, Cm], wd [Cin, Cout] → [Cout,
    Cin] (None without a downsample).  For a conv parameter, whose layout
    [Cout, Cin, kh, kw] these are views of, each is one cast."""
    mat = lambda w: _mat(w).t().to(dtype).contiguous()
    return (mat(w1), kmajor_conv_weight(w2, dtype), mat(w3),
            None if wd is None else mat(wd))


def takes_wgmma_tile(x: torch.Tensor, cm: int, cout: int) -> bool:
    """Whether a call takes the Hopper tile: bfloat16 with Cin, Cm and Cout
    multiples of 8 and a 16-byte aligned x (h1, h2 and the output are
    allocated aligned)."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and cm % 8 == 0 and cout % 8 == 0 and x.data_ptr() % 16 == 0)


def _usable(got, want_shape, dtype, dev) -> bool:
    return (got is not None and tuple(got.shape) == tuple(want_shape)
            and got.dtype == dtype and got.device == dev
            and got.is_contiguous() and got.data_ptr() % 16 == 0)


def _stream(dev) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def conv1_kernel(x, w1k, s1, b1) -> torch.Tensor:
    """conv1 on the Hopper tile: ``relu(x @ w1k.T · s1 + b1)`` rounded to
    bfloat16, x [N, H, W, Cin] and w1k [Cm, Cin] contiguous bfloat16, s1 /
    b1 [Cm] float32."""
    n, h, w, cin = x.shape
    cm = w1k.shape[0]
    h1 = torch.empty((n, h, w, cm), dtype=x.dtype, device=x.device)
    name = "bottleneck_conv1_bf16_wgmma"
    fn = kernel_lib.function(name, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P)
    kernel_lib.check(fn(x.data_ptr(), cin, w1k.data_ptr(), s1.data_ptr(),
                        b1.data_ptr(), h1.data_ptr(), n, h, w, cm,
                        _stream(x.device)), name)
    return h1


def conv2_kernel(h1, w2k, s2, b2) -> torch.Tensor:
    """conv2 on the Hopper tile: ``relu(conv3x3(h1) · s2 + b2)`` rounded to
    bfloat16, h1 [N, H, W, Cm] and w2k [Cm, 3, 3, Cm] contiguous bfloat16."""
    n, h, w, cm = h1.shape
    h2 = torch.empty_like(h1)
    name = "bottleneck_conv2_bf16_wgmma"
    fn = kernel_lib.function(name, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P)
    kernel_lib.check(fn(h1.data_ptr(), cm, w2k.data_ptr(), s2.data_ptr(),
                        b2.data_ptr(), h2.data_ptr(), n, h, w,
                        _stream(h1.device)), name)
    return h2


def conv3_kernel(h2, w3k, s3, b3, x, wdk=None, sd=None, bd=None
                 ) -> torch.Tensor:
    """conv3 on the Hopper tile: ``relu(h2 @ w3k.T · s3 + b3 + ident)``
    rounded to bfloat16, ``ident = x @ wdk.T · sd + bd`` (its own float32
    accumulator) or, without ``wdk``, x itself; h2 [N, H, W, Cm], w3k
    [Cout, Cm], wdk [Cout, Cin] contiguous bfloat16."""
    n, h, w, cm = h2.shape
    cin, cout = x.shape[-1], w3k.shape[0]
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ds = ([wdk.data_ptr(), sd.data_ptr(), bd.data_ptr()] if wdk is not None
          else [None, None, None])
    name = "bottleneck_conv3_bf16_wgmma"
    fn = kernel_lib.function(name, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                             _P, _I, _I, _I, _I, _P)
    kernel_lib.check(fn(h2.data_ptr(), cm, w3k.data_ptr(), s3.data_ptr(),
                        b3.data_ptr(), x.data_ptr(), cin, *ds,
                        out.data_ptr(), n, h, w, cout, _stream(x.device)),
                     name)
    return out


def kernel(x, w1, aff1, w2, aff2, w3, aff3, wd=None, affd=None,
           kmajor=None):
    """K6 on CUDA tensors (see :func:`bottleneck_fused`)."""
    global launches, wgmma_launches
    n, h, w, cin = x.shape
    dtype, dev = x.dtype, x.device
    if dtype not in _ENTRY:
        raise TypeError(f"bottleneck kernel takes bfloat16 or float32, not "
                        f"{dtype}")
    if not x.is_cuda:
        raise ValueError("bottleneck kernel: tensors must be on a CUDA device")
    w1m, w3m = _mat(w1), _mat(w3)
    cm, cout = w1m.shape[1], w3m.shape[1]
    if (w1m.shape[0] != cin or tuple(w2.shape) != (3, 3, cm, cm)
            or w3m.shape[0] != cm):
        raise ValueError(f"bottleneck kernel: kernels {tuple(w1m.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w3m.shape)} do not chain "
                         f"from Cin = {cin}")
    if wd is None and cin != cout:
        raise ValueError(f"bottleneck kernel: the identity needs Cin == Cout,"
                         f" got {cin} and {cout}")
    if wd is not None and tuple(_mat(wd).shape) != (cin, cout):
        raise ValueError(f"bottleneck kernel: downsample {tuple(wd.shape)} "
                         f"is not [{cin}, {cout}]")
    x = x.contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    aff = [f32(t) for a in (aff1, aff2, aff3) for t in a]
    affd = [f32(t) for t in affd] if wd is not None else [None, None]
    if takes_wgmma_tile(x, cm, cout):
        shapes = [(cm, cin), (cm, 3, 3, cm), (cout, cm),
                  None if wd is None else (cout, cin)]
        if kmajor is None:
            ks = kmajor_weights(*(t if t is None else t.to(dev)
                                  for t in (w1, w2, w3, wd)), dtype=dtype)
        elif all(_usable(k, s, dtype, dev) for k, s in zip(kmajor, shapes)
                 if s is not None):
            ks = kmajor
        else:
            raise ValueError("bottleneck kernel: the K-major weights given "
                             "are not contiguous 16-byte aligned "
                             f"{dtype} on {dev} of shapes {shapes}")
        h1 = conv1_kernel(x, ks[0], aff[0], aff[1])
        h2 = conv2_kernel(h1, ks[1], aff[2], aff[3])
        out = conv3_kernel(h2, ks[2], aff[4], aff[5], x,
                           None if wd is None else ks[3], *affd)
        launches += 1
        wgmma_launches += 1
        return out
    cast = lambda t: _mat(t).to(device=dev, dtype=dtype).contiguous()
    ws = [cast(w1), w2.to(device=dev, dtype=dtype).contiguous(), cast(w3)]
    ds = ([cast(wd).data_ptr(), affd[0].data_ptr(), affd[1].data_ptr()]
          if wd is not None else [None, None, None])
    h1 = torch.empty((n, h, w, cm), dtype=dtype, device=dev)
    h2 = torch.empty_like(h1)
    out = torch.empty((n, h, w, cout), dtype=dtype, device=dev)
    fn = kernel_lib.function(_ENTRY[dtype], _P, _I, _I, _I,
                             *([_P] * 15), _I, _I, _I, _P)
    rc = fn(x.data_ptr(), cin, cm, cout,
            ws[0].data_ptr(), aff[0].data_ptr(), aff[1].data_ptr(),
            ws[1].data_ptr(), aff[2].data_ptr(), aff[3].data_ptr(),
            ws[2].data_ptr(), aff[4].data_ptr(), aff[5].data_ptr(),
            *ds, h1.data_ptr(), h2.data_ptr(), out.data_ptr(), n, h, w,
            _stream(dev))
    kernel_lib.check(rc, _ENTRY[dtype])
    launches += 1
    return out
