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

What the design does about it, for now: three launches of the
implicit-GEMM tile of ``csrc/conv_tile.cuh`` per call.  conv1 (1×1) and
conv2 (3×3, zero padding by predicate) each apply their affine and ReLU
in float32 and write their output rounded to the activation dtype (the
TPU kernel rounds them there too); conv3 runs with the downsample product
in a second float32 accumulator, or reads the identity in float32, and
adds the residual and applies the ReLU in its epilogue.  So h1 and h2 make
a round trip through device memory (about 3× the compulsory bytes at
``layer1``); keeping conv1's halo tile and conv2's tile in shared memory,
one kernel per block, is the next step.  Any Cm works (the tile walks K
in slices), including the Cm = 512 of ResNet-50 layer 4.  One call counts
as one K6 launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.pallas_osa import check_forward_only
from transcar_tpu_torch.ops.pallas_osa_block import conv3x3_affine_relu

#: K6 launches (calls, each of 3 device kernels) since the count was last
#: set to 0.
launches = 0

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
                     rows_per_chunk: Optional[int] = None) -> torch.Tensor:
    """Fused stride-1 bottleneck.

    Args:
      x: [N, H, W, Cin] (bfloat16 or float32).
      w1: [1, 1, Cin, Cm] or [Cin, Cm]; w2: [3, 3, Cm, Cm]; w3: [1, 1, Cm,
        Cout] or [Cm, Cout]; wd: optional [1, 1, Cin, Cout] or [Cin, Cout]
        downsample (without it Cin must equal Cout); any float dtype.
      aff1, aff2, aff3, affd: ([C] scale, [C] bias) folded FrozenBN.
      rows_per_chunk: the TPU kernel's row chunking; ignored.
    Returns: [N, H, W, Cout] in x's dtype.

    A CPU tensor takes :func:`plain_bottleneck`; a CUDA tensor launches K6
    or raises.
    """
    del rows_per_chunk
    affs = [t for a in (aff1, aff2, aff3, affd) if a is not None for t in a]
    check_forward_only("bottleneck_fused", x, w1, w2, w3, wd, *affs)
    if x.device.type == "cpu":
        return plain_bottleneck(x, w1, aff1, w2, aff2, w3, aff3, wd, affd)
    return kernel(x, w1, aff1, w2, aff2, w3, aff3, wd, affd)


def kernel(x, w1, aff1, w2, aff2, w3, aff3, wd=None, affd=None):
    """K6 on CUDA tensors (see :func:`bottleneck_fused`)."""
    global launches
    n, h, w, cin = x.shape
    dtype, dev = x.dtype, x.device
    if dtype not in _ENTRY:
        raise TypeError(f"bottleneck kernel takes bfloat16 or float32, not "
                        f"{dtype}")
    if not x.is_cuda:
        raise ValueError("bottleneck kernel: tensors must be on a CUDA device")
    cast = lambda t: t.to(device=dev, dtype=dtype).contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    w1, w3 = cast(_mat(w1)), cast(_mat(w3))
    cm, cout = w1.shape[1], w3.shape[1]
    w2 = cast(w2)
    if w1.shape[0] != cin or w2.shape != (3, 3, cm, cm) or w3.shape[0] != cm:
        raise ValueError(f"bottleneck kernel: kernels {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w3.shape)} do not chain "
                         f"from Cin = {cin}")
    if wd is None and cin != cout:
        raise ValueError(f"bottleneck kernel: the identity needs Cin == Cout,"
                         f" got {cin} and {cout}")
    x = x.contiguous()
    aff = [f32(t) for a in (aff1, aff2, aff3) for t in a]
    ds = [None, None, None]                  # wd, sd, bd: null = identity
    if wd is not None:
        wd = cast(_mat(wd))
        if wd.shape != (cin, cout):
            raise ValueError(f"bottleneck kernel: downsample {tuple(wd.shape)}"
                             f" is not [{cin}, {cout}]")
        aff += [f32(affd[0]), f32(affd[1])]
        ds = [wd.data_ptr(), aff[6].data_ptr(), aff[7].data_ptr()]
    h1 = torch.empty((n, h, w, cm), dtype=dtype, device=dev)
    h2 = torch.empty_like(h1)
    out = torch.empty((n, h, w, cout), dtype=dtype, device=dev)
    fn = kernel_lib.function(_ENTRY[dtype], _P, _I, _I, _I,
                             *([_P] * 15), _I, _I, _I, _P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), cin, cm, cout,
                w1.data_ptr(), aff[0].data_ptr(), aff[1].data_ptr(),
                w2.data_ptr(), aff[2].data_ptr(), aff[3].data_ptr(),
                w3.data_ptr(), aff[4].data_ptr(), aff[5].data_ptr(),
                *ds, h1.data_ptr(), h2.data_ptr(), out.data_ptr(), n, h, w,
                stream)
    kernel_lib.check(rc, _ENTRY[dtype])
    launches += 1
    return out
