"""Whole OSA block kernel for Hopper (``csrc/osa_block.cu``, K5).

Replaces ``transcar_tpu/ops/pallas_osa_block.py::osa_block_fused`` (the
Pallas TPU ``_kernel``): the chain of 3×3 ConvBN-ReLU layers of a VoVNet
OSA block and the concat-free 1×1 reduce with its per-image channel sums;
the caller applies the eSE gate and the identity.

What bounds it on the H100: 5.600 TFLOP per request over the 16 blocks
(3.93 in the chain, 1.67 in the reduce), so it is tensor-core bound
(about 5.7 ms at the bfloat16 dense peak); its compulsory traffic is one
read of each block's input and one write of its output.  With a chain
buffer per conv, the chain tile below also moves each tap's window again
(28 GB a request) and each 128-pixel tile's whole weight slice (about 37
GB) from L2.  No one stream sets its pace: taking out the A loads saves
9% of the chain's time, the B loads 5%, the multiply 18%
(``chip_smoke.py --variants k5``; H100 80GB HBM3, 700 W).

What the design does about it: the TPU kernel keeps the whole chain of a
row chunk in VMEM.  One SM has 227 KB of shared memory, and a stage-2
chain output alone is 232 × 400 × 128 channels, so here each chain conv is
a launch of its own that writes its output to device memory for the next
conv's halo (keeping the chain on chip, in row bands with a halo as on the
TPU, is later work), and the reduce is K4.  bfloat16 calls whose widths
are multiples of 8 (:func:`takes_wgmma_tile`; every VoVNet-99 block) take
the Hopper tile of ``csrc/osa_wgmma.cuh``, K4's persistent ``wgmma``
kernel fed by TMA, in its 3×3 form: an output tile is a rectangle of
bh × bw = 128 pixels of one image (bw = 16 … 128, whichever leaves the
fewest pixels past the image), K walks 9 taps × 64-channel slices, and the
A slice of tap (ky, kx) is one TMA load of a 4-D box of the NHWC input at
(n, i0 − 1 + ky, j0 − 1 + kx, c0): TMA's zero fill of what lies outside the
image is the conv's zero padding, and it ends a slice past a width of 160
or 224.  The weight is read K-major, [Ch, 3, 3, Cin] in bfloat16
(:func:`kmajor_conv_weight`, cached by ``models/vovnet.OSABlock``), one
box of Ch rows a slice (the ``wgmma`` is 256 wide for Ch = 160 / 192 /
224, but the rows past Ch feed only columns that are never stored, so
they are not loaded: that cut the chain's time by a fifth, 13.65 to 10.64
ms a request).  The
epilogue applies the folded FrozenBN affine and the ReLU in float32 and
rounds once to bfloat16, as the TPU kernel rounds before the next conv.
Then the reduce runs K4's Hopper tile over x and the chain buffers
(:func:`pallas_osa.kernel`, counted there).  So a bfloat16 call is 5
chain-tile launches (:data:`wgmma_launches`) and one K4 launch for a V-99
block.  float32 calls (the checks) and other widths take the ``wmma`` tile
of ``csrc/conv_tile.cuh`` for the whole block, ``len(conv_w9s) + 1``
device kernels.  One call of :func:`osa_block_fused` counts as one K5
launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib, pallas_osa
from transcar_tpu_torch.ops.pallas_osa import (check_forward_only,
                                               plain_osa_reduce)

#: K5 launches (calls, each of n_convs + 1 device kernels) since the count
#: was last set to 0.
launches = 0
#: Chain convs that took the Hopper (wgmma) tile since the count was last
#: set to 0 (n_convs per bfloat16 call; its reduce counts in pallas_osa).
wgmma_launches = 0

_ENTRY = {torch.bfloat16: "osa_block_bf16", torch.float32: "osa_block_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
Affine = Tuple[torch.Tensor, torch.Tensor]


def conv3x3_affine_relu(x: torch.Tensor, w9: torch.Tensor,
                        affine: Affine) -> torch.Tensor:
    """Plain 3×3 / stride 1 / pad 1 conv of the activation-dtype values
    with float32 accumulation, then the affine and ReLU in float32, NHWC
    in and float32 out."""
    dtype = x.dtype
    w = w9.to(dtype).float().permute(3, 2, 0, 1)           # [O, I, 3, 3]
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    acc = acc.permute(0, 2, 3, 1)
    return torch.relu(acc * affine[0].float() + affine[1].float())


def plain_osa_block(x: torch.Tensor, conv_w9s: Sequence[torch.Tensor],
                    conv_affines: Sequence[Affine],
                    reduce_ws: Sequence[torch.Tensor], reduce_affine: Affine
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: the chain, each output rounded to x's dtype,
    then the reduce of :func:`plain_osa_reduce` over x and the chain."""
    pieces = [x]
    for w9, aff in zip(conv_w9s, conv_affines):
        pieces.append(conv3x3_affine_relu(pieces[-1], w9, aff).to(x.dtype))
    return plain_osa_reduce(pieces, reduce_ws, *reduce_affine, relu=True)


def osa_block_fused(x: torch.Tensor, conv_w9s: Sequence[torch.Tensor],
                    conv_affines: Sequence[Affine],
                    reduce_ws: Sequence[torch.Tensor], reduce_affine: Affine,
                    rows_per_chunk: Optional[int] = None,
                    conv_kmajor: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused OSA block: 3×3 ConvBN-ReLU chain + concat-free reduce + eSE
    channel sums.

    Args:
      x: [N, H, W, C0] (bfloat16 or float32).
      conv_w9s: [3, 3, Cinᵢ, Ch] chain kernels, any float dtype.
      conv_affines: ([Ch] scale, [Ch] bias) folded FrozenBN per chain conv.
      reduce_ws: [Cᵢ, Cr] splits of the 1×1 reduce kernel (x first).
      reduce_affine: ([Cr] scale, [Cr] bias).
      rows_per_chunk: the TPU kernel's row chunking; ignored.
      conv_kmajor: optional :func:`kmajor_conv_weight` of each chain kernel
        (cached copies); the Hopper tile uses one when it has the layout
        and dtype it reads, and builds one otherwise.
    Returns:
      ([N, H, W, Cr] after the ReLU, before the eSE gate, in x's dtype;
       [N, Cr] float32 per-image channel sums).

    It calls the registered op :data:`osa_block`: a CPU tensor takes
    :func:`plain_osa_block`, a CUDA tensor launches K5 or raises.
    """
    del rows_per_chunk
    check_forward_only("osa_block_fused", x, *conv_w9s, *reduce_ws,
                       *(t for a in (*conv_affines, reduce_affine) for t in a))
    return osa_block(x, list(conv_w9s), [a[0] for a in conv_affines],
                     [a[1] for a in conv_affines], list(reduce_ws),
                     *reduce_affine, list(conv_kmajor or []))


def _osa_block_cuda(x, conv_w9s, conv_scales, conv_biases, reduce_ws,
                    reduce_scale, reduce_bias, conv_kmajor):
    return kernel(x, conv_w9s, list(zip(conv_scales, conv_biases)),
                  reduce_ws, (reduce_scale, reduce_bias), conv_kmajor or None)


def _osa_block_cpu(x, conv_w9s, conv_scales, conv_biases, reduce_ws,
                   reduce_scale, reduce_bias, conv_kmajor):
    return plain_osa_block(x, conv_w9s, list(zip(conv_scales, conv_biases)),
                           reduce_ws, (reduce_scale, reduce_bias))


def _osa_block_fake(x, conv_w9s, conv_scales, conv_biases, reduce_ws,
                    reduce_scale, reduce_bias, conv_kmajor):
    n, h, w, _ = x.shape
    cr = reduce_ws[0].shape[-1]
    return (x.new_empty((n, h, w, cr)),
            x.new_empty((n, cr), dtype=torch.float32))


#: K5 as a registered op, ``torch.ops.transcar.osa_block(x, conv_w9s,
#: conv_scales, conv_biases, reduce_ws, reduce_scale, reduce_bias,
#: conv_kmajor)``: :func:`kernel` on CUDA, :func:`plain_osa_block` on the
#: CPU; the chain affines come split into scales and biases, and
#: ``conv_kmajor`` is empty where the caller has no K-major copies; its fake
#: gives the contiguous [N, H, W, Cr] output and the [N, Cr] float32 sums.
osa_block = kernel_lib.register_op(
    "osa_block(Tensor x, Tensor[] conv_w9s, Tensor[] conv_scales, "
    "Tensor[] conv_biases, Tensor[] reduce_ws, Tensor reduce_scale, "
    "Tensor reduce_bias, Tensor[] conv_kmajor) -> (Tensor, Tensor)",
    cuda=lambda *a: _osa_block_cuda(*a), cpu=lambda *a: _osa_block_cpu(*a),
    fake=_osa_block_fake)


@register_flop_formula(torch.ops.transcar.osa_block)
def _osa_block_flops(x_shape, w9_shapes, *args, out_shape=None,
                     **kwargs) -> float:
    n, h, w, c0 = x_shape
    return counts.osa_block(n, h, w, c0, w9_shapes[0][-1], len(w9_shapes),
                            out_shape[0][-1])


def kmajor_conv_weight(w9: torch.Tensor, dtype) -> torch.Tensor:
    """A [3, 3, Cin, Ch] chain kernel as the Hopper tile's K-major B:
    [Ch, 3, 3, Cin] contiguous in ``dtype``."""
    return w9.permute(3, 0, 1, 2).to(dtype).contiguous()


def takes_wgmma_tile(x: torch.Tensor, ch: int, cr: int) -> bool:
    """Whether a call takes the Hopper tiles: bfloat16 with C0, Ch and Cr
    multiples of 8 and a 16-byte aligned x (the chain buffers are
    allocated aligned)."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and ch % 8 == 0 and cr % 8 == 0 and x.data_ptr() % 16 == 0)


def conv3x3_kernel(x: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """One chain conv on the Hopper tile: ``relu(conv3x3(x) · scale +
    bias)`` rounded to bfloat16, on contiguous CUDA tensors ``x`` [N, H, W,
    Cin] and ``wk`` [Ch, 3, 3, Cin] (bfloat16) and float32 ``scale`` /
    ``bias`` [Ch]."""
    global wgmma_launches
    n, h, w, cin = x.shape
    ch = wk.shape[0]
    out = torch.empty((n, h, w, ch), dtype=x.dtype, device=x.device)
    name = "osa_conv3x3_bf16_wgmma"
    fn = kernel_lib.function(name, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), cin, wk.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), n, h, w, ch, stream)
    kernel_lib.check(rc, name)
    wgmma_launches += 1
    return out


def kernel(x, conv_w9s, conv_affines, reduce_ws, reduce_affine,
           conv_kmajor=None):
    """K5 on CUDA tensors (see :func:`osa_block_fused`)."""
    global launches
    n, h, w, c0 = x.shape
    dtype, dev = x.dtype, x.device
    if dtype not in _ENTRY:
        raise TypeError(f"osa_block kernel takes bfloat16 or float32, not "
                        f"{dtype}")
    if not x.is_cuda:
        raise ValueError("osa_block kernel: tensors must be on a CUDA device")
    k = len(conv_w9s)
    ch = conv_w9s[0].shape[-1]
    cr = reduce_ws[0].shape[-1]
    if not 1 <= k <= 7 or len(conv_affines) != k or len(reduce_ws) != k + 1:
        raise ValueError(f"osa_block kernel: {k} chain convs (1..7) need as "
                         f"many affines and {k + 1} reduce splits")
    x = x.contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    ws, scales, biases = [], [], []
    for i, (w9, (s, b)) in enumerate(zip(conv_w9s, conv_affines)):
        if w9.shape != (3, 3, c0 if i == 0 else ch, ch):
            raise ValueError(f"osa_block kernel: conv {i} kernel "
                             f"{tuple(w9.shape)} is not [3, 3, "
                             f"{c0 if i == 0 else ch}, {ch}]")
        ws.append(w9)
        scales.append(s.to(**f32).contiguous())
        biases.append(b.to(**f32).contiguous())
    for i, wr in enumerate(reduce_ws):
        if wr.shape != (c0 if i == 0 else ch, cr):
            raise ValueError(f"osa_block kernel: reduce split {i} "
                             f"{tuple(wr.shape)} is not "
                             f"[{c0 if i == 0 else ch}, {cr}]")
    if takes_wgmma_tile(x, ch, cr):
        chain = [x]
        for i, (w9, s, b) in enumerate(zip(ws, scales, biases)):
            wk = conv_kmajor[i] if conv_kmajor is not None else None
            if not (wk is not None and wk.shape == (ch, 3, 3, w9.shape[2])
                    and wk.dtype == dtype and wk.device == dev
                    and wk.is_contiguous() and wk.data_ptr() % 16 == 0):
                wk = kmajor_conv_weight(w9.to(dev), dtype)
            chain.append(conv3x3_kernel(chain[-1], wk, s, b))
        out, sums = pallas_osa.kernel(chain, [wr.to(dev) for wr in reduce_ws],
                                      *reduce_affine, relu=True)
        launches += 1
        return out, sums
    ws = [w9.to(device=dev, dtype=dtype).contiguous() for w9 in ws]
    rws = [wr.to(device=dev, dtype=dtype).contiguous() for wr in reduce_ws]
    rs = reduce_affine[0].to(**f32).contiguous()
    rb = reduce_affine[1].to(**f32).contiguous()
    chain = [torch.empty((n, h, w, ch), dtype=dtype, device=dev)
             for _ in range(k)]
    out = torch.empty((n, h, w, cr), dtype=dtype, device=dev)
    sums = torch.zeros((n, cr), **f32)
    ptrs = lambda ts: (_P * len(ts))(*[t.data_ptr() for t in ts])
    fn = kernel_lib.function(_ENTRY[dtype], _P, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), c0, k, ch, ptrs(ws), ptrs(scales), ptrs(biases),
                ptrs(chain), ptrs(rws), rs.data_ptr(), rb.data_ptr(),
                out.data_ptr(), sums.data_ptr(), n, h, w, cr, stream)
    kernel_lib.check(rc, _ENTRY[dtype])
    launches += 1
    return out, sums
