"""Whole OSA block kernel for Hopper (``csrc/osa_block.cu``, K5).

Replaces ``transcar_tpu/ops/pallas_osa_block.py::osa_block_fused`` (the
Pallas TPU ``_kernel``): the chain of 3×3 ConvBN-ReLU layers of a VoVNet
OSA block and the concat-free 1×1 reduce with its per-image channel sums;
the caller applies the eSE gate and the identity.

What bounds it on the H100: 5.600 TFLOP per request over the 16 blocks
(3.93 in the chain, 1.67 in the reduce), so it is tensor-core bound
(about 5.7 ms at the bfloat16 dense peak); its compulsory traffic is one
read of each block's input and one write of its output.

What the design does about it: the TPU kernel keeps the whole chain of a
row chunk in VMEM.  One SM has 227 KB of shared memory, and a stage-2
chain output alone is 232 × 400 × 128 channels, so here each chain conv is
its own launch of the implicit-GEMM tile of ``csrc/conv_tile.cuh`` (a 3×3
segment, zero padding by predicate, affine and ReLU in float32, rounded
once to the activation dtype as the TPU kernel rounds before the next
conv) that writes its output to device memory for the next conv's halo;
the reduce is then K4's walk over x and the chain outputs.  One call of
:func:`osa_block_fused` counts as one K5 launch and issues
``len(conv_w9s) + 1`` device kernels (6 for a V-99 block).  Keeping the
chain on chip (row bands with a halo, as on the TPU) is later work.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.pallas_osa import (check_forward_only,
                                               plain_osa_reduce)

#: K5 launches (calls, each of n_convs + 1 device kernels) since the count
#: was last set to 0.
launches = 0

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
                    rows_per_chunk: Optional[int] = None
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
    Returns:
      ([N, H, W, Cr] after the ReLU, before the eSE gate, in x's dtype;
       [N, Cr] float32 per-image channel sums).

    A CPU tensor takes :func:`plain_osa_block`; a CUDA tensor launches K5
    or raises.
    """
    del rows_per_chunk
    check_forward_only("osa_block_fused", x, *conv_w9s, *reduce_ws,
                       *(t for a in (*conv_affines, reduce_affine) for t in a))
    if x.device.type == "cpu":
        return plain_osa_block(x, conv_w9s, conv_affines, reduce_ws,
                               reduce_affine)
    return kernel(x, conv_w9s, conv_affines, reduce_ws, reduce_affine)


def kernel(x, conv_w9s, conv_affines, reduce_ws, reduce_affine):
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
        ws.append(w9.to(device=dev, dtype=dtype).contiguous())
        scales.append(s.to(**f32).contiguous())
        biases.append(b.to(**f32).contiguous())
    rws = []
    for i, wr in enumerate(reduce_ws):
        if wr.shape != (c0 if i == 0 else ch, cr):
            raise ValueError(f"osa_block kernel: reduce split {i} "
                             f"{tuple(wr.shape)} is not "
                             f"[{c0 if i == 0 else ch}, {cr}]")
        rws.append(wr.to(device=dev, dtype=dtype).contiguous())
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
