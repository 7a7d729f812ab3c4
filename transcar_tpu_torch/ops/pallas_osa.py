"""OSA concat-reduce kernel for Hopper (``csrc/osa_reduce.cu``, K4).

Replaces ``transcar_tpu/ops/pallas_osa.py::osa_reduce`` (the Pallas TPU
``_kernel``; ``scripts/probe_osa_s3_tail.py::osa_reduce_onedot`` is a
one-dot variant of the same function): the tail of every VoVNet OSA
block, ``relu((concat(pieces) @ W) · scale + bias)`` without building the
concatenation, plus per-image float32 channel sums of the result, which
the eSE gate divides by H·W instead of re-reading the map.

What bounds it on the H100: a request runs it 16 times (one per OSA
block), 1.671 TFLOP and 4.34 GB of compulsory traffic in bfloat16, so it
is tensor-core bound (about 1.7 ms at the dense peak) wherever the tile
keeps the multiply fed.

What the design does about it: an implicit GEMM over M = N·H·W pixels,
N = Cout and K = ΣCᵢ (``csrc/conv_tile.cuh``, shared with K5 and K6).  A
block owns 64 pixels of one image × 128 output channels; its K loop walks
the pieces in turn, each with its own pointer and width, so the
concatenation is a pointer table and never reaches device memory.  K
slices are double buffered with ``cp.async``; bfloat16 multiplies on the
tensor cores (``wmma``, float32 accumulators), float32 on CUDA-core FMAs
(no TF32).  The epilogue applies the folded FrozenBN affine and the ReLU
in float32, stores the output once, and adds the block's column sums over
its real pixels into ``sums[n, Cout]``.  The TPU kernel carried those sums
across its sequential grid axis; Hopper's blocks run in no order, so they
meet in float32 ``atomicAdd``s, whose order changes from run to run (a
relative error of order 1e-6 in float32 over a stage-2 image, checked at
1e-4).  The output channels are the fastest grid axis, so the blocks that
share a pixel tile run together and read it from L2.  ``rows_per_step``
was a VMEM tiling knob and is accepted and ignored.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from transcar_tpu_torch.ops import kernel_lib

#: K4 launches since the count was last set to 0.
launches = 0

_ENTRY = {torch.bfloat16: "osa_reduce_bf16", torch.float32: "osa_reduce_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_PIECES = 8


def check_forward_only(name: str, *tensors) -> None:
    """The kernels have no backward (nor have the Pallas kernels they
    replace): refuse a call whose result autograd would need to
    differentiate, rather than return a silent zero gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only: call it under "
                           "torch.no_grad() or on tensors that need no grad "
                           "(training takes the plain layers)")


def plain_osa_reduce(pieces: Sequence[torch.Tensor],
                     weights: Sequence[torch.Tensor], scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: the concatenation, one [ΣCᵢ → Cout] product of
    the activation-dtype values with float32 accumulation, the affine in
    float32, ReLU, one rounding, and per-image float32 channel sums of the
    float32 result (as the TPU kernel sums its accumulator)."""
    dtype = pieces[0].dtype
    n, h, w, _ = pieces[0].shape
    x = torch.cat([p.to(dtype) for p in pieces], -1).reshape(n * h * w, -1)
    wt = torch.cat([wi.to(dtype) for wi in weights], 0)
    acc = x.float() @ wt.float()
    acc = acc * scale.float() + bias.float()
    if relu:
        acc = torch.relu(acc)
    cout = acc.shape[-1]
    sums = acc.reshape(n, h * w, cout).sum(1)
    return acc.to(dtype).reshape(n, h, w, cout), sums


def osa_reduce(pieces: Sequence[torch.Tensor],
               weights: Sequence[torch.Tensor], scale: torch.Tensor,
               bias: torch.Tensor, relu: bool = True,
               rows_per_step: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``relu((concat(pieces, -1) @ concat(weights, 0)) · scale + bias)``
    without the concatenation, plus per-image channel sums.

    Args:
      pieces: [N, H, W, Cᵢ] tensors (bfloat16 or float32, one dtype).
      weights: [Cᵢ, Cout] splits of the 1×1 kernel along its input axis,
        any float dtype (cast to the pieces' dtype).
      scale, bias: [Cout] folded FrozenBN affine (float32).
      relu: apply the ReLU after the affine.
      rows_per_step: the TPU kernel's VMEM tile; ignored.
    Returns:
      ([N, H, W, Cout] in the pieces' dtype, [N, Cout] float32 sums).

    A CPU tensor takes :func:`plain_osa_reduce`; a CUDA tensor launches K4
    or raises.
    """
    del rows_per_step
    check_forward_only("osa_reduce", *pieces, *weights, scale, bias)
    if pieces[0].device.type == "cpu":
        return plain_osa_reduce(pieces, weights, scale, bias, relu)
    return kernel(pieces, weights, scale, bias, relu)


def kernel(pieces, weights, scale, bias, relu: bool = True):
    """K4 on CUDA tensors (see :func:`osa_reduce`)."""
    global launches
    x0 = pieces[0]
    n, h, w, _ = x0.shape
    dtype, dev = x0.dtype, x0.device
    if dtype not in _ENTRY:
        raise TypeError(f"osa_reduce kernel takes bfloat16 or float32, not "
                        f"{dtype}")
    if not 1 <= len(pieces) <= MAX_PIECES or len(weights) != len(pieces):
        raise ValueError(f"osa_reduce kernel takes 1..{MAX_PIECES} pieces "
                         f"with one weight each, got {len(pieces)} pieces "
                         f"and {len(weights)} weights")
    cout = weights[0].shape[-1]
    pieces = [p.contiguous() for p in pieces]
    weights = [wi.to(dtype).contiguous() for wi in weights]
    for p, wi in zip(pieces, weights):
        if (p.shape[:3] != (n, h, w) or p.dtype != dtype or p.device != dev
                or wi.shape != (p.shape[-1], cout) or wi.device != dev):
            raise ValueError(f"osa_reduce kernel: piece {tuple(p.shape)} "
                             f"{p.dtype} / weight {tuple(wi.shape)} do not "
                             f"match [{n}, {h}, {w}, C] {dtype} / [C, {cout}]"
                             f" on {dev}")
    if not x0.is_cuda:
        raise ValueError("osa_reduce kernel: tensors must be on a CUDA device")
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n, h, w, cout), dtype=dtype, device=dev)
    sums = torch.zeros((n, cout), dtype=torch.float32, device=dev)
    k = len(pieces)
    fn = kernel_lib.function(_ENTRY[dtype], _I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(k, (_P * k)(*[p.data_ptr() for p in pieces]),
                (_P * k)(*[wi.data_ptr() for wi in weights]),
                (_I * k)(*[p.shape[-1] for p in pieces]),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                sums.data_ptr(), n, h, w, cout, int(relu), stream)
    kernel_lib.check(rc, _ENTRY[dtype])
    launches += 1
    return out, sums
