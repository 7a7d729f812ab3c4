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

What the design does about it.  bfloat16 calls whose widths and Cout are
multiples of 8 (every VoVNet-99 block) take the Hopper tile of
``csrc/osa_reduce.cu`` on ``csrc/hopper_tile.cuh``: an implicit GEMM per
image over its pixels, N = Cout, K = ΣCᵢ walked piece by piece, each piece
and weight slice its own TMA tensor map, so the concatenation never
reaches device memory and TMA's zero fill ends a tile at the image edge
and a 64-wide K slice past a width of 160 or 224.  A persistent block per
SM keeps a 4-stage ring of slices in flight with one producer thread while
two consumer warpgroups run ``wgmma`` over 128 pixels × 256 channels; the
epilogue applies the folded FrozenBN affine (staged in shared memory per
tile) and the ReLU in float32 from the accumulator registers, stores
bfloat16 once with 8-byte stores after one exchange between neighbouring
lanes, and writes per-(tile, channel) column sums, reduced by a butterfly of
warp shuffles and one shared-memory row per warp, as partials; the tile
that completes an (image, Cout tile) column sums its partials in tile
order into ``sums[n, Cout]`` (``csrc/ordered_sum.cuh``).  The weights
are read K-major ([Cout, Cᵢ] rows, as the 1×1 conv parameter already
stores them): :func:`kmajor_weights` gives the [Cᵢ, Cout] views the model
caches, and any other weight is packed so on each call.  float32 calls and
bfloat16 calls outside those shapes take the ``wmma`` tile
(``csrc/conv_tile.cuh``, shared with K5 and K6: 64 pixels × 128 channels,
``wmma`` bf16 or CUDA-core float32 FMAs without TF32, ``cp.async`` double
buffering); the choice is made by dtype and shape, never on failure.  The
TPU kernel carried the channel sums across its sequential grid axis in
order; Hopper's blocks run in no order, so each writes its part once and
the last block of a column, found by an integer ticket, adds the parts in
their fixed order: the sums repeat bit for bit.  Against the plain
version's single float32 sum they differ by the other order of summation
(a relative error of order 1e-6 in float32 over a stage-2 image, checked
at 1e-4).  ``rows_per_step`` was a VMEM tiling knob and is accepted and
ignored.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib

#: K4 launches since the count was last set to 0.
launches = 0
#: Of those, the launches that took the Hopper (wgmma) tile.
wgmma_launches = 0

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
        any float dtype (cast to the pieces' dtype); the Hopper tile reads
        them without a copy when they are K-major views in that dtype
        (:func:`kmajor_weights`).
      scale, bias: [Cout] folded FrozenBN affine (float32).
      relu: apply the ReLU after the affine.
      rows_per_step: the TPU kernel's VMEM tile; ignored.
    Returns:
      ([N, H, W, Cout] in the pieces' dtype, [N, Cout] float32 sums).

    It calls the registered op :data:`osa_reduce_op`: a CPU tensor takes
    :func:`plain_osa_reduce`, a CUDA tensor launches K4 or raises.
    """
    del rows_per_step
    check_forward_only("osa_reduce", *pieces, *weights, scale, bias)
    return osa_reduce_op(list(pieces), list(weights), scale, bias, relu)


def _osa_reduce_fake(pieces, weights, scale, bias, relu=True):
    n, h, w, _ = pieces[0].shape
    cout = weights[0].shape[-1]
    return (pieces[0].new_empty((n, h, w, cout)),
            pieces[0].new_empty((n, cout), dtype=torch.float32))


#: K4 as a registered op, ``torch.ops.transcar.osa_reduce(pieces, weights,
#: scale, bias, relu=True)``: :func:`kernel` on CUDA,
#: :func:`plain_osa_reduce` on the CPU; its fake gives the contiguous [N, H,
#: W, Cout] output and the [N, Cout] float32 sums.
osa_reduce_op = kernel_lib.register_op(
    "osa_reduce(Tensor[] pieces, Tensor[] weights, Tensor scale, "
    "Tensor bias, bool relu=True) -> (Tensor, Tensor)",
    cuda=lambda *a: kernel(*a), cpu=lambda *a: plain_osa_reduce(*a),
    fake=_osa_reduce_fake)


@register_flop_formula(torch.ops.transcar.osa_reduce)
def _osa_reduce_flops(piece_shapes, weight_shapes, scale_shape, bias_shape,
                      relu=True, *, out_shape=None, **kwargs) -> float:
    n, h, w, _ = piece_shapes[0]
    return counts.osa_reduce(n, h, w, [p[-1] for p in piece_shapes],
                             weight_shapes[0][-1])


def kmajor_weights(weight: torch.Tensor, widths: Sequence[int],
                   dtype) -> list:
    """The 1×1 reduce kernel ``weight`` ([Cout, ΣCᵢ, 1, 1] or [Cout, ΣCᵢ])
    as the [Cᵢ, Cout] weights of :func:`osa_reduce`, in ``dtype``: views of
    one contiguous [Cout, ΣCᵢ] tensor (stride (1, ΣCᵢ)), the K-major layout
    the Hopper tile reads without a copy."""
    w = weight.reshape(weight.shape[0], -1).to(dtype).contiguous()
    return list(torch.split(w.t(), list(widths), 0))


def _wgmma_weights(weights, dtype) -> list:
    """Each weight as a K-major view in ``dtype`` (itself if it is one)."""
    out = []
    for wi in weights:
        if not (wi.dtype == dtype and wi.stride(0) == 1
                and wi.stride(1) % 8 == 0 and wi.data_ptr() % 16 == 0):
            wi = wi.to(dtype).t().contiguous().t()
        out.append(wi)
    return out


def takes_wgmma_tile(pieces, cout: int) -> bool:
    """Whether a call takes the Hopper tile: bfloat16 pieces whose widths
    and Cout are multiples of 8, on 16-byte aligned bases."""
    return (pieces[0].dtype == torch.bfloat16 and cout % 8 == 0
            and all(p.shape[-1] % 8 == 0 and p.data_ptr() % 16 == 0
                    for p in pieces))


def sums_scratch(n: int, hw: int, cout: int, device):
    """The channel sums of a reduce over [n, hw] pixels and what their
    fixed order needs: ([n, cout] float32 sums, written whole by the
    kernel; the [n, ⌈hw / 64⌉, cout] float32 partials, one a pixel tile of
    either tile (the Hopper tile's 128-pixel tiles use the first half);
    the zeroed int32 tickets, one an (image, 128-channel tile))."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((n, cout), **f32),
            torch.empty((n, -(-hw // 64), cout), **f32),
            kernel_lib.zeroed_scratch(device, n * -(-cout // 128)))


def kernel(pieces, weights, scale, bias, relu: bool = True):
    """K4 on CUDA tensors (see :func:`osa_reduce`)."""
    global launches, wgmma_launches
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
    sums, partials, tickets = sums_scratch(n, h * w, cout, dev)
    k = len(pieces)
    wgmma = takes_wgmma_tile(pieces, cout)
    if wgmma:
        name = "osa_reduce_bf16_wgmma"
        weights = _wgmma_weights(weights, dtype)
        extra = [(_I * k)(*[wi.stride(1) for wi in weights])]
    else:
        name = _ENTRY[dtype]
        weights = [wi.to(dtype).contiguous() for wi in weights]
        extra = []
    fn = kernel_lib.function(name, _I, _P, _P, _P, *([_P] if wgmma else []),
                             _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(k, (_P * k)(*[p.data_ptr() for p in pieces]),
                (_P * k)(*[wi.data_ptr() for wi in weights]),
                (_I * k)(*[p.shape[-1] for p in pieces]), *extra,
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                sums.data_ptr(), partials.data_ptr(), tickets.data_ptr(), n,
                h, w, cout, int(relu), stream)
    kernel_lib.check(rc, name)
    launches += 1
    wgmma_launches += int(wgmma)
    return out, sums
