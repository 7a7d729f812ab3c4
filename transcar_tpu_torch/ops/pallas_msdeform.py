"""Multi-scale deformable attention kernels for Hopper: the forward
(``csrc/msdeform_forward.cu``, K7) and the backward
(``csrc/msdeform_backward.cu``, K8 and K9).

Replaces ``transcar_tpu/ops/pallas_msdeform.py::_enc_pair`` (the Pallas
TPU ``_enc_kernel``, reached through ``pallas_msdeform_encoder`` and
``pallas_msdeform_encoder_ad``): the MSDeformAttn forward,

    out[b, q, h·D + d] = Σ_{l,p} a[b,q,h,l,p] · bilinear(value_l[b, :, :, h, d],
                                                      loc[b,q,h,l,p])

with ``grid_sample(align_corners=False)`` coordinates and zero padding,
the function of :func:`~transcar_tpu_torch.ops.msdeform.ms_deform_attn_core`.
The TPU kernel was a banded one-hot matmul, one ``pallas_call`` per
(query level, value level) pair, on a bfloat16 value, with the vertical
taps outside a row band dropped and the queries required to be the token
grid itself.  Those were Mosaic workarounds: this kernel is exact for any
offset, any head count and head dim, any query count and any level
shapes, with a float32 value and float32 accumulation, so it serves both
the encoder's self-attention (Q = S = 87 040 at a 512² BEV) and the
decoder's cross-attention (Q = 300), each call with all levels in one
launch.  The TPU-only ``band`` has no counterpart.

What bounds it on the H100: an encoder call must read the value
(87 040 × 256 float32, 89 MB), the locations (89 MB) and the weights
(45 MB) and write the output (89 MB): ~312 MB, about 0.093 ms at
3.35 TB/s, against ~3.6 GFLOP (0.05 ms at the float32 peak), so it is
bound by bytes.  The gather itself reads 4 taps × 16 samples × 128 B per
(query, head), about 5.7 GB per encoder layer, served mostly from L2;
that, not device memory, is what this first kernel feels.

What the design does about it.  For a head dim D that is a multiple of
8 and at most 64, with 16-byte aligned value and output rows
(:func:`takes_group_kernel`: the pillar head's D = 32, counted in
:data:`group_launches`), K7 runs one lane group per query
(``msdeform_forward_group_kernel``, its gather in
``csrc/msdeform_gather.cuh``, shared with K8): G lanes (the least power
of two with 8·G ≥ D; 4 for D = 32) own one (batch, query, head), lane j
holding 8 channels as two ``float4``, so a warp holds 32 / G neighbouring
queries of one head, which in the encoder are neighbouring BEV cells, and
a block 4 such runs of one head, head fastest, so that corner rows the
queries share at a level can meet in L1.  The warp walks its queries'
L·P samples together, level by level: it computes each sample's
location, corners and fractions once a group (with the plain version's
rounding: one multiply, then one subtract), not once per lane, and
issues the 16-byte loads of the sample's four corner rows (8 samples in
flight a warp at D = 32: two a group, at 108 registers in place of 63,
ran 1.15× the time on an H100) before any arithmetic.  Each lane then adds
a·Σ w_corner·v_corner into its 8 accumulators, with the first kernel's
expression in its (level, point) order, so that each channel sums as
the first kernel sums it; the group stores its query's 128-byte output
row as two ``float4`` a lane, with no sum across lanes.  Far-off
locations form no out-of-range index, a non-finite location gives NaN in
its row and an off-map sample still meets its weight (0·NaN = NaN), as
in the plain version.  Other D, and misaligned rows, keep the first
kernel, openly: one warp per (batch, query, head), lanes over the
channels, each tap one coalesced 128-byte read, the locations and
weights warp-wide broadcast loads.  Level shapes and starts travel as a
small argument struct.

The backward is two kernels of ``csrc/msdeform_backward.cu``, one for
each TPU kernel it replaces:

  * K8 replaces ``_bwd_taps_pair`` (the Pallas ``_bwd_taps_kernel``):
    d_attn and d_loc of every sample;
  * K9 replaces ``_bwd_value_pair`` (the Pallas ``_bwd_value_kernel``):
    d_value.

Together they are the exact VJP of ``ms_deform_attn_core`` (its plain
version is :func:`~transcar_tpu_torch.ops.msdeform.ms_deform_attn_backward`),
for any offset, head count, head dim, query count and level shapes, as K7
is.  The TPU ran them per (query level, value level) pair on a banded
bfloat16 value window, with d_value as a one-hot matmul and the queries
required to be the token grid, so it only ever differentiated the
encoder; here one launch of each serves the encoder and the decoder.

What bounds them on the H100: at an encoder call K8 must read the value,
the locations, the weights and the output gradient (~312 MB) and write
d_loc and d_attn (~134 MB), about 0.133 ms at 3.35 TB/s, against ~8.2
GFLOP (0.122 ms at the float32 peak); K9 must read the locations, the
weights and the gradient (~223 MB) and write d_value (89 MB), about 0.093
ms.  Both are bound by bytes.  At a decoder call (300 queries) the taps
are few and K9's bound is the 89 MB d_value alone, which the wrapper's
zero-fill writes.  What they really meet is the gather (K8 reads the
same ~5.7 GB of taps through L2 as K7) and the scatter: K9 makes
87 040 × 8 × 16 × 4 × 32 ≈ 1.4 G float atomic adds through L2 per
encoder call.

What the design does about it.  K8, for a head dim D that is a multiple
of 8 and at most 64 with 16-byte aligned rows (:func:`takes_group_kernel`:
the pillar head's D = 32, counted in :data:`backward_taps_group_launches`),
runs one lane group per sample (``msdeform_backward_taps_group_kernel``,
its gather in ``csrc/msdeform_gather.cuh``): G lanes (the least power of
two with 8·G ≥ D; 4 for D = 32) hold 8 channels each as two ``float4``,
so a warp holds 32 / G samples and computes each sample's
location, corners and fractions once (with the plain version's rounding),
not once per lane.  A warp owns 4 neighbouring queries of one (batch,
head), which in the encoder are neighbouring tokens of the BEV grid, and a
block 8 such runs of one head; it walks their samples
level by level, so that the corner rows that neighbouring queries share
at one level can meet in L1.  It keeps 16 samples in flight: every lane
issues its 16-byte corner-row loads for all of them before any
arithmetic, then forms the four dot products
g·v_corner over its channels, combines them with the sample's corner
weights into g·s, g·∂s/∂x and g·∂s/∂y (the same products, summed in
another order: within 1e-5 of max|plain|), and sums those over the
group's lanes in log2 G shuffle rounds.  The queries' gradient rows are
read once into shared memory; the group's first lane stores d_attn and
d_loc, a warp's stores covering consecutive samples.  Other D keep the
first kernel, openly: one warp per (batch, query, head) with lanes over
the channels, three warp-wide sums a sample.

K9, for the same D and 16-byte aligned d_out and d_value
(:func:`takes_group_kernel`, counted in
:data:`backward_value_group_launches`), runs one lane group per query as
K7 does, but with one ``float4`` a lane (``msdeform_backward_value_group_kernel``:
G the least power of two with 4·G ≥ D, 8 lanes for D = 32, so a warp
holds 4 neighbouring queries): the group reads its query's gradient row
once and, for each sample, computes the corners and their four weights
once and adds (g·a)·w_corner into each corner row on the map with one
16-byte vector atomic add a lane (``atomicAdd(float4 *, float4)``), in
place of four scalar atomics: 0.36 G in place of 1.43 G an encoder call.
That cuts instructions; what paces K9 is the L2's atomic work on the
4.7 GB of corner rows an encoder call adds, which grows with the
requests a row takes: a group adds a whole 128-byte row in one
instruction, where K7's 8 channels a lane take two of half a row (1.17×
the time on an H100) and scalar adds four times as many (3.8×).  Other D
keep the first K9: one warp per (batch, query, head) with lanes over the
channels, each tap one coalesced 128-byte scalar atomic add.  d_value is
zeroed by the wrapper (``torch.zeros``, so 16-byte aligned); a
non-finite location and an off-map corner add nothing.  The corner
weights round as K7 and the plain version round them.  The atomics add
in an order that changes from run to run, so d_value differs from the
plain version by summation order only.

:func:`ms_deform_attn` on a CUDA tensor always goes through
:class:`MSDeformAttnFunction` (K7 forward, K8 and K9 backward), with or
without autograd; on a CPU tensor it takes the plain version, which
autograd differentiates.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib
from transcar_tpu_torch.ops.msdeform import level_starts, ms_deform_attn_core

#: K7 launches since the count was last set to 0.
launches = 0
#: Of those, the launches that took the lane-group kernel.
group_launches = 0
#: K8 (d_attn, d_loc) launches since the count was last set to 0.
backward_taps_launches = 0
#: Of those, the launches that took the lane-group kernel.
backward_taps_group_launches = 0
#: K9 (d_value) launches since the count was last set to 0.
backward_value_launches = 0
#: Of those, the launches that took the lane-group kernel.
backward_value_group_launches = 0

MAX_LEVELS = 8
_P, _I = ctypes.c_void_p, ctypes.c_int


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   query_chunk: int = 0) -> torch.Tensor:
    """MSDeformAttn: value [B, S, H, D], sampling_locations
    [B, Q, H, L, P, 2] (x, y in [0, 1] per level), attention_weights
    [B, Q, H, L, P] → [B, Q, H·D], differentiable in all three.

    Where no gradient is wanted (serving, and the exported program) it
    calls the registered op :data:`msdeform_forward`: K7 on a CUDA tensor,
    the plain version
    (:func:`~transcar_tpu_torch.ops.msdeform.ms_deform_attn_core`, whose
    ``query_chunk`` bounds its intermediates) on a CPU one.  Where one
    is, a CPU tensor takes the plain version under autograd and a CUDA
    tensor :class:`MSDeformAttnFunction`: K7 (the op), and K8 and K9 in
    the backward; a CUDA call the kernels do not take raises.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations,
                                      attention_weights)):
        if value.device.type == "cpu":
            return ms_deform_attn_core(value, spatial_shapes,
                                       sampling_locations, attention_weights,
                                       query_chunk)
        return MSDeformAttnFunction.apply(value, tuple(spatial_shapes),
                                          sampling_locations,
                                          attention_weights)
    return msdeform_forward(value, flat_shapes(spatial_shapes),
                            sampling_locations, attention_weights,
                            query_chunk)


def flat_shapes(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """The levels' (H, W) as the op takes them: [H₀, W₀, H₁, W₁, ...]."""
    return [int(v) for hw in spatial_shapes for v in hw]


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


def _msdeform_forward_cuda(value, spatial_shapes, sampling_locations,
                           attention_weights, query_chunk=0):
    return kernel(value, _pairs(spatial_shapes), sampling_locations,
                  attention_weights)


def _msdeform_forward_cpu(value, spatial_shapes, sampling_locations,
                          attention_weights, query_chunk=0):
    return ms_deform_attn_core(value, _pairs(spatial_shapes),
                               sampling_locations, attention_weights,
                               query_chunk)


def _msdeform_forward_fake(value, spatial_shapes, sampling_locations,
                           attention_weights, query_chunk=0):
    b, _, h, d = value.shape
    return value.new_empty((b, sampling_locations.shape[1], h * d),
                           dtype=torch.float32)


#: K7 as a registered op, ``torch.ops.transcar.msdeform_forward(value,
#: spatial_shapes, sampling_locations, attention_weights, query_chunk=0)``,
#: the levels' shapes as :func:`flat_shapes`: :func:`kernel` on CUDA
#: (``query_chunk`` unused), the plain version on the CPU; its fake gives
#: the contiguous [B, Q, H·D] float32 output.
msdeform_forward = kernel_lib.register_op(
    "msdeform_forward(Tensor value, int[] spatial_shapes, "
    "Tensor sampling_locations, Tensor attention_weights, "
    "int query_chunk=0) -> Tensor", cuda=_msdeform_forward_cuda,
    cpu=_msdeform_forward_cpu, fake=_msdeform_forward_fake)


@register_flop_formula(torch.ops.transcar.msdeform_forward)
def _msdeform_forward_flops(value_shape, spatial_shapes, loc_shape,
                            wgt_shape, query_chunk=0, *, out_shape=None,
                            **kwargs) -> float:
    return counts.msdeform_forward(math.prod(wgt_shape), value_shape[3])


class MSDeformAttnFunction(torch.autograd.Function):
    """K7 forward (the registered op); K8 (d_attn, d_loc) and K9 (d_value)
    backward, the counterpart of the JAX package's custom VJP
    ``pallas_msdeform_encoder_ad``.  Saves the value, the locations and the
    weights, not the output."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        value, sampling_locations, attention_weights = (
            t.contiguous() for t in (value, sampling_locations,
                                     attention_weights))
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msdeform_forward(value, flat_shapes(spatial_shapes),
                                sampling_locations, attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        value, loc, wgt = ctx.saved_tensors
        need_value, _, need_loc, need_wgt = ctx.needs_input_grad
        d_value = d_loc = d_wgt = None
        if need_loc or need_wgt:
            d_loc, d_wgt = backward_taps_kernel(value, ctx.spatial_shapes,
                                                loc, wgt, d_out)
        if need_value:
            d_value = backward_value_kernel(value, ctx.spatial_shapes, loc,
                                            wgt, d_out)
        return (d_value, None, d_loc if need_loc else None,
                d_wgt if need_wgt else None)


def _check(value, spatial_shapes, sampling_locations, attention_weights,
           *more) -> None:
    """Raise on what the kernels do not take."""
    b, s, h, d = value.shape
    q = sampling_locations.shape[1]
    l, p = len(spatial_shapes), sampling_locations.shape[4]
    tensors = (value, sampling_locations, attention_weights, *more)
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("ms_deform_attn kernels take float32 value, "
                        "locations, weights and gradients")
    if sampling_locations.shape != (b, q, h, l, p, 2) or \
            attention_weights.shape != (b, q, h, l, p):
        raise ValueError(f"ms_deform_attn kernel: locations "
                         f"{tuple(sampling_locations.shape)} / weights "
                         f"{tuple(attention_weights.shape)} must be "
                         f"[{b}, Q, {h}, {l}, P, 2] / [{b}, Q, {h}, {l}, P]")
    if not 1 <= l <= MAX_LEVELS or s != sum(hl * wl for hl, wl in
                                             spatial_shapes):
        raise ValueError(f"ms_deform_attn kernel: {l} levels {spatial_shapes}"
                         f" (1..{MAX_LEVELS}) must tile S = {s} tokens")
    if any(t.shape != (b, q, h * d) for t in more):
        raise ValueError(f"ms_deform_attn backward: d_out "
                         f"{[tuple(t.shape) for t in more]} must be "
                         f"[{b}, {q}, {h * d}]")
    if not all(t.is_cuda and t.device == value.device for t in tensors):
        raise ValueError("ms_deform_attn kernel: all tensors must be on one "
                         "CUDA device")


def _levels(spatial_shapes):
    """The level table the C entry points take: heights, widths, starts."""
    ints = _I * len(spatial_shapes)
    return (ints(*[hl for hl, _ in spatial_shapes]),
            ints(*[wl for _, wl in spatial_shapes]),
            ints(*level_starts(spatial_shapes)))


def _launch(name, argtypes, *args, device):
    fn = kernel_lib.function(name, *argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(rc, name)


_SHAPE_ARGS = (_I,) * 7 + (_P,) * 4     # B S Q H D L P, 3 level tables, stream


def kernel(value, spatial_shapes, sampling_locations, attention_weights):
    """K7 on CUDA tensors (see :func:`ms_deform_attn`)."""
    global launches, group_launches
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, h, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    value, loc, wgt = (t.contiguous() for t in
                       (value, sampling_locations, attention_weights))
    out = torch.empty((b, q, h * d), dtype=torch.float32, device=value.device)
    group = takes_group_kernel(d, value, out)
    _launch("msdeform_forward_group_f32" if group else "msdeform_forward_f32",
            (_P,) * 4 + _SHAPE_ARGS,
            value.data_ptr(), loc.data_ptr(), wgt.data_ptr(), out.data_ptr(),
            b, s, q, h, d, len(spatial_shapes), p, *_levels(spatial_shapes),
            device=value.device)
    launches += 1
    group_launches += int(group)
    return out


def takes_group_kernel(head_dim: int, *rows: torch.Tensor) -> bool:
    """Whether K7, K8 or K9 takes its lane-group kernel: a head dim that is
    a multiple of 8 and at most 64, and 16-byte aligned ``rows`` (the
    tensors the kernel reads or writes as ``float4``: K7 value and output,
    K8 value and d_out, K9 d_out and d_value)."""
    return (head_dim % 8 == 0 and head_dim <= 64
            and all(t.data_ptr() % 16 == 0 for t in rows))


def backward_taps_kernel(value, spatial_shapes, sampling_locations,
                         attention_weights, d_out):
    """K8 on CUDA tensors: (d_loc [B, Q, H, L, P, 2], d_attn [B, Q, H, L,
    P]) of :func:`ms_deform_attn` for the output gradient ``d_out`` [B, Q,
    H·D], float32."""
    global backward_taps_launches, backward_taps_group_launches
    _check(value, spatial_shapes, sampling_locations, attention_weights,
           d_out)
    b, s, h, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    value, loc, wgt, d_out = (t.contiguous() for t in (
        value, sampling_locations, attention_weights, d_out))
    d_loc = torch.empty_like(loc)
    d_attn = torch.empty_like(wgt)
    group = takes_group_kernel(d, value, d_out)
    _launch("msdeform_backward_taps_group_f32" if group
            else "msdeform_backward_taps_f32", (_P,) * 6 + _SHAPE_ARGS,
            value.data_ptr(), loc.data_ptr(), wgt.data_ptr(),
            d_out.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr(),
            b, s, q, h, d, len(spatial_shapes), p, *_levels(spatial_shapes),
            device=value.device)
    backward_taps_launches += 1
    backward_taps_group_launches += int(group)
    return d_loc, d_attn


def backward_value_kernel(value, spatial_shapes, sampling_locations,
                          attention_weights, d_out):
    """K9 on CUDA tensors: d_value [B, S, H, D] of :func:`ms_deform_attn`
    for the output gradient ``d_out`` [B, Q, H·D], float32 (``value``
    gives the shape and device; its numbers are not read)."""
    global backward_value_launches, backward_value_group_launches
    _check(value, spatial_shapes, sampling_locations, attention_weights,
           d_out)
    b, s, h, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    loc, wgt, d_out = (t.contiguous() for t in (
        sampling_locations, attention_weights, d_out))
    d_value = torch.zeros((b, s, h, d), dtype=torch.float32,
                          device=value.device)
    group = takes_group_kernel(d, d_out, d_value)
    _launch("msdeform_backward_value_group_f32" if group
            else "msdeform_backward_value_f32", (_P,) * 4 + _SHAPE_ARGS,
            loc.data_ptr(), wgt.data_ptr(), d_out.data_ptr(),
            d_value.data_ptr(), b, s, q, h, d, len(spatial_shapes), p,
            *_levels(spatial_shapes), device=value.device)
    backward_value_launches += 1
    backward_value_group_launches += int(group)
    return d_value
