"""Multi-scale deformable attention kernel for Hopper
(``csrc/msdeform_forward.cu``, K7).

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

What the design does about it: one warp per (batch, query, head); its
lanes hold the head's channels (D = 32: one channel per lane; other D
loop d += 32), so each bilinear tap is one coalesced 128-byte read of
the [B, S, H, D] value, and the locations and weights of the warp's
L·P samples are warp-wide broadcast loads.  Level shapes and starts
travel as a small argument struct.  Coordinates round as the plain
version's (one multiply, one subtract, no contraction), far-off
locations contribute zero without forming an index, and a non-finite
location gives NaN, as in the plain version.

The kernel is forward-only (the backward kernels, K8 and K9, come with
ObjDGCNN training): the wrapper refuses a call that autograd would have
to differentiate.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.msdeform import level_starts, ms_deform_attn_core
from transcar_tpu_torch.ops.pallas_osa import check_forward_only

#: K7 launches since the count was last set to 0.
launches = 0

MAX_LEVELS = 8
_P, _I = ctypes.c_void_p, ctypes.c_int


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   query_chunk: int = 0) -> torch.Tensor:
    """MSDeformAttn: value [B, S, H, D], sampling_locations
    [B, Q, H, L, P, 2] (x, y in [0, 1] per level), attention_weights
    [B, Q, H, L, P] → [B, Q, H·D].

    A CPU tensor takes the plain version
    (:func:`~transcar_tpu_torch.ops.msdeform.ms_deform_attn_core`, whose
    ``query_chunk`` bounds its intermediates); a CUDA tensor launches K7
    or raises.
    """
    check_forward_only("ms_deform_attn", value, sampling_locations,
                       attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_core(value, spatial_shapes, sampling_locations,
                                   attention_weights, query_chunk)
    return kernel(value, spatial_shapes, sampling_locations,
                  attention_weights)


def kernel(value, spatial_shapes, sampling_locations, attention_weights):
    """K7 on CUDA tensors (see :func:`ms_deform_attn`)."""
    global launches
    b, s, h, d = value.shape
    q = sampling_locations.shape[1]
    l, p = len(spatial_shapes), sampling_locations.shape[4]
    if not all(t.dtype == torch.float32 for t in
               (value, sampling_locations, attention_weights)):
        raise TypeError("ms_deform_attn kernel takes float32 value, "
                        "locations and weights")
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
    if not all(t.is_cuda and t.device == value.device for t in
               (value, sampling_locations, attention_weights)):
        raise ValueError("ms_deform_attn kernel: all tensors must be on one "
                         "CUDA device")
    value = value.contiguous()
    sampling_locations = sampling_locations.contiguous()
    attention_weights = attention_weights.contiguous()
    out = torch.empty((b, q, h * d), dtype=torch.float32, device=value.device)
    ints = _I * l
    fn = kernel_lib.function("msdeform_forward_f32", _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _P, _P, _P, _P)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), b, s, q, h, d,
                l, p, ints(*[hl for hl, _ in spatial_shapes]),
                ints(*[wl for _, wl in spatial_shapes]),
                ints(*level_starts(spatial_shapes)), stream)
    kernel_lib.check(rc, "msdeform_forward_f32")
    launches += 1
    return out
