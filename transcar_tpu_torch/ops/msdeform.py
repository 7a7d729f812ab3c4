"""Multi-scale deformable attention sampling, exact
(``transcar_tpu/ops/msdeform.py``).

mmcv ``multi_scale_deformable_attn_pytorch`` semantics: every (query,
head, level, point) location is sampled bilinearly from that head's value
map of that level (``F.grid_sample`` with ``align_corners=False`` and zero
padding, through :func:`~transcar_tpu_torch.ops.sampling.bilinear_sample_nhwc`)
and the samples are reduced with the softmaxed attention weights.

This is the CPU path and the plain version of kernel K7
(``ops/pallas_msdeform.py``), and :func:`ms_deform_attn_backward` that of
the backward kernels K8 and K9; nothing on the main path runs either when
a card is present.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from transcar_tpu_torch.ops.sampling import bilinear_sample_nhwc


def level_starts(spatial_shapes: Sequence[Tuple[int, int]]) -> list:
    """Token offset of each level in the flattened value."""
    starts, acc = [], 0
    for hl, wl in spatial_shapes:
        starts.append(acc)
        acc += hl * wl
    return starts


def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        query_chunk: int = 0) -> torch.Tensor:
    """Args:
      value: [B, S, H, D] flattened multi-level values (S = Σ H_l·W_l).
      spatial_shapes: (H_l, W_l) of each level.
      sampling_locations: [B, Q, H, L, P, 2] in [0, 1] per level (x, y).
      attention_weights: [B, Q, H, L, P] (already softmaxed over L·P).
      query_chunk: when > 0 and Q > query_chunk, process the queries in
        sequential chunks of this size (the last one ragged).  Exact: it
        bounds the gathered [B·H, Q·P, D] intermediates, which at the
        encoder's Q = 87 040 would otherwise take gigabytes.
    Returns:
      [B, Q, H·D].
    """
    b, s, h, d = value.shape
    q = sampling_locations.shape[1]
    if query_chunk and q > query_chunk:
        return torch.cat([
            ms_deform_attn_core(value, spatial_shapes,
                                sampling_locations[:, s0:s0 + query_chunk],
                                attention_weights[:, s0:s0 + query_chunk])
            for s0 in range(0, q, query_chunk)], dim=1)

    p = sampling_locations.shape[4]
    out = torch.zeros(b, q, h, d, dtype=value.dtype, device=value.device)
    for li, (start, (hl, wl)) in enumerate(zip(level_starts(spatial_shapes),
                                               spatial_shapes)):
        vmap = value[:, start:start + hl * wl]                   # [B,HW,H,D]
        vmap = vmap.permute(0, 2, 1, 3).reshape(b * h, hl, wl, d)
        loc = sampling_locations[:, :, :, li]                    # [B,Q,H,P,2]
        loc = loc.permute(0, 2, 1, 3, 4).reshape(b * h, q * p, 2)
        sampled = bilinear_sample_nhwc(vmap, loc).reshape(b, h, q, p, d)
        wgt = attention_weights[:, :, :, li].permute(0, 2, 1, 3)  # [B,H,Q,P]
        out = out + torch.einsum("bhqpd,bhqp->bqhd", sampled,
                                 wgt.to(sampled.dtype))
    return out.reshape(b, q, h * d)


def ms_deform_attn_backward(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            d_out: torch.Tensor, query_chunk: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(d_value, d_loc, d_attn) of :func:`ms_deform_attn_core` for the
    output gradient ``d_out`` [B, Q, H·D]: autograd of the plain version,
    one chunk of ``query_chunk`` queries at a time (0: one pass), with
    d_value accumulated over the chunks, so that at the encoder's
    Q = 87 040 it holds one chunk's intermediates."""
    q = sampling_locations.shape[1]
    step = query_chunk if 0 < query_chunk < q else max(q, 1)
    d_value = torch.zeros_like(value)
    d_loc, d_attn = [], []
    with torch.enable_grad():
        v = value.detach().requires_grad_()
        for s0 in range(0, q, step):
            loc = sampling_locations[:, s0:s0 + step].detach()
            wgt = attention_weights[:, s0:s0 + step].detach()
            loc.requires_grad_()
            wgt.requires_grad_()
            out = ms_deform_attn_core(v, spatial_shapes, loc, wgt)
            dv, dl, da = torch.autograd.grad(out, (v, loc, wgt),
                                             d_out[:, s0:s0 + step])
            d_value += dv
            d_loc.append(dl)
            d_attn.append(da)
    return d_value, torch.cat(d_loc, 1), torch.cat(d_attn, 1)
