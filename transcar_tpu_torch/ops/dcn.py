"""Modulated deformable convolution v2, exact (``transcar_tpu/ops/dcn.py``).

mmcv DCNv2 semantics: ``offset_mask`` holds 27 channels per output pixel
of the 3×3 kernel, ch ``2k`` = Δy_k and ``2k+1`` = Δx_k of tap k = 3r + c,
ch ``18+k`` the modulation logit (sigmoid-ed).  Every tap bilinearly
samples the input at ``(i − 1 + r + Δy, j − 1 + c + Δx)`` with zero
padding outside, for ARBITRARY offsets; the modulated samples then meet
the weight in one 9·Cin → Cout contraction.

This is the CPU path and the oracle of the CUDA kernel
(``ops/pallas_dcn.py``).  Numerics match that kernel: coordinates,
fractions, σ(mask) and the bilinear sum run in float32 (the fractions,
σ(mask) and the sum in float64 for float64 inputs), the modulated sample
is rounded once to the input dtype, the contraction accumulates in
float32 and the output is in the input dtype.  (The JAX version rounds the
fractions to the input dtype too; in bfloat16 the two differ by that.)
"""
from __future__ import annotations

import torch


def modulated_deform_conv(x: torch.Tensor, offset_mask: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """Batched modulated deformable conv, 3×3 / stride 1 / pad 1 /
    dilation 1 (every DCN conv of the caffe-style ResNet), NHWC, no bias.

    Args:
      x: [N, H, W, Cin].
      offset_mask: [N, H, W, 27] raw conv_offset output.
      weight: [3, 3, Cin, Cout].
    Returns:
      [N, H, W, Cout] in x.dtype.
    """
    n, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev = x.device

    acc = torch.promote_types(x.dtype, torch.float32)
    om = offset_mask.float()
    dy, dx = om[..., 0:18:2], om[..., 1:18:2]              # [N, H, W, 9]
    mk = torch.sigmoid(om[..., 18:27]).to(acc)
    tap = torch.arange(9, device=dev)
    py = (torch.arange(h, device=dev)[:, None, None] - 1
          + (tap // 3)).float() + dy
    px = (torch.arange(w, device=dev)[None, :, None] - 1
          + (tap % 3)).float() + dx
    y0f, x0f = py.floor(), px.floor()
    fy, fx = (py - y0f).to(acc), (px - x0f).to(acc)
    y0, x0 = y0f.long(), x0f.long()

    flat = x.reshape(n * h * w, cin)
    base = torch.arange(n, device=dev).view(n, 1, 1, 1) * (h * w)
    sampled = torch.zeros(n * h * w * 9, cin, dtype=acc, device=dev)
    for cy, wy in ((0, 1.0 - fy), (1, fy)):
        for cx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = y0 + cy, x0 + cx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            wgt = (wy * wx * mk * valid).reshape(-1, 1)
            sampled += flat[idx.reshape(-1)].to(acc) * wgt
    sampled = sampled.to(x.dtype).reshape(n * h * w, 9 * cin)
    out = sampled @ weight.reshape(9 * cin, cout).to(x.dtype)
    return out.reshape(n, h, w, cout)
