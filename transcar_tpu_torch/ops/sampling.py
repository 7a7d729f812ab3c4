"""Bilinear point sampling from feature maps (``transcar_tpu/ops/sampling.py``).

The reference calls ``F.grid_sample`` with its defaults: bilinear,
``padding_mode='zeros'``, ``align_corners=False``.  The same semantics as
a gather on the NHWC ``[H·W, C]`` layout the head keeps its features in:
grid coord g ∈ [-1, 1] maps to pixel ``(g + 1) / 2 · S − 0.5`` and taps
outside the map contribute zeros.  The four corners gather whole feature
rows in one call (``F.embedding`` on the [M·H·W, C] rows): its backward
sums the rows a pixel receives by one sort of the row indices, in one
fixed order, where an element-wise ``torch.gather``'s scatter-add is,
under PyTorch's deterministic mode, a sort of every (row, channel)
element, and one a corner.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample_nhwc(feat: torch.Tensor, uv01: torch.Tensor) -> torch.Tensor:
    """Sample points from a batch of feature maps with zero padding.

    Args:
      feat: [M, H, W, C] feature maps.
      uv01: [M, P, 2] (x, y) locations normalized to [0, 1] over the map.
    Returns:
      [M, P, C] bilinearly interpolated features.
    """
    m, h, w, c = feat.shape
    x = uv01[..., 0] * w - 0.5
    y = uv01[..., 1] * h - 0.5
    x0, y0 = x.floor(), y.floor()
    tx = (x - x0).to(feat.dtype)[..., None]
    ty = (y - y0).to(feat.dtype)[..., None]
    x0, y0 = x0.long(), y0.long()
    rows = feat.reshape(m * h * w, c)
    base = torch.arange(m, device=feat.device)[:, None] * (h * w)
    # corners 00, 01, 10, 11: [4, M, P]
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1])
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1])
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1) + base
    taps = F.embedding(idx, rows) * valid[..., None].to(feat.dtype)
    return (taps[0] * ((1 - ty) * (1 - tx))
            + taps[1] * ((1 - ty) * tx)
            + taps[2] * (ty * (1 - tx))
            + taps[3] * (ty * tx))


def sample_multiview_multilevel(mlvl_feats, uv01: torch.Tensor) -> torch.Tensor:
    """Sample every query point in every camera at every FPN level.

    The same normalized image coordinate serves every level (it is
    normalized by the padded input size, not the level's).

    Args:
      mlvl_feats: list of L tensors [B, N, H_l, W_l, C].
      uv01: [B, N, Q, 2] normalized (x, y) image coordinates.
    Returns:
      [B, Q, N, L, C] float32 samples (zero where off-image).
    """
    b, n, q, _ = uv01.shape
    uv_flat = uv01.reshape(b * n, q, 2)
    per_level = []
    for feat in mlvl_feats:
        _, _, h, w, c = feat.shape
        sampled = bilinear_sample_nhwc(feat.reshape(b * n, h, w, c), uv_flat)
        per_level.append(sampled.reshape(b, n, q, c))
    stacked = torch.stack(per_level, dim=-2)         # [B, N, Q, L, C]
    return stacked.permute(0, 2, 1, 3, 4).float()
