"""Lidar → image projection (``transcar_tpu/core/geometry.py``)."""
from __future__ import annotations

import torch


def project_points_to_cams(points_m: torch.Tensor, lidar2img: torch.Tensor,
                           img_hw, eps: float = 1e-5):
    """Project metric lidar-frame points into every camera.

    Same eps-clamped perspective divide and strict in-frustum test as the
    reference's feature_sampling (detr3d_transformer.py:393-410).

    Args:
      points_m: [B, Q, 3] points in the lidar frame (meters).
      lidar2img: [B, N, 4, 4].
      img_hw: (H, W) of the padded input image.
    Returns:
      uv01 [B, N, Q, 2] image coords normalized to [0, 1], and the bool
      visibility mask [B, N, Q] (depth > eps and strictly inside the frame).
    """
    h, w = img_hw
    pts_h = torch.cat([points_m, torch.ones_like(points_m[..., :1])], dim=-1)
    cam_pts = torch.einsum("bnij,bqj->bnqi", lidar2img, pts_h)
    depth = cam_pts[..., 2:3]
    mask = depth[..., 0] > eps
    uv = cam_pts[..., 0:2] / depth.clamp(min=eps)
    uv01 = uv / torch.tensor([w, h], dtype=uv.dtype, device=uv.device)
    grid = (uv01 - 0.5) * 2.0
    inside = ((grid[..., 0] > -1.0) & (grid[..., 0] < 1.0)
              & (grid[..., 1] > -1.0) & (grid[..., 1] < 1.0))
    return uv01, mask & inside
