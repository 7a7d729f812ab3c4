"""Camera geometry (``transcar_tpu/core/geometry.py``): the host-side
lidar2img assembly of the dataset reader and the lidar → image projection
of the decoder."""
from __future__ import annotations

import numpy as np
import torch

from transcar_tpu_torch.core.device import const


def build_lidar2img(sensor2lidar_rot: np.ndarray,
                    sensor2lidar_trans: np.ndarray,
                    cam_intrinsic: np.ndarray) -> np.ndarray:
    """Assemble per-camera 4×4 lidar2img matrices (host-side, numpy).

    Mirrors nuscenes_dataset.py:46-62: ``lidar2cam_rt`` built from the
    inverse of sensor2lidar, then ``viewpad @ lidar2cam_rt.T``.

    Args:
      sensor2lidar_rot: [num_cams, 3, 3]
      sensor2lidar_trans: [num_cams, 3]
      cam_intrinsic: [num_cams, 3, 3]
    Returns:
      [num_cams, 4, 4] float64 lidar2img.
    """
    num_cams = sensor2lidar_rot.shape[0]
    out = np.zeros((num_cams, 4, 4), dtype=np.float64)
    for i in range(num_cams):
        lidar2cam_r = np.linalg.inv(sensor2lidar_rot[i])
        lidar2cam_t = sensor2lidar_trans[i] @ lidar2cam_r.T
        lidar2cam_rt = np.eye(4)
        lidar2cam_rt[:3, :3] = lidar2cam_r.T
        lidar2cam_rt[3, :3] = -lidar2cam_t
        viewpad = np.eye(4)
        viewpad[:3, :3] = cam_intrinsic[i]
        out[i] = viewpad @ lidar2cam_rt.T
    return out


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
    uv01 = uv / const([w, h], uv.device, uv.dtype)
    grid = (uv01 - 0.5) * 2.0
    inside = ((grid[..., 0] > -1.0) & (grid[..., 0] < 1.0)
              & (grid[..., 1] > -1.0) & (grid[..., 1] < 1.0))
    return uv01, mask & inside
