"""3D box codec helpers (``transcar_tpu/core/boxes.py``).

The 10-dim box code is ``(cx, cy, log w, log l, cz, log h, sin yaw,
cos yaw, vx, vy)``; see the JAX module for the reference citations.
"""
from __future__ import annotations

import torch

from transcar_tpu_torch.core.device import const


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """Encode ``(cx, cy, cz, w, l, h, yaw[, vx, vy])`` into the regression
    code: z moves to slot 4, dims are logged, yaw becomes (sin, cos)."""
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 3:4].log(),
             bboxes[..., 4:5].log(), bboxes[..., 2:3], bboxes[..., 5:6].log(),
             rot.sin(), rot.cos()]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """Decode the regression code to ``(cx, cy, cz, w, l, h, yaw[, vx, vy])``."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [normalized[..., 0:1], normalized[..., 1:2], normalized[..., 4:5],
             normalized[..., 2:3].exp(), normalized[..., 3:4].exp(),
             normalized[..., 5:6].exp(), rot]
    if normalized.shape[-1] > 8:
        parts += [normalized[..., 8:9], normalized[..., 9:10]]
    return torch.cat(parts, dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit (detr3d_transformer.py:17-32)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def denorm_points(points01: torch.Tensor, pc_range) -> torch.Tensor:
    """Map [0, 1]-normalized xyz into metric ``pc_range`` space."""
    lo = const(pc_range[:3], points01.device, points01.dtype)
    hi = const(pc_range[3:], points01.device, points01.dtype)
    return points01 * (hi - lo) + lo
