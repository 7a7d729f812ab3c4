"""3D box codec helpers used at inference (``transcar_tpu/core/boxes.py``).

The 10-dim box code is ``(cx, cy, log w, log l, cz, log h, sin yaw,
cos yaw, vx, vy)``; see the JAX module for the reference citations.
"""
from __future__ import annotations

import torch


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
    lo = torch.tensor(pc_range[:3], dtype=points01.dtype,
                      device=points01.device)
    hi = torch.tensor(pc_range[3:], dtype=points01.dtype,
                      device=points01.device)
    return points01 * (hi - lo) + lo
