"""Hard voxelization and pillar scatter (``transcar_tpu/ops/voxelize.py``).

The reference uses mmdet3d's CUDA hard voxelizer and PointPillarsScatter
(configs/obj_dgcnn/pillar.py:30-43).  The JAX package groups points with
a static-shape sort, and so does this copy, written out over the batch
(JAX maps one cloud at a time with ``vmap``): points sort by voxel id
with a *stable* sort (``jnp.argsort`` is stable, so the ``max_points``
points a full voxel keeps are the first ones in cloud order), a point's
rank inside its voxel is its distance to the start of its run, and voxel
slots come from a cumulative sum of first occurrences.  Points and voxels
past the budgets land in an overflow row that is dropped.  All outputs
are fixed ``[max_voxels, max_points, ...]`` with counts.
"""
from __future__ import annotations

from typing import Tuple

import torch

from transcar_tpu_torch.core.device import const


def hard_voxelize(points: torch.Tensor, num_points: torch.Tensor,
                  voxel_size: Tuple[float, float, float],
                  pc_range: Tuple[float, ...], max_points: int = 20,
                  max_voxels: int = 30000):
    """Group each cloud's points into voxels (pillars when the voxel's z
    extent covers the whole range).

    Args:
      points: [B, N_max, F] padded point clouds (first 3 dims = xyz).
      num_points: [B] real points of each cloud (≤ N_max).
      voxel_size / pc_range: the grid.
    Returns:
      voxels [B, max_voxels, max_points, F] grouped points (zero padded),
      coords [B, max_voxels, 3] int32 (z, y, x), num_per_voxel
      [B, max_voxels] int32, num_voxels [B] int32.
    """
    b, n, f = points.shape
    dev = points.device
    lo = const(pc_range[:3], dev, points.dtype)
    vs = const(voxel_size, dev, points.dtype)
    grid = [round((pc_range[3 + i] - pc_range[i]) / voxel_size[i])
            for i in range(3)]
    grid_t = const(grid, dev, torch.int32)

    idx3 = torch.floor((points[..., :3] - lo) / vs).to(torch.int32)
    ar = torch.arange(n, device=dev)
    valid = ((ar < num_points.to(dev)[:, None])
             & (idx3 >= 0).all(-1) & (idx3 < grid_t).all(-1))
    # linear voxel id (int32: 41 · 1024 · 1024 at most); invalid points
    # sort to the end
    lin = (idx3[..., 2] * grid[1] + idx3[..., 1]) * grid[0] + idx3[..., 0]
    lin = torch.where(valid, lin, grid[0] * grid[1] * grid[2] + 1)

    lin_s, order = torch.sort(lin, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, f))
    valid_s = torch.gather(valid, 1, order)
    idx3_s = torch.gather(idx3, 1, order[..., None].expand(-1, -1, 3))

    boundary = torch.ones_like(valid_s)
    boundary[:, 1:] = lin_s[:, 1:] != lin_s[:, :-1]
    first = boundary & valid_s
    voxel_slot = torch.cumsum(first, dim=1) - 1               # per point
    first_pos = torch.cummax(torch.where(boundary, ar, -1), dim=1).values
    rank = ar - first_pos

    keep = valid_s & (rank < max_points) & (voxel_slot < max_voxels)
    slot = torch.where(keep, voxel_slot, max_voxels)          # overflow row
    rank = torch.where(keep, rank, 0)
    row = slot + torch.arange(b, device=dev)[:, None] * (max_voxels + 1)

    voxels = torch.zeros(b * (max_voxels + 1), max_points, f,
                         dtype=points.dtype, device=dev)
    voxels[row, rank] = torch.where(keep[..., None], pts_s, 0.0)
    counts = torch.zeros(b * (max_voxels + 1), dtype=torch.int32, device=dev)
    counts.index_add_(0, row.reshape(-1), keep.reshape(-1).to(torch.int32))
    coords = torch.zeros(b * (max_voxels + 1), 3, dtype=torch.int32,
                         device=dev)
    zyx = idx3_s.flip(-1)
    coords[row] = torch.where(keep[..., None], zyx, 0)

    num_voxels = first.sum(1).clamp(max=max_voxels).to(torch.int32)
    shape = (b, max_voxels + 1)
    return (voxels.reshape(*shape, max_points, f)[:, :max_voxels],
            coords.reshape(*shape, 3)[:, :max_voxels],
            counts.reshape(shape)[:, :max_voxels], num_voxels)


def pillar_scatter(pillar_feats: torch.Tensor, coords: torch.Tensor,
                   num_voxels: torch.Tensor,
                   bev_hw: Tuple[int, int]) -> torch.Tensor:
    """PointPillarsScatter: [B, P, C] pillar features → [B, H, W, C] BEV
    canvas.  coords are (z, y, x); rows ≥ num_voxels go to a scratch cell
    that is dropped."""
    b, p, c = pillar_feats.shape
    h, w = bev_hw
    dev = pillar_feats.device
    valid = torch.arange(p, device=dev) < num_voxels.to(dev)[:, None]
    lin = torch.where(valid, coords[..., 1].long() * w + coords[..., 2].long(),
                      h * w)
    lin = lin + torch.arange(b, device=dev)[:, None] * (h * w + 1)
    canvas = torch.zeros(b * (h * w + 1), c, dtype=pillar_feats.dtype,
                         device=dev)
    canvas[lin] = torch.where(valid[..., None], pillar_feats, 0.0)
    return canvas.reshape(b, h * w + 1, c)[:, :h * w].reshape(b, h, w, c)
