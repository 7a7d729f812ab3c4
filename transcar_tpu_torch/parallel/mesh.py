"""The (data × model) grid of process groups, and camera-axis sharded
serving (``transcar_tpu/parallel/mesh.py``).

:func:`make_grid` stands in for ``make_mesh((dp, tp), ("data",
"model"))``: rank r sits at (r // tp, r % tp), as device r of the JAX
mesh does.  The ranks of one column (one model rank) form a data group,
over which the batch is split and the gradients, loss normalizers and
BatchNorm statistics are summed; the ranks of one row form a model group,
over which the head's matmuls are split (``parallel/sharding.py``).

Camera sharding (the JAX ``camera_mesh`` / ``shard_batch_cameras``):
the 6 camera streams are independent through backbone and FPN (the
detector folds [B, N, ...] into [B·N, ...] around them, as the
reference's Detr3D does, detr3d.py:39-66), so
:class:`CameraShardedDetector` runs each camera group's backbone and FPN
on a device of its own (a replica of those modules on each) and gathers
the FPN levels to the head's device: batch-1 latency that data
parallelism cannot cut.  The output is the unsharded one: every
per-camera convolution is the same, and the gather is a concatenation.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from transcar_tpu_torch.models.detector import camera_features
from transcar_tpu_torch.parallel.distributed import rank_world


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (data × model) grid of process groups; a
    group is None where its axis has one rank."""
    data_rank: int = 0
    data_size: int = 1
    data_group: Optional[object] = None
    model_rank: int = 0
    model_size: int = 1
    model_group: Optional[object] = None


def make_grid(dp: Optional[int] = None, tp: int = 1) -> Grid:
    """Groups of a (dp × tp) grid over the ranks of the default group
    (dp defaults to world / tp).  Every rank calls this: it creates every
    group in the same order on all of them."""
    rank, world = rank_world()
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"grid {dp} x {tp} needs {dp * tp} ranks, have "
                         f"{world}")
    data_group = model_group = None
    if dp > 1:
        if tp == 1:
            data_group = dist.group.WORLD
        else:
            for m in range(tp):
                g = dist.new_group([d * tp + m for d in range(dp)])
                if rank % tp == m:
                    data_group = g
    if tp > 1:
        if dp == 1:
            model_group = dist.group.WORLD
        else:
            for d in range(dp):
                g = dist.new_group([d * tp + m for m in range(tp)])
                if rank // tp == d:
                    model_group = g
    return Grid(rank // tp, dp, data_group, rank % tp, tp, model_group)


def camera_devices(num_cams: int, devices: Sequence) -> list:
    """The largest prefix of ``devices`` whose length divides
    ``num_cams``, so every device holds as many cameras (6 cameras → 6,
    3, 2 or 1 devices)."""
    devices = list(devices)
    n = max(d for d in range(1, min(len(devices), num_cams) + 1)
            if num_cams % d == 0)
    return devices[:n]


class _CameraTrunk(nn.Module):
    """A replica of a detector's backbone and FPN on another device."""

    def __init__(self, model: nn.Module, device):
        super().__init__()
        self.cfg = model.cfg
        self.backbone = copy.deepcopy(model.backbone).to(device)
        self.neck = copy.deepcopy(model.neck).to(device)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, as a parameter's device reads."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class CameraShardedDetector(nn.Module):
    """A camera-track detector whose backbone and FPN run camera group by
    camera group, group g on ``devices[g]``; the head runs on the
    model's device.  ``devices`` may repeat a device (each distinct one
    holds one replica, the model's own on its device), so the split and
    the gather can be run on one card.  Inference only; called as the
    detector is."""

    def __init__(self, model: nn.Module, devices: Sequence):
        super().__init__()
        num_cams = model.cfg.head.num_cams
        devices = [_indexed(torch.device(d)) for d in devices]
        if num_cams % len(devices):
            raise ValueError(f"{len(devices)} camera groups do not divide "
                             f"{num_cams} cameras (camera_devices picks a "
                             "count that does)")
        self.model = model
        self.devices = devices
        home = next(model.parameters()).device
        self._trunks = {home: model}
        for d in devices:
            if d not in self._trunks:
                self._trunks[d] = _CameraTrunk(model, d).eval()

    def features(self, images: torch.Tensor) -> list:
        """The FPN levels [B, N, h, w, C] of images [B, N, H, W, 3],
        camera group by camera group, gathered on the head's device."""
        b, n, h, w, _ = images.shape
        k = n // len(self.devices)
        home = next(self.model.parameters()).device
        groups = []
        for g, dev in enumerate(self.devices):
            x = images[:, g * k:(g + 1) * k].to(dev).reshape(b * k, h, w, 3)
            trunk = self._trunks[dev]
            groups.append(camera_features(trunk.backbone, trunk.neck,
                                          trunk.cfg, x, b, k))
        return [torch.cat([lv[i].to(home) for lv in groups], dim=1)
                for i in range(len(groups[0]))]

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                radar_tokens: Optional[torch.Tensor] = None, **_):
        h, w = images.shape[2:4]
        return self.model.head(self.features(images), lidar2img, (h, w),
                               radar_tokens)
