"""SECOND BEV backbone and BN-FPN neck of the ObjDGCNN track
(``transcar_tpu/models/second.py``).

Parity: configs/obj_dgcnn/pillar.py:44-59 — SECOND(layer_nums=(3, 5, 5),
strides=(2, 2, 2), channels=(64, 128, 256), bias-free convs + BN + ReLU)
and an mmdet FPN with BN + ReLU ConvModules, start level 0 and 4 outputs,
the extra one from a 1 × 1 max pool at stride 2 (mmdet's default when
``add_extra_convs`` is unset).  NCHW in channels-last memory, in the
input's dtype (bfloat16 under ``lidar_compute_dtype``), with the
trainable BN's arithmetic in float32 (``common.BatchNorm``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.models.common import ConvBN


class SECOND(nn.Module):
    def __init__(self, in_channels: int = 64,
                 layer_nums: Tuple[int, ...] = (3, 5, 5),
                 layer_strides: Tuple[int, ...] = (2, 2, 2),
                 out_channels: Tuple[int, ...] = (64, 128, 256)):
        super().__init__()
        self.layer_nums = layer_nums
        cin = in_channels
        for s, (n_layers, stride, ch) in enumerate(
                zip(layer_nums, layer_strides, out_channels)):
            setattr(self, f"block{s}_conv0",
                    ConvBN(cin, ch, 3, stride=stride, padding=1,
                           norm="batch"))
            for i in range(n_layers):
                setattr(self, f"block{s}_conv{i + 1}",
                        ConvBN(ch, ch, 3, padding=1, norm="batch"))
            cin = ch

    def forward(self, x):
        outs = []
        for s, n_layers in enumerate(self.layer_nums):
            for i in range(n_layers + 1):
                x = getattr(self, f"block{s}_conv{i}")(x)
            outs.append(x)
        return outs


class BNFPN(nn.Module):
    """mmdet FPN with norm + act ConvModules and max-pool extra levels."""

    def __init__(self, in_channels: Tuple[int, ...] = (64, 128, 256),
                 out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.num_in = len(in_channels)
        self.num_outs = num_outs
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", ConvBN(cin, out_channels, 1,
                                                norm="batch"))
            setattr(self, f"fpn{i}", ConvBN(out_channels, out_channels, 3,
                                            padding=1, norm="batch"))

    def forward(self, feats: Sequence[torch.Tensor]):
        laterals = [getattr(self, f"lateral{i}")(feats[i])
                    for i in range(self.num_in)]
        for i in range(len(laterals) - 1, 0, -1):
            # nearest upsample by index, as the JAX module writes it
            h, w = laterals[i - 1].shape[-2:]
            sh, sw = laterals[i].shape[-2:]
            dev = laterals[i].device
            ry = torch.arange(h, device=dev) * sh // h
            rx = torch.arange(w, device=dev) * sw // w
            laterals[i - 1] = laterals[i - 1] + laterals[i].index_select(
                2, ry).index_select(3, rx)
        outs = [getattr(self, f"fpn{i}")(lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs
