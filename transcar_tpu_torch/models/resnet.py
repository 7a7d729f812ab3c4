"""ResNet-50/101 (caffe style) with DCNv2 stages and frozen BN
(``transcar_tpu/models/resnet.py``).

Caffe style puts the stride on each bottleneck's first 1×1 conv, so the
3×3 (or DCN) conv is always stride 1.  Activations are NCHW tensors in
channels-last memory; the DCN conv hands the kernel their free NHWC view.
The JAX package's opt-in variants (int8, the phase stem, the fused
bottleneck) are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.models.common import Conv2d, ConvBN, FrozenBN
from transcar_tpu_torch.ops.dcn import modulated_deform_conv
from transcar_tpu_torch.ops.pallas_dcn import fused_deform_conv

RESNET_DEPTHS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class DCNConv(nn.Module):
    """DCNv2 3×3 stride-1 layer: zero-initialized ``conv_offset`` (mmcv
    ModulatedDeformConv2dPack) + the deformable conv ``weight``
    [Cout, Cin, 3, 3].

    ``impl="exact"`` calls the plain version (ops/dcn.py) on any device;
    ``"pallas"`` calls the kernel wrapper (ops/pallas_dcn.py), which runs
    the CUDA kernel on a CUDA tensor and the plain version on a CPU one.
    """

    def __init__(self, in_features: int, features: int, impl: str = "exact"):
        super().__init__()
        if impl not in ("exact", "pallas"):
            raise ValueError(f"unknown dcn impl {impl!r}")
        self.impl = impl
        self.conv_offset = Conv2d(in_features, 27, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))

    def forward(self, x):
        om = self.conv_offset(x).permute(0, 2, 3, 1)          # NHWC views
        xh = x.permute(0, 2, 3, 1)
        w = self.weight.permute(2, 3, 1, 0).to(x.dtype)      # [3,3,Cin,Cout]
        if self.impl == "pallas":
            out = fused_deform_conv(xh, om, w)
        else:
            out = modulated_deform_conv(xh, om, w)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: 1×1(stride) → 3×3 or DCN → 1×1, frozen BN."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 dcn_impl: str = "exact"):
        super().__init__()
        self.conv1 = ConvBN(inplanes, planes, 1, stride=stride)
        if with_dcn:
            self.conv2 = DCNConv(planes, planes, impl=dcn_impl)
            self.bn2 = FrozenBN(planes)
        else:
            self.conv2 = ConvBN(planes, planes, 3, padding=1)
        self.conv3 = ConvBN(planes, planes * 4, 1, relu=False)
        if downsample:
            self.downsample = ConvBN(inplanes, planes * 4, 1, stride=stride,
                                     relu=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if hasattr(self, "bn2"):
            out = F.relu(self.bn2(out))
        out = self.conv3(out)
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Multi-stage ResNet returning the C2..C5 feature maps (NCHW)."""

    def __init__(self, depth: int = 101,
                 with_dcn: Tuple[bool, ...] = (False, False, True, True),
                 compute_dtype: Optional[str] = "bfloat16",
                 dcn_impl: str = "exact"):
        super().__init__()
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        self.stem = ConvBN(3, 64, 7, stride=2, padding=3)
        self.block_names = []
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(RESNET_DEPTHS[depth]):
            names = []
            for b in range(num_blocks):
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, Bottleneck(
                    inplanes, planes,
                    stride=(1 if stage == 0 else 2) if b == 0 else 1,
                    downsample=(b == 0), with_dcn=with_dcn[stage],
                    dcn_impl=dcn_impl))
                names.append(name)
                inplanes = planes * 4
            self.block_names.append(names)
            planes *= 2

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        outs = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs
