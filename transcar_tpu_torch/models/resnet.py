"""ResNet-50/101 (caffe style) with DCNv2 stages and frozen BN
(``transcar_tpu/models/resnet.py``).

Caffe style puts the stride on each bottleneck's first 1×1 conv, so the
3×3 (or DCN) conv is always stride 1.  Activations are NCHW tensors in
channels-last memory; the DCN conv hands the kernel their free NHWC view.

``block_impl="fused"`` (an opt-in, ``model.backbone.block_impl=fused``)
runs every stride-1 non-DCN bottleneck through ``ops/pallas_bottleneck.py``
(K6 on the GPU) with the folded affines of ``conv1/conv2/conv3/
downsample``; the TPU's VMEM gate ``_pick_rows`` is dropped, since it only
sent blocks back to XLA for want of VMEM.  On ``transcar_r101`` that is
the 6 blocks ``layer1_0..2`` (232 × 400) and ``layer2_1..3`` (116 × 200);
``layer2_0`` (stride 2) and the DCN stages keep the layers.  On a CUDA
tensor the block hands K6's Hopper tile the K-major copies of its conv
weights in the compute dtype, cached.  The phase
stem (``stem_impl="phase"``) computes the same function and is not
ported: it is accepted and only keeps the stem out of int8, as in JAX.

``quantize="int8"`` (the int8 serving mode, ``ops/int8.py``) runs the
stem and every bottleneck's ``conv1``, ``conv3``, ``downsample`` and
non-DCN ``conv2`` as dynamic int8 convolutions (``ConvBN``); the DCN
``conv2`` (K1) and the ``block_impl="fused"`` blocks (K6) stay in the
compute dtype, as in the JAX package.  ``conv1`` and ``downsample``
quantize their shared input once, and ``conv1`` → ``conv2`` → ``conv3``
of a non-DCN block pass the amax of each epilogue on (``ConvBN``).

Training: the stem and the first ``frozen_stages`` stages get
``requires_grad=False`` (mmdet ``_freeze_stages``; frozen BN is buffers
throughout), and ``remat`` recomputes each bottleneck's forward in the
backward (``torch.utils.checkpoint``, the ``nn.remat`` analog).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transcar_tpu_torch.models.common import (Conv2d, ConvBN, FrozenBN,
                                              cached_copy)
from transcar_tpu_torch.ops.dcn import modulated_deform_conv
from transcar_tpu_torch.ops.int8 import quantize_per_tensor
from transcar_tpu_torch.ops.pallas_bottleneck import (bottleneck_fused,
                                                      kmajor_weights)
from transcar_tpu_torch.ops.pallas_dcn import fused_deform_conv, kmajor_weight

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
    the CUDA kernels (K1 forward, K3 backward) on a CUDA tensor and the
    plain version on a CPU one.  The wrapper gets the float32 ``weight``
    and casts it inside, as the JAX module hands ``fused_deform_conv_ad``
    its float32 param, so the weight gradient reaches the optimizer
    unrounded.  On a CUDA tensor it also hands K1's Hopper tile the
    parameter's K-major copy in the compute dtype, cached.
    """

    def __init__(self, in_features: int, features: int, impl: str = "exact"):
        super().__init__()
        if impl not in ("exact", "pallas"):
            raise ValueError(f"unknown dcn impl {impl!r}")
        self.impl = impl
        self.conv_offset = Conv2d(in_features, 27, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))

    def _weight_kmajor(self, dtype) -> torch.Tensor:
        """K1's weight: ``kmajor_weight`` of the [3, 3, Cin, Cout] view,
        [Cout, 3, 3, Cin] in ``dtype`` (:func:`cached_copy`)."""
        w = self.weight
        return cached_copy(self, "_kmajor", [w], dtype, lambda: kmajor_weight(
            w.permute(2, 3, 1, 0), dtype))

    def forward(self, x):
        om = self.conv_offset(x).permute(0, 2, 3, 1)          # NHWC views
        xh = x.permute(0, 2, 3, 1)
        w = self.weight.permute(2, 3, 1, 0)                  # [3,3,Cin,Cout]
        if self.impl == "pallas":
            out = fused_deform_conv(
                xh, om, w, self._weight_kmajor(x.dtype) if x.is_cuda else None)
        else:
            out = modulated_deform_conv(xh, om, w.to(x.dtype))
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: 1×1(stride) → 3×3 or DCN → 1×1, frozen BN.
    ``impl="fused"`` takes the K6 wrapper where the block is stride 1
    without DCN; ``quantize`` applies to its ConvBNs (see the module
    docstring)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 dcn_impl: str = "exact", impl: str = "xla",
                 quantize: str = "none"):
        super().__init__()
        if impl not in ("xla", "fused"):
            raise ValueError(f"unknown block impl {impl!r}")
        self.fused = impl == "fused" and stride == 1 and not with_dcn
        q = dict(quantize=quantize)
        self.conv1 = ConvBN(inplanes, planes, 1, stride=stride, **q)
        if with_dcn:
            self.conv2 = DCNConv(planes, planes, impl=dcn_impl)
            self.bn2 = FrozenBN(planes)
        else:
            self.conv2 = ConvBN(planes, planes, 3, padding=1, **q)
        self.conv3 = ConvBN(planes, planes * 4, 1, relu=False, **q)
        if downsample:
            self.downsample = ConvBN(inplanes, planes * 4, 1, stride=stride,
                                     relu=False, **q)

    def forward(self, x):
        if self.fused:
            return self._fused(x)
        ds = getattr(self, "downsample", None)
        # int8: conv1 and the downsample share one quantize of x (JAX's
        # CSE merges theirs), and each int8 ConvBN feeding the next hands
        # it the amax its epilogue took (no amax pass over its output)
        codes = (quantize_per_tensor(x) if ds is not None
                 and self.conv1.quantize == "int8" else None)
        dcn = hasattr(self, "bn2")
        out, amax = self.conv1.pair(x, codes=codes, want_amax=not dcn)
        if dcn:
            out, amax = F.relu(self.bn2(self.conv2(out))), None
        else:
            out, amax = self.conv2.pair(out, amax=amax, want_amax=True)
        out = self.conv3(out, amax=amax)
        identity = ds(x, codes=codes) if ds is not None else x
        return F.relu(out + identity)

    def _jax_weights(self) -> tuple:
        """The conv weights as the K6 wrapper takes them (JAX layout views):
        w1 [Cin, Cm], w2 [3, 3, Cm, Cm], w3 [Cm, Cout], wd [Cin, Cout] or
        None."""
        mat = lambda conv: conv.conv.weight[:, :, 0, 0].t()
        return (mat(self.conv1), self.conv2.conv.weight.permute(2, 3, 1, 0),
                mat(self.conv3), mat(self.downsample)
                if hasattr(self, "downsample") else None)

    def _kmajor(self, dtype) -> tuple:
        """K6's Hopper-tile weights: :func:`kmajor_weights` in ``dtype``
        (:func:`cached_copy`)."""
        convs = [self.conv1, self.conv2, self.conv3] + (
            [self.downsample] if hasattr(self, "downsample") else [])
        return cached_copy(self, "_kmajor_cache",
                           [c.conv.weight for c in convs], dtype,
                           lambda: kmajor_weights(*self._jax_weights(),
                                                  dtype=dtype))

    def _fused(self, x):
        w1, w2, w3, wd = self._jax_weights()
        kw = {}
        if wd is not None:
            kw = dict(wd=wd, affd=self.downsample.bn.affine())
        out = bottleneck_fused(
            x.permute(0, 2, 3, 1), w1, self.conv1.bn.affine(),
            w2, self.conv2.bn.affine(), w3, self.conv3.bn.affine(), **kw,
            kmajor=self._kmajor(x.dtype) if x.is_cuda else None)
        return out.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """Multi-stage ResNet returning the C2..C5 feature maps (NCHW)."""

    def __init__(self, depth: int = 101,
                 with_dcn: Tuple[bool, ...] = (False, False, True, True),
                 compute_dtype: Optional[str] = "bfloat16",
                 dcn_impl: str = "exact", frozen_stages: int = 1,
                 remat: bool = False, block_impl: str = "xla",
                 quantize: str = "none", stem_impl: str = "xla"):
        super().__init__()
        if stem_impl not in ("xla", "phase"):
            raise ValueError(f"unknown stem_impl {stem_impl!r}")
        self.remat = remat
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        self.stem = ConvBN(3, 64, 7, stride=2, padding=3, quantize=(
            quantize if stem_impl == "xla" else "none"))
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
                    dcn_impl=dcn_impl, impl=block_impl, quantize=quantize))
                names.append(name)
                inplanes = planes * 4
            self.block_names.append(names)
            planes *= 2
        frozen = ["stem"] if frozen_stages >= 0 else []
        for names in self.block_names[:max(frozen_stages, 0)]:
            frozen += names
        for name in frozen:
            getattr(self, name).requires_grad_(False)

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        outs = []
        for names in self.block_names:
            for name in names:
                block = getattr(self, name)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            outs.append(x)
        return outs
