"""VoVNet-99-eSE backbone (``transcar_tpu/models/vovnet.py``), the
``transcar_vovnet_trainval`` preset's.

Spec "V-99-eSE": stem (64, 64, 128) with strides (2, 1, 2), stage conv
channels (128, 160, 192, 224), stage out channels (256, 512, 768, 1024),
5 convs per OSA block, blocks per stage (1, 3, 9, 3).  eSE channel
attention in every OSA block, the identity added after it on every
non-first block of a stage, a 3×3 / stride-2 ceil-mode max-pool before
stages 3-5, frozen BN.  Activations are NCHW tensors in channels-last
memory, as in ``models/resnet.py``; the kernels take their NHWC views.

``OSABlock.reduce_impl`` picks the block's tail, with one parameter tree
(``conv{i}``, ``concat``, ``ese.fc``) for all three:

  * ``"xla"``: the plain layers (concatenation, 1×1 ConvBN, eSE), which
    autograd differentiates; training takes it.
  * ``"pallas"``: the chain as ConvBN layers, then the concat-free reduce
    of ``ops/pallas_osa.py`` (K4 on the GPU), whose channel sums feed the
    eSE gate.
  * ``"fused"``: the whole block through ``ops/pallas_osa_block.py`` (K5
    on the GPU), an opt-in through ``VoVNet(stage_impls=...)``.

The kernel paths gate from ``gap = sums / (H·W)`` cast to the activation
dtype before the 1×1 ``fc``, as the JAX module does.  ``stem_impl``
("xla" | "phase": the same function) and the TPU tiling knobs
``rows_per_chunk`` / ``STAGE_CHUNK_ROWS`` change nothing here.

``quantize="int8"`` (the int8 serving mode, ``ops/int8.py``) runs the
three stem convs (unless ``stem_impl="phase"``, as in JAX) and every
block's chain convs as dynamic int8 convolutions; the 1×1 concat reduce
only on the ``"xla"`` tail.  The K4 (``"pallas"``) reduce keeps the
compute dtype, and the ``"fused"`` (K5) blocks ignore it, as the JAX
package does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transcar_tpu_torch.models.common import Conv2d, ConvBN, cached_copy
from transcar_tpu_torch.ops.pallas_osa import kmajor_weights, osa_reduce
from transcar_tpu_torch.ops.pallas_osa_block import (kmajor_conv_weight,
                                                     osa_block_fused)

V99_SPEC = dict(
    stem=(64, 64, 128),
    stage_conv_ch=(128, 160, 192, 224),
    stage_out_ch=(256, 512, 768, 1024),
    layer_per_block=5,
    block_per_stage=(1, 3, 9, 3),
)

REDUCE_IMPLS = ("xla", "pallas", "fused")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of a channels-last NCHW tensor (a copy otherwise)."""
    return x.permute(0, 2, 3, 1).contiguous()


class _eSEGate(nn.Module):
    """eSE gate from a precomputed per-image mean [N, C, 1, 1]: the
    hard-sigmoid ``clip(fc(mean) + 3, 0, 6) / 6``."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, mean):
        return torch.clamp(self.fc(mean) + 3.0, 0.0, 6.0) / 6.0


class eSE(_eSEGate):
    """Effective squeeze-excitation: global average pool, 1×1 ``fc``,
    hard-sigmoid gate, times the input (same ``fc`` as the gate)."""

    def forward(self, x):
        return x * super().forward(x.mean((2, 3), keepdim=True))


class OSABlock(nn.Module):
    """One-shot aggregation: chain of 3×3 ConvBNs, concatenation of the
    input and every chain output, 1×1 ConvBN reduce, eSE, and the
    identity when ``identity``."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, identity: bool = False,
                 reduce_impl: str = "xla", quantize: str = "none"):
        super().__init__()
        if reduce_impl not in REDUCE_IMPLS:
            raise ValueError(f"unknown reduce_impl {reduce_impl!r}")
        self.identity = identity
        self.reduce_impl = reduce_impl
        self.n_convs = layer_per_block
        self.widths = [in_ch] + [stage_ch] * layer_per_block
        cin = in_ch
        for i in range(layer_per_block):
            setattr(self, f"conv{i}", ConvBN(cin, stage_ch, 3, padding=1,
                                             quantize=quantize))
            cin = stage_ch
        self.concat = ConvBN(sum(self.widths), concat_ch, 1, quantize=(
            quantize if reduce_impl == "xla" else "none"))
        self.ese = (eSE if reduce_impl == "xla" else _eSEGate)(concat_ch)

    def _reduce_kmajor(self, dtype) -> list:
        """K4's weights: K-major [Cᵢ, Cout] views in ``dtype``
        (:func:`kmajor_weights`, :func:`cached_copy`)."""
        w = self.concat.conv.weight
        return cached_copy(self, "_kmajor", [w], dtype,
                           lambda: kmajor_weights(w, self.widths, dtype))

    def _chain_kmajor(self, dtype) -> list:
        """K5's chain weights: K-major [Ch, 3, 3, Cinᵢ] copies in ``dtype``
        (:func:`kmajor_conv_weight`, :func:`cached_copy`)."""
        ws = [getattr(self, f"conv{i}").conv.weight
              for i in range(self.n_convs)]
        return cached_copy(self, "_chain", ws, dtype, lambda: [
            kmajor_conv_weight(w.permute(2, 3, 1, 0), dtype) for w in ws])

    def forward(self, x):
        identity = x
        if self.reduce_impl == "fused":
            convs = [getattr(self, f"conv{i}") for i in range(self.n_convs)]
            out, sums = osa_block_fused(
                _nhwc(x), [c.conv.weight.permute(2, 3, 1, 0) for c in convs],
                [c.bn.affine() for c in convs],
                self._reduce_kmajor(x.dtype), self.concat.bn.affine(),
                conv_kmajor=(self._chain_kmajor(x.dtype) if x.is_cuda
                             else None))
        else:
            outputs = [x]
            for i in range(self.n_convs):
                outputs.append(getattr(self, f"conv{i}")(outputs[-1]))
            if self.reduce_impl == "xla":
                x = self.ese(self.concat(torch.cat(outputs, 1)))
                return x + identity if self.identity else x
            out, sums = osa_reduce([_nhwc(o) for o in outputs],
                                   self._reduce_kmajor(x.dtype),
                                   *self.concat.bn.affine(), relu=True)
        n, h, w, c = out.shape
        gap = (sums / float(h * w)).to(out.dtype).reshape(n, c, 1, 1)
        x = out.permute(0, 3, 1, 2) * self.ese(gap)
        return x + identity if self.identity else x


class VoVNet(nn.Module):
    """V-99-eSE returning the stage 2..5 feature maps (NCHW).

    ``reduce_impl`` applies to every stage ("pallas" through
    ``PALLAS_STAGE_IMPLS``) unless ``stage_impls`` names one impl per
    stage.  ``remat`` recomputes each OSA block in the backward
    (``torch.utils.checkpoint``).  The stem and the first
    ``frozen_stages`` stages get ``requires_grad=False``, as
    ``models/resnet.py`` does (mmdet VoVNet ``_freeze_stages``).
    """

    PALLAS_STAGE_IMPLS = ("pallas", "pallas", "pallas", "pallas")

    def __init__(self, out_stages: Sequence[int] = (2, 3, 4, 5),
                 compute_dtype: Optional[str] = "bfloat16",
                 reduce_impl: str = "xla",
                 stage_impls: Optional[Tuple[str, ...]] = None,
                 stem_impl: str = "xla", remat: bool = False,
                 frozen_stages: int = 1, quantize: str = "none"):
        super().__init__()
        if stem_impl not in ("xla", "phase"):
            raise ValueError(f"unknown stem_impl {stem_impl!r}")
        self.out_stages = tuple(out_stages)
        self.remat = remat
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        spec = V99_SPEC
        s1, s2, s3 = spec["stem"]
        sq = quantize if stem_impl == "xla" else "none"
        self.stem1 = ConvBN(3, s1, 3, stride=2, padding=1, quantize=sq)
        self.stem2 = ConvBN(s1, s2, 3, stride=1, padding=1, quantize=sq)
        self.stem3 = ConvBN(s2, s3, 3, stride=2, padding=1, quantize=sq)
        if stage_impls is None:
            stage_impls = (self.PALLAS_STAGE_IMPLS if reduce_impl == "pallas"
                           else (reduce_impl,) * 4)
        self.stage_impls = tuple(stage_impls)
        self.block_names = []
        cin = s3
        for si in range(4):
            names = []
            for b in range(spec["block_per_stage"][si]):
                name = f"stage{si + 2}_block{b}"
                setattr(self, name, OSABlock(
                    cin, spec["stage_conv_ch"][si], spec["stage_out_ch"][si],
                    spec["layer_per_block"], identity=b > 0,
                    reduce_impl=self.stage_impls[si], quantize=quantize))
                names.append(name)
                cin = spec["stage_out_ch"][si]
            self.block_names.append(names)
        frozen = ["stem1", "stem2", "stem3"] if frozen_stages >= 0 else []
        for names in self.block_names[:max(frozen_stages, 0)]:
            frozen += names
        for name in frozen:
            getattr(self, name).requires_grad_(False)

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.stem3(self.stem2(self.stem1(x)))
        outs = []
        for si, names in enumerate(self.block_names):
            if si > 0:
                # 3×3 / 2 ceil mode: H // 2 rows for every H, as the JAX
                # pad of (0, 2·(H//2 − 1) + 3 − H) gives
                x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
            for name in names:
                block = getattr(self, name)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            if si + 2 in self.out_stages:
                outs.append(x)
        return outs
