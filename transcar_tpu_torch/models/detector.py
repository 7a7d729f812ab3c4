"""Top-level detector: 6-camera batch → backbone → FPN → TransCAR head
(``transcar_tpu/models/detector.py``), inference only.

The public layout is the JAX package's: images [B, N, H, W, 3] (NHWC,
normalized float32), lidar2img [B, N, 4, 4], radar tokens [B, T, 36].
The backbone and FPN compute in ``BackboneConfig.compute_dtype``
(bfloat16 on the flagship) on channels-last NCHW tensors; the FPN levels
reach the head as NHWC in ``head_input_dtype`` (float32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from transcar_tpu_torch.models.common import Conv2d, TorchMHA, disable_tf32
from transcar_tpu_torch.models.fpn import FPN
from transcar_tpu_torch.models.head import TransCARHead
from transcar_tpu_torch.models.resnet import DCNConv, ResNet


class TransCARDetector(nn.Module):
    def __init__(self, cfg, dcn_impl: str = "exact"):
        """cfg: a ``ModelConfig``; dcn_impl: "exact" | "pallas" (resolved
        by :func:`build_model`, see :func:`resolve_dcn_impl`)."""
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone
        if bc.kind not in ("resnet101", "resnet50"):
            raise NotImplementedError(
                f"backbone {bc.kind!r} is not ported yet (ROADMAP.md "
                "Queue 1 item 9: the VoVNet-99 preset)")
        self.backbone = ResNet(depth=int(bc.kind[6:]), with_dcn=bc.with_dcn,
                               compute_dtype=bc.compute_dtype,
                               dcn_impl=dcn_impl)
        self.neck = FPN(in_channels=bc.fpn_in_channels,
                        out_channels=bc.fpn_out_channels,
                        start_level=bc.fpn_start_level,
                        num_outs=bc.fpn_num_outs,
                        add_extra_convs=bc.fpn_add_extra_convs,
                        relu_before_extra_convs=bc.fpn_relu_before_extra_convs)
        self.head = TransCARHead(cfg.head)

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                radar_tokens: Optional[torch.Tensor] = None):
        """images: [B, N, H, W, 3]; lidar2img: [B, N, 4, 4]; radar_tokens:
        [B, T, 36] (required when the head has radar fusion).  Returns the
        head's dict (all_cls_scores / all_bbox_preds)."""
        b, n, h, w, _ = images.shape
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
        feats = self.neck(self.backbone(x))
        head_dt = getattr(torch, self.cfg.backbone.head_input_dtype)
        mlvl = [f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:],
                                               f.shape[1]).to(head_dt)
                for f in feats]
        return self.head(mlvl, lidar2img, (h, w), radar_tokens)


def resolve_dcn_impl(cfg) -> str:
    """``BackboneConfig.dcn_impl``: "auto" and "pallas" take the kernel
    wrapper (ops/pallas_dcn.py: the CUDA kernel on the GPU, the plain
    version on the CPU); "exact" takes the plain version everywhere."""
    impl = cfg.model.backbone.dcn_impl
    if impl not in ("auto", "exact", "pallas"):
        raise ValueError(f"unknown dcn_impl {impl!r}")
    return "exact" if impl == "exact" else "pallas"


def build_model(cfg, device="cpu", training: bool = False,
                seed: int = 0) -> TransCARDetector:
    """Camera/fusion presets → TransCARDetector on ``device``, in eval mode,
    with seeded random weights (load real ones with ``load_state_dict``).

    TPU-only knobs change no math and are accepted as no-ops:
    ``dcn_band_rows``, ``dcn_rows_per_step`` and ``dcn_variant`` (the
    kernel is exact for any offset), ``stem_impl``, ``block_impl``,
    ``osa_reduce_impl`` and ``remat`` (no backward is built).
    """
    m = cfg.model
    if training:
        raise NotImplementedError("training is not ported yet (ROADMAP.md "
                                  "Queue 1 items 6-7)")
    if m.lidar_encoder:
        raise NotImplementedError(
            f"LiDAR preset {cfg.name!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 10: ObjDGCNN)")
    if m.backbone.quantize != "none":
        raise NotImplementedError(
            f"quantize={m.backbone.quantize!r} changes the numbers and "
            "waits for ops/int8.py (ROADMAP.md Queue 1 item 11)")
    disable_tf32()
    model = TransCARDetector(m, dcn_impl=resolve_dcn_impl(cfg))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init after the JAX package's flax initializers:
    lecun-normal convs and linears with zero biases, he-normal DCN
    weights, zero DCN offset convs (mmcv) and cross-attention weights,
    xavier-uniform attention and reference-point projections, N(0, 1)
    query embeddings; norms keep their identity construction."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def xavier_(t, fan_in, fan_out):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, DCNConv):
                nn.init.zeros_(mod.conv_offset.weight)
                nn.init.zeros_(mod.conv_offset.bias)
                normal_(mod.weight, math.sqrt(2.0 / mod.weight[0].numel()))
            elif isinstance(mod, Conv2d) and not name.endswith("conv_offset"):
                normal_(mod.weight, math.sqrt(1.0 / mod.weight[0].numel()))
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Linear):
                if name.endswith("attention_weights"):
                    nn.init.zeros_(mod.weight)
                elif name.endswith("reference_points"):
                    xavier_(mod.weight, mod.in_features, mod.out_features)
                else:
                    normal_(mod.weight, math.sqrt(1.0 / mod.in_features))
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, TorchMHA):
                for p in (mod.wq, mod.wk, mod.wv, mod.wo):
                    xavier_(p, *p.shape)
        normal_(model.head.query_embedding, 1.0)
