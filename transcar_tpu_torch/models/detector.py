"""Top-level detector: 6-camera batch → backbone → FPN → TransCAR head
(``transcar_tpu/models/detector.py``).

The public layout is the JAX package's: images [B, N, H, W, 3] (NHWC,
normalized float32), lidar2img [B, N, 4, 4], radar tokens [B, T, 36].
The backbone and FPN compute in ``BackboneConfig.compute_dtype``
(bfloat16 on the flagship) on channels-last NCHW tensors; the FPN levels
reach the head as NHWC in ``head_input_dtype`` (float32).

In training mode (``model.train()``) GridMask runs on the images when
``use_grid_mask`` and dropout runs in the head.  ``stop_camera_grad``
(fusion-only training) runs the whole camera forward, backbone, FPN and
decoder, without a graph: the reference sets ``requires_grad=False`` on
the camera net and the JAX package builds no camera backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from transcar_tpu_torch.data.gridmask import grid_mask
from transcar_tpu_torch.models.common import Conv2d, TorchMHA, disable_tf32
from transcar_tpu_torch.models.fpn import FPN
from transcar_tpu_torch.models.head import TransCARHead
from transcar_tpu_torch.models.resnet import DCNConv, ResNet


class TransCARDetector(nn.Module):
    def __init__(self, cfg, dcn_impl: str = "exact", remat: bool = False,
                 dropout: float = 0.1):
        """cfg: a ``ModelConfig``; dcn_impl: "exact" | "pallas" (resolved
        by :func:`build_model`, see :func:`resolve_dcn_impl`); remat:
        recompute backbone blocks in the backward; dropout: the head's
        training dropout rate."""
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone
        if bc.kind not in ("resnet101", "resnet50"):
            raise NotImplementedError(
                f"backbone {bc.kind!r} is not ported yet (ROADMAP.md "
                "Queue 1 item 9: the VoVNet-99 preset)")
        self.backbone = ResNet(depth=int(bc.kind[6:]), with_dcn=bc.with_dcn,
                               compute_dtype=bc.compute_dtype,
                               dcn_impl=dcn_impl,
                               frozen_stages=bc.frozen_stages, remat=remat)
        self.neck = FPN(in_channels=bc.fpn_in_channels,
                        out_channels=bc.fpn_out_channels,
                        start_level=bc.fpn_start_level,
                        num_outs=bc.fpn_num_outs,
                        add_extra_convs=bc.fpn_add_extra_convs,
                        relu_before_extra_convs=bc.fpn_relu_before_extra_convs)
        self.head = TransCARHead(cfg.head, dropout=dropout)

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                radar_tokens: Optional[torch.Tensor] = None,
                stop_camera_grad: bool = False,
                generator: Optional[torch.Generator] = None):
        """images: [B, N, H, W, 3]; lidar2img: [B, N, 4, 4]; radar_tokens:
        [B, T, 36] (required when the head has radar fusion);
        stop_camera_grad: fusion-only training (see the module
        docstring); generator: GridMask's draws in training.  Returns the
        head's dict (all_cls_scores / all_bbox_preds)."""
        b, n, h, w, _ = images.shape
        x = images.reshape(b * n, h, w, 3)
        if self.training and self.cfg.use_grid_mask:
            if generator is None:
                raise ValueError("training with use_grid_mask needs a "
                                 "torch.Generator for GridMask")
            x = grid_mask(x, generator)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_camera_grad):
            feats = self.neck(self.backbone(x.permute(0, 3, 1, 2)))
        head_dt = getattr(torch, self.cfg.backbone.head_input_dtype)
        mlvl = [f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:],
                                               f.shape[1]).to(head_dt)
                for f in feats]
        return self.head(mlvl, lidar2img, (h, w), radar_tokens,
                         stop_camera_grad=stop_camera_grad)


def resolve_dcn_impl(cfg) -> str:
    """``BackboneConfig.dcn_impl``: "auto" and "pallas" take the kernel
    wrapper (ops/pallas_dcn.py: the CUDA kernel on the GPU, the plain
    version on the CPU); "exact" takes the plain version everywhere."""
    impl = cfg.model.backbone.dcn_impl
    if impl not in ("auto", "exact", "pallas"):
        raise ValueError(f"unknown dcn_impl {impl!r}")
    return "exact" if impl == "exact" else "pallas"


def camera_branch_trains(cfg) -> bool:
    """True when the camera net (backbone, FPN, decoder) receives
    gradients: the TransCAR recipe freezes the whole camera net
    (tools/train.py:238-252), so only the camera-only full-training track
    (freeze_camera_branch=False or no fusion head) trains it."""
    return not (cfg.train.optim.freeze_camera_branch
                and cfg.model.head.with_radar_fusion)


def resolve_remat(cfg) -> bool:
    """``BackboneConfig.remat``: "on" and "off" force either way; "auto"
    is off.  The JAX package turned "auto" on for full-backbone training
    to fit a TPU v5e's 16 GB; the H100's 80 GB holds that step without
    recomputation, and recomputation changes no number."""
    remat = cfg.model.backbone.remat
    if remat not in ("auto", "on", "off"):
        raise ValueError(f"unknown remat {remat!r}")
    return remat == "on"


def build_model(cfg, device="cpu", training: bool = False,
                seed: int = 0, dropout: float = 0.1) -> TransCARDetector:
    """Camera/fusion presets → TransCARDetector on ``device`` with seeded
    random weights (load real ones with ``load_state_dict``), in train
    mode when ``training`` (GridMask, ``dropout`` in the head) and eval
    mode otherwise.

    TPU-only knobs change no math and are accepted as no-ops:
    ``dcn_band_rows``, ``dcn_rows_per_step`` and ``dcn_variant`` (the
    kernels are exact for any offset, so full-backbone training needs no
    band widening), ``stem_impl``, ``block_impl`` and ``osa_reduce_impl``.
    """
    m = cfg.model
    if m.lidar_encoder:
        raise NotImplementedError(
            f"LiDAR preset {cfg.name!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 10: ObjDGCNN)")
    if m.backbone.quantize != "none" and not training:
        raise NotImplementedError(
            f"quantize={m.backbone.quantize!r} changes the numbers and "
            "waits for ops/int8.py (ROADMAP.md Queue 1 item 11)")
    disable_tf32()
    model = TransCARDetector(m, dcn_impl=resolve_dcn_impl(cfg),
                             remat=resolve_remat(cfg),
                             dropout=dropout)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train(training)


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
