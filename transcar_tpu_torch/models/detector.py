"""Top-level detector: 6-camera batch → backbone → FPN → TransCAR head
(``transcar_tpu/models/detector.py``); :func:`build_model` also builds the
LiDAR presets' ObjDGCNN (``models/dgcnn.py``).

The public layout is the JAX package's: images [B, N, H, W, 3] (NHWC,
normalized float32), lidar2img [B, N, 4, 4], radar tokens [B, T, 36].
The backbone and FPN compute in ``BackboneConfig.compute_dtype``
(bfloat16 on the flagship) on channels-last NCHW tensors; the FPN levels
reach the head as NHWC in ``head_input_dtype`` (float32).

:meth:`TransCARDetector.aug_forward` is the test-time augmentation entry:
backbone and FPN features averaged over A augmented views, then one head.

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
from transcar_tpu_torch.models.common import (QUANTIZE_MODES, Conv2d, TorchMHA,
                                              disable_tf32)
from transcar_tpu_torch.models.dgcnn import MSDeformAttention, ObjDGCNN
from transcar_tpu_torch.models.fpn import FPN
from transcar_tpu_torch.models.head import TransCARHead
from transcar_tpu_torch.models.resnet import DCNConv, ResNet
from transcar_tpu_torch.models.sparse_encoder import SparseConvBlock
from transcar_tpu_torch.models.vovnet import VoVNet


class TransCARDetector(nn.Module):
    def __init__(self, cfg, dcn_impl: str = "exact", remat: bool = False,
                 dropout: float = 0.1, osa_reduce_impl: str = "xla",
                 block_impl: str = "xla", quantize: str = "none"):
        """cfg: a ``ModelConfig``; dcn_impl: "exact" | "pallas" (resolved
        by :func:`build_model`, see :func:`resolve_dcn_impl`); remat:
        recompute backbone blocks in the backward; dropout: the head's
        training dropout rate; osa_reduce_impl: the VoVNet OSA tail,
        "xla" | "pallas" | "fused"; block_impl: the ResNet stride-1
        non-DCN bottlenecks, "xla" | "fused"; quantize: the backbone's
        convs, "none" | "int8" (serving only; see :func:`build_model`)."""
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone
        stem = bc.stem_impl if bc.stem_impl != "auto" else "xla"
        if bc.kind in ("resnet101", "resnet50"):
            self.backbone = ResNet(
                depth=int(bc.kind[6:]), with_dcn=bc.with_dcn,
                compute_dtype=bc.compute_dtype, dcn_impl=dcn_impl,
                frozen_stages=bc.frozen_stages, remat=remat,
                block_impl=block_impl, quantize=quantize, stem_impl=stem)
        elif bc.kind == "vovnet99":
            self.backbone = VoVNet(
                compute_dtype=bc.compute_dtype, reduce_impl=osa_reduce_impl,
                stem_impl=stem, remat=remat, frozen_stages=bc.frozen_stages,
                quantize=quantize)
        else:
            raise ValueError(f"unknown backbone {bc.kind!r}")
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
            mlvl = self._features(x, b, n)
        return self.head(mlvl, lidar2img, (h, w), radar_tokens,
                         stop_camera_grad=stop_camera_grad)

    def _features(self, x: torch.Tensor, b: int, n: int):
        return camera_features(self.backbone, self.neck, self.cfg, x, b, n)

    def aug_forward(self, images_augs: torch.Tensor, lidar2img: torch.Tensor,
                    radar_tokens: Optional[torch.Tensor] = None):
        """Test-time augmentation: backbone + FPN features averaged over
        the augmented copies, then the head once (the JAX method,
        ``aug_test_pts`` of the reference).  images_augs: [A, B, N, H, W,
        3], A augmented views of the batch."""
        a, b, n, h, w, _ = images_augs.shape
        total = None
        for ai in range(a):
            mlvl = self._features(images_augs[ai].reshape(b * n, h, w, 3),
                                  b, n)
            total = mlvl if total is None else [
                acc + f for acc, f in zip(total, mlvl)]
        return self.head([f / a for f in total], lidar2img, (h, w),
                         radar_tokens)


def camera_features(backbone: nn.Module, neck: nn.Module, cfg,
                    x: torch.Tensor, b: int, n: int):
    """Backbone + FPN of images [B·N, H, W, 3] (``cfg``: a
    ``ModelConfig``): the levels as [B, N, h, w, C] in
    ``head_input_dtype``."""
    feats = neck(backbone(x.permute(0, 3, 1, 2)))
    head_dt = getattr(torch, cfg.backbone.head_input_dtype)
    return [f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:],
                                          f.shape[1]).to(head_dt)
            for f in feats]


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


def resolve_osa_reduce_impl(cfg, training: bool = False) -> str:
    """``BackboneConfig.osa_reduce_impl``: "auto" takes the K4 wrapper
    ("pallas") at inference and the plain layers ("xla") in training, as
    the JAX ``build_model`` does (the kernel is forward-only); "pallas",
    "xla" and "fused" (K5) as given."""
    impl = cfg.model.backbone.osa_reduce_impl
    if impl not in ("auto", "xla", "pallas", "fused"):
        raise ValueError(f"unknown osa_reduce_impl {impl!r}")
    if impl == "auto":
        return "xla" if training else "pallas"
    return impl


def resolve_quantize(cfg, training: bool = False) -> str:
    """``BackboneConfig.quantize``: "int8" is a serving mode, so training
    always builds the float path ("none"), as the JAX ``build_model``
    does (rounding has no useful derivative); an unknown value raises."""
    quantize = cfg.model.backbone.quantize
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize {quantize!r} (one of "
                         f"{QUANTIZE_MODES})")
    return "none" if training else quantize


def resolve_block_impl(cfg) -> str:
    """``BackboneConfig.block_impl``: "auto" is the plain layers ("xla"),
    as in the JAX ``build_model``; "fused" takes the K6 wrapper."""
    impl = cfg.model.backbone.block_impl
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown block_impl {impl!r}")
    return "xla" if impl == "auto" else impl


def resolve_encoder_band(cfg) -> None:
    """``ModelConfig.encoder_band_rows`` is the TPU encoder kernel's row
    band: a no-op here, since K7 is exact for any offset, but a value the
    JAX ``build_model`` refuses is refused here too, so presets and
    overrides stay shared."""
    m = cfg.model
    band = m.encoder_band_rows
    if band > 0:
        h_min = m.bev_hw[0] >> (m.head.num_levels - 1)
        if band % 2 or band < 4 or band > h_min:
            raise ValueError(
                f"model.encoder_band_rows={band} must be an even value in "
                f"[4, {h_min}] (smallest encoder level's rows, "
                f"bev_hw[0]={m.bev_hw[0]} over {m.head.num_levels} levels)")


def build_model(cfg, device="cuda", training: bool = False,
                seed: int = 0, dropout: float = 0.1) -> nn.Module:
    """Camera/fusion presets → TransCARDetector, ``lidar_encoder`` presets
    (``objdgcnn_pillar``, ``objdgcnn_voxel``) → ObjDGCNN, on ``device``
    with seeded random weights (load real ones with ``load_state_dict``),
    in train mode when
    ``training`` (GridMask, ``dropout`` in the head; for ObjDGCNN, batch
    statistics in every BatchNorm) and eval mode otherwise.  The model
    goes to the card unless the caller passes ``device="cpu"``; without
    CUDA that default raises.

    Kernel knobs: ``dcn_impl`` (:func:`resolve_dcn_impl`),
    ``osa_reduce_impl`` (:func:`resolve_osa_reduce_impl`),
    ``block_impl`` (:func:`resolve_block_impl`) and ``quantize``
    (:func:`resolve_quantize`: the int8 serving mode of
    ``ops/int8.py``, forced off in training); ObjDGCNN's deformable
    attention always takes the kernel wrapper (K7, and K8 / K9 in the
    backward); ``objdgcnn_voxel``'s sparse encoder is plain PyTorch in
    either ``sparse_impl`` (the JAX package runs it as XLA too).
    TPU-only knobs change no math and are accepted as no-ops:
    ``dcn_band_rows``, ``dcn_rows_per_step`` and ``dcn_variant`` (the
    kernels are exact for any offset, so full-backbone training needs no
    band widening), ``stem_impl`` and ``encoder_band_rows`` (validated as
    in JAX, :func:`resolve_encoder_band`).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: device cuda, but "
                           "torch.cuda.is_available() is False (pass "
                           "device=\"cpu\" for a CPU model)")
    m = cfg.model
    if m.lidar_encoder:
        resolve_encoder_band(cfg)
        disable_tf32()
        model = ObjDGCNN(m.head, encoder=m.lidar_encoder,
                         voxel_size=m.voxel_size,
                         max_points=m.max_points_per_voxel,
                         max_voxels=m.max_voxels, bev_hw=m.bev_hw,
                         compute_dtype=m.lidar_compute_dtype,
                         dropout=dropout, sparse_shape=m.sparse_shape,
                         sparse_impl=m.sparse_impl)
        init_weights(model, torch.Generator().manual_seed(seed))
        model = model.to(device=device, memory_format=torch.channels_last)
        return model.train(training)
    quantize = resolve_quantize(cfg, training)
    disable_tf32()
    model = TransCARDetector(m, dcn_impl=resolve_dcn_impl(cfg),
                             remat=resolve_remat(cfg),
                             dropout=dropout,
                             osa_reduce_impl=resolve_osa_reduce_impl(
                                 cfg, training),
                             block_impl=resolve_block_impl(cfg),
                             quantize=quantize)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train(training)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init after the JAX package's flax initializers:
    lecun-normal convs and linears with zero biases, he-normal DCN and
    sparse-conv weights (a sparse conv's [27, Cin, Cout] has fan-in
    27·Cin), zero DCN offset convs (mmcv) and cross-attention weights,
    xavier-uniform attention and reference-point projections, N(0, 1)
    query and level embeddings, and for MSDeformAttn mmcv's zero
    ``sampling_offsets`` kernel with the circle bias; norms keep their
    identity construction."""
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
            elif isinstance(mod, SparseConvBlock):
                fan_in = mod.weight[:, :, 0].numel()
                normal_(mod.weight, math.sqrt(2.0 / fan_in))
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
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, TorchMHA):
                for p in (mod.wq, mod.wk, mod.wv, mod.wo):
                    xavier_(p, *p.shape)
        for mod in model.modules():
            if isinstance(mod, MSDeformAttention):
                nn.init.zeros_(mod.sampling_offsets.weight)
                mod.sampling_offsets.bias.copy_(mod.offset_bias())
        if hasattr(model, "head"):            # also takes a bare backbone
            normal_(model.head.query_embedding, 1.0)
            if hasattr(model.head, "level_embeds"):
                normal_(model.head.level_embeds, 1.0)
