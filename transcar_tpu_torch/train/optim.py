"""Optimizer: AdamW with parameter groups, the freeze rules and the warmup ×
cosine schedule (``transcar_tpu/train/optim.py``).

  * AdamW, betas (0.9, 0.999), eps 1e-8, weight decay on every trainable
    parameter: ``torch.optim.AdamW`` makes the same update as
    ``optax.adamw``.
  * Groups as the JAX ``make_labels``: ``main``, ``backbone`` at
    lr × ``backbone_lr_mult``, and ``frozen``, whose parameters get
    ``requires_grad=False`` and stay out of the optimizer (no update, no
    weight decay, not in the clip norm).
  * The lr schedule is evaluated at the step count before the update (0
    for the first step), as optax does: ``LambdaLR`` starts at 0 and is
    stepped after each optimizer step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

_FUSION_PREFIXES = ("fusion", "final_cls", "final_reg", "radar_")


def lr_schedule(cfg, total_steps: int) -> Callable[[int], float]:
    """lr factor at a step: linear warmup from ``warmup_ratio`` over
    ``warmup_iters``, times a cosine from 1 to ``min_lr_ratio`` over
    ``total_steps`` (``cfg``: an ``OptimConfig``)."""
    def factor(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
            1.0 + math.cos(math.pi * frac))
        warm_frac = min(max(step / max(cfg.warmup_iters, 1), 0.0), 1.0)
        warm = cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * warm_frac
        return cos * warm

    return factor


def make_labels(model: nn.Module, freeze_camera: bool,
                frozen_stages: int = 1, norm_eval: bool = True
                ) -> Dict[str, str]:
    """"main" | "backbone" | "frozen" for every named parameter.

    Fusion-only (``freeze_camera``): only ``head.fusion*``,
    ``head.final_cls*``, ``head.final_reg*`` and ``head.radar_*`` train.
    Full training: the stem and ``layer1_`` .. ``layer{frozen_stages}_``
    (ResNet) or ``stage2_`` .. ``stage{frozen_stages + 1}_`` (VoVNet) are
    frozen (mmdet ``frozen_stages``), as are backbone BN affines under
    ``norm_eval`` (here they are buffers), and the rest of the backbone
    trains at the backbone lr.  ObjDGCNN's pillar encoder (``vfe``) trains
    at the backbone lr too; SECOND's ``block{s}_conv{i}`` names meet no
    freeze rule.
    """
    def label(name: str) -> str:
        keys = name.split(".")
        top = keys[0]
        if freeze_camera:
            if top == "head" and keys[1].startswith(_FUSION_PREFIXES):
                return "main"
            return "frozen"
        if top == "vfe":
            # ObjDGCNN: the pillar encoder shares the SECOND lr × 0.1
            # group (pillar.py:286-291 custom_keys)
            return "backbone"
        if top != "backbone":
            return "main"
        if norm_eval and any(k.startswith("bn") for k in keys[1:]):
            return "frozen"
        if keys[1].startswith("stem") and frozen_stages >= 0:
            return "frozen"
        if any(keys[1].startswith((f"layer{s}_", f"stage{s + 1}_"))
               for s in range(1, frozen_stages + 1)):
            return "frozen"
        return "backbone"

    return {name: label(name) for name, _ in model.named_parameters()}


def build_optimizer(cfg, model: nn.Module, total_steps: int,
                    freeze_camera: bool, frozen_stages: int = 1,
                    norm_eval: bool = True
                    ) -> Tuple[torch.optim.AdamW,
                               torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the trainable groups and its schedule (``cfg``: an
    ``OptimConfig``).  Sets ``requires_grad=False`` on the frozen
    parameters."""
    labels = make_labels(model, freeze_camera, frozen_stages, norm_eval)
    groups = {"main": [], "backbone": []}
    for name, p in model.named_parameters():
        lab = labels[name]
        p.requires_grad_(lab != "frozen")
        if lab != "frozen":
            groups[lab].append(p)
    mult = {"main": 1.0, "backbone": cfg.backbone_lr_mult}
    param_groups = [{"params": ps, "lr": cfg.lr * mult[g], "name": g}
                    for g, ps in groups.items() if ps]
    opt = torch.optim.AdamW(param_groups, lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              lr_schedule(cfg, total_steps))
    return opt, sched
