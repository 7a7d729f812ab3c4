"""One training step: forward, loss with Hungarian targets, backward,
gradient clip and AdamW update (``transcar_tpu/train/step.py``).

The JAX step folds a key per step into its GridMask and dropout draws;
here GridMask draws from the ``torch.Generator`` the caller passes and
dropout from PyTorch's default generator of the model's device.
Fusion-only training (the TransCAR recipe) runs the camera forward
without a graph (``stop_camera_grad``), as the JAX step cuts the gradient
at the fusion input.  The uint8 wire and the on-device photometric
augmentation belong to the data pipeline, which is not ported: a float32
batch passes through unchanged, as in the JAX step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from transcar_tpu_torch.models.detector import camera_branch_trains
from transcar_tpu_torch.train.loss import detr3d_loss
from transcar_tpu_torch.train.optim import build_optimizer


@dataclass
class TrainState:
    """What a step updates: the model (in train mode), its optimizer and
    schedule, the step count and the last step's gradient norm (before
    clipping, over the trainable parameters)."""
    cfg: object
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    stop_camera_grad: bool
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None


def init_state(cfg, model: nn.Module, total_steps: int) -> TrainState:
    """Optimizer, schedule and freeze rules of ``cfg`` for ``model``."""
    fusion_only = not camera_branch_trains(cfg)
    opt, sched = build_optimizer(
        cfg.train.optim, model, total_steps, freeze_camera=fusion_only,
        frozen_stages=cfg.model.backbone.frozen_stages,
        norm_eval=cfg.model.backbone.norm_eval)
    return TrainState(cfg, model.train(), opt, sched, fusion_only)


def compute_losses(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Forward and ``detr3d_loss`` of one batch: a camera batch (images
    [B, N, H, W, 3] float32, lidar2img, radar_tokens) or, dispatched on
    ``"points"`` as the JAX ``apply_model`` does, a LiDAR batch (points
    [B, N_max, 5], num_points [B]); both with gt_boxes, gt_labels and
    num_gt.  A LiDAR model in train mode updates its BatchNorm running
    statistics in place (the JAX step returns them as ``new_stats``)."""
    if "points" in batch:
        preds = state.model(batch["points"], batch["num_points"])
        return detr3d_loss(preds, batch["gt_boxes"], batch["gt_labels"],
                           batch["num_gt"], state.cfg.model.head)
    if batch["images"].dtype == torch.uint8:
        raise NotImplementedError("the uint8 wire and photometric "
                                  "augmentation are not ported yet (the "
                                  "data pipeline); pass float32 images")
    preds = state.model(batch["images"], batch["lidar2img"],
                        batch.get("radar_tokens"),
                        stop_camera_grad=state.stop_camera_grad,
                        generator=generator)
    return detr3d_loss(preds, batch["gt_boxes"], batch["gt_labels"],
                       batch["num_gt"], state.cfg.model.head)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step; returns the loss dict (detached)."""
    state.optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(state, batch, generator)
    losses["total"].backward()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:            # as optax: unreached parameters still decay
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.grad_norm = torch.nn.utils.clip_grad_norm_(
        params, state.cfg.train.optim.grad_clip_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}
