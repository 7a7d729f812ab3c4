"""One training step: forward, loss with Hungarian targets, backward,
gradient clip and AdamW update, and the eval steps: forward and NMS-free
decode, plain or over test-time augmented views
(``transcar_tpu/train/step.py``).

The JAX step folds a key per step into its GridMask and dropout draws;
here GridMask draws from the ``torch.Generator`` the caller passes and
dropout from PyTorch's default generator of the model's device
(``train/loop.py`` seeds both from the train seed and the step).
Fusion-only training (the TransCAR recipe) runs the camera forward
without a graph (``stop_camera_grad``), as the JAX step cuts the gradient
at the fusion input.

Both steps take the loader's uint8 wire (``DataConfig.normalize_on_device``):
:func:`normalize_batch_images` applies the drawn photometric distortion
(training), the normalize and the zero padding on the batch's device, as
the JAX step does inside its jitted function; a float32 batch passes
through unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from transcar_tpu_torch.core.device import const
from transcar_tpu_torch.eval.decode import nms_free_decode
from transcar_tpu_torch.models.common import BatchNorm
from transcar_tpu_torch.models.detector import camera_branch_trains
from transcar_tpu_torch.parallel import sharding
from transcar_tpu_torch.parallel.distributed import all_reduce_, global_sum
from transcar_tpu_torch.parallel.mesh import Grid
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
    losses: Optional[Dict[str, torch.Tensor]] = None   # the last step's
    last_eval: Optional[object] = None   # train/loop.py's last val pass
    grid: Optional[Grid] = None          # the process groups, if several


def init_state(cfg, model: nn.Module, total_steps: int,
               grid: Optional[Grid] = None) -> TrainState:
    """Optimizer, schedule and freeze rules of ``cfg`` for ``model``.

    With a ``grid`` (``parallel/mesh.make_grid``) the step is this rank's
    part of a parallel one: every BatchNorm sums its statistics over a
    data group of more than one rank, and the matmuls the rule table
    names are split over the model group (``parallel/sharding.
    shard_model``, before the optimizer sees the parameters)."""
    if grid is not None:
        for mod in model.modules():
            if isinstance(mod, BatchNorm) and grid.data_size > 1:
                mod.group = grid.data_group
        sharding.shard_model(model, grid)
    fusion_only = not camera_branch_trains(cfg)
    opt, sched = build_optimizer(
        cfg.train.optim, model, total_steps, freeze_camera=fusion_only,
        frozen_stages=cfg.model.backbone.frozen_stages,
        norm_eval=cfg.model.backbone.norm_eval)
    return TrainState(cfg, model.train(), opt, sched, fusion_only,
                      grid=grid)


def _bgr2hsv(x: torch.Tensor) -> torch.Tensor:
    """float32 BGR → HSV with H in degrees: ``data/pipeline.py::_bgr2hsv``
    (mmcv / cv2 semantics), the same formula in torch."""
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    num = torch.where(maxc == r, g - b,
                      torch.where(maxc == g, (b - r) + delta * 2.0,
                                  (r - g) + delta * 4.0))
    h = num * (60.0 / delta.clamp(min=1e-12))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv2bgr(h: torch.Tensor, s: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """``data/pipeline.py::_hsv2bgr`` in torch: channel(n) = V − V·S·
    clip(min(k, 4 − k), 0, 1), k = (n + H/60) mod 6."""
    h60 = h * (1.0 / 60.0)
    vs = v * s

    def chan(n):
        k = torch.remainder(n + h60, 6.0)
        return v - vs * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(1.0), chan(3.0), chan(5.0)], dim=-1)


def _device_photometric(x: torch.Tensor, p: torch.Tensor,
                        perm: torch.Tensor) -> torch.Tensor:
    """PhotoMetricDistortionMultiViewImage's pixel math on the batch's
    device (transform_3d.py:139-180; the choices are drawn on the host,
    ``data/pipeline.py::draw_photometric_params``).

    x [B, N, H, W, 3] float32 BGR; p [B, N, 5] = (brightness, mode,
    contrast_alpha, saturation_alpha, hue_deg); perm [B, N, 3] int32.
    The reference's order: brightness → contrast (mode 1) → HSV →
    saturation → hue → BGR → contrast (mode 0) → channel swap.  The HSV
    round trip runs unconditionally, as in the reference: it is not an
    identity for out-of-gamut pixels (a brightness-darkened all-negative
    pixel has V ≤ 0, so S = 0 and it turns grey)."""
    bc = p[:, :, None, None, :]                      # [B, N, 1, 1, 5]
    mode1 = bc[..., 1] == 1
    alpha = bc[..., 2]
    x = x + bc[..., 0:1]
    x = x * torch.where(mode1, alpha, 1.0)[..., None]
    hsv = _bgr2hsv(x)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    s = s * bc[..., 3]
    h = h + bc[..., 4]                      # one wrap, as the reference
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    x = _hsv2bgr(h, s, v)
    x = x * torch.where(mode1, 1.0, alpha)[..., None]
    index = perm.long()[:, :, None, None, :].expand(x.shape)
    return torch.gather(x, -1, index)


def normalize_batch_images(batch: Dict[str, torch.Tensor], dc) -> Dict:
    """On-device [PhotoMetricDistortion (train) →] NormalizeMultiviewImage
    → PadMultiViewImage(0) of a uint8 batch (``dc``: a ``DataConfig``).

    A batch whose images are not uint8 passes through unchanged.
    ``img_shape`` [B, 2] is the content extent before padding: the
    padding is zeroed after the normalize, as the host pipeline
    normalizes and then pads (the aug runs first, so distorted padding is
    zeroed too).  The photometric keys are dropped from the result."""
    imgs = batch.get("images")
    if imgs is None or imgs.dtype != torch.uint8:
        return batch
    x = imgs.float()
    pp = batch.get("photo_params")
    if pp is not None:
        x = _device_photometric(x, pp, batch["photo_perm"])
    if dc.to_rgb:
        x = x.flip(-1)
    mean = const(dc.img_mean, x.device)
    std = const(dc.img_std, x.device)
    x = (x - mean) / std
    hw = batch.get("img_shape")
    if hw is not None:                       # zero the padded border
        rows = torch.arange(x.shape[-3], device=x.device)
        cols = torch.arange(x.shape[-2], device=x.device)
        mask = ((rows[None, None, :, None] < hw[:, 0, None, None, None])
                & (cols[None, None, None, :] < hw[:, 1, None, None, None]))
        x = x * mask[..., None].to(x.dtype)
    out = dict(batch)
    out["images"] = x
    out.pop("photo_params", None)
    out.pop("photo_perm", None)
    return out


def forward(model: nn.Module, batch: Dict[str, torch.Tensor],
            stop_camera_grad: bool = False,
            generator: Optional[torch.Generator] = None):
    """The model on a normalized batch, dispatched on ``"points"`` as the
    JAX ``apply_model`` does: a LiDAR batch (points [B, N_max, 5],
    num_points [B]) or a camera batch (images [B, N, H, W, 3] float32,
    lidar2img, radar_tokens)."""
    if "points" in batch:
        return model(batch["points"], batch["num_points"])
    return model(batch["images"], batch["lidar2img"],
                 batch.get("radar_tokens"),
                 stop_camera_grad=stop_camera_grad, generator=generator)


def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor],
              cfg) -> Dict[str, torch.Tensor]:
    """Inference and NMS-free decode of one batch (the JAX
    ``make_eval_step``): normalize (a uint8 or float32 batch), forward
    without a graph, ``eval/decode.py``.  ``model`` is in eval mode."""
    with torch.inference_mode():
        batch = normalize_batch_images(batch, cfg.data)
        return nms_free_decode(forward(model, batch), cfg.model.head)


#: Test-time augmentations :func:`aug_eval_step` knows.
AUGS = ("identity", "flip")


def check_augs(augs) -> None:
    """Raise ``ValueError`` naming the known augmentations for any other."""
    bad = set(augs) - set(AUGS)
    if bad:
        raise ValueError(f"unknown aug(s) {sorted(bad)}; pick from "
                         f"{sorted(AUGS)}")


def aug_eval_step(model: nn.Module, batch: Dict[str, torch.Tensor], cfg,
                  augs=("identity", "flip")) -> Dict[str, torch.Tensor]:
    """Test-time-augmentation inference (the JAX ``make_aug_eval_step``;
    reference ``aug_test``, detr3d.py:195-219): the backbone and FPN run
    once a view, their features are averaged over the views, and the head
    runs once on the first view's ``lidar2img`` (the reference takes
    ``img_metas[0]`` likewise), then the NMS-free decode.

    ``augs``: any of ``identity`` / ``flip`` (horizontal image flip).  The
    views are built on the batch's device from the normalized, padded
    batch: one wire transfer.  The flipped view's features are averaged
    with the others' unaligned (never mirrored back), verbatim from the
    reference, as the JAX package keeps it."""
    check_augs(augs)
    with torch.inference_mode():
        batch = normalize_batch_images(batch, cfg.data)
        imgs = batch["images"]                        # [B, N, H, W, 3]
        views = torch.stack([imgs if a == "identity" else imgs.flip(3)
                             for a in augs])          # [A, B, N, H, W, 3]
        preds = model.aug_forward(views, batch["lidar2img"],
                                  batch.get("radar_tokens"))
        return nms_free_decode(preds, cfg.model.head)


def compute_losses(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Forward and ``detr3d_loss`` of one batch (see :func:`forward`; the
    camera images uint8 or float32, :func:`normalize_batch_images`), with
    gt_boxes, gt_labels and num_gt.  A LiDAR model in train mode updates
    its BatchNorm running statistics in place (the JAX step returns them
    as ``new_stats``)."""
    batch = normalize_batch_images(batch, state.cfg.data)
    preds = forward(state.model, batch, state.stop_camera_grad, generator)
    group = state.grid.data_group if state.grid is not None else None
    return detr3d_loss(preds, batch["gt_boxes"], batch["gt_labels"],
                       batch["num_gt"], state.cfg.model.head, group=group)


def gradients(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Forward and backward of one batch: every trainable parameter's
    ``grad`` is then the global batch's gradient (zeros where the loss
    does not reach it).  Returns this rank's losses.

    With a ``state.grid`` the batch is this rank's rows of the global
    batch, and the gradients are summed over the data group by one flat
    bucketed all-reduce after the backward, every parameter included."""
    state.optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(state, batch, generator)
    losses["total"].backward()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:            # as optax: unreached parameters still decay
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.grid is not None:
        all_reduce_([p.grad for p in params], state.grid.data_group)
    return losses


def apply_gradients(state: TrainState, losses: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The update from :func:`gradients`' ``grad``: the clip at the global
    norm, the optimizer and the schedule.  Returns the global batch's
    losses (detached; ``losses`` summed over the data group)."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grid = state.grid
    clip = state.cfg.train.optim.grad_clip_norm
    state.grad_norm = (
        torch.nn.utils.clip_grad_norm_(params, clip)
        if grid is None or grid.model_group is None
        else sharding.clip_grad_norm_(params, clip, grid))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    losses = {k: v.detach() for k, v in losses.items()}
    if grid is not None and grid.data_group is not None:
        summed = global_sum(torch.stack(list(losses.values())),
                            grid.data_group)
        losses = dict(zip(losses, summed))
    state.losses = losses
    return state.losses


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step (:func:`gradients`, then :func:`apply_gradients`);
    returns the loss dict (detached).  With a ``state.grid`` the returned
    losses are the global batch's, and after the step every rank of a
    data group holds the same parameters."""
    return apply_gradients(state, gradients(state, batch, generator))
