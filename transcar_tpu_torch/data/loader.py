"""Batch assembly + prefetching loader (``transcar_tpu/data/loader.py``).

Replaces mmdet3d's ``build_dataloader`` (4 worker processes, config :189)
with a thread-pool prefetcher producing static-shape numpy batches, the
same shuffles, per-sample random streams and batches as the JAX loader;
:func:`to_device` then copies a batch to the card from pinned memory:

  images       [B, N_cams, H, W, 3] uint8 BGR (padded ÷32; normalized
                               on device — DataConfig.normalize_on_device,
                               4× fewer host→device bytes) or float32
                               pre-normalized when that flag is off
  img_shape    [B, 2] int32   pre-pad content extent (on-device route only)
  photo_params [B, N_cams, 5] float32, photo_perm [B, N_cams, 3] int32
                               (train + photometric_distortion on the
                               on-device route: drawn aug choices; the
                               pixel math runs fused in the jitted step)
  lidar2img    [B, N_cams, 4, 4]
  radar_tokens [B, T, 36]          (optional)
  gt_boxes     [B, G_max, 9]  gravity-center z (loss convention,
                               detr3d_head.py:963-965), padded rows have
                               unit dims so log() stays finite
  gt_labels    [B, G_max] int32
  num_gt       [B] int32

With several processes (``process_count``) each loads its rows of every
global batch, as the JAX loader does (``parallel/distributed.
local_batch_slice``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from transcar_tpu_torch.core.config import DataConfig
from transcar_tpu_torch.data import pipeline as pp
from transcar_tpu_torch.data.infos import NuScenesInfos, Sample
from transcar_tpu_torch.parallel.distributed import local_batch_slice


def pad_gt(gt_boxes: np.ndarray, gt_labels: np.ndarray, max_gt: int):
    """Bottom-z boxes → gravity-z, padded to static [G_max, 9]."""
    g = min(len(gt_boxes), max_gt)
    boxes = np.ones((max_gt, 9), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    if g:
        grav = gt_boxes[:g].copy()
        grav[:, 2] += grav[:, 5] * 0.5
        boxes[:g] = grav
        labels[:g] = gt_labels[:g]
    return boxes, labels, np.int32(g)


def prepare_sample(sample: Sample, cfg: DataConfig, training: bool,
                   rng: Optional[np.random.Generator] = None,
                   radar_fn: Optional[Callable[[str], np.ndarray]] = None,
                   ) -> Dict[str, np.ndarray]:
    """Full per-sample host pipeline → dict of static-shape arrays.

    With ``cfg.normalize_on_device`` (the TPU-first default) images leave
    the host as PADDED uint8 BGR plus an ``img_shape`` content-extent
    record; the jitted step applies the normalize + pad-zero semantics
    on device (train/step.py::normalize_batch_images) — 4× fewer
    host→device bytes (6×928×1600×3: 107 → 27 MB/sample).  Bit-exact
    for the eval pipeline (same fp32 math on the same integers).

    Training photometric distortion rides the SAME uint8 wire: the host
    only draws the per-image random choices
    (pipeline.py::draw_photometric_params → ``photo_params`` /
    ``photo_perm``) and the pixel math runs inside the jitted step,
    fused into the normalize.  This is load-bearing for throughput, not
    a nicety — the host float aug chain measured ~5 s/sample in numpy
    (HSV round trip + fp16 materialization), and numpy ufuncs hold the
    GIL so loader threads serialize on it; on device it is elementwise
    noise folded into an existing pass.  It also kills the old wire
    dilemma: the aug's output range leaves [0, 255] (the reference
    never clips, transform_3d.py:139-180), which uint8 could not carry."""
    if cfg.normalize_on_device:
        images, img_shape = pp.load_multiview_stack_u8(
            sample.img_paths, cfg.pad_divisor)
    else:
        imgs = pp.load_multiview_images(sample.img_paths)
        if training and cfg.photometric_distortion:
            imgs = pp.photometric_distortion(
                imgs, rng or np.random.default_rng())
        img_shape = None
        imgs = pp.normalize_images(imgs, cfg.img_mean, cfg.img_std,
                                   cfg.to_rgb)
        imgs = pp.pad_to_divisor(imgs, cfg.pad_divisor)
        images = pp.stack_views(imgs)

    out: Dict[str, np.ndarray] = {
        "images": images,
        "lidar2img": sample.lidar2img,
    }
    if img_shape is not None:
        out["img_shape"] = img_shape
        if training and cfg.photometric_distortion:
            params, perm = pp.draw_photometric_params(
                rng or np.random.default_rng(), len(sample.img_paths))
            out["photo_params"] = params
            out["photo_perm"] = perm
    if radar_fn is not None:
        out["radar_tokens"] = radar_fn(sample.token)
    boxes, labels, n = pad_gt(sample.gt_boxes, sample.gt_labels,
                              cfg.max_gt_boxes)
    out.update(gt_boxes=boxes, gt_labels=labels, num_gt=n)
    return out


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch → tensors on ``device`` (the counterpart of the JAX
    ``shard_batch``).  On the card every leaf is copied from pinned
    memory with ``non_blocking=True``: a copy from pageable memory first
    waits for the stream (``core/device.py``), so the host could not run
    ahead of the step it feeds.  Scalars per sample (``num_gt``,
    ``num_points``) arrive as [B] tensors."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def _put_unless_stopped(q: "queue.Queue", item, stop: threading.Event,
                        poll: float = 0.25) -> bool:
    """Blocking put that aborts when the consumer abandoned the epoch
    (avoids a producer wedged on a full queue)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


class PrefetchLoader:
    """Thread-pool prefetcher over a dataset of index → sample-dict."""

    def __init__(self, dataset: NuScenesInfos, cfg: DataConfig,
                 batch_size: int, training: bool = True,
                 indices: Optional[np.ndarray] = None,
                 radar_fn: Optional[Callable[[str], np.ndarray]] = None,
                 seed: int = 0, workers: Optional[int] = None,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1, modality: str = "camera"):
        """``batch_size`` is the global batch.  With ``process_count``
        above 1 every process builds the same global order and loads its
        ``local_batch_slice`` of each global batch (rank-independent:
        a sample's draws are seeded by (seed, epoch, index))."""
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.training = training
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self.radar_fn = radar_fn
        self.seed = seed
        self.workers = workers if workers is not None else cfg.workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.modality = modality         # "camera" (+radar) | "lidar"

    def __len__(self):
        return len(self.indices) // self.batch_size

    def epoch(self, epoch_idx: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of epoch ``epoch_idx``, from its ``start``-th on
        (a resumed run skips those its checkpoint had taken; the skipped
        ones are never loaded)."""
        order = self.indices.copy()
        if self.training:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        nb = len(order) // self.batch_size
        batches = order[: nb * self.batch_size].reshape(
            nb, self.batch_size)[start:]
        if self.process_count > 1:
            batches = batches[:, local_batch_slice(
                self.process_index, self.process_count, self.batch_size)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_one(idx, rank):
            rng = np.random.default_rng(
                self.seed * 1_000_003 + epoch_idx * 10_007 + int(idx))
            if self.modality == "lidar":
                from transcar_tpu_torch.data.points import prepare_lidar_sample
                info, gt_b, gt_l = self.dataset.get_lidar_sample(int(idx))
                rebase = (self.dataset._rebase
                          if self.dataset.data_root else None)
                return prepare_lidar_sample(
                    info, self.cfg, self.training, rng, rebase=rebase,
                    pc_range=self.dataset.pc_range,
                    gt_boxes=gt_b, gt_labels=gt_l)
            sample = self.dataset.get_sample(int(idx))
            return prepare_sample(sample, self.cfg, self.training, rng,
                                  self.radar_fn)

        def producer():
            from concurrent.futures import ThreadPoolExecutor
            try:
                with ThreadPoolExecutor(
                        max_workers=max(self.workers, 1)) as ex:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        parts = list(ex.map(load_one, batch_idx,
                                            range(len(batch_idx))))
                        if not _put_unless_stopped(q, collate(parts), stop):
                            return
                _put_unless_stopped(q, None, stop)
            except BaseException as e:     # propagate instead of deadlock
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
