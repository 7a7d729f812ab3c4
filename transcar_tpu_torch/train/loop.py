"""Training loop: epochs, logging, eval hook, checkpointing
(``transcar_tpu/train/loop.py``).

EpochBasedRunner analog (SURVEY.md §2.6): json + text logging that the
log-analysis CLI parses, an EvalHook every N epochs, a checkpoint hook,
warm start and resume.  One process drives one card.  Under a process
group (torchrun or Slurm, ``parallel/distributed.py``) the W ranks train
data-parallel: the global batch is ``data.samples_per_device`` × W, each
rank loads its rows of it, and the step sums what spans the batch over
the ranks, so W ranks train what the JAX package trains on a W-device
data mesh.  Rank 0 alone logs, writes checkpoints and traces; every rank
restores on resume.  ``train.mesh_shape`` is a no-op: the world size is
the data axis.

Each step's random draws come from ``(train.seed, step)``
(:func:`step_generator`): GridMask from a CPU generator, the same on
every rank (one mask covers the global batch, as it covers the batch of
one process), and dropout from the device's default generator, seeded
from ``(train.seed, step, rank)``; both are reseeded before the step, as
the JAX step folds the step into its key.  So a resumed run draws what an
uninterrupted run draws.  A resumed run also skips the batches of its
epoch that the saved step had taken (the JAX loop restarts the epoch),
so it sees the same batches as well.

Nothing but the ``log_interval`` records pulls a value to the host (the
step's Hungarian match does, inside the step, as in the JAX step).
"""
from __future__ import annotations

import functools
import json
import os
import signal
import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from transcar_tpu_torch.core.config import TransCARConfig, config_to_dict
from transcar_tpu_torch.data.infos import NuScenesInfos, cbgs_indices
from transcar_tpu_torch.data.loader import PrefetchLoader, to_device
from transcar_tpu_torch.eval.submission import (detections_to_nusc_annos,
                                                write_submission)
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.parallel.distributed import (allgather_eval_outputs,
                                                     rank_world)
from transcar_tpu_torch.parallel.mesh import (CameraShardedDetector,
                                              camera_devices, make_grid)
from transcar_tpu_torch.train import checkpoint as ckpt
from transcar_tpu_torch.train.fold import fold_bn_into_conv, frozen_bn_names
from transcar_tpu_torch.train.step import (TrainState, aug_eval_step,
                                           check_augs, eval_step, init_state,
                                           train_step)


class JsonLogger:
    """mmcv-style json-line logger (work_dirs/<name>/<ts>.log.json) — the
    format tools/analysis_tools/analyze_logs.py parses."""

    def __init__(self, work_dir: str, enabled: bool = True):
        self.enabled = enabled        # rank 0 of a process group logs
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(work_dir, f"{stamp}.log.json")

    def log(self, record: Dict):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        mode = record.get("mode", "")
        human = ", ".join(f"{k}: {v}" for k, v in record.items()
                          if k not in ("mode",))
        print(f"[{mode}] {human}", flush=True)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``cuda`` as the current card, which
    a rank of a process group has set); a CUDA device without CUDA raises
    (nothing runs on the CPU unless asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but torch.cuda.is_available() is "
                           "False (pass device=\"cpu\", or --device cpu, "
                           "for a CPU run)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def step_generator(seed: int, step: int, device,
                   rank: int = 0) -> torch.Generator:
    """Reseed the default generator of ``device`` (dropout) from
    ``(seed, step, rank)`` and return a CPU generator (GridMask) seeded
    from ``(seed, step)``, the same on every rank.  ``rank`` is the data
    rank: the ranks of one model group draw the same dropout."""
    s = (seed + 1) * 1_000_003 + step
    device = torch.device(device)
    drop = s + rank * 7_919_000_017      # rank 0 draws as one process does
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        torch.cuda.default_generators[index].manual_seed(drop)
    else:
        torch.default_generator.manual_seed(drop)
    return torch.Generator().manual_seed(s)


class EvalResult(NamedTuple):
    """What :func:`evaluate` wrote and decoded: the submission's path and
    the decoded rows by sample (boxes [S, K, 9] bottom-center, scores,
    labels, valid, and the samples' tokens)."""
    path: str
    detections: Dict[str, np.ndarray]


def train(cfg: TransCARConfig,
          radar_fn: Optional[Callable[[str], np.ndarray]] = None,
          max_steps: Optional[int] = None,
          log_interval: int = 50,
          eval_samples: Optional[int] = None,
          trace_dir: Optional[str] = None,
          trace_start: int = 8,
          trace_steps: int = 3,
          device="cuda") -> TrainState:
    """Full training run driven by a config (tools/train.py analog).

    Mid-training evaluation (EvalHook analog, every 2 epochs in the
    reference): every ``cfg.train.eval_interval_epochs`` epochs and after
    the last, the val split runs through the current weights, the
    submission json is written under work_dir, and devkit metrics (when
    the raw dataset is present) or the native ones (``eval/metrics.py``)
    land in a ``mode="val"`` record.  ``eval_interval_epochs <= 0``
    disables the hook; ``eval_samples`` bounds each val pass.  A
    checkpoint is saved every ``checkpoint_interval_epochs``, at
    ``max_steps``, and on SIGTERM / SIGINT (then the run logs
    ``preempted`` and returns).

    Every ``log_interval`` steps a ``mode="train"`` record holds the
    losses, the lr, the mean wall time a step (``time``) and of it the
    time spent waiting on the loader (``data_time``), and on the card
    the peak memory in MiB (``memory``), as mmcv's logger does.

    ``trace_dir`` captures a ``torch.profiler`` window of ``trace_steps``
    steps from the ``trace_start``-th step this process runs, loader
    waits included, and writes its chrome trace and ``summary.json``
    (``cli/benchmark.py::trace_summary``: device busy time and idle
    share) there.

    Runs on ``device`` (the card unless the caller passes ``"cpu"``);
    returns the final state, whose ``last_eval`` holds the last val
    pass's :class:`EvalResult`.

    Under a process group every rank runs this function (see the module
    docstring); the loader, the step and the eval hook split the work,
    and rank 0 writes."""
    device = resolve_device(device)
    rank, world = rank_world()
    main = rank == 0
    grid = make_grid() if world > 1 else None
    work_dir = cfg.train.work_dir
    os.makedirs(work_dir, exist_ok=True)
    logger = JsonLogger(work_dir, enabled=main)
    if main:
        with open(os.path.join(work_dir, "config.json"), "w") as f:
            json.dump(config_to_dict(cfg), f, indent=2)

    dataset = NuScenesInfos(
        os.path.join(cfg.data.data_root, cfg.data.ann_train),
        class_names=cfg.data.class_names, data_root=cfg.data.data_root)
    indices = cbgs_indices(dataset) if cfg.data.use_cbgs else None
    modality = "lidar" if cfg.model.lidar_encoder else "camera"
    loader = PrefetchLoader(dataset, cfg.data,
                            cfg.data.samples_per_device * world,
                            training=True, indices=indices,
                            radar_fn=radar_fn, seed=cfg.train.seed,
                            process_index=rank, process_count=world,
                            modality=modality)
    steps_per_epoch = max(len(loader), 1)
    total_steps = steps_per_epoch * cfg.train.optim.total_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)

    model = build_model(cfg, device=device, training=True,
                        seed=cfg.train.seed)
    if cfg.train.load_from:
        model.load_state_dict(_load_params(cfg.train.load_from, cfg, model))
    state = init_state(cfg, model, total_steps, grid=grid)
    start_epoch, skip = 0, 0
    if cfg.train.resume_from:
        step = ckpt.restore_checkpoint(cfg.train.resume_from, state)
        start_epoch, skip = divmod(step, steps_per_epoch)

    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True

    def save():
        ckpt.save_checkpoint(work_dir, state,
                             config_dict=config_to_dict(cfg))

    eval_ctx: Dict[str, object] = {}     # the val model and dataset, once

    def run_val(epoch: int):
        t0 = time.time()
        if not eval_ctx:
            eval_ctx["dataset"] = NuScenesInfos(
                os.path.join(cfg.data.data_root, cfg.data.ann_val),
                class_names=cfg.data.class_names, test_mode=True,
                data_root=cfg.data.data_root)
            eval_ctx["model"] = build_model(cfg, device=device)
        eval_ctx["model"].load_state_dict(state.model.state_dict())
        result = evaluate(
            cfg, eval_ctx["model"], radar_fn=radar_fn,
            max_samples=eval_samples,
            out_path=os.path.join(work_dir,
                                  f"val_epoch{epoch + 1}_nusc.json"),
            _dataset=eval_ctx["dataset"])
        state.last_eval = result
        if main:
            rec = {"mode": "val", "epoch": epoch + 1, "iter": len(loader),
                   "step": state.step, "time": round(time.time() - t0, 4)}
            rec.update(_metrics(result.path, cfg, eval_ctx["dataset"]))
            logger.log(rec)

    tracing = {"on": False, "done": trace_dir is None or not main,
               "local": 0, "prof": None, "t0": 0.0}

    def trace_tick():
        """Open the window before the ``trace_start``-th local step and
        close it after ``trace_steps`` steps."""
        if tracing["done"]:
            return
        local = tracing["local"]
        tracing["local"] += 1
        if not tracing["on"] and local >= trace_start:
            _sync(device)
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            tracing["prof"] = profile(activities=acts)
            tracing["prof"].__enter__()
            tracing["on"] = True
            tracing["t0"] = time.perf_counter()
        elif tracing["on"] and local >= trace_start + trace_steps:
            stop_trace(local - trace_start)

    def stop_trace(steps: int):
        _sync(device)
        wall = time.perf_counter() - tracing["t0"]
        tracing["prof"].__exit__(None, None, None)
        from transcar_tpu_torch.cli.benchmark import _write_trace
        _write_trace(tracing["prof"], trace_dir, device, wall, steps)
        tracing.update(on=False, done=True, prof=None)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass    # not on the main thread
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        done = False
        for epoch in range(start_epoch, cfg.train.optim.total_epochs):
            t_iter = time.time()
            waited = 0.0
            batches = loader.epoch(epoch, start=skip)
            first = skip
            skip = 0
            while True:
                t_wait = time.time()
                batch = next(batches, None)
                if batch is None:
                    break
                waited += time.time() - t_wait
                i = first
                first += 1
                t_tick = time.time()
                trace_tick()
                t_iter += time.time() - t_tick     # not the trace's export
                gen = step_generator(cfg.train.seed, state.step, device,
                                     rank)
                losses = train_step(state, to_device(batch, device), gen)
                if main and (i + 1) % log_interval == 0:
                    rec = {"mode": "train", "epoch": epoch + 1,
                           "iter": i + 1, "step": state.step,
                           "lr": float(state.scheduler.get_last_lr()[0]),
                           "time": round((time.time() - t_iter)
                                         / log_interval, 4),
                           "data_time": round(waited / log_interval, 4)}
                    if device.type == "cuda":
                        rec["memory"] = int(torch.cuda.max_memory_allocated(
                            device) // 2**20)
                    rec.update({k: round(float(v), 4)
                                for k, v in losses.items()})
                    logger.log(rec)
                    t_iter = time.time()
                    waited = 0.0
                if preempted["flag"]:
                    if tracing["on"]:
                        stop_trace(tracing["local"] - trace_start)
                    save()
                    logger.log({"mode": "train", "epoch": epoch + 1,
                                "preempted": True, "step": state.step})
                    return state
                if max_steps is not None and state.step >= max_steps:
                    done = True
                    break
            batches.close()
            if (epoch + 1) % cfg.train.checkpoint_interval_epochs == 0 \
                    or done:
                save()
            ei = cfg.train.eval_interval_epochs
            last = (epoch + 1 == cfg.train.optim.total_epochs) or done
            if ei > 0 and ((epoch + 1) % ei == 0 or last):
                run_val(epoch)
            if done:
                break
        if tracing["on"]:        # run shorter than the trace window
            stop_trace(tracing["local"] - trace_start)
        return state
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _metrics(result_path: str, cfg, dataset: NuScenesInfos) -> Dict:
    """Devkit mAP / NDS when the raw dataset and the devkit are there,
    else the native evaluator over the val infos; a failure is recorded,
    never raised (a periodic eval hook must not end a run)."""
    rec: Dict = {}
    try:
        from transcar_tpu_torch.eval.submission import evaluate_nuscenes
        rec.update({k: round(float(v), 4) for k, v in evaluate_nuscenes(
            result_path, cfg.data.data_root,
            version=cfg.data.version).items()})
        rec["metrics_source"] = "devkit"
    except Exception as e:
        rec["devkit"] = f"unavailable: {type(e).__name__}"
        if any("gt_boxes" in i for i in dataset.infos):
            try:
                from transcar_tpu_torch.eval.metrics import evaluate_native
                rec.update({k: round(float(v), 4) for k, v in
                            evaluate_native(result_path,
                                            infos=dataset.infos).items()})
                rec["metrics_source"] = "native"
            except Exception as e2:
                rec["native"] = f"failed: {type(e2).__name__}: {e2}"
    return rec


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(cfg: TransCARConfig, model: nn.Module,
             radar_fn: Optional[Callable[[str], np.ndarray]] = None,
             max_samples: Optional[int] = None,
             out_path: Optional[str] = None,
             batch_size: int = 1,
             fold_bn: bool = True,
             aug_test: Optional[Sequence[str]] = None,
             shard_cameras: bool = False,
             _dataset: Optional[NuScenesInfos] = None) -> EvalResult:
    """Inference over the val set → nuScenes submission json
    (tools/test.py --format-only analog), with ``model`` (eval mode, on
    its device) as it is given; returns an :class:`EvalResult`.

    ``batch_size`` > 1 batches inference (samples_per_gpu analog): the
    index list is padded to a batch multiple by repeating the first
    sample and the padded rows are dropped, so outputs are those of the
    bs=1 path.  ``fold_bn`` folds the frozen-BN scales into the convs
    before inference (``train/fold.py``; ``False`` for the unfolded
    numbers): it rewrites ``model``'s weights in place, before any int8
    weight codes are taken from them (``model.backbone.quantize=int8``
    quantizes the folded weights at the next forward, as the JAX
    ``evaluate`` folds its params before the quantizing eval step).

    ``aug_test`` (e.g. ``("identity", "flip")``) runs test-time
    augmentation (``train/step.py::aug_eval_step``): the backbone and FPN
    once a view, the features averaged, the head once; camera track only.

    ``shard_cameras`` (camera track, one process) runs each camera
    group's backbone and FPN on a device of its own
    (``parallel/mesh.CameraShardedDetector``), over every visible card,
    as many as divide the camera count (``parallel/mesh.
    camera_devices``); with one device, under a process group or for a
    LiDAR preset it takes the unsharded path and says so.  The output is
    the unsharded one.

    Under a process group the samples are strided across the ranks, each
    rank's decoded rows are gathered (``parallel/distributed.
    allgather_eval_outputs``) in sample order on every rank, and rank 0
    writes the submission (mmdet's ``multi_gpu_test`` and collect).

    On the card two batches are in flight: each step's decoded rows are
    copied to pinned host memory as soon as the step is queued, and the
    host reads a batch's rows only when the next but one is queued; the
    next batch's images are copied on a stream of their own while the
    current step runs."""
    if aug_test:
        if cfg.model.lidar_encoder:
            raise ValueError("--aug-test is camera-track only")
        check_augs(aug_test)
        step = functools.partial(aug_eval_step, augs=tuple(aug_test))
    else:
        step = eval_step
    dataset = _dataset if _dataset is not None else NuScenesInfos(
        os.path.join(cfg.data.data_root, cfg.data.ann_val),
        class_names=cfg.data.class_names, test_mode=True,
        data_root=cfg.data.data_root)
    device = next(model.parameters()).device
    if fold_bn:
        model.load_state_dict(fold_bn_into_conv(model.state_dict(),
                                                frozen_bn_names(model)))
    rank, world = rank_world()
    if shard_cameras and cfg.model.lidar_encoder:
        print("[shard-cameras] a LiDAR preset has no cameras: the "
              "unsharded path")
    elif shard_cameras and world > 1:
        print(f"[shard-cameras] {world} ranks split the samples: the "
              "unsharded path on each")
    elif shard_cameras:
        visible = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        devices = camera_devices(cfg.model.head.num_cams, visible)
        if len(devices) > 1:
            model = CameraShardedDetector(model, devices)
        else:
            print(f"[shard-cameras] {len(devices)} device for "
                  f"{cfg.model.head.num_cams} cameras: the one-device path")
    n = len(dataset) if max_samples is None else min(max_samples,
                                                     len(dataset))
    my_indices = np.arange(n)[rank::world]
    n_real = len(my_indices)
    pad = (-n_real) % batch_size if n_real else 0
    padded = (np.concatenate([my_indices, np.repeat(my_indices[:1], pad)])
              if pad else my_indices)
    loader = PrefetchLoader(
        dataset, cfg.data, batch_size=batch_size, training=False,
        indices=padded, radar_fn=radar_fn,
        modality="lidar" if cfg.model.lidar_encoder else "camera")
    keys = ("boxes", "scores", "labels", "valid")
    local = {k: [] for k in keys}
    local["sample_idx"] = []

    def collect(bidx, out, ready):
        if ready is not None:
            ready.synchronize()
        for row in range(batch_size):
            pos = bidx * batch_size + row
            if pos >= n_real:          # padded tail rows
                continue
            for k in keys:
                local[k].append(out[k][row].numpy())
            local["sample_idx"].append(int(my_indices[pos]))

    uploads = _Uploader(device)
    pending = deque()
    batches = loader.epoch(0)
    nxt = next(batches, None)
    staged = uploads.stage(nxt) if nxt is not None else None
    bidx = 0
    while staged is not None:
        out = step(model, uploads.take(staged), cfg)
        nxt = next(batches, None)
        staged = uploads.stage(nxt) if nxt is not None else None
        if device.type == "cuda":
            host = {k: out[k].to("cpu", non_blocking=True) for k in keys}
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = {k: out[k] for k in keys}, None
        pending.append((bidx, host, ready))
        if len(pending) > 2:
            collect(*pending.popleft())
        bidx += 1
    while pending:
        collect(*pending.popleft())
    batches.close()

    k_det = cfg.model.head.max_detections
    empty = {"boxes": ((0, k_det, 9), np.float32),
             "scores": ((0, k_det), np.float32),
             "labels": ((0, k_det), np.int32), "valid": ((0, k_det), bool)}
    dets = {k: np.stack(local[k]) if local[k] else np.zeros(*empty[k])
            for k in keys}
    dets["sample_idx"] = np.asarray(local["sample_idx"], np.int64)
    if world > 1:
        dets, _ = allgather_eval_outputs(dets, n_real)
        order = np.argsort(dets["sample_idx"], kind="stable")
        dets = {k: v[order] for k, v in dets.items()}
    samples = dets.pop("sample_idx")
    dets["tokens"] = np.asarray([dataset.infos[i]["token"]
                                 for i in samples])
    out_path = out_path or os.path.join(cfg.train.work_dir,
                                        "results_nusc.json")
    if rank == 0:
        results: Dict[str, list] = {}
        for row, i in enumerate(samples):
            info = dataset.infos[i]
            results[info["token"]] = detections_to_nusc_annos(
                dets["boxes"][row], dets["scores"][row],
                dets["labels"][row], dets["valid"][row], info,
                cfg.data.class_names)
        write_submission(results, out_path)
    return EvalResult(out_path, dets)


class _Uploader:
    """Host batches to the device.  On the card the images (the large
    leaf) are copied from pinned memory on a stream of their own, so the
    copy of batch i + 1 runs beside step i; the main stream waits for it
    only where the step uses it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def stage(self, batch):
        if self.stream is None or "images" not in batch:
            return to_device(batch, self.device), None
        rest = {k: v for k, v in batch.items() if k != "images"}
        images = torch.from_numpy(batch["images"]).pin_memory()
        with torch.cuda.stream(self.stream):
            images = images.to(self.device, non_blocking=True)
        return {**to_device(rest, self.device), "images": images}, \
            self.stream

    def take(self, staged):
        batch, stream = staged
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
            batch["images"].record_stream(
                torch.cuda.current_stream(self.device))
        return batch


def _merge_over_template(template: Dict[str, torch.Tensor],
                         loaded: Dict[str, torch.Tensor]):
    """Overlay a (possibly partial) converted ``state_dict`` onto a
    freshly built model's: every entry absent from ``loaded`` or of
    another shape (e.g. the fusion / radar / final_* heads when TransCAR
    warm-starts from a camera-only DETR3D checkpoint, README.md:13,
    tools/train.py:238-252) keeps its fresh value.  Returns (the merged
    ``state_dict``, the keys kept)."""
    merged, kept = {}, []
    for key, t in template.items():
        got = loaded.get(key)
        if got is None or tuple(got.shape) != tuple(t.shape):
            kept.append(key)
            merged[key] = t
        else:
            merged[key] = got.to(device=t.device, dtype=t.dtype)
    return merged, kept


def _load_params(path: str, cfg: TransCARConfig, model: nn.Module
                 ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` to load into ``model`` for a warm start or an
    eval.  As in JAX, a ``.pth`` / ``.pt`` file is a reference checkpoint:
    converted (``train/convert.py``) and merged over ``model``'s own
    ``state_dict``, with the counts printed.  Anything else is a port
    checkpoint (a step dir, or a params-only file of
    ``checkpoint.save_params_only`` under another name), loaded
    strictly."""
    template = model.state_dict()
    if path.endswith((".pth", ".pt")):
        from transcar_tpu_torch.train.convert import (
            convert_detr3d_checkpoint, from_jax_params,
            load_torch_state_dict)
        params, report = convert_detr3d_checkpoint(
            load_torch_state_dict(path),
            num_decoder_layers=cfg.model.head.num_decoder_layers,
            backbone=cfg.model.backbone.kind,
            with_dcn=cfg.model.backbone.with_dcn,
            with_radar_fusion=cfg.model.head.with_radar_fusion)
        if report["missing"]:
            print(f"[load_from] {len(report['missing'])} missing keys, e.g. "
                  f"{report['missing'][:3]}")
        merged, kept = _merge_over_template(template,
                                            from_jax_params(params))
        if kept:
            print(f"[load_from] {len(kept)} params kept at fresh init "
                  f"(absent from checkpoint), e.g. {kept[:3]}")
        return merged
    sd = ckpt.load_params_only(path, template)
    return {k: v.to(template[k].device) for k, v in sd.items()}
