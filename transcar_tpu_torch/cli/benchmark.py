"""Inference and training throughput of the port
(``transcar_tpu/cli/benchmark.py`` and ``bench.py``'s train rows).

Usage (from the repository root)::

    python -m transcar_tpu_torch.cli.benchmark transcar_r101 \
        [--samples 20] [--warmup 3] [--batch 1] [--cfg-options k.sub=v ...]
    python -m transcar_tpu_torch.cli.benchmark detr3d_r101 --train \
        [--samples 5] [--warmup 2]

Inference times batch requests after ``--warmup`` requests, with
``torch.cuda.synchronize()`` around the timed loop (the reference protocol,
tools/analysis_tools/benchmark.py:64-91, which ``bench.py`` cites), on
seeded random weights and the synthetic batch of ``data/synthetic.py``.
It prints one JSON line: samples/s, ms/sample, the device's name, the
launches of every kernel (K1-K9, the int8 convolution and quantize
pass, and the Hungarian matching) in the run, the peak device memory, and
two audits of the first warmup request: the share of DCN taps whose
vertical offset exceeds 5 px (the TPU kernel's exact band; here every tap
is exact; null for a backbone without DCN, as VoVNet-99) and the share of
(query, radar token) pairs the fusion masks keep.

Any camera or fusion preset runs, ``transcar_vovnet_trainval`` (VoVNet-99,
K4 in every OSA block) included.  The kernel paths are the defaults; the
plain layers are ``--cfg-options model.backbone.dcn_impl=exact
model.backbone.osa_reduce_impl=xla model.head.use_pallas_attention=false``,
and the opt-in kernels are ``model.backbone.block_impl=fused`` (K6, ResNet)
and ``model.backbone.osa_reduce_impl=fused`` (K5, VoVNet).  The int8
serving mode is ``--cfg-options model.backbone.quantize=int8`` (78 int8
convolutions a ``transcar_r101`` request, 77 of them on the ``wgmma``
tile, 74 codes and 60 amax passes; 83 convolutions, 82 on the ``wgmma``
tile, 83 codes and 17 amax passes a ``transcar_vovnet_trainval`` one;
``--train`` builds the float path).

The LiDAR preset ``objdgcnn_pillar`` (ObjDGCNN, 8 K7 launches per
request: 2 encoder and 6 decoder deformable attentions) times batch-1
inference on the synthetic point cloud of ``data/synthetic.py``
(``data.max_points`` points, 90% real); its line holds ``max_points`` in
place of ``img_hw`` and, from the first warmup request, the pillars kept
and the BEV rows they reach.  Random weights would leave every
MSDeformAttn ``sampling_offsets`` and ``attention_weights`` kernel at
mmcv's zero init, so every query would sample the fixed circle pattern
with uniform weights; the benchmark draws them (:data:`MSDEFORM_STD`).
``objdgcnn_pillar --train`` times its train steps on the same cloud with
ground-truth boxes (``data/synthetic.fake_lidar_batch``): 8 K7 launches
in the forward and 8 K8 + 8 K9 in the backward of every step, its line
holding ``max_points`` in place of ``img_hw``.

``objdgcnn_voxel`` (0.1 × 0.1 × 0.2 m voxels, 90 000 of them, the sparse
3D encoder on a (41, 1024, 1024) grid, SECOND (5, 5) and the same head)
serves and trains the same way, with the same launches; its sparse
encoder is plain PyTorch (``model.sparse_impl``: ``gather``, the
preset's, or ``dense``).  Its line holds a ``voxel_audit`` in place of
the ``pillar_audit``, from the first cloud, outside the timed loop: the
voxels kept against ``max_voxels``, the z layers they reach against the
grid's, and for each stride-2 downsample of the last request's encoder
the sites before and after its cap (``max_voxels`` for ``gather``; the
dense encoder keeps every site).

``--train`` times ``--samples`` train steps (forward, loss with Hungarian
targets matched on the card, one ``hungarian`` launch a step, backward,
clip, AdamW; ``train/step.py``) after ``--warmup``
steps on one synthetic batch, and prints steps/s, ms/step, the kernel
launches of the run and per step, the peak device memory, and the loss
of the first and the last step.  ``--dropout`` sets the head's dropout
rate (0.1 in the reference).

Random weights would leave every DCN ``conv_offset`` at mmcv's zero init,
so the deformable convs would sample only whole-pixel taps; the
benchmark draws those weights too (:data:`OFFSET_PX`), so taps fall
between pixels and past the TPU kernel's ±5 px band, as a trained
checkpoint's offsets do.  A backbone without DCN has nothing to draw.

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` exists for the CPU tests.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from transcar_tpu_torch.core.config import get_preset, parse_overrides
from transcar_tpu_torch.data.synthetic import fake_batch, fake_lidar_batch
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.models.dgcnn import MSDeformAttention
from transcar_tpu_torch.models.resnet import DCNConv
from transcar_tpu_torch.ops import (hungarian, int8, pallas_attention,
                                    pallas_bottleneck, pallas_dcn,
                                    pallas_msdeform, pallas_osa,
                                    pallas_osa_block)
from transcar_tpu_torch.ops.voxelize import hard_voxelize
from transcar_tpu_torch.train.step import init_state, train_step

#: Scale of the random DCN offsets: conv_offset weights are drawn
#: N(0, (OFFSET_PX / √fan_in)²).  The seeded backbone feeds the DCN convs
#: activations of RMS 0.7-2.2, so the mean |offset| is 0.7-3 px and up
#: to a quarter of a deep layer's taps lie past ±5 px (measured on the
#: CPU at 256 × 448).
OFFSET_PX = 1.5

#: Scale of the random MSDeformAttn kernels: ``sampling_offsets`` and
#: ``attention_weights`` weights are drawn N(0, (MSDEFORM_STD / √fan_in)²).
#: The queries (LayerNorm output plus the sine and level embeddings) have
#: an RMS of about 1.5, so the offsets spread about 1.5 cells on top of
#: mmcv's circle of 1-4 cells, and the attention logits about 1.5, a
#: softmax far from uniform.
MSDEFORM_STD = 1.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", nargs="?", default="transcar_r101")
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--height", type=int, default=928)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", action="store_true",
                    help="time train steps instead of inference requests")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="the head's dropout rate in training")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the timed loop "
                         "into this directory (chrome trace, a table of "
                         "device time by kernel, and summary.json: device "
                         "busy time, idle share, and by kernel group the "
                         "time, the host's lead at launch and the idle "
                         "time after)")
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="dotted deep overrides, as for the JAX CLIs")
    args = ap.parse_args(argv)
    if args.samples < 1 or args.warmup < 0:
        ap.error("--samples must be ≥ 1 and --warmup ≥ 0")
    return args


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name: K1-K9, the
    int8 serving mode's convolution (``int8_wgmma`` of them on the
    ``wgmma`` tile), codes passes and standalone amax passes, and the
    train step's Hungarian matching."""
    return {"dcn_forward": pallas_dcn.launches,
            "dcn_backward": pallas_dcn.backward_launches,
            "masked_attention": pallas_attention.launches,
            "osa_reduce": pallas_osa.launches,
            "osa_block": pallas_osa_block.launches,
            "bottleneck": pallas_bottleneck.launches,
            "msdeform_forward": pallas_msdeform.launches,
            "msdeform_backward_taps": pallas_msdeform.backward_taps_launches,
            "msdeform_backward_value":
                pallas_msdeform.backward_value_launches,
            "int8_conv": int8.launches,
            "int8_wgmma": int8.wgmma_launches,
            "int8_quantize": int8.quantize_launches,
            "int8_amax": int8.amax_launches,
            "hungarian": hungarian.launches}


def _launches_since(start: dict) -> dict:
    return {k: v - start[k] for k, v in kernel_counts().items()}


def _peak_memory(dev):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def randomize_offsets(model, generator: torch.Generator) -> None:
    """Draw every DCN conv_offset weight and every MSDeformAttn offset and
    attention-weight kernel (see the module docstring)."""
    def draw(w, scale):
        std = scale / math.sqrt(w[0].numel())
        w.copy_(torch.randn(w.shape, generator=generator).to(w.device) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNConv):
                draw(mod.conv_offset.weight, OFFSET_PX)
            elif isinstance(mod, MSDeformAttention):
                draw(mod.sampling_offsets.weight, MSDEFORM_STD)
                draw(mod.attention_weights.weight, MSDEFORM_STD)


def _audit_hooks(model, stats):
    """Hooks that add the audits' counts to ``stats`` (device tensors, no
    host sync); returns their handles."""
    def dcn(mod, args, om):                    # om: conv_offset output, NCHW
        dy = om[:, 0:18:2].float().abs()
        stats["dcn_taps"] += dy.numel()
        stats["dcn_past_5px"] += (dy > 5.0).sum()

    def fusion(mod, args, kwargs):
        mask = kwargs["mask"]
        stats["fusion_pairs"] += mask.numel()
        stats["fusion_kept"] += (~mask).sum()

    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, DCNConv):
            handles.append(mod.conv_offset.register_forward_hook(dcn))
        elif name.startswith("head.fusion") and name.endswith("_attn"):
            handles.append(mod.register_forward_pre_hook(fusion,
                                                         with_kwargs=True))
    return handles


def _profiler(trace_dir, dev):
    """A torch.profiler context for the timed loop, or a no-op."""
    if trace_dir is None:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _write_trace(prof, trace_dir, dev, wall_s: float, count: int) -> dict:
    """Write the chrome trace, a table of time by kernel and
    ``summary.json`` (:func:`trace_summary`); returns the summary."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    sort = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
    with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
    summary = trace_summary(path, wall_s, count)
    with open(os.path.join(trace_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


#: Kernel groups of the trace summary: the first pattern a kernel's name
#: contains decides its group.
KERNEL_GROUPS = (
    ("K1 dcn_forward", ("dcn_forward_kernel", "dcn_forward_wgmma_kernel")),
    ("K3 dcn_backward", ("dcn_bwd_",)),
    ("K2 masked_attention", ("masked_attention",)),
    ("K4 osa_reduce", ("osa_reduce_wgmma", "conv_gemm_kernel<4,")),
    ("K5 osa_block", ("osa_chain_wgmma", "conv_gemm_kernel<5,")),
    ("K6 bottleneck", ("bottleneck_", "conv_gemm_kernel<6,")),
    ("K7 msdeform_forward", ("msdeform_forward_",)),
    ("K8 msdeform_backward_taps", ("msdeform_backward_taps_",)),
    ("K9 msdeform_backward_value", ("msdeform_backward_value_",)),
    ("int8 conv", ("int8_conv",)),
    ("int8 quantize", ("int8_amax", "int8_codes")),
    ("Hungarian matching", ("hungarian",)),
    ("GEMM / convolution (cuBLAS, cuDNN)", (
        "gemm", "Gemm", "cutlass", "xmma", "conv", "Conv", "dgrad", "wgrad",
        "fprop", "implicit")),
    ("optimizer (AdamW, clip)", ("multi_tensor", "adam", "Adam", "foreach")),
    ("index / gather / scatter", ("index", "gather", "scatter", "Index")),
    ("elementwise / reduce / copy", ("elementwise", "vectorized", "reduce",
                                     "Reduce", "copy", "Copy", "fill",
                                     "Fill", "norm", "Norm", "softmax",
                                     "Softmax", "CatArray", "pool")),
)


def trace_summary(trace_path: str, wall_s: float, count: int) -> dict:
    """Device time of a profiled loop of ``count`` iterations that took
    ``wall_s`` seconds: the union of the kernels' intervals (busy), the
    idle share of the wall time, kernels per iteration, and time per
    iteration by kernel group (summed kernel durations, so overlapping
    kernels count twice there).  Per group also the median host lead (a
    kernel's device start less its launch call's host start: how far the
    host was ahead of the device there; ~0.01 ms means the device waited
    for the launch) and the mean device idle time right after a kernel
    of the group (to the next kernel's start)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    ks = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                 e.get("args", {}).get("correlation")) for e in events
                if e.get("cat") == "kernel" and "dur" in e)
    busy_us, groups, leads, idle_after = 0.0, {}, {}, {}
    end = None
    for i, (s, e, name, corr) in enumerate(ks):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
        group = next((g for g, pats in KERNEL_GROUPS
                      if any(p in name for p in pats)), "other")
        groups[group] = groups.get(group, 0.0) + (e - s)
        if corr in launched:
            leads.setdefault(group, []).append(s - launched[corr])
        if i + 1 < len(ks):
            idle_after.setdefault(group, []).append(
                max(ks[i + 1][0] - end, 0.0))
    per = max(count, 1)
    order = sorted(groups, key=lambda g: -groups[g])
    return {
        "iterations": count,
        "wall_ms_per_iter": 1e3 * wall_s / per,
        "device_busy_ms_per_iter": busy_us / 1e3 / per,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s) if ks else None,
        "kernels_per_iter": len(ks) / per,
        "ms_per_iter_by_group": {g: groups[g] / 1e3 / per for g in order},
        "host_lead_ms_by_group": {g: statistics.median(leads[g]) / 1e3
                                  for g in order if g in leads},
        "idle_after_ms_by_group": {g: statistics.fmean(idle_after[g]) / 1e3
                                   for g in order if g in idle_after},
    }


def _setup(args, training: bool):
    """Config, model with randomized offsets, and the synthetic batch (or
    point cloud, for a LiDAR preset) on the device."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False (use --device cpu for a CPU run)")
    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    model = build_model(cfg, device=dev, training=training, seed=args.seed,
                        dropout=args.dropout)
    randomize_offsets(model, torch.Generator().manual_seed(args.seed + 1))
    head = cfg.model.head
    rng = np.random.default_rng(args.seed)
    if cfg.model.lidar_encoder:
        batch = fake_lidar_batch(rng, args.batch, cfg.data.max_points,
                                 head.pc_range)
    else:
        batch = fake_batch(rng, args.batch, head.num_cams, args.height,
                           args.width, head.num_radar_tokens)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if not head.with_radar_fusion:
        batch.pop("radar_tokens", None)
    return cfg, model, batch, dev


def pillar_audit(cfg, batch) -> dict:
    """Pillars the voxelizer keeps and the BEV rows they reach, for the
    first cloud of the batch."""
    m = cfg.model
    _, coords, _, nv = hard_voxelize(
        batch["points"][:1], batch["num_points"][:1], m.voxel_size,
        m.head.pc_range, m.max_points_per_voxel, m.max_voxels)
    n = int(nv[0])
    rows = int(coords[0, :n, 1].max()) + 1 if n else 0
    return {"pillars": n, "max_pillars": m.max_voxels,
            "bev_rows_reached": rows, "bev_rows": m.bev_hw[0]}


def voxel_audit(cfg, model, batch) -> dict:
    """Voxels the voxelizer keeps and the z layers they reach, and for
    each stride-2 downsample of the middle encoder's last forward the
    sites it marked and the sites it kept (under the gather encoder's cap
    of ``max_voxels``; the dense one has none), for the first cloud of
    the batch."""
    m = cfg.model
    pc, vs = m.head.pc_range, m.voxel_size
    _, coords, _, nv = hard_voxelize(
        batch["points"][:1], batch["num_points"][:1], vs, pc,
        m.max_points_per_voxel, m.max_voxels)
    n = int(nv[0])
    return {"voxels": n, "max_voxels": m.max_voxels,
            "z_layers_reached": int(coords[0, :n, 0].max()) + 1 if n else 0,
            "z_layers": round((pc[5] - pc[2]) / vs[2]),
            "downsamples": [{"sites": int(marked[0]), "kept": int(kept[0])}
                            for marked, kept in
                            model.middle_encoder.downsample_sites]}


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_train(argv=None):
    """Build, warm up and time train steps; returns (record, state)."""
    args = parse_args(argv)
    cfg, model, batch, dev = _setup(args, training=True)
    steps = args.warmup + args.samples
    state = init_state(cfg, model, total_steps=steps)
    gen = torch.Generator().manual_seed(args.seed + 2)
    counts0 = kernel_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for _ in range(args.warmup):
        losses.append(train_step(state, batch, gen))
    _sync(dev)
    with _profiler(args.trace_dir, dev) as prof:
        t0 = time.perf_counter()
        for _ in range(args.samples):
            losses.append(train_step(state, batch, gen))
        _sync(dev)
        dt = time.perf_counter() - t0
    trace = (None if args.trace_dir is None else
             _write_trace(prof, args.trace_dir, dev, dt, args.samples))
    launches = _launches_since(counts0)
    record = {
        "preset": args.preset,
        "mode": "train",
        "batch": args.batch,
        **({"max_points": cfg.data.max_points} if cfg.model.lidar_encoder
           else {"img_hw": [args.height, args.width]}),
        "device": _device_name(dev),
        "steps_per_sec": args.samples / dt,
        "ms_per_step": 1000.0 * dt / args.samples,
        "steps": steps,
        "kernel_launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "peak_memory_bytes": _peak_memory(dev),
        "loss_first": {k: float(v) for k, v in losses[0].items()},
        "loss_last": {k: float(v) for k, v in losses[-1].items()},
        "fusion_only": state.stop_camera_grad,
        "trace": trace,
    }
    return record, state


def run(argv=None):
    """Build, warm up and time inference; returns (record, last outputs)."""
    args = parse_args(argv)
    cfg, model, batch, dev = _setup(args, training=False)
    lidar = bool(cfg.model.lidar_encoder)
    inputs = ([batch["points"], batch["num_points"]] if lidar else
              [batch["images"], batch["lidar2img"], batch.get("radar_tokens")])

    counts0 = kernel_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stats = dict.fromkeys(("dcn_taps", "dcn_past_5px", "fusion_pairs",
                           "fusion_kept"), 0)
    with torch.inference_mode():
        for i in range(args.warmup):
            handles = _audit_hooks(model, stats) if i == 0 else []
            out = model(*inputs)
            for h in handles:
                h.remove()
        _sync(dev)
        with _profiler(args.trace_dir, dev) as prof:
            t0 = time.perf_counter()
            for _ in range(args.samples):
                out = model(*inputs)
            _sync(dev)
            dt = time.perf_counter() - t0
    trace = (None if args.trace_dir is None else
             _write_trace(prof, args.trace_dir, dev, dt, args.samples))
    record = {
        "preset": args.preset,
        "batch": args.batch,
        **({"max_points": cfg.data.max_points} if lidar else
           {"img_hw": [args.height, args.width]}),
        "device": _device_name(dev),
        "samples_per_sec": args.samples * args.batch / dt,
        "ms_per_sample": 1000.0 * dt / (args.samples * args.batch),
        "requests": args.warmup + args.samples,
        "kernel_launches": _launches_since(counts0),
        "peak_memory_bytes": _peak_memory(dev),
        "trace": trace,
        "dcn_taps_past_5px": (float(stats["dcn_past_5px"] / stats["dcn_taps"])
                              if stats["dcn_taps"] else None),
    }
    if lidar:
        with torch.inference_mode():
            if cfg.model.lidar_encoder == "voxel":
                record["voxel_audit"] = voxel_audit(cfg, model, batch)
            else:
                record["pillar_audit"] = pillar_audit(cfg, batch)
    if stats["fusion_pairs"]:
        record["fusion_keep_share"] = float(stats["fusion_kept"]
                                            / stats["fusion_pairs"])
    return record, out


def main(argv=None):
    train = "--train" in (argv if argv is not None else sys.argv[1:])
    record, _ = (run_train if train else run)(argv)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
