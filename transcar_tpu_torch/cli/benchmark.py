"""Inference throughput of the port (``transcar_tpu/cli/benchmark.py`` analog).

Usage (from the repository root)::

    python -m transcar_tpu_torch.cli.benchmark transcar_r101 \
        [--samples 20] [--warmup 3] [--batch 1] [--cfg-options k.sub=v ...]

Times batch inference after ``--warmup`` requests, with
``torch.cuda.synchronize()`` around the timed loop (the reference protocol,
tools/analysis_tools/benchmark.py:64-91, which ``bench.py`` cites), on
seeded random weights and the inputs of ``__graft_entry__._fake_batch``.
Prints one JSON line: samples/s, ms/sample, the device's name, the
kernel launches of the run, and two audits of the first warmup request:
the share of DCN taps whose vertical offset exceeds 5 px (the TPU
kernel's exact band; here every tap is exact) and the share of (query,
radar token) pairs the fusion masks keep.

Random weights would leave every DCN ``conv_offset`` at mmcv's zero init,
so the deformable convs would sample only whole-pixel taps; the
benchmark draws those weights too (:data:`OFFSET_PX`), so taps fall
between pixels and past the TPU kernel's ±5 px band, as a trained
checkpoint's offsets do.

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` exists for the CPU tests.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time

import numpy as np
import torch

from transcar_tpu_torch.core.config import get_preset, load_shared
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.models.resnet import DCNConv
from transcar_tpu_torch.ops import pallas_attention, pallas_dcn

#: Scale of the random DCN offsets: conv_offset weights are drawn
#: N(0, (OFFSET_PX / √fan_in)²).  The seeded backbone feeds the DCN convs
#: activations of RMS 0.7-2.2, so the mean |offset| is 0.7-3 px and up
#: to a quarter of a deep layer's taps lie past ±5 px (measured on the
#: CPU at 256 × 448).
OFFSET_PX = 1.5


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
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the timed loop "
                         "into this directory (chrome trace + a table of "
                         "device time by kernel)")
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="dotted deep overrides, as for the JAX CLIs")
    args = ap.parse_args(argv)
    if args.samples < 1 or args.warmup < 0:
        ap.error("--samples must be ≥ 1 and --warmup ≥ 0")
    return args


def randomize_offsets(model, generator: torch.Generator) -> None:
    """Draw every DCN conv_offset weight (see the module docstring)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNConv):
                w = mod.conv_offset.weight
                std = OFFSET_PX / math.sqrt(w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)


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


def _write_trace(prof, trace_dir, dev):
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    sort = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
    with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))


def run(argv=None):
    """Build, warm up and time; returns (record, last outputs)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False (use --device cpu for a CPU run)")
    import __graft_entry__ as ge        # its fake batch needs numpy only

    overrides = load_shared("transcar_tpu/cli/train.py").parse_overrides(
        args.cfg_options)
    cfg = get_preset(args.preset, overrides)
    model = build_model(cfg, device=dev, seed=args.seed)
    gen = torch.Generator().manual_seed(args.seed + 1)
    randomize_offsets(model, gen)
    head = cfg.model.head
    batch = ge._fake_batch(np.random.default_rng(args.seed), args.batch,
                           head.num_cams, args.height, args.width,
                           head.num_radar_tokens)
    inputs = [torch.from_numpy(batch["images"]).to(dev),
              torch.from_numpy(batch["lidar2img"]).to(dev),
              torch.from_numpy(batch["radar_tokens"]).to(dev)
              if head.with_radar_fusion else None]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    counts0 = (pallas_dcn.launches, pallas_attention.launches)
    stats = dict.fromkeys(("dcn_taps", "dcn_past_5px", "fusion_pairs",
                           "fusion_kept"), 0)
    with torch.inference_mode():
        for i in range(args.warmup):
            handles = _audit_hooks(model, stats) if i == 0 else []
            out = model(*inputs)
            for h in handles:
                h.remove()
        sync()
        with _profiler(args.trace_dir, dev) as prof:
            t0 = time.perf_counter()
            for _ in range(args.samples):
                out = model(*inputs)
            sync()
            dt = time.perf_counter() - t0
    if args.trace_dir is not None:
        _write_trace(prof, args.trace_dir, dev)
    record = {
        "preset": args.preset,
        "batch": args.batch,
        "img_hw": [args.height, args.width],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "samples_per_sec": args.samples * args.batch / dt,
        "ms_per_sample": 1000.0 * dt / (args.samples * args.batch),
        "requests": args.warmup + args.samples,
        "kernel_launches": {
            "dcn_forward": pallas_dcn.launches - counts0[0],
            "masked_attention": pallas_attention.launches - counts0[1],
        },
    }
    if stats["dcn_taps"]:
        record["dcn_taps_past_5px"] = float(stats["dcn_past_5px"]
                                            / stats["dcn_taps"])
    if stats["fusion_pairs"]:
        record["fusion_keep_share"] = float(stats["fusion_kept"]
                                            / stats["fusion_pairs"])
    return record, out


def main(argv=None):
    record, _ = run(argv)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
