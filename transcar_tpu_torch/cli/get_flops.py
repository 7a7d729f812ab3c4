"""Static FLOPs CLI (tools/analysis_tools/get_flops.py analog;
``transcar_tpu/cli/get_flops.py``, which reads XLA's cost analysis).

Counts one eval forward with ``torch.utils.flop_counter.FlopCounterMode``
on the meta device: the model is built there and the hand-written
kernels' registered ops give their output shapes through their fakes, so
full width costs no memory and needs no card.  PyTorch counts its own
matmuls and convolutions; each kernel op counts through its flop formula,
on the shared counts of ``ops/counts.py`` that ``chip_smoke.py``'s bounds
read.  Softmax, normalization and elementwise work are not counted (as
in the reference's hook counter), so the total is not XLA's.  Both
modalities are served: the camera presets through images, the LiDAR ones
through points.

Usage:
    python -m transcar_tpu_torch.cli.get_flops [preset] [--height H]
        [--width W] [--cfg-options ...]

Prints one JSON line: ``preset``, ``input``, ``gflops``,
``bytes_accessed_gb`` (null: PyTorch has no cost model of memory
traffic; ``bytes_note`` says so), ``params_m`` (the parameters the JAX
package holds, so its count: every ``state_dict`` entry but the LiDAR
BatchNorms' running statistics, which JAX keeps in ``batch_stats``) and
``kernel_gflops`` (the registered kernel ops' share, by op).
"""
from __future__ import annotations

import argparse
import json

import torch

from transcar_tpu_torch import ops  # noqa: F401  (registers the ops)


def param_count(model: torch.nn.Module) -> int:
    """Elements of the ``state_dict`` entries that are JAX ``params``:
    all but the running statistics of trainable BatchNorms."""
    from transcar_tpu_torch.models.common import BatchNorm
    stats = {f"{name}.{buf}" if name else buf
             for name, mod in model.named_modules()
             if isinstance(mod, BatchNorm)
             for buf in ("running_mean", "running_var")}
    return sum(t.numel() for k, t in model.state_dict().items()
               if k not in stats)


def count_flops(cfg, height: int, width: int) -> dict:
    """The JSON record of one batch-1 eval forward of ``cfg``'s model."""
    from torch.utils.flop_counter import FlopCounterMode

    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.train.step import forward

    with torch.device("meta"):
        model = build_model(cfg, device="meta").requires_grad_(False)
    meta = torch.device("meta")
    if cfg.model.lidar_encoder:
        n_max = cfg.data.max_points
        batch = {"points": torch.zeros(1, n_max, 5, device=meta),
                 "num_points": torch.zeros(1, dtype=torch.int32,
                                           device=meta)}
        input_desc = [1, n_max, 5]
    else:
        n = cfg.model.head.num_cams
        batch = {"images": torch.zeros(1, n, height, width, 3, device=meta),
                 "lidar2img": torch.zeros(1, n, 4, 4, device=meta)}
        if cfg.model.head.with_radar_fusion:
            batch["radar_tokens"] = torch.zeros(
                1, cfg.model.head.num_radar_tokens, 36, device=meta)
        input_desc = [1, n, height, width, 3]
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        forward(model, batch)
    by_op = counter.get_flop_counts().get("Global", {})
    kernels = {str(op).split(".")[-1]: round(f / 1e9, 2)
               for op, f in by_op.items() if "transcar" in str(op)}
    return {
        "preset": cfg.name,
        "input": input_desc,
        "gflops": round(counter.get_total_flops() / 1e9, 2),
        "bytes_accessed_gb": None,
        "bytes_note": "not reckoned: PyTorch has no cost model of memory "
                      "traffic",
        "params_m": round(param_count(model) / 1e6, 2),
        "kernel_gflops": kernels,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", nargs="?", default="transcar_r101")
    ap.add_argument("--height", type=int, default=928)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="dotted deep overrides, same as the train CLI")
    args = ap.parse_args(argv)

    from transcar_tpu_torch.core.config import get_preset, parse_overrides

    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    record = count_flops(cfg, args.height, args.width)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
