"""Export CLI: the eval forward and its NMS-free decode as one
``torch.export`` program (``transcar_tpu/cli/export.py``, which writes
StableHLO).

The program is what ``evaluate()`` runs a batch through: backbone → FPN →
head → ``eval/decode.nms_free_decode`` (``train/step.eval_step`` on a
normalized float32 batch), traced in eval mode under ``torch.no_grad()``.
The hand-written kernels on that path are ``torch.library`` ops
(``transcar::dcn_forward``, ``masked_attention``, ``osa_reduce``,
``msdeform_forward``; with ``model.backbone.osa_reduce_impl=fused``
``osa_block``, with ``block_impl=fused`` ``bottleneck``, with
``quantize=int8`` ``int8_amax``, ``int8_codes`` and ``int8_conv``), so
the graph calls them by name and the loaded program launches them on the
card.  Unlike the JAX artifact, which takes the parameters as call
arguments, the program holds the model's ``state_dict`` as its state: the
weights of ``--checkpoint`` (seeded random ones without it), with the
frozen BatchNorms folded into the convs as ``evaluate()`` folds them
(``train/fold.py``) unless ``--no-fold-bn``.  Beside them it holds what
the kernels read derived from those weights, computed once at export by
one eager forward (``models/common.derived_weights_held``): the K-major
weight copies of K1, K4, K5 and K6, and int8's per-channel weight codes,
scales and folded affines, so a call rebuilds and re-quantizes none of
them.  The LiDAR track's BatchNorm statistics are buffers in that state,
so the program takes no ``batch_stats`` argument.

Usage:
    python -m transcar_tpu_torch.cli.export <preset> --out model.pt2
        [--checkpoint CKPT] [--batch-size B] [--no-fold-bn]
        [--device cpu] [--cfg-options ...]

Serving side (``import transcar_tpu_torch.ops`` registers the ops; the
program cannot load without them):
    import torch, transcar_tpu_torch.ops
    program = torch.export.load("model.pt2").module()
    out = program(batch)     # dict: boxes, scores, labels, valid

``batch`` is the dict the sidecar ``model.pt2.json`` lists, on the device
the program was exported on.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import torch
from torch import nn

from transcar_tpu_torch.eval.decode import nms_free_decode
from transcar_tpu_torch.models.common import derived_weights_held
from transcar_tpu_torch.train.step import forward


class EvalProgram(nn.Module):
    """The eval forward and decode of ``model`` on a normalized batch:
    the function the exported program computes."""

    def __init__(self, model: nn.Module, cfg):
        super().__init__()
        self.model = model
        self.head_cfg = cfg.model.head

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return nms_free_decode(forward(self.model, batch), self.head_cfg)


def example_batch(cfg, batch_size: int, device) -> Dict[str, torch.Tensor]:
    """Zeros in the calling convention's shapes and dtypes (a LiDAR batch
    of points and point counts, or a camera batch of normalized float32
    images, lidar2img and, with radar fusion, radar tokens)."""
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    if cfg.model.lidar_encoder:
        return {"points": zeros(batch_size, cfg.data.max_points, 5),
                "num_points": zeros(batch_size, dtype=torch.int32)}
    h, w = cfg.data.img_hw
    n = cfg.model.head.num_cams
    batch = {"images": zeros(batch_size, n, h, w, 3),
             "lidar2img": zeros(batch_size, n, 4, 4)}
    if cfg.model.head.with_radar_fusion:
        batch["radar_tokens"] = zeros(
            batch_size, cfg.model.head.num_radar_tokens, 36)
    return batch


def tree_doc(tree: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """``{name: "dtype[shape]"}``, as the JAX sidecar writes its trees."""
    return {k: f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
            for k, v in tree.items()}


def output_specs(exported) -> Dict[str, torch.Tensor]:
    """The program's outputs as the fake tensors its trace recorded."""
    from torch.utils._pytree import tree_unflatten

    node = next(n for n in exported.graph.nodes if n.op == "output")
    return tree_unflatten([n.meta["val"] for n in node.args[0]],
                          exported.call_spec.out_spec)


def export_eval_step(cfg, model: nn.Module, batch_size: int = 1,
                     fold_bn: bool = True):
    """Returns (``torch.export.ExportedProgram``, sidecar dict) of
    ``model`` (eval mode, on its device) with its weights and the layouts
    derived from them as state; ``fold_bn`` folds the frozen BatchNorms
    into ``model`` in place first."""
    if fold_bn:
        from transcar_tpu_torch.train.fold import (fold_bn_into_conv,
                                                   frozen_bn_names)
        model.load_state_dict(fold_bn_into_conv(model.state_dict(),
                                                frozen_bn_names(model)))
    device = next(model.parameters()).device
    batch = example_batch(cfg, batch_size, device)
    grads = [(p, p.requires_grad) for p in model.parameters()]
    model.requires_grad_(False)        # a graph without autograd state
    program = EvalProgram(model, cfg).eval()
    try:
        with torch.no_grad():
            program(batch)             # builds the derived layouts
        with derived_weights_held(model) as n_held:
            exported = torch.export.export(program, (batch,))
    finally:
        for p, wanted in grads:
            p.requires_grad_(wanted)
    sidecar = {
        "preset": cfg.name,
        "platforms": [device.type],
        "batch": tree_doc(batch),
        "outputs": tree_doc(output_specs(exported)),
        "takes_batch_stats": False,
        "batch_stats": "none as an argument: BatchNorm statistics are "
                       "buffers in the program's state",
        "params": ("the model's state_dict, held in the program "
                   + ("(fold_bn_into_conv applied, as evaluate() folds)"
                      if fold_bn else "(unfolded)")),
        "derived": (f"{n_held} tensors derived from the weights at export "
                    "(K-major copies, int8 codes, scales and folded "
                    "affines), held as non-persistent buffers"),
        "ops": "import transcar_tpu_torch.ops before torch.export.load",
    }
    return exported, sidecar


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset")
    ap.add_argument("--out", required=True,
                    help="output program path (.pt2); the sidecar goes "
                         "to <out>.json")
    ap.add_argument("--checkpoint",
                    help="weights to hold: a training step dir, a "
                         "params-only file or a reference .pth (seeded "
                         "random weights without it)")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="hold the unfolded weights (evaluate() folds the "
                         "frozen BatchNorms into the convs by default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.train.loop import _load_params, resolve_device

    device = resolve_device(args.device)
    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    model = build_model(cfg, device=device)
    if args.checkpoint:
        model.load_state_dict(_load_params(args.checkpoint, cfg, model))
    exported, sidecar = export_eval_step(cfg, model, args.batch_size,
                                         fold_bn=not args.no_fold_bn)
    torch.export.save(exported, args.out)
    with open(args.out + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    print(f"exported {args.preset} (platforms {sidecar['platforms']}) "
          f"to {args.out}")
    return exported, sidecar


if __name__ == "__main__":
    main()
