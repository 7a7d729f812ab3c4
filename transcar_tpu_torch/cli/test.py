"""Eval CLI (tools/test.py analog; ``transcar_tpu/cli/test.py``).

Usage:
    python -m transcar_tpu_torch.cli.test <preset> <checkpoint>
        [--format-only] [--eval bbox] [--out results.json]
        [--max-samples N] [--show-dir D] [--batch-size B] [--no-fold-bn]
        [--device cpu] [--aug-test [identity,flip]] [--shard-cameras]
        [--dist-backend nccl|gloo] [--cfg-options ...]

The checkpoint is a training step dir (``work_dir/checkpoints/<step>``),
a params-only file, or a reference ``.pth`` (converted on load).  --eval
bbox runs the devkit DetectionEval when it and the raw dataset are
there, else the native evaluator (``eval/metrics.py``).  The run takes
the card unless ``--device cpu`` is given; without CUDA it raises.
``--aug-test`` runs test-time augmentation (``train/step.py::
aug_eval_step``; camera presets); ``--cfg-options
model.backbone.quantize=int8`` serves with int8 backbone convolutions
(``ops/int8.py``), with or without it.  ``--shard-cameras`` runs each
camera group's backbone and FPN on a card of its own (camera track, one
process; ``train/loop.evaluate``).  Launched on W processes (torchrun or
Slurm, ``transcar_tpu_torch/tools/{dist,slurm}_test.sh``) the samples
are strided across the ranks and rank 0 writes and scores the
submission.  ``--show-dir D`` renders one BEV PNG a sample of the
submission into ``D`` (``eval/bev_plot.py``), on rank 0.
"""
from __future__ import annotations

import argparse
import os

from transcar_tpu_torch.cli.train import _try_radar_fn
from transcar_tpu_torch.core.config import parse_overrides


def main(argv=None):
    """Parse ``argv``, evaluate; returns the ``train.loop.EvalResult``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset")
    ap.add_argument("checkpoint")
    ap.add_argument("--format-only", action="store_true")
    ap.add_argument("--eval", dest="eval_metric", nargs="?", const="bbox")
    ap.add_argument("--out")
    ap.add_argument("--max-samples", type=int)
    ap.add_argument("--show-dir",
                    help="render BEV PNGs of the predictions into this "
                         "directory (tools/test.py:43-45 analog, headless)")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="inference batch size (samples_per_gpu analog, "
                         "tools/test.py:183-189); the tail batch is padded "
                         "and padded rows dropped, so results match bs=1")
    ap.add_argument("--fuse-conv-bn", action="store_true",
                    help="precompute frozen-BN affines before inference "
                         "(tools/test.py:27-30 analog; the conv fold is "
                         "the eval default — see --no-fold-bn)")
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="disable the default conv-BN fold at eval "
                         "(unfolded numerics)")
    ap.add_argument("--shard-cameras", action="store_true",
                    help="camera-axis model parallelism: each camera "
                         "group's backbone and FPN on a card of its own "
                         "(batch-1 latency, which data parallelism cannot "
                         "cut; the output is the unsharded one; camera "
                         "track only)")
    ap.add_argument("--aug-test", nargs="?", const="identity,flip",
                    help="test-time augmentation: comma list from "
                         "identity,flip (default both); backbone+FPN "
                         "features are averaged over the augmented copies "
                         "before the head (reference aug_test, "
                         "detr3d.py:195-219)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="process-group backend under torchrun or Slurm "
                         "(default: nccl with --device cuda, gloo with "
                         "--device cpu)")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)
    from transcar_tpu_torch.train.loop import (_load_params, evaluate,
                                               resolve_device)

    resolve_device(args.device)        # raises without CUDA, before a group
    rank, _ = maybe_initialize_distributed(args.device, args.dist_backend)
    device = resolve_device(args.device)
    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    model = build_model(cfg, device=device)
    model.load_state_dict(_load_params(args.checkpoint, cfg, model))
    if args.fuse_conv_bn:
        from transcar_tpu_torch.train.fold import (fold_frozen_bn,
                                                   frozen_bn_names)
        model.load_state_dict(fold_frozen_bn(model.state_dict(),
                                             frozen_bn_names(model)))
    radar_fn = (_try_radar_fn(cfg)
                if cfg.model.head.with_radar_fusion else None)
    result = evaluate(cfg, model, radar_fn=radar_fn,
                      max_samples=args.max_samples, out_path=args.out,
                      batch_size=args.batch_size,
                      fold_bn=not args.no_fold_bn,
                      aug_test=(args.aug_test.split(",")
                                if args.aug_test else None),
                      shard_cameras=args.shard_cameras)
    if rank != 0:        # rank 0 wrote the submission and scores it
        return result
    print(f"results written to {result.path}")

    if args.show_dir:
        from transcar_tpu_torch.eval.bev_plot import render_submission
        render_submission(result.path, args.show_dir)

    if args.eval_metric:
        metrics = None
        try:    # devkit DetectionEval when raw data is on disk
            from transcar_tpu_torch.eval.submission import evaluate_nuscenes
            metrics = evaluate_nuscenes(result.path, cfg.data.data_root,
                                        version=cfg.data.version)
            print("metrics source: nuscenes-devkit")
        except (ImportError, FileNotFoundError) as e:
            print(f"devkit unavailable ({type(e).__name__}: {e}); "
                  f"using the native evaluator")
        except Exception as e:
            # the devkit IS present but evaluation failed: surface the
            # error before falling back
            print(f"devkit evaluation FAILED ({type(e).__name__}: {e}); "
                  f"falling back to the native evaluator")
        if metrics is None:
            from transcar_tpu_torch.eval.metrics import evaluate_native
            metrics = evaluate_native(
                result.path, ann_file=os.path.join(cfg.data.data_root,
                                                   cfg.data.ann_val))
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")
    return result


if __name__ == "__main__":
    main()
