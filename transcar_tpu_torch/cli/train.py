"""Train CLI (tools/train.py analog; ``transcar_tpu/cli/train.py``).

Usage:
    python -m transcar_tpu_torch.cli.train <preset> [--work-dir D]
        [--load-from CKPT|REF.pth] [--resume-from D] [--seed N]
        [--max-steps N] [--no-validate] [--eval-samples N]
        [--autoscale-lr] [--trace-dir D] [--device cpu]
        [--dist-backend nccl|gloo] [--cfg-options k.subkey=value ...]

Presets replace the reference's config files; --cfg-options is the deep
override (tools/train.py:59-68 analog).  Radar tokens come from the
dataset's nuScenes tables and radar ``.pcd`` files when the preset has
radar fusion (``data/radar_io.py``, no devkit needed).  The run takes the
card unless ``--device cpu`` is given; without CUDA it raises.

Launched on W processes (torchrun, or Slurm: ``transcar_tpu_torch/tools/
{dist,slurm}_train.sh``) it trains data-parallel, each rank on
``cuda:LOCAL_RANK`` (``parallel/distributed.maybe_initialize_distributed``,
backend ``--dist-backend``: nccl on the card, gloo on the CPU unless
named); the global batch is ``data.samples_per_device`` × W.
``--autoscale-lr`` scales the lr by the card count over the reference's
8 (the linear scaling rule, tools/train.py:148-150).
"""
from __future__ import annotations

import argparse
import os

from transcar_tpu_torch.core.config import parse_overrides


def main(argv=None):
    """Parse ``argv`` and train; returns the final ``TrainState``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset")
    ap.add_argument("--work-dir")
    ap.add_argument("--load-from")
    ap.add_argument("--resume-from")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--max-steps", type=int)
    ap.add_argument("--autoscale-lr", action="store_true",
                    help="linear LR scaling: lr × card count / 8 (one "
                         "card a rank)")
    ap.add_argument("--no-validate", action="store_true",
                    help="disable the mid-training eval hook "
                         "(tools/train.py:44-46 analog)")
    ap.add_argument("--eval-samples", type=int,
                    help="bound each mid-training val pass to N samples")
    ap.add_argument("--log-interval", type=int, default=50,
                    help="steps between train records in the json log")
    ap.add_argument("--trace-dir",
                    help="capture a torch.profiler trace of a few train "
                         "steps into this directory (chrome trace and "
                         "summary.json: device busy time and idle share)")
    ap.add_argument("--trace-start", type=int, default=8,
                    help="steps this process runs before the --trace-dir "
                         "window opens")
    ap.add_argument("--trace-steps", type=int, default=3,
                    help="steps to include in the --trace-dir capture")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="process-group backend under torchrun or Slurm "
                         "(default: nccl with --device cuda, gloo with "
                         "--device cpu)")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    import dataclasses

    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)

    overrides = parse_overrides(args.cfg_options)
    if args.work_dir:
        overrides["train.work_dir"] = args.work_dir
    else:
        overrides.setdefault("train.work_dir", f"work_dirs/{args.preset}")
    if args.load_from:
        # fail fast: building the model takes a while at full width
        if not os.path.exists(args.load_from):
            ap.error(f"--load-from path does not exist: {args.load_from}")
        overrides["train.load_from"] = args.load_from
    if args.resume_from:
        if not os.path.exists(args.resume_from):
            ap.error(f"--resume-from path does not exist: "
                     f"{args.resume_from}")
        overrides["train.resume_from"] = args.resume_from
    if args.seed is not None:
        overrides["train.seed"] = args.seed
    if args.no_validate:
        overrides["train.eval_interval_epochs"] = "0"
    cfg = get_preset(args.preset, overrides)

    from transcar_tpu_torch.core.device import set_deterministic
    from transcar_tpu_torch.train.loop import resolve_device, train
    set_deterministic(args.device)     # before anything touches the card
    resolve_device(args.device)        # raises without CUDA, before a group
    rank, world = maybe_initialize_distributed(args.device,
                                               args.dist_backend)
    device = resolve_device(args.device)
    if args.autoscale_lr:
        # the linear scaling rule against the reference's 8-GPU schedule
        # (tools/train.py:148-150); one card a rank
        optim = dataclasses.replace(cfg.train.optim,
                                    lr=cfg.train.optim.lr * world / 8.0)
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, optim=optim))
        if rank == 0:
            print(f"autoscale-lr: {world} devices → lr {optim.lr:.2e}")
    radar_fn = None
    if cfg.model.head.with_radar_fusion:
        radar_fn = _try_radar_fn(cfg)
    return train(cfg, radar_fn=radar_fn, max_steps=args.max_steps,
                 log_interval=args.log_interval,
                 eval_samples=args.eval_samples, trace_dir=args.trace_dir,
                 trace_start=args.trace_start, trace_steps=args.trace_steps,
                 device=device)


def _try_radar_fn(cfg):
    """Radar token provider: devkit-free ingestion (data/radar_io.py
    tables + .pcd reader; C++ featurizer when built) with an on-disk
    per-sample cache — tokens are deterministic given the sample, so
    they are computed once per dataset, not per epoch (vs the
    reference's per-step devkit file IO, detr3d_head.py:301-536)."""
    try:
        import numpy as np
        from transcar_tpu_torch.data.radar import (empty_radar_tokens,
                                                   load_radar_tokens)
        from transcar_tpu_torch.data.radar_io import NuScenesTables

        nusc = NuScenesTables(cfg.data.data_root,
                              version=cfg.data.version)
        # fail fast here (not inside the loader workers) when the raw
        # tables are absent — triggers the sentinel-buffer fallback
        nusc.tokens("sample")
        cache_dir = os.path.join(cfg.data.data_root, "radar_token_cache",
                                 f"{cfg.data.radar_sweeps}sweep_"
                                 f"{cfg.model.head.num_radar_tokens}")
        os.makedirs(cache_dir, exist_ok=True)

        warned = set()

        def radar_fn(token):
            path = os.path.join(cache_dir, f"{token}.npy")
            if os.path.exists(path):
                return np.load(path)
            try:
                tokens = load_radar_tokens(
                    nusc, token, nsweeps=cfg.data.radar_sweeps,
                    num_tokens=cfg.model.head.num_radar_tokens)
            except Exception as e:   # token absent from tables / bad .pcd
                if type(e).__name__ not in warned:
                    warned.add(type(e).__name__)
                    print(f"[train] radar ingestion failed for sample "
                          f"{token} ({type(e).__name__}: {e}); feeding "
                          "the sentinel buffer for such samples")
                return empty_radar_tokens(cfg.model.head.num_radar_tokens)
            np.save(path, tokens)
            return tokens

        return radar_fn
    except Exception as e:          # raw tables unavailable
        from transcar_tpu_torch.data.radar import empty_radar_tokens
        print(f"[train] radar pipeline unavailable ({e}); feeding the "
              "all-sentinel radar buffer (queries see no radar tokens)")
        return lambda token: empty_radar_tokens(
            cfg.model.head.num_radar_tokens)


if __name__ == "__main__":
    main()
