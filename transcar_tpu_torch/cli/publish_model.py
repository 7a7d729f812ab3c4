"""Publish CLI (tools/model_converters/publish_model.py analog;
``transcar_tpu/cli/publish_model.py``): strip the optimizer state from a
training checkpoint and save the model's ``state_dict`` alone as
``<out_prefix>-<8 hex>``, the hex a SHA-256 of the tensors' bytes in
``state_dict`` order.  Host only: it reads the step dir on the CPU.

Usage:
    python -m transcar_tpu_torch.cli.publish_model <work_dir> <out_prefix>
        [--step N]

The published file loads wherever a checkpoint does (``cli.test``,
``--load-from``, ``cli.parity_check --checkpoint``).
"""
from __future__ import annotations

import argparse
import hashlib
import os

import torch


def state_digest(state_dict) -> str:
    """SHA-256 hex of every tensor's bytes, in ``state_dict`` order."""
    digest = hashlib.sha256()
    for t in state_dict.values():
        t = t.detach().cpu().contiguous().reshape(-1)
        digest.update(t.view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("work_dir", help="training work dir with checkpoints/")
    ap.add_argument("out_prefix", help="output path prefix")
    ap.add_argument("--step", type=int)
    args = ap.parse_args(argv)

    from transcar_tpu_torch.train import checkpoint as ckpt

    ckpt_dir = os.path.abspath(os.path.join(args.work_dir, "checkpoints"))
    steps = ckpt._steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    step = args.step if args.step is not None else steps[-1]
    params = ckpt.load_params_only(os.path.join(ckpt_dir, str(step)))
    out = f"{args.out_prefix}-{state_digest(params)[:8]}"
    ckpt.save_params_only(out, params)
    print(f"published params-only checkpoint: {out}")
    return out


if __name__ == "__main__":
    main()
