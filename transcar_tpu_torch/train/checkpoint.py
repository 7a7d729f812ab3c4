"""Checkpoints (``transcar_tpu/train/checkpoint.py``, which saves with
orbax).

``save_checkpoint`` writes ``<work_dir>/checkpoints/<step>/state.pt``
(``torch.save`` of the model's ``state_dict``, the optimizer's and the
schedule's, and the step) and ``config.json`` beside it, and keeps the
newest ``keep`` step dirs.  ``restore_checkpoint`` is the full-state
resume; ``load_params_only`` the warm start and the eval CLI's load,
from a step dir or from a params-only file (``save_params_only``, the
``publish_model`` analog).  The ``state_dict`` holds the buffers too:
FrozenBN statistics, and the LiDAR track's BatchNorm running statistics
(the JAX ``batch_stats``), so a step dir restores those with the
parameters.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from transcar_tpu_torch.parallel.distributed import barrier, is_main

STATE_FILE = "state.pt"


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, d, STATE_FILE)))


def save_checkpoint(work_dir: str, state, config_dict=None,
                    keep: int = 5) -> str:
    """Save ``state`` (a ``train.step.TrainState``) at its step; returns
    the step dir.  The file is written under a temporary name and moved
    into place, so a step dir with a ``state.pt`` is always whole.  Under
    a process group rank 0 writes (every rank of a data-parallel run
    holds the same state) and every rank waits for it."""
    ckpt_dir = os.path.abspath(os.path.join(work_dir, "checkpoints"))
    path = os.path.join(ckpt_dir, str(int(state.step)))
    if is_main():
        _write(path, ckpt_dir, state, config_dict, keep)
    barrier()
    return path


def _write(path, ckpt_dir, state, config_dict, keep) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save({"step": int(state.step),
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if config_dict is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config_dict, f, indent=2)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def restore_checkpoint(work_dir: str, state,
                       step: Optional[int] = None) -> int:
    """Full-state resume (``--resume-from``): the newest step (or
    ``step``) of ``<work_dir>/checkpoints`` loaded into ``state``'s
    model, optimizer and schedule in place; returns the step.  Every rank
    of a process group restores."""
    ckpt_dir = os.path.abspath(os.path.join(work_dir, "checkpoints"))
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    step = steps[-1] if step is None else int(step)
    saved = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                       map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state.step


def save_params_only(path: str, model) -> None:
    """publish_model analog: the model's ``state_dict`` without the
    optimizer.  Name the file without a ``.pth`` / ``.pt`` suffix: as in
    the JAX package, ``train/loop._load_params`` reads those as reference
    checkpoints to convert."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)


def load_params_only(path: str, template: Optional[Dict] = None
                     ) -> Dict[str, torch.Tensor]:
    """Warm-start ``load_from`` analog.

    Accepts a params-only file (:func:`save_params_only`) or a training
    step dir (``.../checkpoints/N``, as the reference's tools/test.py
    takes a training checkpoint).  With ``template`` (a model's
    ``state_dict``) the loaded dict must match it key for key and shape
    for shape (a clear error instead of a late failure), and each tensor
    takes the template's dtype."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        sd = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                        weights_only=True)["model"]
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return sd
    missing = sorted(set(template) - set(sd))
    extra = sorted(set(sd) - set(template))
    bad_shape = sorted(k for k in template.keys() & sd.keys()
                       if tuple(template[k].shape) != tuple(sd[k].shape))
    if missing or extra or bad_shape:
        raise ValueError(
            f"checkpoint {path!r} does not match the model: "
            f"missing={missing[:5]} extra={extra[:5]} "
            f"shape-mismatch={bad_shape[:5]} "
            f"(counts: {len(missing)}/{len(extra)}/{len(bad_shape)})")
    return {k: sd[k].to(template[k].dtype) for k in template}
