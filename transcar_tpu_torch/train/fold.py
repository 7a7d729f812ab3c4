"""Frozen-BN folds on the port's ``state_dict`` (``transcar_tpu/train/
fold.py``; reference tools/misc/fuse_conv_bn.py).

The ``state_dict`` keys follow the flax tree, so the JAX package's two
patterns read:

  * ConvBN: ``<p>.conv.weight`` with the FrozenBN ``<p>.bn.*``;
  * DCN:    ``<p>.conv2.weight`` with the FrozenBN ``<p>.bn2.*``;

with the output channels on dim 0 (the JAX kernel's last axis).  A
FrozenBN keeps ``weight``, ``bias``, ``running_mean`` and ``running_var``
as buffers, as the LiDAR track's trainable BatchNorm does with its
statistics, so the caller names the FrozenBN modules
(:func:`frozen_bn_names`); the trainable ones are left alone, as in JAX.

Loading a folded ``state_dict`` copies into the parameters in place,
which bumps their versions, so the kernels' K-major weight caches
(``models/common.cached_copy``) rebuild at the next forward.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch import nn

from transcar_tpu_torch.models.common import FrozenBN


def frozen_bn_names(model: nn.Module) -> set:
    """Names of ``model``'s FrozenBN modules (the ``state_dict`` prefixes
    the folds may rewrite)."""
    return {n for n, m in model.named_modules() if isinstance(m, FrozenBN)}


def _stats(sd, bn: str):
    return [sd[f"{bn}.{k}"].double()
            for k in ("weight", "bias", "running_mean", "running_var")]


def _neutral(like: torch.Tensor, bias: torch.Tensor, eps: float):
    """A FrozenBN that is a pure bias add (mean 0, var 1 − eps)."""
    return {"weight": torch.ones_like(like, dtype=torch.float32),
            "bias": bias.float(),
            "running_mean": torch.zeros_like(like, dtype=torch.float32),
            "running_var": (torch.ones_like(like, dtype=torch.float64)
                            - eps).float()}


def fold_frozen_bn(state_dict: Dict[str, torch.Tensor],
                   frozen: Iterable[str],
                   eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Every FrozenBN in ``frozen`` rewritten to its precomputed affine:
    weight' = γ/√(var+eps), bias' = β − mean·γ/√(var+eps), mean 0,
    var 1 − eps (computed in float64, stored in float32)."""
    out = dict(state_dict)
    for bn in frozen:
        gamma, beta, mean, var = _stats(state_dict, bn)
        s = gamma / torch.sqrt(var + eps)
        new = _neutral(s, beta - mean * s, eps)
        new["weight"] = s.float()
        out.update({f"{bn}.{k}": v for k, v in new.items()})
    return out


def fold_bn_into_conv(state_dict: Dict[str, torch.Tensor],
                      frozen: Iterable[str],
                      eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """True conv-BN fusion (tools/misc/fuse_conv_bn.py:10-24 semantics):
    each FrozenBN scale γ/√(var+eps) multiplied into the output channels
    of the conv before it, the BN left as a pure bias add.  It moves
    where the multiply happens, so a bfloat16 backbone rounds slightly
    differently; ``evaluate`` folds by default and ``fold_bn=False``
    keeps the unfolded numbers."""
    out = dict(state_dict)
    for bn in frozen:
        parent, _, leaf = bn.rpartition(".")
        conv = {"bn": "conv", "bn2": "conv2"}.get(leaf)
        key = f"{parent}.{conv}.weight" if parent else f"{conv}.weight"
        if conv is None or key not in state_dict:
            continue
        gamma, beta, mean, var = _stats(state_dict, bn)
        s = gamma / torch.sqrt(var + eps)
        w = state_dict[key]
        shape = (-1,) + (1,) * (w.ndim - 1)
        out[key] = (w.double() * s.view(shape)).to(w.dtype)
        out.update({f"{bn}.{k}": v for k, v in
                    _neutral(s, beta - mean * s, eps).items()})
    return out
