"""Weight bridge: the JAX package's flax parameter tree → this package's
``state_dict``.

The port's submodules are named after the flax tree
(``backbone.layer3_0.conv2.conv_offset``, ``head.fusion0_attn.wq``, ...),
so the bridge is a generic walk with two layout rules and four leaf
renames:

  * a 4-D leaf (conv ``kernel``, DCN ``weight``) [kh, kw, I, O] →
    [O, I, kh, kw];
  * a 2-D ``kernel`` (Dense) [I, O] → ``weight`` [O, I];
  * ``kernel`` and ``scale`` (LayerNorm, FrozenBN) → ``weight``; FrozenBN
    ``mean`` / ``var`` → ``running_mean`` / ``running_var``;
  * everything else passes unchanged (biases, ``query_embedding``, and
    the attention ``wq … bo``, which keep the JAX [in, out] layout).

Published reference ``.pth`` checkpoints reach the port through
``transcar_tpu.train.convert.convert_detr3d_checkpoint`` and then this
function.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of arrays, with or without the
    top-level ``"params"``) → ``state_dict`` for ``load_state_dict``:
    float32, or float64 where a leaf is float64."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + key + ".")
                continue
            arr = np.asarray(val)
            arr = arr.astype(np.promote_types(arr.dtype, np.float32))
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2 and key == "kernel":
                arr = arr.T
            out[prefix + _RENAME.get(key, key)] = torch.tensor(arr)

    walk(params, "")
    return out
