"""Hungarian matching of ground truth to queries, solved on the host
(``transcar_tpu/ops/hungarian.py``).

The reference solves each [900, num_gt] cost matrix on the CPU with
scipy's ``linear_sum_assignment`` (hungarian_assigner_3d.py:108-125); so
does the port.  The JAX package's on-device shortest-augmenting-path
solver is a TPU formulation and is not ported.  All L·B problems of a
step cross to the host in ONE device-to-host copy and their matches come
back in ONE host-to-device copy, not one round trip per decoder layer.

Semantics kept from the JAX solver: non-finite costs become ±1e7 (NaN →
+1e7) and every cost is clipped to ±1e7, so exploded predictions cannot
break the solve (scipy raises on non-finite entries); only the first
``num_gt`` columns of a problem are solved; padded gt slots carry the
out-of-range sentinel Q, which the target scatters drop.  Tied costs may
match other queries than the JAX solver does; the matched total cost is
the same optimum.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

BIG_M = 1e7


def sanitize_cost(cost: np.ndarray) -> np.ndarray:
    """NaN → +1e7, ±inf → ±1e7, then clip to ±1e7 (float32)."""
    cost = np.nan_to_num(cost.astype(np.float32), nan=BIG_M, posinf=BIG_M,
                         neginf=-BIG_M)
    return np.clip(cost, -BIG_M, BIG_M)


def hungarian_match(cost_qg: torch.Tensor, num_gt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost assignment of gts to queries for a batch of problems.

    Args:
      cost_qg: [P, Q, G] costs (rows: queries, cols: gt slots), any device.
      num_gt: [P] real gt counts (≤ G), any device.
    Returns:
      (matched [P, G] int64 query per gt slot, Q at padded slots;
       valid [P, G] bool, slot < num_gt), both on ``cost_qg``'s device.
    """
    p, q, g = cost_qg.shape
    cost = sanitize_cost(cost_qg.detach().cpu().numpy())       # one copy
    counts = torch.as_tensor(num_gt).cpu().numpy().astype(np.int64)
    counts = counts.reshape(p)
    matched = np.full((p, g), q, np.int64)
    for i, n in enumerate(counts):
        if n > 0:
            rows, cols = linear_sum_assignment(cost[i, :, :n])
            matched[i, cols] = rows
    valid = np.arange(g)[None, :] < counts[:, None]
    both = torch.from_numpy(np.concatenate([matched, valid], axis=1))
    both = both.to(cost_qg.device)                              # one copy
    return both[:, :g], both[:, g:].bool()
