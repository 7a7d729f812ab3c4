"""Feature Pyramid Network, mmdet ``FPN`` parity (``transcar_tpu/models/fpn.py``).

1×1 laterals from ``start_level``, nearest-neighbor top-down pathway, 3×3
output convs, and ``add_extra_convs='on_output'`` stride-2 extra levels;
the relu of ``relu_before_extra_convs`` applies only from the second extra
conv on (none at the flagship's one extra level).  NCHW.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.models.common import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Tuple[int, ...] = (256, 512, 1024, 2048),
                 out_channels: int = 256, start_level: int = 1,
                 num_outs: int = 4, add_extra_convs: str = "on_output",
                 relu_before_extra_convs: bool = True):
        super().__init__()
        if add_extra_convs != "on_output":
            raise NotImplementedError(
                f"add_extra_convs={add_extra_convs!r}: only 'on_output' "
                "(every preset's value) is ported")
        used = range(start_level, len(in_channels))
        self.start_level = start_level
        self.num_levels = len(used)
        self.num_extra = num_outs - self.num_levels
        self.relu_before_extra_convs = relu_before_extra_convs
        for rel, i in enumerate(used):
            setattr(self, f"lateral{rel}", Conv2d(in_channels[i],
                                                  out_channels, 1))
            setattr(self, f"fpn{rel}", Conv2d(out_channels, out_channels, 3,
                                              padding=1))
        for e in range(self.num_extra):
            setattr(self, f"extra{e}", Conv2d(out_channels, out_channels, 3,
                                              stride=2, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]):
        laterals = [getattr(self, f"lateral{rel}")(feats[self.start_level + rel])
                    for rel in range(self.num_levels)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _nearest_resize(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [getattr(self, f"fpn{i}")(lat) for i, lat in enumerate(laterals)]
        for e in range(self.num_extra):
            src = outs[-1]
            if e > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            outs.append(getattr(self, f"extra{e}")(src))
        return outs


def _nearest_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest upsample with torch ``F.interpolate(mode='nearest')``'s
    integer index arithmetic (src = floor(dst · in / out)), written out
    rather than trusting a float scale."""
    h, w = hw
    sh, sw = x.shape[-2:]
    ry = torch.arange(h, device=x.device) * sh // h
    rx = torch.arange(w, device=x.device) * sw // w
    return x.index_select(2, ry).index_select(3, rx)
