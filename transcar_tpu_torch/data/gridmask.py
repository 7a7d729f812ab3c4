"""GridMask augmentation (``transcar_tpu/data/gridmask.py``; reference
projects/mmdet3d_plugin/models/utils/grid_mask.py:84-123 with the
detector's settings, detr3d.py:36: use_h = use_w = True, rotate = 1,
offset = False, ratio = 0.5, mode = 1, prob = 0.7).

``rotate=1`` draws ``randint(1) == 0``, so rotation never happens; mode 1
inverts the mask, so the stripes survive and about 1 − (1 − ratio)² of the
image is kept; one mask covers the whole 6-camera stack.  The random
draws come from an explicit ``torch.Generator``; the stripes are built on
the images' device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def grid_mask(images: torch.Tensor, generator: torch.Generator,
              prob: float = 0.7, ratio: float = 0.5) -> torch.Tensor:
    """Apply one GridMask to a stack of images [..., H, W, C].

    Draws, in order, whether to apply (probability ``prob``), the period
    d ~ randint(2, H) (grid_mask.py:91) and the row and column starts
    st_h, st_w < d, all from ``generator`` (a CPU generator).
    """
    h, w = images.shape[-3], images.shape[-2]
    apply = torch.rand((), generator=generator).item() <= prob
    d = int(torch.randint(2, h, (), generator=generator))
    st_h = int(torch.randint(0, 1 << 30, (), generator=generator)) % d
    st_w = int(torch.randint(0, 1 << 30, (), generator=generator)) % d
    if not apply:
        return images
    row, col = stripe_pattern(h, w, d, st_h, st_w, ratio, images.device)
    keep = row[:, None] | col[None, :]            # mode 1: 1 − mask
    return images * keep.to(images.dtype)[..., None]


def stripe_pattern(h: int, w: int, d: int, st_h: int, st_w: int,
                   ratio: float = 0.5, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Striped rows [h] and columns [w] (bool) of the reference's loop
    (grid_mask.py:93-111): position g of the centre-cropped window of the
    1.5× canvas is striped iff g ∈ [d·i + st, d·i + st + l) for some
    0 ≤ i < canvas // d, with l = min(max(int(d·ratio + 0.5), 1), d − 1)."""
    length = min(max(int(d * ratio + 0.5), 1), d - 1)

    def striped(size, canvas, st):
        g = torch.arange(size, device=device) + (canvas - size) // 2
        kk = g - st
        return (kk >= 0) & (kk % d < length) & (kk // d < canvas // d)

    return striped(h, int(1.5 * h), st_h), striped(w, int(1.5 * w), st_w)
