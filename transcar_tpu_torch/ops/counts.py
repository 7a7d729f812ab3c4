"""Operation counts of the serving kernels' work, by shape.

One place for the work each kernel does, whatever implements it: the
flop formulas of the registered ops (``torch.utils.flop_counter``, read by
``cli/get_flops.py``) and the bounds ``chip_smoke.py`` prints beside each
kernel's time both read these, so a FLOP count and a bound cannot drift
apart.  An operation is a multiply or an add (a multiply-add is two).
"""
from __future__ import annotations

from typing import Sequence


def dcn_forward(n: int, h: int, w: int, cin: int, cout: int) -> float:
    """K1: the 9·Cin → Cout product at each of N·H·W pixels (the bilinear
    gather is not counted)."""
    return 2.0 * n * h * w * 9 * cin * cout


def dcn_backward(n: int, h: int, w: int, cin: int, cout: int) -> float:
    """K3: d_samp = d_out × W9ᵀ and d_W = sampledᵀ × d_out, each as large
    as the forward's product."""
    return 2.0 * dcn_forward(n, h, w, cin, cout)


def masked_attention(b: int, heads: int, q: int, t: int,
                     head_dim: int) -> float:
    """K2: S = QKᵀ and P·V over every (query, token) pair of each
    (batch, head), whatever the mask keeps (the softmax is not
    counted)."""
    return 4.0 * b * heads * q * t * head_dim


def osa_reduce(n: int, h: int, w: int, widths: Sequence[int],
               cout: int) -> float:
    """K4: the ΣCᵢ → Cout 1×1 product at each of N·H·W pixels (the affine,
    ReLU and channel sums are not counted)."""
    return 2.0 * n * h * w * sum(widths) * cout


def msdeform_forward(samples: int, head_dim: int) -> float:
    """K7: per (query, head, level, point) sample and channel, the four
    bilinear taps and the attention weight, a multiply-add each;
    ``samples`` is B·Q·H·L·P (the attention weights' element count)."""
    return 10.0 * head_dim * samples
