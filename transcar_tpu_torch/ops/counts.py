"""Operation counts of the kernels' work, by shape.

One place for the work each kernel does, whatever implements it: the
flop formulas of the registered ops (``torch.utils.flop_counter``, read by
``cli/get_flops.py``) and the bounds ``chip_smoke.py`` prints beside each
kernel's time both read these, so a FLOP count and a bound cannot drift
apart.  An operation is a multiply or an add (a multiply-add is two).
The int8 quantize passes and the Hungarian matching do no product: they
are counted in the bytes they must move, and have no flop formula.
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


def osa_block(n: int, h: int, w: int, c0: int, ch: int, n_convs: int,
              cout: int) -> float:
    """K5: the chain's ``n_convs`` 3×3 convs (C0 → Ch, then Ch → Ch) and
    the K4 reduce of the C0 + n_convs·Ch concatenation → Cout, at each of
    N·H·W pixels (affines, ReLUs and channel sums not counted)."""
    chain = 9 * (c0 * ch + (n_convs - 1) * ch * ch)
    return 2.0 * n * h * w * (chain + (c0 + n_convs * ch) * cout)


def bottleneck(n: int, h: int, w: int, cin: int, cm: int, cout: int,
               downsample: bool) -> float:
    """K6: conv1 (1×1, Cin → Cm), conv2 (3×3, Cm → Cm), conv3 (1×1, Cm →
    Cout) and, with ``downsample``, the 1×1 Cin → Cout of the identity, at
    each of N·H·W pixels (affines, ReLUs and the residual add not
    counted)."""
    macs = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if downsample
                                                  else 0)
    return 2.0 * n * h * w * macs


def int8_conv(n: int, ho: int, wo: int, cin: int, cout: int, kh: int,
              kw: int) -> float:
    """The int8 conv: the kh·kw·Cin → Cout product at each of N·Ho·Wo
    output pixels, as a float conv of the same shape counts it (Cin is the
    weight's, not a stem's 4 code channels; the dequantize and epilogue
    are not counted)."""
    return 2.0 * (n * ho * wo) * cout * (kh * kw * cin)


def int8_amax_bytes(numel: int, itemsize: int) -> int:
    """Bytes the amax pass must move: the activation read once and its
    float32 max written."""
    return itemsize * numel + 4


def int8_codes_bytes(numel: int, itemsize: int) -> int:
    """Bytes the codes pass must move: the activation read once, a code
    byte written an element (a stem's zero codes past its Cin not
    counted), the amax read and the scale written."""
    return (itemsize + 1) * numel + 8


def hungarian_bytes(q: int, g: int, num_gt: Sequence[int]) -> int:
    """Bytes the matching must move for problems of Q queries and G gt
    slots with these gt counts: the solved rows of the float32 cost read
    once (Q a gt below its problem's count, as this run's data needs), the
    int32 counts, and the int64 matches and bool validity written."""
    solved = sum(min(max(int(n), 0), g) for n in num_gt)
    return 4 * q * solved + len(num_gt) * (4 + 9 * g)


def hungarian_operations(q: int, scans: int) -> float:
    """Operations of the matching's Dijkstra scans: each scan's reduced
    cost of a column, three float32 adds, over the Q columns (the scans a
    run took, which its data decides)."""
    return 3.0 * q * scans
