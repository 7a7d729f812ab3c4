"""K7's and K9's lane-group layout walked on the CPU.

The lane-group kernels of ``csrc/msdeform_forward.cu`` (K7) and
``csrc/msdeform_backward.cu`` (K9) give one (batch, query, head) to a
group of G lanes; lane j holds the ``float4`` chunks k < V of channels
4(k·G + j) … 4(k·G + j) + 3, G the least power of two with 4·G·V ≥ D (K7
V = 2, 4 lanes at D = 32; K9 V = 1, 8 lanes).  K7 walks the query's
samples level-major, adds a·Σ w_corner·v_corner into each lane's 8
accumulators and stores the chunks; K9 adds (g·a)·w_corner into each
corner row on the map, one ``float4`` a lane.  These tests
walk that layout in torch, with the kernels' corner arithmetic, and hold
it to the port's plain versions and to the JAX package's exact
``ms_deform_attn_core`` (and its ``jax.vjp`` for d_value) on the same
numpy inputs, float32, within 1e-5 of max|reference| (the walk sums in
another order than both).
"""
import jax
import numpy as np
import pytest
import torch

from transcar_tpu.ops.msdeform import ms_deform_attn_core as jax_core
from transcar_tpu_torch.ops.msdeform import (level_starts,
                                             ms_deform_attn_backward,
                                             ms_deform_attn_core)

SHAPES = [(5, 6), (3, 4)]
TOL = 1e-5
# the JAX reference, jitted: one compile a shape, where op-by-op dispatch
# compiles every primitive
_jax_forward = jax.jit(lambda v, l, w: jax_core(v, SHAPES, l, w))
_jax_d_value = jax.jit(lambda v, l, w, g: jax.vjp(
    lambda v: jax_core(v, SHAPES, l, w), v)[1](g)[0])


def _group(d, v):
    """G of a lane-group kernel with V float4 chunks a lane for head dim
    D: the least power of two with 4·G·V ≥ D (K7: V = 2; K9: V = 1)."""
    assert d % 8 == 0 and d <= 64
    return next(g for g in (1, 2, 4, 8, 16) if 4 * g * v >= d)


def _chunks(d, v):
    """[(lane j, chunk k, first channel)] of one group, chunks past D out."""
    g = _group(d, v)
    return [(j, k, 4 * (k * g + j)) for j in range(g) for k in range(v)
            if 4 * (k * g + j) < d]


def _corners(uv, hl, wl):
    """The kernels' corners(): fractions, the four corners' validity and
    tokens within the level, from clamped indices (float32, one multiply
    then one subtract, as the plain version rounds)."""
    x = uv[..., 0] * np.float32(wl) - np.float32(0.5)
    y = uv[..., 1] * np.float32(hl) - np.float32(0.5)
    finite = torch.isfinite(x) & torch.isfinite(y)
    x, y = torch.where(finite, x, 0.0), torch.where(finite, y, 0.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    vx = (x0 >= 0) & (x0 <= wl - 1), (x0 >= -1) & (x0 <= wl - 2)
    vy = (y0 >= 0) & (y0 <= hl - 1), (y0 >= -1) & (y0 <= hl - 2)
    ix = torch.clamp(x0, -1, wl).long()
    iy = torch.clamp(y0, -1, hl).long()
    tok = iy * wl + ix
    out = []
    for cy, cx, w in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                      (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
        out.append((vy[cy] & vx[cx] & finite, tok + cy * wl + cx, w))
    return finite, out


def _walk(loc):
    """The level-major sample walk of one group: (level, point, its
    start, height, width) for each of the L·P samples in order."""
    p = loc.shape[4]
    for si in range(len(SHAPES) * p):
        l = si // p
        yield l, si - l * p, level_starts(SHAPES)[l], *SHAPES[l]


def group_forward(value, loc, wgt):
    """K7's lane-group walk: out [B, Q, H·D]."""
    b, s, h, d = value.shape
    q = loc.shape[1]
    out = torch.full((b, q, h, d), float("-inf"))      # every channel stored
    bi = torch.arange(b)[:, None, None]
    hi = torch.arange(h)[None, None, :]
    for j, k, ch in _chunks(d, 2):
        acc = torch.zeros(b, q, h, 4)                   # the lane's chunk k
        for l, pt, start, hl, wl in _walk(loc):
            a = wgt[:, :, :, l, pt]
            finite, corners = _corners(loc[:, :, :, l, pt], hl, wl)
            smp = torch.zeros(b, q, h, 4)
            for valid, tok, w in corners:
                rows = value[bi, start + tok.clamp(0, hl * wl - 1), hi,
                             ch:ch + 4]                  # one float4 load
                smp = smp + torch.where(valid[..., None], rows, 0.0) * w[..., None]
            af = torch.where(finite, a, float("nan"))
            acc = acc + af[..., None] * smp
        out[..., ch:ch + 4] = acc
    return out.reshape(b, q, h * d)


def group_backward_value(value, loc, wgt, d_out):
    """K9's lane-group scatter: d_value [B, S, H, D]."""
    b, s, h, d = value.shape
    q = loc.shape[1]
    g = d_out.reshape(b, q, h, d)
    d_value = torch.zeros(b * s * h, d)
    bi = torch.arange(b)[:, None, None]
    hi = torch.arange(h)[None, None, :]
    for j, k, ch in _chunks(d, 1):
        gk = g[..., ch:ch + 4]                          # read once
        for l, pt, start, hl, wl in _walk(loc):
            a = wgt[:, :, :, l, pt]
            _, corners = _corners(loc[:, :, :, l, pt], hl, wl)
            ga = gk * a[..., None]
            for valid, tok, w in corners:
                row = ((bi * s + start + tok) * h + hi)[valid]
                add = (ga * w[..., None])[valid]         # one float4 add
                cols = d_value[:, ch:ch + 4]
                d_value[:, ch:ch + 4] = cols.index_add(0, row, add)
    return d_value.reshape(b, s, h, d)


def _case(seed, heads, d, q=11, p=3):
    rng = np.random.default_rng(seed)
    s = sum(hl * wl for hl, wl in SHAPES)
    value = rng.normal(size=(1, s, heads, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(1, q, heads, len(SHAPES), p, 2)
                      ).astype(np.float32)
    loc[0, 1, 0, 0, 0] = (2.0 + 0.5 / 6, 0.5)          # whole-cell, off right
    loc[0, 2, 0, 1, 1] = (0.5 / 4, 1.5 / 3)             # on a cell centre
    loc[0, 3, -1, 0, 2] = (1e20, 0.5)                   # far off
    wgt = rng.normal(size=(1, q, heads, len(SHAPES) * p))
    wgt = np.exp(wgt) / np.exp(wgt).sum(-1, keepdims=True)
    wgt = wgt.reshape(1, q, heads, len(SHAPES), p).astype(np.float32)
    d_out = rng.normal(size=(1, q, heads * d)).astype(np.float32)
    return value, loc, wgt, d_out


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("v", [2, 1])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 64])
def test_group_layout_covers_each_channel_once(d, v):
    """Each channel in one lane's chunk, no group wider than it needs."""
    chans = sorted(c + i for _, _, c in _chunks(d, v) for i in range(4))
    assert chans == list(range(d))
    assert len({j for j, _, _ in _chunks(d, v)}) > _group(d, v) // 2


@pytest.mark.parametrize("heads,d", [(2, 16), (3, 32)])
def test_group_forward_walk_matches_plain_and_jax(heads, d):
    value, loc, wgt, _ = _case(0, heads, d)
    t = [torch.from_numpy(x) for x in (value, loc, wgt)]
    got = group_forward(*t)
    assert torch.isfinite(got).all()
    _close(got, ms_deform_attn_core(t[0], SHAPES, t[1], t[2]))
    _close(got, _jax_forward(value, loc, wgt))


def test_group_forward_walk_non_finite_rows():
    value, loc, wgt, _ = _case(1, 2, 16)
    loc[0, 4, 1, 1, 0, 0] = np.nan
    loc[0, 6, 0, 0, 2, 1] = np.inf
    t = [torch.from_numpy(x) for x in (value, loc, wgt)]
    got = group_forward(*t)
    ref = ms_deform_attn_core(t[0], SHAPES, t[1], t[2])
    assert torch.equal(got.isnan(), ref.isnan()) and ref.isnan().sum() == 32
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("heads,d", [(2, 16), (3, 32)])
def test_group_value_scatter_matches_plain_and_jax(heads, d):
    value, loc, wgt, d_out = _case(2, heads, d)
    t = [torch.from_numpy(x) for x in (value, loc, wgt, d_out)]
    got = group_backward_value(*t)
    _close(got, ms_deform_attn_backward(t[0], SHAPES, t[1], t[2], t[3])[0])
    _close(got, _jax_d_value(value, loc, wgt, d_out))
