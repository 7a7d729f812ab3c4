"""K2's tensor-core layout walked on the CPU.

``csrc/masked_attention.cu`` gives a warpgroup 64 query rows (16 a warp)
of one (batch, head) and every fourth 32-token chunk (four warpgroups of
tokens per block, merged at the end).  Both products run on ``wgmma``
m64n32k8 TF32 in three products of split operands (x = hi + lo, hi =
tf32_rna(x), lo = tf32_rna(x - hi); a·b ≈ lo_a·hi_b + hi_a·lo_b +
hi_a·hi_b): S = Q·Kᵀ from K-major tiles in shared memory (Q pre-scaled by
scale·log2(e); K with token 4n + j at row 8j + n), P·V with P from
registers and V^T's tile with token 8t + 4h + j at column 8j + 4h + t and
head dim 8(n / 2) + 2n' + n % 2 at row 8n' + n.  The softmax is online,
in exp2.  S's accumulator is P·V's A fragment as it stands, with the
tokens of each k-step relabelled.  Each chunk's P·V sums into its own
accumulator, added to the running output in float32.

These tests walk that layout in torch, warp by warp (a warpgroup's
product is its four warps' 16-row slices): each register fragment is
built lane by lane from the kernel's register maps (which row, token and
dim a lane's register holds) into the positions the PTX ISA gives that
register, each operand tile is built with the kernel's row and column
maps, each product is a matrix product of those, and the accumulators
are read back through the kernel's maps.  A map that disagrees with
another puts a value in the wrong place and the walk misses the
references: the port's ``attention_core`` and the JAX package's
``multihead_attention`` under ``jax.jit`` (identity projections),
float32, within 1e-5 of max|reference|.  A one-pass TF32 walk misses
that tolerance, so the tests can tell the split from a single product.
"""
import jax
import numpy as np
import pytest
import torch

from transcar_tpu.ops.attention import multihead_attention as jax_mha
from transcar_tpu_torch.ops import pallas_attention
from transcar_tpu_torch.ops.attention import (NEG_INF, attention_core,
                                              split_heads)

HD = 32
TW, CT = 4, 32                  # token warpgroups of a block; chunk tokens
TOL = 1e-5
KNEG = np.float32(NEG_INF)
QSCALE = np.float32(np.float32(1 / np.sqrt(HD)) * np.float32(1.4426950408889634))


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 stored mantissa bits, ties away from
    zero (add half a unit to the magnitude bits, then truncate)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def mma(d, a, b, split=True):
    """d + a·b as the kernel's three products (small ones first) of split
    operands; ``b`` holds tiles already split by ``split_tile``."""
    ah = tf32(a)
    bh, bl = b
    if split:
        d = d + tf32(a - ah) @ bh
        d = d + ah @ bl
    return d + ah @ bh


def split_tile(x, split=True):
    hi = tf32(x)
    return hi, (tf32(x - hi) if split else torch.zeros_like(x))


# PTX ISA positions of a lane's registers (g = lane // 4, t = lane % 4) in
# a warp's 16 rows: A 16x8 (k8 TF32), an 8-column group of C/D.
def a_pos(g, t):
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def c_pos(g, t):
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


# The kernel's register maps: what each register holds.
def s_acc(j, g, t):             # (row, token): the lane's keep bytes j, 4 + j
    return [(g, 8 * t + j), (g, 8 * t + 4 + j),
            (g + 8, 8 * t + j), (g + 8, 8 * t + 4 + j)]


P_FROM_S = (0, 2, 1, 3)         # P.V's A register i is S's accumulator P_FROM_S[i]


def o_acc(n, g, t):             # (row, dim): the lane's dims 8t .. 8t+7
    return [(g, 8 * t + 2 * n), (g, 8 * t + 2 * n + 1),
            (g + 8, 8 * t + 2 * n), (g + 8, 8 * t + 2 * n + 1)]


# The kernel's tile maps (split_chunk): where a token or dim goes.
def k_row(tau):                 # K tile row of token tau
    return 8 * (tau & 3) + (tau >> 2)


def vt_col(tau):                # V^T tile column of token tau
    return 8 * (tau & 3) + 4 * ((tau >> 2) & 1) + (tau >> 3)


def vt_row(d):                  # V^T tile row of head dim d
    return 8 * ((d >> 1) & 3) + 2 * (d >> 3) + (d & 1)


def _lanes():
    return [(lane // 4, lane % 4) for lane in range(32)]


def _fragment(shape, pos, reg):
    """Index tensors (two, of ``shape``) placing the registers of every
    lane: entry [isa position] = the kernel's (first, second) index."""
    i0 = torch.full(shape, -1, dtype=torch.long)
    i1 = torch.full(shape, -1, dtype=torch.long)
    for g, t in _lanes():
        for p, r in zip(pos(g, t), reg(g, t)):
            assert i0[p] == -1, "two registers at one ISA position"
            i0[p], i1[p] = r
    assert (i0 >= 0).all(), "an ISA position no register fills"
    return i0, i1


def _groups(acc):               # the 8-column groups' maps side by side
    def pos(g, t):
        return [(r, 8 * n + c) for n in range(len(acc))
                for r, c in c_pos(g, t)]

    def reg(g, t):
        return [x for a in acc for x in a(g, t)]
    return pos, reg


C_S = [_fragment((16, 8), c_pos, lambda g, t, j=j: s_acc(j, g, t))
       for j in range(4)]
C_O = _fragment((16, 32), *_groups([lambda g, t, n=n: o_acc(n, g, t)
                                    for n in range(4)]))


def _p_fragment(p_isa):
    """P.V's A fragment from S's accumulator fragment [..., 16, 8], lane by
    lane: A register i takes accumulator register P_FROM_S[i]."""
    a = torch.empty_like(p_isa)
    for g, t in _lanes():
        cs = c_pos(g, t)
        for i, ap in enumerate(a_pos(g, t)):
            a[..., ap[0], ap[1]] = p_isa[..., cs[P_FROM_S[i]][0],
                                         cs[P_FROM_S[i]][1]]
    return a


def _tiles(kt, vt, split):
    """A warpgroup's operand tiles of a chunk: K [32 rows][32 dims] and
    V^T [32 rows][32 columns], each as (hi, lo)."""
    tau, dims = torch.arange(CT), torch.arange(HD)
    ktile = torch.empty_like(kt)
    ktile[..., k_row(tau), :] = kt
    vtile = torch.empty(*vt.shape[:-2], HD, CT)
    vtile[..., vt_row(dims)[:, None], vt_col(tau)[None, :]] = vt.transpose(-1, -2)
    return split_tile(ktile, split), split_tile(vtile, split)


def walk(q, k, v, keep, split=True):
    """K2's walk: q [B, H, Q, 32], k / v [B, H, T, 32] float32, keep bool
    [B, Q, T] → [B, H, Q, 32]."""
    b, h, nq, _ = q.shape
    nt = k.shape[2]
    groups, n_chunks = -(-nq // 16), -(-nt // CT)
    qp = torch.zeros(b, h, groups * 16, HD)
    qp[:, :, :nq] = q * QSCALE
    qp = qp.reshape(b, h, groups, 16, HD)     # A: Q's tile, dims in order
    kp = torch.zeros(b, h, n_chunks * CT, HD)
    vp = torch.zeros_like(kp)
    kp[:, :, :nt], vp[:, :, :nt] = k, v
    kq = torch.zeros(b, groups * 16, n_chunks * CT, dtype=torch.bool)
    kq[:, :nq, :nt] = keep
    kq = kq.reshape(b, 1, groups, 16, n_chunks * CT)
    states = []
    for th in range(TW):
        m = torch.full((b, h, groups, 16), -torch.inf)
        l = torch.zeros(b, h, groups, 16)
        o = torch.zeros(b, h, groups, 16, 32)
        for ci in range(th, n_chunks, TW):   # the warpgroup's chunks
            tok_w = ci * CT
            ktile, vtile = _tiles(kp[:, :, None, tok_w:tok_w + CT],
                                  vp[:, :, None, tok_w:tok_w + CT], split)
            logit = torch.empty(b, h, groups, 16, CT)
            for j in range(4):               # S's 8-column group j
                acc = torch.zeros(b, h, groups, 16, 8)
                for kk in range(4):          # B[k][n] = K row 8j+n, dim 8kk+k
                    bt = [x[..., 8 * j:8 * j + 8, 8 * kk:8 * kk + 8]
                          .transpose(-1, -2) for x in ktile]
                    acc = mma(acc, qp[..., 8 * kk:8 * kk + 8], bt, split)
                rows, toks = C_S[j]
                logit[..., rows, toks] = acc
            tok = torch.arange(CT) + tok_w
            x = torch.where(kq[..., tok_w:tok_w + CT], logit, KNEG)
            x = torch.where(tok < nt, x, -torch.inf)
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mn)
            m = mn
            p = torch.exp2(x - m[..., None])
            l = l * alpha + p.sum(-1)
            os = torch.zeros_like(o)         # the chunk's own sums
            for j in range(4):               # B[k][n] = V^T row n, column 8j+k
                rows, toks = C_S[j]
                a_p = _p_fragment(p[..., rows, toks])
                bt = [x[..., :, 8 * j:8 * j + 8].transpose(-1, -2)
                      for x in vtile]
                os = mma(os, a_p, bt, split)
            o = o * alpha[..., None] + os
        out = torch.empty(b, h, groups, 16, HD)
        rows, dims = C_O
        out[..., rows, dims] = o
        states.append((m, l, out))
    (m, l, out), rest = states[0], states[1:]
    for mw, lw, ow in rest:                  # the token warpgroups' merge
        mn = torch.maximum(m, mw)
        f, fw = torch.exp2(m - mn), torch.exp2(mw - mn)
        l = l * f + lw * fw
        out = out * f[..., None] + ow * fw[..., None]
        m = mn
    out = out / l[..., None]
    return out.reshape(b, h, groups * 16, HD)[:, :, :nq]


def _case(seed, b, heads, nq, nt, density=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, heads, n, HD)).astype(np.float32)
               for n in (nq, nt, nt))
    keep = rng.uniform(size=(b, nq, nt)) < density
    keep[:, 0] = True                       # a fully-visible row
    keep[:, -1] = False                     # a fully-masked row
    return q, k, v, keep


def _jax_core(q, k, v, keep):
    """The JAX package's multihead_attention with identity projections."""
    b, heads, nq, _ = q.shape
    e = heads * HD
    eye = np.eye(e, dtype=np.float32)
    params = {n: eye for n in ("wq", "wk", "wv", "wo")}
    params.update({n: np.zeros(e, np.float32) for n in ("bq", "bk", "bv", "bo")})
    merge = lambda x: x.transpose(0, 2, 1, 3).reshape(b, x.shape[2], e)
    out = jax.jit(lambda q, k, v, m: jax_mha(q, k, v, params, heads, mask=m))(
        merge(q), merge(k), merge(v), ~keep)
    return np.asarray(out).reshape(b, nq, heads, HD).transpose(0, 2, 1, 3)


def _err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("b,heads,nq,nt", [
    (2, 2, 37, 150),        # ragged Q and T: a short last chunk
    (1, 2, 16, 1),          # T = 1: one token, three token warpgroups idle
    (1, 1, 21, 300),        # ten chunks, uneven over the warpgroups
])
def test_walk_matches_plain_and_jax(b, heads, nq, nt):
    q, k, v, keep = _case(0, b, heads, nq, nt)
    t = [torch.from_numpy(x) for x in (q, k, v, keep)]
    got = walk(*t)
    assert torch.isfinite(got).all()
    plain = attention_core(t[0], t[1], t[2], ~t[3])
    assert _err(got, plain) <= TOL
    assert _err(got, _jax_core(q, k, v, keep)) <= TOL
    # the fully-masked row is the plain version's uniform average over T
    assert _err(got[:, :, -1], plain[:, :, -1]) <= TOL
    torch.testing.assert_close(got[:, :, -1], t[2].mean(2), rtol=0, atol=1e-5)


def test_one_pass_tf32_walk_misses_the_tolerance():
    q, k, v, keep = _case(1, 1, 2, 37, 150)
    t = [torch.from_numpy(x) for x in (q, k, v, keep)]
    plain = attention_core(t[0], t[1], t[2], ~t[3])
    one_pass = _err(walk(*t, split=False), plain)
    assert one_pass > 10 * TOL, one_pass
    assert _err(walk(*t), plain) <= TOL


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                        # TF32's unit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:4] == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert abs(got[4] - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert (tf32(x).view(torch.int32) & 0x1FFF == 0).all()


def test_masked_attention_on_cpu_takes_split_heads_views():
    rng = np.random.default_rng(2)
    qx, kx, vx = (torch.from_numpy(rng.normal(size=(2, n, 64)).astype(
        np.float32)) for n in (19, 40, 40))
    keep = torch.from_numpy(rng.uniform(size=(2, 19, 40)) < 0.4)
    qh, kh, vh = (split_heads(x, 2) for x in (qx, kx, vx))
    assert qh.stride() == (19 * 64, 32, 64, 1)            # views, not copies
    got = pallas_attention.masked_attention(qh, kh, vh, keep)
    ref = attention_core(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                         ~keep)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_kernel_strides_of_split_heads_views():
    x = torch.zeros(2, 30, 256)
    out = torch.zeros(2, 30, 8, 32).transpose(1, 2)
    assert pallas_attention.kernel_strides(split_heads(x, 8), out) == [
        30 * 256, 32, 256, 30 * 256, 32, 256]
    with pytest.raises(ValueError, match="unit stride"):
        pallas_attention.kernel_strides(split_heads(x, 8).transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        pallas_attention.kernel_strides(
            split_heads(torch.zeros(2, 30, 257)[..., 1:], 8))


@pytest.mark.parametrize("nt,width", [(1500, 1500), (150, 152), (1, 4)])
def test_keep_rows_pad_to_four_bytes(nt, width):
    keep = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 5, nt))
                            < 0.5)
    rows = pallas_attention.keep_rows(keep)
    assert rows.dtype == torch.uint8 and rows.shape == (2, 5, width)
    assert torch.equal(rows[..., :nt].bool(), keep)
    assert not rows[..., nt:].any()
    if width == nt:                                       # no pass, a view
        assert rows.data_ptr() == keep.data_ptr()
