"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without CUDA.  This file imports no JAX, so it runs on a
GPU host that has none:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged on purpose (pixel counts that are no
multiple of the 64-pixel tile, Cout below the 128-channel tile, query
and token counts off the 32 / 64 tiles); ``chip_smoke.py`` checks the
flagship shapes.
"""
import pytest
import torch

import chip_smoke
from transcar_tpu_torch.models.common import disable_tf32
from transcar_tpu_torch.ops import (dcn, hungarian, pallas_attention,
                                    pallas_bottleneck, pallas_dcn,
                                    pallas_msdeform, pallas_osa,
                                    pallas_osa_block)
from transcar_tpu_torch.ops.attention import (attention_core, merge_heads,
                                              split_heads)
from transcar_tpu_torch.ops.msdeform import (ms_deform_attn_backward,
                                             ms_deform_attn_core)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    disable_tf32()          # the plain versions' float32 GEMMs and convs
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_dcn_kernel(dev, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    n, h, w, cin, cout = 2, 7, 11, 64, 72
    x = torch.randn(n, h, w, cin, device=dev, generator=g)
    om = torch.randn(n, h, w, 27, device=dev, generator=g)
    om[..., :18] = torch.rand(n, h, w, 18, device=dev, generator=g) * 16 - 8
    wt = torch.randn(3, 3, cin, cout, device=dev, generator=g) * 0.05
    args = [a.to(dtype) for a in (x, om, wt)]
    before = pallas_dcn.launches
    out = pallas_dcn.fused_deform_conv(*args).float()
    ref = dcn.modulated_deform_conv(*args).float()
    assert pallas_dcn.launches == before + 1
    assert (out - ref).abs().max() <= tol * ref.abs().max()


def test_dcn_kernel_rejects_unsupported_shapes(dev):
    x = torch.zeros(1, 4, 4, 24, device=dev)       # Cin % 32 != 0
    with pytest.raises(ValueError, match="Cin % 32"):
        pallas_dcn.fused_deform_conv(x, torch.zeros(1, 4, 4, 27, device=dev),
                                     torch.zeros(3, 3, 24, 8, device=dev))


# a bfloat16 call the Hopper tile does not take raises: no other tile
@pytest.mark.parametrize("cin,cout", [(12, 8), (16, 12)])
def test_dcn_bfloat16_raises_off_the_wgmma_tile(dev, cin, cout):
    x = torch.zeros(1, 4, 4, cin, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Cin % 8 == 0 and Cout % 8 == 0"):
        pallas_dcn.fused_deform_conv(
            x, torch.zeros(1, 4, 4, 27, device=dev, dtype=torch.bfloat16),
            torch.zeros(3, 3, cin, cout, device=dev))


def _dcn_fwd_case(dev, n, h, w, cin, cout, offsets):
    """bfloat16 K1 inputs: offsets over ±8 px ("pm8"), ±40 px ("far": most
    taps land outside the image), 0 ("zero"), whole pixels in [-3, 3]
    ("integer") or N(0, 2 px) ("model", the benchmark's scale)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n, h, w, cin, device=dev, generator=g)
    om = torch.randn(n, h, w, 27, device=dev, generator=g)
    u = torch.rand(n, h, w, 18, device=dev, generator=g)
    om[..., :18] = {"pm8": u * 16 - 8, "far": u * 80 - 40, "zero": u * 0,
                    "integer": (u * 7).floor() - 3,
                    "model": torch.randn(n, h, w, 18, device=dev,
                                         generator=g) * 2}[offsets]
    wt = torch.randn(3, 3, cin, cout, device=dev, generator=g) / (9 * cin) ** 0.5
    return x.bfloat16(), om.bfloat16(), wt.bfloat16()


def _dcn_fwd_check(x, om, wt, weight_kmajor=None):
    counts = (pallas_dcn.launches, pallas_dcn.wgmma_launches)
    out = pallas_dcn.fused_deform_conv(x, om, wt, weight_kmajor)
    ref = dcn.modulated_deform_conv(x, om, wt)
    assert (pallas_dcn.launches, pallas_dcn.wgmma_launches) == (
        counts[0] + 1, counts[1] + 1)
    _close(out, ref, 1e-2)


# K1's Hopper tile against its plain version in bfloat16, max|kernel −
# plain| over max|plain| within one output rounding (2⁻⁸) with margin:
# pixel counts off the 128-pixel tile, each Cout tile width (64, 128, 256;
# 512 as two 256-wide tiles), Cin 64 and 40 (no multiple of the 64-channel
# slice), offsets far outside the image, zero and whole-pixel
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 7, 11, 64, 64), (2, 9, 13, 40, 128), (1, 13, 21, 64, 256),
    (2, 5, 9, 128, 512), (1, 6, 7, 40, 72)])
@pytest.mark.parametrize("offsets", ["pm8", "far", "zero", "integer"])
def test_dcn_wgmma_tile(dev, n, h, w, cin, cout, offsets):
    _dcn_fwd_check(*_dcn_fwd_case(dev, n, h, w, cin, cout, offsets))


# the two flagship shapes (23 + 3 launches of an R101 request)
@pytest.mark.parametrize("n,h,w,cin,cout", [(6, 58, 100, 256, 256),
                                            (6, 29, 50, 512, 512)])
@pytest.mark.parametrize("offsets", ["model", "pm8"])
def test_dcn_wgmma_tile_flagship(dev, n, h, w, cin, cout, offsets):
    _dcn_fwd_check(*_dcn_fwd_case(dev, n, h, w, cin, cout, offsets))


def test_dcn_wgmma_tile_takes_a_cached_weight(dev):
    # the float32 parameter with its cached K-major bf16 copy, as
    # models/resnet.DCNConv passes them; a copy of the wrong layout is not
    # read (the wrapper builds its own)
    x, om, wt = _dcn_fwd_case(dev, 1, 9, 10, 64, 96, "pm8")
    w32 = wt.float()
    _dcn_fwd_check(x, om, w32, pallas_dcn.kmajor_weight(w32))
    _dcn_fwd_check(x, om, w32, wt.contiguous())


def test_dcn_float32_keeps_the_first_tile(dev):
    x, om, wt = (t.float() for t in _dcn_fwd_case(dev, 1, 7, 11, 64, 72,
                                                   "pm8"))
    counts = (pallas_dcn.launches, pallas_dcn.wgmma_launches)
    out = pallas_dcn.fused_deform_conv(x, om, wt)
    assert (pallas_dcn.launches, pallas_dcn.wgmma_launches) == (
        counts[0] + 1, counts[1])
    _close(out, dcn.modulated_deform_conv(x, om, wt), 1e-5)


def _dcn_bwd_case(dev, n, h, w, cin, cout, dtype, offsets):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, h, w, cin, device=dev, generator=g)
    om = torch.randn(n, h, w, 27, device=dev, generator=g)
    if offsets == "pm8":
        om[..., :18] = torch.rand(n, h, w, 18, device=dev, generator=g) * 16 - 8
    elif offsets == "zero":
        om[..., :18] = 0.0
    else:
        om[..., :18] = torch.randint(-3, 4, (n, h, w, 18), device=dev,
                                     generator=g).float()
    wt = torch.randn(3, 3, cin, cout, device=dev, generator=g) * 0.05
    d_out = torch.randn(n, h, w, cout, device=dev, generator=g)
    return x.to(dtype), om.to(dtype), wt, d_out.to(dtype)


# K3 against autograd of the plain version, per output relative to its
# max|plain|: float32 differs by the order of summation, bfloat16 by the
# plain version's bf16 rounding of d_samp and of each corner scatter; K3's
# own order is fixed, so a second launch gives the same bits
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("cin,cout", [(32, 40), (64, 136)])
@pytest.mark.parametrize("offsets", ["pm8", "zero", "integer"])
def test_dcn_backward_kernel(dev, dtype, tol, cin, cout, offsets):
    # 7 × 11 pixels × 2 images: no multiple of the 64-pixel or 32-pixel
    # tiles; Cin below the 128-channel slices, Cout off the 128 tile
    x, om, wt, d_out = _dcn_bwd_case(dev, 2, 7, 11, cin, cout, dtype,
                                     offsets)
    before = pallas_dcn.backward_launches
    got = pallas_dcn.backward_kernel(x, om, wt, d_out)
    ref = pallas_dcn.plain_backward(x, om, wt, d_out)
    assert pallas_dcn.backward_launches == before + 1
    again = pallas_dcn.backward_kernel(x, om, wt, d_out)
    for name, a, b, c in zip(("d_x", "d_om", "d_w"), got, ref, again):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max()
        assert err <= tol * b.float().abs().max(), (name, err.item())
        assert torch.equal(a, c), name


# the bfloat16 Hopper kernels at a flagship width: Cin = Cout = 256 on a
# small map (several 128-pixel bands, the last one ragged); "zero" keeps
# every corner within a pixel of its tap, "pm8" sends them up to 9 px away
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("offsets", ["zero", "pm8"])
def test_dcn_backward_kernel_flagship_width(dev, dtype, tol, offsets):
    x, om, wt, d_out = _dcn_bwd_case(dev, 2, 9, 17, 256, 256, dtype, offsets)
    got = pallas_dcn.backward_kernel(x, om, wt, d_out)
    ref = pallas_dcn.plain_backward(x, om, wt, d_out)
    again = pallas_dcn.backward_kernel(x, om, wt, d_out)
    for name, a, b, c in zip(("d_x", "d_om", "d_w"), got, ref, again):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max()
        assert err <= tol * b.float().abs().max(), (name, err.item())
        assert torch.equal(a, c), name


def test_dcn_autograd_function(dev):
    # the wrapper's autograd: K1 forward and K3 backward, the float32
    # weight's gradient in float32, d_x in the NHWC view's layout
    x, om, wt, d_out = _dcn_bwd_case(dev, 1, 9, 13, 32, 32, torch.bfloat16,
                                     "pm8")
    xc = x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    omr = om.clone().requires_grad_()
    wr = wt.clone().requires_grad_()
    f0, b0 = pallas_dcn.launches, pallas_dcn.backward_launches
    t0 = pallas_dcn.wgmma_launches
    out = pallas_dcn.fused_deform_conv(xc.permute(0, 2, 3, 1), omr, wr)
    out.backward(d_out)
    assert (pallas_dcn.launches, pallas_dcn.backward_launches) == (f0 + 1,
                                                                   b0 + 1)
    assert pallas_dcn.wgmma_launches == t0 + 1      # K1's Hopper tile feeds K3
    assert wr.grad.dtype == torch.float32
    assert xc.grad.shape == xc.shape and torch.isfinite(xc.grad).all()
    ref = pallas_dcn.plain_backward(x, om, wt, d_out)
    for a, b in zip((xc.grad.permute(0, 2, 3, 1), omr.grad, wr.grad), ref):
        assert (a.float() - b.float()).abs().max() <= (
            2e-2 * b.float().abs().max())


# ragged Q and T (T % 4 != 0 pads the keep rows; T = 1 leaves the second
# token warp idle), the flagship 8 x 900 x 1500 at batch 1 and 4; q, k, v
# as the strided views split_heads makes of [B, L, 256] projections
@pytest.mark.parametrize("b,nq,nt", [(2, 150, 200), (1, 33, 1), (1, 37, 150),
                                     (1, 900, 1500), (4, 900, 1500)])
def test_masked_attention_kernel(dev, b, nq, nt):
    g = torch.Generator(device=dev).manual_seed(1)
    qh, kh, vh = (split_heads(torch.randn(b, n, 256, device=dev, generator=g),
                              8) for n in (nq, nt, nt))
    keep = torch.rand(b, nq, nt, device=dev, generator=g) < 0.3
    keep[:, 0] = True
    keep[:, -1] = False                 # fully masked
    before = pallas_attention.launches, pallas_attention.mma_launches
    out = pallas_attention.masked_attention(qh, kh, vh, keep)
    assert (pallas_attention.launches, pallas_attention.mma_launches) == (
        before[0] + 1, before[1] + 1)
    ref = attention_core(qh, kh, vh, ~keep)
    assert torch.isfinite(out).all()
    # every row: a fully-masked one is the uniform average of v over T
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    assert merge_heads(out).data_ptr() == out.data_ptr()    # a view


def test_masked_attention_kernel_on_a_tensor_parallel_rank(dev):
    """K2 on 4 of the 8 heads, as a rank of a 2-way split head runs it:
    the [1, 4, 900, 32] views of a [1, L, 128] projection, 1500 tokens."""
    g = torch.Generator(device=dev).manual_seed(2)
    qh, kh, vh = (split_heads(torch.randn(1, n, 128, device=dev, generator=g),
                              4) for n in (900, 1500, 1500))
    keep = torch.rand(1, 900, 1500, device=dev, generator=g) < 0.3
    before = pallas_attention.mma_launches
    out = pallas_attention.masked_attention(qh, kh, vh, keep)
    assert pallas_attention.mma_launches == before + 1
    torch.testing.assert_close(out, attention_core(qh, kh, vh, ~keep),
                               rtol=2e-4, atol=2e-4)


def test_data_parallel_step_of_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): the tiny ``objdgcnn_pillar`` step of a global batch of 2
    equals the one-process step (the summed gradients before the clip
    and their norm to 0.1, ``dryrun.grad_error``: read at 1.1e-2 and
    2.3e-2 a tensor on the H100, where the rounding of a batch of 1
    instead of 2 moves sampling points across cell edges, against 0.5 for
    a wrong sum; losses, parameters and running statistics to rtol =
    atol = 1e-4), the ranks are bit for bit equal, and each rank launched
    K7, K8 and K9."""
    from transcar_tpu_torch.parallel import dryrun

    spec = dryrun.case("objdgcnn_pillar", dryrun.TINY_PILLAR + [
        "model.lidar_compute_dtype=float32"], batch=2, seed=3, max_gt=4)
    ref = str(tmp_path / "ref.pt")
    dryrun.save_reference(spec, ref, dev)
    for r in dryrun.spawn(dryrun.dp_check, 2, spec, ref, backend="gloo",
                          device="cuda"):
        assert r["loss_rel_err"] <= 1e-4 and r["agree"]
        assert max(r["grad_rel_err"], r["grad_worst"],
                   r["norm_rel_err"]) <= 0.1, r
        assert r["param_ratio"] <= 1.0 and r["buffer_ratio"] <= 1.0
        assert all(r["launches"].get(k, 0) > 0 for k in (
            "msdeform_forward", "msdeform_backward_taps",
            "msdeform_backward_value"))


def test_masked_attention_kernel_rejects_what_it_does_not_take(dev):
    qh = torch.zeros(1, 8, 10, 32, device=dev)
    keep = torch.ones(1, 10, 10, dtype=torch.bool, device=dev)
    strided = torch.zeros(1, 8, 32, 10, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        pallas_attention.masked_attention(qh, strided, qh, keep)
    with pytest.raises(ValueError, match="head dim 32"):
        pallas_attention.masked_attention(*(torch.zeros(1, 2, 10, 16,
                                                        device=dev),) * 3, keep)
    with pytest.raises(TypeError, match="float32"):
        pallas_attention.masked_attention(qh.double(), qh, qh, keep)
    with pytest.raises(ValueError, match="one CUDA device"):
        pallas_attention.masked_attention(qh, qh, qh, keep.cpu())


# --- K4, K5, K6: ragged shapes ---------------------------------------------
# Float32 differs from the plain version by summation order only; bfloat16
# by that order before one output rounding (2⁻⁸), with margin; the K5 / K6
# chains round each intermediate, where a value on a rounding boundary may
# go either way and carry into the next conv.  The channel sums come from
# the float32 values before the rounding, summed in another order than the
# plain version's; the kernels' order is fixed, so a second launch gives
# the same bits.
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
CHAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SUMS_TOL = 1e-4


def _close(got, ref, tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), err.item()


def _aff(g, c, dev):
    return (torch.rand(c, device=dev, generator=g) + 0.5,
            torch.randn(c, device=dev, generator=g) * 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,widths,cout,relu", [
    (1, 7, 11, [32, 13, 16, 20], 72, True),     # odd H, W; C % 8 != 0
    (2, 9, 9, [24, 8], 70, False),              # Cout % 8 != 0
    (1, 20, 30, [64, 40, 40], 136, True),       # > one 64-pixel tile
])
def test_osa_reduce_kernel(dev, dtype, n, h, w, widths, cout, relu):
    g = torch.Generator(device=dev).manual_seed(4)
    pieces = [torch.randn(n, h, w, c, device=dev, generator=g).to(dtype)
              for c in widths]
    ws = [torch.randn(c, cout, device=dev, generator=g) / sum(widths) ** 0.5
          for c in widths]
    s, b = _aff(g, cout, dev)
    before = pallas_osa.launches
    out, sums = pallas_osa.osa_reduce(pieces, ws, s, b, relu=relu)
    ref, ref_sums = pallas_osa.plain_osa_reduce(pieces, ws, s, b, relu=relu)
    assert pallas_osa.launches == before + 1
    _close(out, ref, CONV_TOL[dtype])
    _close(sums, ref_sums, SUMS_TOL)
    again = pallas_osa.osa_reduce(pieces, ws, s, b, relu=relu)
    assert torch.equal(out, again[0]) and torch.equal(sums, again[1])


# VoVNet widths on small maps: several 128-pixel tiles per image with the
# image edge inside the last one, 160- and 224-wide pieces (no multiple of
# the 64-wide K slice), Cout of one and of two 256-wide tiles; bfloat16
# takes the wgmma tile, with the model's K-major weights or contiguous ones
@pytest.mark.parametrize("n,h,w,widths,cout", [
    (2, 13, 21, [128, 160, 160, 160], 256),
    (1, 17, 19, [256, 224, 224], 512),
    (3, 9, 10, [64, 40, 40], 136),
])
@pytest.mark.parametrize("kmajor", [True, False])
def test_osa_reduce_wgmma_tile(dev, n, h, w, widths, cout, kmajor):
    g = torch.Generator(device=dev).manual_seed(5)
    pieces = [torch.randn(n, h, w, c, device=dev, generator=g)
              .to(torch.bfloat16) for c in widths]
    w_all = torch.randn(cout, sum(widths), device=dev,
                        generator=g) / sum(widths) ** 0.5
    ws = (pallas_osa.kmajor_weights(w_all, widths, torch.bfloat16) if kmajor
          else list(torch.split(w_all.t().contiguous(), widths, 0)))
    s, b = _aff(g, cout, dev)
    before = (pallas_osa.launches, pallas_osa.wgmma_launches)
    out, sums = pallas_osa.osa_reduce(pieces, ws, s, b)
    ref, ref_sums = pallas_osa.plain_osa_reduce(pieces, ws, s, b)
    assert (pallas_osa.launches, pallas_osa.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    _close(out, ref, CONV_TOL[torch.bfloat16])
    _close(sums, ref_sums, SUMS_TOL)
    again = pallas_osa.osa_reduce(pieces, ws, s, b)
    assert torch.equal(out, again[0]) and torch.equal(sums, again[1])


def test_osa_reduce_odd_widths_take_the_wmma_tile(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    pieces = [torch.randn(1, 7, 11, c, device=dev, generator=g)
              .to(torch.bfloat16) for c in (32, 13)]
    ws = [torch.randn(c, 72, device=dev, generator=g) for c in (32, 13)]
    s, b = _aff(g, 72, dev)
    before = pallas_osa.wgmma_launches
    out, sums = pallas_osa.osa_reduce(pieces, ws, s, b)
    ref, ref_sums = pallas_osa.plain_osa_reduce(pieces, ws, s, b)
    assert pallas_osa.wgmma_launches == before
    _close(out, ref, CONV_TOL[torch.bfloat16])
    _close(sums, ref_sums, SUMS_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c0,ch,cr,k", [
    (1, 9, 13, 20, 16, 40, 3),                  # C0 % 8 != 0
    (2, 17, 25, 128, 128, 256, 5),              # a V-99 stage-2 block, small
])
def test_osa_block_kernel(dev, dtype, n, h, w, c0, ch, cr, k):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(n, h, w, c0, device=dev, generator=g).to(dtype)
    w9s, affs, cin = [], [], c0
    for _ in range(k):
        w9s.append(torch.randn(3, 3, cin, ch, device=dev, generator=g)
                   / (9 * cin) ** 0.5)
        affs.append(_aff(g, ch, dev))
        cin = ch
    rws = [torch.randn(c, cr, device=dev, generator=g) / (c0 + k * ch) ** 0.5
           for c in [c0] + [ch] * k]
    raff = _aff(g, cr, dev)
    before = pallas_osa_block.launches
    out, sums = pallas_osa_block.osa_block_fused(x, w9s, affs, rws, raff)
    ref, ref_sums = pallas_osa_block.plain_osa_block(x, w9s, affs, rws, raff)
    assert pallas_osa_block.launches == before + 1
    _close(out, ref, CHAIN_TOL[dtype])
    _close(sums, ref_sums, SUMS_TOL if dtype == torch.float32
           else CHAIN_TOL[dtype])
    again = pallas_osa_block.osa_block_fused(x, w9s, affs, rws, raff)
    assert torch.equal(out, again[0]) and torch.equal(sums, again[1])


# K5's chain tile against conv3x3_affine_relu rounded once to bfloat16:
# the ragged chain widths 160 and 224 (no multiple of the 64-channel slice),
# W = 50 (no multiple of any tile width), a single row, several images
@pytest.mark.parametrize("n,h,w,cin,ch", [
    (2, 1, 50, 64, 160), (1, 3, 50, 224, 224), (2, 9, 50, 160, 160),
    (1, 17, 19, 128, 128), (1, 5, 100, 192, 192)])
def test_osa_chain_wgmma_tile(dev, n, h, w, cin, ch):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(n, h, w, cin, device=dev, generator=g).bfloat16()
    w9 = torch.randn(3, 3, cin, ch, device=dev, generator=g) / (9 * cin) ** 0.5
    s, b = _aff(g, ch, dev)
    before = pallas_osa_block.wgmma_launches
    out = pallas_osa_block.conv3x3_kernel(
        x, pallas_osa_block.kmajor_conv_weight(w9, torch.bfloat16), s, b)
    ref = pallas_osa_block.conv3x3_affine_relu(x, w9, (s, b)).bfloat16()
    assert pallas_osa_block.wgmma_launches == before + 1
    _close(out, ref, CONV_TOL[torch.bfloat16])


# a whole bfloat16 block on the Hopper tiles (k chain tiles, then K4's
# wgmma tile for the reduce) against plain_osa_block; float32 keeps the
# wmma tile of conv_tile.cuh for all of it
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c0,ch,cr,k", [
    (2, 1, 50, 256, 160, 512, 5),
    (1, 7, 50, 768, 224, 1024, 5),
    (1, 9, 13, 128, 128, 256, 2),
])
def test_osa_block_wgmma_tiles(dev, dtype, n, h, w, c0, ch, cr, k):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(n, h, w, c0, device=dev, generator=g).to(dtype)
    w9s, affs, cin = [], [], c0
    for _ in range(k):
        w9s.append(torch.randn(3, 3, cin, ch, device=dev, generator=g)
                   / (9 * cin) ** 0.5)
        affs.append(_aff(g, ch, dev))
        cin = ch
    rws = [torch.randn(c, cr, device=dev, generator=g) / (c0 + k * ch) ** 0.5
           for c in [c0] + [ch] * k]
    raff = _aff(g, cr, dev)
    counts = lambda: (pallas_osa_block.launches,
                      pallas_osa_block.wgmma_launches, pallas_osa.launches,
                      pallas_osa.wgmma_launches)
    before = counts()
    out, sums = pallas_osa_block.osa_block_fused(x, w9s, affs, rws, raff)
    ref, ref_sums = pallas_osa_block.plain_osa_block(x, w9s, affs, rws, raff)
    bf16 = int(dtype == torch.bfloat16)
    assert counts() == (before[0] + 1, before[1] + k * bf16,
                        before[2] + bf16, before[3] + bf16)
    _close(out, ref, CHAIN_TOL[dtype])
    _close(sums, ref_sums, SUMS_TOL if dtype == torch.float32
           else CHAIN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cm,cout,ds", [
    (1, 9, 13, 32, 8, 32, False),               # identity, Cm below a slice
    (1, 7, 11, 12, 16, 40, True),               # downsample, Cin % 8 != 0
    (2, 5, 7, 2048, 512, 2048, False),          # Cm = 512 (ResNet layer 4)
])
def test_bottleneck_kernel(dev, dtype, n, h, w, cin, cm, cout, ds):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(n, h, w, cin, device=dev, generator=g).to(dtype)
    k = lambda *s: torch.randn(*s, device=dev, generator=g) / (
        s[0] * s[1] * s[2]) ** 0.5
    args = [k(1, 1, cin, cm), _aff(g, cm, dev), k(3, 3, cm, cm),
            _aff(g, cm, dev), k(1, 1, cm, cout), _aff(g, cout, dev)]
    kw = dict(wd=k(1, 1, cin, cout), affd=_aff(g, cout, dev)) if ds else {}
    before = (pallas_bottleneck.launches, pallas_bottleneck.wgmma_launches)
    out = pallas_bottleneck.bottleneck_fused(x, *args, **kw)
    ref = pallas_bottleneck.plain_bottleneck(x, *args, **kw)
    # bfloat16 with every width a multiple of 8 takes the Hopper tile;
    # float32 and Cin = 12 keep conv_tile.cuh
    wgmma = int(dtype == torch.bfloat16 and cin % 8 == 0)
    assert (pallas_bottleneck.launches, pallas_bottleneck.wgmma_launches) == (
        before[0] + 1, before[1] + wgmma)
    _close(out, ref, CHAIN_TOL[dtype])


# K6's Hopper tile (conv1 and conv3 on the reduce form, conv2 on the 3×3
# form of csrc/osa_wgmma.cuh) at the three R101 width triples on a 29 × 50
# grid (1450 pixels: no multiple of the 128-pixel tile), with the K-major
# copies the model caches and without them (the wrapper builds them)
@pytest.mark.parametrize("cin,cm,cout,ds", [
    (64, 64, 256, True),                        # layer1_0, downsample
    (256, 64, 256, False),                      # layer1_1..2
    (512, 128, 512, False),                     # layer2_1..3
])
@pytest.mark.parametrize("kmajor", [True, False])
def test_bottleneck_wgmma_tile(dev, cin, cm, cout, ds, kmajor):
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(1, 29, 50, cin, device=dev, generator=g).bfloat16()
    k = lambda *s: torch.randn(*s, device=dev, generator=g) / (
        s[0] * s[1] * s[2]) ** 0.5
    w1, w2, w3 = k(1, 1, cin, cm), k(3, 3, cm, cm), k(1, 1, cm, cout)
    args = [w1, _aff(g, cm, dev), w2, _aff(g, cm, dev), w3,
            _aff(g, cout, dev)]
    kw = dict(wd=k(1, 1, cin, cout), affd=_aff(g, cout, dev)) if ds else {}
    ks = (pallas_bottleneck.kmajor_weights(w1, w2, w3, kw.get("wd"))
          if kmajor else None)
    before = (pallas_bottleneck.launches, pallas_bottleneck.wgmma_launches)
    out = pallas_bottleneck.bottleneck_fused(x, *args, **kw, kmajor=ks)
    ref = pallas_bottleneck.plain_bottleneck(x, *args, **kw)
    assert (pallas_bottleneck.launches, pallas_bottleneck.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    _close(out, ref, CHAIN_TOL[torch.bfloat16])


def test_bottleneck_wgmma_tile_rejects_unusable_kmajor(dev):
    """K-major copies that are given but not in the Hopper tile's dtype
    raise, rather than being rebuilt on every call; a float32 call on the
    first tile ignores them."""
    g = torch.Generator(device=dev).manual_seed(10)
    k = lambda *s: torch.randn(*s, device=dev, generator=g) / (
        s[0] * s[1] * s[2]) ** 0.5
    w1, w2, w3 = k(1, 1, 64, 32), k(3, 3, 32, 32), k(1, 1, 32, 64)
    args = [w1, _aff(g, 32, dev), w2, _aff(g, 32, dev), w3, _aff(g, 64, dev)]
    f32 = pallas_bottleneck.kmajor_weights(w1, w2, w3, dtype=torch.float32)
    x = torch.randn(1, 5, 7, 64, device=dev, generator=g)
    with pytest.raises(ValueError, match="K-major"):
        pallas_bottleneck.bottleneck_fused(x.bfloat16(), *args, kmajor=f32)
    before = pallas_bottleneck.wgmma_launches
    out = pallas_bottleneck.bottleneck_fused(x, *args, kmajor=f32)
    assert pallas_bottleneck.wgmma_launches == before
    _close(out, pallas_bottleneck.plain_bottleneck(x, *args),
           CHAIN_TOL[torch.float32])


def test_conv_kernels_are_forward_only(dev):
    x = torch.randn(1, 3, 5, 8, device=dev, requires_grad=True)
    ones = torch.ones(8, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        pallas_osa.osa_reduce([x], [torch.ones(8, 8, device=dev)], ones, ones)


def _msdeform_case(dev, b, q, heads, d, shapes, p, lo=-0.25, hi=1.25):
    """Value, locations over [lo, hi] (off the map past [0, 1]) and
    softmaxed weights."""
    g = torch.Generator(device=dev).manual_seed(7)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, heads, d, device=dev, generator=g)
    loc = lo + (hi - lo) * torch.rand(b, q, heads, len(shapes), p, 2,
                                      device=dev, generator=g)
    wgt = torch.randn(b, q, heads, len(shapes) * p, device=dev, generator=g)
    wgt = wgt.softmax(-1).reshape(b, q, heads, len(shapes), p)
    return value, loc, wgt


# K7 against its plain version, max|kernel − plain| over max|plain|: both
# float32, differing by summation order over the L·P samples
@pytest.mark.parametrize("b,q,heads,d,shapes,p", [
    (1, 37, 6, 16, [(7, 9), (4, 5), (2, 3), (1, 1)], 4),   # Q off the warp
    (2, 300, 8, 32, [(16, 16), (8, 8), (4, 4), (2, 2)], 4),
    (1, 5, 3, 48, [(5, 3)], 3),                 # D past one warp's lanes
    (1, 129, 8, 32, [(1, 1), (3, 70)], 2),                  # a 1 × 1 level
])
def test_msdeform_kernel(dev, b, q, heads, d, shapes, p):
    value, loc, wgt = _msdeform_case(dev, b, q, heads, d, shapes, p)
    before = pallas_msdeform.launches
    out = pallas_msdeform.ms_deform_attn(value, shapes, loc, wgt)
    ref = ms_deform_attn_core(value, shapes, loc, wgt)
    torch.cuda.synchronize()
    assert pallas_msdeform.launches == before + 1
    assert out.shape == ref.shape == (b, q, heads * d)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_msdeform_kernel_far_and_non_finite_locations(dev):
    shapes = [(6, 7), (3, 4)]
    value, loc, wgt = _msdeform_case(dev, 1, 9, 4, 32, shapes, 2)
    loc[0, 0, 0, 0, 0] = torch.tensor([0.5, 40.0])      # far below the map
    loc[0, 1, 1, 1, 1] = torch.tensor([-1e20, 0.5])     # far left
    loc[0, 2, 2, 0, 1, 0] = float("nan")
    loc[0, 3, 3, 1, 0, 1] = float("inf")
    out = pallas_msdeform.ms_deform_attn(value, shapes, loc, wgt)
    ref = ms_deform_attn_core(value, shapes, loc, wgt)
    assert torch.equal(out.isnan(), ref.isnan()) and ref.isnan().any()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


def _counts():
    return (pallas_msdeform.launches, pallas_msdeform.backward_taps_launches,
            pallas_msdeform.backward_value_launches)


def _takes_group(d):
    """K8's lane-group kernel takes D % 8 == 0 and D <= 64."""
    return d % 8 == 0 and d <= 64


def test_msdeform_kernel_is_forward_only(dev):
    """The name is kept from when K7 refused autograd: on CUDA tensors the
    wrapper now differentiates through ``MSDeformAttnFunction``, one K7,
    K8 and K9 launch with the plain backward's gradients; K8 runs only for
    d_loc / d_attn and K9 only for d_value; under no_grad only K7."""
    shapes = [(4, 4)]
    value, loc, wgt = _msdeform_case(dev, 1, 3, 2, 32, shapes, 2)
    args = [x.clone().requires_grad_() for x in (value, loc, wgt)]
    before = _counts()
    out = pallas_msdeform.ms_deform_attn(args[0], shapes, *args[1:])
    d_out = torch.randn_like(out)
    got = torch.autograd.grad(out, args, d_out)
    assert _counts() == tuple(c + 1 for c in before)
    want = ms_deform_attn_backward(value, shapes, loc, wgt, d_out)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    before = _counts()
    v = value.clone().requires_grad_()
    pallas_msdeform.ms_deform_attn(v, shapes, loc, wgt).backward(d_out)
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)
    with torch.no_grad():
        assert pallas_msdeform.ms_deform_attn(
            v, shapes, loc, wgt).shape == (1, 3, 64)
    assert _counts() == (before[0] + 2, before[1], before[2] + 1)


# K8 and K9 against the plain backward, max|kernel − plain| over
# max|plain| per gradient: both float32, differing by summation order; K9's
# order is fixed (a gather by target), so a second launch gives the same
# bits.  D = 16,
# 48 and 32 take K8's lane-group kernel (G = 2, 8 and 4 lanes a sample;
# D = 48 leaves lanes idle), D = 12 and 72 its first kernel; the pillar-like
# case has Q off the group kernel's 32-query blocks
@pytest.mark.parametrize("b,q,heads,d,shapes,p", [
    (1, 37, 6, 16, [(7, 9), (4, 5), (2, 3), (1, 1)], 4),   # Q off the warp
    (2, 129, 6, 48, [(16, 16), (8, 8), (4, 4), (1, 1)], 4),  # D past 32
    (1, 129, 8, 32, [(1, 1), (3, 70)], 2),
    (1, 301, 8, 32, [(32, 32), (16, 16), (8, 8), (4, 4)], 4),  # pillar-like
    (1, 45, 4, 12, [(6, 7), (3, 4)], 4),
    (1, 33, 3, 72, [(5, 6)], 3),
])
def test_msdeform_backward_kernels(dev, b, q, heads, d, shapes, p):
    value, loc, wgt = _msdeform_case(dev, b, q, heads, d, shapes, p)
    # whole-number coordinates on level 0, far-off samples at ±1e20
    hl, wl = shapes[0]
    g = torch.Generator(device=dev).manual_seed(8)
    loc[:, ::2, :, 0, 0, 0] = (torch.randint(-1, wl + 1, (b, (q + 1) // 2,
                               heads), device=dev, generator=g) + 0.5) / wl
    loc[:, ::2, :, 0, 0, 1] = (torch.randint(-1, hl + 1, (b, (q + 1) // 2,
                               heads), device=dev, generator=g) + 0.5) / hl
    loc[0, 1, 1, 0, 1] = torch.tensor([1e20, 0.5])
    loc[0, 2, 2, -1, 0] = torch.tensor([0.5, -1e20])
    d_out = torch.randn(b, q, heads * d, device=dev, generator=g)
    before = _counts()
    before_group = pallas_msdeform.backward_taps_group_launches
    d_loc, d_attn = pallas_msdeform.backward_taps_kernel(value, shapes, loc,
                                                         wgt, d_out)
    group = pallas_msdeform.backward_taps_group_launches - before_group
    d_value = pallas_msdeform.backward_value_kernel(value, shapes, loc, wgt,
                                                    d_out)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 1)
    assert group == int(_takes_group(d))
    assert torch.equal(d_value, pallas_msdeform.backward_value_kernel(
        value, shapes, loc, wgt, d_out))
    want = ms_deform_attn_backward(value, shapes, loc, wgt, d_out)
    for got, ref, name in zip((d_value, d_loc, d_attn), want,
                              ("d_value", "d_loc", "d_attn")):
        assert got.shape == ref.shape, name
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (name, err)
    assert not d_loc[0, 1, 1, 0, 1].any() and not d_attn[0, 2, 2, -1, 0]


def test_msdeform_backward_misaligned_rows_skip_the_group_kernel(dev):
    """A value or d_out 4 bytes past a 16-byte boundary (its rows are read
    as float4) takes K8's first kernel through the wrapper, with the plain
    gradients, and the lane-group entry refuses it with an error."""
    shapes = [(4, 5)]
    value, loc, wgt = _msdeform_case(dev, 1, 9, 2, 32, shapes, 2)
    d_out = torch.randn(1, 9, 64, device=dev)
    shift = lambda t: torch.empty(t.numel() + 1, device=dev)[1:].view_as(
        t).copy_(t)
    want = ms_deform_attn_backward(value, shapes, loc, wgt, d_out)
    for v, g in ((shift(value), d_out), (value, shift(d_out))):
        before = pallas_msdeform.backward_taps_group_launches
        d_loc, d_attn = pallas_msdeform.backward_taps_kernel(v, shapes, loc,
                                                             wgt, g)
        assert pallas_msdeform.backward_taps_group_launches == before
        for got, ref in ((d_loc, want[1]), (d_attn, want[2])):
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        with pytest.raises(RuntimeError, match="CUDA error"):
            pallas_msdeform._launch(
                "msdeform_backward_taps_group_f32",
                (pallas_msdeform._P,) * 6 + pallas_msdeform._SHAPE_ARGS,
                *(t.data_ptr() for t in (v, loc, wgt, g, d_loc, d_attn)),
                1, 20, 9, 2, 32, 1, 2, *pallas_msdeform._levels(shapes),
                device=v.device)


@pytest.mark.parametrize("d", [32, 12])
def test_msdeform_backward_taps_non_finite_locations(dev, d):
    """K8 on both kernels: a NaN or infinite location gives NaN d_attn and
    d_loc for that sample alone; the rest match the plain backward."""
    shapes = [(6, 7), (3, 4)]
    value, loc, wgt = _msdeform_case(dev, 1, 40, 4, d, shapes, 4)
    loc[0, 2, 1, 0, 3, 0] = float("nan")
    loc[0, 33, 3, 1, 0, 1] = float("inf")
    bad = torch.zeros(wgt.shape, dtype=torch.bool, device=dev)
    bad[0, 2, 1, 0, 3] = bad[0, 33, 3, 1, 0] = True
    d_out = torch.randn(1, 40, 4 * d, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    before = pallas_msdeform.backward_taps_group_launches
    d_loc, d_attn = pallas_msdeform.backward_taps_kernel(value, shapes, loc,
                                                         wgt, d_out)
    assert pallas_msdeform.backward_taps_group_launches - before == int(
        _takes_group(d))
    assert d_attn.isnan().equal(bad) and d_loc.isnan().any(-1).equal(bad)
    assert d_loc[bad].isnan().all()
    ok = ~bad
    loc_ok = torch.where(bad[..., None], torch.zeros_like(loc), loc)
    _, ref_loc, ref_attn = ms_deform_attn_backward(value, shapes, loc_ok, wgt,
                                                   d_out)
    for got, ref in ((d_attn[ok], ref_attn[ok]), (d_loc[ok], ref_loc[ok])):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# The cases of test_msdeform_kernel and test_msdeform_backward_kernels: D =
# 16, 32 and 48 take K7's lane-group kernel (G = 2, 4 and 8 lanes a
# query), D = 12 and 72 its first kernel; K9 is one gather for any D; Q =
# 37, 301 and 129 end off the group kernels' blocks of 8 to 64 queries
_GROUP_CASES = [
    (1, 37, 6, 16, [(7, 9), (4, 5), (2, 3), (1, 1)], 4),
    (2, 300, 8, 32, [(16, 16), (8, 8), (4, 4), (2, 2)], 4),
    (1, 5, 3, 48, [(5, 3)], 3),
    (1, 129, 8, 32, [(1, 1), (3, 70)], 2),
    (2, 129, 6, 48, [(16, 16), (8, 8), (4, 4), (1, 1)], 4),
    (1, 301, 8, 32, [(32, 32), (16, 16), (8, 8), (4, 4)], 4),   # pillar-like
    (1, 45, 4, 12, [(6, 7), (3, 4)], 4),
    (1, 33, 3, 72, [(5, 6)], 3),
]


@pytest.mark.parametrize("b,q,heads,d,shapes,p", _GROUP_CASES)
def test_msdeform_group_kernels_take_their_domain(dev, b, q, heads, d,
                                                  shapes, p):
    """K7 takes its lane-group kernel for D % 8 == 0 and D <= 64 (the
    counter rises by one), its first kernel otherwise (the counter stays);
    K9's gather takes every D; within 1e-5 of max|plain| either way."""
    value, loc, wgt = _msdeform_case(dev, b, q, heads, d, shapes, p)
    d_out = torch.randn(b, q, heads * d, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    before = (pallas_msdeform.group_launches,
              pallas_msdeform.backward_value_launches)
    out = pallas_msdeform.ms_deform_attn(value, shapes, loc, wgt)
    d_value = pallas_msdeform.backward_value_kernel(value, shapes, loc, wgt,
                                                    d_out)
    torch.cuda.synchronize()
    assert (pallas_msdeform.group_launches - before[0],
            pallas_msdeform.backward_value_launches - before[1]) == (
                int(_takes_group(d)), 1)
    ref = ms_deform_attn_core(value, shapes, loc, wgt)
    ref_value = ms_deform_attn_backward(value, shapes, loc, wgt, d_out)[0]
    for got, want in ((out, ref), (d_value, ref_value)):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_msdeform_group_kernel_far_and_non_finite_locations(dev):
    """K7's lane-group kernel: NaN rows where the plain version has them
    (a NaN or infinite location), far-off locations read nothing."""
    shapes = [(6, 7), (3, 4)]
    value, loc, wgt = _msdeform_case(dev, 1, 40, 4, 32, shapes, 2)
    loc[0, 0, 0, 0, 0] = torch.tensor([0.5, 40.0])      # far below the map
    loc[0, 9, 1, 1, 1] = torch.tensor([-1e20, 0.5])     # far left
    loc[0, 17, 2, 0, 1, 0] = float("nan")
    loc[0, 33, 3, 1, 0, 1] = float("inf")
    before = pallas_msdeform.group_launches
    out = pallas_msdeform.ms_deform_attn(value, shapes, loc, wgt)
    assert pallas_msdeform.group_launches == before + 1
    ref = ms_deform_attn_core(value, shapes, loc, wgt)
    assert torch.equal(out.isnan(), ref.isnan()) and ref.isnan().any()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("d", [32, 12])
def test_msdeform_backward_value_non_finite_locations(dev, d):
    """K9 at D = 32 and 12: a NaN or infinite location adds nothing to
    d_value (the plain backward with that sample's weight set to 0)."""
    shapes = [(6, 7), (3, 4)]
    value, loc, wgt = _msdeform_case(dev, 1, 40, 4, d, shapes, 4)
    loc[0, 2, 1, 0, 3, 0] = float("nan")
    loc[0, 33, 3, 1, 0, 1] = float("inf")
    loc[0, 34, 0, 0, 2] = float("-inf")
    bad = ~loc.isfinite().all(-1)
    d_out = torch.randn(1, 40, 4 * d, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    before = pallas_msdeform.backward_value_launches
    d_value = pallas_msdeform.backward_value_kernel(value, shapes, loc, wgt,
                                                    d_out)
    assert pallas_msdeform.backward_value_launches - before == 1
    loc_ok = torch.where(bad[..., None], torch.zeros_like(loc), loc)
    wgt_ok = torch.where(bad, torch.zeros_like(wgt), wgt)
    ref = ms_deform_attn_backward(value, shapes, loc_ok, wgt_ok, d_out)[0]
    assert d_value.isfinite().all()
    assert (d_value - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_msdeform_misaligned_rows_skip_the_group_kernels(dev):
    """A value 4 bytes past a 16-byte boundary takes K7's first kernel
    through the wrapper, with the plain result, and the lane-group entry
    refuses it, and a misaligned output, with an error; K9's gather reads
    a d_out so misaligned by scalar loads, with the plain result."""
    shapes = [(4, 5)]
    value, loc, wgt = _msdeform_case(dev, 1, 9, 2, 32, shapes, 2)
    d_out = torch.randn(1, 9, 64, device=dev)
    shift = lambda t: torch.empty(t.numel() + 1, device=dev)[1:].view_as(
        t).copy_(t)
    args = (1, 20, 9, 2, 32, 1, 2, *pallas_msdeform._levels(shapes))
    sig = (pallas_msdeform._P,) * 4 + pallas_msdeform._SHAPE_ARGS
    ref = ms_deform_attn_core(value, shapes, loc, wgt)
    v = shift(value)
    before = pallas_msdeform.group_launches
    out = pallas_msdeform.kernel(v, shapes, loc, wgt)
    assert pallas_msdeform.group_launches == before
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    for src, dst in ((v, out), (value, shift(out))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            pallas_msdeform._launch(
                "msdeform_forward_group_f32", sig,
                *(t.data_ptr() for t in (src, loc, wgt, dst)), *args,
                device=dev)
    ref_value = ms_deform_attn_backward(value, shapes, loc, wgt, d_out)[0]
    g = shift(d_out)
    d_value = pallas_msdeform.backward_value_kernel(value, shapes, loc, wgt, g)
    assert (d_value - ref_value).abs().max() <= 1e-5 * ref_value.abs().max()


# --- the voxel model's sparse encoder (plain PyTorch, no kernel of its own)

def _sparse_case(g, counts, cin, v=192, grid=(8, 12, 12)):
    """Unique random sites per sample in [B, V] buffers, on the CPU."""
    b = len(counts)
    cells = grid[0] * grid[1] * grid[2]
    feats = torch.zeros(b, v, cin)
    coords = torch.zeros(b, v, 3, dtype=torch.int32)
    for bi, n in enumerate(counts):
        lin = torch.randperm(cells, generator=g)[:n]
        coords[bi, :n] = torch.stack([lin // (grid[1] * grid[2]),
                                      (lin // grid[2]) % grid[1],
                                      lin % grid[2]], 1).int()
        feats[bi, :n] = torch.randn(n, cin, generator=g)
    return feats, coords, torch.tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("out_max", [192, 40])
def test_sparse_ops_on_the_card_match_the_cpu(dev, out_max):
    """The submanifold and strided convs (float32, TF32 off) on the card
    against the same ops on the CPU: site sets, coords, counts and the
    dropped count exactly, features to 1e-5 of their scale (the card's
    GEMM sums in another order)."""
    from transcar_tpu_torch.ops import sparse

    g = torch.Generator().manual_seed(0)
    grid = (8, 12, 12)
    feats, coords, counts = _sparse_case(g, [60, 23], 8)
    w = torch.randn(27, 8, 16, generator=g) * 0.2
    cpu = (sparse.subm_conv(feats, coords, counts, w, grid),
           *sparse.sparse_conv_down(feats, coords, counts, w, grid, out_max))
    args = [a.to(dev) for a in (feats, coords, counts, w)]
    card = (sparse.subm_conv(*args, grid),
            *sparse.sparse_conv_down(*args, grid, out_max))
    for a, b in zip(card, cpu):
        if b.is_floating_point():
            assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()
        else:
            assert torch.equal(a.cpu(), b)
    assert (card[4] > 0).all() if out_max == 40 else (card[4] == 0).all()


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_sparse_encoder_makes_no_host_sync(dev, impl):
    """The middle encoder, warm, on the card, under
    ``set_sync_debug_mode("error")`` (train mode, batch statistics: the
    running statistics update on the device too), against the CPU."""
    from transcar_tpu_torch.models.sparse_encoder import SparseEncoder

    g = torch.Generator().manual_seed(1)
    feats, coords, counts = _sparse_case(g, [24, 17], 5)
    enc = SparseEncoder(5, (8, 12, 12), impl=impl)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    ref = enc.train()(feats, coords, counts)
    enc = enc.to(dev)
    args = [a.to(dev) for a in (feats, coords, counts)]
    enc(*args)                                             # warmup
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = enc(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (out.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("photometric", [False, True])
def test_normalize_batch_images_on_the_card(dev, photometric):
    """``train/step.normalize_batch_images`` on the card against the CPU,
    at a padded odd-sized batch (3 samples of 5 cameras, 37 × 53 content
    padded to 64 × 64): equal bit for bit without the photometric
    distortion, within 2e-2 on the 0-255 scale with it (the tolerance of
    tests/test_device_normalize.py)."""
    import numpy as np

    from transcar_tpu_torch.core.config import DataConfig
    from transcar_tpu_torch.data.pipeline import draw_photometric_params
    from transcar_tpu_torch.train.step import normalize_batch_images

    rng = np.random.default_rng(0)
    b, n = 3, 5
    images = np.zeros((b, n, 64, 64, 3), np.uint8)
    images[:, :, :37, :53] = rng.integers(0, 256, (b, n, 37, 53, 3))
    batch = {"images": images,
             "img_shape": np.tile(np.int32([37, 53]), (b, 1))}
    if photometric:
        params, perm = draw_photometric_params(rng, b * n)
        batch["photo_params"] = params.reshape(b, n, 5)
        batch["photo_perm"] = perm.reshape(b, n, 3)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    dc = DataConfig()
    cpu = normalize_batch_images(batch, dc)["images"]
    got = normalize_batch_images({k: v.to(dev) for k, v in batch.items()},
                                 dc)["images"].cpu()
    assert got.dtype == torch.float32 and got.shape == cpu.shape
    if photometric:
        assert (got - cpu).abs().max() <= 2e-2
    else:
        assert torch.equal(got, cpu)


# --- int8 serving: the quantize pass and the int8 implicit-GEMM conv ---------

def _int8_case(dev, n, cin, h, w, cout, k, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, cin, h, w, device=dev, generator=g) * 2).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, k, k, device=dev, generator=g) / (k * cin
                                                                 ) ** 0.5
    return x, wt


def _int8_plain(x, wt, stride, padding, out_dtype):
    from transcar_tpu_torch.ops import int8

    xq, s_x = int8.plain_quantize_per_tensor(x)
    q, s_w = int8.quantize_weight_per_channel(wt)
    return int8.plain_int8_conv(xq, s_x, q, s_w, stride, padding, 1,
                                out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 64, 33, 17),
                                   (3, 160, 9, 11)])
def test_int8_quantize_kernel(dev, dtype, shape):
    # codes and scale bit for bit: a true division, round half to even
    # (ties at a scale of exactly 1); an element count that is no
    # multiple of 8 ends in the scalar tail
    from transcar_tpu_torch.ops import int8

    n, c, h, w = shape
    x = (torch.randn(n, c, h, w, device=dev) * 3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    x.permute(0, 2, 3, 1).view(-1)[:9] = torch.tensor(
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0],
        device=dev).to(dtype)
    before = int8.quantize_launches
    q, s = int8.quantize_kernel(x)
    assert int8.quantize_launches == before + 1
    q_ref, s_ref = int8.plain_quantize_per_tensor(x)
    assert s.item() == s_ref.item() == 1.0
    assert q.stride() == x.stride() and torch.equal(q, q_ref)
    for f in (0.37, 0.8123, 1.1):
        x2 = x * f
        q, s = int8.quantize_kernel(x2)
        q_ref, s_ref = int8.plain_quantize_per_tensor(x2)
        # a true division: float64 then float32 rounds as float32 does
        want = (x2.float().abs().max().double() / 127).float()
        assert s.item() == s_ref.item() == want.item()
        assert torch.equal(q, q_ref)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,cin,h,w,cout,k,stride,padding", [
    (2, 3, 37, 45, 64, 7, 2, 3),        # stem: Cin = 3, 4-pixel gathers
    (1, 3, 29, 31, 64, 3, 2, 1),        # VoVNet stem1
    (2, 64, 19, 23, 24, 3, 1, 1),       # Cout below the 64-channel tile
    (1, 160, 13, 11, 160, 3, 1, 1),     # K = 1440, not a multiple of 64
    (2, 64, 17, 25, 256, 1, 1, 0),
    (1, 256, 15, 21, 128, 1, 2, 0),     # stride-2 1x1 (conv1, downsample)
    (1, 48, 9, 9, 16, 1, 1, 0)])        # Cin below a 128-channel slice
def test_int8_conv_kernel(dev, out_dtype, n, cin, h, w, cout, k, stride,
                          padding):
    # the int32 sum is exact and the epilogue rounds as the plain version
    # does, so the outputs are equal bit for bit
    from transcar_tpu_torch.ops import int8

    x, wt = _int8_case(dev, n, cin, h, w, cout, k)
    before = (int8.launches, int8.quantize_launches)
    got = int8.dynamic_int8_conv(x, wt, stride=stride, padding=padding,
                                 out_dtype=out_dtype)
    assert (int8.launches, int8.quantize_launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = _int8_plain(x, wt, stride, padding, out_dtype)
    assert got.shape == want.shape and got.dtype == out_dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,cin,h,w,cout,k,stride,padding", [
    (6, 3, 928, 1600, 64, 7, 2, 3),     # R101 stem
    (6, 64, 232, 400, 64, 3, 1, 1),     # R101 stage 1 conv2
    (6, 256, 232, 400, 128, 1, 2, 0),   # R101 layer2_0 conv1
    (6, 768, 29, 50, 224, 3, 1, 1)])    # VoVNet stage 5 block 0 conv0
def test_int8_conv_kernel_flagship(dev, n, cin, h, w, cout, k, stride,
                                   padding):
    from transcar_tpu_torch.ops import int8

    x, wt = _int8_case(dev, n, cin, h, w, cout, k)
    got = int8.dynamic_int8_conv(x, wt, stride=stride, padding=padding)
    want = _int8_plain(x, wt, stride, padding, torch.bfloat16)
    assert torch.equal(got, want)


def test_int8_conv_kernel_rejects_what_it_does_not_take(dev):
    from transcar_tpu_torch.ops import int8

    x, wt = _int8_case(dev, 1, 16, 9, 9, 8, 3)
    with pytest.raises(ValueError, match="dilation"):
        int8.dynamic_int8_conv(x, wt, padding=2, dilation=2)
    with pytest.raises(ValueError, match="channels-last"):
        xq, s_x = int8.quantize_kernel(x.contiguous())
        int8.conv_kernel(xq, s_x, int8.prepare_weight(wt), padding=1)
    with pytest.raises(ValueError, match="one CUDA device"):
        int8.dynamic_int8_conv(x, wt, padding=1,
                               weight_q=int8.prepare_weight(wt.cpu()))
    with pytest.raises(ValueError, match="5x5"):
        int8.dynamic_int8_conv(x, torch.zeros(8, 16, 5, 5, device=dev))
    # neither tile: Cout % 8 != 0, or 4 < Cin with Cin % 16 != 0
    with pytest.raises(ValueError, match="16 -> 10 channels"):
        int8.dynamic_int8_conv(x, torch.randn(10, 16, 1, 1, device=dev))
    x5, w5 = _int8_case(dev, 1, 5, 9, 9, 8, 3)
    with pytest.raises(ValueError, match="5 -> 8 channels"):
        int8.dynamic_int8_conv(x5, w5, padding=1)
    with pytest.raises(ValueError, match="CUDA"):
        int8.quantize_kernel(x.cpu())


def _int8_affine(dev, cout, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(cout, device=dev, generator=g) * 3 - 1.5,
            torch.randn(cout, device=dev, generator=g))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold,relu", [(False, False), (True, False),
                                       (True, True)])
@pytest.mark.parametrize("n,cin,h,w,cout,k,stride,padding", [
    (2, 64, 19, 23, 64, 3, 1, 1),       # VoVNet stem2, R101 conv2
    (1, 64, 13, 11, 160, 3, 1, 1),      # 160 / 192 / 224: one Cout tile
    (1, 256, 9, 13, 192, 3, 1, 1),
    (1, 160, 10, 9, 224, 3, 2, 1),      # stride 2: four parity maps
    (2, 64, 17, 25, 256, 1, 1, 0),      # the reduce form
    (1, 256, 7, 9, 1024, 1, 1, 0),
    (1, 256, 15, 21, 1024, 1, 2, 0),    # 1x1 stride 2 (conv1, downsample)
    (1, 64, 12, 14, 1024, 3, 1, 1),     # 256-wide Cout slices
    (1, 64, 17, 19, 64, 7, 2, 3),       # 7x7 on the wgmma tile
    (2, 3, 21, 25, 64, 7, 2, 3),        # the stems: the mma.sync tile
    (1, 3, 29, 31, 64, 3, 2, 1)])
def test_int8_conv_epilogue(dev, out_dtype, fold, relu, n, cin, h, w, cout,
                            k, stride, padding):
    # ConvBN's epilogue (FrozenBN's affine, ReLU) with the module's
    # roundings, bit for bit against the plain version; the amax the
    # epilogue takes equals max |out| (twice: the scratch pair it meets
    # in is zero again after each launch)
    from transcar_tpu_torch.ops import int8

    x, wt = _int8_case(dev, n, cin, h, w, cout, k, seed=cout + k)
    wq = int8.prepare_weight(wt)
    xq, s_x = int8.quantize_kernel(x, channels=int8.code_channels(cin))
    affine = _int8_affine(dev, cout, cin) if fold else None
    want = int8.plain_int8_convbn(xq[:, :cin], s_x, wq.q, wq.scale, stride,
                                  padding, 1, out_dtype, affine, relu)
    for _ in range(2):
        before = (int8.launches, int8.wgmma_launches)
        got, amax = int8.conv_kernel(xq, s_x, wq, stride, padding, 1,
                                     out_dtype, affine, relu, want_amax=True)
        assert (int8.launches, int8.wgmma_launches) == (
            before[0] + 1, before[1] + int8.takes_wgmma(cin, cout))
        assert got.dtype == out_dtype and torch.equal(got, want)
        assert amax.item() == want.float().abs().max().item()
    assert int8.takes_wgmma(cin, cout) == (cin != 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stem_codes_take_four_channels(dev, dtype):
    # a stem's image: 4-channel codes, the fourth zero, the rest and the
    # scale those of the plain quantize
    from transcar_tpu_torch.ops import int8

    x, _ = _int8_case(dev, 2, 3, 17, 23, 8, 1, dtype=dtype)
    q, s = int8.quantize_kernel(x, channels=int8.code_channels(3))
    q_ref, s_ref = int8.plain_quantize_per_tensor(x)
    assert q.shape == (2, 4, 17, 23) and q.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(q[:, :3], q_ref) and not q[:, 3].any()
    assert s.item() == s_ref.item()


def test_int8_codes_pass_from_a_given_amax(dev):
    # the codes pass alone (one launch, no amax pass) from an epilogue's
    # amax equals the plain quantize bit for bit
    from transcar_tpu_torch.ops import int8

    x, _ = _int8_case(dev, 2, 64, 13, 17, 8, 1)
    before = (int8.quantize_launches, int8.amax_launches)
    q, s = int8.quantize_kernel(x, int8.plain_amax(x))
    assert (int8.quantize_launches, int8.amax_launches) == (before[0] + 1,
                                                            before[1])
    q_ref, s_ref = int8.plain_quantize_per_tensor(x)
    assert torch.equal(q, q_ref) and s.item() == s_ref.item()
    q, s = int8.quantize_kernel(x)
    assert int8.amax_launches == before[1] + 1
    assert torch.equal(q, q_ref) and s.item() == s_ref.item()


def test_int8_weight_scales_divide_on_the_card(dev):
    # PyTorch's CUDA division by a Python scalar multiplies by the
    # reciprocal; the quantizers divide by a tensor, so the card's scales
    # are the CPU's (and JAX's) bit for bit
    from transcar_tpu_torch.ops import int8

    w = torch.randn(512, 64, 3, 3, generator=torch.Generator().manual_seed(3))
    q, s = int8.quantize_weight_per_channel(w.to(dev))
    q_cpu, s_cpu = int8.quantize_weight_per_channel(w)
    assert torch.equal(s.cpu(), s_cpu) and torch.equal(q.cpu(), q_cpu)


def test_int8_convbn_takes_the_kernel_and_caches_the_codes(dev):
    from transcar_tpu_torch.models.common import ConvBN
    from transcar_tpu_torch.ops import int8

    m = ConvBN(64, 96, 3, padding=1, quantize="int8").to(dev).eval()
    x = torch.randn(2, 64, 20, 30, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    before = int8.launches
    with torch.inference_mode():
        a = m(x)
        b = m(x)
    assert int8.launches == before + 2 and torch.equal(a, b)
    wq = m.__dict__["_int8"][1]
    assert wq.kmajor is not None and wq.kmajor.shape == (96, 576)


# --- the opt-in serving kernels as registered ops ----------------------------

def _counted(module, attr, fn):
    before = getattr(module, attr)
    out = fn()
    return out, getattr(module, attr) - before


def test_int8_ops_equal_their_wrappers(dev):
    # torch.ops.transcar.int8_amax / int8_codes / int8_conv launch the
    # kernels of the bare wrappers, once a call, bit for bit
    from transcar_tpu_torch.ops import int8

    g = torch.Generator(device=dev).manual_seed(21)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    x = cl(torch.randn(2, 32, 13, 17, device=dev, generator=g)).to(
        torch.bfloat16)
    img = cl(torch.randn(1, 3, 19, 23, device=dev, generator=g))
    amax, n = _counted(int8, "amax_launches", lambda: int8.int8_amax(x))
    assert n == 1 and amax.shape == () and torch.equal(
        amax, int8.amax_kernel(x))
    for t, ch in ((x, 32), (img, 4)):
        m = int8.amax_kernel(t)
        (q, s), n = _counted(int8, "quantize_launches",
                             lambda: int8.int8_codes(t, m, ch))
        q_ref, s_ref = int8.codes_kernel(t, m, ch)
        assert n == 1 and torch.equal(q, q_ref) and torch.equal(s, s_ref)
        assert q.stride() == q_ref.stride()
    xq, s_x = int8.quantize_kernel(x)
    for cout, k, stride, pad, out_dtype, fold, want in (
            (48, 3, 1, 1, torch.bfloat16, True, True),
            (64, 1, 2, 0, torch.float32, False, False)):
        wq = int8.prepare_weight(torch.randn(cout, 32, k, k, device=dev,
                                             generator=g) * 0.1)
        aff = _int8_affine(dev, cout, cout) if fold else None
        sc, bi = aff if fold else (None, None)
        (y, m), n = _counted(int8, "launches", lambda: int8.int8_conv(
            xq, s_x, wq.q, wq.scale, wq.kmajor, stride, pad, 1, out_dtype,
            sc, bi, fold, want))
        ref = int8.conv_kernel(xq, s_x, wq, stride, pad, 1, out_dtype, aff,
                               fold, want)
        ref_y, ref_m = ref if want else (ref, None)
        assert n == 1 and torch.equal(y, ref_y)
        assert y.stride() == ref_y.stride()
        assert torch.equal(m, ref_m) if want else m.shape == (0,)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_osa_block_op_equals_its_wrapper(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(22)
    n, h, w, c0, ch, cr = 2, 9, 13, 32, 24, 48
    x = torch.randn(n, h, w, c0, device=dev, generator=g).to(dtype)
    w9s = [torch.randn(3, 3, c, ch, device=dev, generator=g) * 0.1
           for c in (c0, ch, ch)]
    affs = [(torch.rand(ch, device=dev, generator=g) + 0.5,
             torch.randn(ch, device=dev, generator=g)) for _ in w9s]
    rws = pallas_osa.kmajor_weights(
        torch.randn(cr, c0 + 3 * ch, device=dev, generator=g) * 0.1,
        [c0, ch, ch, ch], dtype)
    raff = (torch.rand(cr, device=dev, generator=g) + 0.5,
            torch.randn(cr, device=dev, generator=g))
    wks = [pallas_osa_block.kmajor_conv_weight(w9, dtype) for w9 in w9s]
    (out, sums), k = _counted(pallas_osa_block, "launches", lambda: (
        pallas_osa_block.osa_block(x, w9s, [a[0] for a in affs],
                                   [a[1] for a in affs], rws, *raff, wks)))
    ref, ref_sums = pallas_osa_block.kernel(x, w9s, affs, rws, raff, wks)
    # the output and the channel sums bit for bit: the sums meet in one
    # fixed order
    assert k == 1 and torch.equal(out, ref) and torch.equal(sums, ref_sums)


@pytest.mark.parametrize("downsample", [True, False])
def test_bottleneck_op_equals_its_wrapper(dev, downsample):
    g = torch.Generator(device=dev).manual_seed(23)
    n, h, w, cin, cm = 2, 11, 14, 64, 16
    cout = 64 if not downsample else 96
    r = lambda *s: torch.randn(*s, device=dev, generator=g) * 0.1
    aff = lambda c: (torch.rand(c, device=dev, generator=g) + 0.5, r(c))
    x = r(n, h, w, cin).to(torch.bfloat16)
    w1, w2, w3 = r(cin, cm), r(3, 3, cm, cm), r(cm, cout)
    a1, a2, a3 = aff(cm), aff(cm), aff(cout)
    wd, ad = (r(cin, cout), aff(cout)) if downsample else (None, None)
    ks = pallas_bottleneck.kmajor_weights(w1, w2, w3, wd)
    out, k = _counted(pallas_bottleneck, "launches", lambda: (
        pallas_bottleneck.bottleneck(
            x, w1, *a1, w2, *a2, w3, *a3, wd, *(ad or (None, None)),
            [t for t in ks if t is not None])))
    ref = pallas_bottleneck.kernel(x, w1, a1, w2, a2, w3, a3, wd, ad, ks)
    assert k == 1 and torch.equal(out, ref)


#: A tiny ``transcar_r101`` (ResNet-50 trunk at its widths, 64 × 96
#: images, one decoder layer of 16 queries), as the CPU tests' overrides.
TINY_R50 = ["model.backbone.kind=resnet50",
            "model.backbone.with_dcn=[false,false,false,false]",
            "model.head.num_query=16", "model.head.num_decoder_layers=1",
            "data.img_hw=[64,96]"]


@pytest.mark.parametrize("option", ["model.backbone.quantize=int8",
                                    "model.backbone.block_impl=fused"])
def test_exported_opt_in_program_launches_what_eager_does(dev, option,
                                                         tmp_path):
    # the loaded program equals the live eval step bit for bit and
    # launches exactly its kernels a request: the weights' codes, scales,
    # affines and K-major copies are its state, computed at export
    from transcar_tpu_torch.cli import export
    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.ops import int8
    from transcar_tpu_torch.train.fold import (fold_bn_into_conv,
                                               frozen_bn_names)
    from transcar_tpu_torch.train.step import eval_step

    over = TINY_R50 + [option]
    path = str(tmp_path / "m.pt2")
    export.main(["transcar_r101", "--out", path, "--cfg-options", *over])
    program = torch.export.load(path).module()
    cfg = get_preset("transcar_r101", parse_overrides(over))
    model = build_model(cfg)
    model.load_state_dict(fold_bn_into_conv(model.state_dict(),
                                            frozen_bn_names(model)))
    g = torch.Generator(device=dev).manual_seed(24)
    batch = {k: torch.randn(v.shape, device=dev, generator=g)
             for k, v in export.example_batch(cfg, 1, dev).items()}
    counters = (
        (int8, "launches"), (int8, "quantize_launches"),
        (int8, "amax_launches"), (pallas_bottleneck, "launches"),
        (pallas_bottleneck, "wgmma_launches"), (pallas_attention,
                                                "launches"))
    read = lambda: [getattr(m, a) for m, a in counters]
    with torch.inference_mode():
        eval_step(model, batch, cfg)            # warm the eager caches
        before = read()
        want = eval_step(model, batch, cfg)
        mid = read()
        got = program(batch)
        after = read()
    eager = [b - a for a, b in zip(before, mid)]
    assert [b - a for a, b in zip(mid, after)] == eager
    assert eager[0 if "int8" in option else 3] > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- the Hungarian matching (csrc/hungarian.cu) -------------------------------

#: (P, Q, G, gt counts, costs): ``chip_smoke.py``'s problems and ragged
#: ones: fewer queries than threads, more gts than queries (the backstops:
#: unmatched real slots keep −1, as the JAX solver returns), more gt slots
#: than threads.
HUNGARIAN_CASES = [c[1:] for c in chip_smoke.HUNGARIAN_CASES] + [
    (2, 37, 5, (5, 3), "uniform"), (2, 3, 8, (8, 2), "integer"),
    (1, 1000, 300, (300,), "uniform")]


@pytest.mark.parametrize("seed", range(len(HUNGARIAN_CASES)))
def test_hungarian_kernel_is_the_plain_version_bit_for_bit(dev, seed):
    p, q, g, counts, kind = HUNGARIAN_CASES[seed]
    cost = chip_smoke._hungarian_costs(
        torch.Generator(device=dev).manual_seed(seed), p, q, g, kind)
    n = torch.tensor(counts, dtype=torch.int32, device=dev)
    scans = [torch.zeros(p, dtype=torch.int32, device=dev) for _ in "kp"]
    before = hungarian.launches
    got = hungarian.hungarian_match(cost, n)
    assert hungarian.launches == before + 1
    mk, vk = hungarian.kernel(cost, n, scans=scans[0])
    mp, vp = hungarian.hungarian_match_plain(cost, n, scans=scans[1])
    torch.cuda.synchronize()
    for a, b in ((got[0], mk), (got[1], vk), (mk, mp), (vk, vp),
                 (scans[0], scans[1])):
        assert torch.equal(a, b)
    if q >= max(counts):                 # every real slot can be matched
        shape_ok, _, opt_ok = chip_smoke._optimum_gap(cost, counts, mk)
        assert shape_ok and opt_ok
    else:
        assert (mk[0, q:] == -1).all() and (mk[0, :q] < q).all()


def test_hungarian_kernel_makes_no_host_sync(dev):
    cost = torch.rand(6, 900, 32, device=dev)
    n = torch.tensor([7, 7, 7, 7, 7, 0], dtype=torch.int32, device=dev)
    want = hungarian.hungarian_match(cost, n)                # warmup
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hungarian.hungarian_match(cost, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
