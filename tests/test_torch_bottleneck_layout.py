"""K6's K-major weights and the ResNet bottleneck's cache of them, on the CPU.

The Hopper tile of ``csrc/osa_wgmma.cuh`` runs K6 (``csrc/bottleneck.cu``)
as three launches over K-major bfloat16 weights: conv1 [Cm, Cin] and conv3
[Cout, Cm] (+ the downsample [Cout, Cin] into a second accumulator) on its
reduce form, conv2 [Cm, 3, 3, Cm] on its 3×3 form, each walking K in
64-channel slices zero-filled past the width.  These tests walk the
bottleneck that way over ``pallas_bottleneck.kmajor_weights`` and hold it
to ``plain_bottleneck``, at widths that are no multiple of 64, and hold
``models/resnet.Bottleneck``'s cache of the copies to its parameters after
in-place updates.
"""
import numpy as np
import pytest
import torch

from transcar_tpu_torch.models.resnet import Bottleneck
from transcar_tpu_torch.ops import pallas_bottleneck

SLICE = 64


def _walk(a, wk):
    """Σ over 64-channel slices of a[:, slice] @ wk[:, slice]ᵀ in float32,
    both zero-filled past the width: the reduce form's K walk.  a: [P, C];
    wk: [Cout, C]."""
    pad = -a.shape[-1] % SLICE
    a = torch.nn.functional.pad(a.float(), (0, pad))
    wk = torch.nn.functional.pad(wk.float(), (0, pad))
    acc = torch.zeros(a.shape[0], wk.shape[0])
    for c0 in range(0, a.shape[-1], SLICE):
        acc += a[:, c0:c0 + SLICE] @ wk[:, c0:c0 + SLICE].t()
    return acc


def _walk3x3(x, wk):
    """conv2 as the 3×3 form walks it: each tap's window of the
    zero-padded input (the 4-D TMA box) times wk[:, tap] by slices."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = 0
    for ky in range(3):
        for kx in range(3):
            acc = acc + _walk(xp[:, ky:ky + h, kx:kx + w].reshape(-1, c),
                              wk[:, ky, kx])
    return acc


def _tile_order(x, ks, affs, affd):
    """K6 over K-major copies ``ks`` in the tile's order: each conv's
    affine (and ReLU) in float32 on its accumulator, h1 and h2 rounded to
    x's dtype, the downsample in its own accumulator with its own affine,
    the identity read in float32, one rounding of the output."""
    n, h, w, cin = x.shape
    dtype = x.dtype
    x2d = x.reshape(-1, cin)
    aff = lambda acc, a: acc * a[0] + a[1]
    h1 = torch.relu(aff(_walk(x2d, ks[0]), affs[0])).to(dtype)
    h2 = torch.relu(aff(_walk3x3(h1.reshape(n, h, w, -1), ks[1]), affs[1]))
    h3 = aff(_walk(h2.to(dtype), ks[2]), affs[2])
    ident = (x2d.float() if ks[3] is None
             else aff(_walk(x2d, ks[3]), affd))
    return torch.relu(h3 + ident).to(dtype).reshape(n, h, w, -1)


def _case(rng, cin, cm, cout, ds):
    k = lambda *s: torch.from_numpy(
        (rng.normal(size=s) / np.sqrt(np.prod(s[:-1]))).astype(np.float32))
    a = lambda c: (torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                   torch.from_numpy(rng.normal(size=c).astype(np.float32)
                                    * 0.1))
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, cin)).astype(np.float32))
    ws = (k(1, 1, cin, cm), k(3, 3, cm, cm), k(1, 1, cm, cout),
          k(1, 1, cin, cout) if ds else None)
    return x, ws, (a(cm), a(cm), a(cout)), (a(cout) if ds else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cm,cout,ds", [
    (40, 24, 72, True),                         # downsample, ragged slices
    (72, 16, 72, False),                        # identity
])
def test_kmajor_weights_give_the_plain_bottleneck(dtype, cin, cm, cout, ds):
    rng = np.random.default_rng(0)
    x, ws, affs, affd = _case(rng, cin, cm, cout, ds)
    x = x.to(dtype)
    ks = pallas_bottleneck.kmajor_weights(*ws, dtype=dtype)
    shapes = [(cm, cin), (cm, 3, 3, cm), (cout, cm),
              (cout, cin) if ds else None]
    for got, shape in zip(ks, shapes):
        assert (got is None) == (shape is None)
        if got is not None:
            assert got.shape == shape and got.dtype == dtype
            assert got.is_contiguous()
    assert torch.equal(ks[1].permute(1, 2, 3, 0), ws[1].to(dtype))
    got = _tile_order(x, ks, affs, affd)
    kw = dict(wd=ws[3], affd=affd) if ds else {}
    ref = pallas_bottleneck.plain_bottleneck(
        x, ws[0], affs[0], ws[1], affs[1], ws[2], affs[2], **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max() <= (
        tol * ref.float().abs().max())


def test_wgmma_tile_shape_rules():
    z = lambda c, dt=torch.bfloat16: torch.zeros(1, 2, 2, c, dtype=dt)
    assert pallas_bottleneck.takes_wgmma_tile(z(64), 64, 256)
    assert not pallas_bottleneck.takes_wgmma_tile(z(12), 16, 40)     # Cin % 8
    assert not pallas_bottleneck.takes_wgmma_tile(z(64), 12, 40)     # Cm % 8
    assert not pallas_bottleneck.takes_wgmma_tile(z(64), 16, 36)     # Cout % 8
    assert not pallas_bottleneck.takes_wgmma_tile(z(64, torch.float32),
                                                  64, 256)


def _kmajor_of(block, dtype):
    """The K-major copies made afresh from the block's parameters."""
    mat = lambda conv: conv.conv.weight.detach()[:, :, 0, 0].to(dtype)
    return (mat(block.conv1), block.conv2.conv.weight.detach()
            .permute(0, 2, 3, 1).to(dtype), mat(block.conv3),
            mat(block.downsample) if hasattr(block, "downsample") else None)


@pytest.mark.parametrize("downsample", [True, False])
def test_bottleneck_caches_its_kmajor_weights(downsample):
    torch.manual_seed(5)
    block = Bottleneck(32 if downsample else 64, 16, downsample=downsample,
                       impl="fused").eval()
    first = block._kmajor(torch.bfloat16)
    assert block._kmajor(torch.bfloat16) is first             # cached
    for got, want in zip(first, _kmajor_of(block, torch.bfloat16)):
        assert (got is None and want is None) or torch.equal(got, want)
    convs = [block.conv1, block.conv2, block.conv3] + (
        [block.downsample] if downsample else [])
    for conv in convs:
        with torch.no_grad():
            conv.conv.weight.mul_(-1.5)                       # in place
        second = block._kmajor(torch.bfloat16)
        assert second is not first
        for got, want in zip(second, _kmajor_of(block, torch.bfloat16)):
            assert (got is None and want is None) or torch.equal(got, want)
        first = second
    with torch.no_grad():
        block.conv2.conv.weight.copy_(torch.randn_like(
            block.conv2.conv.weight))                         # a state load
    assert torch.equal(block._kmajor(torch.bfloat16)[1],
                       _kmajor_of(block, torch.bfloat16)[1])
    assert block._kmajor(torch.float32)[0].dtype == torch.float32


def test_fused_bottleneck_follows_weight_updates():
    """The block's K6 path (the plain version on the CPU) against its
    plain layers, before and after in-place updates of its weights."""
    torch.manual_seed(6)
    ref = Bottleneck(24, 8, downsample=True).eval()
    blk = Bottleneck(24, 8, downsample=True, impl="fused").eval()
    blk.load_state_dict(ref.state_dict())
    x = torch.randn(1, 24, 5, 7)
    with torch.no_grad():
        for _ in range(2):
            torch.testing.assert_close(blk(x), ref(x), rtol=1e-5, atol=1e-5)
            for m in (ref, blk):
                m.conv2.conv.weight.mul_(0.5)
                m.downsample.conv.weight.mul_(-1.5)
