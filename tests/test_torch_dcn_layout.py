"""K1's and K5's K-major weights and the modules' caches of them, on the CPU.

The Hopper tiles of ``csrc/dcn_forward.cu`` (K1) and ``csrc/osa_wgmma.cuh``
(K5's chain convs) read their 3×3 weights K-major, [Cout, 3, 3, Cin], one
64-channel slice of one tap at a time, with the slice past Cin filled with
zeros.  These tests walk the product that way over the K-major copies
(``pallas_dcn.kmajor_weight``, ``pallas_osa_block.kmajor_conv_weight``) and
hold it to the plain versions, at a Cin that is no multiple of 64, and hold
the modules' caches (``models/resnet.DCNConv``, ``models/vovnet.OSABlock``)
to their parameters after in-place updates.
"""
import numpy as np
import pytest
import torch

from transcar_tpu_torch.models.resnet import DCNConv
from transcar_tpu_torch.models.vovnet import OSABlock
from transcar_tpu_torch.ops import pallas_dcn, pallas_osa_block
from transcar_tpu_torch.ops.dcn import modulated_deform_conv

SLICE = 64


def _slice_walk(a, wk):
    """Σ over taps and 64-channel slices of a[..., tap, slice] @ wk[:, tap,
    slice]ᵀ in float32, both zero-filled past Cin: the kernels' K walk.
    a: [P, 9, Cin]; wk: [Cout, 3, 3, Cin]."""
    cin = a.shape[-1]
    pad = -cin % SLICE
    a = torch.nn.functional.pad(a.float(), (0, pad))
    wk = torch.nn.functional.pad(wk.float().reshape(wk.shape[0], 9, cin), (0, pad))
    acc = torch.zeros(a.shape[0], wk.shape[0])
    for k in range(9):
        for c0 in range(0, cin + pad, SLICE):
            acc += a[:, k, c0:c0 + SLICE] @ wk[:, k, c0:c0 + SLICE].t()
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(40, 24), (64, 16)])
def test_dcn_kmajor_weight_gives_the_plain_product(dtype, cin, cout):
    rng = np.random.default_rng(0)
    n, h, w = 1, 4, 5
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    om = torch.from_numpy(rng.normal(size=(n, h, w, 27)).astype(np.float32))
    om[..., :18] *= 3.0
    wt = torch.from_numpy(rng.normal(size=(3, 3, cin, cout))
                          .astype(np.float32) / (9 * cin) ** 0.5)
    x, om = x.to(dtype), om.to(dtype)
    wk = pallas_dcn.kmajor_weight(wt, dtype)
    assert wk.shape == (cout, 3, 3, cin) and wk.dtype == dtype
    assert wk.is_contiguous()
    assert torch.equal(wk.permute(1, 2, 3, 0), wt.to(dtype))
    # the modulated samples, rounded to dtype: the plain version with an
    # identity weight (one nonzero product per output, exact)
    eye = torch.eye(9 * cin).reshape(3, 3, cin, 9 * cin)
    sampled = modulated_deform_conv(x, om, eye).reshape(-1, 9, cin)
    got = _slice_walk(sampled, wk)
    ref = modulated_deform_conv(x, om, wt.to(dtype)).reshape(-1, cout)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.to(dtype).float() - ref.float()).abs().max() <= (
        tol * ref.float().abs().max())


def test_dcn_wgmma_tile_shape_rules():
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)
    assert pallas_dcn.takes_wgmma_tile(z(1, 4, 4, 40), z(3, 3, 40, 72))
    assert not pallas_dcn.takes_wgmma_tile(z(1, 4, 4, 12), z(3, 3, 12, 8))
    assert not pallas_dcn.takes_wgmma_tile(z(1, 4, 4, 16), z(3, 3, 16, 12))
    assert not pallas_dcn.takes_wgmma_tile(z(1, 4, 4, 64, dt=torch.float32),
                                           z(3, 3, 64, 64))


def test_dcn_conv_caches_its_kmajor_weight():
    torch.manual_seed(0)
    conv = DCNConv(16, 24, impl="pallas")
    torch.nn.init.normal_(conv.weight)
    w = conv.weight
    first = conv._weight_kmajor(torch.bfloat16)
    assert conv._weight_kmajor(torch.bfloat16) is first       # cached
    assert torch.equal(first, pallas_dcn.kmajor_weight(
        w.detach().permute(2, 3, 1, 0)))
    with torch.no_grad():
        w.mul_(-2.0)                                          # in place
    second = conv._weight_kmajor(torch.bfloat16)
    assert second is not first and torch.equal(
        second, w.detach().permute(0, 2, 3, 1).bfloat16())
    with torch.no_grad():
        w.copy_(torch.randn_like(w))                          # a state load
    assert torch.equal(conv._weight_kmajor(torch.bfloat16),
                       w.detach().permute(0, 2, 3, 1).bfloat16())
    assert conv._weight_kmajor(torch.float32).dtype == torch.float32
    with torch.inference_mode():                              # rebuilt once
        inf = conv._weight_kmajor(torch.float32)
        assert conv._weight_kmajor(torch.float32) is inf


@pytest.mark.parametrize("cin,ch", [(40, 24), (72, 16)])
def test_osa_chain_kmajor_weight_gives_the_plain_product(cin, ch):
    rng = np.random.default_rng(1)
    n, h, w = 2, 3, 5
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    w9 = torch.from_numpy(rng.normal(size=(3, 3, cin, ch)).astype(np.float32)
                          / (9 * cin) ** 0.5)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, ch).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=ch).astype(np.float32) * 0.1)
    wk = pallas_osa_block.kmajor_conv_weight(w9, torch.float32)
    assert wk.shape == (ch, 3, 3, cin) and wk.is_contiguous()
    # each tap's window of the zero-padded input: what the 4-D TMA box
    # loads at (n, i - 1 + ky, j - 1 + kx, c0)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([xp[:, ky:ky + h, kx:kx + w] for ky in range(3)
                        for kx in range(3)], 3).reshape(-1, 9, cin)
    got = torch.relu(_slice_walk(taps, wk) * s + b).reshape(n, h, w, ch)
    ref = pallas_osa_block.conv3x3_affine_relu(x, w9, (s, b))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_osa_block_wgmma_tile_shape_rules():
    z = lambda c, dt=torch.bfloat16: torch.zeros(1, 2, 2, c, dtype=dt)
    assert pallas_osa_block.takes_wgmma_tile(z(128), 160, 512)
    assert not pallas_osa_block.takes_wgmma_tile(z(20), 16, 40)      # C0 % 8
    assert not pallas_osa_block.takes_wgmma_tile(z(128), 12, 40)     # Ch % 8
    assert not pallas_osa_block.takes_wgmma_tile(z(128, torch.float32),
                                                 160, 512)


def test_osa_block_caches_its_chain_kmajor_weights():
    torch.manual_seed(2)
    block = OSABlock(32, 24, 40, 2, reduce_impl="fused").eval()
    first = block._chain_kmajor(torch.bfloat16)
    assert block._chain_kmajor(torch.bfloat16) is first       # cached
    w1 = block.conv1.conv.weight
    with torch.no_grad():
        w1.mul_(0.5)                                          # one conv, in place
    second = block._chain_kmajor(torch.bfloat16)
    assert second is not first
    for got, conv in zip(second, (block.conv0, block.conv1)):
        assert torch.equal(got, conv.conv.weight.detach().permute(0, 2, 3, 1)
                           .bfloat16())
    assert block._chain_kmajor(torch.float32)[0].dtype == torch.float32


def test_osa_block_fused_path_follows_weight_updates():
    """The block's K5 path (the plain version on the CPU, over the cached
    K-major reduce views) against its plain concat + conv path, before and
    after an in-place update of a chain and the reduce weight."""
    torch.manual_seed(3)
    ref = OSABlock(16, 24, 40, 2, reduce_impl="xla").eval()
    blk = OSABlock(16, 24, 40, 2, reduce_impl="fused").eval()
    blk.load_state_dict(ref.state_dict())
    x = torch.randn(1, 16, 5, 7)
    with torch.no_grad():
        for _ in range(2):
            torch.testing.assert_close(blk(x), ref(x), rtol=1e-5, atol=1e-5)
            for m in (ref, blk):
                m.concat.conv.weight.mul_(0.5)
                m.conv1.conv.weight.mul_(-1.5)
