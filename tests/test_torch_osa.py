"""K4's K-major weights and the OSA block's cache of them, on the CPU.

The Hopper tile of ``csrc/osa_reduce.cu`` reads each weight split as a
K-major view of one [Cout, ΣCᵢ] tensor (``pallas_osa.kmajor_weights``),
which ``models/vovnet.OSABlock`` caches per parameter version.  These
tests hold the plain product over those views to the plain product over
contiguous splits, at widths that are no multiple of the tile's 64-wide K
slice (160, 224), and the cache to the parameter after in-place updates.
"""
import numpy as np
import pytest
import torch

from transcar_tpu_torch.models.vovnet import OSABlock
from transcar_tpu_torch.ops import pallas_osa

WIDTHS = [128, 160, 224]


def _case(dtype, cout=96, seed=0):
    rng = np.random.default_rng(seed)
    pieces = [torch.from_numpy(rng.normal(size=(2, 5, 7, c))
                               .astype(np.float32)).to(dtype) for c in WIDTHS]
    weight = torch.from_numpy(rng.normal(size=(cout, sum(WIDTHS), 1, 1))
                              .astype(np.float32) / sum(WIDTHS) ** 0.5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32) * 0.1)
    return pieces, weight, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmajor_views_give_the_plain_product(dtype):
    pieces, weight, scale, bias = _case(dtype)
    views = pallas_osa.kmajor_weights(weight, WIDTHS, dtype)
    total = sum(WIDTHS)
    for v, c in zip(views, WIDTHS):
        assert v.shape == (c, weight.shape[0]) and v.dtype == dtype
        assert v.stride() == (1, total)          # K-major: rows of ΣCᵢ
    splits = list(torch.split(weight[:, :, 0, 0].t().to(dtype).contiguous(),
                              WIDTHS, 0))
    got = pallas_osa.osa_reduce(pieces, views, scale, bias)
    ref = pallas_osa.plain_osa_reduce(pieces, splits, scale, bias)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert pallas_osa.takes_wgmma_tile(pieces, weight.shape[0]) == (
        dtype == torch.bfloat16)


def test_wgmma_tile_shape_rules():
    x = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16)
    odd = torch.zeros(1, 2, 2, 13, dtype=torch.bfloat16)
    assert pallas_osa.takes_wgmma_tile([x, x], 16)
    assert not pallas_osa.takes_wgmma_tile([x, odd], 16)      # C % 8
    assert not pallas_osa.takes_wgmma_tile([x], 12)           # Cout % 8
    assert not pallas_osa.takes_wgmma_tile([x.float()], 16)   # float32


def test_osa_block_caches_its_kmajor_weights():
    torch.manual_seed(0)
    block = OSABlock(128, 160, 96, 2, reduce_impl="pallas").eval()
    w = block.concat.conv.weight
    first = block._reduce_kmajor(torch.bfloat16)
    assert block._reduce_kmajor(torch.bfloat16) is first      # cached
    with torch.no_grad():
        w.mul_(-2.0)                                          # in place
    second = block._reduce_kmajor(torch.bfloat16)
    assert second is not first
    want = pallas_osa.kmajor_weights(w, block.widths, torch.bfloat16)
    for a, b in zip(second, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        w.copy_(torch.randn_like(w))                          # a state load
    third = block._reduce_kmajor(torch.bfloat16)
    assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(
        third, torch.split(w[:, :, 0, 0].t(), block.widths, 0)))
    assert block._reduce_kmajor(torch.float32)[0].dtype == torch.float32


def test_osa_block_pallas_path_follows_weight_updates():
    """The block's K4 path (the plain version on the CPU) against its
    plain concat + conv path, before and after an in-place update."""
    torch.manual_seed(1)
    ref = OSABlock(64, 160, 96, 2, reduce_impl="xla").eval()
    blk = OSABlock(64, 160, 96, 2, reduce_impl="pallas").eval()
    blk.load_state_dict(ref.state_dict())
    x = torch.randn(1, 64, 6, 9)
    with torch.no_grad():
        for _ in range(2):
            torch.testing.assert_close(blk(x), ref(x), rtol=1e-5, atol=1e-5)
            for m in (ref, blk):
                m.concat.conv.weight.mul_(0.5)
