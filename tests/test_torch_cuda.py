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

from transcar_tpu_torch.ops import dcn, pallas_attention, pallas_dcn
from transcar_tpu_torch.ops.attention import attention_core

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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


@pytest.mark.parametrize("b,nq,nt", [(2, 150, 200), (1, 33, 1)])
def test_masked_attention_kernel(dev, b, nq, nt):
    g = torch.Generator(device=dev).manual_seed(1)
    qh, kh, vh = (torch.randn(b, 8, n, 32, device=dev, generator=g)
                  for n in (nq, nt, nt))
    keep = torch.rand(b, nq, nt, device=dev, generator=g) < 0.3
    keep[:, 0] = True
    keep[:, -1] = False
    out = pallas_attention.masked_attention(qh, kh, vh, keep)
    ref = attention_core(qh, kh, vh, ~keep)
    gate = keep.any(-1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.transpose(1, 2)[gate],
                               ref.transpose(1, 2)[gate],
                               rtol=2e-4, atol=2e-4)
