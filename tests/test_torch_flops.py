"""``cli/get_flops.py`` and the flop formulas of the registered ops
(``tests/test_tools.py``'s get_flops test for the port):

  * the CLI at tiny camera and LiDAR sizes, on the meta device: positive
    GFLOPs, the input shape, the kernels' share, and ``params_m`` equal to
    what the JAX CLI reports (the leaves of the flax ``params`` tree, from
    ``jax.eval_shape``: no compile);
  * each op's flop formula, read by ``FlopCounterMode``, equal to the
    shared count of ``ops/counts.py`` that ``chip_smoke.py``'s bounds
    read (the int8 conv, K5 and K6 too);
  * the opt-in serving configurations (int8, ``osa_reduce_impl=fused``,
    ``block_impl=fused``) count, through their ops, the total of their
    default twins, whose arithmetic they repeat;
  * ``params_m`` of every other model at its full widths equal to JAX's.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tests.test_torch_data import TINY
from transcar_tpu.core import config as jconfig
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu_torch.cli import get_flops
from transcar_tpu_torch.core.config import get_preset, parse_overrides
from transcar_tpu_torch.ops import (counts, int8, pallas_attention,
                                    pallas_bottleneck, pallas_dcn,
                                    pallas_msdeform, pallas_osa,
                                    pallas_osa_block)

CAMERA = ["model.head.with_radar_fusion=false", *TINY]


def _jax_params_m(preset, over, hw=None):
    """What the JAX ``get_flops`` prints as ``params_m``."""
    cfg = jconfig.get_preset(preset, parse_overrides(over))
    model = jbuild_model(cfg)
    if cfg.model.lidar_encoder:
        args = (np.zeros((1, cfg.data.max_points, 5), np.float32),
                np.zeros((1,), np.int32))
    else:
        n = cfg.model.head.num_cams
        h, w = hw or cfg.data.img_hw
        args = (np.zeros((1, n, h, w, 3), np.float32),
                np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1)),
                np.zeros((1, cfg.model.head.num_radar_tokens, 36),
                         np.float32)
                if cfg.model.head.with_radar_fusion else None)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *args))["params"]
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes))
    return round(n_params / 1e6, 2)


@pytest.mark.parametrize("preset,over,want_input,ops", [
    ("detr3d_r101", CAMERA + ["model.backbone.with_dcn="
                              "[false,false,true,true]"],
     [1, 6, 64, 96, 3], {"dcn_forward"}),
    ("objdgcnn_pillar", TINY, [1, 2500, 5], {"msdeform_forward"}),
])
def test_get_flops_cli(preset, over, want_input, ops, capsys):
    get_flops.main([preset, "--height", "64", "--width", "96",
                    "--cfg-options", *over])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["preset"] == preset and rec["input"] == want_input
    assert rec["gflops"] > 0 and rec["bytes_accessed_gb"] is None
    assert set(rec["kernel_gflops"]) == ops
    assert rec["params_m"] == _jax_params_m(preset, over, (64, 96))


def _flops(fn):
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn()
    return counter.get_total_flops()


def test_each_op_counts_the_shared_count():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 16, generator=g)
    om = torch.randn(2, 5, 6, 27, generator=g)
    w = torch.randn(3, 3, 16, 24, generator=g)
    assert _flops(lambda: pallas_dcn.fused_deform_conv(x, om, w)) \
        == counts.dcn_forward(2, 5, 6, 16, 24)
    qh = torch.randn(1, 8, 7, 32, generator=g)
    kh = torch.randn(1, 8, 11, 32, generator=g)
    keep = torch.rand(1, 7, 11, generator=g) > 0.5
    assert _flops(lambda: pallas_attention.masked_attention(
        qh, kh, kh, keep)) == counts.masked_attention(1, 8, 7, 11, 32)
    pieces = [torch.randn(2, 3, 4, c, generator=g) for c in (8, 16, 24)]
    ws = [torch.randn(c, 40, generator=g) for c in (8, 16, 24)]
    assert _flops(lambda: pallas_osa.osa_reduce(
        pieces, ws, torch.ones(40), torch.zeros(40))) \
        == counts.osa_reduce(2, 3, 4, (8, 16, 24), 40)
    shapes = ((4, 4), (2, 2))
    value = torch.randn(1, 20, 2, 8, generator=g)
    loc = torch.rand(1, 6, 2, 2, 3, 2, generator=g)
    wgt = torch.rand(1, 6, 2, 2, 3, generator=g)
    assert _flops(lambda: pallas_msdeform.ms_deform_attn(
        value, shapes, loc, wgt)) == counts.msdeform_forward(wgt.numel(), 8)
    xc = torch.randn(2, 16, 9, 11, generator=g)
    wc = torch.randn(24, 16, 3, 3, generator=g)
    assert _flops(lambda: int8.dynamic_int8_conv(xc, wc, stride=2,
                                                 padding=1)) \
        == counts.int8_conv(2, 5, 6, 16, 24, 3, 3)
    aff = lambda c: (torch.ones(c), torch.zeros(c))
    x = torch.randn(2, 5, 6, 16, generator=g)
    w9s = [torch.randn(3, 3, 16, 8, generator=g),
           torch.randn(3, 3, 8, 8, generator=g)]
    rws = [torch.randn(c, 24, generator=g) for c in (16, 8, 8)]
    assert _flops(lambda: pallas_osa_block.osa_block_fused(
        x, w9s, [aff(8), aff(8)], rws, aff(24))) \
        == counts.osa_block(2, 5, 6, 16, 8, 2, 24)
    for wd in (None, torch.randn(16, 32, generator=g)):
        cout = 16 if wd is None else 32
        assert _flops(lambda: pallas_bottleneck.bottleneck_fused(
            x, torch.randn(16, 8, generator=g), aff(8), w9s[1], aff(8),
            torch.randn(8, cout, generator=g), aff(cout), wd,
            None if wd is None else aff(cout))) \
            == counts.bottleneck(2, 5, 6, 16, 8, cout, wd is not None)


@functools.lru_cache(maxsize=None)
def _default_count(preset: str) -> dict:
    return get_flops.count_flops(get_preset(preset), 64, 96)


@pytest.mark.parametrize("preset,option,op", [
    ("transcar_r101", "model.backbone.quantize=int8", "int8_conv"),
    ("transcar_vovnet_trainval", "model.backbone.osa_reduce_impl=fused",
     "osa_block"),
    ("transcar_r101", "model.backbone.block_impl=fused", "bottleneck"),
])
def test_opt_in_configurations_count_as_their_twins(preset, option, op):
    """int8 serving, the fused OSA block and the fused bottleneck do their
    default twin's arithmetic, so ``get_flops`` counts the same total,
    with the op's share named (the camera presets at their own widths, a
    small image)."""
    twin = _default_count(preset)
    rec = get_flops.count_flops(
        get_preset(preset, parse_overrides([option])), 64, 96)
    assert rec["gflops"] == twin["gflops"] > 0
    assert rec["kernel_gflops"][op] > 0 and op not in twin["kernel_gflops"]


@pytest.mark.parametrize("preset", ["transcar_r101",
                                    "transcar_vovnet_trainval",
                                    "objdgcnn_voxel"])
def test_params_m_at_full_width_equals_jax(preset):
    """The ``state_dict`` entries the JAX tree holds, counted on the meta
    device at the preset's own widths (small inputs, which hold no
    parameter, keep the JAX trace short), for the models the CLI test
    does not build at their widths: R101 with radar fusion (of which
    ``detr3d_r101`` is the camera part, and ``transcar_r101_cbgs`` the
    same model with another sampler and schedule), VoVNet-99 and the
    voxel encoder (the pillar model is the CLI test's at full widths)."""
    from transcar_tpu_torch.models.detector import build_model

    small = ["data.img_hw=[64,96]", "data.max_points=2500"]
    with torch.device("meta"):
        model = build_model(get_preset(preset, parse_overrides(small)),
                            device="meta")
    got = round(get_flops.param_count(model) / 1e6, 2)
    assert got == _jax_params_m(preset, small)
    assert get_preset("transcar_r101_cbgs").model == \
        get_preset("transcar_r101").model
