"""The VoVNet-99 slice of the port (K4, K5, K6 and their modules) against
the JAX package, on the CPU.

The same seeded numpy inputs and weights go through ``transcar_tpu``
(Pallas kernels in interpret mode, as tests/test_pallas_osa.py,
test_pallas_osa_block.py and test_pallas_bottleneck.py run them) and
through ``transcar_tpu_torch``, whose kernel wrappers take their plain
versions for CPU tensors; the CUDA kernels themselves are held against
those plain versions in tests/test_torch_cuda.py and ``chip_smoke.py``.
The JAX models run under ``jax.jit``: at these sizes one compile of the
whole unrolled V-99 (about 4 s on the CPU) is faster than the first call
of its eager ops, each of which compiles on its own (about 10 s).  One
seeded parameter tree of the tiny ``transcar_vovnet_trainval`` detector
(full-width V-99, FPN and head, 2 cameras, 16 queries, 1 decoder layer)
serves every detector, backbone and bridge test.  Float32 throughout
unless a test says otherwise, at 1e-4.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.geom import camera_ring_l2i
from tests.test_torch_model import _random_params
from transcar_tpu.core import config as jcfg
from transcar_tpu.models import TransCARDetector as JaxDetector
from transcar_tpu.models.resnet import ResNet as JaxResNet
from transcar_tpu.models.vovnet import OSABlock as JaxOSABlock
from transcar_tpu.models.vovnet import VoVNet as JaxVoVNet
from transcar_tpu.ops.pallas_bottleneck import bottleneck_fused as jbottleneck
from transcar_tpu.ops.pallas_osa import osa_reduce as josa_reduce
from transcar_tpu.ops.pallas_osa_block import osa_block_fused as josa_block
from transcar_tpu_torch.cli import benchmark
from transcar_tpu_torch.core import config as pcfg
from transcar_tpu_torch.core.config import parse_overrides
from transcar_tpu_torch.data.synthetic import fake_batch
from transcar_tpu_torch.models.detector import (TransCARDetector, build_model,
                                                resolve_block_impl,
                                                resolve_osa_reduce_impl)
from transcar_tpu_torch.models.resnet import ResNet
from transcar_tpu_torch.models.vovnet import OSABlock, VoVNet
from transcar_tpu_torch.ops import pallas_bottleneck, pallas_osa, \
    pallas_osa_block
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.step import init_state, train_step

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def nchw(a):
    return t(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _affine(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32))


def _load(module, params):
    module.load_state_dict(from_jax_params(params), strict=True)
    return module.eval()


# --- K4: osa_reduce -----------------------------------------------------------

@pytest.mark.parametrize("relu", [True, False])
def test_osa_reduce_matches_jax(relu):
    # mixed piece widths (stage-3 style), as tests/test_pallas_osa.py
    rng = np.random.default_rng(0)
    n, h, w, cs, cout = 2, 8, 24, [32, 16, 16, 16], 64
    pieces = [rng.normal(size=(n, h, w, c)).astype(np.float32) for c in cs]
    ws = [(rng.normal(size=(c, cout)) * 0.1).astype(np.float32) for c in cs]
    scale, bias = _affine(rng, cout)
    ref, ref_sums = josa_reduce([jnp.asarray(p) for p in pieces],
                                [jnp.asarray(x) for x in ws], scale, bias,
                                relu=relu, rows_per_step=64, interpret=True)
    before = pallas_osa.launches
    out, sums = pallas_osa.osa_reduce([t(p) for p in pieces],
                                      [t(x) for x in ws], t(scale), t(bias),
                                      relu=relu, rows_per_step=64)
    assert pallas_osa.launches == before      # the CPU takes the plain version
    assert out.dtype == torch.float32 and sums.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # sums of 192 pixels: relative to their size
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-4,
                               atol=1e-4 * np.abs(ref_sums).max())
    if relu:
        assert (out >= 0).all()


def test_kernel_wrappers_are_forward_only():
    x = torch.ones(1, 2, 3, 4, requires_grad=True)
    w = torch.ones(4, 8)
    ones = torch.ones(8)
    with pytest.raises(RuntimeError, match="forward-only"):
        pallas_osa.osa_reduce([x], [w], ones, ones)
    with torch.no_grad():
        out, sums = pallas_osa.osa_reduce([x], [w], ones, ones)
    assert out.shape == (1, 2, 3, 8) and sums.shape == (1, 8)


# --- K5: osa_block_fused -------------------------------------------------------

def test_osa_block_fused_matches_jax():
    # tests/test_pallas_osa_block.py's shapes, whole image
    rng = np.random.default_rng(0)
    n, h, w, c0, ch, cr, nconv = 2, 10, 12, 24, 16, 32, 3
    x = rng.normal(size=(n, h, w, c0)).astype(np.float32)
    conv_ws, conv_affs, cin = [], [], c0
    for _ in range(nconv):
        conv_ws.append((rng.normal(size=(3, 3, cin, ch)) * 0.15)
                       .astype(np.float32))
        conv_affs.append(_affine(rng, ch))
        cin = ch
    red_ws = [(rng.normal(size=(c, cr)) * 0.1).astype(np.float32)
              for c in [c0] + [ch] * nconv]
    raff = _affine(rng, cr)
    ref, ref_sums = josa_block(
        jnp.asarray(x), [jnp.asarray(k) for k in conv_ws],
        [tuple(map(jnp.asarray, a)) for a in conv_affs],
        [jnp.asarray(k) for k in red_ws], tuple(map(jnp.asarray, raff)),
        interpret=True)
    before = pallas_osa_block.launches
    out, sums = pallas_osa_block.osa_block_fused(
        t(x), [t(k) for k in conv_ws], [tuple(map(t, a)) for a in conv_affs],
        [t(k) for k in red_ws], tuple(map(t, raff)))
    assert pallas_osa_block.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-4,
                               atol=1e-4 * np.abs(ref_sums).max())


# --- K6: bottleneck_fused ------------------------------------------------------

@pytest.mark.parametrize("identity", [True, False])
def test_bottleneck_fused_matches_jax(identity):
    # tests/test_pallas_bottleneck.py's shapes
    rng = np.random.default_rng(0 if identity else 1)
    n, h, w, planes = 2, 12, 16, 8
    cin, cout = (planes * 4 if identity else planes), planes * 4
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    k = lambda *s: (rng.normal(size=s) / np.sqrt(np.prod(s[:-1]))).astype(
        np.float32)
    args = [k(1, 1, cin, planes), _affine(rng, planes),
            k(3, 3, planes, planes), _affine(rng, planes),
            k(1, 1, planes, cout), _affine(rng, cout)]
    kw = {} if identity else dict(wd=k(1, 1, cin, cout),
                                  affd=_affine(rng, cout))
    jx = lambda a: (tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                    else jnp.asarray(a))
    ref = jbottleneck(jnp.asarray(x), *map(jx, args),
                      **{key: jx(v) for key, v in kw.items()},
                      interpret=True)
    px = lambda a: tuple(map(t, a)) if isinstance(a, tuple) else t(a)
    out = pallas_bottleneck.bottleneck_fused(
        t(x), *map(px, args), **{key: px(v) for key, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --- OSABlock and V-99 -----------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_osa_block_module_matches_jax(impl):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    kw = dict(stage_ch=16, concat_ch=32, layer_per_block=3, identity=True)
    jblk = JaxOSABlock(reduce_impl="xla", **kw)
    params = _random_params(lambda key: jblk.init(key, jnp.asarray(x)),
                            seed=1)
    # the JAX module's own impl (Pallas in interpret mode) as reference
    ref = JaxOSABlock(reduce_impl=impl, interpret=True, **kw).apply(
        params, jnp.asarray(x))
    port = _load(OSABlock(32, reduce_impl=impl, **kw), params)
    with torch.no_grad():
        out = port(nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_vovnet99_matches_jax(vov_case):
    # 2 images of 66 × 98: stage 2 at 17 × 25, odd sizes, so the
    # ceil-mode pools of stages 3-5 meet both parities (8 × 12, 4 × 6,
    # 2 × 3); the port's default inference tail (K4's plain version)
    # against the JAX plain layers, float32
    x = np.random.default_rng(2).normal(size=(2, 66, 98, 3)).astype(
        np.float32)
    params = {"params": vov_case[0]["params"]["backbone"]}
    ref = jax.jit(JaxVoVNet(compute_dtype=None).apply)(params, x)
    port = _load(VoVNet(compute_dtype=None, reduce_impl="pallas"), params)
    with torch.no_grad():
        outs = port(nchw(x))
    assert [tuple(o.shape[2:]) for o in outs] == [(17, 25), (8, 12), (4, 6),
                                                 (2, 3)]
    for a, b in zip(outs, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), b,
                                   rtol=1e-4, atol=1e-4 * np.abs(b).max())


# --- the transcar_vovnet_trainval detector ---------------------------------------

B, N, H, W, Q, T = 1, 2, 64, 96, 16, 40
TINY = [f"model.head.num_cams={N}", f"model.head.num_query={Q}",
        "model.head.num_decoder_layers=1", f"model.head.num_radar_tokens={T}",
        "model.use_grid_mask=false"]


def _vov_cfg(module, compute_dtype=None):
    cfg = module.get_preset("transcar_vovnet_trainval", parse_overrides(TINY))
    bb = dataclasses.replace(cfg.model.backbone, compute_dtype=compute_dtype)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=bb))


@pytest.fixture(scope="module")
def vov_case():
    """Seeded inputs, two views of the images, and seeded random params of
    the tiny JAX detector (shapes only from ``jax.eval_shape``)."""
    rng = np.random.default_rng(3)
    images = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    augs = np.stack([images, images[..., ::-1, :] * 0.5])     # [A=2, ...]
    l2i = camera_ring_l2i(N, H, W)[None]
    radar = np.full((B, T, 36), 500.0, np.float32)
    radar[0, :20] = rng.normal(size=(20, 36)).astype(np.float32)
    radar[0, :20, 0:2] = rng.uniform(-3, 3, (20, 2))
    cfg = _vov_cfg(jcfg).model
    params = _random_params(
        lambda k: JaxDetector(cfg).init(k, images, l2i, radar), seed=3)
    return params, (images, l2i, radar), augs


def _detector_pair(vov_case, compute_dtype):
    params, inputs, _ = vov_case
    jmodel = JaxDetector(_vov_cfg(jcfg, compute_dtype).model)
    ref = jax.jit(jmodel.apply)(params, *inputs)
    port = _load(TransCARDetector(_vov_cfg(pcfg, compute_dtype).model,
                                  osa_reduce_impl="pallas"), params)
    with torch.no_grad():
        out = port(*map(t, inputs))
    return [(k, out[k].numpy(), np.asarray(ref[k]))
            for k in ("all_cls_scores", "all_bbox_preds")]


def test_vovnet_detector_fp32(vov_case):
    for key, a, b in _detector_pair(vov_case, None):
        assert a.shape == b.shape == (3, B, Q, 10) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **TOL, err_msg=key)


def test_vovnet_detector_bf16(vov_case):
    # bfloat16 backbone + FPN: the port's K4 plain version rounds once
    # after the float32 affine where the JAX plain layers round the conv
    # and then the BN, so the levels differ by bf16 ulps; the per-query
    # tolerance of tests/test_torch_model.py::test_slice_bf16
    for key, a, b in _detector_pair(vov_case, "bfloat16"):
        per_query = (np.abs(a - b) / (1 + np.abs(b))).max(axis=(0, 3))
        assert np.quantile(per_query, 0.9) <= 5e-2, key
        assert per_query.max() <= 0.3, key


def test_aug_forward_matches_jax(vov_case):
    params, (_, l2i, radar), augs = vov_case
    jmodel = JaxDetector(_vov_cfg(jcfg).model)
    ref = jax.jit(lambda *a: jmodel.apply(
        *a, method=JaxDetector.aug_forward))(params, augs, l2i, radar)
    port = _load(TransCARDetector(_vov_cfg(pcfg).model,
                                  osa_reduce_impl="pallas"), params)
    with torch.no_grad():
        out = port.aug_forward(t(augs), t(l2i), t(radar))
        single = port(t(augs[0]), t(l2i), t(radar))
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   **TOL, err_msg=key)
    # the second view moves the result: the average is not a no-op
    assert not torch.allclose(out["all_bbox_preds"], single["all_bbox_preds"])


def test_strict_load_of_the_vovnet_tree(vov_case):
    # the transcar_vovnet_trainval detector at full backbone width:
    # stem{1,2,3}, stage{s}_block{b}.conv{i} / .concat ConvBNs, ese.fc
    params = vov_case[0]
    sd = from_jax_params(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    model = build_model(_vov_cfg(pcfg, "bfloat16"), device="cpu")
    res = model.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    p = params["params"]["backbone"]
    np.testing.assert_array_equal(
        model.backbone.stage4_block8.ese.fc.weight.detach().numpy(),
        p["stage4_block8"]["ese"]["fc"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.backbone.stage5_block2.concat.conv.weight.detach().numpy(),
        p["stage5_block2"]["concat"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert model.backbone.stage2_block0.reduce_impl == "pallas"


# --- K6 in the ResNet --------------------------------------------------------------

def test_resnet50_fused_blocks_match_jax():
    # tests/test_pallas_bottleneck.py's model-level case: every stride-1
    # block (the port drops the TPU's VMEM gate) against the JAX fused
    # model in interpret mode and against the port's plain layers
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 48, 64, 3)).astype(np.float32)
    kw = dict(depth=50, with_dcn=(False, False, False, False),
              compute_dtype=None)
    jnet = JaxResNet(out_indices=(2, 3), remat=False, **kw)
    params = jax.tree_util.tree_map(
        lambda a: a * 0.5, _random_params(
            lambda key: jnet.init(key, jnp.asarray(x)), seed=4))
    ref = JaxResNet(out_indices=(2, 3), remat=False, block_impl="fused",
                    dcn_interpret=True, **kw).apply(params, jnp.asarray(x))
    port = _load(ResNet(block_impl="fused", **kw), params)
    plain = _load(ResNet(**kw), params)
    fused = [n for names in port.block_names for n in names
             if getattr(port, n).fused]
    assert len(fused) == 16 - 3          # all but the 3 stride-2 blocks
    with torch.no_grad():
        outs, plain_outs = port(nchw(x)), plain(nchw(x))
    for a, p, b in zip(outs[2:], plain_outs[2:], ref):
        b = np.asarray(b)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), b,
                                   rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)


def test_block_impl_on_the_flagship_layout():
    # transcar_r101 with block_impl=fused: K6 in the 6 stride-1 non-DCN
    # blocks; "auto" keeps the plain layers, as in JAX
    cfg = pcfg.get_preset("transcar_r101", {
        "model.backbone.kind": "resnet50", "model.head.num_query": 16,
        "model.backbone.block_impl": "fused"})
    assert resolve_block_impl(cfg) == "fused"
    model = build_model(cfg, device="cpu")
    fused = [n for names in model.backbone.block_names for n in names
             if getattr(model.backbone, n).fused]
    assert fused == ["layer1_0", "layer1_1", "layer1_2", "layer2_1",
                     "layer2_2", "layer2_3"]
    auto = pcfg.get_preset("transcar_r101")
    assert resolve_block_impl(auto) == "xla"
    vov = pcfg.get_preset("transcar_vovnet_trainval")
    assert resolve_osa_reduce_impl(vov) == "pallas"
    assert resolve_osa_reduce_impl(vov, training=True) == "xla"


# --- entry points --------------------------------------------------------------

def test_build_model_defaults_to_the_card(monkeypatch):
    cfg = pcfg.get_preset("detr3d_r101", {"model.backbone.kind": "resnet50",
                                          "model.head.num_query": 16})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


TINY_CLI = ["--device", "cpu", "--samples", "1", "--warmup", "1",
            "--height", "64", "--width", "96", "--cfg-options",
            f"model.head.num_cams={N}", "model.head.num_query=16",
            "model.head.num_decoder_layers=1",
            "model.head.num_radar_tokens=40"]


def test_cli_vovnet_cpu(capsys):
    benchmark.main(["transcar_vovnet_trainval"] + TINY_CLI)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["preset"] == "transcar_vovnet_trainval"
    assert rec["dcn_taps_past_5px"] is None          # no DCN in VoVNet
    assert set(rec["kernel_launches"].values()) == {0}   # plain on the CPU
    assert rec["samples_per_sec"] > 0


def test_vovnet_fusion_only_train_step():
    cfg = pcfg.get_preset("transcar_vovnet_trainval", parse_overrides(TINY))
    model = build_model(cfg, device="cpu", training=True, dropout=0.0)
    assert all(getattr(model.backbone, n).reduce_impl == "xla"
               for names in model.backbone.block_names for n in names)
    state = init_state(cfg, model, total_steps=10)
    assert state.stop_camera_grad
    batch = fake_batch(np.random.default_rng(5), B, N, H, W, T)
    batch = {k: t(v) for k, v in batch.items()}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = train_step(state, batch)
    assert torch.isfinite(losses["total"])
    camera = ("backbone.", "neck.", "head.decoder", "head.query_embedding",
              "head.reference_points")
    moved = {n: not torch.equal(p.detach(), p0[n])
             for n, p in model.named_parameters()}
    assert not any(v for n, v in moved.items() if n.startswith(camera))
    assert any(v for n, v in moved.items() if n.startswith("head.fusion"))
