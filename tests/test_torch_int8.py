"""The int8 serving mode of the port (``ops/int8.py``, ``ConvBN`` /
``Bottleneck`` / ``OSABlock`` / the detector with ``quantize="int8"``,
``build_model``) against the JAX package (``transcar_tpu/ops/int8.py``) on
the CPU.

The same seeded numpy inputs and weights go through both; the port's
wrappers take their plain versions for CPU tensors (the CUDA kernels are
held against those in tests/test_torch_cuda.py and ``chip_smoke.py``).
The quantizers and the convolution are compared bit for bit with the JAX
functions run op by op (as tests/test_int8.py runs them): both sides
divide in float32, round half to even, sum the codes exactly and form
``s_x · s_w`` before the dequantizing product.  Under ``jax.jit`` XLA's
algebraic simplifier rewrites the two scales (``max / 127`` becomes
``max · (1/127)``, and ``(max_x / 127) · (max_w / 127)`` becomes
``max_w · (max_x · (1/16129))``), which moves a scale by an ulp; so the
jitted oracles of the module tests differ from the port by that, and
those tests state their tolerances.  Each module oracle is jitted once.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.geom import camera_ring_l2i
from tests.test_torch_model import _random_params
from transcar_tpu.core import config as jconfig
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.models.resnet import Bottleneck as JaxBottleneck
from transcar_tpu.models.vovnet import OSABlock as JaxOSABlock
from transcar_tpu.ops import int8 as jint8
from transcar_tpu_torch.core import config as pconfig
from transcar_tpu_torch.models.common import ConvBN
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.models.resnet import Bottleneck
from transcar_tpu_torch.models.vovnet import OSABlock
from transcar_tpu_torch.ops import int8
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.fold import fold_bn_into_conv, frozen_bn_names

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def t(a):
    return torch.from_numpy(np.asarray(a))


def nchw(a):
    return t(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(x):
    return x.permute(0, 2, 3, 1).float().numpy()


def _load(module, params):
    module.load_state_dict(from_jax_params(params), strict=True)
    return module.eval()


def _case_input(case, rng):
    if case == "ties":
        # amax 127, so s = 1 exactly and every half-integer is a tie that
        # only round-half-to-even decides (exact in bfloat16 too)
        return (np.arange(-254, 255, dtype=np.float32) * 0.5).reshape(
            1, 1, 509, 1)
    return (rng.normal(size=(2, 9, 11, 16)) * 3).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["normal", "ties"])
def test_quantizers_match_jax_bit_for_bit(dtype, case):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = _case_input(case, rng)
    jq, js = jint8.quantize_per_tensor(jnp.asarray(x, jdt))
    q, s = int8.quantize_per_tensor(nchw(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jq))
    assert s.item() == float(js)
    k = (rng.normal(size=(3, 3, 16, 12)) * 0.1).astype(np.float32)
    k[:, :, :, 0] = x.reshape(-1)[:144].reshape(3, 3, 16)   # ties too
    jqk, jsk = jint8.quantize_weight_per_channel(jnp.asarray(k, jdt))
    qk, sk = int8.quantize_weight_per_channel(t(k).permute(3, 2, 0, 1)
                                              .to(tdt))
    np.testing.assert_array_equal(qk.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jqk))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))


def _jax_conv(stride, padding, out_dtype):
    return functools.partial(jint8.dynamic_int8_conv, stride=stride,
                             padding=padding, out_dtype=out_dtype)


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                              (1, 2, 0), (7, 2, 3)])
def test_dynamic_int8_conv_matches_jax_bit_for_bit(k, stride, padding):
    # the stem's 7×7 on Cin = 3 and odd image sizes, so stride 2 meets
    # both parities; float32 and bfloat16 outputs (one rounding each)
    rng = np.random.default_rng(k * 10 + stride)
    cin = 3 if k == 7 else 16
    x = rng.normal(size=(2, 13, 17, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, 24)) / np.sqrt(k * k * cin)).astype(
        np.float32)
    for name in DTYPES:
        tdt, jdt = DTYPES[name]
        ref = _jax_conv(stride, padding, jdt)(jnp.asarray(x), jnp.asarray(w))
        got = int8.dynamic_int8_conv(nchw(x), t(w).permute(3, 2, 0, 1),
                                     stride=stride, padding=padding,
                                     out_dtype=tdt)
        assert got.dtype == tdt and int8.launches == 0
        np.testing.assert_array_equal(nhwc(got),
                                      np.asarray(ref, np.float32))
    # the jitted JAX function: its scale product rounds differently (see
    # the module docstring), within 3 float32 ulps of the port
    ref = jax.jit(_jax_conv(stride, padding, jnp.float32))(
        jnp.asarray(x), jnp.asarray(w))
    got = int8.dynamic_int8_conv(nchw(x), t(w).permute(3, 2, 0, 1),
                                 stride=stride, padding=padding)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=3.6e-7,
                               atol=0)


def test_int8_is_exact_for_representable_values():
    # JAX tests/test_int8.py: integers with |max| = 127 have scales of
    # exactly 1, so the int8 conv is the integer conv, bit for bit
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (1, 8, 8, 16)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0
    k = rng.integers(-127, 128, (3, 3, 16, 8)).astype(np.float32)
    k[0, 0, 0, :] = 127.0
    want = torch.nn.functional.conv2d(
        nchw(x).double(), t(k).permute(3, 2, 0, 1).double(), padding=1)
    got = int8.dynamic_int8_conv(nchw(x), t(k).permute(3, 2, 0, 1),
                                 padding=1, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.float().numpy())
    ref = _jax_conv(1, 1, jnp.float32)(jnp.asarray(x), jnp.asarray(k))
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))


def test_positive_scale_invariance():
    # x · 7.5 keeps every code and scales s_x, so the output scales by
    # 7.5 up to the float32 rounding of the two scale products
    rng = np.random.default_rng(2)
    x = nchw(rng.normal(size=(1, 10, 12, 8)).astype(np.float32))
    w = t(rng.normal(size=(8, 8, 3, 3)).astype(np.float32))
    q1, s1 = int8.quantize_per_tensor(x)
    q2, s2 = int8.quantize_per_tensor(x * 7.5)
    assert torch.equal(q1, q2)
    y1 = int8.dynamic_int8_conv(x, w, padding=1)
    y2 = int8.dynamic_int8_conv(x * 7.5, w, padding=1)
    np.testing.assert_allclose(y2.numpy(), y1.numpy() * 7.5, rtol=1e-5,
                               atol=1e-5)


def test_convbn_int8_keeps_the_float_state_dict():
    fp = ConvBN(16, 24, 3, padding=1)
    q = ConvBN(16, 24, 3, padding=1, quantize="int8")
    sd = fp.state_dict()
    assert {k: v.shape for k, v in q.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    q.load_state_dict(sd, strict=True)
    x = torch.randn(1, 16, 8, 8, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        y_fp, y_q = fp(x), q(x)
    # the same float weights drive both (JAX tests/test_int8.py's bound)
    assert (y_q - y_fp).norm() / y_fp.norm() < 0.05
    # the codes are cached per weight version and rebuilt on a change
    hit = q.__dict__["_int8"][1]
    with torch.no_grad():
        q(x)
        assert q.__dict__["_int8"][1] is hit
        q.conv.weight.mul_(2.0)
        q(x)
    assert q.__dict__["_int8"][1] is not hit
    with pytest.raises(ValueError, match="quantize"):
        ConvBN(16, 24, quantize="int4")


def _max_rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_bottleneck_int8_matches_jax():
    # stride 2 with the downsample: conv1 and the downsample carry the
    # stride.  The jitted oracle's scales sit an ulp from the port's (see
    # the module docstring) and each side applies FrozenBN in its own
    # float32 order, so the outputs differ by float32 ulps (measured
    # 1.0e-7 of the output range; no code moved).  A code moved by one at
    # a tie would show as ~1e-3 of the range, so 1e-4 bounds the ulps
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 12, 16, 64)).astype(np.float32)
    jblk = JaxBottleneck(planes=16, stride=2, downsample=True,
                         quantize="int8")
    params = _random_params(lambda key: jblk.init(key, jnp.asarray(x)),
                            seed=5)
    ref = np.asarray(jax.jit(jblk.apply)(params, jnp.asarray(x)))
    port = _load(Bottleneck(64, 16, stride=2, downsample=True,
                            quantize="int8"), params)
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    assert _max_rel(out, ref) <= 1e-4


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_osa_block_int8_matches_jax(impl):
    # the K4 tail (JAX's Pallas kernel in interpret mode against the
    # port's plain version) quantizes the chain only; the xla tail also
    # the concat reduce.  Tolerance as for the bottleneck (measured
    # 1.2e-7 and 1.0e-7)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    kw = dict(stage_ch=16, concat_ch=32, layer_per_block=3, identity=True)
    jblk = JaxOSABlock(reduce_impl=impl, interpret=True, quantize="int8",
                       **kw)
    params = _random_params(lambda key: JaxOSABlock(**kw).init(
        key, jnp.asarray(x)), seed=6)
    ref = np.asarray(jax.jit(jblk.apply)(params, jnp.asarray(x)))
    port = _load(OSABlock(32, reduce_impl=impl, quantize="int8", **kw),
                 params)
    assert port.concat.quantize == ("int8" if impl == "xla" else "none")
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    assert _max_rel(out, ref) <= 1e-4


def test_fold_then_quantize_agrees_with_unfolded_int8():
    # evaluate() folds the frozen-BN scales into the convs, then the int8
    # weight codes are taken from the folded weights.  A per-channel
    # symmetric scale commutes with the fold's per-channel factor, also a
    # negative one (the codes and the scale change sign together), up to
    # the float rounding of w·γ/σ, which could move a code at a tie:
    # measured 1.2e-7 of the output range (no code moved), bounded at 1e-4
    # as in the module tests
    rng = np.random.default_rng(7)
    x = nchw(rng.normal(size=(1, 12, 16, 64)).astype(np.float32))
    blk = Bottleneck(64, 16, downsample=True, quantize="int8").eval()
    with torch.no_grad():
        for name, buf in blk.named_buffers():
            if name.endswith("bn.weight"):
                buf.copy_(t(rng.uniform(-1.5, 1.5, buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(t(rng.uniform(0.5, 1.5, buf.shape)))
            elif name.endswith(("running_mean", "bn.bias")):
                buf.copy_(t(rng.normal(size=buf.shape) * 0.1))
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())) * 0.1)
        want = blk(x).numpy()
        blk.load_state_dict(fold_bn_into_conv(blk.state_dict(),
                                              frozen_bn_names(blk)))
        got = blk(x).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _tiny_cfgs(*extra):
    over = pconfig.parse_overrides(
        ["model.backbone.kind=resnet50", "model.head.num_cams=2",
         "model.head.num_query=16", "model.head.num_decoder_layers=1",
         "model.head.num_radar_tokens=40", "model.use_grid_mask=false",
         *extra])
    return (pconfig.get_preset("transcar_r101", over),
            jconfig.get_preset("transcar_r101", over))


def test_build_model_resolves_quantize():
    cfg, _ = _tiny_cfgs("model.backbone.quantize=int8")
    model = build_model(cfg, device="cpu")
    bb = model.backbone
    modes = [m.quantize for m in bb.modules() if isinstance(m, ConvBN)]
    # R50, DCN in stages 3-4: stem + 16 conv1 + 16 conv3 + 4 downsample +
    # 7 non-DCN conv2; the 9 DCN conv2 are not ConvBNs
    assert modes.count("int8") == 44 == len(modes)
    assert bb.stem.quantize == "int8"
    trained = build_model(cfg, device="cpu", training=True)
    assert {m.quantize for m in trained.modules()
            if isinstance(m, ConvBN)} == {"none"}
    # the phase stem (the same function, a TPU form) stays out of int8
    phase, _ = _tiny_cfgs("model.backbone.quantize=int8",
                          "model.backbone.stem_impl=phase")
    assert build_model(phase, device="cpu").backbone.stem.quantize == "none"
    bad, _ = _tiny_cfgs("model.backbone.quantize=int4")
    with pytest.raises(ValueError, match="quantize"):
        build_model(bad, device="cpu")


def test_tiny_r50_detector_int8_matches_jax():
    # the whole camera detector in float32 with int8 backbone convs.  The
    # jitted JAX oracle's scales sit an ulp from the port's (see the
    # module docstring), and the float ops between the convs (FrozenBN,
    # the DCN's bilinear taps) round in each framework's order, so a few
    # activation codes land one step apart at a tie, and the random-weight
    # head carries that to a few queries.  Measured: 13 of the 16 queries
    # within 4e-6 (relative to 1 + |ref|), the other 3 at 7e-3 to 1.6e-2;
    # so 3/4 of the queries within 1e-5 and every one within 5e-2
    cfg, jcfg = _tiny_cfgs("model.backbone.quantize=int8")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone,
                                                compute_dtype=None)))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, backbone=dataclasses.replace(jcfg.model.backbone,
                                                 compute_dtype=None)))
    rng = np.random.default_rng(8)
    b, n, h, w, q, tk = 1, 2, 64, 96, 16, 40
    images = rng.normal(size=(b, n, h, w, 3)).astype(np.float32)
    l2i = camera_ring_l2i(n, h, w)[None]
    radar = np.full((b, tk, 36), 500.0, np.float32)
    radar[0, :20] = rng.normal(size=(20, 36)).astype(np.float32)
    radar[0, :20, 0:2] = rng.uniform(-3, 3, (20, 2))
    jmodel = jbuild_model(jcfg)
    assert jmodel.backbone_quantize == "int8"
    inputs = (images, l2i, radar)
    params = _random_params(lambda k: jmodel.init(k, *inputs), seed=8)
    ref = jax.jit(jmodel.apply)(params, *map(jnp.asarray, inputs))
    model = _load(build_model(cfg, device="cpu"), params)
    with torch.no_grad():
        out = model(*map(t, inputs))
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, r = out[key].numpy(), np.asarray(ref[key])
        assert a.shape == r.shape and np.isfinite(a).all()
        per_query = (np.abs(a - r) / (1 + np.abs(r))).max(axis=(0, 3))
        assert np.quantile(per_query, 0.75) <= 1e-5, key
        assert per_query.max() <= 5e-2, key
