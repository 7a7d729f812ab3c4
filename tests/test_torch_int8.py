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


# --- ConvBN's epilogue and the quantize threading (plain versions) ------------

def _bn_buffers(bn, rng, folded=False):
    c = bn.weight.shape[0]
    with torch.no_grad():
        if folded:                # train/fold.py leaves weight 1, var 1 - eps
            bn.weight.fill_(1.0)
            bn.running_var.fill_(1.0 - bn.eps)
            bn.running_mean.zero_()
        else:
            bn.weight.copy_(t(rng.uniform(-1.5, 1.5, c).astype(np.float32)))
            bn.running_var.copy_(t(rng.uniform(0.5, 1.5, c).astype(
                np.float32)))
            bn.running_mean.copy_(t(rng.normal(size=c).astype(np.float32)))
        bn.bias.copy_(t(rng.normal(size=c).astype(np.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_epilogue_plain_equals_relu_bn_dequant(dtype, folded, relu):
    # the epilogue's plain version repeats the module's eager roundings:
    # equal bit for bit to F.relu(FrozenBN(plain_int8_conv(...))), and
    # ConvBN's int8 path (the affine cached) to the same composition
    from transcar_tpu_torch.models.common import FrozenBN

    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(9)
    x = nchw(rng.normal(size=(2, 9, 11, 16)).astype(np.float32)).to(tdt)
    m = ConvBN(16, 24, 3, padding=1, relu=relu, quantize="int8").eval()
    _bn_buffers(m.bn, rng, folded)
    with torch.no_grad():
        m.conv.weight.copy_(t(rng.normal(size=(24, 16, 3, 3)).astype(
            np.float32) * 0.1))
    xq, s_x = int8.plain_quantize_per_tensor(x)
    wq, s_w = int8.quantize_weight_per_channel(m.conv.weight)
    bn = FrozenBN(24)
    bn.load_state_dict(m.bn.state_dict())
    want = bn(int8.plain_int8_conv(xq, s_x, wq, s_w, 1, 1, 1, tdt))
    want = torch.nn.functional.relu(want) if relu else want
    got = int8.plain_int8_convbn(xq, s_x, wq, s_w, 1, 1, 1, tdt,
                                 m.bn.affine(), relu)
    assert got.dtype == tdt and torch.equal(got, want)
    with torch.no_grad():
        y, amax = m.pair(x, want_amax=True)
        assert torch.equal(m(x), want) and torch.equal(y, want)
    assert amax.dtype == torch.float32 and amax.item() == \
        want.float().abs().max().item()


def test_codes_pass_given_the_amax_equals_the_plain_quantize():
    rng = np.random.default_rng(10)
    for x in (nchw(_case_input("normal", rng)),
              nchw(_case_input("ties", rng)).to(torch.bfloat16)):
        q, s = int8.plain_quantize_per_tensor(x)
        q2, s2 = int8.quantize_per_tensor(x, int8.plain_amax(x))
        assert torch.equal(q, q2) and s.item() == s2.item()


def _count_quantizes(monkeypatch):
    """Records, for each activation codes pass (the ``int8_codes`` op),
    whether its amax came with it (True, from a conv's epilogue) rather
    than from an amax pass (the ``int8_amax`` op) run for it (False)."""
    calls, amax_pass = [], []
    amax_op, codes_op = int8.int8_amax, int8.int8_codes

    def counting_amax(x):
        amax_pass.append(True)
        return amax_op(x)

    def counting_codes(x, amax, channels):
        calls.append(not amax_pass)
        amax_pass.clear()
        return codes_op(x, amax, channels)

    monkeypatch.setattr(int8, "int8_amax", counting_amax)
    monkeypatch.setattr(int8, "int8_codes", counting_codes)
    return calls


def test_bottleneck_quantizes_its_input_once(monkeypatch):
    # conv1 and the downsample share one quantize of x; conv2 and conv3
    # run their codes pass from the amax of the previous epilogue; the
    # result is that of quantizing every conv's input on its own
    rng = np.random.default_rng(11)
    x = nchw(rng.normal(size=(1, 8, 10, 32)).astype(np.float32))
    blk = Bottleneck(32, 8, stride=2, downsample=True, quantize="int8").eval()
    for p in blk.parameters():
        p.data.copy_(t(rng.normal(size=p.shape).astype(np.float32) * 0.2))
    with torch.no_grad():
        want = torch.nn.functional.relu(
            blk.conv3(blk.conv2(blk.conv1(x))) + blk.downsample(x))
        calls = _count_quantizes(monkeypatch)
        got = blk(x)
    assert calls == [False, True, True] and torch.equal(got, want)
    dcn = Bottleneck(32, 8, with_dcn=True, quantize="int8").eval()
    with torch.no_grad():
        calls.clear()
        dcn(x)
    assert calls == [False, False]        # conv1, conv3 after the DCN


def test_osa_chain_passes_the_amax_on(monkeypatch):
    # chain convs 1-3 quantize from the amax of the conv before them
    rng = np.random.default_rng(12)
    x = nchw(rng.normal(size=(1, 6, 8, 32)).astype(np.float32))
    blk = OSABlock(32, 16, 32, 4, reduce_impl="pallas",
                   quantize="int8").eval()
    with torch.no_grad():
        want = [x]
        for i in range(4):
            want.append(getattr(blk, f"conv{i}")(want[-1]))
        calls = _count_quantizes(monkeypatch)
        got = [x]
        for i in range(4):
            y, amax = getattr(blk, f"conv{i}").pair(got[-1], want_amax=True)
            got.append(y)
            assert amax.item() == y.abs().max().item()
        calls.clear()
        blk(x)
    assert calls == [False, True, True, True]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k,stride,padding", [(7, 2, 3), (3, 2, 1)])
def test_stem_weight_layout_matches_its_four_channel_gather(k, stride,
                                                            padding):
    # a stem's K-major codes (Cin = 3, codes padded to 4 channels, each
    # kernel row padded to 4 taps) against the rows the tile gathers: for
    # each output pixel, each kernel row's kwp adjacent pixels of 4 codes
    # (zero outside the image); their product is the conv, exactly
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 3, 11, 13))).to(
        torch.int8)
    q = torch.from_numpy(rng.integers(-127, 128, (8, 3, k, k))).to(
        torch.int8)
    assert int8.code_channels(3) == 4
    wk = int8.kmajor_codes(q)
    kwp = -(-k // 4) * 4
    x4 = torch.nn.functional.pad(x.double(), (padding, padding + kwp - k,
                                              padding, padding, 0, 1))
    n, _, hp, wp = x4.shape
    ho = (x.shape[2] + 2 * padding - k) // stride + 1
    wo = (x.shape[3] + 2 * padding - k) // stride + 1
    rows = [x4[:, :, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(kwp)]
    a = torch.stack(rows, 1).permute(0, 3, 4, 1, 2).reshape(n * ho * wo, -1)
    got = a @ wk[:, :a.shape[1]].double().t()
    want = torch.nn.functional.conv2d(x.double(), q.double(), stride=stride,
                                      padding=padding)
    assert wk.shape == (8, -(-k * kwp * 4 // 64) * 64)
    assert not wk[:, a.shape[1]:].any()
    assert torch.equal(got, want.permute(0, 2, 3, 1).reshape(got.shape))
