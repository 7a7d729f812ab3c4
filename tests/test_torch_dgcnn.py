"""The ObjDGCNN pillar slice of the port (K7's plain version and every
module on the serving path) against the JAX package, on the CPU.

The same seeded numpy inputs and weights go through ``transcar_tpu`` and
``transcar_tpu_torch``; the port's K7 wrapper takes its plain version for
CPU tensors, and the CUDA kernel itself is held against that plain
version in tests/test_torch_cuda.py and ``chip_smoke.py``.  Shapes are
those of tests/test_dgcnn.py: pc_range ±8 m, 0.5 m pillars, a 32 × 32
BEV, 256 pillars of 8 points.  One seeded flax tree (shapes from
``jax.eval_shape``, no init compute) with non-zero MSDeformAttn offset
and weight kernels and non-identity BN statistics serves every
whole-model test; each JAX forward runs once under ``jax.jit`` in a
module-scoped fixture.  Float32 at 1e-4 unless a test says otherwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_model import _random_params
from transcar_tpu.core.config import HeadConfig as JaxHeadConfig
from transcar_tpu.models import dgcnn as jdgcnn
from transcar_tpu.models.second import BNFPN as JaxBNFPN
from transcar_tpu.models.second import SECOND as JaxSECOND
from transcar_tpu.ops.msdeform import ms_deform_attn_core as jax_core
from transcar_tpu.ops.pallas_msdeform import pallas_msdeform_encoder
from transcar_tpu.ops.voxelize import hard_voxelize as jax_voxelize
from transcar_tpu.ops.voxelize import pillar_scatter as jax_scatter
from transcar_tpu_torch.cli import benchmark
from transcar_tpu_torch.core.config import HeadConfig, get_preset
from transcar_tpu_torch.data.synthetic import fake_points
from transcar_tpu_torch.eval.decode import nms_free_decode
from transcar_tpu_torch.models import dgcnn
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.models.second import BNFPN, SECOND
from transcar_tpu_torch.ops import pallas_msdeform
from transcar_tpu_torch.ops.msdeform import ms_deform_attn_core
from transcar_tpu_torch.ops.voxelize import hard_voxelize, pillar_scatter
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

PC = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VS = (0.5, 0.5, 6.0)
BEV = (32, 32)
MAX_POINTS, MAX_VOXELS = 8, 256
TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def _load(module, variables):
    module.load_state_dict(from_jax_params(variables), strict=True)
    return module.eval()


def _head_cfg(cls, num_query=24, layers=2):
    return cls(num_query=num_query, num_decoder_layers=layers,
               with_radar_fusion=False, num_levels=4, pc_range=PC)


def _clouds():
    """Two clouds of 700 slots: the first spread over the range with some
    points outside it, the second packed into a few pillars (more than 8
    points each) plus a spread that fills more than 256 pillars."""
    rng = np.random.default_rng(0)
    pts = np.zeros((2, 700, 5), np.float32)
    pts[0, :, :3] = rng.uniform(-9, 9, (700, 3))
    pts[0, :, 2] = rng.uniform(-2.5, 2.5, 700)
    pts[1, :300, :2] = rng.uniform(-1, 1, (300, 2))
    pts[1, 300:, :2] = rng.uniform(-8, 8, (400, 2))
    pts[1, :, 2] = rng.uniform(-2.9, 2.9, 700)
    pts[:, :, 3:] = rng.normal(size=(2, 700, 2))
    return pts, np.array([150, 680], np.int32)


# --- (a) voxelization and scatter --------------------------------------------

def test_hard_voxelize_and_scatter_match_jax():
    pts, num = _clouds()
    ref = jax.vmap(lambda p, n: jax_voxelize(p, n, VS, PC, MAX_POINTS,
                                             MAX_VOXELS))(jnp.asarray(pts),
                                                          jnp.asarray(num))
    got = hard_voxelize(t(pts), t(num), VS, PC, MAX_POINTS, MAX_VOXELS)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    voxels, coords, counts, nv = got
    # both overflows happen: full pillars, and more pillars than slots
    assert counts.max() == MAX_POINTS and int(nv[1]) == MAX_VOXELS
    assert 0 < int(nv[0]) < MAX_VOXELS

    feats = np.random.default_rng(1).normal(
        size=(2, MAX_VOXELS, 6)).astype(np.float32)
    ref = jax.vmap(lambda f, c, n: jax_scatter(f, c, n, BEV))(
        jnp.asarray(feats), ref[1], ref[3])
    got = pillar_scatter(t(feats), coords, nv, BEV)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- (b, c) K7's plain version ----------------------------------------------

RAGGED = [(7, 9), (4, 5), (2, 3), (1, 1)]


def _msdeform_inputs(rng, shapes, b, q, heads, d, p, lo=-0.2, hi=1.2):
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, heads, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, (b, q, heads, len(shapes), p, 2))
    logits = rng.normal(size=(b, q, heads, len(shapes) * p))
    wgt = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (value, loc.astype(np.float32),
            wgt.reshape(b, q, heads, len(shapes), p).astype(np.float32))


@pytest.mark.parametrize("heads,d", [(6, 16), (8, 32)])
def test_ms_deform_attn_core_matches_jax(heads, d):
    # ragged levels (one of 1 × 1), locations up to 0.2 off the map
    rng = np.random.default_rng(heads)
    value, loc, wgt = _msdeform_inputs(rng, RAGGED, 2, 13, heads, d, 3)
    ref = np.asarray(jax_core(jnp.asarray(value), RAGGED, jnp.asarray(loc),
                              jnp.asarray(wgt)))
    got = ms_deform_attn_core(t(value), RAGGED, t(loc), t(wgt))
    assert got.shape == (2, 13, heads * d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on the CPU, and counts nothing
    before = pallas_msdeform.launches
    wrapped = pallas_msdeform.ms_deform_attn(t(value), RAGGED, t(loc), t(wgt))
    assert pallas_msdeform.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    # query chunks, dividing or not, are exact
    for chunk in (4, 13, 5):
        np.testing.assert_allclose(
            ms_deform_attn_core(t(value), RAGGED, t(loc), t(wgt),
                                query_chunk=chunk).numpy(),
            got.numpy(), rtol=1e-6, atol=1e-6, err_msg=str(chunk))


def test_wrapper_is_forward_only():
    rng = np.random.default_rng(0)
    value, loc, wgt = _msdeform_inputs(rng, RAGGED, 1, 3, 2, 4, 2)
    v = t(value).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        pallas_msdeform.ms_deform_attn(v, RAGGED, t(loc), t(wgt))
    with torch.no_grad():
        assert pallas_msdeform.ms_deform_attn(
            v, RAGGED, t(loc), t(wgt)).shape == (1, 3, 8)


def test_plain_version_matches_the_tpu_kernel_in_band():
    # tests/test_pallas_msdeform.py's encoder regime: queries are the
    # token grid, offsets ≤ 2 cells (inside the band of 8 rows); the TPU
    # kernel casts the value to bfloat16, hence its 2e-2
    shapes = [(16, 16), (8, 8), (4, 4)]
    heads, d, p = 4, 8, 2
    rng = np.random.default_rng(0)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(2, s, heads, d)).astype(np.float32)
    refs = []
    for hl, wl in shapes:
        g = np.stack(np.meshgrid((np.arange(wl) + 0.5) / wl,
                                 (np.arange(hl) + 0.5) / hl, indexing="xy"),
                     -1)
        refs.append(g.reshape(-1, 2))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    norm = np.array([[wl, hl] for hl, wl in shapes], np.float32)
    off = rng.uniform(-2, 2, (2, s, heads, len(shapes), p, 2))
    loc = (ref + off / norm[None, None, None, :, None, :]).astype(np.float32)
    wgt = rng.uniform(0, 1, (2, s, heads, len(shapes), p))
    wgt = (wgt / wgt.sum(axis=(-2, -1), keepdims=True)).astype(np.float32)
    want = np.asarray(pallas_msdeform_encoder(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(wgt),
        band=8, interpret=True))
    got = ms_deform_attn_core(t(value), shapes, t(loc), t(wgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


# --- (d) positional encoding --------------------------------------------------

@pytest.mark.parametrize("h,w", [(8, 12), (32, 32)])
def test_sine_positional_encoding_matches_jax(h, w):
    ref = np.asarray(jdgcnn.sine_positional_encoding(h, w, 128))
    got = dgcnn.sine_positional_encoding(h, w, 128)
    assert got.shape == (h, w, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# --- (e, f) modules -----------------------------------------------------------

def _variables(init, seed=0):
    """Seeded flax variables (params and batch_stats) for ``init``."""
    return _random_params(init, seed)


def test_second_and_bnfpn_match_jax():
    # randomized running statistics: the BN is no identity
    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(size=(1, 32, 32, 64)), 0).astype(np.float32)
    jsecond, jfpn = JaxSECOND(), JaxBNFPN(in_channels=(64, 128, 256))
    v_second = _variables(lambda k: jsecond.init(k, jnp.asarray(x)))
    feats = jax.jit(jsecond.apply)(v_second, jnp.asarray(x))
    v_fpn = _variables(lambda k: jfpn.init(k, feats), seed=1)
    outs = jax.jit(jfpn.apply)(v_fpn, feats)

    second = _load(SECOND(64), v_second)
    fpn = _load(BNFPN((64, 128, 256)), v_fpn)
    with torch.no_grad():
        got = second(t(x).permute(0, 3, 1, 2))
        for a, b in zip(got, feats):
            np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(b), **TOL)
        got = fpn(got)
    assert [tuple(o.shape[-2:]) for o in got] == [(16, 16), (8, 8), (4, 4),
                                                  (2, 2)]
    for a, b in zip(got, outs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), b,
                                   rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_dgcnn_attn_matches_jax():
    # 24 queries: k = 16 neighbours are a real selection
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 24, 256)).astype(np.float32)
    pos = rng.normal(size=(2, 24, 256)).astype(np.float32)
    jmod = jdgcnn.DGCNNAttn(256)
    v = _variables(lambda k: jmod.init(k, jnp.asarray(q), jnp.asarray(pos)))
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(q), jnp.asarray(pos)))
    mod = _load(dgcnn.DGCNNAttn(256), v)
    with torch.no_grad():
        got = mod(t(q), t(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_msdeform_attention_and_pfn_match_jax():
    rng = np.random.default_rng(5)
    shapes = [(6, 8), (3, 4)]
    s = sum(h * w for h, w in shapes)
    q = rng.normal(size=(1, 10, 256)).astype(np.float32)
    pos = rng.normal(size=(1, 10, 256)).astype(np.float32)
    value = rng.normal(size=(1, s, 256)).astype(np.float32)
    ref_pts = rng.uniform(0, 1, (1, 10, 2, 2)).astype(np.float32)
    args = (q, pos, value)
    jmod = jdgcnn.MSDeformAttention(256, 8, 2, 4)
    v = _variables(lambda k: jmod.init(k, *map(jnp.asarray, args), shapes,
                                       jnp.asarray(ref_pts)))
    ref = np.asarray(jmod.apply(v, *map(jnp.asarray, args), shapes,
                                jnp.asarray(ref_pts)))
    mod = _load(dgcnn.MSDeformAttention(256, 8, 2, 4), v)
    with torch.no_grad():
        got = mod(*map(t, args), shapes, t(ref_pts))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

    pts, num = _clouds()
    voxels, coords, counts, _ = hard_voxelize(t(pts), t(num), VS, PC,
                                              MAX_POINTS, MAX_VOXELS)
    vox = [a.reshape(-1, *a.shape[2:]).numpy() for a in (voxels, coords,
                                                         counts)]
    jpfn = jdgcnn.PillarFeatureNet(64, VS[:2], PC)
    v = _variables(lambda k: jpfn.init(k, *map(jnp.asarray, vox)))
    ref = np.asarray(jpfn.apply(v, *map(jnp.asarray, vox)))
    pfn = _load(dgcnn.PillarFeatureNet(5, 64, VS[:2], PC), v)
    with torch.no_grad():
        got = pfn(*map(t, vox))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# --- (g) the whole detector ---------------------------------------------------

@pytest.fixture(scope="module")
def whole_model():
    """Seeded variables, the points, and the JAX forward (outputs and the
    FPN levels, the head's input) in float32 and with the bfloat16 BEV
    path."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-7, 7, (1, 400, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 2, (1, 400))
    num = np.array([350], np.int32)
    cfg = _head_cfg(JaxHeadConfig)
    kw = dict(voxel_size=VS, max_points=MAX_POINTS, max_voxels=MAX_VOXELS,
              bev_hw=BEV)
    variables = _variables(lambda k: jdgcnn.ObjDGCNN(cfg, **kw).init(
        k, jnp.asarray(pts), jnp.asarray(num)))
    outs = {}
    for dt in ("float32", "bfloat16"):
        model = jdgcnn.ObjDGCNN(cfg, compute_dtype=dt, **kw)
        out, state = jax.jit(lambda v, p, n, m=model: m.apply(
            v, p, n, capture_intermediates=lambda mdl, _: mdl.name == "neck",
            mutable=["intermediates"]))(variables, jnp.asarray(pts),
                                        jnp.asarray(num))
        outs[dt] = {k: np.asarray(v) for k, v in out.items()}
        outs[dt]["levels"] = [np.asarray(f.astype(jnp.float32)) for f in
                              state["intermediates"]["neck"]["__call__"][0]]
    return variables, pts, num, outs, kw


def _port_forward(whole_model, dt):
    variables, pts, num, outs, kw = whole_model
    model = _load(dgcnn.ObjDGCNN(_head_cfg(HeadConfig), compute_dtype=dt,
                                 **kw), variables)
    with torch.no_grad():
        levels = model.bev_features(t(pts), t(num))
        out = model.head(levels)
    out["levels"] = levels
    return out, outs[dt]


def test_objdgcnn_forward_matches_jax_fp32(whole_model):
    got, ref = _port_forward(whole_model, "float32")
    for a, b in zip(got["levels"], ref["levels"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, b = got[key].numpy(), ref[key]
        assert a.shape == b.shape == (2, 1, 24, 10)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=key)
    dec = nms_free_decode(got, _head_cfg(HeadConfig))
    from transcar_tpu.eval.decode import nms_free_decode as jax_decode
    jdec = jax_decode({k: jnp.asarray(ref[k]) for k in
                       ("all_cls_scores", "all_bbox_preds")},
                      _head_cfg(JaxHeadConfig))
    np.testing.assert_array_equal(dec["labels"].numpy(),
                                  np.asarray(jdec["labels"]))
    np.testing.assert_allclose(dec["boxes"].numpy(), np.asarray(jdec["boxes"]),
                               rtol=1e-4, atol=1e-4 * np.abs(
                                   np.asarray(jdec["boxes"])).max())
    assert torch.isfinite(dec["boxes"]).all()


def test_objdgcnn_bf16_bev_path_matches_jax(whole_model):
    """SECOND and the FPN in bfloat16.  The two frameworks round each
    conv output to bfloat16 (2⁻⁹ relative) after accumulating in another
    order, and a value on a rounding boundary goes either way: 22 convs
    deep the FPN levels differ by a few bf16 ulps of their scale (2.4
    measured), held at 2e-2 of each level's max|JAX|.  The first decoder
    layer's outputs then agree to about 1e-3 of their scale, held at
    1e-2; the random-weight decoder amplifies a perturbation 10-20× per
    layer (a DGCNNAttn neighbour set can change), so the second layer,
    2.6e-2 measured, is held at 5e-2.  The float32 path agrees to 1e-4."""
    got, ref = _port_forward(whole_model, "bfloat16")
    for a, b in zip(got["levels"], ref["levels"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-2 * np.abs(b).max())
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, b = got[key].numpy(), ref[key]
        assert a.dtype == np.float32 and np.isfinite(a).all()
        for layer, tol in ((0, 1e-2), (1, 5e-2)):
            np.testing.assert_allclose(
                a[layer], b[layer], rtol=0,
                atol=tol * np.abs(b[layer]).max(), err_msg=f"{key} {layer}")


# --- entry points --------------------------------------------------------------

def test_build_model_objdgcnn_pillar():
    cfg = get_preset("objdgcnn_pillar")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, dgcnn.ObjDGCNN) and not model.training
    heads = [m for m in model.modules()
             if isinstance(m, dgcnn.MSDeformAttention)]
    assert len(heads) == 8 and all(m.impl == "pallas" for m in heads)
    # mmcv init: zero offset and weight kernels, the circle bias
    attn = model.head.encoder0_attn
    assert not attn.sampling_offsets.weight.any()
    assert not attn.attention_weights.weight.any()
    bias = attn.sampling_offsets.bias.detach().reshape(8, 4, 4, 2)
    np.testing.assert_allclose(bias[0, 0, :, 0].numpy(), [1, 2, 3, 4])
    np.testing.assert_allclose(bias[2, 0, 0].numpy(), [0, 1], atol=1e-6)
    # encoder_band_rows stays a validated no-op, and the voxel model waits
    for bad in (3, 2, 128):
        with pytest.raises(ValueError, match="encoder_band_rows"):
            build_model(get_preset("objdgcnn_pillar",
                                   {"model.encoder_band_rows": bad}),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        build_model(get_preset("objdgcnn_voxel"), device="cpu")
    with pytest.raises(NotImplementedError, match="K8 and K9"):
        build_model(cfg, device="cpu", training=True)


def test_benchmark_cli_objdgcnn_pillar_on_cpu(capsys):
    tiny = ["model.voxel_size=[2.0,2.0,8.0]", "model.bev_hw=[32,32]",
            "model.head.pc_range=[-32.0,-32.0,-5.0,32.0,32.0,3.0]",
            "data.max_points=3000", "model.max_voxels=256",
            "model.head.num_query=16", "model.head.num_decoder_layers=2"]
    benchmark.main(["objdgcnn_pillar", "--device", "cpu", "--samples", "1",
                    "--warmup", "1", "--cfg-options", *tiny])
    rec = __import__("json").loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["max_points"] == 3000 and "img_hw" not in rec
    assert rec["kernel_launches"]["msdeform_forward"] == 0     # CPU: plain
    audit = rec["pillar_audit"]
    assert audit["pillars"] == 256 and audit["bev_rows"] == 32
    assert 0 < audit["bev_rows_reached"] < 32
    # the cloud: 90% real points, intensity and time lag in range
    pts, num = fake_points(np.random.default_rng(0), 1, 3000,
                           (-32.0, -32.0, -5.0, 32.0, 32.0, 3.0))
    assert pts.shape == (1, 3000, 5) and num.tolist() == [2700]
    assert 0 <= pts[..., 3].min() and pts[..., 4].max() < 0.45
