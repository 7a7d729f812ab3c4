"""Port ops vs their JAX twins on the CPU, at tiny sizes.

The same seeded numpy inputs go through ``transcar_tpu`` (Pallas kernels
in interpret mode, as tests/test_pallas_*.py run them) and through
``transcar_tpu_torch``, whose kernel wrappers take their plain versions
for CPU tensors.  The CUDA kernels themselves are tested against those
plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.geom import camera_ring_l2i
from transcar_tpu.core import boxes as jboxes
from transcar_tpu.core.config import HeadConfig
from transcar_tpu.core.geometry import project_points_to_cams as jproject
from transcar_tpu.eval.decode import nms_free_decode as jdecode
from transcar_tpu.ops.attention import multihead_attention as jmha
from transcar_tpu.ops.dcn import modulated_deform_conv as jdcn
from transcar_tpu.ops.pallas_attention import masked_mha_pallas
from transcar_tpu.ops.pallas_dcn import fused_deform_conv as jfused_dcn
from transcar_tpu.ops.sampling import (bilinear_sample_nhwc as jbilinear,
                                       sample_multiview_multilevel as jsample)
from transcar_tpu_torch.core import boxes, geometry
from transcar_tpu_torch.eval.decode import nms_free_decode
from transcar_tpu_torch.ops import dcn, pallas_attention, pallas_dcn, sampling

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers


def t(a):
    return torch.from_numpy(np.asarray(a))


# --- K2: masked attention ---------------------------------------------------

E, H = 64, 4


def _attn_params(rng):
    p = {}
    for n in ("wq", "wk", "wv", "wo"):
        p[n] = rng.normal(size=(E, E)).astype(np.float32) * 0.1
        p["b" + n[1:]] = rng.normal(size=(E,)).astype(np.float32) * 0.1
    return p


def _attn_case(seed, b=2, q=150, t_=200):
    rng = np.random.default_rng(seed)
    params = _attn_params(rng)
    qx = rng.normal(size=(b, q, E)).astype(np.float32)
    kv = rng.normal(size=(b, t_, E)).astype(np.float32)
    keep = rng.uniform(size=(b, q, t_)) < 0.2
    keep[:, 0] = True                      # a fully-visible row
    keep[:, 5] = False                     # a fully-masked row
    return params, qx, kv, keep


def test_masked_mha_matches_jax_xla_and_pallas():
    params, qx, kv, keep = _attn_case(0)
    ours = pallas_attention.masked_mha(
        t(qx), t(kv), t(kv), {k: t(v) for k, v in params.items()}, H,
        t(keep)).numpy()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    xla = np.asarray(jmha(jnp.asarray(qx), jnp.asarray(kv), jnp.asarray(kv),
                          jp, H, mask=~jnp.asarray(keep)))
    pallas = np.asarray(masked_mha_pallas(
        jnp.asarray(qx), jnp.asarray(kv), jnp.asarray(kv), jp, H,
        jnp.asarray(keep), interpret=True))
    # only gated rows (≥ 1 visible token): fully-masked rows are finite
    # but unspecified, and every caller gates them away
    gate = keep.any(-1)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[gate], xla[gate], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours[gate], pallas[gate], rtol=2e-4, atol=2e-4)


# --- K1: DCNv2 --------------------------------------------------------------

def _dcn_case(seed, n, h, w, cin, cout, offy, offx):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    om = rng.normal(size=(n, h, w, 27)).astype(np.float32)
    om[..., 0:18:2] = rng.uniform(-offy, offy, (n, h, w, 9))
    om[..., 1:18:2] = rng.uniform(-offx, offx, (n, h, w, 9))
    weight = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    return x, om, weight


def _jax_exact(x, om, weight, dtype=jnp.float32):
    return np.asarray(jax.vmap(lambda a, b: jdcn(a, b, weight.astype(dtype)))(
        jnp.asarray(x, dtype), jnp.asarray(om, dtype)).astype(jnp.float32))


def test_dcn_exact_for_arbitrary_offsets():
    # offsets up to ±9 px on a 15 × 12 map: taps past every edge and past
    # the TPU kernel's band
    x, om, weight = _dcn_case(1, 2, 15, 12, 8, 16, 9.0, 9.0)
    ours = pallas_dcn.fused_deform_conv(t(x), t(om), t(weight)).numpy()
    np.testing.assert_allclose(ours, _jax_exact(x, om, weight),
                               rtol=1e-4, atol=1e-4)


def test_dcn_matches_pallas_within_band():
    # band_rows=16 is exact for |Δy| ≤ 6; Δx is unrestricted
    x, om, weight = _dcn_case(2, 1, 20, 12, 8, 16, 6.0, 8.0)
    ours = dcn.modulated_deform_conv(t(x), t(om), t(weight)).numpy()
    ref = np.asarray(jfused_dcn(jnp.asarray(x), jnp.asarray(om),
                                jnp.asarray(weight), band_rows=16,
                                interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_dcn_bf16():
    x, om, weight = _dcn_case(3, 1, 10, 9, 32, 16, 4.0, 4.0)
    ours = pallas_dcn.fused_deform_conv(
        t(x).bfloat16(), t(om).bfloat16(), t(weight)).float().numpy()
    ref = _jax_exact(x, om, weight, jnp.bfloat16)
    exact = _jax_exact(np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
                       np.asarray(jnp.asarray(om, jnp.bfloat16), np.float32),
                       np.asarray(jnp.asarray(weight, jnp.bfloat16),
                                  np.float32))
    scale = np.abs(exact).max()
    # ops/dcn.py (JAX) rounds the bilinear fractions and corner weights to
    # bfloat16 (≈ 2⁻⁹ relative each) before its bf16 einsum; the port keeps
    # them float32 and rounds only the modulated sample.  Both then round
    # the output to bfloat16, so each sits a few bf16 ulps from the
    # float32 result on the same rounded inputs, the port closer.
    err_port = np.abs(ours - exact).max() / scale
    err_jax = np.abs(ref - exact).max() / scale
    assert err_port <= 1e-2, err_port
    assert err_port <= err_jax, (err_port, err_jax)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-2 * scale)


# --- K3: DCNv2 backward -----------------------------------------------------

def _jax_dcn_grads(x, om, weight, d_out):
    def f(a, b, c):
        out = jax.vmap(lambda xi, oi: jdcn(xi, oi, c))(a, b)
        return jnp.sum(out * d_out)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(om), jnp.asarray(weight))]


@pytest.mark.parametrize("offsets", ["zero", "integer", "pm8"])
def test_dcn_backward_matches_jax_grad(offsets):
    # float32, 1e-4 of max|ref| per output.  "zero" is the mmcv init: every
    # tap on its grid position, border taps at py = -1 and py = H, where
    # both sides take the one-sided floor-convention derivative
    x, om, weight = _dcn_case(9, 2, 9, 11, 8, 16, 8.0, 8.0)
    if offsets == "zero":
        om[..., :18] = 0.0
    elif offsets == "integer":
        om[..., :18] = np.random.default_rng(10).integers(-3, 4, (2, 9, 11,
                                                                   18))
    d_out = np.random.default_rng(11).normal(size=(2, 9, 11, 16)).astype(
        np.float32)
    refs = _jax_dcn_grads(x, om, weight, d_out)
    # the kernel wrapper's CPU path (autograd of ops/dcn.py), with the
    # weight as the float32 parameter, and K3's plain version
    xs, oms, ws = (t(a).requires_grad_() for a in (x, om, weight))
    pallas_dcn.fused_deform_conv(xs, oms, ws).backward(t(d_out))
    plain = pallas_dcn.plain_backward(t(x), t(om), t(weight), t(d_out))
    for name, a, b, r in zip(("d_x", "d_om", "d_w"),
                             (xs.grad, oms.grad, ws.grad), plain, refs):
        assert a.dtype == torch.float32
        scale = np.abs(r).max()
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(b.numpy(), r, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


# --- small modules ----------------------------------------------------------

def test_bilinear_sampling():
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(3, 7, 9, 5)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (3, 40, 2)).astype(np.float32)
    ours = sampling.bilinear_sample_nhwc(t(feat), t(uv)).numpy()
    ref = np.asarray(jax.vmap(jbilinear)(jnp.asarray(feat), jnp.asarray(uv)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)

    feats = [rng.normal(size=(2, 3, 8 >> i, 12 >> i, 4)).astype(np.float32)
             for i in range(3)]
    uv = rng.uniform(-0.1, 1.1, (2, 3, 10, 2)).astype(np.float32)
    ours = sampling.sample_multiview_multilevel([t(f) for f in feats],
                                                t(uv)).numpy()
    ref = np.asarray(jsample([jnp.asarray(f) for f in feats],
                             jnp.asarray(uv)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_projection():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-50, 50, (2, 64, 3)).astype(np.float32)
    l2i = np.stack([camera_ring_l2i(6, 64, 96)] * 2)
    uv, vis = geometry.project_points_to_cams(t(pts), t(l2i), (64, 96))
    juv, jvis = jproject(jnp.asarray(pts), jnp.asarray(l2i), (64, 96))
    assert vis.any() and not vis.all()
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    # points behind a camera divide by the 1e-5 depth clamp and reach
    # ~1e6: relative tolerance for the float32 matmuls' summation order
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-4,
                               atol=1e-5)


def test_boxes():
    rng = np.random.default_rng(7)
    code = rng.normal(size=(4, 10)).astype(np.float32)
    np.testing.assert_allclose(boxes.denormalize_bbox(t(code)).numpy(),
                               np.asarray(jboxes.denormalize_bbox(code)),
                               rtol=1e-6, atol=1e-6)
    p = rng.uniform(-0.1, 1.1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(boxes.inverse_sigmoid(t(p)).numpy(),
                               np.asarray(jboxes.inverse_sigmoid(p)),
                               rtol=1e-5, atol=1e-5)
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    np.testing.assert_allclose(boxes.denorm_points(t(p), pc).numpy(),
                               np.asarray(jboxes.denorm_points(p, pc)),
                               rtol=1e-6, atol=1e-5)


def test_nms_free_decode():
    rng = np.random.default_rng(8)
    cfg = HeadConfig(num_query=64, score_threshold=0.3)
    preds = {"all_cls_scores": rng.normal(size=(2, 2, 64, 10)),
             "all_bbox_preds": rng.normal(size=(2, 2, 64, 10)) * 40}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    ours = nms_free_decode({k: t(v) for k, v in preds.items()}, cfg)
    ref = jdecode({k: jnp.asarray(v) for k, v in preds.items()}, cfg)
    # random scores have no ties, so the sorted top-k lists align row by row
    np.testing.assert_allclose(np.sort(ours["scores"].numpy(), -1),
                               np.sort(np.asarray(ref["scores"]), -1),
                               rtol=1e-6)
    np.testing.assert_array_equal(ours["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_array_equal(ours["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    np.testing.assert_allclose(ours["boxes"].numpy(),
                               np.asarray(ref["boxes"]), rtol=1e-5, atol=1e-5)
