"""The port's training path against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
port twin: focal loss and cost, L1, the Hungarian matcher, the set loss,
GridMask's stripes, the optimizer labels, and whole train steps (forward,
loss, backward, clip, AdamW) of a tiny R50-DCN for both recipes —
``detr3d_r101`` (the whole camera net trains, so the DCN backward runs)
and ``transcar_r101`` (fusion-only).  Geometry as tests/test_torch_model.py:
6 cameras × 64 × 96, 36 queries, 40 radar tokens, one decoder layer;
dropout and GridMask off.

The train steps run in float64 on both sides (JAX under
``jax.enable_x64``; both DCNs keep their float32 coordinate math).  In
float32 the two frameworks' rounding differs by ~1e-7 relative, which
flips the sign of the few ReLU inputs that lie that close to zero: each
flip drops one pixel's term from a conv weight's gradient, ~1e-3 of the
leaf (measured), far above what the ported math itself contributes.
"""
import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests.geom import camera_ring_l2i
from tests.test_torch_model import _random_params
from transcar_tpu.core import boxes as jboxes
from transcar_tpu.core import config as jcfg
from transcar_tpu.data.gridmask import stripe_pattern as jstripes
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.ops import focal as jfocal
from transcar_tpu.ops.hungarian import hungarian_match as jhungarian
from transcar_tpu.train.loss import detr3d_loss as jloss
from transcar_tpu.train.optim import build_optimizer as jbuild_optimizer
from transcar_tpu.train.optim import make_labels as jmake_labels
from transcar_tpu_torch.cli import benchmark
from transcar_tpu_torch.core import boxes
from transcar_tpu_torch.core import config as pcfg
from transcar_tpu_torch.core.config import get_preset, parse_overrides
from transcar_tpu_torch.data.gridmask import grid_mask, stripe_pattern
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.ops import focal
from transcar_tpu_torch.ops.hungarian import hungarian_match
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.loss import detr3d_loss
from transcar_tpu_torch.train.optim import make_labels
from transcar_tpu_torch.train.step import compute_losses, init_state, \
    train_step

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

B, N, H, W = 1, 6, 64, 96
Q, T, G = 36, 40, 8
TINY = ["model.backbone.kind=resnet50",
        f"model.head.num_query={Q}", "model.head.num_decoder_layers=1",
        f"model.head.num_radar_tokens={T}", "model.use_grid_mask=false"]


def tiny_cfg(module, preset):
    """The tiny preset of ``module`` (either config copy) with the
    backbone computing in its input's dtype."""
    cfg = module.get_preset(preset, parse_overrides(TINY))
    bb = dataclasses.replace(cfg.model.backbone, compute_dtype=None)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=bb))


def t(a):
    return torch.from_numpy(np.asarray(a))


# --- focal loss, focal cost, L1 (1e-6 relative) ----------------------------

def test_focal_and_l1_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 50)                   # 10 = background
    lw = rng.uniform(0.5, 1.0, 50).astype(np.float32)
    ours = focal.sigmoid_focal_loss(t(logits), t(labels), t(lw), 10,
                                    avg_factor=7.0, loss_weight=2.0)
    ref = jfocal.sigmoid_focal_loss(logits, labels, lw, 10, avg_factor=7.0,
                                    loss_weight=2.0)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)

    gt = rng.integers(0, 10, 9)
    np.testing.assert_allclose(
        focal.focal_loss_cost(t(logits), t(gt)).numpy(),
        np.asarray(jfocal.focal_loss_cost(logits, gt)), rtol=1e-6,
        atol=1e-7)
    # batched labels broadcast over leading dims
    lg = rng.normal(size=(2, 3, 50, 10)).astype(np.float32)
    gl = rng.integers(0, 10, (3, 9))
    ours = focal.focal_loss_cost(t(lg), t(gl)).numpy()
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                ours[i, j], np.asarray(jfocal.focal_loss_cost(lg[i, j],
                                                              gl[j])),
                rtol=1e-6, atol=1e-7)

    pred, tgt = (rng.normal(size=(50, 10)).astype(np.float32)
                 for _ in range(2))
    w = rng.uniform(size=(50, 10)).astype(np.float32)
    np.testing.assert_allclose(
        focal.l1_loss(t(pred), t(tgt), t(w), avg_factor=3.0).item(),
        float(jfocal.l1_loss(pred, tgt, w, avg_factor=3.0)), rtol=1e-6)


def test_normalize_bbox_matches_jax():
    rng = np.random.default_rng(1)
    raw = rng.uniform(0.5, 4.0, (5, 9)).astype(np.float32)
    np.testing.assert_allclose(boxes.normalize_bbox(t(raw)).numpy(),
                               np.asarray(jboxes.normalize_bbox(raw)),
                               rtol=1e-6, atol=1e-6)


# --- Hungarian: same optimum as the JAX solver -------------------------------

def _matched_cost(cost_qg, matched, n):
    return sum(float(cost_qg[int(matched[j]), j]) for j in range(n))


@pytest.mark.parametrize("case", ["finite", "nonfinite", "zero_gt"])
def test_hungarian_same_total_cost_as_jax(case):
    rng = np.random.default_rng(2)
    q, g = 40, 12
    costs = rng.normal(size=(3, q, g)).astype(np.float32)
    counts = np.array([12, 5, 0 if case == "zero_gt" else 9])
    if case == "nonfinite":
        costs[0, 3, 2] = np.nan
        costs[0, 7] = np.inf
        costs[1, :, 1] = -np.inf
    matched, valid = hungarian_match(t(costs), t(counts))
    assert matched.shape == (3, g) and valid.dtype == torch.bool
    sane = np.clip(np.nan_to_num(costs, nan=1e7, posinf=1e7, neginf=-1e7),
                   -1e7, 1e7)
    for i in range(3):
        jm, jv = jhungarian(jnp.asarray(costs[i]), jnp.int32(counts[i]))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        n = counts[i]
        # padded slots carry the sentinel Q, real ones distinct queries
        assert (matched[i, n:] == q).all()
        assert len(set(matched[i, :n].tolist())) == n
        np.testing.assert_allclose(_matched_cost(sane[i], matched[i], n),
                                   _matched_cost(sane[i], np.asarray(jm), n),
                                   rtol=1e-6, atol=1e-3)


# --- the set loss, every key (1e-5) ------------------------------------------

def _gt(rng, b, g, num):
    gt_boxes = np.ones((b, g, 9), np.float32)
    gt_boxes[..., 0:2] = rng.uniform(-40, 40, (b, g, 2))
    gt_boxes[..., 2] = rng.uniform(-3, 1, (b, g))
    gt_boxes[..., 3:6] = rng.uniform(0.5, 6, (b, g, 3))
    gt_boxes[..., 6] = rng.uniform(-3, 3, (b, g))
    gt_boxes[..., 7:9] = rng.normal(size=(b, g, 2))
    gt_labels = rng.integers(0, 10, (b, g)).astype(np.int32)
    return gt_boxes, gt_labels, np.asarray(num, np.int32)


@pytest.mark.parametrize("num_gt", [(5, 8), (0, 3)])
def test_detr3d_loss_matches_jax(num_gt):
    rng = np.random.default_rng(3)
    cfg = jcfg.HeadConfig(num_query=30)
    nl, b = 3, 2
    preds = {"all_cls_scores": rng.normal(size=(nl, b, 30, 10)) * 2,
             "all_bbox_preds": rng.normal(size=(nl, b, 30, 10)) * 3}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    gt_boxes, gt_labels, num = _gt(rng, b, 8, num_gt)
    ours = detr3d_loss({k: t(v) for k, v in preds.items()}, t(gt_boxes),
                       t(gt_labels), t(num), cfg)
    ref = jloss({k: jnp.asarray(v) for k, v in preds.items()},
                jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                jnp.asarray(num), cfg)
    assert set(ours) == set(ref) == {
        "loss_cls", "loss_bbox", "d0.loss_cls", "d0.loss_bbox",
        "d1.loss_cls", "d1.loss_bbox", "total"}
    for k in ref:
        np.testing.assert_allclose(ours[k].item(), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


# --- GridMask ----------------------------------------------------------------

@pytest.mark.parametrize("d,st_h,st_w", [(2, 0, 1), (7, 3, 6), (23, 22, 0),
                                         (63, 5, 40), (95, 94, 94)])
def test_stripe_pattern_matches_jax(d, st_h, st_w):
    row, col = stripe_pattern(H, W, d, st_h, st_w)
    jrow, jcol = jstripes(H, W, jnp.int32(d), jnp.int32(st_h),
                          jnp.int32(st_w))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))


def test_grid_mask_one_mask_for_the_stack():
    imgs = torch.ones(6, H, W, 3)
    gen = torch.Generator().manual_seed(0)
    outs = [grid_mask(imgs, gen) for _ in range(20)]
    applied = [o for o in outs if not torch.equal(o, imgs)]
    assert 0 < len(applied) < 20            # prob 0.7
    for o in applied:                       # every camera and channel alike
        assert torch.equal(o, o[:1, :, :, :1].expand_as(o))
        assert 0.4 < o.mean().item() < 1.0


# --- optimizer labels: trainable set and lr group per parameter -------------

PILLAR_TINY = ["model.bev_hw=[32,32]", "model.voxel_size=[3.2,3.2,8.0]",
               "model.max_voxels=64", "model.head.num_query=16",
               "model.head.num_decoder_layers=1"]


def _pillar_label_case():
    """objdgcnn_pillar at tiny shapes: the JAX variables' shapes (params,
    and BN statistics in batch_stats) and the port's model."""
    over = parse_overrides(PILLAR_TINY)
    cfg = jcfg.get_preset("objdgcnn_pillar", over)
    pts, num = np.zeros((1, 64, 5), np.float32), np.array([50], np.int32)
    variables = jax.eval_shape(lambda k: jbuild_model(cfg, training=True)
                               .init(k, pts, num), jax.random.PRNGKey(0))
    model = build_model(pcfg.get_preset("objdgcnn_pillar", over),
                        device="cpu", training=True)
    return cfg, variables, model


@pytest.mark.parametrize("preset", ["detr3d_r101", "transcar_r101",
                                    "objdgcnn_pillar"])
def test_labels_match_jax_make_labels(preset):
    freeze = preset == "transcar_r101"
    if preset == "objdgcnn_pillar":
        cfg, params, model = _pillar_label_case()
    else:
        cfg, params, _ = tiny_case(preset)
        model = build_model(tiny_cfg(pcfg, preset), device="cpu",
                            training=True)
    norm_eval = cfg.model.backbone.norm_eval
    jlabels = from_jax_labels(jmake_labels(params["params"], freeze, 0.1,
                                           norm_eval=norm_eval))
    ours = make_labels(model, freeze, norm_eval=norm_eval)
    buffers = dict(model.named_buffers())
    assert set(ours) | (set(jlabels) & set(buffers)) == set(jlabels)
    for name, lab in jlabels.items():
        if name in buffers:                 # FrozenBN: buffers, never trained
            assert lab == "frozen", name
        else:
            assert ours[name] == lab, name
    # the BN statistics (JAX batch_stats, flax MaskedBN and BatchNorm) are
    # the port's buffers, which no optimizer group holds
    stats = set(from_jax_labels(params.get("batch_stats", {})))
    assert stats <= set(buffers) and not stats & set(ours)
    if preset == "objdgcnn_pillar":
        assert stats and {n for n in ours if n.startswith("vfe.")} == {
            "vfe.pfn0.weight", "vfe.pfn0_bn.weight", "vfe.pfn0_bn.bias"}
        assert all(lab == "backbone" for n, lab in ours.items()
                   if n.startswith(("vfe.", "backbone.")))
        assert set(ours.values()) == {"main", "backbone"}
        return
    assert {"main", "frozen"} <= set(ours.values())
    assert ("backbone" in ours.values()) == (not freeze)


def from_jax_labels(tree):
    """Flatten a JAX label tree to the port's parameter names."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, prefix + key + ".")
            else:
                name = {"kernel": "weight", "scale": "weight",
                        "mean": "running_mean",
                        "var": "running_var"}.get(key, key)
                out[prefix + name] = val
    walk(tree, "")
    return out


# --- whole train steps against the JAX step ----------------------------------

@functools.lru_cache(maxsize=None)
def tiny_case(preset):
    """The JAX config, seeded random params and a seeded batch, float64."""
    cfg = tiny_cfg(jcfg, preset)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    l2i = camera_ring_l2i(N, H, W)[None]
    radar = np.full((B, T, 36), 500.0, np.float32)
    radar[0, :20] = rng.normal(size=(20, 36)).astype(np.float32)
    # radar points near the pc-range centre, where the random queries'
    # boxes land, so the fusion masks keep some pairs
    radar[0, :20, 0:2] = rng.uniform(-3, 3, (20, 2))
    gt_boxes, gt_labels, num_gt = _gt(rng, B, G, [6])
    batch = {"images": images, "lidar2img": l2i, "radar_tokens": radar,
             "gt_boxes": gt_boxes, "gt_labels": gt_labels, "num_gt": num_gt}
    model = jbuild_model(cfg, training=True)
    params = _random_params(lambda k: model.init(k, images, l2i, radar),
                            seed=5)
    f64 = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a
    # the loss keeps float32 box targets on both sides
    return (cfg, jax.tree_util.tree_map(f64, params),
            {k: v if k == "gt_boxes" else f64(v) for k, v in batch.items()})


def _jax_steps(cfg, params, batch, steps, total_steps):
    """The JAX package's step with dropout and GridMask off (train=False),
    the optimizer of train/optim.py; per step the losses before the
    update, the first gradients and the params after every step."""
    model = jbuild_model(cfg, training=True)
    stop = cfg.train.optim.freeze_camera_branch and \
        cfg.model.head.with_radar_fusion
    tx = jbuild_optimizer(cfg.train.optim, params["params"], total_steps,
                          freeze_camera=stop)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = model.apply({"params": p}, jb["images"], jb["lidar2img"],
                            jb.get("radar_tokens"), train=False,
                            stop_camera_grad=stop)
        losses = jloss(preds, jb["gt_boxes"], jb["gt_labels"], jb["num_gt"],
                       cfg.model.head)
        return losses["total"], losses

    @jax.jit
    def step(p, opt_state):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, losses, grads

    p, opt_state = params["params"], tx.init(params["params"])
    history = []
    for _ in range(steps):
        p, opt_state, losses, grads = step(p, opt_state)
        history.append(jax.device_get((losses, grads, p)))
    return history


def _f64(tree):
    return from_jax_params({"params": tree})


@pytest.mark.parametrize("preset", ["detr3d_r101", "transcar_r101"])
def test_train_steps_match_jax(preset):
    cfg, params, batch = tiny_case(preset)
    steps, total = 3, 10
    with jax.enable_x64(True):
        history = _jax_steps(cfg, params, batch, steps, total)

    cfg_t = tiny_cfg(pcfg, preset)
    model = build_model(cfg_t, device="cpu", training=True,
                        dropout=0.0).double()
    model.load_state_dict(_f64(params["params"]), strict=True)
    state = init_state(cfg_t, model, total_steps=total)
    assert state.stop_camera_grad == (preset == "transcar_r101")
    pb = {k: t(v) for k, v in batch.items()}
    if not cfg_t.model.head.with_radar_fusion:
        pb.pop("radar_tokens")
    named = dict(model.named_parameters())
    trainable = {n for n, p in named.items() if p.requires_grad}
    p0 = {n: p.detach().clone() for n, p in named.items()}

    # per-leaf gradients of the first step: 1e-4 of the leaf's max (the
    # float32 coordinate and sampling math leaves ~4e-7); the attention
    # key bias gets none in exact arithmetic (softmax ignores a per-row
    # shift), so every leaf's scale is floored at 1e-9 of the largest
    compute_losses(state, pb)["total"].backward()
    jgrads = _f64(history[0][1])
    assert trainable and all(named[n].grad is not None for n in trainable)
    gmax = max(np.abs(jgrads[n].numpy()).max() for n in trainable)
    for n in trainable:
        ref = jgrads[n].numpy()
        np.testing.assert_allclose(
            named[n].grad.numpy(), ref, rtol=0,
            atol=1e-4 * max(np.abs(ref).max(), 1e-9 * gmax), err_msg=n)
    state.optimizer.zero_grad(set_to_none=True)

    # one AdamW step moves an element by ≤ lr; where |g| is near eps
    # (1e-8) Adam's g / (|g| + eps) magnifies the gradients' difference,
    # so the params agree to 2e-2·lr per step (measured 4e-3·lr)
    lr0 = cfg_t.train.optim.lr * cfg_t.train.optim.warmup_ratio
    for i in range(steps):
        losses = train_step(state, pb)
        jl = history[i][0]
        assert set(losses) == set(jl)
        for k in jl:                                   # losses (1e-5)
            np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                       rtol=1e-5, err_msg=k)
        jp = _f64(history[i][2])
        for n, p in named.items():
            a, b = p.detach().numpy(), jp[n].numpy()
            if n not in trainable:           # frozen: untouched on both
                np.testing.assert_array_equal(a, p0[n].numpy(), err_msg=n)
                np.testing.assert_array_equal(b, p0[n].numpy(), err_msg=n)
            else:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=2e-2 * lr0 * (i + 1),
                                           err_msg=n)
    moved = [(named[n] != p0[n]).float().mean().item() for n in trainable]
    assert np.mean(moved) > 0.9


def test_remat_and_grid_mask_in_training():
    # remat recomputes each bottleneck in the backward: same loss and
    # gradients; GridMask draws from the step's generator and needs one
    base = tiny_cfg(pcfg, "detr3d_r101")
    _, _, batch = tiny_case("detr3d_r101")
    pb = {k: t(v).float() if v.dtype == np.float64 else t(v)
          for k, v in batch.items() if k != "radar_tokens"}
    grads = []
    for remat in ("off", "on"):
        bb = dataclasses.replace(base.model.backbone, remat=remat)
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, backbone=bb))
        state = init_state(cfg, build_model(cfg, device="cpu", training=True,
                                               dropout=0.0),
                           total_steps=10)
        assert state.model.backbone.remat == (remat == "on")
        losses = compute_losses(state, pb)
        losses["total"].backward()
        grads.append((losses["total"].item(),
                      {n: p.grad.clone() for n, p in
                       state.model.named_parameters() if p.grad is not None}))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, rel=1e-6) and g0.keys() == g1.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7)

    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, use_grid_mask=True))
    state = init_state(cfg, build_model(cfg, device="cpu", training=True),
                       total_steps=10)
    with pytest.raises(ValueError, match="Generator"):
        compute_losses(state, pb)
    losses = train_step(state, pb, torch.Generator().manual_seed(0))
    assert torch.isfinite(losses["total"])


def test_cli_train_cpu(capsys):
    for preset in ("detr3d_r101", "transcar_r101"):
        benchmark.main([preset, "--train", "--device", "cpu", "--samples",
                        "1", "--warmup", "1", "--height", "64", "--width",
                        "96", "--cfg-options", "model.backbone.kind=resnet50",
                        "model.head.num_query=16",
                        "model.head.num_decoder_layers=1",
                        "model.head.num_radar_tokens=40"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["mode"] == "train" and rec["steps"] == 2
        assert rec["device"] == "cpu" and rec["steps_per_sec"] > 0
        assert rec["fusion_only"] == (preset == "transcar_r101")
        assert np.isfinite(rec["loss_first"]["total"])
        assert np.isfinite(rec["loss_last"]["total"])
        # the CPU takes the plain versions: no kernel launches
        assert rec["kernel_launches"] == dict.fromkeys(
            ("dcn_forward", "dcn_backward", "masked_attention", "osa_reduce",
             "osa_block", "bottleneck", "msdeform_forward",
             "msdeform_backward_taps", "msdeform_backward_value",
             "int8_conv", "int8_wgmma", "int8_quantize", "int8_amax",
             "hungarian"), 0)
