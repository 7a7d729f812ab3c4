"""ObjDGCNN training in the port against the JAX package, on the CPU.

The same seeded numpy inputs go through ``transcar_tpu`` and
``transcar_tpu_torch``:

  (a) ``common.BatchNorm`` in train mode against flax's ``BatchNorm`` (as
      ``train_bn`` and ``ConvBN(norm="batch")`` build it) and the VFE's
      ``MaskedBN``: outputs and running statistics over 2 steps;
  (b) the plain MSDeformAttn backward (K8 and K9's plain version) against
      ``jax.vjp`` of ``ms_deform_attn_core`` in float64;
  (c) the same plain backward against the TPU kernels' own VJP,
      ``pallas_msdeform_encoder_ad`` in interpret mode, every tap in band;
  (d) three train steps of a tiny ``objdgcnn_pillar`` against the JAX step
      in float64: losses, first-step gradients, parameters and the BN
      running statistics.

The CUDA kernels K8 and K9 are held against the plain backward in
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as fnn

from tests.test_torch_model import _random_params
from transcar_tpu.core import config as jcfg
from transcar_tpu.models import dgcnn as jdgcnn
from transcar_tpu.models.common import MaskedBN
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.ops.msdeform import ms_deform_attn_core as jax_core
from transcar_tpu.ops.pallas_msdeform import pallas_msdeform_encoder_ad
from transcar_tpu.train.loss import detr3d_loss as jloss
from transcar_tpu.train.optim import build_optimizer as jbuild_optimizer
from transcar_tpu.train.step import apply_model
from transcar_tpu_torch.core import config as pcfg
from transcar_tpu_torch.core.config import parse_overrides
from transcar_tpu_torch.data.synthetic import fake_lidar_batch
from transcar_tpu_torch.models.common import BatchNorm
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.ops.msdeform import ms_deform_attn_backward
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.step import compute_losses, init_state, \
    train_step

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers


def t(a):
    return torch.from_numpy(np.asarray(a))


# --- (a) BatchNorm batch statistics -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Two train-mode steps on NHWC input: flax's BatchNorm (momentum 0.9,
    the output in the input's dtype, as ConvBN builds it) against the port
    with the channel last and, on the NCHW transpose, at axis 1; then the
    running statistics normalize in eval mode.  Float32 agrees to 1e-5
    (summation order); a bfloat16 output to one bf16 rounding (2⁻⁸)."""
    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(2, 5, 7, 16)) * 2 + 0.5).astype(np.float32)
          for _ in range(2)]
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jdt),
                        use_running_average=True)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    ports = [BatchNorm(16, channel_dim=cd).train() for cd in (-1, 1)]
    for mod in ports:
        mod.weight.data.copy_(t(scale))
        mod.bias.data.copy_(t(bias))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    for x in xs + [None]:
        train = x is not None
        x = xs[0] if x is None else x
        for mod in ports:
            mod.train(train)
        out = bn.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x, jdt), use_running_average=not train,
                       mutable=["batch_stats"] if train else False)
        if train:
            out, new = out
            stats = new["batch_stats"]
        want = np.asarray(out.astype(jnp.float32))
        xt = t(x).to(tdt)
        got_last = ports[0](xt)
        got_first = ports[1](xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        for got in (got_last, got_first):
            assert got.dtype == tdt
            np.testing.assert_allclose(got.detach().float().numpy(), want,
                                       **tol)
        for mod in ports:
            np.testing.assert_allclose(mod.running_mean.numpy(),
                                       np.asarray(stats["mean"]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(mod.running_var.numpy(),
                                       np.asarray(stats["var"]),
                                       rtol=1e-5, atol=1e-6)
    # flax's fast variance is the biased one (what F.batch_norm would not
    # store): after one step from (0, 1), var = 0.9 + 0.1 · biased var
    x0 = t(xs[0]).double().reshape(-1, 16)
    fresh = BatchNorm(16, channel_dim=-1).double().train()
    fresh(t(xs[0]).double())
    np.testing.assert_allclose(fresh.running_var.numpy(),
                               0.9 + 0.1 * x0.var(0, unbiased=False).numpy(),
                               rtol=1e-12)


def test_masked_batchnorm_matches_jax_masked_bn():
    """The VFE's MaskedBN: padding pillars (garbage rows) are left out of
    the statistics, zero-padded points of real pillars count; all pillars
    are normalized."""
    rng = np.random.default_rng(1)
    p, m, c = 12, 5, 8
    counts = np.array([5, 3, 1, 0, 4, 0, 2, 5, 0, 1, 0, 3])
    x = rng.normal(size=(p, m, c)).astype(np.float32)
    x[np.arange(m)[None, :] >= counts[:, None]] = 0.0      # padded points
    x[counts == 0] = 100.0                              # padding pillars
    mask = (counts > 0)[:, None]
    jmod = MaskedBN(c, eps=1e-3)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(mask))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=c), jnp.float32)}
    stats = variables["batch_stats"]
    mod = BatchNorm(c, eps=1e-3, channel_dim=-1).train()
    mod.weight.data.copy_(t(params["scale"]))
    mod.bias.data.copy_(t(params["bias"]))
    for step in range(2):
        xi = x * (1 + step)
        want, new = jmod.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(xi), jnp.asarray(mask),
                               train=True, mutable=["batch_stats"])
        stats = new["batch_stats"]
        got = mod(t(xi), t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)
    # the padding rows' 100s reached neither statistic
    assert float(mod.running_mean.abs().max()) < 1.0
    # no real row at all: n is clamped at 1, the statistics are zero
    fresh = BatchNorm(c, eps=1e-3, channel_dim=-1).train()
    fresh(t(x), t(np.zeros_like(mask)))
    assert torch.equal(fresh.running_mean, torch.zeros(c))
    assert torch.allclose(fresh.running_var, torch.full((c,), 0.9))


# --- (b, c) the plain backward ------------------------------------------------

RAGGED = [(7, 9), (4, 8), (2, 3), (1, 1)]


def _backward_case(rng, shapes, b, q, heads, d, p):
    """float64 value, locations over [-0.2, 1.2] with integer-coordinate
    samples on the 4 × 8 and 1 × 1 levels and some at ±1e20, softmaxed
    weights and an output gradient."""
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, heads, d))
    loc = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2))
    # x = u·W − 0.5 and y = v·H − 0.5 whole numbers (exact in binary)
    loc[:, ::2, :, 1, 0, 0] = (rng.integers(-1, 9, (b, (q + 1) // 2, heads))
                               + 0.5) / 8
    loc[:, ::2, :, 1, 0, 1] = (rng.integers(-1, 5, (b, (q + 1) // 2, heads))
                               + 0.5) / 4
    loc[:, 1::3, :, 3, :, :] = 0.5                 # the 1 × 1 cell's centre
    loc[:, 2, 0, 0, 0] = (1e20, 0.5)
    loc[:, 3, 1, 2, 1] = (0.5, -1e20)
    logits = rng.normal(size=(b, q, heads, len(shapes) * p))
    wgt = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    d_out = rng.normal(size=(b, q, heads * d))
    return value, loc, wgt.reshape(b, q, heads, len(shapes), p), d_out


@pytest.mark.parametrize("heads,d", [(6, 16), (6, 48)])
def test_plain_backward_matches_jax_grad(heads, d):
    rng = np.random.default_rng(heads + d)
    value, loc, wgt, d_out = _backward_case(rng, RAGGED, 2, 13, heads, d, 3)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda v, lc, a: jax_core(v, RAGGED, lc, a),
                         jnp.asarray(value), jnp.asarray(loc),
                         jnp.asarray(wgt))
        want = [np.asarray(g) for g in vjp(jnp.asarray(d_out))]
    assert all(np.isfinite(w).all() for w in want)
    results = [ms_deform_attn_backward(t(value), RAGGED, t(loc), t(wgt),
                                       t(d_out), query_chunk=chunk)
               for chunk in (0, 5, 13)]
    for got in results:
        assert [g.dtype for g in got] == [torch.float64] * 3
        for g, w, name in zip(got, want, ("d_value", "d_loc", "d_attn")):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-10 * np.abs(w).max(),
                                       err_msg=name)
    # far-off samples have no gradient at all
    assert not results[0][1][:, 2, 0, 0, 0].any()
    assert not results[0][2][:, 3, 1, 2, 1].any()


def test_plain_backward_matches_the_tpu_kernels_in_band():
    """The backward twin of tests/test_torch_dgcnn.py's in-band forward
    check: queries are the token grid and offsets stay within 2 cells (in
    the band of 8 rows).  The TPU kernels cast the value and the one-hot
    taps to bfloat16, hence 2e-2 of each gradient's max."""
    shapes = ((16, 16), (8, 8), (4, 4))
    heads, d, p = 4, 8, 2
    rng = np.random.default_rng(0)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(1, s, heads, d)).astype(np.float32)
    refs = []
    for hl, wl in shapes:
        g = np.stack(np.meshgrid((np.arange(wl) + 0.5) / wl,
                                 (np.arange(hl) + 0.5) / hl, indexing="xy"),
                     -1)
        refs.append(g.reshape(-1, 2))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    norm = np.array([[wl, hl] for hl, wl in shapes], np.float32)
    off = rng.uniform(-2, 2, (1, s, heads, len(shapes), p, 2))
    loc = (ref + off / norm[None, None, None, :, None, :]).astype(np.float32)
    wgt = rng.uniform(0, 1, (1, s, heads, len(shapes), p))
    wgt = (wgt / wgt.sum(axis=(-2, -1), keepdims=True)).astype(np.float32)
    d_out = rng.normal(size=(1, s, heads * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, lc, a: pallas_msdeform_encoder_ad(
        v, shapes, lc, a, 8, True), jnp.asarray(value), jnp.asarray(loc),
        jnp.asarray(wgt))
    want = vjp(jnp.asarray(d_out))
    got = ms_deform_attn_backward(t(value), shapes, t(loc), t(wgt), t(d_out))
    for g, w, name in zip(got, want, ("d_value", "d_loc", "d_attn")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=name)


# --- (d) three train steps against the JAX step -------------------------------

# tests/test_lidar_mesh.py's tiny pillar preset: 32 × 32 pillars of
# 3.2 m, 256 of them kept, BEV levels 16² .. 2², 16 queries; the BEV
# convolutions in float64 as the rest, two decoder layers
TINY = ["model.lidar_compute_dtype=float64", "data.max_points=600",
        "model.max_voxels=256", "model.bev_hw=[32,32]",
        "model.voxel_size=[3.2,3.2,8.0]", "model.head.num_query=16",
        "model.head.num_decoder_layers=2"]


def _tiny_case():
    """The JAX config, seeded random float64 variables (params and
    batch_stats) and a seeded LiDAR batch (float64 points)."""
    cfg = jcfg.get_preset("objdgcnn_pillar", parse_overrides(TINY))
    rng = np.random.default_rng(3)
    batch = fake_lidar_batch(rng, 1, cfg.data.max_points,
                             cfg.model.head.pc_range, max_gt=4)
    batch["num_gt"][:] = 3
    model = jbuild_model(cfg, training=True)
    variables = _random_params(lambda k: model.init(
        k, batch["points"], batch["num_points"]), seed=5)
    f64 = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a
    batch = {k: v if k == "gt_boxes" else f64(v) for k, v in batch.items()}
    return cfg, jax.tree_util.tree_map(f64, variables), batch


class _MaskedBNAtLeastF32(MaskedBN):
    """The JAX ``MaskedBN`` computing in at least float32, as flax's
    ``BatchNorm`` and the port's ``BatchNorm`` do.  The JAX module casts
    its input to float32 outright, which is the same for the float32
    points the model takes; in this float64 comparison it would add
    float32 rounding (~1e-7) that the random-weight detector amplifies
    ~1000× into the gradients (a sample crossing a cell edge flips its
    bilinear derivative)."""

    @fnn.compact
    def __call__(self, x, mask, train: bool = False):
        dt = jnp.promote_types(x.dtype, jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((self.features,), dt))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((self.features,), dt))
        scale = self.param("scale", fnn.initializers.ones, (self.features,))
        bias = self.param("bias", fnn.initializers.zeros, (self.features,))
        if train:
            m = jnp.broadcast_to(mask.astype(dt)[..., None], x.shape)
            n = jnp.maximum(jnp.sum(m) / self.features, 1.0)
            axes = tuple(range(x.ndim - 1))
            mean = jnp.sum(x.astype(dt) * m, axis=axes) / n
            var = jnp.sum(m * (x.astype(dt) - mean) ** 2, axis=axes) / n
            if not self.is_initializing():
                ra_mean.value = (self.momentum * ra_mean.value
                                 + (1 - self.momentum) * mean)
                ra_var.value = (self.momentum * ra_var.value
                                + (1 - self.momentum) * var)
        else:
            mean, var = ra_mean.value, ra_var.value
        inv = jax.lax.rsqrt(var + self.eps) * scale
        return ((x.astype(dt) - mean) * inv + bias).astype(x.dtype)


def _jax_steps(cfg, variables, batch, steps, total_steps):
    """The JAX package's LiDAR step with batch statistics (train=True) and
    its dropout patched off: per step the losses before the update, the
    first gradients, and the params and batch_stats after the step."""
    model = jbuild_model(cfg, training=True)
    tx = jbuild_optimizer(cfg.train.optim, variables["params"], total_steps,
                          freeze_camera=False,
                          frozen_stages=cfg.model.backbone.frozen_stages,
                          norm_eval=cfg.model.backbone.norm_eval)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, stats):
        preds, new_stats = apply_model(model, p, jb, train=True,
                                       batch_stats=stats)
        losses = jloss(preds, jb["gt_boxes"], jb["gt_labels"], jb["num_gt"],
                       cfg.model.head)
        return losses["total"], (losses, new_stats)

    @jax.jit
    def step(p, stats, opt_state):
        (_, (losses, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, stats)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), stats, opt_state, losses, \
            grads

    p, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(p)
    history = []
    for _ in range(steps):
        p, stats, opt_state, losses, grads = step(p, stats, opt_state)
        history.append(jax.device_get((losses, grads, p, stats)))
    return history


def test_pillar_train_steps_match_jax(monkeypatch):
    """Float64 on both sides (the port's dropout 0, JAX's patched off, and
    its MaskedBN in at least float32, see above; BN on batch statistics):
    losses to 1e-5, first-step gradients per leaf to
    1e-4 of the leaf's max, params to 2e-2·lr per step (Adam's g / (|g| +
    eps) magnifies gradient differences where |g| is near eps, as in
    tests/test_torch_train.py) and the running statistics to 1e-6 of
    each one's max (they agree to 1e-9 after the first forward; later ones
    inherit the parameters' differences)."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(jdgcnn, "MaskedBN", _MaskedBNAtLeastF32)
    cfg, variables, batch = _tiny_case()
    steps, total = 3, 10
    with jax.enable_x64(True):
        history = _jax_steps(cfg, variables, batch, steps, total)

    cfg_t = pcfg.get_preset("objdgcnn_pillar", parse_overrides(TINY))
    model = build_model(cfg_t, device="cpu", training=True,
                        dropout=0.0).double()
    model.load_state_dict(from_jax_params(variables), strict=True)
    state = init_state(cfg_t, model, total_steps=total)
    assert not state.stop_camera_grad and model.training
    pb = {k: t(v) for k, v in batch.items()}
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert all(p.requires_grad for p in named.values())

    # first-step gradients (the forward also updates the running stats,
    # so they are put back before the steps)
    stats0 = {n: b.clone() for n, b in buffers.items()}
    compute_losses(state, pb)["total"].backward()
    jgrads = from_jax_params({"params": history[0][1]})
    gmax = max(np.abs(g.numpy()).max() for g in jgrads.values())
    for n, p in named.items():
        ref = jgrads[n].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=1e-4 * max(np.abs(ref).max(), 1e-9 * gmax), err_msg=n)
    state.optimizer.zero_grad(set_to_none=True)
    for n, b in buffers.items():
        b.copy_(stats0[n])

    lr0 = cfg_t.train.optim.lr * cfg_t.train.optim.warmup_ratio
    p0 = {n: p.detach().clone() for n, p in named.items()}
    for i in range(steps):
        losses = train_step(state, pb)
        jl, _, jp, js = history[i]
        assert set(losses) == set(jl)
        for k in jl:
            np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                       rtol=1e-5, err_msg=k)
        want = from_jax_params({"params": jp, "batch_stats": js})
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=0, atol=2e-2 * lr0 * (i + 1),
                                       err_msg=n)
        for n, b in buffers.items():
            ref = want[n].numpy()
            np.testing.assert_allclose(b.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=n)
    moved = [(named[n] != p0[n]).float().mean().item() for n in named]
    assert np.mean(moved) > 0.9
    assert all(not torch.equal(b, stats0[n]) for n, b in buffers.items())


def test_benchmark_cli_objdgcnn_pillar_train_on_cpu(capsys, tmp_path):
    """``cli.benchmark objdgcnn_pillar --train`` at tiny shapes: one JSON
    line, finite losses, and no kernel launched on the CPU."""
    from transcar_tpu_torch.cli import benchmark

    tiny = ["model.voxel_size=[2.0,2.0,8.0]", "model.bev_hw=[32,32]",
            "model.head.pc_range=[-32.0,-32.0,-5.0,32.0,32.0,3.0]",
            "data.max_points=3000", "model.max_voxels=256",
            "model.head.num_query=16", "model.head.num_decoder_layers=2"]
    benchmark.main(["objdgcnn_pillar", "--train", "--device", "cpu",
                    "--samples", "1", "--warmup", "1", "--trace-dir",
                    str(tmp_path), "--cfg-options", *tiny])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = __import__("json").loads(lines[-1])
    assert len(lines) == 1 and rec["mode"] == "train" and rec["steps"] == 2
    assert rec["max_points"] == 3000 and "img_hw" not in rec
    assert rec["device"] == "cpu" and not rec["fusion_only"]
    assert set(rec["loss_first"]) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                                      "d0.loss_bbox", "total"}
    assert all(np.isfinite(v) for r in (rec["loss_first"], rec["loss_last"])
               for v in r.values())
    assert len(rec["kernel_launches"]) == 11      # K1-K9, int8 conv, quantize
    assert set(rec["kernel_launches"].values()) == {0}      # CPU: plain
    assert rec["trace"]["iterations"] == 1
    assert (tmp_path / "summary.json").exists()
