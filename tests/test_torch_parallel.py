"""The port's parallelism (``transcar_tpu_torch/parallel``) on the CPU,
two gloo ranks spawned once for the module (their side is
``parallel/dryrun.run_calls``):

  (a) the tensor-parallel rule table against the JAX ``_spec_for`` (and
      its divisibility guard) on every parameter of tiny
      ``transcar_r101`` and ``objdgcnn_pillar``;
  (b) the loader of 2 processes: each yields its contiguous half of every
      one-process global batch;
  (c) a 2-rank ``objdgcnn_pillar`` step (float64, dropout off) against the
      JAX step jitted over a 2-device data mesh, from the same weights
      (``from_jax_params``) and batch: gradients, losses, parameters and
      BatchNorm running statistics; and against the port's one-process
      step of the global batch;
  (d) a 2-rank tiny ``transcar_r101`` step against the port's
      one-process step of the global batch (GridMask on): gradients,
      losses, parameters;
  (e) the head split over 2 ranks against the replicated head: a train
      step (dropout on; gradients, losses, parameters) and an eval
      forward;
  (f) camera-sharded eval against the unsharded eval, bit for bit, and
      ``camera_devices`` against the JAX ``camera_mesh`` rule;
  (g) ``allgather_eval_outputs`` at 3 and 2 rows;
  (h) ``cli.train`` on 2 ranks for 2 steps against one process at the
      doubled batch; rank 0 alone writes logs and checkpoints.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import chip_smoke
from tests.test_torch_data import TINY
from tests.test_torch_dgcnn_train import _MaskedBNAtLeastF32
from tests.test_torch_model import _random_params
from transcar_tpu.core import config as jcfg
from transcar_tpu.models import dgcnn as jdgcnn
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.parallel.mesh import camera_mesh, make_mesh, shard_batch
from transcar_tpu.parallel.sharding import tp_sharding_tree
from transcar_tpu.train.loss import detr3d_loss as jloss
from transcar_tpu.train.optim import build_optimizer as jbuild_optimizer
from transcar_tpu.train.step import apply_model
from transcar_tpu_torch.cli import train as cli_train
from transcar_tpu_torch.core import config as pcfg
from transcar_tpu_torch.data.infos import NuScenesInfos
from transcar_tpu_torch.data.loader import PrefetchLoader
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.parallel import dryrun
from transcar_tpu_torch.parallel.mesh import Grid, camera_devices
from transcar_tpu_torch.parallel.sharding import shard_model, split_dims
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

#: (c): the dry run's pillar shapes in float64
PILLAR64 = dryrun.TINY_PILLAR + ["model.lidar_compute_dtype=float64"]
#: (d), (e), (h): R50 without DCN, float32, at the dry run's head sizes
CAMERA = ["model.backbone.kind=resnet50",
          "model.backbone.with_dcn=[false,false,false,false]",
          "model.backbone.compute_dtype=float32"] + dryrun.TINY_TRANSCAR


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nusc_parallel"))
    chip_smoke.write_fixture(path, hw=(60, 90), lidar_points=3000,
                             radar_points=12)
    return path


def _jax_mesh_step(spec, tmp):
    """(c)'s reference: the JAX pillar step over a 2-device data mesh,
    float64, Dropout and MaskedBN patched as in
    tests/test_torch_dgcnn_train.py; saves the initial weights and the
    reference (losses, gradients and their global norm, state after the
    update) for ``dryrun.dp_check``."""
    cfg = jcfg.get_preset("objdgcnn_pillar",
                          pcfg.parse_overrides(spec["options"]))
    batch = dryrun.case_batch(spec)
    model = jbuild_model(cfg, training=True)
    f64 = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a
    variables = jax.tree_util.tree_map(f64, _random_params(
        lambda k: model.init(k, batch["points"], batch["num_points"]),
        seed=5))
    init = os.path.join(tmp, "pillar_init.pt")
    torch.save(from_jax_params(variables), init)
    tx = jbuild_optimizer(cfg.train.optim, variables["params"], 10,
                          freeze_camera=False,
                          frozen_stages=cfg.model.backbone.frozen_stages,
                          norm_eval=cfg.model.backbone.norm_eval)
    mesh = make_mesh((2,), ("data",), jax.devices()[:2])
    with jax.enable_x64(True):
        jb = shard_batch(batch, mesh)

        @jax.jit
        def step(p, stats, opt_state):
            def loss_fn(p):
                preds, new = apply_model(model, p, jb, train=True,
                                         batch_stats=stats)
                losses = jloss(preds, jb["gt_boxes"], jb["gt_labels"],
                               jb["num_gt"], cfg.model.head)
                return losses["total"], (losses, new)

            (_, (losses, new)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            updates, _ = tx.update(g, opt_state, p)
            return (optax.apply_updates(p, updates), new, losses, g,
                    optax.global_norm(g))

        p, stats, losses, g, norm = jax.device_get(step(
            variables["params"], variables["batch_stats"],
            tx.init(variables["params"])))
    ref = os.path.join(tmp, "pillar_jax.pt")
    torch.save({"losses": [{k: float(v) for k, v in losses.items()}],
                "grads": from_jax_params({"params": g}),
                "grad_norm": float(norm),
                "model": from_jax_params({"params": p,
                                          "batch_stats": stats})}, ref)
    return init, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, fixture_root):
    """Every rank-side check of the module, on one group of 2 gloo ranks,
    and the one-process references they are held to."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, *a, **k: inputs)
    mp.setattr(jdgcnn, "MaskedBN", _MaskedBNAtLeastF32)
    try:
        pillar = dryrun.case("objdgcnn_pillar", PILLAR64, batch=2, seed=3,
                             dtype="float64", max_gt=4)
        init, pillar_ref = _jax_mesh_step(pillar, tmp)
    finally:
        mp.undo()
    pillar_one = os.path.join(tmp, "pillar_one.pt")
    dryrun.save_reference(pillar, pillar_one, "cpu", init=init)
    camera = dryrun.case("transcar_r101", CAMERA, batch=2, wire="u8_aug")
    camera_ref = os.path.join(tmp, "camera_ref.pt")
    dryrun.save_reference(camera, camera_ref, "cpu")
    tp = dryrun.case("transcar_r101", CAMERA, wire="u8_aug", dropout=0.1)
    train = ["--device", "cpu", "--max-steps", "2", "--log-interval", "1",
             "--eval-samples", "2", "--cfg-options",
             *TINY, f"data.data_root={fixture_root}",
             "train.optim.total_epochs=1"]
    one = os.path.join(tmp, "one")
    with dryrun.head_dropout(0.0):
        state = cli_train.main(["transcar_r101", "--work-dir", one, *train,
                                "data.samples_per_device=2"])
    two = os.path.join(tmp, "two")
    results = dryrun.spawn(dryrun.run_calls, 2, [
        ("dp_check", (pillar, pillar_ref, 1, init)),
        ("dp_check", (camera, camera_ref)),
        ("tp_check", (tp, 1, 2, dict(tp, dropout=0.0))),
        ("gather_check", ([3, 2],)),
        ("cli_train_check", (["transcar_r101", "--work-dir", two,
                              *train],)),
        ("dp_check", (pillar, pillar_one, 1, init))], threads=2)
    return {"ranks": results, "one": (one, state), "two": two}


def _param_paths(preset, options):
    """The JAX parameter tree of a tiny preset (shapes only)."""
    cfg = jcfg.get_preset(preset, pcfg.parse_overrides(options))
    model = jbuild_model(cfg, training=True)
    if cfg.model.lidar_encoder:
        b = dryrun.case_batch(dryrun.case(preset, options))
        args = (b["points"], b["num_points"])
    else:
        b = dryrun.case_batch(dryrun.case(preset, options))
        args = (b["images"], b["lidar2img"], b["radar_tokens"])
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             *args))["params"]


@pytest.mark.parametrize("preset,options", [
    ("transcar_r101", dryrun.TINY_TRANSCAR),
    ("objdgcnn_pillar", dryrun.TINY_PILLAR)])
def test_rule_table_matches_jax_spec_for(preset, options):
    """(a) Every parameter: the dim the port splits over 2 ranks (in its
    own layout) is the dim the JAX rule and guard split (in the flax
    layout), and ``shard_model`` gives each split parameter a split
    form."""
    shapes = _param_paths(preset, options)
    mesh = make_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    want = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_leaves_with_path(shapes),
            jax.tree_util.tree_leaves(tp_sharding_tree(shapes, mesh))):
        keys = [p.key for p in path]
        spec = tuple(sh.spec)
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}
                                     .get(keys[-1], keys[-1])])
        if "model" in spec:
            dim = spec.index("model")
            want[name] = 1 - dim if len(leaf.shape) == 2 \
                and keys[-1] == "kernel" else dim
    model = build_model(pcfg.get_preset(preset,
                                        pcfg.parse_overrides(options)),
                        device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(want) <= names
    got = split_dims(model, 2)
    assert got == want
    assert len(want) > 10
    split = shard_model(model, Grid(model_size=2))
    assert sorted(split) == sorted(want)


def test_loader_slices_the_global_batch(fixture_root):
    """(b) 2 processes: rank r's batches are rows r of the one-process
    global batches of 2, every leaf equal (per-sample draws do not depend
    on the rank)."""
    cfg = pcfg.get_preset("transcar_r101", pcfg.parse_overrides(
        TINY + [f"data.data_root={fixture_root}"]))
    ds = NuScenesInfos(os.path.join(fixture_root, cfg.data.ann_train),
                       data_root=fixture_root)
    one = list(PrefetchLoader(ds, cfg.data, 2, training=True,
                              seed=7).epoch(1))
    halves = [list(PrefetchLoader(ds, cfg.data, 2, training=True, seed=7,
                                  process_index=r, process_count=2)
                   .epoch(1)) for r in (0, 1)]
    assert len(one) == 2 and all(len(h) == 2 for h in halves)
    for b, whole in enumerate(one):
        for r in (0, 1):
            part = halves[r][b]
            assert set(part) == set(whole)
            for k in whole:
                np.testing.assert_array_equal(part[k], whole[k][r:r + 1],
                                              err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        PrefetchLoader(ds, cfg.data, 3, process_count=2)


def test_pillar_data_parallel_step_matches_jax_mesh(ranks):
    """(c) Float64, on both ranks.  Against the JAX mesh step: the summed
    gradients (before the clip) and their global norm to 1e-6 (``dryrun.
    grad_error``; read at 4.0e-8 and 5.5e-8 a tensor: both models round
    the FPN output to float32, so their gradients differ at float32's
    rounding), losses to rtol 1e-4, parameters and running statistics to
    rtol = atol = 1e-4 (tests/test_lidar_mesh.py's; one AdamW step moves a
    weight by about ± lr whatever its gradient, so the parameters alone
    would pass any gradient).  Against the port's one-process step of the
    global batch: the gradients and their norm to 1e-11 (read at 9e-15
    and 1.7e-14 a tensor), the losses and running statistics to 1e-12.
    The ranks bit for bit equal."""
    for res in ranks["ranks"]:
        r, one = res[0], res[5]
        assert r["grad_rel_err"] <= 1e-6 and r["grad_worst"] <= 1e-6, r
        assert r["norm_rel_err"] <= 1e-6, r["norm_rel_err"]
        assert r["loss_rel_err"] <= 1e-4, r["losses"]
        assert r["param_ratio"] <= 1.0, r["param_abs"]
        assert r["buffer_ratio"] <= 1.0, r["buffer_abs"]
        assert one["grad_rel_err"] <= 1e-11 and one["grad_worst"] <= 1e-11, \
            one
        assert one["norm_rel_err"] <= 1e-11, one["norm_rel_err"]
        assert one["loss_rel_err"] <= 1e-12, one["losses"]
        assert one["buffer_abs"] <= 1e-12, one["buffer_abs"]
        assert r["agree"] and one["agree"]


def test_camera_data_parallel_step_matches_one_process(ranks):
    """(d) The global batch of 2 on 2 ranks = one process (GridMask on,
    the same mask on both ranks), float32: the summed gradients and their
    norm to 1e-5 (``dryrun.grad_error``; read at 1.6e-7 and 1.8e-7 a
    tensor), losses to 1e-5, parameters to rtol = atol = 1e-4, ranks bit
    for bit equal."""
    for res in ranks["ranks"]:
        r = res[1]
        assert r["grad_rel_err"] <= 1e-5 and r["grad_worst"] <= 1e-5, r
        assert r["norm_rel_err"] <= 1e-5, r["norm_rel_err"]
        assert r["loss_rel_err"] <= 1e-5, r["losses"]
        assert r["param_ratio"] <= 1.0, r["param_abs"]
        assert r["agree"]


def test_tensor_parallel_head_matches_replicated(ranks):
    """(e) The JAX dry run's bar (loss within 1e-4 · (1 + |loss|), every
    parameter within 1e-3), dropout on; the gradients (the split ones
    gathered) and their norm, which the split clip takes, to 1e-4 of the
    replicated ones (read at 2.7e-7, 1.2e-6 a tensor and 6.9e-7, float32);
    the eval forward within 1e-5 of 1 + |ref|; the head's matmuls split
    on both ranks."""
    for res in ranks["ranks"]:
        r = res[2]
        assert r["grad_rel_err"] <= 1e-4 and r["grad_worst"] <= 1e-4, r
        assert r["norm_rel_err"] <= 1e-4, r["norm_rel_err"]
        assert r["loss_err"] <= 1e-4, (r["loss"], r["loss_rep"])
        assert r["param_abs"] < 1e-3
        assert r["eval_err"] <= 1e-5
        assert r["split"] > 50 and r["agree"]
        # the fusion attention on 4 of 8 heads, plain on the CPU
        assert r["k2_launches"] == 0 and len(r["k2_calls"]) == 3
        assert all(c["shape"][1] == 4 and c["max_abs_err"] == 0.0
                   for c in r["k2_calls"])


def test_camera_sharded_eval_is_unsharded_bit_for_bit():
    """(f) The eval forward with the CPU listed 2, 3 and 6 times equals
    bit for bit the unsharded forward whose backbone and FPN take as many
    cameras at a time (``dryrun.chunked_features``).  Listed 2 and 3
    times (3 and 2 cameras a group) it also equals the plain unsharded
    forward bit for bit; listed 6
    times (one camera a group) it agrees to 1e-4 of 1 + |ref|: oneDNN
    convolves a batch of one image with other kernels than a batch of
    six (stages 2-4 of the backbone differ by ~1e-5 on their own), so
    there the per-camera convolutions are not the same.
    ``camera_devices`` keeps the largest count that divides the cameras,
    as ``camera_mesh``."""
    spec = dryrun.case("transcar_r101", CAMERA)
    res = dryrun.camera_check(spec, "cpu")
    assert all(res["same_fpn"].values()), res["same_fpn"]
    assert all(res["same_equal"].values()), res["same_equal"]
    assert res["equal"][2] and res["equal"][3], res["rel_err"]
    assert res["fpn_equal"][2] and res["fpn_equal"][3], res["fpn_rel_err"]
    assert res["rel_err"][6] <= 1e-4, res["rel_err"]
    devs = jax.devices()
    for cams in (5, 6):
        for k in range(1, 9):
            assert len(camera_devices(cams, list(range(k)))) == \
                camera_mesh(cams, devs[:k]).devices.size


def test_allgather_eval_outputs_unequal_counts(ranks):
    """(g) 3 rows on rank 0, 2 on rank 1: every rank gets the 5 real rows
    in rank order, with their dtypes, and their indices in the padded
    stack of 2 × 3."""
    for res in ranks["ranks"]:
        g = res[3]
        np.testing.assert_array_equal(g["keep"], [0, 1, 2, 3, 4])
        got = g["gathered"]
        np.testing.assert_array_equal(got["labels"], [0, 1, 2, 100, 101])
        assert got["labels"].dtype == np.int32
        np.testing.assert_array_equal(got["valid"],
                                      [True, False, True, True, False])
        assert got["boxes"].shape == (5, 3, 2)
        np.testing.assert_array_equal(got["boxes"][:, 0, 0],
                                      [0, 1, 2, 100, 101])


def test_cli_train_on_two_ranks_matches_one_process(ranks):
    """(h) ``cli.train`` for 2 steps with ``data.samples_per_device=1`` on
    2 ranks against one process with 2: the logged global losses, the
    saved weights and the eval hook's submission; one log, one config,
    one checkpoint dir, from rank 0."""
    one, state = ranks["one"]
    two = ranks["two"]
    for res in ranks["ranks"]:
        r = res[4]
        assert r["step"] == 2 and r["agree"]
        for k, v in r["losses"].items():
            np.testing.assert_allclose(v, float(state.losses[k]),
                                       rtol=1e-5, err_msg=k)
        assert r["eval_tokens"] == list(
            state.last_eval.detections["tokens"])
    logs = [f for f in os.listdir(two) if f.endswith(".log.json")]
    assert len(logs) == 1
    recs = [json.loads(line) for line in open(os.path.join(two, logs[0]))]
    ones = [json.loads(line) for line in open(os.path.join(one, [
        f for f in os.listdir(one) if f.endswith(".log.json")][0]))]
    assert [r["mode"] for r in recs] == ["train", "train", "val"]
    for a, b in zip(recs[:2], ones[:2]):
        for k in a:
            if k.startswith(("loss", "d0.")) or k == "total":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4)
    assert os.listdir(os.path.join(two, "checkpoints")) == ["2"]
    sd2 = torch.load(os.path.join(two, "checkpoints", "2", "state.pt"),
                     weights_only=True)["model"]
    sd1 = torch.load(os.path.join(one, "checkpoints", "2", "state.pt"),
                     weights_only=True)["model"]
    for k, v in sd1.items():
        np.testing.assert_allclose(sd2[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    sub2 = json.load(open(os.path.join(two, "val_epoch1_nusc.json")))
    sub1 = json.load(open(os.path.join(one, "val_epoch1_nusc.json")))
    assert sub2["results"].keys() == sub1["results"].keys()
