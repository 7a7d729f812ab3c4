"""The port's voxel ObjDGCNN (``objdgcnn_voxel``) against the JAX package,
and its entry points, on the CPU.

The whole model runs at tests/test_dgcnn.py's voxel shapes (pc_range
±8 m, 0.5 × 0.5 × 0.75 m voxels on an (8, 32, 32) grid, 256 voxels of 5
points, one decoder layer of 8 queries) on the gather encoder, the
preset's, with seeded weights carried by ``from_jax_params`` (strict
load); the cloud's 237 voxels mark 485 sites at the first downsample,
so its cap of 256 binds, and the capped site sets are part of what
agrees.  The entry points
(``build_model``, ``cli.benchmark`` serving and ``--train``) run at tiny
overrides.  The JAX voxel train step is marked slow there
(tests/test_dgcnn.py:147): the vjp of the JAX gather encoder alone takes
tens of seconds to compile on a CPU, so the port's step is held to its
own invariants here: a finite loss, every sparse-conv
weight and BatchNorm statistic of the middle encoder moved.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_model import _random_params
from transcar_tpu.core.config import HeadConfig as JaxHeadConfig
from transcar_tpu.models import dgcnn as jdgcnn
from transcar_tpu_torch.cli import benchmark
from transcar_tpu_torch.core.config import HeadConfig, get_preset
from transcar_tpu_torch.models import dgcnn
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.models.sparse_encoder import SparseConvBlock
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

PC = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VOXEL = dict(voxel_size=(0.5, 0.5, 0.75), max_points=5, max_voxels=256,
             bev_hw=(32, 32), sparse_shape=(8, 32, 32))
# objdgcnn_voxel at a 64 × 64 × 8 m range of 2 × 2 × 1 m voxels: a
# (9, 32, 32) grid as the preset's (41, 1024, 1024), 256 voxels
TINY = ["model.voxel_size=[2.0,2.0,1.0]", "model.sparse_shape=[9,32,32]",
        "model.head.pc_range=[-32.0,-32.0,-5.0,32.0,32.0,3.0]",
        "data.max_points=3000", "model.max_voxels=256",
        "model.head.num_query=16", "model.head.num_decoder_layers=2"]


def t(a):
    return torch.from_numpy(np.asarray(a))


def _head_cfg(cls):
    return cls(num_query=8, num_decoder_layers=1, with_radar_fusion=False,
               num_levels=4, pc_range=PC)


def test_objdgcnn_voxel_forward_matches_jax_fp32():
    """Float32 throughout: the FPN levels and the outputs to 1e-4 of
    their scale."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-7, 7, (1, 300, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2.5, 2.5, (1, 300))
    num = np.array([250], np.int32)
    jmodel = jdgcnn.ObjDGCNN(_head_cfg(JaxHeadConfig), encoder="voxel",
                             compute_dtype="float32", **VOXEL)
    variables = _random_params(lambda k: jmodel.init(
        k, jnp.asarray(pts), jnp.asarray(num)), seed=2)
    out, state = jax.jit(lambda v, p, n: jmodel.apply(
        v, p, n, capture_intermediates=lambda m, _: m.name == "neck",
        mutable=["intermediates"]))(variables, pts, num)
    ref_levels = state["intermediates"]["neck"]["__call__"][0]

    model = dgcnn.ObjDGCNN(_head_cfg(HeadConfig), encoder="voxel",
                           compute_dtype="float32", **VOXEL)
    model.load_state_dict(from_jax_params(variables), strict=True)
    with torch.no_grad():
        levels = model.eval().bev_features(t(pts), t(num))
        got = model.head(levels)
    assert [tuple(f.shape) for f in levels] == [
        (1, 4, 4, 256), (1, 2, 2, 256), (1, 1, 1, 256), (1, 1, 1, 256)]
    for a, b in zip(levels, ref_levels):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, b = got[key].numpy(), np.asarray(out[key])
        assert a.shape == b.shape == (1, 1, 8, 10)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=key)


def test_build_model_objdgcnn_voxel():
    cfg = get_preset("objdgcnn_voxel")
    model = build_model(cfg, device="cpu")
    assert isinstance(model, dgcnn.ObjDGCNN) and not model.training
    enc = model.middle_encoder
    assert enc.impl == "gather" and enc.sparse_shape == (41, 1024, 1024)
    assert enc.compute_dtype is None                    # float32 gathers
    assert enc.out_conv.in_features == 6 * 128          # z' · C, folded
    assert model.backbone.layer_nums == (5, 5)
    heads = [m for m in model.modules()
             if isinstance(m, dgcnn.MSDeformAttention)]
    assert len(heads) == 8 and all(m.impl == "pallas" for m in heads)
    # he-normal sparse-conv weights, fan-in 27 · Cin
    blocks = [m for m in model.modules() if isinstance(m, SparseConvBlock)]
    assert len(blocks) == 12
    w = enc.stage3_conv1.weight.detach()
    assert w.shape == (27, 128, 128)
    assert abs(w.std().item() / np.sqrt(2 / (27 * 128)) - 1) < 0.02
    dense = build_model(get_preset("objdgcnn_voxel",
                                   {"model.sparse_impl": "dense"}),
                        device="cpu")
    assert dense.middle_encoder.compute_dtype == "bfloat16"
    assert dense.state_dict().keys() == model.state_dict().keys()


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_benchmark_cli_objdgcnn_voxel_on_cpu(capsys, impl):
    benchmark.main(["objdgcnn_voxel", "--device", "cpu", "--samples", "1",
                    "--warmup", "1", "--cfg-options", *TINY,
                    f"model.sparse_impl={impl}"])
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["max_points"] == 3000 and "pillar_audit" not in rec
    assert set(rec["kernel_launches"].values()) == {0}      # CPU: plain
    audit = rec["voxel_audit"]
    assert audit["voxels"] == audit["max_voxels"] == 256
    assert audit["z_layers"] == 8 and 1 <= audit["z_layers_reached"] <= 8
    assert len(audit["downsamples"]) == 3
    for down in audit["downsamples"]:
        cap = 256 if impl == "gather" else down["sites"]
        assert down["kept"] == min(down["sites"], cap) and down["kept"] > 0


def test_benchmark_cli_objdgcnn_voxel_trains_on_cpu():
    """Two steps through ``benchmark --train``: finite losses, every
    sparse-conv weight and ``out_conv`` of the middle encoder moved, and
    all of its BatchNorm running statistics."""
    argv = ["objdgcnn_voxel", "--train", "--device", "cpu", "--samples",
            "1", "--warmup", "1", "--cfg-options", *TINY]
    _, start, _, _ = benchmark._setup(benchmark.parse_args(argv),
                                      training=True)
    start = {k: v.clone() for k, v in start.state_dict().items()}
    rec, state = benchmark.run_train(argv)
    assert rec["steps"] == 2 and rec["launches_per_step"]["msdeform_forward"] \
        == 0
    for losses in (rec["loss_first"], rec["loss_last"]):
        assert all(np.isfinite(v) for v in losses.values())
    now = state.model.state_dict()
    enc = [k for k in now if k.startswith("middle_encoder.")]
    moved = {k for k in enc if not torch.equal(now[k], start[k])}
    weights = {k for k in enc if k.endswith(".weight")
               and not k.endswith("bn.weight")}
    stats = {k for k in enc if "running_" in k}
    assert len(weights) == 13 and weights <= moved
    assert len(stats) == 26 and stats <= moved
