"""Test-time augmentation in the port (``eval/tta.py``,
``train/step.py::aug_eval_step``, ``train/loop.evaluate(aug_test=...)``,
``cli.test --aug-test``) against the JAX package on the CPU:

  * the LiDAR flip helpers bit for bit against ``transcar_tpu/eval/tta.py``;
  * ``aug_eval_step`` against the JAX ``make_aug_eval_step`` (jitted once)
    on a tiny R50 camera detector with the weights carried across, from
    one uint8 batch; ``("identity",)`` alone equals ``eval_step`` bit for
    bit;
  * ``cli.test --aug-test --device cpu`` on ``chip_smoke.write_fixture``
    with a reference ``.pth``, also with ``quantize=int8``; a LiDAR preset
    and an unknown aug raise.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.geom import camera_ring_l2i
from tests.test_torch_data import TINY
from tests.test_torch_model import _random_params
from transcar_tpu.core import config as jconfig
from transcar_tpu.eval import tta as jtta
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.train import step as jstep
from transcar_tpu_torch.cli import test as cli_test
from transcar_tpu_torch.core import config as pconfig
from transcar_tpu_torch.eval import tta
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.train import loop
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.step import aug_eval_step, eval_step

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_flip_helpers_match_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(2, 20, 5)).astype(np.float32)
    for hor, ver in ((True, False), (False, True), (True, True)):
        _eq(tta.flip_points(torch.from_numpy(pts), hor, ver),
            jtta.flip_points(jnp.asarray(pts), hor, ver))
        for width in (7, 8, 9):          # the > 7 / > 8 velocity guards
            boxes = rng.normal(size=(5, width)).astype(np.float32)
            _eq(tta.unflip_boxes(torch.from_numpy(boxes), hor, ver),
                jtta.unflip_boxes(jnp.asarray(boxes), hor, ver))
    views = []
    for i in range(2):
        views.append({
            "boxes": rng.normal(size=(4, 9)).astype(np.float32),
            "scores": np.asarray([0.9 - i * 0.1, 0.5, 0.3, 0.2], np.float32),
            "labels": np.arange(4, dtype=np.int32),
            "valid": np.asarray([True, True, False, True])})
    flips = [(False, False), (True, True)]
    got = tta.merge_flip_detections(
        [{k: torch.from_numpy(v) for k, v in d.items()} for d in views],
        flips, max_num=5)
    want = jtta.merge_flip_detections(views, flips, max_num=5)
    assert got.keys() == want.keys()
    for k in got:
        _eq(got[k], want[k])
    # the input is left as it was
    assert not np.shares_memory(got["boxes"], views[0]["boxes"])


B, N, H, W, Q, T = 1, 2, 64, 96, 16, 40


def _tiny_cfgs():
    over = pconfig.parse_overrides(
        ["model.backbone.kind=resnet50", "model.backbone.compute_dtype=float32",
         f"model.head.num_cams={N}", f"model.head.num_query={Q}",
         "model.head.num_decoder_layers=1",
         f"model.head.num_radar_tokens={T}", "model.use_grid_mask=false"])
    return (pconfig.get_preset("transcar_r101", over),
            jconfig.get_preset("transcar_r101", over))


@pytest.fixture(scope="module")
def tta_case():
    """A uint8 batch (content 60 × 90 of 64 × 96, so the pad is zeroed),
    the tiny JAX detector and seeded random params, and the port's
    detector with them."""
    cfg, jcfg = _tiny_cfgs()
    rng = np.random.default_rng(9)
    batch = {
        "images": rng.integers(0, 256, (B, N, H, W, 3)).astype(np.uint8),
        "img_shape": np.asarray([[60, 90]], np.int32),
        "lidar2img": camera_ring_l2i(N, H, W)[None],
        "radar_tokens": np.full((B, T, 36), 500.0, np.float32)}
    batch["radar_tokens"][0, :20] = rng.normal(size=(20, 36))
    batch["radar_tokens"][0, :20, 0:2] = rng.uniform(-3, 3, (20, 2))
    jmodel = jbuild_model(jcfg)
    f32 = (np.zeros((B, N, H, W, 3), np.float32), batch["lidar2img"],
           batch["radar_tokens"])
    params = _random_params(lambda k: jmodel.init(k, *f32), seed=9)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return cfg, jcfg, jmodel, params, batch, model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_aug_eval_step_matches_jax(tta_case):
    # float32 on both sides: the backbone, FPN and head differ by
    # summation order only, so scores within 1e-5 and, where the scores
    # are separated, the same labels and boxes within 1e-4 of their scale
    # (the tolerances of tests/test_torch_loop.py's evaluate test)
    cfg, jcfg, jmodel, params, batch, model = tta_case
    augs = ("identity", "flip")
    want = jstep.make_aug_eval_step(jcfg, jmodel, augs)(params["params"],
                                                        batch)
    got = aug_eval_step(model, _torch_batch(batch), cfg, augs)
    scores = got["scores"][0].numpy()
    np.testing.assert_allclose(scores, np.asarray(want["scores"][0]),
                               atol=1e-5)
    gap = np.minimum(np.abs(np.diff(scores, prepend=np.inf)),
                     np.abs(np.diff(scores, append=-np.inf)))
    sep = gap > 1e-4
    assert sep.sum() > 5
    _eq(got["labels"][0].numpy()[sep], np.asarray(want["labels"][0])[sep])
    b, wb = got["boxes"][0].numpy()[sep], np.asarray(want["boxes"][0])[sep]
    assert np.abs(b - wb).max() <= 1e-4 * (1 + np.abs(wb).max())
    # the flipped view moves the result: the average is not a no-op
    single = eval_step(model, _torch_batch(batch), cfg)
    assert not torch.equal(single["scores"], got["scores"])


def test_identity_alone_equals_eval_step(tta_case):
    cfg, _, _, _, batch, model = tta_case
    got = aug_eval_step(model, _torch_batch(batch), cfg, ("identity",))
    want = eval_step(model, _torch_batch(batch), cfg)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_unknown_aug_and_lidar_presets_raise(tta_case):
    cfg, _, _, _, batch, model = tta_case
    with pytest.raises(ValueError, match=r"\['flip', 'identity'\]"):
        aug_eval_step(model, _torch_batch(batch), cfg, ("identity", "rot"))
    with pytest.raises(ValueError, match="camera-track only"):
        loop.evaluate(pconfig.get_preset("objdgcnn_pillar"), model,
                      aug_test=("identity", "flip"))
    with pytest.raises(ValueError, match="unknown aug"):
        loop.evaluate(cfg, model, aug_test=("mirror",))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc_tta")
    chip_smoke.write_fixture(str(root), hw=(60, 90), lidar_points=3000,
                             radar_points=12)
    ref = str(root / "ref.pth")
    chip_smoke.write_reference_pth(ref, blocks=(3, 4, 6, 3),
                                   with_dcn=(False,) * 4, num_layers=1,
                                   num_query=16)
    return str(root), ref


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_cli_test_aug_test(fixture_root, tmp_path, quantize):
    """``cli.test --aug-test`` (identity and flip) on the fixture's val
    sample from a reference ``.pth``, with and without int8 backbone
    convs: one result a sample, finite boxes, other scores than the plain
    run's; ``--aug-test identity`` gives the plain rows bit for bit."""
    root, ref = fixture_root
    argv = ["--device", "cpu", "--max-samples", "1", "--cfg-options", *TINY,
            f"data.data_root={root}", f"model.backbone.quantize={quantize}"]
    runs = {}
    for name, extra in (("tta", ["--aug-test"]),
                        ("identity", ["--aug-test", "identity"]),
                        ("plain", [])):
        out = str(tmp_path / f"{name}.json")
        res = cli_test.main(["transcar_r101", ref, "--out", out, *extra,
                             *argv])
        assert len(json.load(open(out))["results"]) == 1
        runs[name] = res.detections
    assert np.isfinite(runs["tta"]["boxes"]).all()
    for k in ("boxes", "scores", "labels", "valid"):
        _eq(runs["identity"][k], runs["plain"][k])
    assert not np.array_equal(runs["tta"]["scores"], runs["plain"]["scores"])
