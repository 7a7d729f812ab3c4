"""The port's copies of the JAX package's host-side data and eval code,
held equal to the originals bit for bit on the same seeded inputs:
``core/geometry.build_lidar2img``, ``data/infos.py`` (with CBGS),
``data/pipeline.py`` (decode routes, photometric draws and math, the
geometric transforms), ``data/radar_io.py`` and ``data/radar.py`` (on the
nuScenes tables that ``chip_smoke.write_fixture`` writes), ``data/points.py``,
``eval/submission.py``, ``eval/metrics.py`` and the ``native/`` C++
helpers (the port's libraries against the JAX package's).

Then the pieces between the loader and the model, at the sizes of
``tests/test_train_loop_e2e.py`` (R50 without DCN, 16 queries, one
decoder layer, images padded to 64 × 96): ``PrefetchLoader`` gives the
JAX loader's batches (both wires, both modalities);
``normalize_batch_images`` against the JAX one (jitted once), equal
without the photometric distortion and within 2e-2 with it;
``convert_detr3d_checkpoint`` + ``from_jax_params`` against the JAX
conversion carried across, the merge keeping the same entries; and
``fold_bn_into_conv`` against the JAX fold carried across, a folded
model's output within 1e-5 of the unfolded one.  No JAX train step is
compiled here.

The fixture is ``chip_smoke.write_fixture`` at a tiny size (48 × 80
JPEGs, 3 000 LiDAR points, 12 radar points a sweep).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_model import _random_params
from transcar_tpu import native as jnative
from transcar_tpu.core import config as jconfig
from transcar_tpu.core import geometry as jgeometry
from transcar_tpu.core.config import DataConfig as JDataConfig
from transcar_tpu.data import infos as jinfos
from transcar_tpu.data import loader as jloader
from transcar_tpu.data import pipeline as jpp
from transcar_tpu.data import points as jpoints
from transcar_tpu.data import radar as jradar
from transcar_tpu.data import radar_io as jradar_io
from transcar_tpu.eval import metrics as jmetrics
from transcar_tpu.eval import submission as jsub
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.train import convert as jconvert
from transcar_tpu.train import fold as jfold
from transcar_tpu.train import loop as jloop
from transcar_tpu.train import step as jstep
from transcar_tpu_torch import native
from transcar_tpu_torch.core import config as pconfig
from transcar_tpu_torch.core import geometry
from transcar_tpu_torch.core.config import DataConfig
from transcar_tpu_torch.data import infos, loader, pipeline as pp, points
from transcar_tpu_torch.data import radar, radar_io
from transcar_tpu_torch.data.synthetic import fake_batch
from transcar_tpu_torch.eval import metrics, submission
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.train import loop
from transcar_tpu_torch.train.convert import from_jax_params
from transcar_tpu_torch.train.fold import fold_bn_into_conv, frozen_bn_names
from transcar_tpu_torch.train.step import normalize_batch_images

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

HW = (48, 80)
TINY = ["model.backbone.kind=resnet50",
        "model.backbone.with_dcn=[false,false,false,false]",
        "model.backbone.compute_dtype=float32",
        "model.head.num_query=16", "model.head.num_decoder_layers=1",
        "data.img_hw=[64,96]", "data.max_gt_boxes=8", "data.workers=2",
        "data.max_points=2500", "model.voxel_size=[2.0,2.0,8.0]",
        "model.bev_hw=[52,52]", "model.max_voxels=400"]


def cfgs(root, preset, *extra):
    """The tiny preset from both config copies."""
    over = pconfig.parse_overrides(TINY + [f"data.data_root={root}",
                                           *extra])
    return (pconfig.get_preset(preset, over),
            jconfig.get_preset(preset, over))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_fixture"))
    chip_smoke.write_fixture(root, hw=HW, lidar_points=3000,
                             radar_points=12)
    return root


def _eq(a, b):
    """Nested equality, arrays bit for bit (NaN == NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)


def test_build_lidar2img():
    rng = np.random.default_rng(0)
    rot = rng.normal(size=(6, 3, 3))
    trans = rng.normal(size=(6, 3))
    intr = rng.normal(size=(6, 3, 3))
    _eq(geometry.build_lidar2img(rot, trans, intr),
        jgeometry.build_lidar2img(rot, trans, intr))


def test_infos_and_cbgs(fixture_root):
    ann = os.path.join(fixture_root, "nuscenes_infos_train.pkl")
    mine = infos.NuScenesInfos(ann, data_root=fixture_root)
    ref = jinfos.NuScenesInfos(ann, data_root=fixture_root)
    assert len(mine) == len(ref) == 4
    for i in range(len(ref)):
        _eq(vars(mine.get_sample(i)), vars(ref.get_sample(i)))
        _eq(mine.get_lidar_sample(i)[1:], ref.get_lidar_sample(i)[1:])
    _eq(infos.cbgs_indices(mine), jinfos.cbgs_indices(ref))
    _eq(infos.cbgs_indices(mine, np.random.default_rng(3)),
        jinfos.cbgs_indices(ref, np.random.default_rng(3)))
    assert infos.NAME_MAPPING == jinfos.NAME_MAPPING
    # the val split's test mode drops the annotations in both
    val = os.path.join(fixture_root, "nuscenes_infos_val.pkl")
    _eq(vars(infos.NuScenesInfos(val, test_mode=True).get_sample(1)),
        vars(jinfos.NuScenesInfos(val, test_mode=True).get_sample(1)))


def test_pipeline_photometric_draws_and_math():
    for seed in range(3):
        _eq(pp.draw_photometric_params(np.random.default_rng(seed), 6),
            jpp.draw_photometric_params(np.random.default_rng(seed), 6))
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 255, (9, 13, 3)).astype(np.float32)
            for _ in range(6)]
    _eq(pp.photometric_distortion(imgs, np.random.default_rng(4)),
        jpp.photometric_distortion(imgs, np.random.default_rng(4)))
    _eq(pp._bgr2hsv(imgs[0] - 40.0), jpp._bgr2hsv(imgs[0] - 40.0))
    hsv = pp._bgr2hsv(imgs[1])
    _eq(pp._hsv2bgr(hsv), jpp._hsv2bgr(hsv))
    mean, std = (103.53, 116.28, 123.675), (57.0, 57.0, 58.0)
    _eq(pp.normalize_images(imgs, mean, std, True),
        jpp.normalize_images(imgs, mean, std, True))


def test_pipeline_geometric_transforms():
    rng = np.random.default_rng(2)
    imgs = [rng.uniform(0, 255, (20, 30, 3)).astype(np.float32)
            for _ in range(3)]
    l2i = rng.normal(size=(3, 4, 4)).astype(np.float32)
    boxes = rng.normal(size=(5, 9)).astype(np.float32)
    _eq(pp.pad_to_divisor(imgs, 32), jpp.pad_to_divisor(imgs, 32))
    _eq(pp.crop_images(imgs, (11, 17)), jpp.crop_images(imgs, (11, 17)))
    _eq(pp._resize_bilinear(imgs[0], (13, 41)),
        jpp._resize_bilinear(imgs[0], (13, 41)))
    _eq(pp.random_scale_images(imgs, l2i, boxes, np.random.default_rng(5)),
        jpp.random_scale_images(imgs, l2i, boxes, np.random.default_rng(5)))
    _eq(pp.horizontal_flip(imgs, l2i, boxes),
        jpp.horizontal_flip(imgs, l2i, boxes))
    _eq(pp.stack_views(imgs, np.uint8), jpp.stack_views(imgs, np.uint8))


def test_pipeline_decode_routes(fixture_root, monkeypatch):
    ds = infos.NuScenesInfos(
        os.path.join(fixture_root, "nuscenes_infos_train.pkl"))
    paths = ds.get_sample(0).img_paths
    ref = jpp.load_multiview_stack_u8(paths, 32)
    before = dict(pp.decode_routes)
    _eq(pp.load_multiview_stack_u8(paths, 32), ref)      # native
    assert pp.decode_routes["native"] == before["native"] + 1
    _eq(pp.load_multiview_images(paths), jpp.load_multiview_images(paths))
    _eq(pp.load_multiview_images_u8(paths),
        jpp.load_multiview_images_u8(paths))

    def broken(*args):
        raise RuntimeError("no libjpeg")

    monkeypatch.setattr(native, "decode_jpeg_multiview", broken)
    _eq(pp.load_multiview_stack_u8(paths, 32), ref)      # PIL
    assert pp.decode_routes["pil"] == before["pil"] + 1
    assert pp.last_fallback == "RuntimeError: no libjpeg"
    assert ref[0].shape == (6, 64, 96, 3) and list(ref[1]) == list(HW)


def test_pipeline_pil_route_on_png_and_grey(tmp_path):
    """Non-JPEG inputs take the PIL route in both packages: RGB and
    greyscale PNGs give the same padded stack; sizes that disagree
    raise."""
    from PIL import Image

    rng = np.random.default_rng(11)
    paths = []
    for i, mode in enumerate(("RGB", "L", "RGB")):
        shape = (37, 53, 3) if mode == "RGB" else (37, 53)
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                        mode).save(path)
        paths.append(path)
    _eq(pp.load_multiview_stack_u8(paths, 32),
        jpp.load_multiview_stack_u8(paths, 32))
    Image.fromarray(np.zeros((40, 53, 3), np.uint8)).save(paths[2])
    with pytest.raises(ValueError, match="disagree on size"):
        pp.load_multiview_stack_u8(paths, 32)


def test_pcd_round_trip_and_multisweep(fixture_root, tmp_path):
    rng = np.random.default_rng(6)
    pts = chip_smoke._fixture_radar_sweep(rng, 17)
    pts[14, ::4] = 7                                  # filtered out
    radar_io.write_radar_pcd(str(tmp_path / "a.pcd"), pts)
    jradar_io.write_radar_pcd(str(tmp_path / "b.pcd"), pts)
    assert (tmp_path / "a.pcd").read_bytes() == (tmp_path / "b.pcd"
                                                 ).read_bytes()
    _eq(radar_io.read_radar_pcd(str(tmp_path / "a.pcd")),
        jradar_io.read_radar_pcd(str(tmp_path / "a.pcd")))
    mine = radar_io.NuScenesTables(fixture_root)
    ref = jradar_io.NuScenesTables(fixture_root)
    assert mine.tokens("sample") == ref.tokens("sample")
    for tok in mine.tokens("sample"):
        for chan in radar.RADAR_CHANNELS:
            for n in (1, 5):
                _eq(radar_io.radar_multisweep(mine, mine.get("sample", tok),
                                              chan, nsweeps=n),
                    jradar_io.radar_multisweep(ref, ref.get("sample", tok),
                                               chan, nsweeps=n))


@pytest.mark.parametrize("use_native", [True, False])
def test_radar_tokens(fixture_root, use_native):
    mine = radar_io.NuScenesTables(fixture_root)
    ref = jradar_io.NuScenesTables(fixture_root)
    before = dict(radar.featurize_routes)
    for tok in mine.tokens("sample"):
        got = radar.load_radar_tokens(mine, tok, num_tokens=300,
                                      use_native=use_native)
        _eq(got, jradar.load_radar_tokens(ref, tok, num_tokens=300,
                                          use_native=use_native))
        n_real = int((got[:, 0] != 500.0).sum())
        assert 0 < n_real < 300              # real tokens and sentinels
    route = "native" if use_native else "numpy"
    assert radar.featurize_routes[route] == before[route] + 6
    _eq(radar.empty_radar_tokens(40), jradar.empty_radar_tokens(40))


def test_prepare_lidar_sample(fixture_root):
    ann = os.path.join(fixture_root, "nuscenes_infos_train.pkl")
    mine = infos.NuScenesInfos(ann, data_root=fixture_root)
    ref = jinfos.NuScenesInfos(ann, data_root=fixture_root)
    for cfg_kw in ({}, {"lidar_sweeps": 3, "point_shuffle": False}):
        cfg = DataConfig(max_points=2500, max_gt_boxes=8, **cfg_kw)
        jcfg = JDataConfig(max_points=2500, max_gt_boxes=8, **cfg_kw)
        for i in range(2):
            info, b, lab = mine.get_lidar_sample(i)
            jinfo, jb, jlab = ref.get_lidar_sample(i)
            for training in (True, False):
                _eq(points.prepare_lidar_sample(
                        info, cfg, training, np.random.default_rng(i),
                        rebase=mine._rebase, gt_boxes=b, gt_labels=lab),
                    jpoints.prepare_lidar_sample(
                        jinfo, jcfg, training, np.random.default_rng(i),
                        rebase=ref._rebase, gt_boxes=jb, gt_labels=jlab))


def test_submission_and_native_metrics(fixture_root, tmp_path):
    """Decoded rows near the val boxes → the same submission and the same
    native metrics (non-trivial: some detections match)."""
    with open(os.path.join(fixture_root, "nuscenes_infos_val.pkl"),
              "rb") as f:
        val = pickle.load(f)["infos"]
    names = DataConfig().class_names
    rng = np.random.default_rng(8)
    results, jresults = {}, {}
    for info in val:
        boxes = np.zeros((12, 9), np.float32)
        g = info["gt_boxes"]
        boxes[:3, :7] = g + rng.normal(0, 0.3, g.shape)
        boxes[:3, 2] -= boxes[:3, 5] / 2
        boxes[3:, :2] = rng.uniform(-60, 60, (9, 2))
        boxes[3:, 3:6] = rng.uniform(0.5, 4, (9, 3))
        boxes[:, 7:] = rng.normal(0, 1, (12, 2))
        scores = rng.uniform(0, 1, 12).astype(np.float32)
        labels = np.r_[[names.index(n) for n in info["gt_names"]],
                       rng.integers(0, 10, 9)].astype(np.int32)
        valid = rng.uniform(size=12) > 0.1
        results[info["token"]] = submission.detections_to_nusc_annos(
            boxes, scores, labels, valid, info, names)
        jresults[info["token"]] = jsub.detections_to_nusc_annos(
            boxes, scores, labels, valid, info, names)
    _eq(results, jresults)
    path = submission.write_submission(results, str(tmp_path / "r.json"))
    jpath = jsub.write_submission(jresults, str(tmp_path / "j.json"))
    assert open(path).read() == open(jpath).read()
    got = metrics.evaluate_native(path, infos=val)
    _eq(got, jmetrics.evaluate_native(jpath, infos=val))
    assert got["mAP"] > 0
    _eq(submission.quat_to_rot(np.array([0.3, 0.1, -0.5, 0.8])),
        jsub.quat_to_rot(np.array([0.3, 0.1, -0.5, 0.8])))


def test_native_libraries_against_the_jax_packages(fixture_root):
    rng = np.random.default_rng(9)
    cost = rng.uniform(size=(7, 11)).astype(np.float32)
    _eq(native.lapjv(cost), jnative.lapjv(cost))
    costs = rng.uniform(size=(3, 6, 9)).astype(np.float32)
    rows = np.int32([6, 2, 0])
    _eq(native.lapjv_batched(costs, rows), jnative.lapjv_batched(costs, rows))
    per = [(chip_smoke._fixture_radar_sweep(rng, n),
            rng.uniform(0, 0.3, (1, n))) for n in (5, 0, 9, 3, 4)]
    rots = [jsub.quat_to_rot(chip_smoke._yaw_quat(y))
            for y in (0.0, 1.0, -1.0, 2.5, -2.5)]
    ref_rot = jsub.quat_to_rot(chip_smoke._yaw_quat(0.1))
    _eq(native.radar_featurize(per, rots, ref_rot, num_tokens=40),
        jnative.radar_featurize(per, rots, ref_rot, num_tokens=40))
    ds = infos.NuScenesInfos(
        os.path.join(fixture_root, "nuscenes_infos_train.pkl"))
    datas = [open(p, "rb").read() for p in ds.get_sample(1).img_paths]
    _eq(native.decode_jpeg_multiview(datas, 64, 96),
        jnative.decode_jpeg_multiview(datas, 64, 96))


@pytest.mark.parametrize("preset,on_device", [
    ("transcar_r101", True), ("transcar_r101", False),
    ("objdgcnn_pillar", True)])
def test_loader_batches_match_jax(fixture_root, preset, on_device):
    cfg, jcfg = cfgs(fixture_root, preset,
                     f"data.normalize_on_device={str(on_device).lower()}")
    ann = os.path.join(fixture_root, cfg.data.ann_train)
    lidar = bool(cfg.model.lidar_encoder)
    kw = dict(batch_size=2, training=True, seed=3,
              modality="lidar" if lidar else "camera")
    # the JAX reader must be indexed before the loader's threads share it
    # (its CLI does so); the port's locks its own
    tables = (radar_io.NuScenesTables(fixture_root),
              jradar_io.NuScenesTables(fixture_root))
    tables[1].tokens("sample")
    mine = loader.PrefetchLoader(
        infos.NuScenesInfos(ann, data_root=fixture_root), cfg.data,
        radar_fn=None if lidar else
        lambda tok: radar.load_radar_tokens(tables[0], tok, num_tokens=60),
        **kw)
    ref = jloader.PrefetchLoader(
        jinfos.NuScenesInfos(ann, data_root=fixture_root), jcfg.data,
        radar_fn=None if lidar else
        lambda tok: jradar.load_radar_tokens(tables[1], tok, num_tokens=60),
        **kw)
    for epoch in (0, 1):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _eq(g, w)
    # a resumed epoch skips the batches its checkpoint had taken
    _eq(next(mine.epoch(1, start=1)), list(ref.epoch(1))[1])
    if on_device and not lidar:
        assert got[0]["images"].dtype == np.uint8
        assert "photo_params" in got[0]


def test_loader_to_device_and_one_process():
    """to_device; and a loader of several processes takes a global batch
    that they divide (tests/test_torch_parallel.py checks its rows)."""
    batch = {"images": np.zeros((1, 2, 4, 4, 3), np.uint8),
             "num_gt": np.int32([3])}
    out = loader.to_device(batch, "cpu")
    assert out["images"].dtype == torch.uint8 and out["num_gt"].tolist() == [3]
    two = loader.PrefetchLoader(None, pconfig.DataConfig(), 4,
                                indices=np.arange(8), process_index=1,
                                process_count=2)
    assert (two.process_index, two.process_count, len(two)) == (1, 2, 2)
    with pytest.raises(ValueError, match="not divisible by 2"):
        loader.PrefetchLoader(None, pconfig.DataConfig(), 1, process_count=2)


def test_normalize_batch_images_matches_jax(fixture_root):
    cfg, jcfg = cfgs(fixture_root, "transcar_r101")
    ds = infos.NuScenesInfos(os.path.join(fixture_root, cfg.data.ann_train),
                             data_root=fixture_root)
    batch = loader.collate([
        loader.prepare_sample(ds.get_sample(i), cfg.data, True,
                              np.random.default_rng(i)) for i in (0, 1)])
    plain = {k: v for k, v in batch.items() if not k.startswith("photo")}
    ref_fn = jax.jit(lambda b: jstep.normalize_batch_images(b, jcfg.data)
                     ["images"])
    for b, exact in ((plain, True), (batch, False)):
        got = normalize_batch_images(
            {k: torch.from_numpy(v) for k, v in b.items()},
            cfg.data)["images"].numpy()
        want = np.asarray(ref_fn({k: jnp.asarray(v) for k, v in b.items()}))
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 2e-2
            assert not np.array_equal(got, np.asarray(ref_fn(plain)))


def _jax_template(cfg, preset_inputs):
    model = jbuild_model(cfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             *preset_inputs))["params"]


def _inputs(cfg):
    n = cfg.model.head.num_cams
    h, w = cfg.data.img_hw
    return (np.zeros((1, n, h, w, 3), np.float32),
            np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1)),
            np.full((1, cfg.model.head.num_radar_tokens, 36), 500.0,
                    np.float32))


def test_reference_checkpoint_conversion_and_merge(fixture_root, tmp_path, capsys):
    """A camera-only reference ``.pth``: the port's load equals the JAX
    conversion carried across on every converted entry, and both keep the
    same entries (the fusion heads) at their fresh init."""
    cfg, jcfg = cfgs(fixture_root, "transcar_r101")
    path = str(tmp_path / "ref.pth")
    chip_smoke.write_reference_pth(path, blocks=(3, 4, 6, 3),
                                   with_dcn=(False,) * 4, num_layers=1,
                                   num_query=16)
    model = build_model(cfg, device="cpu")
    merged = loop._load_params(path, cfg, model)
    printed = capsys.readouterr().out
    params, report = jconvert.convert_detr3d_checkpoint(
        jconvert.load_torch_state_dict(path), num_decoder_layers=1,
        backbone="resnet50", with_dcn=(False,) * 4, with_radar_fusion=True)
    assert report["missing"] and all(      # camera-only: no fusion keys
        k.split(".")[1].startswith(("radar_", "rf_", "final_"))
        for k in report["missing"])
    assert f"[load_from] {len(report['missing'])} missing keys" in printed
    carried = from_jax_params(params)
    jmerged, jkept = jloop._merge_over_template(
        _jax_template(jcfg, _inputs(jcfg)), params)
    kept = set(model.state_dict()) - set(carried)
    assert len(kept) == len(jkept) > 0
    assert all(k.startswith("head.") for k in kept)
    assert f"[load_from] {len(kept)} params kept at fresh init" in printed
    template = model.state_dict()
    for k, v in merged.items():
        if k in kept:
            assert torch.equal(v, template[k]), k
        else:
            assert torch.equal(v, carried[k]), k
    model.load_state_dict(merged)            # strict: every key present


def test_fold_bn_matches_jax_and_keeps_the_output(fixture_root):
    cfg, jcfg = cfgs(fixture_root, "detr3d_r101")
    inputs = _inputs(jcfg)[:2]
    jmodel = jbuild_model(jcfg)
    params = _random_params(lambda k: jmodel.init(k, *inputs))
    model = build_model(cfg, device="cpu")
    sd = from_jax_params(params)
    model.load_state_dict(sd)
    folded = fold_bn_into_conv(sd, frozen_bn_names(model))
    want = from_jax_params(jfold.fold_bn_into_conv(
        jax.tree_util.tree_map(np.asarray, params)))
    assert folded.keys() == want.keys()
    for k in want:
        assert torch.equal(folded[k], want[k]), k
    changed = [k for k in sd if not torch.equal(sd[k], folded[k])]
    assert any(k.endswith("conv.weight") for k in changed)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 6, 64, 96, 3)).astype(
        np.float32))
    l2i = torch.from_numpy(fake_batch(np.random.default_rng(0), 1, 6, 64,
                                      96, 4)["lidar2img"])
    with torch.no_grad():
        ref = model(x, l2i)
        model.load_state_dict(folded)
        got = model(x, l2i)
    for key in ref:
        scale = ref[key].abs().max()
        assert (got[key] - ref[key]).abs().max() <= 1e-5 * (1 + scale)
