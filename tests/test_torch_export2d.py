"""The port's ``data/export2d.py`` and ``cli/create_data.py`` against the JAX
package's, bit for bit on the same seeded inputs: the quaternion and box
geometry, the hull ∩ canvas clip, the record, ``get_2d_boxes`` and
``export_2d_annotation`` through the duck-typed nuScenes DB of
``tests/test_export2d.py`` (with seeded annotations added), and
``cache_radar_tokens`` on the ``v1.0-mini`` tables of
``tests/test_radar_io.py`` (the devkit is not installed, as in JAX's
tests).
"""
import json
import os
import pickle

import numpy as np
import pytest

from tests.test_export2d import FakeNusc
from tests.test_radar_io import _build_mini_nuscenes
from transcar_tpu.cli import create_data as jcreate
from transcar_tpu.data import export2d as je2
from transcar_tpu_torch.cli import create_data as create
from transcar_tpu_torch.data import export2d as e2


def _quats(seed, n=16):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_quaternions_and_box_geometry():
    qs = _quats(0)
    for a, b in zip(qs, qs[::-1]):
        _eq(e2.quat_mul(a, b), je2.quat_mul(a, b))
        _eq(e2.quat_inv(a), je2.quat_inv(a))
        _eq(e2.quat_rot_mat(a), je2.quat_rot_mat(a))
        assert e2.quat_yaw(a) == je2.quat_yaw(a)
        rng = np.random.default_rng(1)
        center, wlh, t = rng.normal(size=(3, 3)) * [[10], [2], [5]]
        box, jbox = (m.Box3D(center, np.abs(wlh), a, token="t")
                     for m in (e2, je2))
        for bx in (box, jbox):
            bx.translate(t)
            bx.rotate(b)
        _eq(box.center, jbox.center)
        _eq(box.quat, jbox.quat)
        _eq(box.corners(), jbox.corners())
    k = np.array([[800.0, 0, 800], [0, 800.0, 450], [0, 0, 1]])
    pts = np.random.default_rng(2).normal(size=(3, 12)) + [[0], [0], [6]]
    for normalize in (True, False):
        _eq(e2.view_points(pts, k, normalize),
            je2.view_points(pts, k, normalize))
    for depth in (True, False):
        _eq(e2.points_cam2img(pts.T, k, depth),
            je2.points_cam2img(pts.T, k, depth))


def test_hull_clip_and_post_process_coords():
    rng = np.random.default_rng(3)
    cases = [rng.uniform(-400, 2000, (8, 2)) * [1, 0.6] for _ in range(30)]
    cases += [np.array([[10, 20], [100, 20], [100, 80], [10, 80], [50, 50]]),
              np.array([[-50, -50], [2000, -50], [2000, 1000], [-50, 1000]]),
              np.array([[-10, -10], [-5, -10], [-7, -2]]),
              np.array([[1700, 100], [1900, 100], [1800, 300]]),
              np.array([[0, 0], [5, 5], [10, 10]]),          # collinear
              np.array([[-5, -5], [-1, -1], [-3, -3]])]
    for pts in cases:
        hull = e2._convex_hull(pts)
        _eq(hull, je2._convex_hull(pts))
        if len(hull) >= 3:
            _eq(e2._clip_poly_rect(hull, 1600.0, 900.0),
                je2._clip_poly_rect(hull, 1600.0, 900.0))
        for imsize in ((1600, 900), (800, 450)):
            _eq(e2.post_process_coords(pts.tolist(), imsize),
                je2.post_process_coords(pts.tolist(), imsize))
    ann = {"category_name": "human.pedestrian.adult"}
    for rec in ({"category_name": "vehicle.car"}, ann,
                {"category_name": "animal"}):
        _eq(e2.generate_record(rec, 1.5, 2.0, 30.25, 40.0, "sd", "f.jpg"),
            je2.generate_record(rec, 1.5, 2.0, 30.25, 40.0, "sd", "f.jpg"))


class SeededNusc(FakeNusc):
    """``tests/test_export2d.py``'s DB with a turned, offset camera and
    twelve seeded annotations: some in view, some clipped at the canvas
    edge, some behind the camera, of several categories."""

    def __init__(self, seed=4):
        super().__init__()
        rng = np.random.default_rng(seed)
        t = self.tables
        t["calibrated_sensor"]["cs0"].update(
            translation=[0.5, -0.2, 1.5], rotation=list(_quats(seed, 1)[0]))
        t["ego_pose"]["pose0"].update(translation=[600.0, 1600.0, 0.0],
                                      rotation=list(_quats(seed + 1, 1)[0]))
        cats = ["vehicle.car", "human.pedestrian.adult", "vehicle.truck",
                "movable_object.barrier", "animal"]
        anns = t["sample"]["samp0"]["anns"]
        for i in range(12):
            token = f"seed{i}"
            anns.append(token)
            t["sample_annotation"][token] = {
                "translation": list(rng.normal(size=3) * 8
                                    + [600.0, 1600.0, 1.0]),
                "size": list(rng.uniform(0.5, 5.0, 3)),
                "rotation": list(_quats(seed + 2 + i, 1)[0]),
                "visibility_token": str(rng.integers(1, 5)),
                "category_name": cats[i % len(cats)],
                "attribute_tokens": ["attr_mov"] if i % 2 else [],
            }


def test_get_2d_boxes_through_the_fake_db():
    for db in (FakeNusc(), SeededNusc()):
        for vis in (["", "1", "2", "3", "4"], ["3", "4"]):
            for mono3d in (True, False):
                got = e2.get_2d_boxes(db, "sd_cam", vis, mono3d)
                _eq(got, je2.get_2d_boxes(db, "sd_cam", vis, mono3d))
    assert len(e2.get_2d_boxes(SeededNusc(), "sd_cam",
                               ["", "1", "2", "3", "4"])) > 1


def test_export_2d_annotation_coco_json(tmp_path):
    cam_info = {
        "sample_data_token": "sd_cam",
        "data_path": "data/nuscenes/samples/CAM_FRONT/img0.jpg",
        "sensor2ego_rotation": [1, 0, 0, 0],
        "sensor2ego_translation": [0, 0, 0],
        "cam_intrinsic": np.array([[800.0, 0, 800], [0, 800.0, 450],
                                   [0, 0, 1]]),
    }
    info = {"token": "samp0", "ego2global_rotation": [1, 0, 0, 0],
            "ego2global_translation": [0, 0, 0],
            "cams": {cam: dict(cam_info) for cam in e2.CAM_TYPES}}
    pkl = tmp_path / "nuscenes_infos_val.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"infos": [info], "metadata": {"version": "fake"}}, f)
    for mono3d in (True, False):
        outs = [str(tmp_path / f"{who}_{mono3d}.json")
                for who in ("port", "jax")]
        coco = e2.export_2d_annotation(SeededNusc(), str(pkl), mono3d,
                                       outs[0])
        jcoco = je2.export_2d_annotation(SeededNusc(), str(pkl), mono3d,
                                         outs[1])
        _eq(coco, jcoco)
        assert open(outs[0]).read() == open(outs[1]).read()
        assert len(coco["images"]) == 6 and coco["annotations"]
    # the default name beside the pkl, as in JAX
    e2.export_2d_annotation(FakeNusc(), str(pkl))
    loaded = json.loads(
        (tmp_path / "nuscenes_infos_val_mono3d.coco.json").read_text())
    assert len(loaded["annotations"]) == 6


@pytest.fixture(scope="module")
def mini_nusc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_mini"))
    _build_mini_nuscenes(root, np.random.default_rng(42))
    return root


def test_cache_radar_tokens_equal_jax(mini_nusc, tmp_path, capsys):
    """The port's cache files equal the JAX package's, file by file."""
    import shutil

    jroot = str(tmp_path / "jax")
    shutil.copytree(mini_nusc, jroot)
    got = create.cache_radar_tokens(mini_nusc, "v1.0-mini", nsweeps=3,
                                    num_tokens=150)
    want = jcreate.cache_radar_tokens(jroot, "v1.0-mini", nsweeps=3,
                                      num_tokens=150)
    names = sorted(os.listdir(got))
    assert names and names == sorted(os.listdir(want))
    for name in names:
        a = np.load(os.path.join(got, name))
        b = np.load(os.path.join(want, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" → ")[0] == out[1].split(" → ")[0]


def test_create_data_needs_the_devkit_only_for_the_infos(tmp_path):
    """The infos walk and the 2D export import the devkit inside the
    function, as in JAX: without it they raise ImportError."""
    with pytest.raises(ImportError):
        create.create_nuscenes_infos(str(tmp_path), "v1.0-mini")
    with pytest.raises(ImportError):
        create.export_2d_annotations(str(tmp_path), "v1.0-mini",
                                     str(tmp_path))
