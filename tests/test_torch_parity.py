"""The port's ``cli/parity_check.py`` (``tests/test_parity_harness.py``'s
twin) on ``chip_smoke.write_fixture``'s fixture, at the tiny float32
camera sizes of ``tests/test_torch_data.py`` with the post-centre range
widened (random weights decode boxes at the range's corners, which the
default range would filter to no row at all):

  * a port capture compared by ``main`` on the same weights, a params-only
    checkpoint: ``PARITY PASSED`` with every deviation 0;
  * a captured token absent from the val infos is refused;
  * a JAX ``capture_outputs`` (its eval step jitted once) compared by the
    port's ``compare_outputs`` with the weights carried across
    (``from_jax_params``): boxes within 1e-3, scores within 1e-4, labels
    equal over the top 10.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_data import TINY, _inputs, cfgs
from tests.test_torch_model import _random_params
from transcar_tpu.cli import parity_check as jparity
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu_torch.cli import parity_check
from transcar_tpu_torch.cli.train import _try_radar_fn
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.train import checkpoint as ckpt
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

WIDE = "model.head.post_center_range=[-10000,-10000,-10000,10000,10000,10000]"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nusc_parity"))
    chip_smoke.write_fixture(path, hw=(48, 80), lidar_points=2000,
                             radar_points=8)
    return path


def test_port_capture_compare_round_trip(root, tmp_path, capsys):
    cfg, _ = cfgs(root, "transcar_r101", WIDE)
    model = build_model(cfg, device="cpu")
    npz = str(tmp_path / "captured.npz")
    parity_check.capture_outputs(cfg, model, npz,
                                 radar_fn=_try_radar_fn(cfg))
    data = np.load(npz)
    assert data["boxes"].shape == (2, 160, 9)
    assert int(data["num_dets"].sum()) > 0, "vacuous capture"
    weights = str(tmp_path / "weights")
    ckpt.save_params_only(weights, model)
    report_path = tmp_path / "report.json"
    rc = parity_check.main([
        "transcar_r101", "--checkpoint", weights, "--reference-npz", npz,
        "--box-tol", "0", "--score-tol", "0", "--report-out",
        str(report_path), "--device", "cpu", "--cfg-options", *TINY,
        f"data.data_root={root}", WIDE])
    assert rc == 0
    assert "PARITY PASSED" in capsys.readouterr().out
    report = json.loads(report_path.read_text())
    assert report["n_samples"] == 2 and report["compared_rows"] == 100
    assert report["box_max_abs"] == report["score_max_abs"] == 0.0
    assert report["label_agree_min"] == 1.0
    assert report["num_det_diff_max"] == 0


def test_token_mismatch_is_refused(root, tmp_path):
    cfg, _ = cfgs(root, "transcar_r101")
    npz = str(tmp_path / "bogus.npz")
    np.savez(npz, tokens=np.asarray(["not_a_token"]),
             boxes=np.zeros((1, 300, 9), np.float32),
             scores=np.zeros((1, 300), np.float32),
             labels=np.zeros((1, 300), np.int32),
             num_dets=np.asarray([0], np.int32))
    with pytest.raises(ValueError, match="not in"):
        parity_check.compare_outputs(cfg, None, npz)


def test_jax_capture_port_compare(root, tmp_path):
    cfg, jcfg = cfgs(root, "transcar_r101", WIDE)
    jmodel = jbuild_model(jcfg)
    params = _random_params(lambda k: jmodel.init(k, *_inputs(jcfg)))
    radar_fn = _try_radar_fn(cfg)
    npz = str(tmp_path / "jax.npz")
    jparity.capture_outputs(jcfg, params["params"], npz, radar_fn=radar_fn)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    report = parity_check.compare_outputs(cfg, model, npz,
                                          radar_fn=radar_fn, box_tol=1e-3,
                                          score_tol=1e-4, top_k=10)
    assert report["passed"], report
    assert report["n_samples"] == 2 and report["compared_rows"] == 20
    assert report["label_agree_min"] == 1.0
