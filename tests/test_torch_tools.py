"""The port's host tools against the JAX package's (``tests/test_tools.py``
and the publish step of ``tests/test_cli_journey.py``):

  * ``cli.print_config``: the JSON of every preset equals JAX's;
  * ``cli.analyze_logs``: ``cal_train_time``'s stdout and ``plot_curve``'s
    CSV equal JAX's on one seeded log, and the PNG path renders;
  * ``eval/bev_plot.py``: the geometry (footprints, heading ticks,
    velocity arrows, the origin) and which boxes are drawn equal what the
    JAX module draws with matplotlib, bit for bit; one PNG a sample of the
    figure's size; ``cli.visualize_results``' stdout equals JAX's;
  * ``cli.publish_model``: round trip, and a hash that names the
    parameters;
  * ``cli.browse_dataset``: stdout equal to JAX's on
    ``chip_smoke.write_fixture``'s fixture.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from transcar_tpu.cli import analyze_logs as janalyze
from transcar_tpu.cli import browse_dataset as jbrowse
from transcar_tpu.cli import print_config as jprint_config
from transcar_tpu.cli import visualize_results as jviz
from transcar_tpu.core.config import list_presets
from transcar_tpu.eval import bev_plot as jbev
from transcar_tpu_torch.cli import (analyze_logs, browse_dataset,
                                    print_config, publish_model,
                                    visualize_results)
from transcar_tpu_torch.eval import bev_plot
from transcar_tpu_torch.train import checkpoint as ckpt


def _out(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("preset", sorted(list_presets()))
def test_print_config_equals_jax(preset, capsys):
    argv = [preset, "--cfg-options", "train.optim.lr=0.001",
            "model.head.num_query=300"]
    got = json.loads(_out(capsys, print_config.main, argv))
    assert got == json.loads(_out(capsys, jprint_config.main, argv))
    assert got["train"]["optim"]["lr"] == 0.001


def _seeded_log(path):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for epoch in (1, 2):
            for i in range(1, 6):
                f.write(json.dumps({
                    "mode": "train", "epoch": epoch, "iter": i,
                    "time": float(rng.uniform(0.3, 0.9)),
                    "loss_cls": float(rng.uniform(0, 2)),
                    "loss_bbox": float(rng.uniform(0, 3)),
                    "total": float(rng.uniform(1, 5))}) + "\n")
            f.write(json.dumps({"mode": "val", "epoch": epoch, "iter": 5,
                                "mAP": float(rng.uniform()),
                                "NDS": float(rng.uniform())}) + "\n")


def test_analyze_logs_equals_jax(tmp_path, capsys):
    log = str(tmp_path / "x.log.json")
    _seeded_log(log)
    argv = ["cal_train_time", log]
    timing = _out(capsys, analyze_logs.main, argv)
    assert timing == _out(capsys, janalyze.main, argv)
    assert "overall mean" in timing and "slowest epoch" in timing
    for keys, mode in ((["loss_cls", "loss_bbox"], "train"),
                       (["mAP", "NDS"], "eval")):
        outs = [str(tmp_path / f"{who}_{mode}.csv") for who in "pj"]
        for main, out in zip((analyze_logs.main, janalyze.main), outs):
            main(["plot_curve", log, "--keys", *keys, "--mode", mode,
                  "--out", out])
        assert open(outs[0]).read() == open(outs[1]).read()
    assert len(open(outs[0]).read().strip().split("\n")) == 3
    png = tmp_path / "curve.png"
    analyze_logs.main(["plot_curve", log, "--out", str(png)])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _submission(path, seed=0, n_samples=3):
    rng = np.random.default_rng(seed)
    names = ["car", "pedestrian", "truck", "barrier", "bicycle"]
    results = {}
    for s in range(n_samples):
        annos = []
        for i in range(9 if s else 0):        # the first sample: no box
            yaw = float(rng.uniform(-np.pi, np.pi))
            annos.append({
                "sample_token": f"tok{s}",
                "translation": [float(rng.uniform(600, 640)),
                                float(rng.uniform(1600, 1640)), 0.5],
                "size": [float(v) for v in rng.uniform(0.5, 5, 3)],
                "rotation": [float(np.cos(yaw / 2)), 0.0, 0.0,
                             float(np.sin(yaw / 2))],
                "velocity": [float(v) for v in rng.normal(size=2)
                             * (0.05 if i % 3 == 0 else 2.0)],
                "detection_name": names[i % len(names)],
                "detection_score": float(rng.uniform(0.1, 0.95)),
                "attribute_name": ""})
        results[f"tok{s}"] = annos
    with open(path, "w") as f:
        json.dump({"meta": {"use_camera": True}, "results": results}, f)
    return results


def _jax_drawing(monkeypatch, annos, out):
    """What the JAX ``render_bev`` draws: (footprint polygons, heading
    ticks, arrows, boxes drawn), recorded from its matplotlib calls."""
    from matplotlib.axes import Axes

    drawn = {"fill": [], "plot": [], "arrow": []}
    for name in drawn:
        orig = getattr(Axes, name)

        def rec(self, *args, _orig=orig, _name=name, **kwargs):
            drawn[_name].append(args)
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(Axes, name, rec)
    n = jbev.render_bev(annos, out)
    monkeypatch.undo()
    return drawn, n


def test_bev_geometry_and_gate_equal_jax(tmp_path, monkeypatch):
    results = _submission(str(tmp_path / "sub.json"))
    for token, annos in results.items():
        for thr in (0.0, 0.3, 0.9):
            kept = bev_plot.gated(annos, thr)
            assert kept == [a for a in annos
                            if a["detection_score"] >= thr]
        drawn, n = _jax_drawing(monkeypatch, annos,
                                str(tmp_path / f"jax_{token}.png"))
        kept = bev_plot.gated(annos, 0.3)
        assert n == len(kept) == len(drawn["fill"])
        origin = bev_plot.ego_origin(kept)
        geos = [bev_plot.box_geometry(a, origin) for a in kept]
        ticks = drawn["plot"][:-1]                 # the last: the ego mark
        arrows = iter(drawn["arrow"])
        for geo, (xs, ys), tick in zip(geos, drawn["fill"], ticks):
            np.testing.assert_array_equal(geo["corners"][:, 0], xs)
            np.testing.assert_array_equal(geo["corners"][:, 1], ys)
            x, y = geo["center"]
            assert tick == ([x, geo["front"][0]], [y, geo["front"][1]])
            if geo["arrow"] is not None:
                assert next(arrows) == (x, y, *geo["arrow"])
        assert next(arrows, None) is None
        assert len(ticks) == len(geos)
        rng = np.random.default_rng(5)
        for x, y, w, l, yaw in rng.normal(size=(8, 5)) * [9, 9, 2, 4, 2]:
            np.testing.assert_array_equal(
                bev_plot._box_corners_bev(x, y, w, l, yaw),
                jbev._box_corners_bev(x, y, w, l, yaw))


def test_render_and_visualize_results(tmp_path, capsys):
    from PIL import Image

    sub = str(tmp_path / "sub.json")
    _submission(sub)
    written = bev_plot.render_submission(sub, str(tmp_path / "viz"))
    assert len(written) == 3
    for p in written:
        with Image.open(p) as im:
            assert im.format == "PNG"
            assert im.size == (bev_plot.CANVAS, bev_plot.CANVAS)
    capsys.readouterr()
    argv = [sub, "--num", "2", "--score-thr", "0.4"]
    assert (_out(capsys, visualize_results.main, argv)
            == _out(capsys, jviz.main, argv))
    visualize_results.main([sub, "--save-dir", str(tmp_path / "viz2")])
    assert len(os.listdir(tmp_path / "viz2")) == 3


class _State:
    """What ``save_checkpoint`` reads of a train state."""

    def __init__(self, step):
        torch.manual_seed(step)
        self.model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                         torch.nn.BatchNorm1d(3))
        self.optimizer = torch.optim.AdamW(self.model.parameters())
        self.model(torch.randn(5, 4)).sum().backward()
        self.optimizer.step()
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda s: 1.0)
        self.step = step


def test_publish_model_round_trip_and_stable_hash(tmp_path, capsys):
    work = str(tmp_path / "work")
    for step in (1, 2):
        ckpt.save_checkpoint(work, _State(step))
    prefix = str(tmp_path / "pub" / "model")
    out = publish_model.main([work, prefix])
    assert out == publish_model.main([work, prefix])     # stable name
    assert "published params-only checkpoint" in capsys.readouterr().out
    want = _State(2).model.state_dict()
    got = ckpt.load_params_only(out)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert out.endswith("-" + publish_model.state_digest(want)[:8])
    first = publish_model.main([work, prefix, "--step", "1"])
    assert first != out
    assert ckpt.load_params_only(first, template=want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nusc_tools"))
    chip_smoke.write_fixture(path, hw=(48, 80), lidar_points=2000,
                             radar_points=8)
    return path


def test_browse_dataset_equals_jax(root, capsys):
    argv = ["transcar_r101", "--num", "3", "--cfg-options",
            f"data.data_root={root}", "data.img_hw=[48,80]"]
    got = _out(capsys, browse_dataset.main, argv)
    assert got == _out(capsys, jbrowse.main, argv)
    assert got.count("imgs=(6, ") == 3
