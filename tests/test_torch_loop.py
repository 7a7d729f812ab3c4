"""The port's checkpoints, train loop, eval hook and CLIs on the CPU, at
the sizes of ``tests/test_train_loop_e2e.py`` (R50 without DCN, 16
queries, one decoder layer, 64 × 96 images), on
``chip_smoke.write_fixture``'s nuScenes-layout fixture:

  * a preempted run (SIGTERM) saves and logs ``preempted``, and resumed,
    its step equals an uninterrupted run's bit for bit; checkpoints keep
    the newest five and load back strictly;
  * ``cli.train`` / ``cli.test`` with ``--device cpu``; without it and
    without CUDA they raise; the later slices' flags raise;
  * the slice: the port's ``evaluate`` against the JAX ``make_eval_step``
    (jitted once) on the same loader batches with the weights carried
    across.

No JAX train step is compiled here.
"""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_data import TINY, _inputs, cfgs
from tests.test_torch_model import _random_params
from transcar_tpu.data import infos as jinfos
from transcar_tpu.data import loader as jloader
from transcar_tpu.models.detector import build_model as jbuild_model
from transcar_tpu.train import step as jstep
from transcar_tpu_torch.cli import test as cli_test
from transcar_tpu_torch.cli import train as cli_train
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.train import checkpoint as ckpt
from transcar_tpu_torch.train import loop
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nusc_loop"))
    chip_smoke.write_fixture(path, hw=(60, 90), lidar_points=3000,
                             radar_points=12)
    return path


def cli_args(root, *extra):
    return ["--device", "cpu", "--cfg-options", *TINY,
            f"data.data_root={root}", *extra]


def _train(root, work, max_steps, resume=False, preset="transcar_r101"):
    cfg, _ = cfgs(root, preset, f"train.work_dir={work}",
                  "train.eval_interval_epochs=0",
                  "train.optim.total_epochs=1",
                  *([f"train.resume_from={work}"] if resume else []))
    return loop.train(cfg, radar_fn=cli_train._try_radar_fn(cfg),
                      max_steps=max_steps, log_interval=1, device="cpu")


def _preempt_after(monkeypatch, step: int):
    """SIGTERM to this process right after train step ``step``."""
    step_fn = loop.train_step

    def step_then_signal(state, *args):
        out = step_fn(state, *args)
        if state.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(loop, "train_step", step_then_signal)


def test_preempted_run_resumes_bit_for_bit(root, tmp_path, monkeypatch):
    """A run of 3 steps preempted (SIGTERM) after step 2 saves, logs
    ``preempted`` and returns; resumed mid-epoch to step 3, it has the
    step-3 loss and weights of an uninterrupted run, bit for bit
    (per-step generators, the skipped batches)."""
    whole = _train(root, str(tmp_path / "a"), 3)
    work = str(tmp_path / "b")
    with monkeypatch.context() as m:
        _preempt_after(m, 2)
        cut = _train(root, work, 3)
    assert cut.step == 2
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    recs = [json.loads(line) for f in os.listdir(work)
            if f.endswith(".log.json")
            for line in open(os.path.join(work, f))]
    assert recs[-1] == {"mode": "train", "epoch": 1, "preempted": True,
                        "step": 2}
    resumed = _train(root, work, 3, resume=True)
    assert whole.step == resumed.step == 3
    for k, v in whole.losses.items():
        assert torch.equal(v, resumed.losses[k]), k
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == \
        ["2", "3"]
    # a step dir round-trips through the strict params-only load
    sd = ckpt.load_params_only(os.path.join(work, "checkpoints", "3"), a)
    assert all(torch.equal(sd[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="does not match the model"):
        ckpt.load_params_only(os.path.join(work, "checkpoints", "3"),
                              {**a, "extra.weight": torch.zeros(1)})


def test_checkpoints_keep_the_newest_five(root, tmp_path):
    cfg, _ = cfgs(root, "detr3d_r101")
    state = loop.init_state(cfg, build_model(cfg, device="cpu"), 10)
    for step in range(1, 8):
        state.step = step
        ckpt.save_checkpoint(str(tmp_path), state, {"name": "x"})
    assert sorted(map(int, os.listdir(tmp_path / "checkpoints"))) == \
        [3, 4, 5, 6, 7]
    state.step = 0
    assert ckpt.restore_checkpoint(str(tmp_path), state) == 7
    assert json.load(open(tmp_path / "checkpoints" / "7" / "config.json")) \
        == {"name": "x"}
    # a params-only file loads strictly through the eval CLI's loader
    ckpt.save_params_only(str(tmp_path / "pub" / "params.bin"), state.model)
    sd = loop._load_params(str(tmp_path / "pub" / "params.bin"), cfg,
                           build_model(cfg, device="cpu", seed=1))
    want = state.model.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_cli_train_and_test_on_the_cpu(root, tmp_path):
    work = str(tmp_path / "w")
    state = cli_train.main(["detr3d_r101", "--work-dir", work,
                            "--max-steps", "2", "--eval-samples", "1",
                            "--log-interval", "1"] + cli_args(root))
    assert os.listdir(os.path.join(work, "checkpoints")) == ["2"]
    logs = [f for f in os.listdir(work) if f.endswith(".log.json")]
    recs = [json.loads(line) for line in open(os.path.join(work, logs[0]))]
    assert [r["step"] for r in recs if r["mode"] == "train"] == [1, 2]
    assert recs[-1]["mode"] == "val" and recs[-1]["metrics_source"] == \
        "native"
    out = str(tmp_path / "r.json")
    res = cli_test.main(["detr3d_r101", os.path.join(work, "checkpoints",
                                                     "2"),
                         "--out", out, "--max-samples", "1", "--eval"]
                        + cli_args(root))
    assert res.path == out and list(json.load(open(out))["results"]) == \
        ["sample4"]
    # the hook and the CLI evaluate the same weights the same way
    np.testing.assert_array_equal(res.detections["boxes"],
                                  state.last_eval.detections["boxes"])


def test_cli_device_and_later_flags(root, tmp_path, capsys, monkeypatch):
    """Without CUDA and without ``--device cpu`` both CLIs raise.
    ``--autoscale-lr`` scales the lr by the card count / 8 (1 / 8 in one
    process) and ``--shard-cameras`` with one device takes the one-device
    path and says so; ``--show-dir`` writes one BEV PNG a sample."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--cfg-options", *TINY, f"data.data_root={root}"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(["detr3d_r101", "--max-steps", "1"] + argv)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_test.main(["detr3d_r101", "x"] + argv)
    work = str(tmp_path / "w")
    state = cli_train.main(["detr3d_r101", "--work-dir", work,
                            "--max-steps", "1", "--no-validate",
                            "--autoscale-lr"] + cli_args(root))
    lr = pconfig_lr("detr3d_r101") / 8
    assert f"autoscale-lr: 1 devices → lr {lr:.2e}" in capsys.readouterr().out
    assert state.scheduler.base_lrs[0] == pytest.approx(lr)
    res = cli_test.main(["detr3d_r101", os.path.join(work, "checkpoints",
                                                     "1"),
                         "--shard-cameras", "--max-samples", "1",
                         "--out", str(tmp_path / "r.json"),
                         "--show-dir", str(tmp_path / "show")]
                        + cli_args(root))
    out = capsys.readouterr().out
    assert "[shard-cameras] 1 device for 6 cameras: the one-device path" \
        in out
    assert res.detections["boxes"].shape[0] == 1
    pngs = list((tmp_path / "show").glob("*.png"))
    assert len(pngs) == 1 and f"rendered {pngs[0]}" in out
    assert pngs[0].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def pconfig_lr(preset):
    from transcar_tpu_torch.core.config import get_preset
    return get_preset(preset).train.optim.lr


def test_evaluate_matches_the_jax_eval_step(root):
    """The slice: val batches through the port's ``evaluate`` and through
    the JAX ``make_eval_step`` (jitted once), the weights carried across:
    boxes within 1e-4 of their scale, labels equal where the scores are
    separated."""
    cfg, jcfg = cfgs(root, "transcar_r101")
    jmodel = jbuild_model(jcfg)
    params = _random_params(lambda k: jmodel.init(k, *_inputs(jcfg)))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    radar_fn = cli_train._try_radar_fn(cfg)
    res = loop.evaluate(cfg, model, radar_fn=radar_fn, fold_bn=False,
                        out_path=os.path.join(root, "eval.json"))
    ds = jinfos.NuScenesInfos(os.path.join(root, jcfg.data.ann_val),
                              test_mode=True, data_root=root)
    eval_step = jstep.make_eval_step(jcfg, jmodel)
    jl = jloader.PrefetchLoader(ds, jcfg.data, 1, training=False,
                                radar_fn=radar_fn)
    want = [jax.tree_util.tree_map(np.asarray,
                                   eval_step(params["params"], b))
            for b in jl.epoch(0)]
    got = res.detections
    assert list(got["tokens"]) == [i["token"] for i in ds.infos]
    for row, w in enumerate(want):
        scores = got["scores"][row]
        np.testing.assert_allclose(scores, w["scores"][0], atol=1e-5)
        gap = np.minimum(np.abs(np.diff(scores, prepend=np.inf)),
                         np.abs(np.diff(scores, append=-np.inf)))
        sep = gap > 1e-4
        assert sep.sum() > 10
        np.testing.assert_array_equal(got["labels"][row][sep],
                                      w["labels"][0][sep])
        b, wb = got["boxes"][row][sep], w["boxes"][0][sep]
        assert np.abs(b - wb).max() <= 1e-4 * (1 + np.abs(wb).max())
        np.testing.assert_array_equal(got["valid"][row][sep],
                                      w["valid"][0][sep])
