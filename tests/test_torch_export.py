"""The serving kernels as ``torch.library`` ops and ``cli/export.py``
(``tests/test_export_cli.py``'s twin), on the CPU, where each op runs its
plain version:

  * ``torch.library.opcheck`` of ``transcar::dcn_forward``,
    ``masked_attention``, ``osa_reduce`` and ``msdeform_forward`` at small
    shapes (schema, fake tensor against the real output's shape, dtype and
    strides, tracing);
  * ``cli.export`` of a tiny ``transcar_r101`` (radar fusion, DCN in
    stages 3-4 on the kernel route) and a tiny ``objdgcnn_pillar``: the
    saved program, loaded, equals the live ``eval_step`` bit for bit; the
    graph names the ops; the sidecar's ``batch`` and ``outputs`` trees
    equal those of the JAX ``export_eval_step`` for the same
    configuration;
  * a configuration whose kernels are not registered ops refuses to
    export.
"""
import json

import numpy as np
import pytest
import torch

from tests.test_torch_data import TINY
from transcar_tpu.cli import export as jexport
from transcar_tpu.core import config as jconfig
from transcar_tpu_torch import ops  # noqa: F401
from transcar_tpu_torch.cli import export
from transcar_tpu_torch.core.config import get_preset, parse_overrides
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.ops import pallas_msdeform
from transcar_tpu_torch.train.step import eval_step

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

DCN = "model.backbone.with_dcn=[false,false,true,true]"


def _randn(g, *shape):
    return torch.randn(shape, generator=g)


def test_opcheck_the_registered_ops():
    g = torch.Generator().manual_seed(0)
    x = _randn(g, 1, 5, 6, 16)
    om = 0.5 * _randn(g, 1, 5, 6, 27)
    w = _randn(g, 3, 3, 16, 8)
    wk = w.permute(3, 0, 1, 2).contiguous()
    qh, kh, vh = _randn(g, 2, 3, 7, 32), _randn(g, 2, 3, 9, 32), \
        _randn(g, 2, 3, 9, 32)
    keep = torch.rand(2, 7, 9, generator=g) > 0.4
    keep[0, 0] = False                              # a fully masked row
    pieces = [_randn(g, 2, 3, 4, 8), _randn(g, 2, 3, 4, 16)]
    weights = [_randn(g, 8, 24), _randn(g, 16, 24)]
    shapes = ((4, 4), (2, 3))
    value = _randn(g, 1, 22, 2, 8)
    loc = torch.rand(1, 6, 2, 2, 3, 2, generator=g)
    wgt = torch.rand(1, 6, 2, 2, 3, generator=g)
    cases = {
        torch.ops.transcar.dcn_forward.default: [(x, om, w, None),
                                                 (x, om, w, wk)],
        torch.ops.transcar.masked_attention.default: [(qh, kh, vh, keep)],
        torch.ops.transcar.osa_reduce.default: [
            (pieces, weights, torch.rand(24, generator=g),
             _randn(g, 24), relu) for relu in (True, False)],
        torch.ops.transcar.msdeform_forward.default: [
            (value, pallas_msdeform.flat_shapes(shapes), loc, wgt, chunk)
            for chunk in (0, 4)],
    }
    for op, arg_lists in cases.items():
        for args in arg_lists:
            result = torch.library.opcheck(op, args)
            assert set(result.values()) == {"SUCCESS"}, (op, result)
    out = torch.ops.transcar.masked_attention(qh, kh, vh, keep)
    assert out.shape == (2, 3, 7, 32) and out.stride() == (672, 32, 96, 1)


def _cfg(preset, *extra):
    return get_preset(preset, parse_overrides(TINY + list(extra)))


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    batch = export.example_batch(cfg, 1, "cpu")
    if cfg.model.lidar_encoder:
        pts = torch.rand(batch["points"].shape, generator=g)
        pc = torch.tensor(cfg.model.head.pc_range)
        pts[..., :3] = pc[:3] + pts[..., :3] * (pc[3:] - pc[:3])
        return {"points": pts,
                "num_points": torch.tensor([2000], dtype=torch.int32)}
    return {k: torch.randn(v.shape, generator=g) for k, v in batch.items()}


@pytest.mark.parametrize("preset,op_names", [
    ("transcar_r101", {"dcn_forward", "masked_attention"}),
    ("objdgcnn_pillar", {"msdeform_forward"}),
])
def test_exported_program_equals_the_eval_step(preset, op_names, tmp_path):
    """``cli.export`` → ``torch.export.load`` → call, against the live
    eval step of the same seeded, folded weights; the sidecar against
    JAX's."""
    from transcar_tpu_torch.train.fold import (fold_bn_into_conv,
                                               frozen_bn_names)

    over = TINY + [DCN]
    path = str(tmp_path / "model.pt2")
    export.main([preset, "--out", path, "--device", "cpu",
                 "--cfg-options", *over])
    program = torch.export.load(path).module()
    graph = {str(n.target).split(".")[1] for n in program.graph.nodes
             if str(n.target).startswith("transcar.")}
    assert graph == op_names
    cfg = _cfg(preset, DCN)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(fold_bn_into_conv(model.state_dict(),
                                            frozen_bn_names(model)))
    batch = _batch(cfg)
    with torch.no_grad():
        got = program(batch)
    want = eval_step(model, batch, cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with open(path + ".json") as f:
        side = json.load(f)
    _, jside = jexport.export_eval_step(
        jconfig.get_preset(preset, parse_overrides(over)))
    assert side["batch"] == jside["batch"] == export.tree_doc(batch)
    assert side["outputs"] == jside["outputs"] == export.tree_doc(got)
    assert side["preset"] == jside["preset"] == cfg.name
    assert side["takes_batch_stats"] is False
    assert side["platforms"] == ["cpu"]
    assert "fold_bn_into_conv" in side["params"]


@pytest.mark.parametrize("option", ["model.backbone.quantize=int8",
                                    "model.backbone.osa_reduce_impl=fused",
                                    "model.backbone.block_impl=fused"])
def test_unregistered_kernels_refuse_to_export(option, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md Queue 2"):
        export.main(["transcar_r101", "--out", str(tmp_path / "m.pt2"),
                     "--device", "cpu", "--cfg-options", *TINY, option])
    assert not list(tmp_path.iterdir())


def test_export_needs_cuda_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        export.main(["objdgcnn_pillar", "--out", str(tmp_path / "m.pt2"),
                     "--cfg-options", *TINY])
    np.testing.assert_equal(list(tmp_path.iterdir()), [])
