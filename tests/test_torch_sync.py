"""No host sync from constants in the port's forward, loss and decode.

A ``torch.tensor(data, device=cuda)`` copies from pageable host memory,
which synchronizes the stream; ``core/device.const`` copies from pinned
memory without waiting.  These tests hold, on the CPU:

- a source scan: no module of ``models``, ``ops``, ``core``, ``eval`` or
  ``train`` but ``core/device.py`` builds a tensor from host data with a
  ``device=`` argument;
- bit-identity: each repaired site (``denorm_points``,
  ``project_points_to_cams``, the camera head's point-cloud range,
  ``nms_free_decode`` and the loss's code weights) gives exactly the
  values of the pageable construction it replaced, which the tests put
  back by patching ``const``.

The card-side check (a warm camera request under
``torch.cuda.set_sync_debug_mode("error")``) is ``chip_smoke.py``'s.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from transcar_tpu_torch.core import boxes, device, geometry
from transcar_tpu_torch.core.config import HeadConfig
from transcar_tpu_torch.eval import decode
from transcar_tpu_torch.models import head as head_mod
from transcar_tpu_torch.train import loss as loss_mod

PORT = pathlib.Path(__file__).resolve().parents[1] / "transcar_tpu_torch"
HOST_DATA = {"tensor", "as_tensor", "asarray"}


def pageable(data, device, dtype=torch.float32):
    """The construction the repair replaced."""
    return torch.tensor(data, dtype=dtype, device=device)


def _host_data_with_device(path: pathlib.Path):
    """(line, call) of every ``torch.tensor/as_tensor/asarray(...,
    device=...)`` in a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in HOST_DATA
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "torch"
                and any(k.arg == "device" for k in node.keywords)):
            yield node.lineno, ast.unparse(node.func)


def test_no_host_data_copied_with_a_device_argument():
    found = []
    for sub in ("models", "ops", "core", "eval", "train"):
        for path in sorted((PORT / sub).glob("*.py")):
            if path == PORT / "core" / "device.py":
                continue
            found += [f"{path.relative_to(PORT)}:{ln} {fn}"
                      for ln, fn in _host_data_with_device(path)]
    assert not found, ("build these with core/device.const, a buffer or "
                       f"Python scalars: {found}")


def test_scan_sees_a_pageable_constant(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch\n"
                   "x = torch.tensor([1.0], dtype=torch.float32,\n"
                   "                 device='cuda')\n"
                   "y = torch.tensor([1.0])\n")
    assert list(_host_data_with_device(src)) == [(2, "torch.tensor")]


def test_const_on_the_cpu_is_the_plain_tensor():
    for dtype in (torch.float32, torch.float64, torch.int32):
        got = device.const([1.5, -2.25, 3.0], "cpu", dtype)
        want = torch.tensor([1.5, -2.25, 3.0], dtype=dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_denorm_points_and_projection_unchanged(monkeypatch, dtype):
    rng = np.random.default_rng(0)
    pts01 = torch.from_numpy(rng.uniform(0, 1, (2, 37, 3))).to(dtype)
    pc = HeadConfig().pc_range
    l2i = torch.from_numpy(rng.normal(size=(2, 6, 4, 4))).to(dtype)
    l2i[..., 2, :] = l2i[..., 2, :].abs() + 0.1       # most depths > 0
    pts_m = boxes.denorm_points(pts01, pc)
    uv, vis = geometry.project_points_to_cams(pts_m, l2i, (928, 1600))
    monkeypatch.setattr(boxes, "const", pageable)
    monkeypatch.setattr(geometry, "const", pageable)
    ref_m = boxes.denorm_points(pts01, pc)
    ref_uv, ref_vis = geometry.project_points_to_cams(ref_m, l2i, (928, 1600))
    assert pts_m.dtype == dtype and torch.equal(pts_m, ref_m)
    assert torch.equal(uv, ref_uv) and torch.equal(vis, ref_vis)
    assert 0 < int(vis.sum()) < vis.numel()


def _head_case():
    cfg = HeadConfig(num_query=16, num_decoder_layers=2, num_fusion_layers=3,
                     num_radar_tokens=24)
    torch.manual_seed(0)
    model = head_mod.TransCARHead(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) / max(1, p.shape[-1]) ** 0.5)
    rng = np.random.default_rng(1)
    feats = [torch.from_numpy(rng.normal(size=(1, 6, h, w, 256))
                              .astype(np.float32))
             for h, w in ((8, 12), (4, 6), (2, 3), (1, 2))]
    l2i = torch.from_numpy(rng.normal(size=(1, 6, 4, 4)).astype(np.float32))
    l2i[..., 2, :] = l2i[..., 2, :].abs() + 0.1
    radar = np.full((1, 24, 36), 500.0, np.float32)
    radar[0, :16] = rng.normal(size=(16, 36)) * 20
    return model, (feats, l2i, (64, 96), torch.from_numpy(radar))


def test_camera_head_unchanged(monkeypatch):
    """The head's point-cloud range (decoder denorm and fusion)."""
    model, args = _head_case()
    with torch.no_grad():
        got = model(*args)
        for mod in (head_mod, boxes, geometry):
            monkeypatch.setattr(mod, "const", pageable)
        ref = model(*args)
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert torch.isfinite(got[key]).all()
        assert torch.equal(got[key], ref[key]), key


def test_decode_and_loss_unchanged(monkeypatch):
    cfg = HeadConfig(num_query=30)
    rng = np.random.default_rng(2)
    preds = {"all_cls_scores": torch.from_numpy(
                 rng.normal(size=(3, 2, 30, 10)).astype(np.float32)),
             "all_bbox_preds": torch.from_numpy(
                 rng.normal(size=(3, 2, 30, 10)).astype(np.float32) * 30)}
    gt = np.zeros((2, 5, 9), np.float32)
    gt[..., :3] = rng.uniform(-40, 40, (2, 5, 3))
    gt[..., 3:6] = rng.uniform(0.5, 4, (2, 5, 3))
    gt[..., 6] = rng.uniform(-3, 3, (2, 5))
    args = (preds, torch.from_numpy(gt),
            torch.from_numpy(rng.integers(0, 10, (2, 5))),
            torch.tensor([5, 3]), cfg)
    dec = decode.nms_free_decode(preds, cfg)
    losses = loss_mod.detr3d_loss(*args)
    monkeypatch.setattr(decode, "const", pageable)
    monkeypatch.setattr(loss_mod, "const", pageable)
    ref_dec = decode.nms_free_decode(preds, cfg)
    ref_losses = loss_mod.detr3d_loss(*args)
    assert 0 < int(dec["valid"].sum()) < dec["valid"].numel()
    for key in dec:
        assert torch.equal(dec[key], ref_dec[key]), key
    assert set(losses) == set(ref_losses)
    for key in losses:
        assert torch.equal(losses[key], ref_losses[key]), key
