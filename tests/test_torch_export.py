"""The serving kernels as ``torch.library`` ops and ``cli/export.py``
(``tests/test_export_cli.py``'s twin), on the CPU, where each op runs its
plain version:

  * ``torch.library.opcheck`` of ``transcar::dcn_forward``,
    ``masked_attention``, ``osa_reduce`` and ``msdeform_forward``, and of
    the opt-in serving kernels' ``int8_amax``, ``int8_codes`` (both code
    widths), ``int8_conv`` (with and without the affine and the epilogue's
    amax, bfloat16 and float32 out, a stem's shape), ``osa_block`` and
    ``bottleneck`` (with and without the downsample), at small shapes
    (schema, fake tensor against the real output's shape, dtype and
    strides, tracing);
  * ``cli.export`` of a tiny ``transcar_r101`` (radar fusion, DCN in
    stages 3-4 on the kernel route) and a tiny ``objdgcnn_pillar``: the
    saved program, loaded, equals the live ``eval_step`` bit for bit; the
    graph names the ops; the sidecar's ``batch`` and ``outputs`` trees
    equal those of the JAX ``export_eval_step`` for the same
    configuration;
  * the opt-in serving configurations exported (int8 through
    ``cli.export`` and ``torch.export.load``, ``osa_reduce_impl=fused``
    and ``block_impl=fused`` as exported): the program equals the live
    ``eval_step`` bit for bit, its graph names exactly their ops, it
    holds the layouts derived from the weights (int8 codes, scales and
    affines; K4's K-major views) as its state and builds none in the
    graph; int8's sidecar trees equal JAX's, the fused ones' those of the
    default configuration;
  * a model traced without its held layouts refuses to export.
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
from transcar_tpu_torch.models.common import derived_weights_held
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.ops import int8, pallas_msdeform, pallas_osa
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
        **_opt_in_cases(g),
    }
    for op, arg_lists in cases.items():
        for args in arg_lists:
            result = torch.library.opcheck(op, args)
            assert set(result.values()) == {"SUCCESS"}, (op, result)
    out = torch.ops.transcar.masked_attention(qh, kh, vh, keep)
    assert out.shape == (2, 3, 7, 32) and out.stride() == (672, 32, 96, 1)
    # a stem's codes: 4 channels in channels-last memory, the 4th zero
    img = _cl(_randn(g, 1, 3, 9, 11))
    iq, isx = int8.plain_quantize_per_tensor(img)
    q, s = torch.ops.transcar.int8_codes(img, int8.plain_amax(img), 4)
    assert q.shape == (1, 4, 9, 11) and q.is_contiguous(
        memory_format=torch.channels_last) and not q[:, 3].any()
    assert torch.equal(q[:, :3], iq) and s.item() == isx.item()


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _affine(g, c):
    return torch.rand(c, generator=g) + 0.5, _randn(g, c)


def _opt_in_cases(g) -> dict:
    """opcheck inputs of the int8, K5 and K6 ops: both code widths; the
    conv with and without the affine and the epilogue's amax, bfloat16
    and float32 out, at a stem's shape; K6 with and without the
    downsample."""
    x = _cl(_randn(g, 2, 16, 5, 6))
    img = _cl(_randn(g, 1, 3, 9, 11))
    xq, sx = int8.plain_quantize_per_tensor(x)
    wq, sw = int8.quantize_weight_per_channel(_randn(g, 8, 16, 3, 3))
    iq, isx = int8.plain_quantize_per_tensor(img)
    sq, ssw = int8.quantize_weight_per_channel(_randn(g, 8, 3, 7, 7))
    s8, b8 = _affine(g, 8)
    xb = _randn(g, 1, 5, 6, 16)
    a1, a2, ar = _affine(g, 8), _affine(g, 8), _affine(g, 24)
    rws = pallas_osa.kmajor_weights(_randn(g, 24, 32), [16, 8, 8],
                                    torch.float32)
    w1, w2 = _randn(g, 16, 8), _randn(g, 3, 3, 8, 8)
    c1, c2 = _affine(g, 8), _affine(g, 8)
    tr = torch.ops.transcar
    return {
        tr.int8_amax.default: [(x,), (x.bfloat16(),)],
        tr.int8_codes.default: [(x, int8.plain_amax(x), 16),
                                (img, int8.plain_amax(img), 4)],
        tr.int8_conv.default: [
            *[(xq, sx, wq, sw, None, stride, 1, 1, dt, *aff, relu, want)
              for stride, dt, aff, relu, want in (
                  (1, torch.bfloat16, (s8, b8), True, True),
                  (1, torch.float32, (s8, b8), False, False),
                  (2, torch.float32, (None, None), False, True),
                  (2, torch.bfloat16, (None, None), False, False))],
            (iq, isx, sq, ssw, None, 2, 3, 1, torch.bfloat16, s8, b8, True,
             True)],
        tr.osa_block.default: [
            (xb, [_randn(g, 3, 3, 16, 8), _randn(g, 3, 3, 8, 8)],
             [a1[0], a2[0]], [a1[1], a2[1]], rws, *ar, [])],
        tr.bottleneck.default: [
            (xb, w1, *c1, w2, *c2, _randn(g, 8, cout), *_affine(g, cout),
             *((_randn(g, 16, cout), *_affine(g, cout)) if ds
               else (None, None, None)), [])
            for cout, ds in ((24, True), (16, False))],
    }


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


#: The opt-in serving configurations at tiny sizes (VoVNet-99 at its own
#: widths, on two small cameras) and the ops their programs call.
VOV = ["model.head.num_cams=2", "model.head.num_query=16",
       "model.head.num_decoder_layers=1", "model.head.num_radar_tokens=40",
       "data.img_hw=[32,64]", "model.backbone.compute_dtype=float32"]
OPT_IN = {
    "int8": ("transcar_r101", TINY + ["model.backbone.quantize=int8"],
             {"int8_amax", "int8_codes", "int8_conv", "masked_attention"}),
    "osa_fused": ("transcar_vovnet_trainval",
                  VOV + ["model.backbone.osa_reduce_impl=fused"],
                  {"osa_block", "masked_attention"}),
    "block_fused": ("transcar_r101",
                    TINY + ["model.backbone.block_impl=fused"],
                    {"bottleneck", "masked_attention"}),
}


@pytest.mark.parametrize("name", list(OPT_IN))
def test_opt_in_configurations_export(name, tmp_path):
    """int8, fused-OSA and fused-bottleneck serving exported, bit for bit
    against the live eval step; the layouts derived from the weights are
    the program's state.  int8 goes through ``cli.export`` →
    ``torch.export.load`` (the held codes, scales and affines round-trip
    the ``.pt2``); the fused programs are called as exported (saving and
    loading them is the same code, held above)."""
    from transcar_tpu_torch.train.fold import (fold_bn_into_conv,
                                               frozen_bn_names)

    preset, over, op_names = OPT_IN[name]
    cfg = get_preset(preset, parse_overrides(over))
    if name == "int8":
        path = str(tmp_path / "model.pt2")
        exported, side = export.main([preset, "--out", path, "--device",
                                      "cpu", "--cfg-options", *over])
        program = torch.export.load(path).module()
        with open(path + ".json") as f:
            assert json.load(f) == side
    else:
        exported, side = export.export_eval_step(
            cfg, build_model(cfg, device="cpu"))
        program = exported.module()
    targets = [str(n.target) for n in program.graph.nodes]
    assert {t.split(".")[1] for t in targets
            if t.startswith("transcar.")} == op_names
    # held, not built per call: the K-major views (K4, which the fused
    # OSA block's reduce reads) and the weight codes, scales and affines
    # (int8) are buffers, and the graph quantizes no weight (K6's K-major
    # copies are the card's only: on the CPU that program holds none)
    held = [k for k, _ in program.named_buffers() if "_held" in k]
    assert f"{len(held)} tensors" in side["derived"]
    assert bool(held) == (name != "block_fused")
    assert "aten.round.default" not in targets
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
    assert side["outputs"] == export.tree_doc(got)
    assert side["batch"] == export.tree_doc(batch)
    if name == "int8":
        _, jside = jexport.export_eval_step(
            jconfig.get_preset(preset, parse_overrides(over)))
        assert side["batch"] == jside["batch"]
        assert side["outputs"] == jside["outputs"]
    else:   # the default configuration's trees (held against JAX above)
        twin = get_preset(preset, parse_overrides(over[:-1]))
        assert side["batch"] == export.tree_doc(
            export.example_batch(twin, 1, "cpu"))


def test_a_traced_layout_is_held_or_refused():
    """Traced outside ``derived_weights_held`` (or before an eager forward
    built the layouts), a model that keeps kernel layouts refuses to
    export rather than rebuild them in the graph at each call."""
    from transcar_tpu_torch.models.common import cached_copy

    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(4, 4))

        def forward(self, x):
            wt = cached_copy(self, "_wt", [self.w], x.dtype,
                             lambda: self.w.t().contiguous())
            return x @ wt

    model = Scaled().requires_grad_(False)
    x = torch.randn(2, 4)
    with pytest.raises(Exception, match="derived_weights_held"):
        torch.export.export(model, (x,))
    want = model(x)                 # the eager forward builds the layout
    with pytest.raises(Exception, match="derived_weights_held"):
        torch.export.export(model, (x,))
    with derived_weights_held(model) as n_held:
        program = torch.export.export(model, (x,)).module()
    assert n_held == 1
    assert torch.equal(program(x), want)


def test_export_needs_cuda_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        export.main(["objdgcnn_pillar", "--out", str(tmp_path / "m.pt2"),
                     "--cfg-options", *TINY])
    np.testing.assert_equal(list(tmp_path.iterdir()), [])
