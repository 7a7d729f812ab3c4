"""Port modules and the whole inference slice vs the JAX package, on the CPU.

Weights are seeded random values for the JAX model's parameter tree,
carried over by ``transcar_tpu_torch.train.convert.from_jax_params``;
inputs are seeded numpy.  Geometry as tests/test_model_forward.py: 6 cameras × 64 × 96,
36 queries, 40 radar tokens, 2 decoder + 3 fusion layers, R50-DCN.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.geom import camera_ring_l2i
from transcar_tpu.core.config import BackboneConfig, HeadConfig, ModelConfig
from transcar_tpu.models import TransCARDetector as JaxDetector
from transcar_tpu.models.detr3d import Detr3DDecoderLayer as JaxDecoderLayer
from transcar_tpu.models.fpn import FPN as JaxFPN
from transcar_tpu.models.head import TransCARHead as JaxHead
from transcar_tpu_torch.cli import benchmark
from transcar_tpu_torch.models.detector import TransCARDetector
from transcar_tpu_torch.models.detr3d import Detr3DDecoderLayer
from transcar_tpu_torch.models.fpn import FPN
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

B, N, H, W = 1, 6, 64, 96
Q, T = 36, 40
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.asarray(a))


def _load(module, params):
    module.load_state_dict(from_jax_params(params), strict=True)
    return module.eval()


def _head_cfg(**kw):
    return HeadConfig(num_query=Q, num_decoder_layers=2, num_fusion_layers=3,
                      num_radar_tokens=T, **kw)


def _random_params(init, seed=0):
    """Seeded random values for every leaf of the flax tree that
    ``init(key)`` builds (shapes from ``jax.eval_shape``, no init
    compute): non-zero DCN
    offsets and camera weights (both init to zero), non-identity frozen
    BN statistics and norms, so every leaf and layout rule of the bridge
    shows in the outputs."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))

    def f(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = rng.normal(size=shape) * 0.1
        elif len(shape) == 1:                          # biases
            v = rng.normal(size=shape) * 0.05
        else:                                 # fan-in scaled kernels
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


@pytest.fixture(scope="module")
def slice_case():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    l2i = camera_ring_l2i(N, H, W)[None]
    radar = np.full((B, T, 36), 500.0, np.float32)
    radar[0, :20] = rng.normal(size=(20, 36)).astype(np.float32)
    radar[0, :20, 0:2] *= 30.0
    cfg = ModelConfig(backbone=BackboneConfig(kind="resnet50",
                                              compute_dtype=None),
                      head=_head_cfg(), use_grid_mask=False)
    inputs = (images, l2i, radar)
    params = _random_params(lambda k: JaxDetector(cfg).init(k, *inputs))
    return cfg, params, inputs


def _run_slice(slice_case, compute_dtype):
    cfg, params, inputs = slice_case
    cfg = ModelConfig(
        backbone=BackboneConfig(kind="resnet50", compute_dtype=compute_dtype),
        head=cfg.head, use_grid_mask=False)
    ref = jax.jit(JaxDetector(cfg).apply)(params, *map(jnp.asarray, inputs))
    port = _load(TransCARDetector(cfg, dcn_impl="pallas"), params)
    with torch.no_grad():
        out = port(*map(t, inputs))
    pairs = []
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, b = out[key].numpy(), np.asarray(ref[key])
        assert a.shape == b.shape == (3, B, Q, 10)
        assert np.isfinite(a).all()
        pairs.append((key, a, b))
    return pairs


def test_slice_fp32(slice_case):
    # float32 end to end: the two differ by summation order only
    # (measured max 6e-5 on |bbox| ≤ 51)
    for key, a, b in _run_slice(slice_case, None):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=key)


def test_slice_bf16(slice_case):
    # bfloat16 backbone + FPN: each side rounds after every conv in its
    # own order (and the JAX DCN rounds its bilinear fractions too), so
    # the FPN levels differ by ~1% of their range, as each differs from
    # float32.  The float32 head mostly carries that through smoothly,
    # but a query whose reference point sits on an image edge or a
    # sigmoid clamp can flip there; so 90% of the queries must agree
    # within 5e-2 (relative to 1 + |ref|) and every query within 0.3.
    # (Measured: 90% within 0.026, worst 0.17; JAX's own bfloat16 path
    # sits 0.032 / 0.078 from its float32 path here.)
    for key, a, b in _run_slice(slice_case, "bfloat16"):
        per_query = (np.abs(a - b) / (1 + np.abs(b))).max(axis=(0, 3))
        assert np.quantile(per_query, 0.9) <= 5e-2, key
        assert per_query.max() <= 0.3, key


def test_fpn():
    rng = np.random.default_rng(1)
    chans = (8, 16, 32, 64)
    feats = [rng.normal(size=(2, 24 >> i, 40 >> i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    jfpn = JaxFPN(in_channels=chans, out_channels=16)
    jfeats = [jnp.asarray(f) for f in feats]
    params = _random_params(lambda k: jfpn.init(k, jfeats), seed=1)
    ref = jfpn.apply(params, jfeats)
    port = _load(FPN(in_channels=chans, out_channels=16), params)
    with torch.no_grad():
        outs = port([t(f).permute(0, 3, 1, 2) for f in feats])
    assert len(outs) == len(ref) == 4
    for a, b in zip(outs, ref):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=1e-4, atol=1e-4)


def test_decoder_layer():
    rng = np.random.default_rng(2)
    e, levels = 32, 2
    query, pos = (rng.normal(size=(B, Q, e)).astype(np.float32)
                  for _ in range(2))
    ref01 = rng.uniform(0.05, 0.95, (B, Q, 3)).astype(np.float32)
    feats = [rng.normal(size=(B, N, 16 >> i, 24 >> i, e)).astype(np.float32)
             for i in range(levels)]
    l2i = camera_ring_l2i(N, H, W)[None]
    args = (query, pos, ref01, feats, l2i)
    kw = dict(embed_dims=e, num_heads=4, ffn_dims=64, num_levels=levels)
    jlayer = JaxDecoderLayer(**kw)
    jargs = [jnp.asarray(a) if not isinstance(a, list)
             else [jnp.asarray(f) for f in a] for a in args]
    params = _random_params(lambda k: jlayer.init(k, *jargs, (H, W)),
                            seed=2)
    ref = jlayer.apply(params, *jargs, (H, W))
    port = _load(Detr3DDecoderLayer(**kw), params)
    with torch.no_grad():
        out = port(*[t(a) if not isinstance(a, list) else [t(f) for f in a]
                     for a in args], (H, W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _fusion_parity(**cfg_kw):
    """The fusion stage of the port's head against the JAX head's, from
    the same seeded inputs and weights; returns the port's outputs."""
    from transcar_tpu_torch.models.head import TransCARHead

    rng = np.random.default_rng(3)
    cfg = _head_cfg(**cfg_kw)
    query = rng.normal(size=(B, Q, 256)).astype(np.float32)
    ref01 = rng.uniform(0.3, 0.7, (B, Q, 3)).astype(np.float32)
    coord = rng.normal(size=(B, Q, 10)).astype(np.float32)
    coord[..., 3] = 0.8                                   # length e^0.8
    radar = np.full((B, T, 36), 500.0, np.float32)
    radar[0, :30] = rng.normal(size=(30, 36)).astype(np.float32)
    # tokens near the query centers, so the masks keep some pairs
    centers = ref01[0, :30, :2] * 102.4 - 51.2
    radar[0, :30, :2] = centers + rng.normal(size=(30, 2)) * 1.5
    args = (query, ref01, coord, radar)
    jhead = JaxHead(cfg)
    feats = [jnp.zeros((B, N, 4, 6, 256))] * 4
    l2i = jnp.asarray(camera_ring_l2i(N, H, W)[None])
    params = _random_params(
        lambda k: jhead.init(k, feats, l2i, (H, W), jnp.asarray(radar)),
        seed=3)
    ref = jhead.apply(params, *map(jnp.asarray, args), method=JaxHead.fuse)
    port = _load(TransCARHead(cfg), params)
    kept = []
    port.fusion0_attn.register_forward_pre_hook(
        lambda m, a, kw: kept.append(float((~kw["mask"]).float().mean())),
        with_kwargs=True)
    with torch.no_grad():
        out = port.fuse(*map(t, args))
    assert 0 < kept[0] < 0.5
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    return out


def test_fusion_stage():
    _fusion_parity()


def test_fusion_stage_without_strict_reference_compat():
    """``strict_reference_compat=False``: the fusion layers take the
    denormalized z as their base, where the reference's quirk adds the
    normalized one; both heads agree, and the z the branch feeds differs
    from the default's."""
    out = _fusion_parity(strict_reference_compat=False)
    strict = _fusion_parity()
    z = 4                                     # (cx, cy, w, l, cz, ...)
    assert not torch.allclose(out["all_bbox_preds"][..., z],
                              strict["all_bbox_preds"][..., z])
    torch.testing.assert_close(out["all_cls_scores"],
                               strict["all_cls_scores"])


TINY_CLI = ["--device", "cpu", "--samples", "1", "--warmup", "1",
            "--height", "64", "--width", "96", "--cfg-options",
            "model.backbone.kind=resnet50", "model.head.num_query=16",
            "model.head.num_decoder_layers=1",
            "model.head.num_radar_tokens=40"]


def test_cli_benchmark_cpu(capsys, tmp_path):
    benchmark.main(["--trace-dir", str(tmp_path)] + TINY_CLI)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["samples_per_sec"] > 0
    assert rec["requests"] == 2
    assert "aten::" in (tmp_path / "kernels.txt").read_text()
    assert (tmp_path / "trace.json").stat().st_size > 0
    # the wrappers took their plain versions on the CPU: no launches
    assert rec["kernel_launches"] == dict.fromkeys(
        ("dcn_forward", "dcn_backward", "masked_attention", "osa_reduce",
         "osa_block", "bottleneck", "msdeform_forward",
         "msdeform_backward_taps", "msdeform_backward_value", "int8_conv",
         "int8_quantize"), 0)
    assert rec["peak_memory_bytes"] is None
    assert 0 <= rec["dcn_taps_past_5px"] <= 1


def test_trace_summary_groups_leads_and_gaps(tmp_path):
    # three kernels (µs): a GEMM launched at 0 runs 100-200; K2 launched
    # at 150 runs 200-230 (queued: lead 50); an elementwise kernel
    # launched at 260 runs 270-280 (lead 10), after 40 idle
    kernels = [("sm90_xmma_gemm", 100, 100, 1, 0),
               ("masked_attention_wgmma_kernel", 200, 30, 2, 150),
               ("vectorized_elementwise_kernel", 270, 10, 3, 260)]
    events = []
    for name, ts, dur, corr, at in kernels:
        events.append({"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                       "args": {"correlation": corr}})
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": at, "dur": 5, "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = benchmark.trace_summary(str(path), wall_s=400e-6, count=1)
    assert s["device_busy_ms_per_iter"] == pytest.approx(0.14)
    assert s["device_idle_share"] == pytest.approx(1 - 140 / 400)
    assert s["kernels_per_iter"] == 3
    k2, gemm = "K2 masked_attention", "GEMM / convolution (cuBLAS, cuDNN)"
    assert s["ms_per_iter_by_group"][k2] == pytest.approx(0.03)
    assert s["host_lead_ms_by_group"] == pytest.approx(
        {gemm: 0.1, k2: 0.05, "elementwise / reduce / copy": 0.01})
    assert s["idle_after_ms_by_group"] == pytest.approx({gemm: 0.0, k2: 0.04})


def test_cli_rejects_unported_presets():
    # every preset serves and trains: objdgcnn_voxel too, here at a tiny
    # size (tests/test_torch_voxel.py holds it); int8 serving too (its
    # plain version on the CPU, tests/test_torch_int8.py holds it)
    tiny = ["--device", "cpu", "--samples", "1", "--warmup", "0",
            "--cfg-options", "model.voxel_size=[2.0,2.0,1.0]",
            "model.sparse_shape=[9,32,32]",
            "model.head.pc_range=[-32.0,-32.0,-5.0,32.0,32.0,3.0]",
            "data.max_points=1000", "model.max_voxels=128",
            "model.head.num_query=8", "model.head.num_decoder_layers=1"]
    rec, out = benchmark.run(["objdgcnn_voxel", *tiny])
    assert rec["voxel_audit"]["voxels"] == 128
    assert out["all_cls_scores"].shape == (1, 1, 8, 10)
    rec, _ = benchmark.run_train(["objdgcnn_voxel", "--train", *tiny])
    assert np.isfinite(rec["loss_last"]["total"])
    rec, out = benchmark.run(TINY_CLI + ["model.backbone.quantize=int8"])
    assert rec["kernel_launches"]["int8_conv"] == 0          # CPU: plain
    assert all(torch.isfinite(v).all() for v in out.values())


def _jax_package_uses(path):
    """Lines of one source file that import jax, the JAX package or the
    JAX driver entry, or that reach a file of the JAX package by path."""
    import ast

    tree = ast.parse(open(path).read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "transcar_tpu",
                       "__graft_entry__"):
                bad.append((node.lineno, f"import {name}"))
        if isinstance(node, (ast.Name, ast.Attribute)):
            ident = node.id if isinstance(node, ast.Name) else node.attr
            if ident in ("spec_from_file_location", "SourceFileLoader",
                         "run_path", "load_shared", "import_module",
                         "__import__"):
                bad.append((node.lineno, ident))
        if isinstance(node, ast.Call):      # paths handed to any call
            for arg in [*node.args, *(k.value for k in node.keywords)]:
                for sub in ast.walk(arg):
                    if (isinstance(sub, ast.Constant)
                            and isinstance(sub.value, str)
                            and ("transcar_tpu/" in sub.value
                                 or sub.value in ("transcar_tpu",
                                                  "__graft_entry__")
                                 or "__graft_entry__." in sub.value)):
                        bad.append((node.lineno, sub.value))
    return bad


def _jax_package_text_uses(path):
    """Code lines (comments stripped: a comment may cite the TPU kernel a
    source replaces) of a C++ / CUDA source, header or Makefile that
    reach the JAX package by path or module (``transcar_tpu/``,
    ``transcar_tpu.``), jax or the JAX driver entry."""
    import re

    pattern = re.compile(r"transcar_tpu[/.]|\bjax\b|jaxlib|__graft_entry__")
    comment = "#" if os.path.basename(path) == "Makefile" else "//"
    found = []
    for n, line in enumerate(open(path).read().splitlines(), 1):
        code = line.split(comment)[0]
        if comment == "//" and code.lstrip().startswith("*"):
            continue                                 # a /* ... */ block
        if pattern.search(code):
            found.append((n, line.strip()))
    return found


def test_port_sources_never_reach_the_jax_package():
    import glob

    def port(pattern):
        return sorted(glob.glob(os.path.join(REPO, "transcar_tpu_torch",
                                             "**", pattern), recursive=True))

    files = port("*.py") + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    found = {os.path.relpath(f, REPO): _jax_package_uses(f) for f in files}
    assert not any(found.values()), {k: v for k, v in found.items() if v}
    native = [f for f in port("*.cpp") + port("*.cu") + port("*.h")
              + port("*.cuh") + port("Makefile")
              if os.sep + "build" + os.sep not in f]
    names = {os.path.basename(f) for f in native}
    assert {"jpeg_decode.cpp", "lapjv.cpp", "radar_featurize.cpp",
            "Makefile", "dcn_forward.cu", "hopper_tile.cuh"} <= names
    found = {os.path.relpath(f, REPO): _jax_package_text_uses(f)
             for f in native}
    assert not any(found.values()), {k: v for k, v in found.items() if v}


def test_jax_package_text_use_detector(tmp_path):
    src = tmp_path / "probe.cpp"
    src.write_text("// Same math as transcar_tpu/data/radar.py\n"
                   "#include \"../../transcar_tpu/native/x.h\"\n"
                   "#include \"transcar_tpu_torch/native/y.h\"  // ok\n")
    assert [n for n, _ in _jax_package_text_uses(str(src))] == [2]
    make = tmp_path / "Makefile"
    make.write_text("# builds like transcar_tpu/native/Makefile\n"
                    "SRC = ../../transcar_tpu/native/lapjv.cpp\n")
    assert [n for n, _ in _jax_package_text_uses(str(make))] == [2]


def test_port_native_build_writes_nothing_beside_its_sources():
    """The port's C++ helpers build into ``transcar_tpu_torch/build/native/``
    under a name keyed by their sources; nothing lands in
    ``transcar_tpu_torch/native/``."""
    from transcar_tpu_torch import native

    def listing():
        return sorted(p for p in os.listdir(native.SRC_DIR)
                      if p != "__pycache__")

    before = listing()
    for name in native.SOURCES:
        so = native.build(name)
        assert so == native.library_path(name) and so.exists()
        assert so.parent == native.BUILD_DIR
    assert listing() == before == ["Makefile", "__init__.py",
                                   "jpeg_decode.cpp", "lapjv.cpp",
                                   "radar_featurize.cpp"]


def test_jax_package_use_detector(tmp_path):
    # the detector itself finds each kind of use
    src = tmp_path / "probe.py"
    src.write_text(
        "import jax.numpy as jnp\n"
        "from transcar_tpu.core import config\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'x', 'transcar_tpu/core/config.py')\n"
        "open('transcar_tpu/cli/train.py')\n"
        "import __graft_entry__\n")
    kinds = [b for _, b in _jax_package_uses(str(src))]
    assert "import jax.numpy" in kinds and "import __graft_entry__" in kinds
    assert "import transcar_tpu.core" in kinds
    assert "spec_from_file_location" in kinds
    assert "transcar_tpu/cli/train.py" in kinds


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from transcar_tpu_torch.cli import benchmark\n"
        f"rec, out = benchmark.run({TINY_CLI!r})\n"
        "assert torch.isfinite(out['all_bbox_preds']).all()\n"
        "rec, state = benchmark.run_train(['detr3d_r101', '--train'] + "
        f"{TINY_CLI!r})\n"
        "assert state.step == 2\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transcar_tpu' or m.startswith('transcar_tpu.')"
        " or m == '__graft_entry__']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
